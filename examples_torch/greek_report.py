"""Whole risk report in one call: price + Greeks for a batch.

The PyTorch port of ``examples/greek_report.py``: one call returns an
(N, M) matrix of price, delta, gamma, theta, vega and rho for the whole
query batch, sharing the per-point barycentric rows across every spec
(``vectorized_eval_batch_multi``), then the served flavor
(:class:`MultiSpecEvaluator`) with pre-differentiated per-spec tensors
and buckets.

Run:  python examples_torch/greek_report.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np
import torch
from scipy.stats import norm

from pychebyshev_tpu_torch import ChebyshevApproximation
from pychebyshev_tpu_torch.serving import MultiSpecEvaluator

DOMAIN = [[80.0, 120.0], [90.0, 110.0], [0.25, 2.0],
          [0.1, 0.5], [0.01, 0.05]]

SPECS = {
    "price": [0, 0, 0, 0, 0],
    "delta": [1, 0, 0, 0, 0],
    "gamma": [2, 0, 0, 0, 0],
    "theta": [0, 0, 1, 0, 0],
    "vega":  [0, 0, 0, 1, 0],
    "rho":   [0, 0, 0, 0, 1],
}


def bs_price(points, _data=None):
    points = np.asarray(points, dtype=np.float64)
    s, k, t, sigma, r = (points[:, i] for i in range(5))
    sqrt_t = np.sqrt(t)
    d1 = (np.log(s / k) + (r + 0.5 * sigma ** 2) * t) / (sigma * sqrt_t)
    d2 = d1 - sigma * sqrt_t
    return s * norm.cdf(d1) - k * np.exp(-r * t) * norm.cdf(d2)


def main(device="cuda"):
    cheb = ChebyshevApproximation(bs_price, 5, DOMAIN, [11] * 5,
                                  vectorized=True, device=device)
    cheb.build(verbose=False)

    rng = np.random.default_rng(7)
    lo = np.array([b[0] for b in DOMAIN])
    hi = np.array([b[1] for b in DOMAIN])
    pts = lo + (hi - lo) * rng.uniform(0.05, 0.95, size=(4096, 5))

    # --- Class path: the whole report in one batched call -------------
    names = list(SPECS)
    report = np.asarray(cheb.vectorized_eval_batch_multi(
        pts, [SPECS[n] for n in names]))
    print(f"report matrix: {report.shape} (points x specs)")
    header = "  ".join(f"{n:>9s}" for n in names)
    print(f"   {header}")
    for i in range(3):
        row = "  ".join(f"{report[i, j]:9.4f}" for j in range(len(names)))
        print(f"   {row}")

    # Spot-check delta against the closed form N(d1).
    s, k, t, sigma, r = pts[0]
    d1 = (np.log(s / k) + (r + 0.5 * sigma ** 2) * t) / (sigma * np.sqrt(t))
    delta_err = abs(report[0, 1] - norm.cdf(d1))
    print(f"delta[0] interpolated {report[0, 1]:.6f} "
          f"vs closed-form {norm.cdf(d1):.6f}")

    # --- Served flavor: pre-hoisted spec tensors + buckets ------------
    engine = MultiSpecEvaluator(cheb, [SPECS[n] for n in names],
                                dtype=torch.float64,
                                bucket_sizes=(1024, 4096), device=device)
    engine.warmup()
    served = engine(pts).cpu().numpy()
    dev = float(np.abs(served - report).max())
    print(f"served report max |dev| vs class path: {dev:.2e}")

    assert report.shape == (4096, len(SPECS))
    assert delta_err < 1e-4 and dev < 1e-10
    return {"delta_err": float(delta_err), "served_dev": dev}


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)

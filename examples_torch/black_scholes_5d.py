"""5-D Black-Scholes pricing proxy: build, accuracy vs analytic, Greeks.

The PyTorch port of ``examples/black_scholes_5d.py``: V(S, K, T, sigma,
r) on an 11^5 Chebyshev grid, with analytical Greeks from spectral
differentiation matrices.

Run:  python examples_torch/black_scholes_5d.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import time

import numpy as np
from scipy.stats import norm

from pychebyshev_tpu_torch import ChebyshevApproximation

DOMAIN = [[80.0, 120.0], [90.0, 110.0], [0.25, 2.0], [0.1, 0.5],
          [0.01, 0.05]]
ATM = [100.0, 100.0, 1.0, 0.2, 0.03]


def bs_price(points, _=None):
    points = np.asarray(points, dtype=np.float64)
    s, k, t, sg, r = (points[:, i] for i in range(5))
    st = np.sqrt(t)
    d1 = (np.log(s / k) + (r + 0.5 * sg ** 2) * t) / (sg * st)
    d2 = d1 - sg * st
    return s * norm.cdf(d1) - k * np.exp(-r * t) * norm.cdf(d2)


def greeks_analytic(s, k, t, sg, r):
    st = np.sqrt(t)
    d1 = (np.log(s / k) + (r + 0.5 * sg ** 2) * t) / (sg * st)
    return {
        "delta": norm.cdf(d1),
        "gamma": norm.pdf(d1) / (s * sg * st),
        "vega": s * norm.pdf(d1) * st,
    }


def main(device="cuda"):
    t0 = time.time()
    cheb = ChebyshevApproximation(bs_price, 5, DOMAIN, [11] * 5,
                                  vectorized=True, device=device)
    cheb.build(verbose=False)
    print(f"build: {time.time() - t0:.3f}s "
          f"({cheb.n_evaluations:,} evaluations)")
    est = cheb.error_estimate()
    print(f"error estimate: {est:.2e}")

    # Price accuracy at the ATM scenario + random points.
    price = cheb.vectorized_eval(ATM, [0] * 5)
    exact = float(bs_price(np.asarray([ATM]))[0])
    atm_rel = abs(price - exact) / exact
    print(f"ATM price: {price:.6f} vs analytic {exact:.6f} "
          f"(rel err {atm_rel:.2e})")

    rng = np.random.default_rng(0)
    lo = np.array([b[0] for b in DOMAIN])
    hi = np.array([b[1] for b in DOMAIN])
    pts = lo + (hi - lo) * rng.uniform(0.05, 0.95, size=(1000, 5))
    approx = cheb.vectorized_eval_batch(pts, [0] * 5)
    exact_v = bs_price(pts)
    liquid = np.abs(exact_v) > 1.0
    rel = np.abs(approx - exact_v)[liquid] / np.abs(exact_v)[liquid]
    print(f"1000 random points: max rel err {rel.max():.2e} (|V|>1)")

    # Analytical Greeks: price + 5 first-order sensitivities in one call.
    multi = cheb.vectorized_eval_multi(ATM, [
        [0, 0, 0, 0, 0], [1, 0, 0, 0, 0], [2, 0, 0, 0, 0],
        [0, 0, 0, 1, 0], [0, 0, 1, 0, 0], [0, 0, 0, 0, 1],
    ])
    g = greeks_analytic(*ATM)
    greek_rel = {}
    for name, k in (("delta", 1), ("gamma", 2), ("vega", 3)):
        greek_rel[name] = abs(multi[k] - g[name]) / g[name]
        print(f"{name + ':':6s} {multi[k]:.6f} vs {g[name]:.6f} "
              f"(rel {greek_rel[name]:.2e})")

    # Sobol: which inputs drive the price variance?
    sob = cheb.sobol_indices()
    names = ["S", "K", "T", "sigma", "r"]
    order = sorted(range(5), key=lambda d: -sob["total_order"][d])
    print("Sobol total-order:",
          ", ".join(f"{names[d]}={sob['total_order'][d]:.3f}"
                    for d in order))

    assert atm_rel < 1e-5 and rel.max() < 1e-3
    assert max(greek_rel.values()) < 1e-3
    assert names[order[0]] == "S"
    return {"error_estimate": est, "atm_rel_err": atm_rel,
            "max_rel_err": float(rel.max()),
            **{f"{k}_rel_err": v for k, v in greek_rel.items()}}


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)

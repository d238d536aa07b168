"""5-D Black-Scholes via TT-Cross: sparse builds, compression, batching.

The PyTorch port of ``examples/tensor_train_5d.py``.  The builds run on
the host; batches run as chains on the device.

Run:  python examples_torch/tensor_train_5d.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import time

import numpy as np
from scipy.stats import norm

from pychebyshev_tpu_torch import ChebyshevTT

DOMAIN = [[80.0, 120.0], [90.0, 110.0], [0.25, 2.0], [0.1, 0.5],
          [0.01, 0.05]]


def bs_price(points, _=None):
    points = np.asarray(points, dtype=np.float64)
    s, k, t, sg, r = (points[:, i] for i in range(5))
    st = np.sqrt(t)
    d1 = (np.log(s / k) + (r + 0.5 * sg ** 2) * t) / (sg * st)
    d2 = d1 - sg * st
    return s * norm.cdf(d1) - k * np.exp(-r * t) * norm.cdf(d2)


def main(device="cuda"):
    t0 = time.time()
    tt = ChebyshevTT(bs_price, 5, DOMAIN, [11] * 5, max_rank=15,
                     vectorized=True, device=device)
    tt.build(verbose=False, seed=42)
    print(f"build: {time.time() - t0:.3f}s")
    print(f"unique evaluations: {tt.total_build_evals:,} "
          f"(full grid would be {11 ** 5:,})")
    print(f"TT ranks: {tt.tt_ranks}")
    print(f"compression: {tt.compression_ratio:.1f}x")

    rng = np.random.default_rng(1)
    lo = np.array([b[0] for b in DOMAIN])
    hi = np.array([b[1] for b in DOMAIN])
    pts = lo + (hi - lo) * rng.uniform(0.05, 0.95, size=(1000, 5))
    t0 = time.time()
    approx = tt.eval_batch(pts).cpu().numpy()   # a tensor on the device
    dt = time.time() - t0
    exact = bs_price(pts)
    liquid = np.abs(exact) > 1.0
    rel = np.abs(approx - exact)[liquid] / np.abs(exact)[liquid]
    print(f"1000-point batch in {dt * 1e3:.1f} ms; "
          f"mean rel err {rel.mean():.2e}, max {rel.max():.2e}")

    # Masked-ALS refinement: least-squares sweeps over the entries the
    # cross already evaluated — zero extra function evaluations.
    ttr = ChebyshevTT(bs_price, 5, DOMAIN, [11] * 5, max_rank=15,
                      vectorized=True, device=device)
    ttr.build(verbose=False, seed=42, refine_sweeps=2)
    rel_r = np.abs(ttr.eval_batch(pts).cpu().numpy() - exact)[liquid] \
        / np.abs(exact)[liquid]
    print(f"with refine_sweeps=2 (same {ttr.total_build_evals:,} evals): "
          f"mean rel err {rel_r.mean():.2e}, max {rel_r.max():.2e}")

    # FD Greeks.
    atm = [100.0, 100.0, 1.0, 0.2, 0.03]
    vals = tt.eval_multi(atm, [[0] * 5, [1, 0, 0, 0, 0],
                               [2, 0, 0, 0, 0]])
    print(f"price {vals[0]:.6f}, FD delta {vals[1]:.6f}, "
          f"FD gamma {vals[2]:.6f}")

    # Calculus on the compressed representation.
    avg = tt.integrate() / np.prod(hi - lo)
    print(f"domain-average price (TT quadrature): {avg:.6f}")

    sob = tt.sobol_indices()
    names = ["S", "K", "T", "sigma", "r"]
    print("Sobol total-order:",
          ", ".join(f"{names[d]}={sob['total_order'][d]:.3f}"
                    for d in range(5)))

    exact_atm = float(bs_price(np.asarray([atm]))[0])
    assert tt.total_build_evals < 11 ** 5 // 10
    assert rel.mean() < 1e-3 and rel.max() < 3e-2
    assert rel_r.max() < rel.max()
    assert abs(vals[0] - exact_atm) / exact_atm < 1e-3
    assert 0.5 < vals[1] < 0.7
    return {"total_build_evals": tt.total_build_evals,
            "compression_ratio": tt.compression_ratio,
            "max_rel_err": float(rel.max()),
            "refined_max_rel_err": float(rel_r.max()),
            "price": vals[0], "fd_delta": vals[1], "average": float(avg)}


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)

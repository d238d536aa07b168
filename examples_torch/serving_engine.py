"""Serving a pricing proxy: bucketed engines, Greeks engines,
pickle-free checkpoints.

The PyTorch port of ``examples/serving_engine.py``: build once,
checkpoint with ``.npz``, reload in a serving process, and answer
ragged batches through :class:`BatchedEvaluator`, one engine per
Greek, with every bucket's operands prepared at warm-up.  On a CUDA
card the f32 engines run the hand-written evaluator (K1).

Run:  python examples_torch/serving_engine.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import tempfile
import time

import numpy as np
import torch
from scipy.stats import norm

from pychebyshev_tpu_torch import ChebyshevApproximation
from pychebyshev_tpu_torch.serving import (
    BatchedEvaluator,
    MultiModelEvaluator,
    build_book,
)

DOMAIN = [[80.0, 120.0], [90.0, 110.0], [0.25, 2.0],
          [0.1, 0.5], [0.01, 0.05]]


def bs_price(points, _data=None):
    points = np.asarray(points, dtype=np.float64)
    s, k, t, sigma, r = (points[:, i] for i in range(5))
    sqrt_t = np.sqrt(t)
    d1 = (np.log(s / k) + (r + 0.5 * sigma ** 2) * t) / (sigma * sqrt_t)
    d2 = d1 - sigma * sqrt_t
    return s * norm.cdf(d1) - k * np.exp(-r * t) * norm.cdf(d2)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(device="cuda"):
    # --- "training" process: build + checkpoint -----------------------
    cheb = ChebyshevApproximation(bs_price, 5, DOMAIN, [11] * 5,
                                  vectorized=True, device=device)
    cheb.build(verbose=False)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "proxy.npz")
        cheb.save(ckpt, format="npz")   # no pickle: safe to ship
        print("built 11^5 proxy, checkpointed to proxy.npz")

        # --- "serving" process: reload + warm up -----------------------
        model = ChebyshevApproximation.load(ckpt, device=device)
    buckets = (1 << 10, 1 << 14, 1 << 17)
    price = BatchedEvaluator(model, dtype=torch.float32,
                             bucket_sizes=buckets, device=device)
    delta = BatchedEvaluator(model, dtype=torch.float32,
                             derivative_order=[1, 0, 0, 0, 0],
                             bucket_sizes=buckets, device=device)
    t0 = time.time()
    price.warmup()
    delta.warmup()
    _sync(device)
    print(f"warmup: {time.time() - t0:.1f}s")

    # --- ragged production traffic ------------------------------------
    rng = np.random.default_rng(0)
    lo = np.array([b[0] for b in DOMAIN])
    hi = np.array([b[1] for b in DOMAIN])
    errs = []
    for n in (37, 5_000, 100_000):
        pts = lo + (hi - lo) * rng.uniform(0.02, 0.98, size=(n, 5))
        t0 = time.perf_counter()
        p = price(pts).cpu().numpy()
        d = delta(pts).cpu().numpy()
        dt = time.perf_counter() - t0
        errs.append(float(np.max(np.abs(p - bs_price(pts)))))
        print(f"batch {n:>7,}: price+delta in {dt * 1e3:7.2f} ms "
              f"(max |err| {errs[-1]:.2e}, delta[0] {d[0]:.4f})")

    # --- a book of proxies, built in ONE call ---------------------------
    # Eight strike-shifted products over the same market grid: the book
    # oracle returns one column per product, so the whole book evaluates
    # every (grid point, model) pair in a single batched call.
    shifts = np.linspace(-5.0, 5.0, 8)

    def book_fn(points, _data=None):
        pts = np.asarray(points, dtype=np.float64)
        cols = []
        for ds in shifts:
            shifted = pts.copy()
            shifted[:, 1] += ds
            cols.append(bs_price(shifted))
        return np.column_stack(cols)

    t0 = time.time()
    book = build_book(book_fn, 5, DOMAIN, [11] * 5, device=device)
    print(f"\nbuilt an 8-model book in {time.time() - t0:.2f}s "
          f"(one oracle call; models share grid arrays)")
    book_engine = MultiModelEvaluator(book, dtype=torch.float32,
                                      bucket_sizes=(1 << 10, 1 << 14),
                                      device=device)
    book_engine.warmup()
    pts = lo + (hi - lo) * rng.uniform(0.02, 0.98, size=(5_000, 5))
    t0 = time.perf_counter()
    surface = book_engine(pts).cpu().numpy()      # (8, 5000)
    dt = time.perf_counter() - t0
    print(f"book of 8 x 5,000 points in {dt * 1e3:.2f} ms "
          f"-> strike ladder at pts[0]: "
          f"{np.round(surface[:, 0], 3)}")
    ladder = np.column_stack([bs_price(pts[:1] + [[0, ds, 0, 0, 0]])
                              for ds in shifts])[0]
    book_err = float(np.abs(surface[:, 0] - ladder).max())

    # f32 serving: ~1e-4 absolute on prices up to ~45.
    assert max(errs) < 5e-3 and book_err < 5e-3
    assert np.all(np.diff(surface[:, 0]) < 0)   # higher strike, cheaper
    return {"max_abs_err": max(errs), "book_abs_err": book_err}


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)

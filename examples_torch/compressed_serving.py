"""1e-12-class dense serving through exact compression.

The PyTorch port of ``examples/compressed_serving.py``: a FULL-GRID
dense model compresses exactly into a tensor train (``to_tt`` — TT-SVD
of the value tensor, no re-sampling) and serves through the grouped
supercore chain, where adjacent TT cores merge exactly into larger
supercores (``groups="auto"`` picks the grouping that moves the fewest
intermediate elements per point).

The workflow below also shows the two compression levers:
- ``order="auto"`` searches dim permutations;
- ``sup_target=`` trims bond ranks against a MEASURED grid sup-norm
  budget.

Run:  python examples_torch/compressed_serving.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

from pychebyshev_tpu_torch import ChebyshevApproximation
from pychebyshev_tpu_torch.ops.tt_eval_dd import tt_dd_auto_groups
from pychebyshev_tpu_torch.serving import BatchedEvaluator

DOMAIN = [[80.0, 120.0], [90.0, 110.0], [0.25, 2.0], [0.1, 0.5],
          [0.01, 0.05]]


def bs_price(points, _data=None):
    from scipy.stats import norm
    p = np.asarray(points, dtype=np.float64)
    s, k, t, sigma, r = (p[:, i] for i in range(5))
    sq = np.sqrt(t)
    d1 = (np.log(s / k) + (r + 0.5 * sigma ** 2) * t) / (sigma * sq)
    d2 = d1 - sigma * sq
    return s * norm.cdf(d1) - k * np.exp(-r * t) * norm.cdf(d2)


def main(device="cuda"):
    cheb = ChebyshevApproximation(bs_price, 5, DOMAIN,
                                  n_nodes=[11] * 5, vectorized=True,
                                  device=device)
    cheb.build(verbose=False)

    # Compress once (exact linear algebra on the value tensor).
    tt = cheb.to_tt(tolerance=1e-13)
    print(f"compressed ranks: {tt.tt_ranks} "
          f"({tt.compression_ratio:.1f}x fewer parameters)")

    # The auto planner picks the grouped supercore chain.
    shapes = tuple(tuple(int(x) for x in c.shape)
                   for c in tt._coeff_cores)
    print(f"auto groups: {tt_dd_auto_groups(shapes)}")

    rng = np.random.default_rng(0)
    lo = np.array([b[0] for b in DOMAIN])
    hi = np.array([b[1] for b in DOMAIN])
    pts = lo + (hi - lo) * rng.uniform(0.02, 0.98, size=(4096, 5))

    dense_f64 = np.asarray(cheb.eval_batch(pts,
                                           derivative_order=[0] * 5))
    scale = np.abs(dense_f64).max()

    served = tt.eval_batch_dd(pts).cpu().numpy()   # groups="auto" default
    dev = float(np.abs(served - dense_f64).max() / scale)
    print(f"grouped dd serving deviation vs dense f64: {dev:.2e}")

    # Lever 1: the dim-order search.
    tt_auto = cheb.to_tt(tolerance=1e-13, order="auto")
    print(f"order='auto' picked {tt_auto.dim_order} "
          f"(ranks {tt_auto.tt_ranks})")

    # Lever 2: per-bond trimming against a measured sup-norm budget.
    tt_trim = cheb.to_tt(tolerance=1e-13, sup_target=3e-12)
    diag = tt_trim.compression_diagnostics
    print(f"sup_target=3e-12 trims ranks "
          f"{diag['bond_ranks_initial']} -> {diag['bond_ranks']} "
          f"(grid sup dev {diag['grid_sup_dev']:.1e}, chain flops "
          f"{diag['chain_flops_initial']} -> {diag['chain_flops']})")
    dev_t = float(np.abs(tt_trim.eval_batch_dd(pts).cpu().numpy()
                         - dense_f64).max() / scale)
    print(f"trimmed serving deviation: {dev_t:.2e}")

    # Production form: a bucketed engine; dtype='dd' on a TT model uses
    # the grouped chain.
    engine = BatchedEvaluator(tt, dtype="dd", device=device)
    dev_e = float(np.abs(engine(pts).cpu().numpy() - dense_f64).max()
                  / scale)
    print(f"engine deviation: {dev_e:.2e}")

    assert dev < 1e-12 and dev_t < 1e-12 and dev_e < 1e-12
    return {"dev": dev, "trimmed_dev": dev_t, "engine_dev": dev_e,
            "compression_ratio": tt.compression_ratio}


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)

"""Scenario analysis in one call: batched boxes and batched roots.

The PyTorch port of ``examples/scenario_calculus.py``.  The reference
answers one scenario per call (``integrate(bounds=...)``,
``roots(dim, fixed)``); the batched forms take a whole scenario batch:

    integrate_batch(bounds)   (B, d, 2) boxes -> (B,) integrals: the
                              batched evaluator with per-box
                              sub-interval quadrature rows (bucket
                              masses, expected exposures, CDF tables).
    roots_batch(dim, fixed)   fixed holds (B,) scenario arrays: one
                              batched slice resampling + one stacked
                              colleague eigensolve (breakevens /
                              exercise boundaries across scenarios).
    minimize_batch / maximize_batch
                              same batching for extrema.

Run:  python examples_torch/scenario_calculus.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

from pychebyshev_tpu_torch import ChebyshevApproximation


def pnl_surface(points, _data=None):
    """A toy desk P&L over (spot move, vol level, rate move)."""
    p = np.asarray(points, dtype=np.float64)
    s, v, r = p[:, 0], p[:, 1], p[:, 2]
    return np.sin(1.5 * s) - 0.8 * v * v + 0.3 * r - 0.1 * s * v


def main(device="cuda"):
    rng = np.random.default_rng(0)
    dom = [(-1.0, 1.0), (0.1, 0.6), (-0.5, 0.5)]
    pnl = ChebyshevApproximation(pnl_surface, 3, dom, [13, 9, 9],
                                 vectorized=True, device=device)
    pnl.build(verbose=False)

    # --- bucketed expected P&L mass over scenario boxes, one call ----
    n_buckets = 64
    lows = np.stack([rng.uniform(a, b, n_buckets) for a, b in dom], axis=1)
    highs = np.stack([rng.uniform(lows[:, i], dom[i][1])
                      for i in range(3)], axis=1)
    boxes = np.stack([lows, highs], axis=-1)            # (B, 3, 2)
    masses = pnl.integrate_batch(boxes)                 # one call
    vols = np.prod(highs - lows, axis=1)
    ok = vols > 1e-12
    mean_pnl = masses[ok] / vols[ok]                    # per-bucket mean
    print(f"{n_buckets} bucket masses in one call; "
          f"mean-P&L range [{mean_pnl.min():+.4f}, {mean_pnl.max():+.4f}]")

    # spot-check one bucket against the per-call path
    b = 0
    per_call = pnl.integrate(bounds=[tuple(boxes[b, k]) for k in range(3)])
    mass_diff = abs(masses[b] - per_call)
    print(f"bucket 0: batched {masses[b]:+.12f} vs per-call "
          f"{per_call:+.12f} (diff {mass_diff:.1e})")

    # --- conditional expectation: E over a spot bucket, per scenario -
    n_cond = 32
    s_lo = rng.uniform(-1.0, 0.0, n_cond)
    s_buckets = np.stack([s_lo, s_lo + rng.uniform(0.2, 1.0, n_cond)],
                         axis=-1)[:, None, :]          # (B, 1, 2)
    vr = np.stack([rng.uniform(*dom[1], n_cond),
                   rng.uniform(*dom[2], n_cond)], axis=1)
    cond = pnl.partial_integrate_batch([0], s_buckets, vr)
    cond_mean = cond / (s_buckets[:, 0, 1] - s_buckets[:, 0, 0])
    one = pnl.integrate(dims=0, bounds=tuple(s_buckets[0, 0])) \
        .vectorized_eval(list(vr[0]), [0, 0])
    cond_diff = abs(cond[0] - one)
    print(f"{n_cond} conditional expectations in one call; "
          f"E[P&L|bucket] range [{cond_mean.min():+.4f}, "
          f"{cond_mean.max():+.4f}]; per-call diff {cond_diff:.1e}")

    # --- the same workflow at the near-f64 tier ----------------------
    # dtype="dd" serves the identical quantities under the dd contract
    # (at most 1e-10 from f64), here in native f64.
    cond_dd = pnl.partial_integrate_batch([0], s_buckets, vr,
                                          dtype="dd")
    masses_dd = pnl.integrate_batch(boxes, dtype="dd")
    dd_dev = max(float(np.abs(cond_dd - cond).max()),
                 float(np.abs(masses_dd - masses).max()))
    print(f"dd tier: conditional dev "
          f"{np.abs(cond_dd - cond).max():.1e}, bucket-mass dev "
          f"{np.abs(masses_dd - masses).max():.1e} vs the f64 path")

    # --- breakeven spot moves across (vol, rate) scenarios -----------
    n_scen = 128
    vol_s = rng.uniform(*dom[1], n_scen)
    rate_s = rng.uniform(*dom[2], n_scen)
    breakevens = pnl.roots_batch(dim=0, fixed={1: vol_s, 2: rate_s})
    counts = np.array([r.size for r in breakevens])
    print(f"{n_scen} scenario breakeven solves in one stacked "
          f"eigensolve; root counts {sorted(set(counts.tolist()))}")

    # worst-case P&L over the spot axis, per scenario
    worst, worst_loc = pnl.minimize_batch(dim=0,
                                          fixed={1: vol_s, 2: rate_s})
    i = int(np.argmin(worst))
    print(f"worst scenario: vol={vol_s[i]:.3f} rate={rate_s[i]:+.3f} "
          f"-> P&L {worst[i]:+.4f} at spot move {worst_loc[i]:+.4f}")

    # agreement with the per-call path on one scenario
    pv, pl = pnl.minimize(dim=0, fixed={1: vol_s[i], 2: rate_s[i]})
    assert abs(pv - worst[i]) < 1e-10
    print("per-call minimize agrees:", f"{pv:+.4f} at {pl:+.4f}")

    assert mass_diff < 1e-12 and cond_diff < 1e-12 and dd_dev < 1e-10
    return {"mass_diff": float(mass_diff), "cond_diff": float(cond_diff),
            "dd_dev": dd_dev, "min_gap": abs(pv - float(worst[i])),
            "worst": float(worst[i])}


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)

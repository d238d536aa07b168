"""Portfolio proxy: TT-ALS builds, completion, TT algebra, inner products.

The PyTorch port of ``examples/portfolio_proxy.py``.  Models a
two-instrument portfolio as TT interpolants over shared risk factors,
then manipulates the portfolio value *in the compressed
representation*: addition with rank rounding, scalar scaling,
orthogonalization sweeps, inner products, and slicing out a risk factor.

Run:  python examples_torch/portfolio_proxy.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

from pychebyshev_tpu_torch import ChebyshevTT

DOMAIN = [[80.0, 120.0], [0.25, 2.0], [0.1, 0.5], [0.01, 0.05]]


def instrument_a(points, _=None):
    # smooth call-like payoff (softplus; a hard kink belongs to
    # ChebyshevSpline, not TT — see examples_torch/spline_kink_2d.py)
    p = np.asarray(points, dtype=np.float64)
    s, t, sg, r = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    soft = 5.0 * np.log1p(np.exp((s - 100.0) / 5.0))
    return soft * np.exp(-r * t) * (1 + 0.5 * sg)


def instrument_b(points, _=None):
    p = np.asarray(points, dtype=np.float64)
    s, t, sg, r = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    return 100.0 * np.exp(-r * t) + 0.1 * s * sg * np.sqrt(t)


def main(device="cuda"):
    # Rank-adaptive ALS builds.
    tta = ChebyshevTT(instrument_a, 4, DOMAIN, [9] * 4, max_rank=8,
                      tolerance=1e-8, vectorized=True, device=device)
    tta.build(verbose=False, method="als", seed=0)
    ttb = ChebyshevTT(instrument_b, 4, DOMAIN, [9] * 4, max_rank=8,
                      tolerance=1e-8, vectorized=True, device=device)
    ttb.build(verbose=False, method="als", seed=1)
    print(f"instrument A ranks: {tta.tt_ranks}")
    print(f"instrument B ranks: {ttb.tt_ranks}")

    # ALS completion sharpens A at its current rank.
    tta.run_completion(tolerance=1e-10, max_iter=5)

    # Portfolio = 2*A + B, assembled in TT form (block-diagonal stacking
    # + TT-SVD rounding).
    portfolio = tta * 2.0 + ttb
    print(f"portfolio ranks after rounding: {portfolio.tt_ranks}")

    rng = np.random.default_rng(2)
    lo = np.array([b[0] for b in DOMAIN])
    hi = np.array([b[1] for b in DOMAIN])
    pts = lo + (hi - lo) * rng.uniform(0.05, 0.95, size=(500, 4))
    exact = 2.0 * instrument_a(pts) + instrument_b(pts)
    approx = portfolio.eval_batch(pts).cpu().numpy()
    scale = np.abs(exact).max()
    err = float(np.abs(approx - exact).max() / scale)
    print(f"portfolio eval max err/scale: {err:.2e}")

    # Orthogonalization sweeps preserve the represented function.
    before = portfolio.eval([100.0, 1.0, 0.3, 0.03])
    portfolio.orth_left(3)
    portfolio.orth_right(0)
    after = portfolio.eval([100.0, 1.0, 0.3, 0.03])
    drift = abs(after - before)
    print(f"value drift through orth sweeps: {drift:.2e}")

    # Inner product of coefficient tensors (correlation-style diagnostics).
    ip = tta.inner_product(ttb)
    print(f"<A, B> coefficient inner product: {ip:.4f}")

    # Slice out the rate factor at r = 3% -> 3-D proxy.
    fixed_rate = portfolio.slice((3, 0.03))
    print(f"sliced portfolio: {fixed_rate.num_dimensions}-D, "
          f"ranks {fixed_rate.tt_ranks}")
    v1 = fixed_rate.eval([100.0, 1.0, 0.3])
    v2 = portfolio.eval([100.0, 1.0, 0.3, 0.03])
    print(f"slice consistency: {abs(v1 - v2):.2e}")

    assert err < 1e-4
    assert drift < 1e-10 * abs(before) and abs(v1 - v2) < 1e-10 * abs(v2)
    return {"max_err_over_scale": err, "orth_drift": drift,
            "inner_product": ip, "slice_gap": abs(v1 - v2)}


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)

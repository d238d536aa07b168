"""2-D call payoff with a strike kink: plain tensor vs spline.

The PyTorch port of ``examples/spline_kink_2d.py``.  A kink destroys
spectral convergence of a global interpolant; placing a knot at the
strike (``ChebyshevSpline``) restores it.

Run:  python examples_torch/spline_kink_2d.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import math

import numpy as np

from pychebyshev_tpu_torch import ChebyshevApproximation, ChebyshevSpline


def payoff(x, _):
    # discounted call payoff with a kink at K = 1.0 along dim 0
    return max(x[0] - 1.0, 0.0) * math.exp(-0.1 * x[1])


def max_err(obj, is_spline):
    rng = np.random.default_rng(0)
    pts = np.column_stack([rng.uniform(0, 2, 2000),
                           rng.uniform(0, 1, 2000)])
    exact = np.array([payoff(p, None) for p in pts])
    if is_spline:
        approx = obj.eval_batch(pts, [0, 0])
    else:
        approx = obj.vectorized_eval_batch(pts, [0, 0])
    return float(np.abs(approx - exact).max())


def main(device="cuda"):
    domain = [[0.0, 2.0], [0.0, 1.0]]

    print("nodes/dim | plain tensor max err | spline (knot at K) max err")
    plain_errs, spline_errs = [], []
    for n in [9, 13, 17, 21]:
        plain = ChebyshevApproximation(payoff, 2, domain, [n, n],
                                       device=device)
        plain.build(verbose=False)
        spline = ChebyshevSpline(payoff, 2, domain, [n, n], [[1.0], []],
                                 device=device)
        spline.build(verbose=False)
        plain_errs.append(max_err(plain, False))
        spline_errs.append(max_err(spline, True))
        print(f"{n:9d} | {plain_errs[-1]:20.2e} | {spline_errs[-1]:26.2e}")

    # Automatic kink detection finds the strike.
    auto = ChebyshevSpline.auto_knots(payoff, 2, domain, device=device)
    print(f"auto_knots found knots: {auto.knots}")

    # Derivative routing: delta jumps across the kink.
    sp = ChebyshevSpline(payoff, 2, domain, [15, 9], [[1.0], []],
                         device=device)
    sp.build(verbose=False)
    left = sp.eval([0.95, 0.5], [1, 0])
    right = sp.eval([1.05, 0.5], [1, 0])
    print(f"delta left of strike:  {left:+.6f}")
    print(f"delta right of strike: {right:+.6f}")

    # The knot restores spectral accuracy; the global tensor stalls.
    assert max(spline_errs) < 1e-10 < min(plain_errs)
    assert any(abs(k - 1.0) < 0.05 for k in auto.knots[0])
    assert abs(left) < 1e-10 and abs(right - math.exp(-0.05)) < 1e-10
    return {"plain_max_err": plain_errs[-1],
            "spline_max_err": max(spline_errs),
            "delta_left": left, "delta_right": right}


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)

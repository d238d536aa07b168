"""10-D basket proxy via the sliding technique + error-threshold auto-N.

The PyTorch port of ``examples/slider_10d.py``.  A near-separable 10-D
function builds from ~100 evaluations instead of 9^10 = 3.5 billion.

Run:  python examples_torch/slider_10d.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import time

import numpy as np

from pychebyshev_tpu_torch import ChebyshevApproximation, ChebyshevSlider

D = 10
DOMAIN = [[-1.0, 1.0]] * D
WEIGHTS = np.linspace(0.5, 1.5, D)


def basket(points, _=None):
    points = np.asarray(points, dtype=np.float64)
    return (np.sum(WEIGHTS * np.sin(points), axis=1)
            + 0.25 * np.sum(points ** 2, axis=1))


def main(device="cuda"):
    t0 = time.time()
    slider = ChebyshevSlider(basket, D, DOMAIN, [9] * D,
                             partition=[[i] for i in range(D)],
                             pivot_point=[0.0] * D, vectorized=True,
                             device=device)
    slider.build(verbose=False)
    print(f"build: {time.time() - t0:.3f}s "
          f"({slider.total_build_evals} evaluations vs 9^10 = "
          f"{9 ** 10:,} for the full tensor)")
    print(f"per-slide error estimate sum: {slider.error_estimate():.2e}")

    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, size=(5000, D))
    approx = slider.eval_batch(pts)
    exact = basket(pts)
    err = float(np.abs(approx - exact).max())
    print(f"5000 random points: max abs err {err:.2e} (exact: f is "
          f"additive)")

    # Derivatives route to the owning slide.
    pt = list(rng.uniform(-1, 1, D))
    d3 = slider.eval(pt, [0] * 3 + [1] + [0] * 6)
    exact_d3 = WEIGHTS[3] * np.cos(pt[3]) + 0.5 * pt[3]
    print(f"d/dx3: {d3:.8f} vs analytic {exact_d3:.8f}")

    # Error-threshold auto-N on a single dimension (capacity estimate).
    n1 = ChebyshevApproximation.get_optimal_n1(
        lambda x, _: float(np.sin(3 * x[0]) + np.exp(x[0])),
        (-1.0, 1.0), 1e-10, device=device)
    print(f"auto-N: sin(3x)+exp(x) needs N={n1} for 1e-10")

    # Closed-form integration of the sliding sum.
    total = slider.integrate()
    # exact: sin terms integrate to 0; sum x^2 term = 0.25 * D * (2/3) * 2^(D-1)
    exact_int = 0.25 * D * (2.0 / 3.0) * 2.0 ** (D - 1)
    print(f"integral over [-1,1]^10: {total:.6f} vs exact "
          f"{exact_int:.6f}")

    assert slider.total_build_evals < 100 and err < 1e-6
    assert abs(d3 - exact_d3) < 1e-5
    assert abs(total - exact_int) < 1e-9 * exact_int
    return {"total_build_evals": slider.total_build_evals,
            "max_abs_err": err, "d3_err": abs(d3 - exact_d3), "n1": n1,
            "integral_err": abs(total - exact_int)}


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)

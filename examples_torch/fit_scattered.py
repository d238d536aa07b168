"""Fitting an interpolant to scattered Monte-Carlo samples.

The PyTorch port of ``examples/fit_scattered.py``.  Because the dense
model is *linear* in its nodal tensor, ``ChebyshevApproximation.fit``
recovers it from scattered data in ONE least-squares solve (no
iteration, unlike the autodiff calibration loop in
calibration_autodiff.py, which remains the tool for nonlinear
objectives).

The demo: a 2-D Bachelier-style payoff surface sampled at 30,000
random (spot, vol) states with per-sample Monte-Carlo noise; the
fitted interpolant denoises well below the sample noise and then
serves through every tier like any built model.

Run:  python examples_torch/fit_scattered.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

from pychebyshev_tpu_torch import ChebyshevApproximation, ChebyshevSlider

DOMAIN = [[80.0, 120.0], [0.1, 0.5]]    # (spot, vol)


def true_price(s, v):
    """The smooth surface the noisy samples come from."""
    m = (s - 100.0) / (v * 100.0)
    return v * 100.0 * (0.39894 * np.exp(-0.5 * m * m) + 0.5 * m * (
        1.0 + np.tanh(0.8 * m)))


def true_delta(s, v):
    mm = (s - 100.0) / (v * 100.0)
    return (-0.39894 * mm * np.exp(-0.5 * mm * mm)
            + 0.5 * (1.0 + np.tanh(0.8 * mm))
            + 0.4 * mm / np.cosh(0.8 * mm) ** 2)


def basket(p):
    p = np.asarray(p)
    return sum(np.maximum(p[..., 2 * i] - 0.2 * p[..., 2 * i + 1],
                          0.0) ** 2 + 0.1 * np.sin(p[..., 2 * i])
               for i in range(5))


def rms(e):
    return float(np.sqrt(np.mean(np.asarray(e) ** 2)))


def main(device="cuda"):
    rng = np.random.default_rng(7)
    n = 30_000
    sigma = 0.05  # per-sample MC noise (price units)

    pts = rng.uniform([80.0, 0.1], [120.0, 0.5], size=(n, 2))
    clean = true_price(pts[:, 0], pts[:, 1])
    noisy = clean + rng.normal(0.0, sigma, n)

    m = ChebyshevApproximation.fit(
        pts, noisy, 2, DOMAIN, [11, 11], l2=1e-9, device=device)
    d = m.fit_diagnostics
    print(f"fit: {d['n_samples']:,} samples -> {d['grid_points']} nodal "
          f"values, training rms {d['rms']:.4f} (noise sigma {sigma})")

    test = rng.uniform([80.0, 0.1], [120.0, 0.5], size=(2000, 2))
    err = m.eval_batch(test, [0, 0]) - true_price(test[:, 0], test[:, 1])
    oos = rms(err)
    print(f"out-of-sample vs TRUE surface: rms {oos:.5f}, "
          f"max {np.max(np.abs(err)):.5f}  (denoised ~"
          f"{sigma / oos:.0f}x below sample noise)")

    # Gradient-enhanced ("differential ML") leg: pathwise/AAD deltas
    # enter the SAME linear solve through derivative_data=.
    n_small = 400
    pts_s = pts[:n_small]
    noisy_s = noisy[:n_small]
    deltas = (true_delta(pts_s[:, 0], pts_s[:, 1])
              + rng.normal(0.0, sigma / 40.0, n_small))
    plain = ChebyshevApproximation.fit(
        pts_s, noisy_s, 2, DOMAIN, [11, 11], l2=1e-9, device=device)
    graded = ChebyshevApproximation.fit(
        pts_s, noisy_s, 2, DOMAIN, [11, 11], l2=1e-9,
        derivative_data=[(pts_s, [1, 0], deltas)], device=device)
    small = {}
    for tag, mdl in (("values only", plain), ("values+deltas", graded)):
        small[tag] = rms(mdl.eval_batch(test, [0, 0])
                         - true_price(test[:, 0], test[:, 1]))
        print(f"  {n_small} samples, {tag:>13}: out-of-sample rms "
              f"{small[tag]:.5f}")

    # The result is an ordinary model: spectral delta, calculus, TT.
    delta = m.eval([100.0, 0.3], [1, 0])
    h = 1e-4
    fd = (true_price(100 + h, 0.3) - true_price(100 - h, 0.3)) / (2 * h)
    print(f"fitted delta at (100, 0.3): {delta:.6f} (true {fd:.6f})")
    mean_price = m.integrate() / (40.0 * 0.4)
    print(f"mean price over the box: {mean_price:.6f}")
    tt = m.to_tt(tolerance=1e-10)
    print(f"compressed to TT ranks {tt.tt_ranks}")

    # High dimension: the additive (slider) fit needs no grid at all —
    # a 10-D basket from 50k scattered samples is one 321-column solve
    # (five 8 x 8 groups and the constant).
    pts10 = rng.uniform(-1.0, 1.0, size=(50_000, 10))
    sl = ChebyshevSlider.fit(
        pts10, basket(pts10), 10, [[-1.0, 1.0]] * 10, [8] * 10,
        partition=[[0, 1], [2, 3], [4, 5], [6, 7], [8, 9]],
        pivot_point=[0.0] * 10, device=device)
    test10 = rng.uniform(-1.0, 1.0, size=(2000, 10))
    err10 = rms(sl.eval_batch(test10) - basket(test10))
    print(f"10-D additive fit from scattered samples: "
          f"{sl.fit_diagnostics['columns']} columns, out-of-sample rms "
          f"{err10:.2e}")

    assert oos < sigma / 10
    assert small["values+deltas"] < small["values only"]
    assert abs(delta - fd) < 1e-2 and err10 < 1e-2
    assert sl.fit_diagnostics["columns"] == 321
    return {"train_rms": d["rms"], "oos_rms": oos,
            "small_values_rms": small["values only"],
            "small_graded_rms": small["values+deltas"],
            "delta_err": abs(delta - fd), "slider_oos_rms": err10}


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)

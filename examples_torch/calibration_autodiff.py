"""Calibrating an interpolant to market quotes with torch.autograd + Adam.

The PyTorch port of ``examples/calibration_autodiff.py``.  The f64
batched evaluator (``ops.eval.eval_batch``) is plain PyTorch, so the
interpolant's *parameters* (its nodal value tensor) are differentiable:
given noisy market quotes at scattered points, gradient descent
recovers a value tensor whose interpolant fits the quotes, a
smile-surface calibration loop running on the device.

The value tensor is a leaf parameter of ``torch.optim.Adam``.  It goes
through the plain f64 path only: the kernel routes (``ops.fused_eval``,
``ops.fused_dd``) have no backward and refuse a tensor that requires
grad.

Run:  python examples_torch/calibration_autodiff.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np
import torch

from pychebyshev_tpu_torch import ChebyshevApproximation
from pychebyshev_tpu_torch.ops import eval as eval_ops

DOMAIN = [[80.0, 120.0], [0.25, 2.0]]   # (strike, maturity) vol surface
LEARNING_RATE = 2e-3
STEPS = 400


def true_vol(points):
    """The 'market' smile the quotes come from (unknown to the model)."""
    p = np.asarray(points, dtype=np.float64)
    k, t = p[:, 0], p[:, 1]
    m = np.log(k / 100.0)
    return 0.2 + 0.3 * m ** 2 / (1 + t) + 0.02 * np.sqrt(t)


def flat_surface(device):
    """The starting model: a FLAT surface; calibration must discover the
    smile."""
    flat = ChebyshevApproximation(
        lambda pts, _: np.full(len(np.asarray(pts)), 0.25), 2, DOMAIN,
        [13, 9], vectorized=True, device=device)
    flat.build(verbose=False)
    return flat


def market_quotes(rng):
    """Noisy market quotes at scattered (strike, maturity) points."""
    quotes_x = np.column_stack([rng.uniform(82, 118, 400),
                                rng.uniform(0.3, 1.9, 400)])
    quotes_v = true_vol(quotes_x) + rng.normal(0, 2e-4, 400)
    return quotes_x, quotes_v


def loss(tensor, grid, qx, qv):
    """Quote misfit + curvature penalty (2nd derivative along strike)."""
    nodes, weights, diffs = grid
    fit = eval_ops.eval_batch(tensor, nodes, weights, diffs, qx, (0, 0))
    curv = eval_ops.eval_batch(tensor, nodes, weights, diffs, qx, (2, 0))
    return torch.mean((fit - qv) ** 2) + 1e-9 * torch.mean(curv ** 2)


def main(device="cuda"):
    flat = flat_surface(device)
    grid = flat._grid_tuples()
    rng = np.random.default_rng(0)
    quotes_x, quotes_v = market_quotes(rng)
    qx = torch.tensor(quotes_x, device=device)
    qv = torch.tensor(quotes_v, device=device)

    tensor = flat.tensor_values.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([tensor], lr=LEARNING_RATE)
    losses = []
    for step in range(STEPS):
        opt.zero_grad()
        val = loss(tensor, grid, qx, qv)
        val.backward()
        opt.step()
        losses.append(float(val.detach()))
        if step % 100 == 0:
            print(f"step {step:4d}: loss {losses[-1]:.3e}")

    calibrated = ChebyshevApproximation.from_values(
        tensor.detach(), 2, DOMAIN, [13, 9], device=device)

    test = np.column_stack([rng.uniform(85, 115, 1000),
                            rng.uniform(0.4, 1.8, 1000)])
    fit = calibrated.vectorized_eval_batch(test, [0, 0])
    err = np.abs(fit - true_vol(test))
    print(f"calibrated surface vs true smile (1000 holdout pts): "
          f"mean {err.mean():.2e}, max {err.max():.2e}")
    vol = calibrated.vectorized_eval([90.0, 1.0], [0, 0])
    true = float(true_vol([[90.0, 1.0]])[0])
    print(f"smile recovered: vol(90, 1.0) = {vol:.4f} (true {true:.4f}), "
          f"started at 0.25")

    # The calibrated object is a first-class interpolant: greeks,
    # serialization, serving — everything applies.
    skew = calibrated.vectorized_eval([100.0, 1.0], [1, 0])
    print(f"calibrated skew d(vol)/dK at ATM: {skew:.5f}")

    assert losses[-1] < 1e-3 * losses[0]
    assert err.mean() < 5e-4 and err.max() < 5e-3
    assert abs(vol - true) < 1e-3
    return {"first_loss": losses[0], "final_loss": losses[-1],
            "holdout_mean_err": float(err.mean()),
            "holdout_max_err": float(err.max()), "vol_90_1": vol,
            "skew": skew}


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)

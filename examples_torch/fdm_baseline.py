"""FDM baseline: batched Crank-Nicolson Black-Scholes PDE.

The PyTorch port of ``examples/fdm_baseline.py``: the finite-difference
baseline of BASELINE.md (one PDE per scenario) with the whole scenario
batch solved at once:

- each case's Crank-Nicolson operators are dense (M+1)^2 matrices,
  built batched and inverted once (the propagator ``P = A^-1`` is
  time-independent because the BS coefficients don't depend on t);
- the time march is a loop whose step is one batched product pair
  ``V <- P @ (B V + boundary)`` in f64, no per-case Python;
- prices/deltas for all cases read off the final grids in one
  vectorized interpolation.

The point of the baseline is the contrast: the PDE grind delivers
~0.1-1% accuracy after a march of a thousand steps, while the prebuilt
11^5 Chebyshev interpolant answers the same scenario batch in one call
at ~1e-4% error.

Run:  python examples_torch/fdm_baseline.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import time

import numpy as np
import torch
from scipy.stats import norm

from pychebyshev_tpu_torch import ChebyshevApproximation

# The 5-D benchmark domain (S, K, T, sigma, r) from BASELINE.md.
DOMAIN = [[80.0, 120.0], [90.0, 110.0], [0.25, 2.0], [0.1, 0.5],
          [0.01, 0.05]]


def bs_price_np(points, _=None):
    points = np.asarray(points, dtype=np.float64)
    s, k, t, sg, r = (points[:, i] for i in range(5))
    st = np.sqrt(t)
    d1 = (np.log(s / k) + (r + 0.5 * sg ** 2) * t) / (sg * st)
    d2 = d1 - sg * st
    return s * norm.cdf(d1) - k * np.exp(-r * t) * norm.cdf(d2)


def interp(x, xp, fp):
    """Batched ``jnp.interp``: row b of (B,) ``x`` on its own (B, M)
    grid ``xp`` and values ``fp``, clamped to the end values outside the
    grid."""
    m = xp.shape[1]
    i = torch.searchsorted(xp, x[:, None].contiguous(), right=True).clamp(1, m - 1)
    x0, x1 = xp.gather(1, i - 1)[:, 0], xp.gather(1, i)[:, 0]
    f0, f1 = fp.gather(1, i - 1)[:, 0], fp.gather(1, i)[:, 0]
    dx = x1 - x0
    tiny = dx.abs() <= np.spacing(np.finfo(np.float64).eps)
    f = torch.where(tiny, f0,
                    f0 + (x - x0) / torch.where(tiny, 1.0, dx) * (f1 - f0))
    f = torch.where(x < xp[:, 0], fp[:, 0], f)
    return torch.where(x > xp[:, -1], fp[:, -1], f)


def crank_nicolson_batch(spots, strikes, mats, sigmas, rates,
                         m_space: int = 160, n_time: int = 1000,
                         s_max_mult: float = 3.0, device="cuda"):
    """Price B European calls by Crank-Nicolson, all cases at once.

    Returns (prices (B,), deltas (B,)) as f64 tensors on ``device``.

    Space grid: S in [0, s_max_mult * K_b] with m_space+1 points per
    case (each case owns its own grid scale).  Time: n_time CN steps.
    Everything is batched over the case axis: operator build, the
    one-time propagator inversion, each step's products, and the final
    grid reads.
    """
    f64 = dict(dtype=torch.float64, device=device)
    spots, strikes, mats, sigmas, rates = (
        torch.as_tensor(a, **f64) for a in (spots, strikes, mats, sigmas,
                                            rates))
    m = m_space
    i_idx = torch.arange(m + 1, **f64)                     # S_i = i*dS
    dtau = mats / n_time                                   # (B,)

    # Interior-space BS generator coefficients in index form
    # (S_i = i dS makes dS cancel):  L V|_i = a_i V_{i-1} + b_i V_i
    # + c_i V_{i+1}; one (m+1)^2 matrix per case.
    sq = (sigmas[:, None] * i_idx) ** 2                    # (B, m+1)
    drift = rates[:, None] * i_idx
    a = 0.5 * (sq - drift)
    b = -(sq + rates[:, None])
    c = 0.5 * (sq + drift)
    gen = (torch.diag_embed(a[:, 1:], -1) + torch.diag_embed(b)
           + torch.diag_embed(c[:, :-1], 1))
    eye = torch.eye(m + 1, **f64)
    half = 0.5 * dtau[:, None, None]
    a_mats = eye - half * gen
    b_mats = eye + half * gen
    # Dirichlet rows: boundary values are imposed through the rhs.
    bound = torch.zeros(m + 1, dtype=torch.bool, device=device)
    bound[0] = bound[m] = True
    a_mats = torch.where(bound[:, None], eye, a_mats)
    b_mats = torch.where(bound[:, None], 0.0 * b_mats, b_mats)
    props = torch.linalg.inv(a_mats)                       # (B, m+1, m+1)

    s_max = s_max_mult * strikes                           # (B,)
    grids = i_idx[None, :] * (s_max / m)[:, None]          # (B, m+1)
    v = torch.clamp(grids - strikes[:, None], min=0.0)

    # Upper-boundary values per step: V(S_max, tau) = S_max - K e^{-r tau}
    # at tau = (n+1) dtau after step n (marching tau 0 -> T).
    steps = torch.arange(1, n_time + 1, **f64)             # (N,)
    upper = s_max[None, :] - strikes[None, :] * torch.exp(
        -rates[None, :] * steps[:, None] * dtau[None, :])  # (N, B)
    for ub in upper:
        rhs = torch.bmm(b_mats, v[:, :, None])[:, :, 0]
        rhs[:, 0] = 0.0
        rhs[:, m] = ub
        v = torch.bmm(props, rhs[:, :, None])[:, :, 0]

    # Vectorized reads: linear interpolation at the spot, centered FD
    # delta off the same grid.
    ds = grids[:, 1] - grids[:, 0]
    prices = interp(spots, grids, v)
    deltas = (interp(spots + ds, grids, v)
              - interp(spots - ds, grids, v)) / (2 * ds)
    return prices, deltas


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(device="cuda"):
    rng = np.random.default_rng(3)
    n_cases = 16
    lo = np.array([b[0] for b in DOMAIN])
    hi = np.array([b[1] for b in DOMAIN])
    scen = lo + (hi - lo) * rng.uniform(0.1, 0.9, size=(n_cases, 5))
    s, k, t, sg, r = (scen[:, i] for i in range(5))
    exact = bs_price_np(scen)

    # ---- FDM baseline: every case in ONE batched CN solve ----
    times = []
    for _ in range(2):
        t0 = time.time()
        prices, deltas = crank_nicolson_batch(s, k, t, sg, r,
                                              device=device)
        _sync(device)
        times.append(time.time() - t0)
    prices = prices.cpu().numpy()

    err = np.abs(prices - exact) / np.abs(exact) * 100
    print(f"FDM Crank-Nicolson, {n_cases} cases batched "
          f"(160 space x 1000 time steps):")
    print(f"  one batch: {times[0]:.2f}s first / {times[1]:.2f}s again "
          f"({times[1] / n_cases * 1e3:.0f} ms/case)")
    print(f"  price error vs analytic: max {err.max():.3f}% / "
          f"mean {err.mean():.3f}%  (reference FDM baseline ~0.8%)")

    # ---- The same scenarios through the pricing proxy ----
    t0 = time.time()
    cheb = ChebyshevApproximation(bs_price_np, 5, DOMAIN, [11] * 5,
                                  vectorized=True, device=device)
    cheb.build(verbose=False)
    build_s = time.time() - t0
    proxy = cheb.vectorized_eval_batch(scen, [0] * 5)     # warm once
    t0 = time.time()
    proxy = cheb.vectorized_eval_batch(scen, [0] * 5)
    proxy_s = time.time() - t0
    perr = np.abs(np.asarray(proxy) - exact) / np.abs(exact) * 100
    print(f"Chebyshev proxy (11^5): build {build_s:.2f}s once, then "
          f"{n_cases} cases in {proxy_s * 1e3:.1f} ms")
    print(f"  price error vs analytic: max {perr.max():.4f}% / "
          f"mean {perr.mean():.4f}%")
    print(f"Amortization: the proxy answers every later scenario batch "
          f"~{max(times[1] / max(proxy_s, 1e-9), 1):,.0f}x faster than "
          f"re-running FDM.")

    assert err.max() < 1.0 and perr.max() < 1e-2
    assert np.all((deltas.cpu().numpy() > 0) & (deltas.cpu().numpy() < 1))
    return {"fdm_max_err_pct": float(err.max()),
            "fdm_mean_err_pct": float(err.mean()),
            "proxy_max_err_pct": float(perr.max()),
            "fdm_s": times[1], "proxy_s": proxy_s}


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)

"""Optional matplotlib plotting helpers shared by all interpolant classes.

A copy of ``pychebyshev_tpu.utils.viz``: host-side extras that plot the
NumPy values of ``vectorized_eval_batch``; every function raises
ImportError with guidance when matplotlib is unavailable.
"""

from __future__ import annotations

import numpy as np

__all__ = ["plot_1d_impl", "plot_2d_surface_impl", "plot_2d_contour_impl"]


def _require_matplotlib():
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError(
            "plotting requires matplotlib (optional dependency)"
        ) from e
    return plt


def _resolve_free_dims(interp, fixed, n_free):
    fixed = dict(fixed or {})
    free = [d for d in range(interp.num_dimensions) if d not in fixed]
    if len(free) != n_free:
        raise ValueError(
            f"need exactly {n_free} free dimension(s); "
            f"{len(free)} remain after fixing {sorted(fixed)}"
        )
    return free, fixed


def _eval_grid(interp, pts):
    return np.asarray(interp.vectorized_eval_batch(
        np.asarray(pts, dtype=float),
        [0] * interp.num_dimensions))


def plot_1d_impl(interp, ax=None, n_points=200, fixed=None):
    plt = _require_matplotlib()
    (free_dim,), fixed = _resolve_free_dims(interp, fixed, 1)
    lo, hi = interp.domain[free_dim]
    xs = np.linspace(lo, hi, n_points)
    pts = np.zeros((n_points, interp.num_dimensions))
    pts[:, free_dim] = xs
    for d, v in fixed.items():
        pts[:, d] = v
    ys = _eval_grid(interp, pts)
    if ax is None:
        _, ax = plt.subplots()
    ax.plot(xs, ys)
    ax.set_xlabel(f"dim {free_dim}")
    ax.set_ylabel("value")
    return ax


def _grid_2d(interp, n_points, fixed):
    (d0, d1), fixed = _resolve_free_dims(interp, fixed, 2)
    lo0, hi0 = interp.domain[d0]
    lo1, hi1 = interp.domain[d1]
    xs = np.linspace(lo0, hi0, n_points)
    ys = np.linspace(lo1, hi1, n_points)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    pts = np.zeros((n_points * n_points, interp.num_dimensions))
    pts[:, d0] = gx.ravel()
    pts[:, d1] = gy.ravel()
    for d, v in fixed.items():
        pts[:, d] = v
    zs = _eval_grid(interp, pts).reshape(n_points, n_points)
    return (d0, d1), gx, gy, zs


def plot_2d_surface_impl(interp, ax=None, n_points=50, fixed=None):
    plt = _require_matplotlib()
    (d0, d1), gx, gy, zs = _grid_2d(interp, n_points, fixed)
    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
    ax.plot_surface(gx, gy, zs, cmap="viridis")
    ax.set_xlabel(f"dim {d0}")
    ax.set_ylabel(f"dim {d1}")
    return ax


def plot_2d_contour_impl(interp, ax=None, n_points=50, n_levels=20,
                         fixed=None):
    plt = _require_matplotlib()
    (d0, d1), gx, gy, zs = _grid_2d(interp, n_points, fixed)
    if ax is None:
        _, ax = plt.subplots()
    cs = ax.contourf(gx, gy, zs, levels=n_levels, cmap="viridis")
    plt.colorbar(cs, ax=ax)
    ax.set_xlabel(f"dim {d0}")
    ax.set_ylabel(f"dim {d1}")
    return ax

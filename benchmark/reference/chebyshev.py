"""Chebyshev grids in plain NumPy, float64: nodes, barycentric weights,
differentiation matrices.

The nodes are the Chebyshev points of the first kind, scaled to the
interval and ascending.  The weights are the barycentric weights of
those nodes, 1 / prod_{k != j} (x_j - x_k), normalised by their largest
magnitude (a common factor cancels in the barycentric formula).  The
differentiation matrix maps an interpolant's values at the nodes to its
derivative's values there, so applying it k times along a dimension of
the value tensor gives the tensor of the k-th derivative's interpolant,
exactly in exact arithmetic.
"""

from __future__ import annotations

import numpy as np


def nodes(lo: float, hi: float, n: int) -> np.ndarray:
    """The n first-kind Chebyshev points of [lo, hi], ascending."""
    k = np.arange(n, dtype=np.float64)
    unit = -np.cos((2.0 * k + 1.0) * np.pi / (2.0 * n))
    return 0.5 * (lo + hi) + 0.5 * (hi - lo) * unit


def barycentric_weights(x: np.ndarray) -> np.ndarray:
    """w_j = 1 / prod_{k != j} (x_j - x_k), scaled to max |w| = 1."""
    x = np.asarray(x, dtype=np.float64)
    gaps = x[:, None] - x[None, :]
    np.fill_diagonal(gaps, 1.0)
    w = 1.0 / np.prod(gaps, axis=1)
    return w / np.abs(w).max()


def differentiation_matrix(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """D[i, j] = (w_j / w_i) / (x_i - x_j) for i != j, and each diagonal
    entry minus the sum of its row's others (a constant has derivative
    zero)."""
    x = np.asarray(x, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    n = x.shape[0]
    d = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i != j:
                d[i, j] = (w[j] / w[i]) / (x[i] - x[j])
        d[i, i] = -d[i].sum()
    return d


def grid_points(domain, n_nodes) -> np.ndarray:
    """Every point of the tensor grid, (prod(n_nodes), d), in C order
    (the last dimension varies fastest)."""
    axes = [nodes(lo, hi, n) for (lo, hi), n in zip(domain, n_nodes)]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], axis=1)

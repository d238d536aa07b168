"""Chebyshev grid metadata on the host: nodes, barycentric weights and
differentiation matrices; and the Chebyshev-Vandermonde rows of the
tensor-train chain, on the device.

Framework-free NumPy, identical to the JAX package's ``_np`` twins, so
the port's grid metadata is bitwise equal to the reference's.  These
are O(n) / O(n^2) build-time arrays, not query-path work.

- Type-I Chebyshev points, scaled to the physical domain, ascending.
- Barycentric weights ``w_i = 1 / prod_{j != i} (x_i - x_j)``,
  power-of-two normalized.
- Spectral differentiation matrix after Berrut & Trefethen (2004) §9.3.

``chebyshev_polynomial_matrix`` is the one torch function here: query
path work of ``ops.tt_eval``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "nodes_for_dim_np",
    "barycentric_weights_np",
    "differentiation_matrix_np",
    "chebyshev_polynomial_matrix",
]


@functools.lru_cache(maxsize=None)
def _chebpts1_np(n: int):
    k = np.arange(n, dtype=np.float64)
    return -np.cos(np.pi * (2.0 * k + 1.0) / (2.0 * n))


def nodes_for_dim_np(lo, hi, n: int):
    """Chebyshev Type-I nodes scaled to [lo, hi], ascending."""
    return np.ascontiguousarray(
        0.5 * (lo + hi) + 0.5 * (hi - lo) * _chebpts1_np(n))


def barycentric_weights_np(nodes):
    """Barycentric weights, power-of-two normalized.

    Rejects degenerate node sets (coinciding nodes from a crafted or
    near-collapsed domain, f64 over/underflow of the weight products)
    with a ValueError instead of silently emitting inf/NaN weights.
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    n = nodes.shape[0]
    if n <= 512:
        diff = nodes[:, None] - nodes[None, :]
        np.fill_diagonal(diff, 1.0)
        with np.errstate(divide="ignore", over="ignore",
                         invalid="ignore"):
            prod = np.prod(diff, axis=1)
            w = 1.0 / prod
        if np.isfinite(w).all() and not (w == 0.0).any():
            # Power-of-two normalization: exact, and keeps narrow-domain
            # weights inside f32 range.
            return w * 2.0 ** -np.round(np.log2(np.abs(w).max()))
        # Non-finite here is EITHER a truly degenerate grid OR mere
        # f64 over/underflow of the product (narrow domains make every
        # diff tiny).  The chunked path below distinguishes the two.

    # Overflow-free path: track a (mantissa, binary exponent) pair with
    # frexp renormalization per 512-column chunk (512 mantissas in
    # [0.5, 1) bottom out at 2^-512, inside f64 range) — the same
    # multiply sequence up to exact power-of-two rescaling.
    mant = np.ones(n)
    expo = np.zeros(n, dtype=np.int64)
    for start in range(0, n, 512):
        stop = min(start + 512, n)
        d = nodes[:, None] - nodes[None, start:stop]
        idx = np.arange(start, stop)
        d[idx, idx - start] = 1.0
        m, e = np.frexp(d)
        mant *= np.prod(m, axis=1)
        expo += e.sum(axis=1, dtype=np.int64)
        mant, e2 = np.frexp(mant)
        expo += e2
    # mant == 0 marks a coinciding-node row (frexp(0) -> (0, 0)).
    if (mant == 0.0).any():
        raise ValueError(
            "degenerate Chebyshev grid: coinciding nodes (collapsed "
            "domain?) give non-finite barycentric weights"
        )
    w = np.ldexp(1.0 / mant, (-expo + expo.min()).astype(np.int64))
    if not np.isfinite(w).all() or (w == 0.0).any():
        raise ValueError(
            "degenerate Chebyshev grid: coinciding nodes (collapsed "
            "domain?) give non-finite barycentric weights"
        )
    return w * 2.0 ** -np.round(np.log2(np.abs(w).max()))


def differentiation_matrix_np(nodes, weights):
    """Spectral differentiation matrix: ``D[i, j] = (w_j / w_i) /
    (x_i - x_j)`` off-diagonal, negative row sum on the diagonal."""
    nodes = np.asarray(nodes, dtype=np.float64)
    weights = np.asarray(weights, dtype=np.float64)
    c = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(c, 1.0)
    d = weights[None, :] / (c * weights[:, None])
    np.fill_diagonal(d, 0.0)
    np.fill_diagonal(d, -np.sum(d, axis=1))
    return d


def chebyshev_polynomial_matrix(x: torch.Tensor, n: int) -> torch.Tensor:
    """Matrix ``Q[m, k] = T_k(x[m])`` for ``k = 0..n-1``
    (Chebyshev-Vandermonde), in ``x``'s dtype.

    The three-term recurrence ``T_k = 2 x T_{k-1} - T_{k-2}``, not
    ``cos(k acos x)``: points outside [-1, 1] extrapolate as the
    polynomials do.
    """
    cols = [torch.ones_like(x)]
    if n > 1:
        cols.append(x)
    two_x = 2.0 * x
    for _ in range(2, n):
        cols.append(two_x * cols[-1] - cols[-2])
    return torch.stack(cols, dim=-1)

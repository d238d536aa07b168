"""Chebyshev value <-> coefficient transforms as explicit cosine matrices
(the error estimate's transform, the tensor-train cores' in both
directions, the DCT-III behind the quadrature weights, and
``values_to_coeffs`` on a torch tensor for the Sobol indices).

One constant matrix per n and direction bakes in the reference
convention (reverse to descending node order, DCT-II, divide by n, halve
c_0), so no other module reimplements it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["_coeff_matrix_np", "_synthesis_matrix_np", "_dct3_matrix_np",
           "values_to_coeffs"]


@functools.lru_cache(maxsize=None)
def _coeff_matrix_np(n: int) -> np.ndarray:
    """Values-at-ascending-Type-I-nodes -> Chebyshev coefficients c_0..c_{n-1}.

    Row k, applied to ascending values v_i:

        c_k = (2 - delta_{k0}) / n * sum_i v_i * cos(pi k (2(n-1-i)+1) / (2n))
    """
    k = np.arange(n, dtype=np.float64)[:, None]
    j = np.arange(n, dtype=np.float64)[None, :]  # descending-order index
    base = np.cos(np.pi * k * (2.0 * j + 1.0) / (2.0 * n))
    scale = np.full((n, 1), 2.0 / n)
    scale[0, 0] = 1.0 / n
    mat = scale * base
    # map from descending index j to ascending index i = n-1-j
    return np.ascontiguousarray(mat[:, ::-1])


@functools.lru_cache(maxsize=None)
def _synthesis_matrix_np(n: int) -> np.ndarray:
    """Chebyshev coefficients -> values at ascending Type-I nodes.

    ``S[i, k] = T_k(x_i)`` with ``x_i`` ascending Type-I points; the exact
    inverse of :func:`_coeff_matrix_np`.  Uses the closed form
    ``T_k(x_i) = cos(k * theta_i)`` with ``theta_i = (2(n-1-i)+1)pi/(2n)``.
    """
    i = np.arange(n, dtype=np.float64)
    theta = (2.0 * (n - 1 - i) + 1.0) * np.pi / (2.0 * n)
    k = np.arange(n, dtype=np.float64)
    return np.ascontiguousarray(np.cos(theta[:, None] * k[None, :]))


@functools.lru_cache(maxsize=None)
def _dct3_matrix_np(n: int) -> np.ndarray:
    """Unnormalized SciPy DCT-III as a matrix (used by Fejer weights).

    ``y[j] = x[0] + 2 * sum_{k>=1} x[k] cos(pi k (2j+1) / (2n))``.
    """
    j = np.arange(n, dtype=np.float64)[:, None]
    k = np.arange(n, dtype=np.float64)[None, :]
    mat = 2.0 * np.cos(np.pi * k * (2.0 * j + 1.0) / (2.0 * n))
    mat[:, 0] = 1.0
    return np.ascontiguousarray(mat)


def values_to_coeffs(values: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Chebyshev coefficients along ``axis`` from values at ascending
    nodes, on the tensor's device and in its dtype."""
    n = values.shape[axis]
    mat = torch.as_tensor(_coeff_matrix_np(n), dtype=values.dtype,
                          device=values.device)
    out = torch.tensordot(values, mat, dims=([axis], [1]))
    return torch.movedim(out, -1, axis)

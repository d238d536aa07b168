"""Fejer-1 quadrature weights for Type-I Chebyshev grids.

The port of ``pychebyshev_tpu.ops.quadrature``.  Follows Waldvogel
(2006): weights = DCT-III of the Chebyshev moments, divided by n, in
ascending node order.

- ``fejer1_weights`` and ``sub_interval_weights`` are host NumPy: tiny
  O(n) constants for one interval.  ``fejer1_weights`` is cached, so
  callers must not edit its result in place.
- ``chebyshev_moment_matrix`` and ``sub_interval_weight_matrix`` are
  their batched counterparts in PyTorch, one row per interval, on the
  bounds' device and in their dtype.  Float32 matmuls rely on torch's
  default ``allow_tf32 = False`` (full IEEE f32).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pychebyshev_tpu_torch.ops.dct import _dct3_matrix_np

__all__ = [
    "fejer1_weights",
    "sub_interval_weights",
    "chebyshev_moment_matrix",
    "sub_interval_weight_matrix",
]


@functools.lru_cache(maxsize=None)
def fejer1_weights(n: int) -> np.ndarray:
    """Fejer-1 weights on [-1, 1] for n Type-I nodes, ascending order.

    ``sum(w * f(nodes)) ~= integral_{-1}^{1} f``.
    """
    # Chebyshev moments: I_k = 2/(1-k^2) for even k, 0 for odd k.
    k = np.arange(n, dtype=np.float64)
    even = k % 2 == 0
    moments = np.zeros(n)
    moments[even] = 2.0 / (1.0 - k[even] * k[even])
    weights_desc = _dct3_matrix_np(n) @ moments / n
    return np.ascontiguousarray(weights_desc[::-1])


def sub_interval_weights(n: int, t_lo: float, t_hi: float) -> np.ndarray:
    """Quadrature weights for a sub-interval [t_lo, t_hi] of [-1, 1].

    Replaces the full-domain Chebyshev moments with sub-interval moments
    ``I_k = integral_{t_lo}^{t_hi} T_k(t) dt`` computed from the Chebyshev
    antiderivative identity, then applies the same DCT-III pipeline.
    Ascending node order.
    """
    # T_k(t) at the two endpoints for k = 0..n via the closed form
    # T_k(t) = cos(k arccos t) (valid since |t| <= 1).
    ks = np.arange(n + 1, dtype=np.float64)
    T_lo = np.cos(ks * np.arccos(np.clip(t_lo, -1.0, 1.0)))
    T_hi = np.cos(ks * np.arccos(np.clip(t_hi, -1.0, 1.0)))

    moments = np.zeros(n)
    moments[0] = t_hi - t_lo
    if n > 1:
        moments[1] = (t_hi * t_hi - t_lo * t_lo) / 2.0
    for k in range(2, n):
        moments[k] = 0.5 * (
            (T_hi[k + 1] - T_lo[k + 1]) / (k + 1)
            - (T_hi[k - 1] - T_lo[k - 1]) / (k - 1)
        )

    weights_desc = _dct3_matrix_np(n) @ moments / n
    return np.ascontiguousarray(weights_desc[::-1])


def chebyshev_moment_matrix(t_lo: torch.Tensor, t_hi: torch.Tensor,
                            n: int) -> torch.Tensor:
    """Batched sub-interval Chebyshev moments.

    For endpoint vectors ``t_lo``/``t_hi`` of shape (B,) returns the
    (B, n) matrix ``M[b, k] = integral_{t_lo[b]}^{t_hi[b]} T_k(t) dt``
    via the Chebyshev antiderivative identity.  Endpoints are clipped to
    [-1, 1] only for the ``arccos`` evaluation, as the host version does
    at domain-edge representation noise.
    """
    cols = [(t_hi - t_lo)[:, None]]
    if n > 1:
        cols.append(((t_hi * t_hi - t_lo * t_lo) * 0.5)[:, None])
    if n > 2:
        ks = torch.arange(n + 1, dtype=t_lo.dtype, device=t_lo.device)
        th_lo = torch.arccos(t_lo.clamp(-1.0, 1.0))[:, None]
        th_hi = torch.arccos(t_hi.clamp(-1.0, 1.0))[:, None]
        d_t = torch.cos(ks[None, :] * th_hi) - torch.cos(ks[None, :] * th_lo)
        kk = ks[2:n]
        cols.append(0.5 * (d_t[:, 3:n + 1] / (kk + 1.0)
                           - d_t[:, 1:n - 1] / (kk - 1.0)))
    return torch.cat(cols, dim=1)


@functools.lru_cache(maxsize=64)
def _dct3_tensor(n: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """The DCT-III matrix as a tensor (a copy; nothing edits it)."""
    return torch.tensor(_dct3_matrix_np(n), dtype=dtype, device=device)


def sub_interval_weight_matrix(n: int, t_lo: torch.Tensor,
                               t_hi: torch.Tensor) -> torch.Tensor:
    """Batched :func:`sub_interval_weights`: (B, n), ascending node order.

    ``sum(W[b] * f(nodes)) ~= integral_{t_lo[b]}^{t_hi[b]} f`` for the
    interpolant through n Type-I nodes.
    """
    moments = chebyshev_moment_matrix(t_lo, t_hi, n)
    dct3 = _dct3_tensor(n, moments.dtype, moments.device)
    # Torch has no negative strides: the reversal is a flip.
    return torch.flip(moments @ dct3.T, dims=[1]) / n

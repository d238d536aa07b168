"""Batched dense-tensor barycentric evaluation in plain PyTorch.

The port of ``pychebyshev_tpu.ops.eval``.  Per-dimension coefficient
rows are built for the whole batch at once and the value tensor is
contracted as a bilinear form:

    out[n] = sum_{a in L, b in R} W_L[n, a] * T2[a, b] * W_R[n, b]

with ``W_L`` / ``W_R`` the row-wise Kronecker (Khatri-Rao) products of
the rows of the left and right dimension groups.

- Derivative passes (spectral differentiation matrices) are
  point-independent, so they are applied to the tensor once per
  ``orders`` tuple.
- The exact-node case (|x - node| < 1e-14 -> take the nodal value) is
  a one-hot coefficient row, which reproduces an index select exactly.
- Works in float64 and float32; the caller picks the dtype through the
  tensors it passes.  Float32 matmuls rely on torch's default
  ``allow_tf32 = False`` (full IEEE f32).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from pychebyshev_tpu_torch.config import NODE_COINCIDENCE_TOL

__all__ = [
    "barycentric_coefficients",
    "apply_derivative_passes",
    "eval_batch",
    "eval_batch_models",
    "eval_batch_multi",
    "contract_dim_at_value",
]


def barycentric_coefficients(x: torch.Tensor, nodes: torch.Tensor,
                             weights: torch.Tensor) -> torch.Tensor:
    """Normalized barycentric coefficient rows for a batch of coordinates.

    ``x`` is (N,) coordinates in one dimension; ``nodes`` / ``weights``
    the (n,) grid of that dimension.  Returns (N, n) rows ``C`` with
    ``C[m] @ values == p(x[m])``: ``(w_i/(x-x_i)) / sum_j w_j/(x-x_j)``,
    or a one-hot row at the first node within 1e-14 of ``x``.
    """
    diff = x[:, None] - nodes[None, :]
    exact = diff.abs() < NODE_COINCIDENCE_TOL
    has_exact = exact.any(dim=1)
    safe = torch.where(exact, torch.ones_like(diff), diff)
    w_over_diff = weights[None, :] / safe
    interp = w_over_diff / w_over_diff.sum(dim=1, keepdim=True)
    # argmax returns the first maximal index, as jnp.argmax does; it
    # does not take bool, so count in int8.  The one-hot row compares
    # with an arange: ``one_hot`` reads its index's range on the host,
    # which ``torch.func.vmap`` refuses.
    first = exact.to(torch.int8).argmax(dim=1)
    one_hot = (first[:, None] == torch.arange(
        nodes.shape[0], device=first.device)).to(interp.dtype)
    return torch.where(has_exact[:, None], one_hot, interp)


def apply_derivative_passes(tensor: torch.Tensor,
                            diff_matrices: Sequence[torch.Tensor],
                            orders: Tuple[int, ...]) -> torch.Tensor:
    """Apply ``D_d^orders[d]`` along each axis d of the value tensor."""
    result = tensor
    for d, k in enumerate(orders):
        if k > 0:
            d_t = diff_matrices[d].T
            moved = torch.movedim(result, d, -1)
            for _ in range(k):
                moved = torch.matmul(moved, d_t)
            result = torch.movedim(moved, -1, d)
    return result


def _khatri_rao(rows: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row-wise Kronecker product: [(N, a), (N, b), ...] -> (N, a*b*...)."""
    out = rows[0]
    for r in rows[1:]:
        out = (out[:, :, None] * r[:, None, :]).reshape(
            out.shape[0], out.shape[1] * r.shape[1])
    return out


def _split_index(shape: Tuple[int, ...]) -> int:
    """Split grid dims into left/right groups for the bilinear contraction.

    Minimizes peak per-point traffic ~ 2 * prod(left) + prod(right).
    """
    d = len(shape)
    best_s, best_cost = 1, None
    for s in range(1, d):
        cost = 2 * math.prod(shape[:s]) + math.prod(shape[s:])
        if best_cost is None or cost < best_cost:
            best_s, best_cost = s, cost
    return best_s


def _contract(tensor: torch.Tensor,
              coeff_rows: Sequence[torch.Tensor]) -> torch.Tensor:
    """Contract the value tensor with per-dim (N, n_d) rows -> (N,)."""
    d = tensor.dim()
    if d == 1:
        return coeff_rows[0] @ tensor
    s = _split_index(tuple(tensor.shape))
    n_left = math.prod(tensor.shape[:s])
    n_right = math.prod(tensor.shape[s:])
    w_left = _khatri_rao(coeff_rows[:s])          # (N, nL)
    w_right = _khatri_rao(coeff_rows[s:])         # (N, nR)
    t2 = tensor.reshape(n_left, n_right)
    y = w_right @ t2.T                            # (N, nL)
    return (w_left * y).sum(dim=1)


# Batches whose (N, n_right) intermediate exceeds this many elements are
# processed in slices of fixed size, so memory stays bounded in N.
_MAX_INTERMEDIATE_ELEMS = 1 << 23


def _chunk_size(shape: Tuple[int, ...]) -> int:
    """Points per slice so the widest per-point intermediate stays under
    ``_MAX_INTERMEDIATE_ELEMS``."""
    if len(shape) == 1:
        per_point = shape[0]
    else:
        s = _split_index(shape)
        per_point = max(math.prod(shape[s:]), 2 * math.prod(shape[:s]))
    return max(256, _MAX_INTERMEDIATE_ELEMS // max(per_point, 1))


def _contract_batched(tensors, coeff_fn, points: torch.Tensor
                      ) -> torch.Tensor:
    """Shared coefficient rows contracted against one or more tensors.

    ``tensors`` may be a single tensor (returns (N,)) or a sequence of
    same-shape tensors (returns (len(tensors), N)): the rows are built
    once per slice and reused across tensors.  Large batches run as a
    loop over slices of ``_chunk_size`` points (the last one ragged).
    """
    single = isinstance(tensors, torch.Tensor)
    tensor_list = [tensors] if single else list(tensors)
    chunk = _chunk_size(tuple(tensor_list[0].shape))
    outs = []
    for start in range(0, points.shape[0], chunk):
        rows = coeff_fn(points[start:start + chunk])
        outs.append(torch.stack([_contract(t, rows) for t in tensor_list]))
    if outs:
        out = torch.cat(outs, dim=1)
    else:
        out = points.new_empty((len(tensor_list), 0),
                               dtype=tensor_list[0].dtype)
    return out[0] if single else out


def _coeff_fn(nodes, weights, dtype):
    def coeff_fn(pts):
        pts = pts.to(dtype)
        return [barycentric_coefficients(pts[:, d], nodes[d], weights[d])
                for d in range(len(nodes))]
    return coeff_fn


def eval_batch(tensor: torch.Tensor,
               nodes: Tuple[torch.Tensor, ...],
               weights: Tuple[torch.Tensor, ...],
               diff_matrices: Tuple[torch.Tensor, ...],
               points: torch.Tensor,
               orders: Tuple[int, ...]) -> torch.Tensor:
    """Evaluate the interpolant (or a mixed partial) at a batch of points.

    ``tensor`` is the (n_0, ..., n_{d-1}) value tensor, ``nodes`` /
    ``weights`` / ``diff_matrices`` the per-dim grid data, ``points``
    (N, d), ``orders`` the per-dim derivative orders.  Returns (N,).
    """
    t = apply_derivative_passes(tensor, diff_matrices, orders)
    return _contract_batched(t, _coeff_fn(nodes, weights, tensor.dtype),
                             points)


def eval_batch_models(tensors: Tuple[torch.Tensor, ...],
                      nodes: Tuple[torch.Tensor, ...],
                      weights: Tuple[torch.Tensor, ...],
                      diff_matrices: Tuple[torch.Tensor, ...],
                      points: torch.Tensor,
                      orders: Tuple[int, ...]) -> torch.Tensor:
    """Evaluate M same-grid value tensors at N points -> (M, N): one row
    build plus M GEMMs per slice."""
    ts = [apply_derivative_passes(t, diff_matrices, orders)
          for t in tensors]
    return _contract_batched(ts, _coeff_fn(nodes, weights, ts[0].dtype),
                             points)


def contract_dim_at_value(tensor: torch.Tensor, axis: int,
                          nodes: torch.Tensor, weights: torch.Tensor,
                          value) -> torch.Tensor:
    """Contract one tensor axis at a fixed coordinate (the slice
    operation): the barycentric row at ``value`` (one-hot, hence an exact
    index select, at a node within 1e-14) and a tensordot."""
    x = torch.tensor([float(value)], dtype=tensor.dtype,
                     device=tensor.device)
    row = barycentric_coefficients(x, nodes.to(tensor.dtype),
                                   weights.to(tensor.dtype))[0]
    return torch.tensordot(tensor, row, dims=([axis], [0]))


def eval_batch_multi(tensor: torch.Tensor,
                     nodes: Tuple[torch.Tensor, ...],
                     weights: Tuple[torch.Tensor, ...],
                     diff_matrices: Tuple[torch.Tensor, ...],
                     points: torch.Tensor,
                     orders_list: Tuple[Tuple[int, ...], ...]
                     ) -> torch.Tensor:
    """Batch x multi-derivative-spec evaluation -> (len(orders_list), N).

    Derivative passes are applied once per spec; the per-point rows are
    built once per slice and shared across all specs (price + Greeks).
    """
    tensors = [apply_derivative_passes(tensor, diff_matrices, orders)
               for orders in orders_list]
    return _contract_batched(tensors,
                             _coeff_fn(nodes, weights, tensor.dtype),
                             points)

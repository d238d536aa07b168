"""Batched evaluation of piecewise (spline) interpolants in plain PyTorch.

The port of ``pychebyshev_tpu.ops.spline_eval``.  A spline's pieces are
dense interpolants on the cells of a knot grid; a query is answered by
the piece whose cell holds it.  Two routes compute the same numbers
(every point's value comes from its own piece's barycentric
contraction either way):

- **masked**: the pieces' grids are stacked once into (P, ...) tensors,
  every piece evaluates the whole batch in one pass with the piece axis
  as a batch dimension (``torch.bmm``; ``jax.vmap`` in the reference),
  and each point keeps its own piece's value.  P x the work of one dense
  evaluation, no host round trip.
- **routed**: points are grouped by piece on the device (a stable sort
  of the piece indices) and each occupied piece evaluates its own
  points through ``ops.eval``.  1x the work, one pass per occupied
  piece and one device-to-host read of the group sizes.

Routing runs in f64 on the points' own device
(``torch.searchsorted(..., right=True)``): a point on a knot belongs to
the right piece, a point outside the domain to the boundary piece.  An
f32 caller routes on its f64 input and casts afterwards, so a point
within one f32 ulp of a knot is never sent to the wrong piece.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from pychebyshev_tpu_torch.config import NODE_COINCIDENCE_TOL
from pychebyshev_tpu_torch.ops import eval as eval_ops
from pychebyshev_tpu_torch.ops.eval import _split_index
from pychebyshev_tpu_torch.ops.tt_eval import _chunk_size

__all__ = ["masked_eval_batch", "masked_eval_batch_multi",
           "masked_eval_prepared", "stacked_derivative_passes",
           "routed_eval_batch", "routed_eval_batch_multi", "routed_apply",
           "route_piece_indices", "piece_strides", "stack_pieces",
           "MASKED_MAX_PIECES"]

# Largest piece count an f32 engine serves on the masked route (above it
# the routed route).  The reference's values (64 at f32, 32 at f64) were
# TPU measurements of a dispatch-bound relay.  This one comes from the
# sweep in ``chip_smoke.py`` (phase 22: masked against routed, routing
# included, at P = 2, 16, 64 pieces of 12^2 nodes, N = 2^20) on an
# NVIDIA H100 80GB HBM3 at 700 W: f32 masked 3.78 / 25.5 / 99.7 ms
# against routed 5.06 / 15.5 / 66.2 ms, f64 masked 5.22 / 35.2 /
# 138.8 ms against routed 3.69 / 15.8 / 69.6 ms (PERF.md).  Masked wins
# only at P = 2 in f32, so f64 (the class path and the f64 engines)
# always takes the routed route.
MASKED_MAX_PIECES = 2


def stack_pieces(pieces, dtype=None):
    """Stack per-piece grid data: (P, *grid) tensor, per-dim (P, n)
    nodes/weights and (P, n, n) differentiation matrices, on the pieces'
    device (copies: nothing aliases a piece's tensors)."""
    dtype = torch.float64 if dtype is None else dtype

    def stack(arrays):
        return torch.stack([a.to(dtype) for a in arrays])

    d = pieces[0].num_dimensions
    return (stack([p.tensor_values for p in pieces]),
            tuple(stack([p.nodes[k] for p in pieces]) for k in range(d)),
            tuple(stack([p.weights[k] for p in pieces]) for k in range(d)),
            tuple(stack([p.diff_matrices[k] for p in pieces])
                  for k in range(d)))


def piece_strides(knot_counts: Sequence[int]) -> Tuple[int, ...]:
    """C-order ravel strides of the piece grid with ``k_d + 1`` pieces
    per dim."""
    shape = [k + 1 for k in knot_counts]
    return tuple(int(np.prod(shape[d + 1:], dtype=np.int64))
                 for d in range(len(shape)))


def route_piece_indices(knots, strides: Sequence[int], points,
                        device=None) -> torch.Tensor:
    """Flat C-order piece index per point (int64, on the points' device),
    routed in f64.

    ``right=True`` is the reference's ``side='right'``: a point on a knot
    belongs to the right piece; a point outside the domain clamps to a
    boundary piece (searchsorted saturates).  Host input goes to
    ``device`` (default the CPU) straight as f64.
    """
    if isinstance(points, torch.Tensor):
        pts = points.to(torch.float64)
    else:
        pts = torch.as_tensor(np.asarray(points, dtype=np.float64),
                              device=device)
    flat = torch.zeros(pts.shape[0], dtype=torch.int64, device=pts.device)
    for d, kn in enumerate(knots):
        if len(kn):
            kn = torch.as_tensor(np.asarray(kn, dtype=np.float64),
                                 device=pts.device)
            cell = torch.searchsorted(kn, pts[:, d].contiguous(), right=True)
            flat += cell * int(strides[d])
    return flat


# ----------------------------------------------------------------------
# The masked route: every piece on every point, one batched pass, then
# each point keeps its own piece's value.
# ----------------------------------------------------------------------


def stacked_derivative_passes(tensors, diffs, orders):
    """``D_d^orders[d]`` along every piece's axis d of a (P, ...) stack."""
    result = tensors
    for d, k in enumerate(orders):
        if k > 0:
            d_t = diffs[d].transpose(1, 2)                   # (P, n, n)
            moved = torch.movedim(result, d + 1, -1)
            shape = moved.shape
            flat = moved.reshape(shape[0], -1, shape[-1])
            for _ in range(k):
                flat = torch.bmm(flat, d_t)
            result = torch.movedim(flat.reshape(shape), -1, d + 1)
    return result


def _rows(x, nodes, weights):
    """(G, N, n) normalized barycentric rows of coordinates ``x`` (N,)
    on G stacked grids ``nodes``/``weights`` (G, n): the batched form of
    ``ops.eval.barycentric_coefficients`` (one-hot at a node within
    1e-14)."""
    diff = x[None, :, None] - nodes[:, None, :]
    exact = diff.abs() < NODE_COINCIDENCE_TOL
    has_exact = exact.any(dim=-1)
    safe = torch.where(exact, torch.ones_like(diff), diff)
    w_over_diff = weights[:, None, :] / safe
    interp = w_over_diff / w_over_diff.sum(dim=-1, keepdim=True)
    first = exact.to(torch.int8).argmax(dim=-1)
    one_hot = (first[..., None] == torch.arange(
        nodes.shape[-1], device=first.device)).to(interp.dtype)
    return torch.where(has_exact[..., None], one_hot, interp)


def _khatri_rao(rows):
    out = rows[0]
    for r in rows[1:]:
        g, n = out.shape[0], out.shape[1]
        out = (out[..., :, None] * r[..., None, :]).reshape(g, n, -1)
    return out


def _contract(tensors, rows):
    """(G, N): each of G stacked tensors (G, *shape) against its own
    per-dim (G, N, n_d) rows; the bilinear form of ``ops.eval``."""
    shape = tuple(int(n) for n in tensors.shape[1:])
    g = tensors.shape[0]
    if len(shape) == 1:
        return torch.bmm(rows[0], tensors[:, :, None])[..., 0]
    s = _split_index(shape)
    w_left = _khatri_rao(rows[:s])                           # (G, N, nL)
    w_right = _khatri_rao(rows[s:])                          # (G, N, nR)
    t2 = tensors.reshape(g, math.prod(shape[:s]), math.prod(shape[s:]))
    y = torch.bmm(w_right, t2.transpose(1, 2))               # (G, N, nL)
    return (w_left * y).sum(dim=-1)


def _per_point(shape, specs: int, pieces: int) -> int:
    """Elements held per point while the stacked pieces are evaluated."""
    s = _split_index(shape) if len(shape) > 1 else 1
    return pieces * (sum(shape) + math.prod(shape[s:])
                     + specs * 2 * math.prod(shape[:s]))


def _masked(spec_tensors, nodes, weights, flat, points):
    """(S, N): S stacked (P, ...) spec tensors of one piece grid, each
    point taking its own piece's values."""
    p = spec_tensors[0].shape[0]
    shape = tuple(int(n) for n in spec_tensors[0].shape[1:])
    n_pts = points.shape[0]
    out = points.new_empty((len(spec_tensors), n_pts))
    step = _chunk_size(_per_point(shape, len(spec_tensors), p),
                       points.device, points.element_size())
    for start in range(0, n_pts, step):
        pts = points[start:start + step]
        rows = [_rows(pts[:, d], nodes[d], weights[d])
                for d in range(len(shape))]
        vals = torch.stack([_contract(t, rows)
                            for t in spec_tensors])          # (S, P, n)
        sel = flat[start:start + step][None, None, :]
        out[:, start:start + step] = vals.gather(
            1, sel.expand(vals.shape[0], 1, -1))[:, 0]
    return out


def masked_eval_batch(tensors, nodes, weights, diffs, flat, points,
                      orders: Tuple[int, ...]) -> torch.Tensor:
    """All-pieces evaluation and each point's own piece, -> (N,).

    Parameters
    ----------
    tensors : (P, n_0, ..., n_{d-1}) stacked piece values (sets the
        evaluation dtype).
    nodes / weights : per-dim tuples of (P, n_k) stacked grids.
    diffs : per-dim tuple of (P, n_k, n_k) differentiation matrices.
    flat : (N,) flat piece index per point (:func:`route_piece_indices`,
        routed in f64).
    points : (N, d) queries (cast to the tensor dtype).
    orders : per-dim derivative orders.
    """
    pts = points.to(tensors.dtype)
    t = stacked_derivative_passes(tensors, diffs, tuple(orders))
    return _masked((t,), nodes, weights, flat.to(pts.device), pts)[0]


def masked_eval_batch_multi(tensors, nodes, weights, diffs, flat, points,
                            orders_list) -> torch.Tensor:
    """All pieces x all derivative specs -> (S, N).

    Each piece builds its barycentric rows once per slice and shares
    them across every spec.  A point on a knot takes the right piece's one-sided derivative (the
    batched paths never raise; single-point ``eval`` holds the guard).
    """
    specs = tuple(stacked_derivative_passes(tensors, diffs, tuple(o))
                  for o in orders_list)
    return masked_eval_prepared(specs, nodes, weights, flat, points)


def masked_eval_prepared(spec_tensors, nodes, weights, flat,
                         points) -> torch.Tensor:
    """:func:`masked_eval_batch_multi` on (P, ...) stacks whose
    derivative passes are already applied (a serving engine's hoisted
    specs) -> (S, N)."""
    pts = points.to(spec_tensors[0].dtype)
    return _masked(tuple(spec_tensors), nodes, weights, flat.to(pts.device),
                   pts)


# ----------------------------------------------------------------------
# The routed route: points grouped by piece on the device.
# ----------------------------------------------------------------------


def routed_apply(flat, points, run: Callable, n_cols: int = None,
                 dtype=None) -> torch.Tensor:
    """``run(piece_index, piece_points)`` on each occupied piece's points,
    gathered back into (N,) (or (N, n_cols)) point order.

    The points are grouped by a stable sort of ``flat`` on the device;
    the group sizes come to the host in one read.
    """
    dtype = points.dtype if dtype is None else dtype
    n = points.shape[0]
    out = points.new_empty((n,) if n_cols is None else (n, n_cols),
                           dtype=dtype)
    if n == 0:
        return out
    order = torch.argsort(flat, stable=True)
    ids, counts = torch.unique_consecutive(flat[order], return_counts=True)
    start = 0
    for idx, count in zip(ids.tolist(), counts.tolist()):
        sel = order[start:start + count]
        out[sel] = run(int(idx), points[sel]).to(dtype)
        start += count
    return out


def routed_eval_batch(piece_arrays, flat, points, orders) -> torch.Tensor:
    """Routed evaluation -> (N,): ``piece_arrays[i]`` is piece i's
    ``(tensor, nodes, weights, diffs)`` (its dtype sets the points')."""
    orders = tuple(orders)

    def run(i, pts):
        tensor, nodes, weights, diffs = piece_arrays[i]
        return eval_ops.eval_batch(tensor, nodes, weights, diffs,
                                   pts.to(tensor.dtype), orders)
    return routed_apply(flat, points, run,
                        dtype=piece_arrays[0][0].dtype)


def routed_eval_batch_multi(piece_arrays, flat, points,
                            orders_list) -> torch.Tensor:
    """Routed multi-spec evaluation -> (N, S): each occupied piece's
    rows shared across the specs (``ops.eval.eval_batch_multi``)."""
    orders_list = tuple(tuple(o) for o in orders_list)

    def run(i, pts):
        tensor, nodes, weights, diffs = piece_arrays[i]
        return eval_ops.eval_batch_multi(tensor, nodes, weights, diffs,
                                         pts.to(tensor.dtype),
                                         orders_list).T
    return routed_apply(flat, points, run, n_cols=len(orders_list),
                        dtype=piece_arrays[0][0].dtype)

"""Batched axis-aligned-box integration in plain PyTorch.

The port of ``pychebyshev_tpu.ops.integrate``.  A batch of boxes is
integrated in one pass by swapping the evaluation paths' per-point rows
for per-box sub-interval quadrature rows:

    dense:  out[b] = sum_idx T[idx] * prod_d w_d[b, idx_d]
            (w_d = sub-interval Fejer weights scaled by the dim measure)
    TT:     the rank chain of ``ops.tt_eval`` with the Chebyshev
            polynomial rows replaced by Chebyshev moment rows

Both reuse the evaluation machinery as it is: the dense bilinear
contraction of ``ops.eval._contract_batched`` (sliced by its
``_chunk_size``) and the chain stage of ``ops.tt_eval``.  Conditional
expectations mix the two kinds of row: quadrature rows on the
integrated dims, evaluation rows on the others.

The JAX package computes all of this in XLA, outside any hand-written
kernel, so the products here stay ``torch.matmul``.  Float32 matmuls
rely on torch's default ``allow_tf32 = False`` (full IEEE f32).

The near-f64 ("dd") names keep the reference's signatures, refusals and
error texts, and are served in native f64: the reference's digit-plane
GEMMs exist because TPU v5e has no f64, and f64 is inside every cutoff's
error.  ``groups`` selects the TT chain's grouping as in
``ops.tt_eval_dd``.
"""

from __future__ import annotations

import numpy as np
import torch

from pychebyshev_tpu_torch.ops import eval as eval_ops
from pychebyshev_tpu_torch.ops import eval_dd, tt_eval, tt_eval_dd
from pychebyshev_tpu_torch.ops.chebyshev import chebyshev_polynomial_matrix
from pychebyshev_tpu_torch.ops.quadrature import (
    chebyshev_moment_matrix,
    sub_interval_weight_matrix,
)

__all__ = ["tier", "host_array",
           "integrate_box_batch", "integrate_box_batch_dd",
           "integrate_box_batch_models",
           "integrate_box_batch_models_dd",
           "partial_integrate_eval_batch",
           "partial_integrate_eval_batch_dd",
           "tt_integrate_box_batch", "tt_integrate_box_batch_dd",
           "tt_partial_integrate_eval_batch",
           "tt_partial_integrate_eval_batch_dd"]


def tier(dtype):
    """A class method's ``dtype=`` as ``"dd"`` or a torch float dtype
    (None is f64)."""
    if dtype is None:
        return torch.float64
    if (isinstance(dtype, str) and dtype == "dd") or dtype in (
            torch.float32, torch.float64):
        return dtype
    raise ValueError(f"dtype must be None, torch.float32, torch.float64 "
                     f"or 'dd', got {dtype!r}")


def host_array(x):
    """Host NumPy of a tensor argument, anything else as it is: the
    calculus validation (``utils.calculus``) reads NumPy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def _device_of(x) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def _on(x, dtype, device) -> torch.Tensor:
    """``x`` (a tensor, array or nested list) as a ``dtype`` tensor on
    ``device``; host input goes through f64 NumPy, never through f32."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                           device=device)


# --- dense ------------------------------------------------------------------


def _scaled_interval_row(matrix_fn, n, a, c, b_lo, b_hi):
    """(B, n) sub-interval rows for one dim: affine-scale the bounds to
    [-1, 1], build rows with ``matrix_fn``, scale by the dim measure,
    and zero degenerate intervals EXACTLY.

    The degenerate mask compares the RAW bounds: the scaling can round
    the lo and hi columns an ulp apart, leaving ~1e-20 residue in rows
    of a zero-measure interval that must integrate to an exact 0.  One
    helper for both the dense (Fejer weights, value space) and TT
    (Chebyshev moments, coefficient space) paths so the scaling and the
    mask cannot drift.
    """
    half = (c - a) * 0.5
    t_lo = 2.0 * (b_lo - a) / (c - a) - 1.0
    t_hi = 2.0 * (b_hi - a) / (c - a) - 1.0
    rows = matrix_fn(t_lo, t_hi, n) * half
    return rows.masked_fill((b_lo == b_hi)[:, None], 0.0)


def _quadrature_row(n, a, c, b_lo, b_hi):
    """Dense-path (B, n) sub-interval Fejer weight rows (value space)."""
    return _scaled_interval_row(
        lambda lo_t, hi_t, m: sub_interval_weight_matrix(m, lo_t, hi_t),
        n, a, c, b_lo, b_hi)


def _moment_row(n, a, c, b_lo, b_hi):
    """TT-path (B, n) Chebyshev moment rows (coefficient space)."""
    return _scaled_interval_row(chebyshev_moment_matrix, n, a, c, b_lo,
                                b_hi)


def _quadrature_coeff_fn(shape, lo, hi):
    """Per-box quadrature rows for a d-dim grid: the integration analog
    of the barycentric rows the evaluation paths build."""
    d = len(shape)

    def coeff_fn(bf):
        boxes = bf.reshape(bf.shape[0], d, 2)
        return [_quadrature_row(shape[dim], lo[dim], hi[dim],
                                boxes[:, dim, 0], boxes[:, dim, 1])
                for dim in range(d)]

    return coeff_fn


def _boxes(tensors, domain, bounds, dtype):
    """(tensors, lo, hi, flat bounds) at ``dtype`` on the tensors'
    device."""
    device = _device_of(tensors[0])
    ts = [_on(t, dtype, device) for t in tensors]
    dom = _on(domain, dtype, device)
    b = _on(bounds, dtype, device)
    return ts, dom[:, 0], dom[:, 1], b.reshape(b.shape[0], 2 * ts[0].dim())


def integrate_box_batch(tensor, domain, bounds,
                        dtype=torch.float64) -> torch.Tensor:
    """Integrals of the dense interpolant over (B, d, 2) boxes -> (B,).

    Parameters
    ----------
    tensor : (n_0, ..., n_{d-1}) value tensor; its device is where the
        contraction runs.
    domain : (d, 2) per-dim [lo, hi].
    bounds : (B, d, 2) per-box per-dim (lo, hi), inside the domain
        (callers validate through ``utils.calculus.normalize_bounds_batch``).
    dtype : ``torch.float64`` (default, the parity tier) or
        ``torch.float32`` (the throughput tier).
    """
    (t,), lo, hi, bf = _boxes([tensor], domain, bounds, dtype)
    return eval_ops._contract_batched(
        t, _quadrature_coeff_fn(tuple(t.shape), lo, hi), bf)


def integrate_box_batch_models(tensors, domain, bounds,
                               dtype=torch.float64) -> torch.Tensor:
    """Box integrals of M same-grid value tensors -> (M, B).

    The book analog of :func:`integrate_box_batch`: the per-box
    quadrature rows are built once per slice and contracted against
    every tensor (one row build plus M GEMMs).
    """
    ts, lo, hi, bf = _boxes(list(tensors), domain, bounds, dtype)
    return eval_ops._contract_batched(
        ts, _quadrature_coeff_fn(tuple(ts[0].shape), lo, hi), bf)


def partial_integrate_eval_batch(tensor, domain, nodes, weights,
                                 diff_matrices, int_dims, bounds, points,
                                 orders=None,
                                 dtype=torch.float64) -> torch.Tensor:
    """Conditional expectations in one pass: integrate over the
    ``int_dims`` boxes, evaluate at the remaining dims' coordinates.

        out[b] = (d^|orders| / dx^orders)
                 int_{bounds[b]} f(x_S, points[b]) dx_S

    Mixed per-dim rows through the same bilinear contraction as
    ``eval_batch``: quadrature rows for integrated dims, barycentric
    rows for the rest, against the derivative-folded tensor.

    Parameters
    ----------
    tensor : (n_0, ..., n_{d-1}) value tensor.
    domain : (d, 2); nodes/weights/diff_matrices : per-dim grid data.
    int_dims : sorted tuple of integrated dims.
    bounds : (B, |int_dims|, 2) per-scenario boxes (int_dims order).
    points : (B, d - |int_dims|) remaining-dim coordinates (ascending
        remaining-dim order).
    orders : per-TENSOR-dim derivative orders (zeros on int_dims), or
        None.  The passes run in f64, before any cast to ``dtype``.
    """
    device = _device_of(tensor)
    d = tensor.dim() if isinstance(tensor, torch.Tensor) else np.ndim(tensor)
    int_dims = tuple(int(k) for k in int_dims)
    orders = tuple(int(o) for o in (orders or (0,) * d))
    t64 = _on(tensor, torch.float64, device)
    diffs = tuple(_on(m, torch.float64, device) for m in diff_matrices)
    t = eval_ops.apply_derivative_passes(t64, diffs, orders).to(dtype)
    dom = _on(domain, dtype, device)
    lo, hi = dom[:, 0], dom[:, 1]
    nodes = tuple(_on(x, dtype, device) for x in nodes)
    weights = tuple(_on(w, dtype, device) for w in weights)
    n_int = len(int_dims)
    b = _on(bounds, dtype, device).reshape(-1, 2 * n_int)
    p = _on(points, dtype, device).reshape(b.shape[0], d - n_int)
    packed = torch.cat([b, p], dim=1)
    int_pos = {dim: i for i, dim in enumerate(int_dims)}
    eval_pos = {dim: i for i, dim in
                enumerate(k for k in range(d) if k not in int_pos)}

    def coeff_fn(pk):
        boxes = pk[:, :2 * n_int].reshape(pk.shape[0], n_int, 2)
        pts = pk[:, 2 * n_int:]
        rows = []
        for dim in range(d):
            if dim in int_pos:
                i = int_pos[dim]
                rows.append(_quadrature_row(
                    t.shape[dim], lo[dim], hi[dim],
                    boxes[:, i, 0], boxes[:, i, 1]))
            else:
                rows.append(eval_ops.barycentric_coefficients(
                    pts[:, eval_pos[dim]], nodes[dim], weights[dim]))
        return rows

    return eval_ops._contract_batched(t, coeff_fn, packed)


# --- dense, near-f64 names (native f64) -------------------------------------


def _check_dd_grid(shape, fallback: str) -> None:
    if not eval_dd.supports_dd(shape):
        raise ValueError(
            f"grid shape {shape} outside digit-GEMM budget; "
            f"use {fallback}")


def integrate_box_batch_dd(tensor, domain, bounds,
                           cutoff: int = None) -> torch.Tensor:
    """Near-f64 batched box integration, served in native f64.

    The reference's dd tier of :func:`integrate_box_batch`: the same
    grids are accepted (``ops.eval_dd.supports_dd``, else ``ValueError``
    and callers fall back to f64); ``cutoff`` is validated and accepted.
    """
    shape = tuple(int(n) for n in tensor.shape)
    _check_dd_grid(shape, "integrate_box_batch")
    eval_dd._check_cutoff(cutoff)
    return integrate_box_batch(tensor, domain, bounds, dtype=torch.float64)


def integrate_box_batch_models_dd(tensors, domain, bounds,
                                  cutoff: int = None) -> torch.Tensor:
    """Near-f64 book bucket masses -> (M, B), served in native f64."""
    tensors = tuple(tensors)
    if not tensors:
        raise ValueError("tensors must be a non-empty sequence")
    shape = tuple(int(n) for n in tensors[0].shape)
    if any(tuple(int(n) for n in t.shape) != shape for t in tensors):
        raise ValueError("all tensors must share one grid shape")
    _check_dd_grid(shape, "integrate_box_batch_models")
    eval_dd._check_cutoff(cutoff)
    return integrate_box_batch_models(tensors, domain, bounds,
                                      dtype=torch.float64)


def partial_integrate_eval_batch_dd(tensor, domain, nodes, weights,
                                    diff_matrices, int_dims, bounds,
                                    points, orders=None,
                                    cutoff: int = None) -> torch.Tensor:
    """Near-f64 batched conditional expectations, served in native f64.

    Same signature and semantics as :func:`partial_integrate_eval_batch`,
    with the reference's refusals: derivative orders on integrated dims,
    and grids outside ``ops.eval_dd.supports_dd`` (callers fall back to
    f64).
    """
    shape = tuple(int(n) for n in tensor.shape)
    d = len(shape)
    int_dims = tuple(int(k) for k in int_dims)
    orders = tuple(int(o) for o in (orders or (0,) * d))
    if any(orders[k] > 0 for k in int_dims):
        raise ValueError(
            f"derivative orders {orders} nonzero on integrated dims "
            f"{int_dims}")
    _check_dd_grid(shape, "partial_integrate_eval_batch")
    eval_dd._check_cutoff(cutoff)
    return partial_integrate_eval_batch(
        tensor, domain, nodes, weights, diff_matrices, int_dims, bounds,
        points, orders=orders, dtype=torch.float64)


# --- tensor train -----------------------------------------------------------


def _tt_chain_rows(cores, row_fns, packed, slices):
    """The ``ops.tt_eval`` chain with arbitrary per-dim row builders.

    ``row_fns[d](packed)`` gives dim d's (B, n_d) rows (moment rows for
    integrated dims, polynomial rows for evaluated dims).  ``slices``
    gives each core's (start, stop) dims: a merged supercore's row is the
    Khatri-Rao product of its dims' rows, as in the grouped chain.
    """
    row = packed.new_ones((packed.shape[0], 1))
    for core, (a, z) in zip(cores, slices):
        q = eval_ops._khatri_rao([row_fns[k](packed) for k in range(a, z)])
        row = tt_eval._stage(row, core, q)
    return row[:, 0]


def _tt_run(coeff_cores, domain, int_dims, bounds, points, dtype,
            groups):
    """The chain over B scenarios: moment rows on ``int_dims`` from the
    (B, |int_dims|, 2) ``bounds``, polynomial rows on the other dims from
    the (B, d - |int_dims|) ``points`` (None when every dim is
    integrated), in slices.  ``groups`` (sizes, or None for per-dim)
    merges cores exactly."""
    coeff_cores = tuple(coeff_cores)
    device = _device_of(coeff_cores[0])
    shapes = tt_eval.core_shapes(coeff_cores)
    d = len(shapes)
    n_int = len(int_dims)
    dom = _on(domain, dtype, device)
    b = _on(bounds, dtype, device).reshape(-1, 2 * n_int)
    packed = b if points is None else torch.cat(
        [b, _on(points, dtype, device).reshape(b.shape[0], d - n_int)],
        dim=1)
    if groups is None:
        cores = tuple(_on(c, dtype, device) for c in coeff_cores)
        slices = tuple((k, k + 1) for k in range(d))
    else:
        cores = tt_eval._merged_cores_device(coeff_cores, groups, dtype,
                                             device)
        slices = tt_eval.group_slices(groups)
    int_pos = {dim: i for i, dim in enumerate(int_dims)}
    eval_col = {k: 2 * n_int + j for j, k in
                enumerate(k for k in range(d) if k not in int_pos)}

    def row_fn(dim, n, lo, hi):
        if dim in int_pos:
            i = int_pos[dim]
            return lambda pk: _moment_row(n, lo, hi, pk[:, 2 * i],
                                          pk[:, 2 * i + 1])
        j = eval_col[dim]
        return lambda pk: chebyshev_polynomial_matrix(
            2.0 * (pk[:, j] - lo) / (hi - lo) - 1.0, n)

    row_fns = [row_fn(k, s[1], dom[k, 0], dom[k, 1])
               for k, s in enumerate(shapes)]
    per_point = max(int(c.shape[1] * c.shape[2]) for c in cores)
    return tt_eval._sliced(
        lambda pk: _tt_chain_rows(cores, row_fns, pk, slices),
        packed, per_point, (), dtype)


def tt_integrate_box_batch(coeff_cores, domain, bounds,
                           dtype=torch.float64) -> torch.Tensor:
    """Integrals of a TT over (B, d, 2) boxes -> (B,).

    In coefficient space the box integral is the evaluation chain with
    the polynomial rows T_k(t) replaced by their sub-interval moments
    (``ops.quadrature.chebyshev_moment_matrix``).

    Parameters
    ----------
    coeff_cores : sequence of (r_{k-1}, n_k, r_k) tensors or arrays
        (storage frame); a tensor's device is where the chain runs.
    domain : (d, 2) per-dim [lo, hi] (storage frame).
    bounds : (B, d, 2) boxes (storage frame).
    dtype : ``torch.float64`` (default) or ``torch.float32``.
    """
    return _tt_run(coeff_cores, domain, tuple(range(len(coeff_cores))),
                   bounds, None, dtype, None)


def tt_partial_integrate_eval_batch(coeff_cores, domain, int_dims,
                                    bounds, points,
                                    dtype=torch.float64) -> torch.Tensor:
    """TT conditional expectations in one pass (storage frame).

    The rank chain with moment rows on ``int_dims`` (per-scenario boxes)
    and Chebyshev polynomial rows on the remaining dims (per-scenario
    coordinates); value only.
    """
    return _tt_run(coeff_cores, domain, tuple(int(k) for k in int_dims),
                   bounds, points, dtype, None)


def _resolve_tt_dd_groups(shapes, groups, cutoff):
    """The dd tier's ``groups`` ("auto", None or sizes) as validated
    sizes, or None for the per-dim chain, with the reference's refusals
    and error texts."""
    tt_eval_dd._check_cutoff(cutoff)
    plan = tt_eval_dd.tt_dd_plan(shapes, cutoff)
    if not plan["ok"]:
        raise ValueError(
            f"TT core shapes {shapes} outside the digit-GEMM budget; "
            f"use the f64 path")
    if isinstance(groups, str) and groups == "auto":
        groups = tt_eval_dd.tt_dd_auto_groups(shapes, plan["cutoff"])
    if groups is None:
        groups = (1,) * len(shapes)
    groups = tuple(int(g) for g in groups)
    if any(g < 1 for g in groups) or sum(groups) != len(shapes):
        raise ValueError(
            f"groups {groups} must be positive and sum to the "
            f"number of cores ({len(shapes)})")
    gplan = tt_eval_dd.tt_dd_plan(tt_eval_dd._merged_shapes(shapes, groups),
                                  plan["cutoff"])
    if not gplan["ok"]:
        raise ValueError(
            f"grouped shapes outside the digit-GEMM budget; loosen "
            f"groups={groups}")
    return None if groups == (1,) * len(shapes) else groups


def tt_integrate_box_batch_dd(coeff_cores, domain, bounds,
                              cutoff: int = None,
                              groups="auto") -> torch.Tensor:
    """Near-f64 batched TT box integration, served in native f64.

    The reference's dd tier of :func:`tt_integrate_box_batch`, with its
    refusals; ``groups`` as in ``ops.tt_eval_dd.tt_eval_batch_dd``
    (``"auto"``, None for per-dim, or contiguous sizes): a grouping
    merges cores exactly, so results agree to rounding.
    """
    shapes = tt_eval.core_shapes(coeff_cores)
    groups = _resolve_tt_dd_groups(shapes, groups, cutoff)
    return _tt_run(coeff_cores, domain, tuple(range(len(shapes))), bounds,
                   None, torch.float64, groups)


def tt_partial_integrate_eval_batch_dd(coeff_cores, domain, int_dims,
                                       bounds, points,
                                       cutoff: int = None,
                                       groups="auto") -> torch.Tensor:
    """Near-f64 TT conditional expectations, served in native f64
    (storage frame, value only); refusals and ``groups`` as in
    :func:`tt_integrate_box_batch_dd`."""
    shapes = tt_eval.core_shapes(coeff_cores)
    groups = _resolve_tt_dd_groups(shapes, groups, cutoff)
    return _tt_run(coeff_cores, domain, tuple(int(k) for k in int_dims),
                   bounds, points, torch.float64, groups)

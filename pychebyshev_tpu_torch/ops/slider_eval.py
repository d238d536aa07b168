"""Batched evaluation of a slider's additive sum in plain PyTorch.

The port of ``pychebyshev_tpu.ops.slider_eval``.  A slider value query
is ``pivot + sum_i (s_i(x_{G_i}) - pivot)`` over low-dimensional slides
of heterogeneous shapes: ``slider_value_batch`` sums the slides' batched
evaluations (``ops.eval``), ``slider_multi_batch`` serves a Greek set
(the value sum at most once, one owning-slide evaluation per derivative
spec, exact zeros for a spec that crosses groups).

The near-f64 "dd" entry points keep the reference's API and its plan's
refusals (``slider_dd_plan``: the same shape arithmetic, so the same
sliders are served and refused), and compute in native f64 as one
contraction: every slide's barycentric rows, Khatri-Rao'd within its
group, put side by side into (N, K) rows, against the slide tensors
stacked into (K, M), a column per spec (zero outside the owning slide
of a derivative spec).  The slide sum evaluates every slide and then
each derivative spec's slide again; this builds each slide's rows once
and runs one GEMM, fewer launches for a Greek set (PERF.md).
The reference's digit planes (``_dd_row_planes``, ``_dd_ladder``,
``_slider_planes``, ``_compiled_*`` and the plane cache) are TPU
arithmetic for hardware without f64 and are not ported.  ``cutoff`` is
validated and accepted; f64 is inside every cutoff's error.
``slider_dd_multi_runner(mesh=)`` serves the points data-parallel.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from pychebyshev_tpu_torch.ops import eval as eval_ops
from pychebyshev_tpu_torch.ops.eval import (
    _khatri_rao,
    apply_derivative_passes,
    barycentric_coefficients,
)
from pychebyshev_tpu_torch.ops.eval_dd import _check_cutoff
from pychebyshev_tpu_torch.ops.tt_eval import _chunk_size
from pychebyshev_tpu_torch.parallel.sharding import (
    _dp_runner,
    _tree_on_mesh,
)

__all__ = ["slider_value_batch", "slider_multi_batch", "spec_plan",
           "slider_batch_dd", "slider_multi_batch_dd",
           "slider_dd_multi_runner", "slider_dd_plan"]

#: The reference's default digit-pair cutoff (accepted; see the module
#: note).
_PAIR_CUTOFF = 44


def slider_value_batch(slide_data, pivot_value,
                       groups: Tuple[Tuple[int, ...], ...],
                       points) -> torch.Tensor:
    """Sum of all slides' batched values -> (N,).

    Parameters
    ----------
    slide_data : tuple of (tensor, nodes, weights, diffs) per slide; the
        tensors' dtype is the evaluation dtype.
    pivot_value : f(z), a float or a 0-d tensor.
    groups : per-slide global dim indices.
    points : (N, d) query points (the caller's dtype governs).
    """
    total = None
    for (tensor, nodes, weights, diffs), group in zip(slide_data, groups):
        vals = eval_ops.eval_batch(tensor, nodes, weights, diffs,
                                   points[:, list(group)],
                                   (0,) * len(group))
        total = vals if total is None else total + vals
    return total - (len(groups) - 1) * pivot_value


def slider_multi_batch(slide_data, pivot_value,
                       groups: Tuple[Tuple[int, ...], ...],
                       spec_plan: Tuple, points,
                       derived=None) -> torch.Tensor:
    """Batch x multi-derivative-spec slider evaluation -> (S, N).

    ``spec_plan`` holds one routing entry per spec: ``("value",)`` (the
    additive sum, computed at most once), ``("slide", idx,
    sub_orders)`` (the owning slide's derivative) or ``("zero",)`` (a
    cross-group mixed partial, identically 0).  ``derived``, if given,
    holds per spec the owning slide's (tensor, nodes, weights, diffs)
    with its ``sub_orders`` already applied (a serving engine's hoisted
    passes), evaluated in place of ``slide_data[idx]``.
    """
    value_sum = None
    rows = []
    for m, plan in enumerate(spec_plan):
        if plan[0] == "value":
            if value_sum is None:
                value_sum = slider_value_batch(slide_data, pivot_value,
                                               groups, points)
            rows.append(value_sum)
        elif plan[0] == "slide":
            _, idx, sub_orders = plan
            data = slide_data[idx]
            if derived is not None:
                data, sub_orders = derived[m], (0,) * len(sub_orders)
            tensor, nodes, weights, diffs = data
            rows.append(eval_ops.eval_batch(
                tensor, nodes, weights, diffs, points[:, list(groups[idx])],
                tuple(sub_orders)))
        else:
            rows.append(points.new_zeros(points.shape[0]))
    return torch.stack(rows)


def spec_plan(groups, specs) -> Tuple:
    """The :func:`slider_multi_batch` routing entry of each spec (a
    per-global-dim orders tuple) over the slides' ``groups``."""
    plan = []
    for orders in specs:
        owning = sorted({i for i, g in enumerate(groups)
                         if any(orders[d] > 0 for d in g)})
        if not owning:
            plan.append(("value",))
        elif len(owning) > 1:
            plan.append(("zero",))
        else:
            plan.append(("slide", owning[0], tuple(
                int(orders[d]) for d in groups[owning[0]])))
    return tuple(plan)


# ----------------------------------------------------------------------
# Near-f64 ("dd") slider serving: one f64 contraction of the slides'
# rows put side by side.
# ----------------------------------------------------------------------


def slider_dd_plan(active_shapes, cutoff: int = None) -> dict:
    """The reference plan's shape arithmetic: ``{"ok": False}`` for the
    sliders its digit tier refuses (no slide, a slide of more than 3
    dims, or a concatenated width ``K`` that leaves its tensor digits
    under 4 bits), else ``k_total`` and the digit widths."""
    _check_cutoff(cutoff)
    if cutoff is None:
        cutoff = _PAIR_CUTOFF
    shapes = [tuple(int(x) for x in s) for s in active_shapes]
    if not shapes or any(len(s) > 3 for s in shapes):
        return {"ok": False}
    k_total = int(sum(math.prod(s) for s in shapes))
    bits_budget = 24 - int(math.ceil(math.log2(k_total)))
    b_t = min(6, bits_budget - 6)
    b_r = min(7, bits_budget - b_t)
    if b_t < 4:
        return {"ok": False}
    return {"ok": True, "k_total": k_total, "b_r": b_r, "b_t": b_t,
            "cutoff": cutoff}


def _validated_groups(groups):
    return tuple(tuple(int(d) for d in g) for g in groups)


def _refuse_outside_plan(shapes, cutoff, fallback: str) -> None:
    if not slider_dd_plan(shapes, cutoff)["ok"]:
        raise ValueError(
            f"slider slide shapes {shapes} outside the digit-GEMM budget; "
            f"use {fallback}")


def _f64(arrays):
    return tuple(a.to(torch.float64) for a in arrays)


def _concat_rows(grids, groups, points) -> torch.Tensor:
    """(N, K) rows: each slide's per-dim f64 barycentric rows,
    Khatri-Rao'd within its group (C-order, as the slide tensor
    ravels), slides side by side."""
    blocks = []
    for (nodes, weights), group in zip(grids, groups):
        rows = [barycentric_coefficients(points[:, g], nodes[j], weights[j])
                for j, g in enumerate(group)]
        blocks.append(_khatri_rao(rows))
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)


def _column(slide_data, active, plan) -> torch.Tensor:
    """(K,) f64 column of one spec over the ``active`` slides: the raw
    ravelled tensors for the value sum, else zeros outside the owning
    slide and its D^k-folded tensor inside."""
    blocks = []
    for i in active:
        tensor, _, _, diffs = slide_data[i]
        t64 = tensor.to(torch.float64)
        if plan[0] == "slide":
            if i != plan[1]:
                t64 = t64.new_zeros(t64.shape)
            elif any(o > 0 for o in plan[2]):
                t64 = apply_derivative_passes(t64, _f64(diffs), plan[2])
        blocks.append(t64.reshape(-1))
    return torch.cat(blocks)


def _contraction(slide_data, groups, active, plan, pivot_value):
    """``points -> (N, M)``: rows of the ``active`` slides against the
    (K, M) columns of the ``plan``'s specs (none a cross-group zero),
    minus each value spec's (S - 1) pivots, in slices."""
    columns = torch.stack([_column(slide_data, active, p) for p in plan],
                          dim=1)
    pivots = columns.new_tensor([
        (len(groups) - 1) * float(pivot_value) if p[0] == "value" else 0.0
        for p in plan])
    grids = [(_f64(slide_data[i][1]), _f64(slide_data[i][2]))
             for i in active]
    act_groups = [groups[i] for i in active]
    n_dims = sum(len(g) for g in groups)

    def run(points) -> torch.Tensor:
        pts = torch.as_tensor(points, dtype=torch.float64,
                              device=columns.device)
        if pts.dim() != 2 or pts.shape[1] != n_dims:
            raise ValueError(f"points must have shape (N, {n_dims}), got "
                             f"{tuple(pts.shape)}")
        step = _chunk_size(2 * columns.shape[0] + columns.shape[1],
                           pts.device, 8)
        outs = [_concat_rows(grids, act_groups, pts[i:i + step]) @ columns
                - pivots for i in range(0, pts.shape[0], step)]
        if not outs:
            return pts.new_zeros((0, columns.shape[1]))
        return torch.cat(outs)
    return run


def slider_batch_dd(slide_data, pivot_value, groups, points,
                    orders=None, cutoff: int = None) -> torch.Tensor:
    """Near-f64 batched slider evaluation -> (N,) f64, one contraction.

    ``orders`` (per global dim) routes like the f64 path: all zero = the
    additive value sum; orders confined to one group = that slide's
    derivative (its rows alone, no pivot term); cross-group orders =
    exact zeros.  Raises ValueError when the reference's plan refuses
    the slides the spec reads.
    """
    groups = _validated_groups(groups)
    n_dims = sum(len(g) for g in groups)
    orders = (0,) * n_dims if orders is None else tuple(int(o)
                                                         for o in orders)
    (plan,) = spec_plan(groups, (orders,))
    if plan[0] == "zero":
        return torch.zeros(len(points), dtype=torch.float64,
                           device=slide_data[0][0].device)
    active = (plan[1],) if plan[0] == "slide" else tuple(range(len(groups)))
    _refuse_outside_plan([tuple(slide_data[i][0].shape) for i in active],
                         cutoff, "slider_value_batch")
    return _contraction(slide_data, groups, active, (plan,),
                        pivot_value)(points)[:, 0]


def slider_multi_batch_dd(slide_data, pivot_value, groups, specs,
                          points, cutoff: int = None) -> torch.Tensor:
    """Batch x multi-spec near-f64 slider evaluation -> (N, S)."""
    return slider_dd_multi_runner(slide_data, pivot_value, groups, specs,
                                  cutoff)(points)


def slider_dd_multi_runner(slide_data, pivot_value, groups, specs,
                           cutoff: int = None, mesh=None,
                           data_axis: str = "dp"):
    """Prepare-once form of :func:`slider_multi_batch_dd`: returns a
    ``points -> (N, len(specs))`` callable that holds the (K, M) column
    matrix of the specs that touch the device.  Every spec contracts
    against the same full-width rows; a cross-group spec is an
    exact-zero column that never reaches the device.  With ``mesh``,
    the matrix is prepared once on this rank's device and the points
    shard over ``data_axis`` (``parallel.sharding``); every rank gets
    the full result."""
    return _dp_runner(
        _slider_dd_multi(_tree_on_mesh(slide_data, mesh), pivot_value,
                         groups, specs, cutoff), mesh, data_axis, 0)


def _slider_dd_multi(slide_data, pivot_value, groups, specs, cutoff):
    groups = _validated_groups(groups)
    n_dims = sum(len(g) for g in groups)
    specs = tuple(tuple(int(o) for o in s) for s in specs)
    for s in specs:
        if len(s) != n_dims:
            raise ValueError(f"spec {s} length != num dims {n_dims}")
    device = slide_data[0][0].device
    if specs:
        _refuse_outside_plan([tuple(sd[0].shape) for sd in slide_data],
                             cutoff, "slider_multi_batch")
    plan = spec_plan(groups, specs)
    live = [m for m, p in enumerate(plan) if p[0] != "zero"]
    if not live:
        return lambda points: torch.zeros((len(points), len(specs)),
                                          dtype=torch.float64, device=device)
    run = _contraction(slide_data, groups, tuple(range(len(groups))),
                       tuple(plan[m] for m in live), pivot_value)
    if len(live) == len(specs):
        return run
    live_idx = torch.tensor(live, device=device)

    def runner(points) -> torch.Tensor:
        cols = run(points)
        out = cols.new_zeros((cols.shape[0], len(specs)))
        out[:, live_idx] = cols
        return out
    return runner

"""Near-f64 ("dd") batched TT evaluation, served in native f64.

The port of ``pychebyshev_tpu.ops.tt_eval_dd``.  The JAX package serves
its near-f64 TT tier through bf16 digit-plane GEMMs with exact f32
accumulation and a double-f32 rank chain, because TPU v5e has no f64
hardware.  CUDA cards and CPUs have IEEE f64, so this module serves the
same API under the same contract in the plain f64 chain of
``ops.tt_eval``: per-dim, or the grouped supercore chain.

The core shapes the tier accepts are the reference's: ``tt_dd_plan`` and
``tt_supports_dd`` copy its shape arithmetic (the digit-width budget
included), so the port accepts and refuses the same chains with the
same errors.

``cutoff`` (and the class-level ``mode="fast"``, which sets it to
``FAST_PAIR_CUTOFF``) places the reference's digit-pair accuracy
frontier.  It is validated and accepted here, but f64 arithmetic is
already inside every cutoff's error, so it does not change the result.

``groups="auto"`` is resolved by ``tt_dd_auto_groups``: the contiguous
grouping that moves the fewest intermediate elements per point (see
there).  Results agree to rounding whichever grouping runs.

Not ported, by design: the digit-plane machinery (``_dd_add``,
``_dd_recurrence``, ``_stage_dd``, ``_chain_model``, ``_compiled*``,
``_pair_fields``, ``_width_digit_bits``, ``_score_partition``,
``_enumerate_auto_groups``, the core digit planes and their caches).  It
is TPU arithmetic for hardware without f64, and native f64 replaces it.
``tt_dd_book_runner(mesh=)`` serves the points data-parallel.
"""

from __future__ import annotations

import functools
import math
import numbers
from typing import Sequence, Tuple

import numpy as np
import torch

from pychebyshev_tpu_torch.ops import tt_eval
from pychebyshev_tpu_torch.ops.tt_eval import (
    core_shapes,
    group_slices,
    validated_groups,
)
from pychebyshev_tpu_torch.parallel.sharding import (
    _dp_runner,
    _tree_on_mesh,
)

__all__ = ["tt_eval_batch_dd", "tt_eval_batch_dd_models",
           "tt_dd_book_runner", "tt_supports_dd", "tt_dd_plan",
           "tt_dd_auto_groups", "grid_dims", "FAST_PAIR_CUTOFF"]

# The reference's default and ``mode="fast"`` cutoffs (accepted; see the
# module note).
_PAIR_CUTOFF = 44
FAST_PAIR_CUTOFF = 36

# "auto" enumerates the 2^(d-1) contiguous groupings up to this many
# cores; longer chains run per-dim.
_AUTO_MAX_CORES = 12


def _shapes(core_shapes_in) -> Tuple[Tuple[int, ...], ...]:
    return tuple(tuple(int(x) for x in s) for s in core_shapes_in)


def tt_dd_plan(core_shapes: Sequence[Tuple[int, int, int]],
               cutoff: int = None) -> dict:
    """The reference plan's shape arithmetic: ``{"ok": False}`` for a
    chain the dd tier refuses, else its digit width ``b``, plane count
    ``p`` and cutoff.

    The reference refuses chains that are not 3-D cores with unit outer
    bonds and matching inner bonds, and per-dim grids so large that its
    digits would drop under 4 bits (``n_d * 2^(2b) < 2^24`` with three
    slack bits).
    """
    if cutoff is None:
        cutoff = _PAIR_CUTOFF
    shapes = [tuple(int(x) for x in s) for s in core_shapes]
    if not shapes or any(len(s) != 3 for s in shapes):
        return {"ok": False}
    if shapes[0][0] != 1 or shapes[-1][2] != 1:
        return {"ok": False}
    if any(a[2] != b[0] for a, b in zip(shapes, shapes[1:])):
        return {"ok": False}
    n_max = max(s[1] for s in shapes)
    bits_budget = 24 - int(math.ceil(math.log2(n_max))) - 3
    b = min(8, bits_budget // 2)
    if b < 4:
        return {"ok": False}
    return {"ok": True, "b": b, "p": int(cutoff // b) + 1,
            "cutoff": int(cutoff), "shapes": tuple(shapes)}


def tt_supports_dd(core_shapes: Sequence[Tuple[int, int, int]]) -> bool:
    """Whether the dd tier serves this core chain (the reference's
    rule)."""
    return bool(tt_dd_plan(core_shapes)["ok"])


def grid_dims(shapes) -> Tuple[int, ...]:
    """Per-dim node counts of a core-shape chain."""
    return tuple(s[1] for s in shapes)


def _merged_shapes(shapes, groups):
    """Supercore shapes of a grouped chain (no data movement)."""
    out = []
    for a, z in group_slices(groups):
        width = math.prod(s[1] for s in shapes[a:z])
        out.append((shapes[a][0], width, shapes[z - 1][2]))
    return tuple(out)


def _elements_moved(shapes, groups) -> int:
    """Intermediate elements per point of one grouping of the plain
    chain: each stage writes and reads its (w, r_r) GEMM output, and a
    merged group also writes and reads its (w,) Khatri-Rao row."""
    total = 0
    for (_, w, r_r), g in zip(_merged_shapes(shapes, groups), groups):
        total += 2 * w * r_r + (2 * w if g > 1 else 0)
    return total


@functools.lru_cache(maxsize=None)
def _auto_groups(shapes) -> Tuple[int, ...]:
    d = len(shapes)
    per_dim = (1,) * d
    if d <= 1 or d > _AUTO_MAX_CORES:
        return per_dim
    best, best_cost = per_dim, _elements_moved(shapes, per_dim)
    for mask in range(1, 1 << (d - 1)):
        groups, run = [], 1
        for k in range(d - 1):
            if mask & (1 << k):
                run += 1
            else:
                groups.append(run)
                run = 1
        groups.append(run)
        groups = tuple(groups)
        if not tt_dd_plan(_merged_shapes(shapes, groups))["ok"]:
            continue
        cost = _elements_moved(shapes, groups)
        if cost < best_cost:
            best, best_cost = groups, cost
    return best


def tt_dd_auto_groups(shapes: Sequence[Tuple[int, int, int]],
                      cutoff: int = None) -> Tuple[int, ...]:
    """The grouping ``groups="auto"`` runs for these core shapes.

    The plain f64 chain is bound by the intermediates it writes and
    reads, not by its arithmetic, so the rule is: of all contiguous
    groupings (the per-dim chain included, and first on ties) whose
    merged shapes the dd plan accepts, the one that moves the fewest
    intermediate elements per point (``_elements_moved``).  Merging two
    cores pays only where the bond between them is wider than what the
    merged group's (w, r_r) output adds, which compression-grade chains
    rarely offer: for those the answer is the per-dim chain.  The
    reference's planner is calibrated for the TPU's matrix unit and is
    not ported; ``cutoff`` is accepted for its signature.
    """
    _check_cutoff(cutoff)
    return _auto_groups(_shapes(shapes))


def _check_cutoff(cutoff) -> None:
    if cutoff is None:
        return
    if (isinstance(cutoff, bool) or not isinstance(cutoff, numbers.Real)
            or not 0 <= cutoff < math.inf):
        raise ValueError(f"cutoff must be a non-negative number or None, "
                         f"got {cutoff!r}")


def _resolved_groups(shapes, groups, cutoff):
    """``groups`` ("auto", None or sizes) as validated sizes or None,
    refusing merged shapes outside the reference's budget."""
    if isinstance(groups, str) and groups == "auto":
        groups = tt_dd_auto_groups(shapes, cutoff)
    groups = validated_groups(groups, len(shapes))
    if groups is not None:
        merged = _merged_shapes(shapes, groups)
        if not tt_dd_plan(merged, cutoff)["ok"]:
            raise ValueError(
                f"grouped shapes {merged} outside the digit-GEMM "
                f"budget; loosen groups={groups}")
    return groups


def _cores64(cores):
    """The cores as f64 tensors.  Tensors that already are f64 pass
    through as the same objects, which keeps the merged-core cache of
    ``ops.tt_eval`` keyed on the caller's cores."""
    return tuple(
        c.to(torch.float64) if isinstance(c, torch.Tensor)
        else torch.tensor(np.asarray(c, dtype=np.float64)) for c in cores)


def _points64(points, device) -> torch.Tensor:
    # dtype= keeps a list of Python floats in f64.
    return torch.as_tensor(points, dtype=torch.float64, device=device)


def tt_eval_batch_dd(coeff_cores, domain, points,
                     cutoff: int = None, groups=None) -> torch.Tensor:
    """f64-class batched TT evaluation -> (N,) f64 on the cores' device.

    Same signature family as ``ops.tt_eval.tt_eval_batch``.  ``cutoff``
    is validated and accepted (see the module note).  ``groups`` selects
    the grouped supercore chain: ``"auto"`` (``tt_dd_auto_groups``, the
    default at the class and serving layers), an explicit tuple of
    contiguous group sizes, or ``None`` for the per-dim chain.
    """
    _check_cutoff(cutoff)
    shapes = core_shapes(coeff_cores)
    if not tt_dd_plan(shapes, cutoff)["ok"]:
        raise ValueError(
            f"TT core shapes {shapes} outside the digit-GEMM budget; "
            f"use ops.tt_eval.tt_eval_batch")
    groups = _resolved_groups(shapes, groups, cutoff)
    cores = _cores64(coeff_cores)
    return tt_eval.tt_eval_batch(cores, domain,
                                 _points64(points, cores[0].device),
                                 groups=groups)


def tt_eval_batch_dd_models(models_cores, domain, points,
                            cutoff: int = None,
                            groups="auto") -> torch.Tensor:
    """Book-of-TT-models near-f64 evaluation -> (M, N).

    M same-grid TT models (ranks may differ) through one batched f64
    chain that shares the Chebyshev rows.  With ``differentiate()``
    models this serves a whole TT Greek report at f64 accuracy.
    ``groups`` (``"auto"`` default) is one grouping for the whole book:
    group widths depend only on the common grid.
    """
    models_cores = tuple(tuple(cs) for cs in models_cores)
    if not models_cores:
        raise ValueError("models_cores must be a non-empty sequence")
    models_shapes = tuple(core_shapes(cs) for cs in models_cores)
    grid0 = grid_dims(models_shapes[0])
    for i, sh in enumerate(models_shapes):
        if not tt_dd_plan(sh, cutoff)["ok"]:
            raise ValueError(
                f"model {i} core shapes {sh} outside the digit-GEMM "
                f"budget; use the stacked f32 TT book")
        if grid_dims(sh) != grid0:
            raise ValueError(
                f"model {i} per-dim node counts "
                f"{grid_dims(sh)} differ from model 0's "
                f"{grid0}; a book shares one grid")
    return tt_dd_book_runner(models_cores, domain, cutoff,
                             groups=groups)(points)


def tt_dd_book_runner(models_cores, domain, cutoff: int = None,
                      mesh=None, data_axis: str = "dp", groups="auto"):
    """Prepare-once form of :func:`tt_eval_batch_dd_models`: returns a
    ``points -> (M, N)`` callable that holds the book's f64 cores
    (merged now, for a grouped chain; rank-padded and stacked, so the
    book runs as one batched chain) for its lifetime.  ``groups``:
    ``"auto"`` picks on the model with the largest total rank load,
    ``None`` is the per-dim chain.  With ``mesh``, the cores are
    prepared once on this rank's device and the points shard over
    ``data_axis`` (``parallel.sharding``); every rank gets the full
    result."""
    _check_cutoff(cutoff)
    models_cores = _tree_on_mesh(tuple(_cores64(cs) for cs in models_cores),
                                 mesh)
    models_shapes = tuple(core_shapes(cs) for cs in models_cores)
    if isinstance(groups, str) and groups == "auto":
        widest = max(models_shapes,
                     key=lambda sh: sum(r * n * s for r, n, s in sh))
        groups = tt_dd_auto_groups(widest, cutoff)
    groups = validated_groups(groups, len(models_shapes[0]))
    if groups is not None:
        for sh in models_shapes:
            if not tt_dd_plan(_merged_shapes(sh, groups), cutoff)["ok"]:
                raise ValueError(
                    f"grouped shapes outside the digit-GEMM budget; "
                    f"loosen groups={groups}")
    device = models_cores[0][0].device
    dom = np.asarray(domain, dtype=np.float64)
    dims_n = grid_dims(models_shapes[0])
    if groups is not None:
        # Merged here and held by the runner, not by the bounded cache
        # of ops.tt_eval.
        models_cores = tuple(
            tt_eval.merged_cores(cs, groups, torch.float64, device)
            for cs in models_cores)
    stacked = tt_eval.stack_rank_padded(models_cores, torch.float64, device)

    def runner(points):
        return tt_eval.tt_eval_batch_models(
            stacked, dom, _points64(points, device), groups=groups,
            dims_n=dims_n)
    return _dp_runner(runner, mesh, data_axis, -1)

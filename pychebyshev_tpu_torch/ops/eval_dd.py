"""Near-f64 ("dd") batched dense evaluation, served in native f64.

The port of ``pychebyshev_tpu.ops.eval_dd``.  The JAX package serves its
near-f64 tier through bf16 digit-plane GEMMs with exact f32
accumulation, because TPU v5e has no f64 hardware.  CUDA cards and CPUs
have IEEE f64, so this module serves the same API under the same
contract (at most 1e-10 scale-normalized from true f64) in native f64:

- On a CUDA tensor, grids that ``ops.fused_dd.supports_fused_dd``
  accepts go through the hand-written f64 kernel (the port of the Pallas
  K3); other grids through the plain f64 path of ``ops.eval``.  This is
  a static rule on the shape, not a fallback on failure.
- On a CPU tensor the same routing runs the kernel's plain version.
- The K3 route refuses, on every device, a tensor that requires grad
  (``fused_eval.refuse_grad``), as the reference's Pallas K3 does; the
  plain f64 route stays differentiable.

The grids the tier accepts are the reference's: ``dd_plan`` and
``supports_dd`` copy its shape arithmetic (the digit-width budget
included), so the port accepts and refuses the same grids with the same
errors.

``cutoff`` (and the class-level ``mode="fast"``, which sets it to
``FAST_PAIR_CUTOFF``) places the reference's digit-pair accuracy
frontier.  It is validated and accepted here, but f64 arithmetic is
already inside every cutoff's error, so it does not change the result.

Not ported, by design: the digit-plane machinery (``pair_schedule``,
``_two_prod``, ``_khatri_rao_dd``, the digit-plane functions,
``dd_gemm_ladder``, ``_compiled`` and the plane caches).  It is TPU
arithmetic for hardware without f64, and native f64 replaces it.
The runners' ``mesh=`` serves the points data-parallel
(``parallel.sharding``), each rank through the same route.
"""

from __future__ import annotations

import math
import numbers
from typing import Sequence, Tuple

import torch

from pychebyshev_tpu_torch.ops import eval as eval_ops
from pychebyshev_tpu_torch.ops import fused_dd, fused_eval
from pychebyshev_tpu_torch.ops.eval import _split_index
from pychebyshev_tpu_torch.parallel.sharding import (
    _dp_runner,
    _tree_on_mesh,
)

__all__ = ["eval_batch_dd", "eval_batch_dd_multi", "eval_batch_dd_models",
           "dd_multi_runner", "dd_models_runner", "supports_dd", "dd_plan",
           "FAST_PAIR_CUTOFF"]

#: The reference's ``mode="fast"`` cutoff (accepted; see the module note).
FAST_PAIR_CUTOFF = 36


def dd_plan(shape: Sequence[int]) -> dict:
    """The reference plan's shape arithmetic: ``{"ok": False}`` for a
    grid the dd tier refuses, else its split ``s`` and group sizes.

    The reference refuses 1-D grids (no left/right split), right groups
    of more than 3 dims (its Lebesgue scale bound), and right groups so
    large that its tensor digits would drop under 4 bits.
    """
    shape = tuple(int(n) for n in shape)
    if len(shape) < 2:
        return {"ok": False}
    s = _split_index(shape)
    if len(shape) - s > 3:
        return {"ok": False}
    n_left = math.prod(shape[:s])
    n_right = math.prod(shape[s:])
    bits_budget = 24 - int(math.ceil(math.log2(n_right)))
    if min(6, bits_budget - 6) < 4:
        return {"ok": False}
    return {"ok": True, "s": s, "n_left": n_left, "n_right": n_right}


def supports_dd(shape: Sequence[int], max_right: int = 1 << 14) -> bool:
    """Whether the dd tier serves this grid (the reference's rule)."""
    plan = dd_plan(shape)
    return bool(plan["ok"]) and plan["n_right"] <= max_right


def _check_cutoff(cutoff) -> None:
    if cutoff is None:
        return
    if (isinstance(cutoff, bool) or not isinstance(cutoff, numbers.Real)
            or not 0 <= cutoff < math.inf):
        raise ValueError(f"cutoff must be a non-negative number or None, "
                         f"got {cutoff!r}")


def _orders(orders, d) -> Tuple[int, ...]:
    orders = (0,) * d if orders is None else tuple(int(o) for o in orders)
    if len(orders) != d:
        raise ValueError(f"orders {orders} length != tensor ndim {d}")
    return orders


def _points64(points, device, d) -> torch.Tensor:
    """(N, d) contiguous f64 points on ``device`` (``dtype=`` keeps a list
    of Python floats in f64)."""
    pts = torch.as_tensor(points, dtype=torch.float64, device=device)
    if pts.dim() != 2 or pts.shape[1] != d:
        raise ValueError(f"points must have shape (N, {d}), got "
                         f"{tuple(pts.shape)}")
    return pts.contiguous()


def _f64(arrays):
    return tuple(a.to(torch.float64) for a in arrays)


def _runner(tensors, nodes, weights, diff_matrices, orders_list):
    """``points -> (M, N)`` over M (tensor, orders) pairs on one grid,
    with every pair's operands prepared now and held by the closure."""
    shape = tuple(int(n) for n in tensors[0].shape)
    d = len(shape)
    device = tensors[0].device
    if fused_dd.supports_fused_dd(shape):
        fused_eval.refuse_grad("eval_dd's K3 route", tensors, nodes,
                               weights, diff_matrices)
        packed = [fused_dd._pack(t, nodes, weights, diff_matrices, o, shape)
                  for t, o in zip(tensors, orders_list)]

        def run(points):
            fused_eval.refuse_grad("eval_dd's K3 route", points)
            pts = _points64(points, device, d)
            return torch.stack([fused_dd._evaluate(p, shape, pts)
                                for p in packed])
        return run

    diffs64 = _f64(diff_matrices)
    spec_tensors = [eval_ops.apply_derivative_passes(
        t.to(torch.float64), diffs64, o)
        for t, o in zip(tensors, orders_list)]
    nodes64, weights64 = _f64(nodes), _f64(weights)

    def run(points):
        pts = _points64(points, device, d)
        return eval_ops.eval_batch_models(spec_tensors, nodes64, weights64,
                                          (), pts, (0,) * d)
    return run


def eval_batch_dd(tensor, nodes, weights, diff_matrices, points,
                  orders: Tuple[int, ...] = None,
                  cutoff: int = None) -> torch.Tensor:
    """Near-f64 batched evaluation -> (N,) f64 on the tensor's device.

    Same signature family as ``ops.eval.eval_batch``; routed as the
    module note says (the f64 kernel, or plain f64).  Its operands are
    cached by ``ops.fused_dd``.
    """
    shape = tuple(int(n) for n in tensor.shape)
    d = len(shape)
    orders = _orders(orders, d)
    _check_cutoff(cutoff)
    if not supports_dd(shape):
        raise ValueError(
            f"grid shape {shape} outside digit-GEMM budget; "
            f"use ops.eval.eval_batch"
        )
    pts = _points64(points, tensor.device, d)
    if fused_dd.supports_fused_dd(shape):
        return fused_dd.fused_eval_batch_dd(tensor, nodes, weights,
                                            diff_matrices, pts, orders)
    return eval_ops.eval_batch(tensor.to(torch.float64), _f64(nodes),
                               _f64(weights), _f64(diff_matrices), pts,
                               orders)


def eval_batch_dd_models(tensors, nodes, weights, diff_matrices, points,
                         orders: Tuple[int, ...] = None,
                         cutoff: int = None) -> torch.Tensor:
    """Book-of-models near-f64 evaluation -> (M, N): M same-grid value
    tensors at one derivative spec."""
    tensors = tuple(tensors)
    if not tensors:
        raise ValueError("tensors must be a non-empty sequence")
    shape = tuple(int(n) for n in tensors[0].shape)
    if any(tuple(int(n) for n in t.shape) != shape for t in tensors):
        raise ValueError("all tensors must share one grid shape")
    if not supports_dd(shape):
        raise ValueError(
            f"grid shape {shape} outside digit-GEMM budget; "
            f"use ops.eval.eval_batch_models"
        )
    return dd_models_runner(tensors, nodes, weights, diff_matrices,
                            orders, cutoff)(points)


def dd_models_runner(tensors, nodes, weights, diff_matrices, orders,
                     cutoff: int = None, mesh=None,
                     data_axis: str = "dp"):
    """Prepare-once form of :func:`eval_batch_dd_models`: returns a
    ``points -> (M, N)`` callable that holds every model's packed
    operands for its lifetime (on CUDA, one kernel launch per model per
    call).  With ``mesh``, the operands are prepared once on this rank's
    device and the points shard over ``data_axis``
    (``parallel.sharding``); every rank gets the full result."""
    tensors = tuple(tensors)
    _check_cutoff(cutoff)
    orders = _orders(orders, tensors[0].dim())
    tensors, nodes, weights, diff_matrices = _tree_on_mesh(
        (tensors, nodes, weights, diff_matrices), mesh)
    return _dp_runner(_runner(tensors, nodes, weights, diff_matrices,
                              [orders] * len(tensors)), mesh, data_axis, -1)


def eval_batch_dd_multi(tensor, nodes, weights, diff_matrices, points,
                        specs, cutoff: int = None) -> torch.Tensor:
    """Batch x multi-spec near-f64 evaluation -> (N, len(specs)): e.g.
    price and Greeks, each spec against its own pre-differentiated
    tensor."""
    shape = tuple(int(n) for n in tensor.shape)
    d = len(shape)
    specs = tuple(tuple(int(o) for o in s) for s in specs)
    for s in specs:
        if len(s) != d:
            raise ValueError(
                f"spec {s} length != tensor ndim {d}")
    if not supports_dd(shape):
        raise ValueError(
            f"grid shape {shape} outside digit-GEMM budget; "
            f"use ops.eval.eval_batch_multi"
        )
    pts = _points64(points, tensor.device, d)
    if not specs:
        return pts.new_zeros((pts.shape[0], 0))
    return dd_multi_runner(tensor, nodes, weights, diff_matrices, specs,
                           cutoff)(pts)


def dd_multi_runner(tensor, nodes, weights, diff_matrices, specs,
                    cutoff: int = None, mesh=None,
                    data_axis: str = "dp"):
    """Prepare-once form of :func:`eval_batch_dd_multi`.

    Returns a ``points -> (N, len(specs))`` callable that holds every
    spec's packed operands, so a serving engine owns its working set
    instead of leaning on the bounded operand cache.  On CUDA a call is
    one kernel launch per spec.  ``mesh``/``data_axis`` as in
    :func:`dd_models_runner`.
    """
    shape = tuple(int(n) for n in tensor.shape)
    specs = tuple(tuple(int(o) for o in s) for s in specs)
    _check_cutoff(cutoff)
    if not supports_dd(shape):
        raise ValueError(
            f"grid shape {shape} outside digit-GEMM budget; "
            f"use ops.eval.eval_batch_multi"
        )
    for s in specs:
        _orders(s, len(shape))
    tensor, nodes, weights, diff_matrices = _tree_on_mesh(
        (tensor, nodes, weights, diff_matrices), mesh)
    if not specs:
        return lambda points: _points64(
            points, tensor.device, len(shape)).new_zeros((len(points), 0))
    run = _runner((tensor,) * len(specs), nodes, weights, diff_matrices,
                  specs)
    return _dp_runner(lambda points: run(points).T, mesh, data_axis, 0)

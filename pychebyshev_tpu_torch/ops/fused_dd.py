"""Fused f64 batched dense evaluation: the CUDA port of the Pallas K3.

Counterpart of ``pychebyshev_tpu/ops/pallas_dd.py``.  The TPU kernel
reaches near-f64 accuracy through bf16 digit planes with exact f32
accumulation, because TPU v5e has no f64.  Hopper's tensor cores
multiply and accumulate in f64 (DMMA), so this module runs the f64
instance of the fused evaluator (``csrc/fused_eval.cu``, entry
``fused_eval_f64``): the same function, within the dd contract's 1e-10
of true f64 (in fact to f64 rounding), with the whole per-point
pipeline on chip.

- ``fused_eval_batch_dd`` launches the kernel for CUDA tensors (or
  raises), and runs the plain PyTorch version of the same function for
  CPU tensors.  Nothing falls back from one to the other.
- ``fused_eval_batch_dd_reference`` is that plain version, on any device.
- Derivative orders are applied to the tensor once, in f64, before
  packing; points stay f64 end to end.
- ``launches`` counts kernel launches (a plain integer; reset it by
  assignment).

The packing, operand cache and plain contraction are ``ops.fused_eval``'s,
at f64.  The TPU knobs ``block`` and ``interpret`` have no counterpart.

Scope (``supports_fused_dd``): tensors with 3 to 16 dims that the dd
tier accepts (``ops.eval_dd.supports_dd``), whose f64 tile (128 points
per block) fits Hopper's 227 KB of shared memory per block, and whose
padded pack has under 2^31 elements.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from pychebyshev_tpu_torch.ops import eval_dd, fused_eval

__all__ = ["fused_eval_batch_dd", "fused_eval_batch_dd_reference",
           "supports_fused_dd", "clear_fused_cache", "launches"]

#: Kernel launches since import (or since the caller last reset it).
launches = 0

# Packed f64 operands, an LRU list under ``ops.fused_eval``'s rules
# (keyed on identity and ``_version``, ``_CACHE_SLOTS`` entries).
_operand_cache: list = []


def supports_fused_dd(shape: Sequence[int]) -> bool:
    """Whether the f64 kernel covers this grid."""
    shape = tuple(int(n) for n in shape)
    return (len(shape) >= 3 and eval_dd.supports_dd(shape)
            and fused_eval._fits(shape, torch.float64))


def clear_fused_cache() -> None:
    """Drop all cached packed f64 operands."""
    with fused_eval._cache_lock:
        _operand_cache.clear()


def _pack(tensor, nodes, weights, diff_matrices, orders, shape):
    """Packed f64 operands of one (tensor, orders), uncached: for callers
    that hold their working set themselves (``ops.eval_dd``'s runners)."""
    return fused_eval._pack(tensor, nodes, weights, diff_matrices, orders,
                            shape, torch.float64)


def _evaluate(packed, shape, points) -> torch.Tensor:
    """The kernel on a CUDA tensor (counted), its plain version on a CPU
    one.  ``points`` are contiguous f64 on the operands' device."""
    global launches
    fused_eval._check_device(packed[0], "fused_eval_batch_dd")
    if packed[0].device.type == "cuda":
        out = fused_eval._launch(*packed, shape, points)
        launches += points.shape[0] > 0   # an empty batch launches nothing
        return out
    return fused_eval._contract_packed(*packed, shape, points)


def _prepare(tensor, nodes, weights, diff_matrices, points, orders):
    shape = tuple(int(n) for n in tensor.shape)
    if not supports_fused_dd(shape):
        raise ValueError(
            f"grid shape {shape} outside the fused dd envelope (3 to "
            f"{fused_eval._MAX_DIMS} dims inside the dd plan, "
            f"{fused_eval._MAX_SMEM_BYTES} bytes of shared memory per "
            f"block at f64, a pack under 2^31 elements); use "
            f"ops.eval_dd.eval_batch_dd")
    return fused_eval._prepare(tensor, nodes, weights, diff_matrices,
                               points, orders, torch.float64)


def fused_eval_batch_dd(tensor, nodes, weights, diff_matrices, points,
                        orders: Tuple[int, ...] = None) -> torch.Tensor:
    """Fused f64 batched evaluation -> (N,) f64 on the tensor's device.

    Same contract as ``ops.eval_dd.eval_batch_dd``.  A CUDA tensor
    launches the kernel; a CPU tensor runs the plain version of the same
    function; any other device raises.  Packed operands are cached.
    """
    shape, orders, points = _prepare(tensor, nodes, weights, diff_matrices,
                                     points, orders)
    fused_eval._check_device(tensor, "fused_eval_batch_dd")
    packed = fused_eval._packed_operands(
        _operand_cache, tensor, nodes, weights, diff_matrices, orders, shape,
        torch.float64)
    return _evaluate(packed, shape, points)


def fused_eval_batch_dd_reference(tensor, nodes, weights, diff_matrices,
                                  points, orders: Tuple[int, ...] = None
                                  ) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_eval_batch_dd`, on any
    device, with no operand cache and no kernel."""
    shape, orders, points = _prepare(tensor, nodes, weights, diff_matrices,
                                     points, orders)
    packed = _pack(tensor, nodes, weights, diff_matrices, orders, shape)
    return fused_eval._contract_packed(*packed, shape, points)

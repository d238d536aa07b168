"""Fused f32 batched dense evaluation: the CUDA port of the Pallas K1
and K2.

Counterpart of ``pychebyshev_tpu/ops/pallas_eval.py``.  The kernel
(``csrc/fused_eval.cu``) keeps the whole per-point pipeline — row build,
Khatri-Rao factors, tensor contraction — on chip, so device memory sees
the points in and one float out per point.  It works in IEEE f32 with
f32 accumulation (no TF32); the Mosaic-specific bf16 splits, selection
dots and VMEM plans of the TPU kernel have no counterpart here.  The
same kernel covers the grids the TPU served with its stream kernel K2
(15^5 to 19^5, 9^6): it walks the contraction depth in shared-memory
stages, so only the rows and the right-prime factor must fit.

The packing, operand cache and plain contraction here are generic over
the dtype: ``ops.fused_dd`` runs the f64 instance of the same kernel.

- ``fused_eval_batch`` launches the kernel for CUDA tensors (or raises),
  and runs the plain PyTorch version of the same arithmetic for CPU
  tensors.  Nothing falls back from one to the other.
- ``fused_eval_batch_reference`` is that plain version, on any device:
  the CPU tests use it, and the chip check compares the kernel with it.
- Derivative orders are applied to the tensor once, in f64 on its
  device, before the cast to f32.
- ``launches`` counts kernel launches (a plain integer; reset it by
  assignment).

Scope (``supports_fused``): f32 evaluation of tensors with 3 to 16 dims
whose per-block shared-memory footprint fits Hopper's 227 KB.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Sequence, Tuple

import torch

from pychebyshev_tpu_torch.ops import _build
from pychebyshev_tpu_torch.ops.eval import (
    _chunk_size,
    _khatri_rao,
    _split_index,
    apply_derivative_passes,
    barycentric_coefficients,
)

__all__ = ["fused_eval_batch", "fused_eval_batch_reference",
           "supports_fused", "clear_fused_cache", "launches"]

#: Kernel launches since import (or since the caller last reset it).
launches = 0

# Kernel geometry; keep in step with the constants in csrc/fused_eval.cu.
_POINTS_PER_BLOCK = {torch.float32: 64, torch.float64: 32}
_ENTRY = {torch.float32: "fused_eval_f32", torch.float64: "fused_eval_f64"}
_COL_TILE = 128
_DEPTH = 16
_MAX_DIMS = 16
_MAX_SMEM_BYTES = 232448   # 227 KB: a Hopper block's shared-memory cap


def _geometry(shape: Tuple[int, ...]):
    """(s, n_left, n_mid, n_rp) of the kernel's split of ``shape``."""
    s = _split_index(shape)
    return s, math.prod(shape[:s]), shape[s], math.prod(shape[s + 1:])


def _smem_bytes(shape: Tuple[int, ...], dtype=torch.float32) -> int:
    """Shared memory one block needs: rows, right-prime factor, and the
    two contraction stages, at ``dtype``'s tile (64 f32 or 32 f64 points
    per block)."""
    _, _, _, n_rp = _geometry(shape)
    ppb = _POINTS_PER_BLOCK[dtype]
    itemsize = torch.empty((), dtype=dtype).element_size()
    return itemsize * (ppb * (sum(shape) + n_rp)
                       + _DEPTH * (ppb + _COL_TILE))


def _fits(shape: Tuple[int, ...], dtype) -> bool:
    """Whether the kernel's ``dtype`` instance takes this grid."""
    return (3 <= len(shape) <= _MAX_DIMS
            and _smem_bytes(shape, dtype) <= _MAX_SMEM_BYTES)


def supports_fused(shape: Sequence[int], dtype) -> bool:
    """Whether the fused kernel covers this configuration."""
    shape = tuple(int(n) for n in shape)
    return dtype == torch.float32 and _fits(shape, dtype)


def _pack(tensor, nodes, weights, diff_matrices, orders, shape, dtype):
    """(t3, nodes_cat, weights_cat) at ``dtype`` on the tensor's device.

    ``t3`` is the derivative-applied tensor (n_mid*n_rp, n_left): row
    ``j*n_rp + r`` holds ``T[:, j, r]`` over the flattened left index,
    the layout the kernel streams.  Derivatives are applied in f64
    before the cast.
    """
    t = tensor.to(torch.float64)
    if any(orders):
        t = apply_derivative_passes(
            t, [m.to(torch.float64) for m in diff_matrices], orders)
    _, n_left, n_mid, n_rp = _geometry(shape)
    t3 = t.reshape(n_left, n_mid * n_rp).T.to(dtype).contiguous()
    nodes_cat = torch.cat([a.reshape(-1) for a in nodes]).to(
        device=tensor.device, dtype=dtype).contiguous()
    weights_cat = torch.cat([a.reshape(-1) for a in weights]).to(
        device=tensor.device, dtype=dtype).contiguous()
    return t3, nodes_cat, weights_cat


# Small strong-reference LRU of packed f32 operands (``ops.fused_dd``
# keeps its own list for f64).  Torch tensors mutate in place without
# changing identity, so an entry matches only when every keyed tensor is
# the same object AND has the same ``_version`` (the counter torch bumps
# on each in-place write).  Strong references rule out id reuse; the
# slot bound caps the pinned device memory.  The lock keeps the
# move-to-front and eviction whole when engines share a cache across
# threads.
_CACHE_SLOTS = 16
_operand_cache: list = []
_cache_lock = threading.Lock()


def clear_fused_cache() -> None:
    """Drop all cached packed operands."""
    with _cache_lock:
        _operand_cache.clear()


def _packed_operands(cache, tensor, nodes, weights, diff_matrices, orders,
                     shape, dtype):
    """``_pack``'s operands through the LRU list ``cache``."""
    keyed = (tensor, *nodes, *weights,
             *(diff_matrices if any(orders) else ()))
    versions = tuple(t._version for t in keyed)
    with _cache_lock:
        for i, (e_keyed, e_versions, e_orders, packed) in enumerate(cache):
            if (e_orders == orders and e_versions == versions
                    and len(e_keyed) == len(keyed)
                    and all(a is b for a, b in zip(e_keyed, keyed))):
                cache.insert(0, cache.pop(i))
                return packed
    packed = _pack(tensor, nodes, weights, diff_matrices, orders, shape,
                   dtype)
    with _cache_lock:
        cache.insert(0, (keyed, versions, orders, packed))
        del cache[_CACHE_SLOTS:]
    return packed


def _contract_packed(t3, nodes_cat, weights_cat, shape, points):
    """The kernel's arithmetic in plain PyTorch, on the kernel's operands
    (same rows, same Khatri-Rao order, same dtype), in bounded slices."""
    s, _, _, _ = _geometry(shape)
    offsets = [0]
    for n in shape:
        offsets.append(offsets[-1] + n)
    out = torch.empty(points.shape[0], dtype=t3.dtype,
                      device=points.device)
    chunk = _chunk_size(shape)
    for start in range(0, points.shape[0], chunk):
        pts = points[start:start + chunk]
        rows = [barycentric_coefficients(
                    pts[:, k], nodes_cat[offsets[k]:offsets[k + 1]],
                    weights_cat[offsets[k]:offsets[k + 1]])
                for k in range(len(shape))]
        w_left = _khatri_rao(rows[:s])
        a = rows[s]
        if s + 1 < len(shape):
            w_rp = _khatri_rao(rows[s + 1:])
            a = (a[:, :, None] * w_rp[:, None, :]).reshape(pts.shape[0], -1)
        out[start:start + chunk] = (w_left * (a @ t3)).sum(dim=1)
    return out


def _prepare(tensor, nodes, weights, diff_matrices, points, orders,
             dtype=torch.float32):
    """Validated (shape, orders, points) with points as contiguous
    ``dtype`` on the tensor's device."""
    shape = tuple(int(n) for n in tensor.shape)
    d = len(shape)
    orders = (0,) * d if orders is None else tuple(int(o) for o in orders)
    if len(orders) != d or len(nodes) != d or len(weights) != d:
        raise ValueError(
            f"tensor has {d} dims; got {len(nodes)} nodes, {len(weights)} "
            f"weights and orders {orders}")
    if any(orders) and len(diff_matrices) != d:
        raise ValueError(f"need {d} differentiation matrices for orders "
                         f"{orders}, got {len(diff_matrices)}")
    grid = [*nodes, *weights, *(diff_matrices if any(orders) else ())]
    if any(a.device != tensor.device for a in grid):
        raise ValueError(f"nodes, weights and differentiation matrices "
                         f"must be on the tensor's device {tensor.device}")
    if not _fits(shape, dtype):
        raise ValueError(
            f"grid shape {shape} is outside the fused kernel's envelope "
            f"(3 to {_MAX_DIMS} dims, {_MAX_SMEM_BYTES} bytes of shared "
            f"memory per block at {dtype}); use ops.eval.eval_batch")
    if not isinstance(points, torch.Tensor):
        # dtype= here: a list of Python floats would otherwise become f32.
        points = torch.as_tensor(points, dtype=dtype, device=tensor.device)
    if points.device != tensor.device:
        raise ValueError(f"points on {points.device}, tensor on "
                         f"{tensor.device}")
    if points.dim() != 2 or points.shape[1] != d:
        raise ValueError(f"points must have shape (N, {d}), got "
                         f"{tuple(points.shape)}")
    return shape, orders, points.to(dtype).contiguous()


def _check_device(tensor, name):
    if tensor.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got "
                         f"{tensor.device}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("fused_eval")
    for entry in _ENTRY.values():
        fn = getattr(lib, entry)
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.fused_eval_error_string.argtypes = [ctypes.c_int]
    lib.fused_eval_error_string.restype = ctypes.c_char_p
    return lib


def _launch(t3, nodes_cat, weights_cat, shape, points):
    """Launch the kernel's ``t3.dtype`` instance on the current stream.
    Raises on a refused launch; counting it is the caller's job."""
    entry = _ENTRY[t3.dtype]
    n = points.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"{n} points exceed the kernel's int32 count")
    out = torch.empty(n, dtype=t3.dtype, device=points.device)
    if n == 0:
        return out
    lib = _library()
    dims = (ctypes.c_int * len(shape))(*shape)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        err = getattr(lib, entry)(
            points.data_ptr(), nodes_cat.data_ptr(), weights_cat.data_ptr(),
            t3.data_ptr(), out.data_ptr(), n, len(shape),
            ctypes.cast(dims, ctypes.c_void_p), _split_index(shape), stream)
    if err != 0:
        msg = lib.fused_eval_error_string(err).decode()
        raise RuntimeError(f"{entry} launch failed: {msg} "
                           f"(cudaError {err})")
    return out


def fused_eval_batch(tensor, nodes, weights, diff_matrices, points,
                     orders: Tuple[int, ...] = None) -> torch.Tensor:
    """Fused f32 batched evaluation -> (N,) f32 on the tensor's device.

    Drop-in for ``ops.eval.eval_batch`` at f32.  A CUDA tensor launches
    the kernel; a CPU tensor runs the plain version of the same
    arithmetic; any other device raises.  Packed operands are cached
    (see ``_operand_cache``).
    """
    global launches
    shape, orders, points = _prepare(tensor, nodes, weights, diff_matrices,
                                     points, orders)
    _check_device(tensor, "fused_eval_batch")
    packed = _packed_operands(_operand_cache, tensor, nodes, weights,
                              diff_matrices, orders, shape, torch.float32)
    if tensor.device.type == "cuda":
        out = _launch(*packed, shape, points)
        launches += points.shape[0] > 0   # an empty batch launches nothing
        return out
    return _contract_packed(*packed, shape, points)


def fused_eval_batch_reference(tensor, nodes, weights, diff_matrices,
                               points, orders: Tuple[int, ...] = None
                               ) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_eval_batch`, on any device,
    with no operand cache and no kernel."""
    shape, orders, points = _prepare(tensor, nodes, weights, diff_matrices,
                                     points, orders)
    packed = _pack(tensor, nodes, weights, diff_matrices, orders, shape,
                   torch.float32)
    return _contract_packed(*packed, shape, points)

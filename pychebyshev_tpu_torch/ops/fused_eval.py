"""Fused f32 batched dense evaluation: the CUDA port of the Pallas K1
and K2.

Counterpart of ``pychebyshev_tpu/ops/pallas_eval.py``.  The kernel
(``csrc/fused_eval.cu``) keeps the whole per-point pipeline — row build,
Khatri-Rao factors, tensor contraction — on chip, so device memory sees
the points in and one float out per point.  Its contraction runs on the
TF32 tensor cores in three passes (3xTF32: each operand splits into a
TF32 big part and a TF32 small part, and small*big + big*small +
big*big accumulates in f32), which keeps f32 accuracy; one TF32 pass
would not.  The Mosaic-specific bf16 splits, selection dots and VMEM
plans of the TPU kernel have no counterpart here.  The same kernel
covers the grids the TPU served with its stream kernel K2 (15^5 to
19^5, 9^6): it walks the contraction depth in shared-memory stages, so
only the rows of a block's points must fit.

The packing, operand cache and plain contraction here are generic over
the dtype: ``ops.fused_dd`` runs the f64 instance of the same kernel.

- ``fused_eval_batch`` launches the kernel for CUDA tensors (or raises),
  and runs the plain PyTorch version of the same function for CPU
  tensors.  Nothing falls back from one to the other.
- ``fused_eval_batch_reference`` is that plain version (IEEE f32), on
  any device: the CPU tests use it, and the chip check compares the
  kernel with it.  ``_matmul_3xtf32`` emulates the kernel's 3xTF32
  product in plain PyTorch, for the tests.
- Derivative orders are applied to the tensor once, in f64 on its
  device, before the cast to f32.
- ``launches`` counts kernel launches (a plain integer; reset it by
  assignment).
- The kernel has no backward, and neither has the Pallas kernel it
  replaces (``jax.grad`` through it fails to linearize).  So the route
  refuses, on every device, an operand or point tensor that requires
  grad while grad mode is on (``refuse_grad``), before it packs or
  caches anything; the plain ``*_reference`` functions stay
  differentiable.

Scope (``supports_fused``): f32 evaluation of tensors with 3 to 16 dims
whose per-block shared-memory footprint fits Hopper's 227 KB and whose
padded pack has under 2^31 elements.
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
           "supports_fused", "clear_fused_cache", "refuse_grad",
           "launches"]

#: Kernel launches since import (or since the caller last reset it).
launches = 0

# Kernel geometry; keep in step with the constants in csrc/fused_eval.cu.
_ENTRY = {torch.float32: "fused_eval_f32", torch.float64: "fused_eval_f64"}
_BLOCK_POINTS = 128   # points per block
_COL_TILE = 128       # left-index columns per tile; t3's rows pad to it
_DEPTH = 16           # contraction steps per stage; t3's depth pads to it
_STAGES = 3           # ring of T stages
_WARPS_N = 4          # column warps, each with a row of partial sums
_PAD = {torch.float32: 8, torch.float64: 4}      # stage row pad, values
_A_PLANES = {torch.float32: 2, torch.float64: 1}  # tf32 big + small, f64
_MAX_DIMS = 16
_MAX_SMEM_BYTES = 232448   # 227 KB: a Hopper block's shared-memory cap


def _geometry(shape: Tuple[int, ...]):
    """(s, n_left, n_mid, n_rp) of the kernel's split of ``shape``."""
    s = _split_index(shape)
    return s, math.prod(shape[:s]), shape[s], math.prod(shape[s + 1:])


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _smem_bytes(shape: Tuple[int, ...], dtype=torch.float32) -> int:
    """Shared memory one block needs: the ring of T stages, two A stages
    (two planes each in f32), the column warps' partial sums, the rows of
    the block's points, and the table of 16-bit row lanes of the
    right-prime dims for each of the n_rp right-prime indices."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    s, _, _, n_rp = _geometry(shape)
    stages = (_STAGES + 2 * _A_PLANES[dtype]) * _DEPTH * (_COL_TILE
                                                          + _PAD[dtype])
    lanes = 2 * n_rp * (len(shape) - s - 1)
    return (itemsize * (stages + _WARPS_N * _BLOCK_POINTS
                        + _BLOCK_POINTS * sum(shape)) + lanes)


def _fits(shape: Tuple[int, ...], dtype) -> bool:
    """Whether the kernel's ``dtype`` instance takes this grid: its
    shared memory fits a block, and its padded pack has under 2^31
    elements (the kernel's offsets into it are 32-bit)."""
    if not 3 <= len(shape) <= _MAX_DIMS:
        return False
    _, n_left, n_mid, n_rp = _geometry(shape)
    elements = (_round_up(n_mid * n_rp, _DEPTH)
                * _round_up(n_left, _COL_TILE))
    return (_smem_bytes(shape, dtype) <= _MAX_SMEM_BYTES
            and elements < 2 ** 31)


def supports_fused(shape: Sequence[int], dtype) -> bool:
    """Whether the fused kernel covers this configuration."""
    shape = tuple(int(n) for n in shape)
    return dtype == torch.float32 and _fits(shape, dtype)


def _pack(tensor, nodes, weights, diff_matrices, orders, shape, dtype):
    """(t3, nodes_cat, weights_cat) at ``dtype`` on the tensor's device.

    ``t3`` is the derivative-applied tensor, (n_mid*n_rp, n_left) zero-
    padded to (k_pad, ld), multiples of ``_DEPTH`` and ``_COL_TILE``: row
    ``j*n_rp + r`` holds ``T[:, j, r]`` over the flattened left index,
    the layout the kernel streams in whole 16-byte-aligned tiles.
    Derivatives are applied in f64 before the cast.
    """
    t = tensor.to(torch.float64)
    if any(orders):
        t = apply_derivative_passes(
            t, [m.to(torch.float64) for m in diff_matrices], orders)
    _, n_left, n_mid, n_rp = _geometry(shape)
    k = n_mid * n_rp
    t3 = torch.zeros((_round_up(k, _DEPTH), _round_up(n_left, _COL_TILE)),
                     dtype=dtype, device=tensor.device)
    t3[:k, :n_left] = t.reshape(n_left, k).T
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


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32``
    rounds it: to nearest, ties away from zero, by bit operations on the
    magnitude (a carry into the exponent gives the next power of two)."""
    bits = x.contiguous().view(torch.int32)
    sign = bits & -0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
    return (sign | mag).view(torch.float32)


def _matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's f32 product in plain PyTorch: each operand split into
    TF32 big and small parts, small*big + big*small + big*big summed in
    f32 (each TF32 x TF32 product is exact in f32)."""
    a_big, b_big = _tf32_round(a), _tf32_round(b)
    a_small, b_small = _tf32_round(a - a_big), _tf32_round(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _contract_packed(t3, nodes_cat, weights_cat, shape, points,
                     matmul=torch.matmul):
    """The kernel's function in plain PyTorch, on the kernel's padded
    operands (same rows, same Khatri-Rao order, same dtype), in bounded
    slices.  ``matmul`` forms the contraction; the tests pass
    ``_matmul_3xtf32`` to emulate the f32 kernel's tensor-core passes."""
    s, n_left, n_mid, n_rp = _geometry(shape)
    t3 = t3[:n_mid * n_rp, :n_left]   # the padding contributes nothing
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
        out[start:start + chunk] = (w_left * matmul(a, t3)).sum(dim=1)
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
            f"memory per block at {dtype}, a pack under 2^31 elements); "
            f"use ops.eval.eval_batch")
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


def refuse_grad(route: str, *tensors) -> None:
    """Raise if autograd would need a gradient through a kernel route:
    grad mode is on and any of ``tensors`` (operands, points; sequences
    of them are walked) requires grad."""
    if not torch.is_grad_enabled():
        return
    stack = list(tensors)
    while stack:
        t = stack.pop()
        if isinstance(t, (tuple, list)):
            stack.extend(t)
        elif isinstance(t, torch.Tensor) and t.requires_grad:
            raise RuntimeError(
                f"{route} has no gradient: its kernel has no backward, and "
                f"an operand or the points require grad.  Differentiate "
                f"through the f64 path (ops.eval.eval_batch, or the "
                f"model's eval_batch_device), or call under torch.no_grad()")


def _check_device(tensor, name):
    if tensor.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got "
                         f"{tensor.device}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return _bind(_build.load_library("fused_eval"))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' signatures on a loaded library."""
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
    function; any other device raises.  Packed operands are cached
    (see ``_operand_cache``).  Refuses a tensor that requires grad
    (``refuse_grad``).
    """
    global launches
    refuse_grad("fused_eval_batch", tensor, nodes, weights, diff_matrices,
                points)
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

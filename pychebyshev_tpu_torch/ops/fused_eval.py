"""Fused f32 batched dense evaluation: the CUDA port of the Pallas K1
and K2.

Counterpart of ``pychebyshev_tpu/ops/pallas_eval.py``.  The kernel
(``csrc/fused_eval.cu``, ``fused_eval_kernel_wgmma``) keeps the whole
per-point pipeline — row build, Khatri-Rao factors, tensor contraction —
on chip, so device memory sees the points in and one float out per
point.  Its contraction runs on the TF32 tensor cores through Hopper's
warpgroup MMA (``wgmma``) in three passes (3xTF32: each operand splits
into a TF32 big part and a small remainder, and small*big + big*small +
big*big accumulates in f32), which keeps f32 accuracy; one TF32 pass
would not.  T's two planes are split once, here, at pack time, and laid
out as the kernel's shared-memory image (``_split_planes``).  The
Mosaic-specific bf16 splits, selection dots and VMEM plans of the TPU
kernel have no counterpart here.  The same kernel covers the grids the
TPU served with its stream kernel K2 (15^5 to 19^5, 9^6): it walks the
contraction depth in shared-memory stages, so only the rows of a block's
points must fit.

The operand cache and plain contraction here are generic over the
dtype, and ``_pack`` at f64 gives the f64 kernel's plain [k_pad][ld]
layout: ``ops.fused_dd`` runs the f64 kernel of the same source.

- ``fused_eval_batch`` launches the kernel for CUDA tensors (or raises),
  and runs the plain PyTorch version of the same function for CPU
  tensors.  Nothing falls back from one to the other.
- ``fused_eval_batch_reference`` is that plain version (IEEE f32), on
  any device: the CPU tests use it, and the chip check compares the
  kernel with it.  ``_matmul_3xtf32_chunked`` emulates the kernel's
  3xTF32 product and its chunked accumulation in plain PyTorch, for the
  tests.
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
for which one of the kernel's plans (``_wg_plan``) fits Hopper's 227 KB
of shared memory per block, and whose padded depth x width is under
2^31 elements.
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
from pychebyshev_tpu_torch.utils.tracing import span

__all__ = ["fused_eval_batch", "fused_eval_batch_reference",
           "supports_fused", "clear_fused_cache", "refuse_grad",
           "launches"]

#: Kernel launches since import (or since the caller last reset it).
launches = 0

# Kernel geometry; keep in step with the constants in csrc/fused_eval.cu.
_ENTRY = {torch.float32: "fused_eval_f32", torch.float64: "fused_eval_f64"}
_COL_TILE = 128       # left-index columns per tile; t3's rows pad to it
_MAX_DIMS = 16
_MAX_SMEM_BYTES = 232448   # 227 KB: a Hopper block's shared-memory cap
# The f64 kernel (mma.sync): 128 points a block, stages 16 deep in a ring
# of 3, two A stages, four column warps' partial sums, rows padded 4.
_BLOCK_POINTS = 128
_DEPTH = 16           # contraction steps per stage; t3's depth pads to it
_STAGES = 3
_WARPS_N = 4
_PAD = 4
# The f32 kernel (wgmma): stages 32 deep (one 128-byte swizzle row of
# f32), each stage's products summed on the tensor cores and added in
# IEEE f32; 64 points a consumer warpgroup.  Plans (consumer warpgroups, ring
# stages), the first that fits shared memory taken; the kernel takes the
# plan from the wrapper and only checks that it fits.
_WG_DEPTH = 32
_WG_PLANS = ((2, 3), (2, 2), (1, 3), (1, 2))


def _geometry(shape: Tuple[int, ...]):
    """(s, n_left, n_mid, n_rp) of the kernel's split of ``shape``."""
    s = _split_index(shape)
    return s, math.prod(shape[:s]), shape[s], math.prod(shape[s + 1:])


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _wg_smem_bytes(shape: Tuple[int, ...], consumers: int,
                   stages: int) -> int:
    """Shared memory of one f32 block under a plan: 1 KB to align the
    ring to the swizzle's 1,024-byte atoms; per stage two 16 KB T planes,
    A's two planes (128 bytes a point) and two mbarriers; the rows of the
    block's 64 * ``consumers`` points at an odd stride; the table of
    16-bit row lanes of the right-prime dims for each right-prime
    index."""
    s, _, _, n_rp = _geometry(shape)
    points = 64 * consumers
    stage = 2 * _COL_TILE * _WG_DEPTH * 4 + 2 * points * _WG_DEPTH * 4
    return (1024 + stages * (stage + 16) + 4 * points * (sum(shape) | 1)
            + 2 * n_rp * (len(shape) - s - 1))


def _wg_plan(shape: Tuple[int, ...]):
    """(consumer warpgroups, ring stages) of the f32 kernel's plan for
    this grid: the first of ``_WG_PLANS`` that fits a block's shared
    memory, or None."""
    for plan in _WG_PLANS:
        if _wg_smem_bytes(shape, *plan) <= _MAX_SMEM_BYTES:
            return plan
    return None


def _smem_bytes(shape: Tuple[int, ...], dtype=torch.float32) -> int:
    """Shared memory one block needs.  f32: the plan ``_wg_plan`` takes
    (the smallest plan's where none fits).  f64: the ring of T stages,
    two A stages, the column warps' partial sums, the rows of the
    block's points, and the right-prime lane table."""
    if dtype == torch.float32:
        return _wg_smem_bytes(shape, *(_wg_plan(shape) or _WG_PLANS[-1]))
    s, _, _, n_rp = _geometry(shape)
    stages = (_STAGES + 2) * _DEPTH * (_COL_TILE + _PAD)
    lanes = 2 * n_rp * (len(shape) - s - 1)
    return (8 * (stages + _WARPS_N * _BLOCK_POINTS
                 + _BLOCK_POINTS * sum(shape)) + lanes)


def _fits(shape: Tuple[int, ...], dtype) -> bool:
    """Whether the kernel of ``dtype`` takes this grid: its shared memory
    fits a block, and its depth padded to 16 times its width padded to
    128 is under 2^31 elements (the f64 kernel's offsets are 32-bit; the
    f32 kernel keeps the same cap)."""
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
    """(pack, nodes_cat, weights_cat) at ``dtype`` on the tensor's device.

    T3 is the derivative-applied tensor as (n_mid*n_rp, n_left) over the
    flattened left index, zero-padded to whole stages of the kernel
    (depth a multiple of 16 at f64, 32 at f32; width a multiple of
    ``_COL_TILE``).  At f64 the pack is that (k_pad, ld) T3, row
    ``j*n_rp + r`` holding ``T[:, j, r]``, which the kernel streams in
    16-byte-aligned tiles.  At f32 the contraction runs r-major, row
    ``r*n_mid + j`` holding ``T[:, j, r]`` (the kernel then forms the
    right-prime product once every n_mid steps), and the pack is T3's
    TF32 planes as the kernel's stage images (``_split_planes``).
    Derivatives are applied in f64 before the cast.
    """
    t = tensor.to(torch.float64)
    if any(orders):
        t = apply_derivative_passes(
            t, [m.to(torch.float64) for m in diff_matrices], orders)
    _, n_left, n_mid, n_rp = _geometry(shape)
    k = n_mid * n_rp
    f32 = dtype == torch.float32
    t3 = torch.zeros((_round_up(k, _WG_DEPTH if f32 else _DEPTH),
                      _round_up(n_left, _COL_TILE)),
                     dtype=dtype, device=tensor.device)
    if f32:
        t3[:k, :n_left] = t.reshape(n_left, n_mid, n_rp).permute(
            2, 1, 0).reshape(k, n_left)
        t3 = _split_planes(t3)
    else:
        t3[:k, :n_left] = t.reshape(n_left, k).T
    nodes_cat = torch.cat([a.reshape(-1) for a in nodes]).to(
        device=tensor.device, dtype=dtype).contiguous()
    weights_cat = torch.cat([a.reshape(-1) for a in weights]).to(
        device=tensor.device, dtype=dtype).contiguous()
    return t3, nodes_cat, weights_cat


def _swizzle_index(device) -> torch.Tensor:
    """(128, 8): the 128-byte swizzle of a K-major [128][32] f32 tile,
    column n's 16-byte chunk c stored at chunk c ^ (n % 8).  An
    involution, so the same gather stores and loads."""
    n = torch.arange(_COL_TILE, device=device)[:, None]
    return torch.arange(8, device=device)[None, :] ^ (n & 7)


def _split_planes(t3: torch.Tensor) -> torch.Tensor:
    """f32 T3 (k_pad, ld) -> (n_ct, n_kt, 2, 128, 32): for each column
    tile and stage, T3's TF32 big plane ``tf32(T3)`` and small plane
    ``T3 - big`` (exact, so big + small is T3), each K-major (column n's
    32 k contiguous) with the 128-byte swizzle.  That is the image
    ``wgmma`` reads from shared memory, so one bulk copy moves a stage."""
    k_pad, ld = t3.shape
    big = _tf32_round(t3)
    planes = torch.stack([big, t3 - big])
    x = planes.reshape(2, k_pad // _WG_DEPTH, _WG_DEPTH, ld // _COL_TILE,
                       _COL_TILE).permute(3, 1, 0, 4, 2)
    x = x.reshape(*x.shape[:4], 8, 4)
    n = torch.arange(_COL_TILE, device=t3.device)[:, None]
    x = x[:, :, :, n, _swizzle_index(t3.device)]
    return x.reshape(*x.shape[:4], _WG_DEPTH).contiguous()


def _t3_of_pack(pack: torch.Tensor) -> torch.Tensor:
    """T3 (k_pad, ld) of either pack, in its own row order: the f64 one
    is T3; the f32 one gives it back as big + small, exactly, undoing
    ``_split_planes``' layout."""
    if pack.dim() == 2:
        return pack
    n_ct, n_kt = pack.shape[:2]
    n = torch.arange(_COL_TILE, device=pack.device)[:, None]
    x = pack.reshape(n_ct, n_kt, 2, _COL_TILE, 8, 4)
    x = x[:, :, :, n, _swizzle_index(pack.device)]
    x = x.reshape(n_ct, n_kt, 2, _COL_TILE, _WG_DEPTH).permute(2, 1, 4, 0, 3)
    big, small = x.reshape(2, n_kt * _WG_DEPTH, n_ct * _COL_TILE)
    return big + small


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
    """``_pack``'s operands through the LRU list ``cache``, in the
    ``route.operands`` span."""
    with span("route.operands"):
        keyed = (tensor, *nodes, *weights,
                 *(diff_matrices if any(orders) else ()))
        versions = tuple(t._version for t in keyed)
        with _cache_lock:
            for i, (e_keyed, e_versions, e_orders, packed) in enumerate(
                    cache):
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


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of an f32 operand: its top 19 bits
    (TF32), the low 13 mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A 3xTF32 product in plain PyTorch, as ``csrc/fused_tt.cu`` (K4)
    forms it: each operand split into TF32 big and small parts (both
    ``cvt.rna``), small*big + big*small + big*big summed in f32 (each
    TF32 x TF32 product is exact in f32)."""
    a_big, b_big = _tf32_round(a), _tf32_round(b)
    a_small, b_small = _tf32_round(a - a_big), _tf32_round(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _matmul_3xtf32_chunked(a: torch.Tensor, b: torch.Tensor,
                           depth: int = _WG_DEPTH
                           ) -> torch.Tensor:
    """The f32 kernel's product in plain PyTorch: big = ``tf32(x)``,
    small = x - big read by the tensor cores as TF32 (truncated), and
    small*big + big*small + big*big summed over each ``depth``-deep
    chunk of the contraction, the chunks' sums added in IEEE f32 in
    order."""
    a_big, b_big = _tf32_round(a), _tf32_round(b)
    a_small, b_small = _tf32_trunc(a - a_big), _tf32_trunc(b - b_big)
    out = None
    for k0 in range(0, a.shape[-1], depth):
        ks = slice(k0, k0 + depth)
        part = (a_small[..., ks] @ b_big[ks] + a_big[..., ks] @ b_small[ks]
                + a_big[..., ks] @ b_big[ks])
        out = part if out is None else out + part
    return out


def _contract_packed(pack, nodes_cat, weights_cat, shape, points,
                     matmul=torch.matmul):
    """The kernel's function in plain PyTorch, on the kernel's padded
    operands (same rows, same Khatri-Rao order, same contraction order,
    same dtype), in bounded slices.  ``matmul`` forms the contraction;
    the tests pass ``_matmul_3xtf32_chunked`` to emulate the f32
    kernel's tensor-core passes."""
    s, n_left, n_mid, n_rp = _geometry(shape)
    r_major = pack.dim() == 5   # the f32 kernel's order
    # The padding contributes nothing.
    t3 = _t3_of_pack(pack)[:n_mid * n_rp, :n_left]
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
            a = (w_rp[:, :, None] * a[:, None, :] if r_major
                 else a[:, :, None] * w_rp[:, None, :])
            a = a.reshape(pts.shape[0], -1)
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
    """Declare the C entry points' signatures on a loaded library: the
    f32 entry takes the plan (consumer warpgroups, ring stages) after the
    split index."""
    for dtype, entry in _ENTRY.items():
        plan = [ctypes.c_int] * 2 if dtype == torch.float32 else []
        fn = getattr(lib, entry)
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
            + plan + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.fused_eval_error_string.argtypes = [ctypes.c_int]
    lib.fused_eval_error_string.restype = ctypes.c_char_p
    return lib


def _launch(pack, nodes_cat, weights_cat, shape, points):
    """Launch the kernel of ``pack.dtype`` on the current stream, in the
    ``route.kernel_launch`` span; the f32 kernel with the plan
    ``_wg_plan`` chooses.  Raises on a refused launch; counting it is the
    caller's job."""
    entry = _ENTRY[pack.dtype]
    plan = _wg_plan(shape) if pack.dtype == torch.float32 else ()
    n = points.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"{n} points exceed the kernel's int32 count")
    with span("route.kernel_launch"):
        out = torch.empty(n, dtype=pack.dtype, device=points.device)
        if n == 0:
            return out
        lib = _library()
        dims = (ctypes.c_int * len(shape))(*shape)
        with torch.cuda.device(points.device):
            stream = torch.cuda.current_stream(points.device).cuda_stream
            err = getattr(lib, entry)(
                points.data_ptr(), nodes_cat.data_ptr(),
                weights_cat.data_ptr(), pack.data_ptr(), out.data_ptr(), n,
                len(shape), ctypes.cast(dims, ctypes.c_void_p),
                _split_index(shape), *plan, stream)
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

"""Fused f32 batched tensor-train evaluation: one hand-written kernel for
the whole chain (K4).

Replaces no Pallas kernel: the JAX package runs the TT chain in XLA,
and ``ops.tt_eval`` runs it as plain PyTorch, per core a GEMM, a product
and a sum whose (N, n * r) intermediates go through device memory.  The
kernel (``csrc/fused_tt.cu``) keeps the running (points, rank) row, the
Chebyshev rows and each stage's Khatri-Rao operand on chip, so device
memory sees the points in and one float out per point.  Its stages run
on the TF32 tensor cores in three passes (3xTF32, as K1 in
``ops.fused_eval``), which keeps f32 accuracy; one TF32 pass would not.

- ``fused_tt_eval_batch`` launches the kernel for CUDA cores (or
  raises), and runs the plain version of the same function, the f32
  chain of ``ops.tt_eval.tt_eval_batch``, for CPU cores.  Nothing falls
  back from one to the other.
- Packed operands (the padded cores in the kernel's order, and the
  domain's ``lo`` and ``1 / (hi - lo)``) are built once per set of cores
  and domain and kept on the cores' device (``_operand_cache``), so a
  call uploads nothing.
- ``launches`` counts kernel launches (a plain integer; reset it by
  assignment).  The benchmark's trace check counts K1-K3 alone, so this
  counter is kept apart from theirs.
- The kernel has no backward: the route refuses cores or points that
  require grad while grad mode is on (``fused_eval.refuse_grad``, as
  K1-K3 do); the chain of ``ops.tt_eval`` stays differentiable.

Scope (``supports_fused_tt``): f32, 2 to 16 cores with boundary ranks 1,
every rank at most 64, and a pack that fits a block's 227 KB of shared
memory.

The pack: ranks pad to multiples of 8, and core s becomes
``n_s * tiles_l * tiles_r`` fragments of 64 floats, one per (j, t, nt)
in that order, where lane ``4 g + q`` holds, side by side,
``G[8 t + q + 4 h, j, 8 nt + rho(g)]`` for h = 0, 1, with
``rho(c) = (c >> 1) + 4 (c & 1)`` the column permutation that lets the
kernel carry the row from stage to stage in registers.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Sequence

import numpy as np
import torch

from pychebyshev_tpu_torch.ops import _build, tt_eval
from pychebyshev_tpu_torch.ops.fused_eval import refuse_grad
from pychebyshev_tpu_torch.utils.tracing import span

__all__ = ["fused_tt_eval_batch", "supports_fused_tt",
           "clear_fused_tt_cache", "launches"]

#: Kernel launches since import (or since the caller last reset it).
launches = 0

# Kernel geometry; keep in step with the constants in csrc/fused_tt.cu.
_MAX_CORES = 16
_TILE = 8            # ranks pad to multiples of 8
_MAX_RANK = 64       # eight tiles of 8
_FRAG = 64           # floats of one k8 x n8 fragment
_MAX_SMEM_BYTES = 232448   # 227 KB: a Hopper block's shared-memory cap
_MAX_POINTS = 1 << 30      # the kernel's point count is int32
# The physical column c of a tile holds logical column _RHO[c].
_RHO = (0, 4, 1, 5, 2, 6, 3, 7)


def _tiles(r: int) -> int:
    return -(-r // _TILE)


def _plan(shapes) -> tuple:
    """(first float of each core in the pack, floats in the pack)."""
    offsets, floats = [], 0
    for r_l, n, r_r in shapes:
        offsets.append(floats)
        floats += n * _tiles(r_l) * _tiles(r_r) * _FRAG
    return tuple(offsets), floats


def _smem_bytes(shapes) -> int:
    """Shared memory one block needs: the whole pack in f32."""
    return 4 * _plan(shapes)[1]


def _fits(shapes) -> bool:
    """Whether the kernel takes a chain of these (r_l, n, r_r) shapes."""
    if not 2 <= len(shapes) <= _MAX_CORES:
        return False
    if shapes[0][0] != 1 or shapes[-1][2] != 1:
        return False
    for k, (r_l, n, r_r) in enumerate(shapes):
        if min(r_l, n, r_r) < 1 or max(r_l, r_r) > _MAX_RANK:
            return False
        if k and r_l != shapes[k - 1][2]:
            return False
    return _smem_bytes(shapes) <= _MAX_SMEM_BYTES


def supports_fused_tt(shapes: Sequence[Sequence[int]], dtype) -> bool:
    """Whether the kernel covers a TT of these core shapes at ``dtype``."""
    shapes = tuple(tuple(int(x) for x in s) for s in shapes)
    return (dtype == torch.float32 and all(len(s) == 3 for s in shapes)
            and _fits(shapes))


def _pack_core(core: torch.Tensor) -> torch.Tensor:
    """One (r_l, n, r_r) core as the kernel's fragments, flat."""
    r_l, n, r_r = core.shape
    tl, tr = _tiles(r_l), _tiles(r_r)
    pad = core.new_zeros((n, _TILE * tl, _TILE * tr))
    pad[:, :r_l, :r_r] = core.permute(1, 0, 2)
    # (j, t, h, q, nt, g): row 8t + 4h + q, column 8nt + rho(g).
    frag = pad.reshape(n, tl, _TILE, tr, _TILE)[..., list(_RHO)]
    frag = frag.reshape(n, tl, 2, 4, tr, _TILE)
    return frag.permute(0, 1, 4, 5, 3, 2).reshape(-1)


def _pack(cores, domain, device):
    """(pack, lo, inv) at f32 on ``device``: the cores as the kernel's
    fragments (packed in f64, then cast), and the domain's lower ends
    and reciprocal widths."""
    pack = torch.cat([_pack_core(torch.as_tensor(c).to(
        device=device, dtype=torch.float64)) for c in cores])
    dom = np.asarray(domain, dtype=np.float64).reshape(len(cores), 2)
    lo = torch.tensor(dom[:, 0], dtype=torch.float32, device=device)
    inv = torch.tensor(1.0 / (dom[:, 1] - dom[:, 0]), dtype=torch.float32,
                       device=device)
    return pack.to(torch.float32), lo, inv


# Small strong-reference LRU of packed operands, keyed as
# ``ops.fused_eval``'s: the same core tensors (identity) at the same
# ``_version``s, and the same domain values.
_CACHE_SLOTS = 16
_operand_cache: list = []
_cache_lock = threading.Lock()


def clear_fused_tt_cache() -> None:
    """Drop all cached packed operands."""
    with _cache_lock:
        _operand_cache.clear()


def _packed_operands(cores, domain, device):
    """``_pack``'s operands through the cache, in the ``route.operands``
    span."""
    with span("route.operands"):
        versions = tuple(c._version for c in cores)
        dom_key = np.asarray(domain, dtype=np.float64).tobytes()
        with _cache_lock:
            for i, (e_cores, e_versions, e_dom, packed) in enumerate(
                    _operand_cache):
                if (e_versions == versions and e_dom == dom_key
                        and len(e_cores) == len(cores)
                        and all(a is b for a, b in zip(e_cores, cores))):
                    _operand_cache.insert(0, _operand_cache.pop(i))
                    return packed
        packed = _pack(cores, domain, device)
        with _cache_lock:
            _operand_cache.insert(0, (cores, versions, dom_key, packed))
            del _operand_cache[_CACHE_SLOTS:]
        return packed


def _prepare(cores, domain, points):
    """Validated (cores, shapes, points) with points as contiguous f32
    on the cores' device."""
    cores = tuple(cores)
    if not cores or not all(isinstance(c, torch.Tensor) for c in cores):
        raise TypeError("cores must be a non-empty sequence of tensors")
    device = cores[0].device
    if any(c.device != device or c.dim() != 3 for c in cores):
        raise ValueError("cores must be 3-D tensors on one device")
    shapes = tt_eval.core_shapes(cores)
    if not _fits(shapes):
        raise ValueError(
            f"TT core shapes {list(shapes)} are outside the fused TT "
            f"kernel's envelope (2 to {_MAX_CORES} chained cores, boundary "
            f"ranks 1, ranks at most {_MAX_RANK}, a pack of at most "
            f"{_MAX_SMEM_BYTES} bytes); use ops.tt_eval.tt_eval_batch")
    if np.asarray(domain).shape != (len(cores), 2):
        raise ValueError(f"domain must have shape ({len(cores)}, 2), got "
                         f"{np.asarray(domain).shape}")
    if not isinstance(points, torch.Tensor):
        points = torch.as_tensor(points, dtype=torch.float32, device=device)
    if points.device != device:
        raise ValueError(f"points on {points.device}, cores on {device}")
    if points.dim() != 2 or points.shape[1] != len(cores):
        raise ValueError(f"points must have shape (N, {len(cores)}), got "
                         f"{tuple(points.shape)}")
    if points.shape[0] > _MAX_POINTS:
        raise ValueError(f"{points.shape[0]} points exceed the kernel's "
                         f"{_MAX_POINTS} a call")
    return cores, shapes, points.to(torch.float32).contiguous()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("fused_tt")
    lib.fused_tt_f32.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    lib.fused_tt_f32.restype = ctypes.c_int
    lib.fused_tt_error_string.argtypes = [ctypes.c_int]
    lib.fused_tt_error_string.restype = ctypes.c_char_p
    return lib


def _launch(pack, lo, inv, shapes, points):
    """Launch the kernel on the current stream, in the
    ``route.kernel_launch`` span.  Raises on a refused launch; counting it
    is the caller's job."""
    with span("route.kernel_launch"):
        n = points.shape[0]
        out = torch.empty(n, dtype=torch.float32, device=points.device)
        if n == 0:
            return out
        lib = _library()
        flat = [x for s in shapes for x in s]
        dims = (ctypes.c_int * len(flat))(*flat)
        with torch.cuda.device(points.device):
            stream = torch.cuda.current_stream(points.device).cuda_stream
            err = lib.fused_tt_f32(
                points.data_ptr(), lo.data_ptr(), inv.data_ptr(),
                pack.data_ptr(), out.data_ptr(), n, len(shapes),
                ctypes.cast(dims, ctypes.c_void_p), stream)
    if err != 0:
        msg = lib.fused_tt_error_string(err).decode()
        raise RuntimeError(f"fused_tt_f32 launch failed: {msg} "
                           f"(cudaError {err})")
    return out


def fused_tt_eval_batch(cores, domain, points) -> torch.Tensor:
    """Fused f32 TT evaluation -> (N,) f32 on the cores' device.

    Drop-in for ``ops.tt_eval.tt_eval_batch`` at f32 on the per-dim
    chain: ``cores`` are the (r_{k-1}, n_k, r_k) coefficient cores
    (storage frame), ``domain`` the (d, 2) per-dim [lo, hi], ``points``
    (N, d).  CUDA cores launch the kernel, with packed operands cached;
    CPU cores run the f32 chain of ``ops.tt_eval``; any other device
    raises.  Refuses tensors that require grad.
    """
    global launches
    refuse_grad("fused_tt_eval_batch", cores, points)
    cores, shapes, points = _prepare(cores, domain, points)
    device = cores[0].device
    if device.type == "cpu":
        return tt_eval.tt_eval_batch(tuple(c.float() for c in cores),
                                     domain, points)
    if device.type != "cuda":
        raise ValueError(f"fused_tt_eval_batch runs on cuda or cpu "
                         f"tensors, got {device}")
    pack, lo, inv = _packed_operands(cores, domain, device)
    out = _launch(pack, lo, inv, shapes, points)
    launches += points.shape[0] > 0   # an empty batch launches nothing
    return out


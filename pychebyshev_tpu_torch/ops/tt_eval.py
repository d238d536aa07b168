"""Batched tensor-train evaluation in plain PyTorch: the TT query path.

The port of ``pychebyshev_tpu.ops.tt_eval``.  For a batch of N points
the running interface row ``(N, r)`` is contracted dimension by
dimension:

    a[n, j, k] = sum_i row[n, i] * core[i, j, k]     (one GEMM)
    row[n, k]  = sum_j Q[n, j] * a[n, j, k]          (product and sum)

with Q the Chebyshev polynomial values from the three-term recurrence.
Contracting the *row* before Q keeps the peak intermediate at
(N, n_k, r_k), linear in the bond rank, instead of the (N, r, r)
blow-up a Q-first ordering produces at high ranks.  Large batches run
in slices so that intermediate stays bounded for any N.

The JAX package runs this chain in XLA, outside any hand-written
kernel, so its small matrix products stay ``torch.matmul`` here.
Float32 matmuls rely on torch's default ``allow_tf32 = False`` (full
IEEE f32): a chain of d stages would compound TF32's rounding.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from pychebyshev_tpu_torch.models.tt_algorithms import tt_merge_cores
from pychebyshev_tpu_torch.ops.chebyshev import chebyshev_polynomial_matrix

__all__ = ["tt_eval_batch", "tt_eval_batch_models", "stack_rank_padded",
           "merged_cores", "core_shapes", "group_slices",
           "validated_groups"]

# Batches whose widest (N, n_k * r_k) intermediate exceeds the cap are
# processed in slices.  On the CPU the cap is fixed; on a CUDA device it
# is a fixed share of the card's memory (the chain holds about three
# arrays of this size at its peak).
_MAX_INTERMEDIATE_ELEMS_CPU = 1 << 23
_CUDA_MEMORY_SHARE = 32     # cap in bytes = total memory / this


def _max_intermediate_elems(device: torch.device, itemsize: int) -> int:
    if device.type != "cuda":
        return _MAX_INTERMEDIATE_ELEMS_CPU
    total = torch.cuda.get_device_properties(device).total_memory
    return max(_MAX_INTERMEDIATE_ELEMS_CPU,
               total // (_CUDA_MEMORY_SHARE * itemsize))


def _chunk_size(per_point: int, device: torch.device, itemsize: int) -> int:
    """Points per slice so the widest per-point intermediate stays under
    the device's cap."""
    return max(256, _max_intermediate_elems(device, itemsize)
               // max(per_point, 1))


def core_shapes(cores) -> Tuple[Tuple[int, int, int], ...]:
    """The (r_l, n, r_r) shapes of a core chain as plain ints."""
    return tuple(tuple(int(x) for x in c.shape) for c in cores)


def group_slices(groups: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """(start, stop) core positions of each contiguous group."""
    out, i = [], 0
    for g in groups:
        out.append((i, i + g))
        i += g
    return tuple(out)


def validated_groups(groups, n_cores: int):
    """``groups`` as a tuple of ints, or ``None`` for the per-dim chain
    (``None`` or all ones).  Raises on sizes that do not partition the
    chain."""
    if groups is None or tuple(groups) == (1,) * n_cores:
        return None
    groups = tuple(int(g) for g in groups)
    if any(g < 1 for g in groups) or sum(groups) != n_cores:
        raise ValueError(
            f"groups {groups} must be positive and sum to the "
            f"number of cores ({n_cores})")
    return groups


def _scaled(points: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
            d: int) -> torch.Tensor:
    return 2.0 * (points[:, d] - lo[d]) / (hi[d] - lo[d]) - 1.0


def _stage(row: torch.Tensor, core: torch.Tensor,
           q: torch.Tensor) -> torch.Tensor:
    """One stage of the chain.  ``core`` is (r_l, w, r_r) for one model
    (``row`` (N, r_l) -> (N, r_r)) or (M, r_l, w, r_r) for a book of M
    (``row`` (M, N, r_l) -> (M, N, r_r)); ``q`` the shared (N, w) rows."""
    r_l, w, r_r = core.shape[-3:]
    a = torch.matmul(row, core.reshape(*core.shape[:-3], r_l, w * r_r))
    a = a.reshape(*a.shape[:-1], w, r_r)
    # The reduction over the node axis as a product and a sum.  It makes
    # a second (N, w, r_r) array, which the slice cap allows for; the
    # same reduction as a batched (1, w) @ (w, r_r) product measured
    # slower on the H100 (PERF.md, plain paths of the TT slice).
    return (a * q[:, :, None]).sum(dim=-2)


def _chain(cores, lo, hi, points):
    """The per-dim chain.  4-D cores carry a leading model axis."""
    lead = cores[0].shape[:-3]
    row = points.new_ones((*lead, points.shape[0], 1))
    for d, core in enumerate(cores):
        q = chebyshev_polynomial_matrix(_scaled(points, lo, hi, d),
                                        core.shape[-2])
        row = _stage(row, core, q)
    return row[..., 0]


def _chain_grouped(cores_merged, dims_n, slices, lo, hi, points):
    """The grouped supercore chain: per-dim Chebyshev rows, Khatri-Rao
    per group, GEMMs contract over the group width.

    Merging adjacent cores exactly
    (``models.tt_algorithms.tt_merge_cores``) removes the interior bonds
    of a group from the chain; the result is the same tensor's value to
    rounding.
    """
    qs = [chebyshev_polynomial_matrix(_scaled(points, lo, hi, d), n_d)
          for d, n_d in enumerate(dims_n)]
    lead = cores_merged[0].shape[:-3]
    row = points.new_ones((*lead, points.shape[0], 1))
    for core, (a, z) in zip(cores_merged, slices):
        q = qs[a]
        for k in range(a + 1, z):
            q = (q[:, :, None] * qs[k][:, None, :]).reshape(
                q.shape[0], -1)
        row = _stage(row, core, q)
    return row[..., 0]


def _sliced(fn, points: torch.Tensor, per_point: int,
            lead: Tuple[int, ...], dtype) -> torch.Tensor:
    """``fn`` over slices of the points axis (the last of the result)."""
    chunk = _chunk_size(per_point, points.device,
                        torch.empty((), dtype=dtype).element_size())
    n = points.shape[0]
    if n <= chunk:
        return fn(points) if n else points.new_empty((*lead, 0), dtype=dtype)
    return torch.cat([fn(points[i:i + chunk]) for i in range(0, n, chunk)],
                     dim=-1)


# Merged-core device cache.  Torch tensors are mutable, so an entry is
# keyed on the caller's core tensors AND their versions, and it keeps
# those tensors alive so their ids cannot be recycled.  NumPy cores are
# merged afresh on every call.
_merged_cache: list = []
_MERGED_CACHE_SLOTS = 16


def merged_cores(cores, groups, dtype, device):
    """The chain's cores merged exactly into one supercore per group (on
    the host, in f64), as ``dtype`` tensors on ``device``."""
    host = [c.detach().cpu().numpy() if isinstance(c, torch.Tensor)
            else np.asarray(c) for c in cores]
    return tuple(
        torch.tensor(c, dtype=dtype, device=device)
        for c in tt_merge_cores([np.asarray(c, dtype=np.float64)
                                 for c in host], list(groups)))


def _merged_cores_device(cores, groups, dtype, device):
    """``merged_cores`` through the cache."""
    key = (tuple(groups), dtype, str(device))
    cacheable = all(isinstance(c, torch.Tensor) for c in cores)
    if cacheable:
        versions = tuple(c._version for c in cores)
        for i, entry in enumerate(_merged_cache):
            if (entry[1] == key and len(entry[0]) == len(cores)
                    and all(a is b for a, b in zip(entry[0], cores))
                    and entry[2] == versions):
                _merged_cache.insert(0, _merged_cache.pop(i))
                return entry[3]
    merged = merged_cores(cores, groups, dtype, device)
    if cacheable:
        _merged_cache.insert(0, (tuple(cores), key, versions, merged))
        del _merged_cache[_MERGED_CACHE_SLOTS:]
    return merged


def _resolve(coeff_cores, points):
    """(device, compute dtype, points on the device at that dtype).

    The device is the cores' (the points' for NumPy cores, else the
    CPU).  The chain computes in the WIDEST of the points' and the
    cores' dtypes: f32 query points must not silently downcast f64 cores
    to the f32 tier, whose fast path needs f32 cores AND f32 points.
    """
    first = coeff_cores[0]
    if isinstance(first, torch.Tensor):
        device, core_dtype = first.device, first.dtype
    else:
        device = (points.device if isinstance(points, torch.Tensor)
                  else torch.device("cpu"))
        core_dtype = torch.from_numpy(np.empty(0, np.asarray(first).dtype)
                                      ).dtype
    if not isinstance(points, torch.Tensor):
        points = np.asarray(points)
        if points.dtype not in (np.float32, np.float64):
            points = points.astype(np.float64)
        points = torch.from_numpy(np.ascontiguousarray(points))
    elif points.dtype not in (torch.float32, torch.float64):
        points = points.to(torch.float64)
    dtype = torch.promote_types(points.dtype, core_dtype)
    if dtype not in (torch.float32, torch.float64):
        dtype = torch.float64
    return device, dtype, points.to(device=device, dtype=dtype)


def tt_eval_batch(coeff_cores, domain, points, groups=None) -> torch.Tensor:
    """Evaluate a TT (Chebyshev coefficient cores) at (N, d) points.

    Parameters
    ----------
    coeff_cores : sequence of (r_{k-1}, n_k, r_k) tensors (storage
        frame); their device is where the chain runs.
    domain : (d, 2) per-dim [lo, hi] (storage frame).
    points : (N, d) query points (storage frame).
    groups : ``None`` (per-dim chain), ``"auto"`` (the grouping
        ``ops.tt_eval_dd.tt_dd_auto_groups`` picks for these shapes), or
        an explicit tuple of contiguous group sizes.  Exact transform;
        results agree to dtype-level rounding.

    Returns (N,) values on the cores' device, in the widest of the
    points' and the cores' dtypes.
    """
    coeff_cores = tuple(coeff_cores)
    device, dtype, points = _resolve(coeff_cores, points)
    dom = torch.as_tensor(np.asarray(domain, dtype=np.float64),
                          dtype=dtype, device=device)
    shapes = core_shapes(coeff_cores)
    if isinstance(groups, str) and groups == "auto":
        from pychebyshev_tpu_torch.ops.tt_eval_dd import tt_dd_auto_groups
        groups = tt_dd_auto_groups(shapes)
    groups = validated_groups(groups, len(shapes))
    if groups is not None:
        merged = _merged_cores_device(coeff_cores, groups, dtype, device)
        dims_n = tuple(s[1] for s in shapes)
        slices = group_slices(groups)
        per_point = max(c.shape[1] * c.shape[2] for c in merged)
        return _sliced(
            lambda p: _chain_grouped(merged, dims_n, slices, dom[:, 0],
                                     dom[:, 1], p),
            points, per_point, (), dtype)
    cores = tuple(torch.as_tensor(c, device=device).to(dtype)
                  for c in coeff_cores)
    per_point = max(s[1] * s[2] for s in shapes)
    return _sliced(lambda p: _chain(cores, dom[:, 0], dom[:, 1], p),
                   points, per_point, (), dtype)


def stack_rank_padded(models_cores, dtype, device):
    """One (M, r_l, w, r_r) tensor per chain position from M same-grid
    models' cores (NumPy arrays or tensors), each model's bonds
    zero-padded to the book-wide rank at that bond.  Zero rows and
    columns add exact zeros, so padding changes no value."""
    models_cores = [list(cs) for cs in models_cores]
    stacked = []
    for k in range(len(models_cores[0])):
        cores_k = [torch.as_tensor(cs[k]).to(device=device, dtype=dtype)
                   for cs in models_cores]
        r_l = max(c.shape[0] for c in cores_k)
        r_r = max(c.shape[2] for c in cores_k)
        block = torch.zeros((len(cores_k), r_l, cores_k[0].shape[1], r_r),
                            dtype=dtype, device=device)
        for i, c in enumerate(cores_k):
            block[i, :c.shape[0], :, :c.shape[2]] = c
        stacked.append(block)
    return tuple(stacked)


def tt_eval_batch_models(stacked_cores, domain, points, groups=None,
                         dims_n=None) -> torch.Tensor:
    """Evaluate a book of M same-grid TTs at (N, d) points -> (M, N).

    ``stacked_cores`` is one (M, r_{k-1}, n_k, r_k) tensor per dim
    (``stack_rank_padded``).  One batched chain over the model axis: the
    Chebyshev rows are built once per slice and shared by the whole
    book.  With ``groups`` (contiguous group sizes) the tensors are the
    stacked merged supercores, one per group, and ``dims_n`` the per-dim
    node counts.
    """
    stacked_cores = tuple(stacked_cores)
    first = stacked_cores[0]
    dtype, device = first.dtype, first.device
    pts = torch.as_tensor(points, dtype=dtype, device=device)
    dom = torch.as_tensor(np.asarray(domain, dtype=np.float64),
                          dtype=dtype, device=device)
    m = int(first.shape[0])
    per_point = m * max(int(c.shape[2] * c.shape[3]) for c in stacked_cores)
    if groups is None:
        def fn(p):
            return _chain(stacked_cores, dom[:, 0], dom[:, 1], p)
    else:
        slices = group_slices(groups)

        def fn(p):
            return _chain_grouped(stacked_cores, tuple(dims_n), slices,
                                  dom[:, 0], dom[:, 1], p)
    return _sliced(fn, pts, per_point, (m,), dtype)

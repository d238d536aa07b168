"""Pipeline-parallel TT evaluation over a device mesh axis.

The port of ``pychebyshev_tpu.parallel.tt_pipeline``.  The TT query chain
(``ops.tt_eval``) is a sequential composition of per-dimension
contractions, the shape pipeline parallelism wants:
``tt_eval_batch_pp`` partitions the cores into contiguous stages, one
per rank along a ``"pp"`` mesh axis, and streams query microbatches
through them.  At step ``t`` the rank of stage ``p`` applies its cores
to microbatch ``t - p``'s row state and sends the state to the next
stage (``torch.distributed.batch_isend_irecv``); after ``M + P - 1``
steps all ``M`` microbatches have passed all ``P`` stages, and the last
stage broadcasts the (N,) values to every rank.

Each rank holds only its own stage's cores, so no stage is padded to a
common block (the reference pads, because a ``shard_map`` program is the
same on every device).  Points and the Chebyshev rows of each stage's
dims are per rank.  With one stage no message is sent.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from pychebyshev_tpu_torch.ops.chebyshev import chebyshev_polynomial_matrix
from pychebyshev_tpu_torch.ops.tt_eval import _scaled, _stage
from pychebyshev_tpu_torch.parallel.sharding import (
    _all_reduce,
    _checked,
    _on_mesh,
    _pad_rows,
    axis_size,
    mesh_device,
)

__all__ = ["tt_eval_batch_pp"]


def _stage_partition(d: int, n_stages: int) -> List[np.ndarray]:
    """Contiguous, balanced assignment of d cores to n_stages stages."""
    return [np.asarray(g, dtype=np.intp)
            for g in np.array_split(np.arange(d), n_stages)]


def _dtype_of(core) -> torch.dtype:
    """The chain's dtype: f32 for f32 cores, else f64."""
    if isinstance(core, torch.Tensor):
        dtype = core.dtype
    else:
        dtype = torch.from_numpy(np.zeros(0, np.asarray(core).dtype)).dtype
    return dtype if dtype in (torch.float32, torch.float64) else torch.float64


def tt_eval_batch_pp(cores: Sequence, domain, points, mesh,
                     axis: str = "pp",
                     microbatch: int = None) -> torch.Tensor:
    """Evaluate a TT at (N, d) points, cores pipelined over ``axis`` ->
    (N,) on every rank.

    Matches ``ops.tt_eval.tt_eval_batch`` numerically (the same stage
    arithmetic, in the cores' dtype).  ``microbatch`` defaults to
    ceil(N / P), which fills the pipeline exactly; smaller values trade
    bubble steps for less memory per step.
    """
    d = len(cores)
    n_stages = axis_size(mesh, axis)
    stage = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    device = mesh_device(mesh)
    dtype = _dtype_of(cores[0])
    shapes = [tuple(int(x) for x in np.shape(c)) for c in cores]
    groups = _stage_partition(d, n_stages)
    mine = [int(k) for k in groups[stage]]
    my_cores = [_on_mesh(cores[k], mesh, dtype) for k in mine]
    n_before = sum(len(g) for g in groups[:stage])
    width_in = 1 if n_before == 0 else shapes[n_before - 1][2]

    dom = torch.as_tensor(np.asarray(domain, dtype=np.float64), dtype=dtype,
                          device=device)
    pts = _on_mesh(points, mesh, dtype)
    n_pts = pts.shape[0]
    if n_pts == 0:
        return pts.new_zeros(0)
    m_size = int(microbatch or max(1, math.ceil(n_pts / n_stages)))
    n_micro = math.ceil(n_pts / m_size)
    pts = _pad_rows(pts, m_size)
    last = stage == n_stages - 1
    out = pts.new_zeros(n_micro * m_size)
    prev_peer = dist.get_global_rank(group, stage - 1) if stage else None
    next_peer = None if last else dist.get_global_rank(group, stage + 1)
    if n_stages > 1:
        # Every rank of the group takes part in one collective before the
        # first point-to-point step (NCCL's rule for batched P2P).
        _all_reduce(torch.zeros(1, dtype=dtype, device=device), group)

    received = None
    for t in range(n_micro + n_stages - 1):
        m = t - stage
        state = None
        if 0 <= m < n_micro:
            sl = pts[m * m_size:(m + 1) * m_size]
            state = (sl.new_ones((m_size, 1)) if stage == 0 else received)
            for k, core in zip(mine, my_cores):
                q = chebyshev_polynomial_matrix(
                    _scaled(sl, dom[:, 0], dom[:, 1], k), core.shape[1])
                state = _stage(state, core, q)
            if last:
                out[m * m_size:(m + 1) * m_size] = state[:, 0]
        ops = []
        if state is not None and not last:
            ops.append(dist.P2POp(dist.isend,
                                  _checked(state.contiguous(), group),
                                  next_peer, group))
        if stage and 0 <= t + 1 - stage < n_micro:
            received = torch.empty((m_size, width_in), dtype=dtype,
                                   device=device)
            ops.append(dist.P2POp(dist.irecv, _checked(received, group),
                                  prev_peer, group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
    if n_stages > 1:
        dist.broadcast(_checked(out, group),
                       src=dist.get_global_rank(group, n_stages - 1),
                       group=group)
    return out[:n_pts]

"""Device-mesh sharding for builds, queries and box integrals.

The port of ``pychebyshev_tpu.parallel.sharding``.  A JAX mesh is
single-controller: one process holds a global array sharded over its
devices.  Here a mesh is a ``torch.distributed.device_mesh.DeviceMesh``
with named dims (``"dp"``, ``"tp"``, ``"pp"``) over a process group, and
every entry point is SPMD: every rank calls it with the same full
inputs, computes the shard that belongs to its coordinate, and a
collective hands every rank the full, unpadded result as a plain tensor
on its own device (the global view a caller of the reference reads with
``np.asarray``).

- **Data-parallel** (``"dp"``): a batch of points, boxes or grid points
  is padded with copies of its first row to a multiple of the axis size;
  each rank serves its contiguous block through the same route as a
  single-device call (on a CUDA rank the hand-written kernels of
  ``ops.fused_eval`` and ``ops.fused_dd`` wherever they cover the grid),
  and ``all_gather`` joins the blocks in rank order.  Operands need no
  replication step: each rank holds them on its own device.
- **Tensor-parallel** (``"tp"``): the value tensor shards along one grid
  axis, padded with zero slabs and zero-weight sentinel nodes at 1e300
  (they add exactly nothing); the sharded dim's barycentric rows are
  normalized globally (``all_reduce`` SUM of the denominators,
  ``all_reduce`` MIN of each rank's first exact node hit, so a point on
  a node selects the globally first hit, as on one device), each rank
  contracts its slab and an ``all_reduce`` SUM completes the
  contraction.

Backends: NCCL for ``"cuda"`` meshes (each rank on its current CUDA
device), gloo for ``"cpu"`` meshes.  A CUDA tensor under a gloo group
raises; it is never staged through the host.

Not ported: ``_replicate_cache`` (a TPU ``device_put`` cache) and the tp
digit-plane program (``_compiled_dd_tp``, ``_tp_prepared``).  The dd
tier is native f64 in this package (``ops.eval_dd``), so
``eval_batch_dd_tp`` contracts f64 slabs and ``dd_tp_plan`` keeps only
the arithmetic of the plan's verdict.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pychebyshev_tpu_torch.config import NODE_COINCIDENCE_TOL
from pychebyshev_tpu_torch.ops import eval as eval_ops
from pychebyshev_tpu_torch.ops.chebyshev import nodes_for_dim_np

__all__ = [
    "make_mesh",
    "full_grid",
    "build_tensor_sharded",
    "sharded_vectorized",
    "eval_batch_dp",
    "integrate_box_batch_dp",
    "tt_integrate_box_batch_dd_dp",
    "eval_batch_dd_dp",
    "slider_batch_dd_dp",
    "tt_eval_batch_dd_dp",
    "eval_batch_tp",
    "eval_batch_dd_tp",
    "dd_tp_plan",
]

# A padded tensor-parallel axis gets zero-weight nodes here: no
# coordinate comes within NODE_COINCIDENCE_TOL of them.
_SENTINEL = 1e300
# Larger than any column index: "no exact node hit on this rank".
_NO_HIT = 1 << 62
# The reference's default digit-pair cutoff, reported by dd_tp_plan.
_PAIR_CUTOFF = 44

_GLOO_CUDA = ("a CUDA tensor cannot go through a gloo process group (it "
              "is never staged through the host); use a 'cuda' mesh over "
              "an NCCL group")


# ---------------------------------------------------------------------------
# The mesh, its device and its collectives
# ---------------------------------------------------------------------------


def axis_size(mesh, axis: str) -> int:
    """Size of the mesh dim named ``axis`` (the reference's
    ``mesh.shape[axis]``)."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(
            f"the mesh has no axis {axis!r}; its axes are {names}")
    return int(mesh.size(names.index(axis)))


def has_axis(mesh, axis: str) -> bool:
    """``axis in mesh.axis_names`` of the reference."""
    return axis in tuple(mesh.mesh_dim_names or ())


def mesh_device(mesh) -> torch.device:
    """The device this rank computes its share of ``mesh`` on: its
    current CUDA device under a ``"cuda"`` mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def check_device(mesh, device, where: str) -> torch.device:
    """The mesh's device on this rank, after checking that ``device``
    (an engine's or a fit's) names it; ``"cuda"`` without an index
    matches any CUDA rank."""
    want = mesh_device(mesh)
    got = torch.device(device)
    if got.type != want.type or (got.index is not None
                                 and got.index != want.index):
        raise ValueError(
            f"{where}: device={str(got)!r} contradicts the mesh, whose "
            f"device on this rank is {str(want)!r}")
    return want


def _on_mesh(x, mesh, dtype=None) -> torch.Tensor:
    """``x`` (an array or a tensor) on this rank's mesh device.  A CUDA
    tensor under a CPU mesh raises instead of passing through the
    host."""
    device = mesh_device(mesh)
    if isinstance(x, torch.Tensor) and x.is_cuda and device.type != "cuda":
        raise ValueError(_GLOO_CUDA)
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _tree_on_mesh(tree, mesh, dtype=None):
    """:func:`_on_mesh` over nested tuples (grids, slide data); ``None``
    entries stay ``None``, and without a mesh the tree is returned as it
    is."""
    if tree is None or mesh is None:
        return tree
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_on_mesh(t, mesh, dtype) for t in tree)
    return _on_mesh(tree, mesh, dtype)


def _checked(t: torch.Tensor, group) -> torch.Tensor:
    if t.is_cuda and dist.get_backend(group) == "gloo":
        raise ValueError(_GLOO_CUDA)
    return t


def _all_reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    """In-place ``all_reduce`` (SUM unless ``op``); returns ``t``."""
    if t.numel():
        dist.all_reduce(_checked(t, group),
                        op=dist.ReduceOp.SUM if op is None else op,
                        group=group)
    return t


def _all_gather_rows(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Equal-sized (n, ...) pieces of every rank in ``group`` stacked in
    rank order -> (size * n, ...)."""
    x = _checked(x.contiguous(), group)
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    gather = (getattr(dist, "all_gather_single", None)
              or dist.all_gather_into_tensor)
    gather(out, x, group=group)
    return out


def _pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """``x`` padded with copies of its first row to a multiple of
    ``multiple`` rows (the first row is always a valid input)."""
    pad = -x.shape[0] % multiple
    if pad:
        x = torch.cat([x, x[:1].expand(pad, *x.shape[1:])])
    return x


def _shard_rows(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """This rank's contiguous block of the padded ``x`` along ``axis``."""
    size = axis_size(mesh, axis)
    x = _pad_rows(x, size)
    per = x.shape[0] // size
    rank = mesh.get_local_rank(axis)
    return x[rank * per:(rank + 1) * per]


def _dp_apply(fn: Callable, rows: torch.Tensor, mesh, axis: str = "dp",
              dim: int = -1) -> torch.Tensor:
    """``fn`` on this rank's block of ``rows`` (N, ...), every rank's
    result joined along ``dim`` (the rows axis of ``fn``'s result): the
    full (unpadded) result on every rank.  ``fn`` must be per-row work.
    """
    n = rows.shape[0]
    if n == 0:
        return fn(rows)
    local = fn(_shard_rows(rows, mesh, axis)).movedim(dim, 0)
    full = _all_gather_rows(local, mesh.get_group(axis),
                            axis_size(mesh, axis))
    return full[:n].movedim(0, dim).contiguous()


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, ...] = ("dp",),
              shape: Optional[Tuple[int, ...]] = None, *,
              device_type: str):
    """A ``DeviceMesh`` over the whole world of the default process
    group (``torch.distributed.init_process_group`` first, one rank per
    device: NCCL for ``device_type="cuda"``, gloo for ``"cpu"``).

    With one axis name the mesh is 1-D; pass ``shape`` for multi-axis
    meshes (e.g. ``axis_names=("dp", "tp"), shape=(2, 2)``).
    ``n_devices`` and ``prod(shape)`` must equal the world size: a mesh
    here spans every rank.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialized default process group "
            "(torch.distributed.init_process_group), one rank per device")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(
            f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if device_type == "cuda" and torch.cuda.device_count() == 0:
        raise RuntimeError("a 'cuda' mesh needs a CUDA card; none is "
                           "visible to this process")
    backend = dist.get_backend()
    if (device_type == "cuda") != (backend == "nccl"):
        raise ValueError(
            f"a {device_type!r} mesh runs over "
            f"{'NCCL' if device_type == 'cuda' else 'gloo'}; the default "
            f"process group's backend is {backend!r}")
    world = dist.get_world_size()
    axis_names = tuple(axis_names)
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(
            f"n_devices={n_devices} must equal the world size {world}: "
            f"a mesh spans every rank")
    if shape is None:
        shape = (world,)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(
            f"shape {shape} and axis_names {axis_names} differ in length")
    if math.prod(shape) != world:
        raise ValueError(
            f"mesh shape {shape} holds {math.prod(shape)} devices; the "
            f"world has {world} ranks")
    return init_device_mesh(device_type, shape, mesh_dim_names=axis_names)


# ---------------------------------------------------------------------------
# Data-parallel builds
# ---------------------------------------------------------------------------


def full_grid(domain, n_nodes, *, device) -> torch.Tensor:
    """(prod(n), d) Cartesian Chebyshev grid in C order, f64 on
    ``device`` (the nodes of ``ChebyshevApproximation.nodes``)."""
    per_dim = [nodes_for_dim_np(domain[k][0], domain[k][1], int(n_nodes[k]))
               for k in range(len(n_nodes))]
    grids = np.meshgrid(*per_dim, indexing="ij")
    return torch.as_tensor(np.stack([g.ravel() for g in grids], axis=-1),
                           dtype=torch.float64, device=device)


def call_on_shard(function: Callable, points: torch.Tensor, data,
                  refusal: str) -> torch.Tensor:
    """``function(points, data)`` on one rank's shard, as f64 on the
    shard's device.  Under a mesh a function receives its shard as an
    (n, d) tensor on the mesh's device and answers with a tensor;
    anything else raises ``ValueError(refusal)``."""
    try:
        out = function(points, data)
    except TypeError as exc:
        raise ValueError(refusal) from exc
    if not isinstance(out, torch.Tensor):
        raise ValueError(refusal)
    if out.dim() == 0 or out.shape[0] != points.shape[0]:
        raise ValueError(
            f"the function returned shape {tuple(out.shape)} for a shard "
            f"of {int(points.shape[0])} points")
    return out.to(device=points.device, dtype=torch.float64)


def _vectorized_refusal(where: str) -> str:
    return (f"{where} requires a vectorized function of an (N, d) tensor "
            f"that answers with a tensor (the shard reaches it on the "
            f"mesh's device); black-box or NumPy functions evaluate on "
            f"host without a mesh")


def build_tensor_sharded(function: Callable, domain, n_nodes, mesh,
                         additional_data=None,
                         axis_name: str = "dp") -> torch.Tensor:
    """Evaluate a vectorized function over the grid, sharded.

    ``function(points (n, d) tensor, data) -> (n,)`` runs once on each
    rank's block of the C-order grid; the gathered values are the value
    tensor, on every rank.  Bitwise equal to the unsharded build
    whenever the function's value at a point does not depend on the
    batch around it.
    """
    grid = full_grid(domain, n_nodes, device=mesh_device(mesh))
    refusal = _vectorized_refusal("build_tensor_sharded")
    values = _dp_apply(
        lambda p: call_on_shard(function, p, additional_data,
                                refusal).reshape(-1),
        grid, mesh, axis_name)
    return values.reshape(tuple(int(n) for n in n_nodes))


def sharded_vectorized(function: Callable, mesh,
                       axis_name: str = "dp") -> Callable:
    """Wrap a vectorized function so that constructor-driven builds
    (``vectorized=True``) shard grid evaluation across the mesh: the
    wrapper takes host points and returns host f64 values, every rank
    the same."""
    refusal = _vectorized_refusal("sharded_vectorized")

    def wrapped(points, data):
        pts = _on_mesh(points, mesh, torch.float64)
        out = _dp_apply(
            lambda p: call_on_shard(function, p, data, refusal).reshape(-1),
            pts, mesh, axis_name)
        return out.cpu().numpy()
    return wrapped


# ---------------------------------------------------------------------------
# Data-parallel queries and box integrals
# ---------------------------------------------------------------------------


def eval_batch_dp(tensor, nodes, weights, diff_matrices, points, mesh,
                  orders: Tuple[int, ...],
                  axis_name: str = "dp") -> torch.Tensor:
    """Data-parallel batched evaluation (``ops.eval.eval_batch`` on each
    rank's block of the points) -> (N,) on every rank."""
    t = _on_mesh(tensor, mesh)
    grid = [_tree_on_mesh(g, mesh, t.dtype)
            for g in (nodes, weights, diff_matrices)]
    pts = _on_mesh(points, mesh, torch.float64)
    orders = tuple(int(o) for o in orders)
    return _dp_apply(lambda p: eval_ops.eval_batch(t, *grid, p, orders),
                     pts, mesh, axis_name)


def integrate_box_batch_dp(tensor, domain, bounds, mesh,
                           axis_name: str = "dp",
                           dtype=torch.float64) -> torch.Tensor:
    """Data-parallel batched box integration: each rank integrates its
    block of the (B, d, 2) boxes (validated by the caller,
    ``utils.calculus.normalize_bounds_batch``) -> (B,) on every rank.
    ``dtype=torch.float32`` selects the throughput tier."""
    from pychebyshev_tpu_torch.ops.integrate import integrate_box_batch

    t = _on_mesh(tensor, mesh)
    dom = np.asarray(domain, dtype=np.float64)
    b = _on_mesh(bounds, mesh, torch.float64)
    return _dp_apply(lambda bb: integrate_box_batch(t, dom, bb, dtype=dtype),
                     b, mesh, axis_name)


def eval_batch_dd_dp(tensor, nodes, weights, diff_matrices, points, mesh,
                     orders: Tuple[int, ...] = None,
                     axis_name: str = "dp",
                     cutoff: int = None) -> torch.Tensor:
    """Data-parallel near-f64 evaluation: ``ops.eval_dd.eval_batch_dd``
    (on a CUDA rank the f64 kernel, wherever it covers the grid) on each
    rank's block of the points.  Pointwise work, so each point's value
    is the single-device one."""
    from pychebyshev_tpu_torch.ops import eval_dd

    shape = tuple(int(x) for x in np.shape(tensor))
    if orders is None:
        orders = (0,) * len(shape)
    if not eval_dd.supports_dd(shape):
        raise ValueError(
            f"grid shape {shape} outside digit-GEMM budget; "
            f"use eval_batch_dp")
    t = _on_mesh(tensor, mesh, torch.float64)
    grid = [_tree_on_mesh(g, mesh, torch.float64)
            for g in (nodes, weights, diff_matrices)]
    pts = _on_mesh(points, mesh, torch.float64)
    orders = tuple(int(o) for o in orders)
    return _dp_apply(
        lambda p: eval_dd.eval_batch_dd(t, *grid, p, orders, cutoff),
        pts, mesh, axis_name)


def tt_integrate_box_batch_dd_dp(coeff_cores, domain, bounds, mesh,
                                 axis_name: str = "dp",
                                 cutoff: int = None,
                                 groups="auto") -> torch.Tensor:
    """Data-parallel near-f64 TT box integration (bucket masses): each
    rank integrates its block of the boxes through
    ``ops.integrate.tt_integrate_box_batch_dd`` (``groups`` as there)."""
    from pychebyshev_tpu_torch.ops import integrate as integrate_ops
    from pychebyshev_tpu_torch.ops.tt_eval import core_shapes

    integrate_ops._resolve_tt_dd_groups(core_shapes(coeff_cores), groups,
                                        cutoff)
    cores = _tree_on_mesh(coeff_cores, mesh, torch.float64)
    b = _on_mesh(bounds, mesh, torch.float64)
    return _dp_apply(
        lambda bb: integrate_ops.tt_integrate_box_batch_dd(
            cores, domain, bb, cutoff=cutoff, groups=groups),
        b, mesh, axis_name)


def slider_batch_dd_dp(slide_data, pivot_value, groups, points, mesh,
                       orders=None, axis_name: str = "dp",
                       cutoff: int = None) -> torch.Tensor:
    """Data-parallel near-f64 slider evaluation:
    ``ops.slider_eval.slider_batch_dd`` on each rank's block of the
    points (``orders`` routed as there)."""
    from pychebyshev_tpu_torch.ops import slider_eval as se

    groups = tuple(tuple(int(x) for x in g) for g in groups)
    n_dims = sum(len(g) for g in groups)
    orders = ((0,) * n_dims if orders is None
              else tuple(int(o) for o in orders))
    (plan,) = se.spec_plan(groups, (orders,))
    if plan[0] != "zero":
        active = ((plan[1],) if plan[0] == "slide"
                  else tuple(range(len(groups))))
        shapes = [tuple(int(x) for x in np.shape(slide_data[i][0]))
                  for i in active]
        if not se.slider_dd_plan(shapes, cutoff)["ok"]:
            raise ValueError(
                f"slider slide shapes {shapes} outside the digit-GEMM "
                f"budget; use eval_batch_dp per slide")
    data = _tree_on_mesh(slide_data, mesh, torch.float64)
    pts = _on_mesh(points, mesh, torch.float64)
    return _dp_apply(
        lambda p: se.slider_batch_dd(data, pivot_value, groups, p,
                                     orders=orders, cutoff=cutoff),
        pts, mesh, axis_name)


def tt_eval_batch_dd_dp(coeff_cores, domain, points, mesh,
                        axis_name: str = "dp", cutoff: int = None,
                        groups="auto") -> torch.Tensor:
    """Data-parallel near-f64 TT chain: ``ops.tt_eval_dd.tt_eval_batch_dd``
    (``groups`` as there, ``"auto"`` by default) on each rank's block of
    the points."""
    from pychebyshev_tpu_torch.ops import tt_eval_dd as tdd
    from pychebyshev_tpu_torch.ops.tt_eval import core_shapes

    shapes = core_shapes(coeff_cores)
    if not tdd.tt_dd_plan(shapes, cutoff)["ok"]:
        raise ValueError(
            f"TT core shapes {shapes} outside the digit-GEMM budget; "
            f"use tt_pipeline or eval_batch_dp")
    cores = _tree_on_mesh(coeff_cores, mesh, torch.float64)
    pts = _on_mesh(points, mesh, torch.float64)
    return _dp_apply(
        lambda p: tdd.tt_eval_batch_dd(cores, domain, p, cutoff=cutoff,
                                       groups=groups),
        pts, mesh, axis_name)


# ---------------------------------------------------------------------------
# Tensor-parallel queries
# ---------------------------------------------------------------------------


def _sharded_dim_rows(x, nodes_s, weights_s, col0: int, group):
    """Globally normalized barycentric rows of a tp-sharded dim.

    The ``w/(x - node)`` terms come from this rank's node slice; an
    ``all_reduce`` SUM assembles the global denominator.  A point within
    tolerance of a node selects the globally FIRST hit (``all_reduce``
    MIN over each rank's first local hit), exactly like the single-device
    rows (``ops.eval.barycentric_coefficients``).  Shared by
    ``eval_batch_tp`` and ``eval_batch_dd_tp``.
    """
    diff = x[:, None] - nodes_s[None, :]
    exact = diff.abs() < NODE_COINCIDENCE_TOL
    safe = torch.where(exact, torch.ones_like(diff), diff)
    w_over_diff = weights_s[None, :] / safe
    denom = _all_reduce(w_over_diff.sum(dim=1), group)
    first = torch.where(exact.any(dim=1),
                        exact.to(torch.int8).argmax(dim=1) + col0,
                        torch.full_like(x, _NO_HIT, dtype=torch.int64))
    first = _all_reduce(first, group, dist.ReduceOp.MIN)
    cols = col0 + torch.arange(nodes_s.shape[0], device=x.device)
    one_hot = (cols[None, :] == first[:, None]).to(x.dtype)
    return torch.where((first < _NO_HIT)[:, None], one_hot,
                       w_over_diff / denom[:, None])


def _tp_eval(tensor, s: int, nodes, weights, points, mesh, dp_axis: str,
             tp_axis: str, dmat=None, order_s: int = 0) -> torch.Tensor:
    """f64 contraction of ``tensor`` sharded along dim ``s`` over
    ``tp_axis``, points over ``dp_axis``.  ``dmat``/``order_s`` fold a
    derivative along the sharded dim into its rows: ``r . (D^k t) ==
    (r D^k) . t``, one ``all_reduce`` per order."""
    group = mesh.get_group(tp_axis)
    n_tp = axis_size(mesh, tp_axis)
    n_s = int(tensor.shape[s])
    pad = -n_s % n_tp
    blk = (n_s + pad) // n_tp
    col0 = mesh.get_local_rank(tp_axis) * blk
    device = tensor.device
    f64 = torch.float64
    if pad:
        pad_shape = list(tensor.shape)
        pad_shape[s] = pad
        tensor = torch.cat([tensor, tensor.new_zeros(pad_shape)], dim=s)
    slab = tensor.narrow(s, col0, blk).contiguous()
    nodes = [_on_mesh(a, mesh, f64) for a in nodes]
    weights = [_on_mesh(a, mesh, f64) for a in weights]
    nodes_s = torch.cat([nodes[s], torch.full((pad,), _SENTINEL, dtype=f64,
                                              device=device)])
    weights_s = torch.cat([weights[s], torch.zeros(pad, dtype=f64,
                                                   device=device)])
    nodes_s = nodes_s[col0:col0 + blk]
    weights_s = weights_s[col0:col0 + blk]
    if order_s:
        dm = torch.zeros((n_s + pad, n_s + pad), dtype=f64, device=device)
        dm[:n_s, :n_s] = _on_mesh(dmat, mesh, f64)
        d_rows = dm[col0:col0 + blk]

    def coeff_fn(pts):
        rows = [None if k == s else eval_ops.barycentric_coefficients(
            pts[:, k], nodes[k], weights[k]) for k in range(len(nodes))]
        c = _sharded_dim_rows(pts[:, s], nodes_s, weights_s, col0, group)
        for _ in range(order_s):
            c = _all_reduce(c @ d_rows, group)[:, col0:col0 + blk]
        rows[s] = c
        return rows

    pts = _on_mesh(points, mesh, f64)
    return _dp_apply(
        lambda p: _all_reduce(eval_ops._contract_batched(slab, coeff_fn, p),
                              group),
        pts, mesh, dp_axis)


def eval_batch_tp(tensor, nodes, weights, diff_matrices, points, mesh,
                  orders: Tuple[int, ...] = None, dp_axis: str = "dp",
                  tp_axis: str = "tp") -> torch.Tensor:
    """Tensor-parallel + data-parallel batched evaluation, in f64.

    The value tensor shards along grid axis 0 over ``tp_axis`` (for
    grids too large for one device); queries shard over ``dp_axis``.
    Derivatives on the other dims apply to each slab; derivatives along
    the sharded axis fold into the dim-0 rows (one ``all_reduce`` per
    order).  Uneven axis 0 pads with zero slabs and zero-weight sentinel
    nodes; uneven batches with the first point.
    """
    d = len(nodes)
    orders = (0,) * d if orders is None else tuple(int(o) for o in orders)
    t = _on_mesh(tensor, mesh, torch.float64)
    diffs = _tree_on_mesh(diff_matrices, mesh, torch.float64)
    if any(orders[1:]):
        t = eval_ops.apply_derivative_passes(t, diffs, (0,) + orders[1:])
    return _tp_eval(t, 0, nodes, weights, points, mesh, dp_axis, tp_axis,
                    dmat=diffs[0] if orders[0] else None, order_s=orders[0])


def dd_tp_plan(shape, n_tp: int, cutoff: int = None) -> dict:
    """The reference's plan for the tp-sharded near-f64 contraction: the
    first right-group dim ``s`` shards over ``n_tp`` devices, so the
    digit-width budget is set by the LOCAL contraction size
    ``k_local``.  Its verdict and its numbers; the digit-pair schedule
    it also carries is TPU arithmetic and is not ported."""
    from pychebyshev_tpu_torch.ops.eval import _split_index

    if cutoff is None:
        cutoff = _PAIR_CUTOFF
    shape = tuple(int(n) for n in shape)
    if len(shape) < 2:
        return {"ok": False}
    s = _split_index(shape)
    if len(shape) - s > 3:
        return {"ok": False}
    n_s_pad = -(-shape[s] // n_tp) * n_tp
    n_rest = math.prod(shape[s + 1:])
    k_local = (n_s_pad // n_tp) * n_rest
    bits_budget = 24 - int(math.ceil(math.log2(k_local)))
    b_t = min(6, bits_budget - 6)
    b_r = min(7, bits_budget - b_t)
    if b_t < 4:
        return {"ok": False}
    return {"ok": True, "s": s, "n_left": math.prod(shape[:s]),
            "n_s_pad": n_s_pad, "n_rest": n_rest, "k_local": k_local,
            "b_r": b_r, "b_t": b_t, "cutoff": int(cutoff)}


def eval_batch_dd_tp(tensor, nodes, weights, diff_matrices, points, mesh,
                     orders: Tuple[int, ...] = None, dp_axis: str = "dp",
                     tp_axis: str = "tp", cutoff: int = None) -> torch.Tensor:
    """Tensor-parallel near-f64 evaluation, for grids beyond the
    single-device dd plan (``ops.eval_dd.supports_dd``) that the tp plan
    accepts (:func:`dd_tp_plan`).

    The first right-group dim shards over ``tp_axis`` (zero-padded like
    ``eval_batch_tp``); derivative passes fold into the f64 tensor
    first; queries shard over ``dp_axis``.  Native f64 throughout.
    """
    shape = tuple(int(x) for x in np.shape(tensor))
    d = len(shape)
    orders = (0,) * d if orders is None else tuple(int(o) for o in orders)
    n_tp = axis_size(mesh, tp_axis)
    plan = dd_tp_plan(shape, n_tp, cutoff)
    if not plan["ok"]:
        raise ValueError(
            f"grid shape {shape} outside the tp digit-GEMM budget on "
            f"{n_tp} devices; use eval_batch_tp")
    t = _on_mesh(tensor, mesh, torch.float64)
    if any(orders):
        t = eval_ops.apply_derivative_passes(
            t, _tree_on_mesh(diff_matrices, mesh, torch.float64), orders)
    return _tp_eval(t, plan["s"], nodes, weights, points, mesh, dp_axis,
                    tp_axis)


def _dp_runner(run: Callable, mesh, axis: str, dim: int) -> Callable:
    """A prepare-once runner (``points -> result``, the points axis at
    ``dim``) served data-parallel: each rank runs it on its block of the
    points, every rank gets the full result.  Its operands were prepared
    on the mesh's device.  Without a mesh, ``run`` itself."""
    if mesh is None:
        return run

    def runner(points):
        return _dp_apply(run, _on_mesh(points, mesh, torch.float64), mesh,
                         axis, dim)
    return runner

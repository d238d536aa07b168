"""Serving engines for batched queries (dense, tensor-train, spline and
slider interpolants).

The port of ``pychebyshev_tpu.serving``.  An engine
snapshots an interpolant's arrays at a chosen dtype on its device, with
the derivative passes it serves applied once (in f64, then cast), and
answers any batch.

PyTorch runs eagerly, so nothing recompiles per batch size: the bucket
sizes only cap the slice a single call processes (the largest bucket),
and ``warmup()`` runs one small batch to build the kernel and pack its
operands.  Results stay on the engine's device as tensors.

On a CUDA device an f32 engine evaluates through the fused kernel
(``ops.fused_eval``) wherever ``supports_fused`` covers the grid.

``dtype="dd"`` is the near-f64 tier (``ops.eval_dd``), served in native
f64: on a CUDA device through the f64 instance of the same kernel
(``ops.fused_dd``) wherever ``supports_fused_dd`` covers the grid.  As
in the reference, a dd engine refuses grids outside ``supports_dd`` and
serves an out-of-domain call through an f64 sibling engine.

A tensor-train engine runs the chain of ``ops.tt_eval`` at f32 or f64,
and ``dtype="dd"`` through ``ops.tt_eval_dd`` (native f64, per-dim or
grouped).  A derivative spec swaps in the analytic-derivative TT
(``differentiate``), and points are permuted on the device into the
TT's storage frame.  ``MultiModelEvaluator`` serves a book of same-grid
dense or TT models from one batch, e.g. a TT risk report: price plus
Greeks as ``differentiate()``d TTs.

A spline engine routes every point to its piece in f64 on the device
(``ops.spline_eval``; an f32 engine routes its f64 input and casts after,
so a point one f32 ulp from a knot stays in its piece), then serves the
masked route (an f32 engine on flat grids of at most
``MASKED_MAX_PIECES`` pieces) or the routed one.  A derivative spec
refuses a point on a knot.  At ``dtype="dd"`` each piece is served by a
runner the engine owns (``eval_dd``: the f64 kernel for piece grids that
``supports_fused_dd`` covers); the reference's 16-piece cap, the size of
its digit-plane cache, is not ported, since the runners hold their own
operands.

A slider engine sums its slides (``ops.slider_eval``); a derivative spec
confined to one group is that slide's derivative, and one that crosses
groups is served as exact zeros without touching the device.  At
``dtype="dd"`` the whole sum is one f64 contraction, refusing the
sliders the reference's plan refuses.

``build_book`` builds a same-grid dense book from one vectorized call
over the grid (its models share one set of grid tensors),
``integrate_book`` integrates such a book over a batch of boxes in one
pass (``ops.integrate``), and ``save_book``/``load_book`` keep it as one
pickle-free ``.npz``.

``mesh=`` (a ``torch.distributed`` device mesh, ``parallel.sharding``)
serves every engine data-parallel: every rank calls the engine with the
same batch, serves its contiguous block of each slice through the same
route as a single-device engine (the kernels included) and gets the
full result by ``all_gather`` over ``data_axis``.  A dense dd engine on a
mesh with a ``"tp"`` axis serves grids beyond ``supports_dd`` that the
tensor-parallel plan accepts (``parallel.sharding.eval_batch_dd_tp``).
``build_book(mesh=)`` shards the grid rows of its one oracle call.

Example
-------
>>> engine = BatchedEvaluator(cheb, dtype=torch.float32, device="cuda")
>>> engine.warmup()
>>> values = engine(points)          # any N
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pychebyshev_tpu_torch.config import NODE_COINCIDENCE_TOL
from pychebyshev_tpu_torch.ops import eval as eval_ops
from pychebyshev_tpu_torch.ops import (
    eval_dd,
    fused_eval,
    slider_eval,
    spline_eval,
    tt_eval,
    tt_eval_dd,
)
from pychebyshev_tpu_torch.parallel import sharding

__all__ = ["BatchedEvaluator", "MultiSpecEvaluator", "MultiModelEvaluator",
           "build_book", "integrate_book", "save_book", "load_book"]

_DEFAULT_BUCKETS = (1 << 10, 1 << 14, 1 << 17, 1 << 20)


def _check_dtype(engine: str, dtype) -> None:
    if isinstance(dtype, str) and dtype != "dd":
        raise ValueError(
            f"{engine}: dtype={dtype!r} is not a tier of this engine; use "
            f"torch.float32, torch.float64 or 'dd'")
    if dtype not in ("dd", torch.float32, torch.float64):
        raise ValueError(f"{engine}: dtype must be torch.float32, "
                         f"torch.float64 or 'dd', got {dtype}")


def _family(interpolant) -> str:
    """"dense", "tt", "spline", "slider", or "" for anything else."""
    from pychebyshev_tpu_torch.models.approximation import (
        ChebyshevApproximation,
    )
    from pychebyshev_tpu_torch.models.slider import ChebyshevSlider
    from pychebyshev_tpu_torch.models.spline import ChebyshevSpline
    from pychebyshev_tpu_torch.models.tensor_train import ChebyshevTT
    for cls, name in ((ChebyshevApproximation, "dense"),
                      (ChebyshevTT, "tt"), (ChebyshevSpline, "spline"),
                      (ChebyshevSlider, "slider")):
        if isinstance(interpolant, cls):
            return name
    return ""


def _check_dd_shape(shape) -> None:
    if not eval_dd.supports_dd(shape):
        raise ValueError(
            f"grid shape {shape} is outside the digit-GEMM plan budget; "
            f"serve at dtype=torch.float64 instead")


def _dd_tp_route(shape, mesh, dense: bool) -> bool:
    """Whether a ``BatchedEvaluator`` at ``dtype="dd"`` serves this grid
    tensor-parallel: grids ``supports_dd`` accepts are served on each
    rank (False); beyond it only a dense engine on a mesh with a
    ``"tp"`` axis whose plan (``dd_tp_plan``) accepts the grid (True).
    The other cases raise the reference's three refusals."""
    if eval_dd.supports_dd(shape):
        return False
    has_tp = mesh is not None and sharding.has_axis(mesh, "tp")
    if has_tp and not dense:
        raise ValueError(
            f"grid shape {shape} is outside the digit-GEMM plan budget, "
            f"and the tensor-parallel dd route serves dense "
            f"ChebyshevApproximation engines only; serve at "
            f"dtype=torch.float64 instead")
    if has_tp:
        n_tp = sharding.axis_size(mesh, "tp")
        if sharding.dd_tp_plan(shape, n_tp)["ok"]:
            return True
        raise ValueError(
            f"grid shape {shape} is outside the digit-GEMM plan budget "
            f"even tensor-parallel over tp={n_tp} (the sharded plan "
            f"refuses this shape); serve at dtype=torch.float64 instead")
    raise ValueError(
        f"grid shape {shape} is outside the digit-GEMM plan budget; serve "
        f"at dtype=torch.float64, or (dense engines) pass a mesh with a "
        f"'tp' axis — tensor-parallel digit-GEMM raises the per-device "
        f"budget")


def _dense_snapshot(interpolant, engine: str, dtype, device):
    """(nodes, weights, diffs) of a built dense interpolant at ``dtype``
    (f64 for ``"dd"``) on ``device``, or an error naming what is not
    served."""
    _check_dtype(engine, dtype)
    if _family(interpolant) != "dense":
        raise TypeError(
            f"{engine} serves ChebyshevApproximation, ChebyshevSpline, "
            f"ChebyshevSlider and ChebyshevTT objects; "
            f"{type(interpolant).__name__} serving is not ported yet "
            f"(see ROADMAP.md)")
    if interpolant.tensor_values is None:
        raise RuntimeError("interpolant is not built")
    if dtype == "dd":
        dtype = torch.float64
    nodes, weights, diffs = interpolant._grid_tuples()
    return tuple(tuple(a.to(device=device, dtype=dtype) for a in grp)
                 for grp in (nodes, weights, diffs))


def _tt_core_shapes(interpolant):
    return [tuple(int(x) for x in c.shape) for c in interpolant._coeff_cores]


def _check_tt_dd(interpolant, prefix: str = "") -> None:
    """A dd engine refuses core chains outside the reference's plan."""
    shapes = _tt_core_shapes(interpolant)
    if not tt_eval_dd.tt_supports_dd(shapes):
        raise ValueError(
            f"{prefix}TT core shapes {shapes} are outside the digit-GEMM "
            f"plan budget; serve at dtype=torch.float64 instead")


def _spec_tensor(interpolant, orders, dtype, device):
    """The value tensor with ``orders`` applied in f64, then cast."""
    tensor = interpolant.tensor_values.to(device)
    diffs = [m.to(device) for m in interpolant.diff_matrices]
    return eval_ops.apply_derivative_passes(tensor, diffs, orders).to(
        dtype=dtype, copy=True).contiguous()


def _grid_snapshot(piece, dtype, device):
    """(nodes, weights, diffs) of one spline piece or slider slide at
    ``dtype`` on ``device``: the engine's own copies."""
    return tuple(tuple(a.to(device=device, dtype=dtype, copy=True)
                       for a in grp) for grp in piece._grid_tuples())


def _piece_snapshot(piece, orders, dtype, device):
    """(tensor with ``orders`` applied, nodes, weights, diffs) of one
    spline piece or slider slide at ``dtype`` on ``device``."""
    return ((_spec_tensor(piece, orders, dtype, device),)
            + _grid_snapshot(piece, dtype, device))


def _check_spline_dd(spline, engine: str, mesh) -> None:
    """A dd spline engine serves one piece grid inside the dd plan (the
    reference's rule, with its single-spec engine's refusals)."""
    shapes = {tuple(p.tensor_values.shape) for p in spline._pieces}
    if len(shapes) != 1:
        raise ValueError(
            f"{engine}: dtype='dd' spline serving requires flat n_nodes "
            f"(all pieces on one grid shape)")
    shape = next(iter(shapes))
    if engine == "BatchedEvaluator":
        _dd_tp_route(shape, mesh, dense=False)
    else:
        _check_dd_shape(shape)


def _check_slider_dd(slider) -> None:
    shapes = [tuple(s.tensor_values.shape) for s in slider.slides]
    if not slider_eval.slider_dd_plan(shapes)["ok"]:
        raise ValueError(
            f"slider slide shapes {shapes} are outside the digit-GEMM plan "
            f"budget; serve at dtype=torch.float64 instead")


def _check_built(interpolant, family: str) -> None:
    if family == "tt":
        interpolant._check_built()
    elif family in ("spline", "slider") and not interpolant._built:
        raise RuntimeError("interpolant is not built")


def _knot_guard(spline, dims, device):
    """(dim, knots) pairs a derivative spec must keep points off."""
    return tuple((d, torch.tensor(spline.knots[d], dtype=torch.float64,
                                  device=device))
                 for d in sorted(dims) if spline.knots[d])


def _validated_orders(orders, num_dimensions):
    orders = tuple(int(o) for o in (orders or [0] * num_dimensions))
    if len(orders) != num_dimensions:
        raise ValueError(
            f"derivative_order length {len(orders)} does not match "
            f"num_dimensions {num_dimensions}")
    return orders


class _SplineSpecs:
    """A spline's derivative specs prepared for one tier on one device:
    ``points`` (f64, user frame) -> (M, N).

    Points route in f64 first (``ops.spline_eval``), then each spec's
    pre-differentiated pieces (passes applied once in f64, then cast)
    serve them: on the masked route at f32 when the piece grids are
    homogeneous and no more than ``MASKED_MAX_PIECES``, else each
    occupied piece on its own points.  At ``dd`` every piece has a runner
    of ``ops.eval_dd`` that holds its operands (on a CUDA device the f64
    kernel for piece grids ``supports_fused_dd`` covers)."""

    def __init__(self, spline, specs, dtype, dd: bool, device):
        self.dtype = torch.float64 if dd else dtype
        self._knots = [list(k) for k in spline.knots]
        self._strides = spline_eval.piece_strides(
            [len(k) for k in self._knots])
        self._m = len(specs)
        self.guard = _knot_guard(
            spline, {d for s in specs for d, o in enumerate(s) if o > 0},
            device)
        pieces = spline._pieces
        self._runners = self._stacks = self._pieces = None
        if dd:
            self._runners = [
                eval_dd.dd_multi_runner(t, n, w, df, specs)
                for t, n, w, df in (
                    _piece_snapshot(p, (0,) * spline.num_dimensions,
                                    torch.float64, device) for p in pieces)]
            return
        if (dtype == torch.float32 and spline._pieces_stackable()
                and len(pieces) <= spline_eval.MASKED_MAX_PIECES):
            tensors, nodes, weights, diffs = spline_eval.stack_pieces(pieces)
            self._stacks = tuple(
                spline_eval.stacked_derivative_passes(tensors, diffs, s).to(
                    device=device, dtype=dtype) for s in specs)
            self._grid = tuple(tuple(a.to(device=device, dtype=dtype)
                                     for a in grp)
                               for grp in (nodes, weights))
            return
        self._pieces = [
            (tuple(_spec_tensor(p, s, dtype, device) for s in specs),)
            + _grid_snapshot(p, dtype, device)[:2] for p in pieces]

    @property
    def masked(self) -> bool:
        return self._stacks is not None

    def __call__(self, points: torch.Tensor) -> torch.Tensor:
        flat = spline_eval.route_piece_indices(self._knots, self._strides,
                                               points)
        if self._runners is not None:
            return spline_eval.routed_apply(
                flat, points, lambda i, p: self._runners[i](p),
                n_cols=self._m).T
        if self._stacks is not None:
            return spline_eval.masked_eval_prepared(
                self._stacks, *self._grid, flat, points)
        return spline_eval.routed_apply(flat, points, self._piece,
                                        n_cols=self._m, dtype=self.dtype).T

    def _piece(self, i: int, points: torch.Tensor) -> torch.Tensor:
        """(n, M): piece ``i``'s specs on its own points."""
        tensors, nodes, weights = self._pieces[i]
        return eval_ops.eval_batch_models(
            tensors, nodes, weights, (), points.to(self.dtype),
            (0,) * len(nodes)).T


class _SliderSpecs:
    """A slider's derivative specs prepared for one tier on one device:
    ``points`` -> (M, N) through ``slider_eval.slider_multi_batch``: the
    value sum runs at most once a call, a spec inside one group runs its
    owning slide (passes applied once in f64, then cast), a spec across
    groups is exact zeros.  At ``dd`` all of it is one f64 contraction
    (``slider_eval.slider_dd_multi_runner``)."""

    guard = ()

    def __init__(self, slider, specs, dtype, dd: bool, device):
        self.dtype = torch.float64 if dd else dtype
        self._groups = tuple(tuple(int(d) for d in g)
                             for g in slider.partition)
        self._slides = tuple(
            _piece_snapshot(s, (0,) * len(g), self.dtype, device)
            for s, g in zip(slider.slides, self._groups))
        self._dd_runner = None
        if dd:
            self._dd_runner = slider_eval.slider_dd_multi_runner(
                self._slides, slider.pivot_value, self._groups, specs)
            return
        self._pivot = torch.tensor(float(slider.pivot_value), dtype=dtype,
                                   device=device)
        self._plan = tuple(slider._multi_spec_plans(specs))
        self._derived = tuple(
            _piece_snapshot(slider.slides[p[1]], p[2], dtype, device)
            if p[0] == "slide" else None for p in self._plan)

    def __call__(self, points: torch.Tensor) -> torch.Tensor:
        if self._dd_runner is not None:
            return self._dd_runner(points).T
        return slider_eval.slider_multi_batch(
            self._slides, self._pivot, self._groups, self._plan, points,
            derived=self._derived)


class _Engine:
    """Points intake, the slice loop, the TT storage frame and the dd
    tier's out-of-domain route, shared by the engines."""

    # dim_order of a TT engine whose storage frame is not the user's;
    # None for dense engines and canonical TTs.
    _perm = None
    # Spline engines take points in f64 and route them before the cast.
    _route_f64 = False
    # (dim, knots) pairs that a spline engine's derivative specs guard.
    _guard = ()
    # The device mesh the engine serves over, and its data axis.
    _mesh = None
    _data_axis = "dp"
    # A dense dd engine served tensor-parallel (eval_batch_dd_tp shards
    # the points itself).
    _dd_tp = False

    def _init_device(self, device, bucket_sizes, mesh, data_axis) -> None:
        """The engine's device and buckets; under a mesh, the device is
        the mesh's on this rank (``device=`` must name it) and every
        bucket must shard evenly over ``data_axis`` (the reference's
        rule)."""
        self.bucket_sizes = tuple(sorted(int(b) for b in bucket_sizes))
        self.device = torch.device(device)
        if mesh is None:
            return
        self.device = sharding.check_device(mesh, device,
                                            type(self).__name__)
        axis_size = sharding.axis_size(mesh, data_axis)
        for b in self.bucket_sizes:
            if b % axis_size != 0:
                raise ValueError(
                    f"bucket size {b} is not divisible by mesh axis "
                    f"{data_axis!r} (size {axis_size}); pick bucket "
                    f"sizes that shard evenly")
        self._mesh, self._data_axis = mesh, data_axis

    def _intake(self, points) -> torch.Tensor:
        # dtype= converts host input straight to the engine's dtype (f64
        # for a spline engine): a list of Python floats must not pass
        # through float32.
        dtype = torch.float64 if self._route_f64 else self.dtype
        pts = torch.as_tensor(points, dtype=dtype, device=self.device)
        if pts.dim() != 2 or pts.shape[1] != self.num_dimensions:
            raise ValueError(
                f"points must have shape (N, {self.num_dimensions}); "
                f"got {tuple(pts.shape)}")
        self._check_knots(pts)
        return pts

    def _check_knots(self, points: torch.Tensor) -> None:
        """A derivative is not defined on a knot: refuse the batch (one
        device-to-host read per guarded dim)."""
        for d, knots in self._guard:
            hit = (points[:, d, None].to(torch.float64)
                   - knots[None, :]).abs() < NODE_COINCIDENCE_TOL
            if bool(hit.any().item()):
                i, k = torch.nonzero(hit)[0].tolist()
                raise ValueError(
                    f"Derivative w.r.t. dimension {d} is not defined at "
                    f"knot x[{d}]={float(knots[k])} (point {i}). The left "
                    f"and right derivatives may differ at this point.")

    def _init_dd(self, interpolant, dtype, sibling):
        """Set the engine's tier.  A dd engine computes in f64 and keeps
        ``sibling`` (an f64 engine's constructor) for out-of-domain
        calls: the reference's dd contract holds in the domain only, so
        such a call is served at f64, reference extrapolation included.
        ``interpolant.domain`` is in the frame ``_run`` works in (a TT's
        storage frame)."""
        self._dd = dtype == "dd"
        self.dtype = torch.float64 if self._dd else dtype
        if self._dd:
            self._dd_domain = torch.tensor(
                interpolant.domain, dtype=torch.float64, device=self.device)
            self._dd_fallback = None
            self._dd_fallback_ctor = sibling

    def _init_family(self, interpolant, specs, dtype, sibling) -> None:
        """Prepare a spline or slider engine for ``specs`` (validated)."""
        if dtype == "dd":
            if self._kind == "spline":
                _check_spline_dd(interpolant, type(self).__name__,
                                 self._mesh)
            else:
                _check_slider_dd(interpolant)
        self._init_dd(interpolant, dtype, sibling)
        self._domain = [tuple(b) for b in interpolant.domain]
        runner = _SplineSpecs if self._kind == "spline" else _SliderSpecs
        self._specs_run = runner(interpolant, specs, self.dtype, self._dd,
                                 self.device)
        self._route_f64 = self._kind == "spline"
        self._guard = self._specs_run.guard

    def _init_frame(self, dim_order) -> None:
        """Remember a TT's storage permutation, if it is one."""
        dim_order = [int(k) for k in dim_order]
        if dim_order != list(range(len(dim_order))):
            self._perm = dim_order

    def _storage(self, points: torch.Tensor) -> torch.Tensor:
        """User-frame points permuted (on the device) into the frame
        ``_run`` works in."""
        return points if self._perm is None else points[:, self._perm]

    def _serve(self, points) -> torch.Tensor:
        """Intake, frame, the dd out-of-domain route, slices.  The f64
        sibling permutes for itself, so it gets the user-frame points."""
        points = self._intake(points)
        framed = self._storage(points)
        sibling = self._dd_sibling(framed)
        if sibling is not None:
            return sibling(points)
        return self._sliced(framed)

    def _dd_sibling(self, points: torch.Tensor):
        """The f64 sibling engine when a dd engine gets a batch with a
        point outside the domain (one device-to-host read), else None.
        ``points`` are in the domain's frame."""
        if not self._dd:
            return None
        dom = self._dd_domain
        if not bool(((points < dom[:, 0]) | (points > dom[:, 1]))
                    .any().item()):
            return None
        if self._dd_fallback is None:
            self._dd_fallback = self._dd_fallback_ctor()
        return self._dd_fallback

    def _sliced(self, points: torch.Tensor) -> torch.Tensor:
        """Run ``_run`` over slices of at most the largest bucket and
        join the results along the points axis (the last one).  Under a
        mesh each slice is served data-parallel."""
        run = self._run
        if self._mesh is not None and not self._dd_tp:
            def run(p):
                return sharding._dp_apply(self._run, p, self._mesh,
                                          self._data_axis)
        step = self.bucket_sizes[-1]
        outs = [run(points[i:i + step])
                for i in range(0, points.shape[0], step)]
        if not outs:
            return run(points)
        return torch.cat(outs, dim=-1)

    def warmup(self) -> None:
        """Run one smallest-bucket batch at the domain centre: builds the
        kernel and packs its operands before the first request."""
        centre = torch.tensor(
            [0.5 * (lo + hi) for lo, hi in self._domain],
            dtype=torch.float64 if self._route_f64 else self.dtype,
            device=self.device)
        self._run(centre.expand(self.bucket_sizes[0], -1).contiguous())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class BatchedEvaluator(_Engine):
    """Batched evaluation of a dense, tensor-train, spline or slider
    interpolant at one derivative spec.

    Parameters
    ----------
    interpolant : a built ``ChebyshevApproximation``, ``ChebyshevTT``,
        ``ChebyshevSpline`` or ``ChebyshevSlider``.
    dtype : torch.float32 (throughput), torch.float64 (parity) or "dd"
        (the near-f64 tier, f64 results).
    derivative_order : fixed per-dim derivative spec; None = values.  A
        TT engine serves it from the analytic-derivative TT
        (``differentiate``).
    bucket_sizes : ascending sizes; the largest caps one call's slice.
    use_fused : dense engines only.  ``None`` = the fused kernel for f32
        CUDA engines whose grid ``supports_fused`` covers; ``True``
        forces it (raising outside the envelope), ``False`` the plain
        path.  A dd engine picks its route itself (``ops.eval_dd``) and
        refuses ``True``, as TT, spline and slider engines do (the JAX
        package has no fused kernel for those families).  Under a mesh
        each rank runs the same route on its block; the reference's
        refusal of ``use_fused`` with ``mesh`` (its kernel was
        single-device) does not apply.
    mesh, data_axis : serve data-parallel over the mesh's ``data_axis``
        (see the module note); every bucket size must divide by its size.
    device : the engine's device (required; under a mesh, the mesh's).
    """

    def __init__(self, interpolant, dtype=torch.float32,
                 derivative_order: Optional[Sequence[int]] = None,
                 bucket_sizes: Tuple[int, ...] = _DEFAULT_BUCKETS,
                 use_fused: bool = None, mesh=None, data_axis: str = "dp",
                 *, device):
        self._init_device(device, bucket_sizes, mesh, data_axis)

        def sibling():
            return BatchedEvaluator(
                interpolant, dtype=torch.float64,
                derivative_order=derivative_order,
                bucket_sizes=bucket_sizes, mesh=mesh, data_axis=data_axis,
                device=device)

        self._kind = _family(interpolant)
        self._tt = self._kind == "tt"
        if self._kind in ("tt", "spline", "slider"):
            _check_dtype("BatchedEvaluator", dtype)
            _check_built(interpolant, self._kind)
            if use_fused:
                raise ValueError(
                    f"use_fused serves dense interpolants; the "
                    f"{type(interpolant).__name__} has no fused kernel")
            if self._tt:
                self._init_tt(interpolant, dtype, derivative_order, sibling)
                return
            self._use_fused = False
            self.num_dimensions = interpolant.num_dimensions
            self._init_family(interpolant, [_validated_orders(
                derivative_order, self.num_dimensions)], dtype, sibling)
            return
        grid = _dense_snapshot(interpolant, "BatchedEvaluator", dtype,
                               self.device)
        self._dd_tp = dtype == "dd" and _dd_tp_route(
            tuple(interpolant.tensor_values.shape), mesh, dense=True)
        self._init_dd(interpolant, dtype, sibling)
        self._nodes, self._weights, self._diffs = grid
        self.num_dimensions = interpolant.num_dimensions
        self._domain = [tuple(b) for b in interpolant.domain]
        orders = _validated_orders(derivative_order, self.num_dimensions)
        self._tensor = _spec_tensor(interpolant, orders, self.dtype,
                                    self.device)
        self._orders = (0,) * self.num_dimensions
        if self._dd:
            if use_fused:
                raise ValueError("dtype='dd' picks its own route; it does "
                                 "not compose with use_fused")
            if not self._dd_tp:
                self._dd_runner = eval_dd.dd_models_runner(
                    (self._tensor,), self._nodes, self._weights,
                    self._diffs, self._orders)
            use_fused = False
        elif use_fused is None:
            use_fused = (dtype == torch.float32
                         and self.device.type == "cuda"
                         and fused_eval.supports_fused(
                             tuple(self._tensor.shape), dtype))
        elif use_fused and dtype != torch.float32:
            raise ValueError("use_fused needs dtype=torch.float32")
        self._use_fused = bool(use_fused)

    def _init_tt(self, interpolant, dtype, derivative_order,
                 sibling) -> None:
        if dtype == "dd":
            _check_tt_dd(interpolant)
        self._init_dd(interpolant, dtype, sibling)
        self._use_fused = False
        self.num_dimensions = interpolant.num_dimensions
        orders = _validated_orders(derivative_order, self.num_dimensions)
        if any(o != 0 for o in orders):
            # The analytic-derivative TT evaluates like any other TT.
            interpolant = interpolant.differentiate(list(orders))
        # The engine's own device copies: nothing else holds them, so
        # nothing edits them in place.
        self._cores = tuple(
            torch.tensor(c, dtype=self.dtype, device=self.device)
            for c in interpolant._coeff_cores)
        self._tt_domain = np.asarray(interpolant.domain, dtype=np.float64)
        self._domain = [tuple(b) for b in interpolant.domain]  # storage
        self._init_frame(interpolant._dim_order)

    def _run(self, points: torch.Tensor) -> torch.Tensor:
        if self._kind in ("spline", "slider"):
            return self._specs_run(points)[0]
        if self._tt:
            if self._dd:
                return tt_eval_dd.tt_eval_batch_dd(
                    self._cores, self._tt_domain, points, groups="auto")
            return tt_eval.tt_eval_batch(self._cores, self._tt_domain,
                                         points)
        if self._dd_tp:
            return sharding.eval_batch_dd_tp(
                self._tensor, self._nodes, self._weights, self._diffs,
                points, self._mesh, self._orders, dp_axis=self._data_axis)
        if self._dd:
            return self._dd_runner(points)[0]
        if self._use_fused:
            return fused_eval.fused_eval_batch(
                self._tensor, self._nodes, self._weights, self._diffs,
                points, self._orders)
        return eval_ops.eval_batch(self._tensor, self._nodes, self._weights,
                                   self._diffs, points, self._orders)

    def __call__(self, points) -> torch.Tensor:
        """Evaluate at (N, d) points -> (N,) tensor on the engine device."""
        return self._serve(points)


class MultiSpecEvaluator(_Engine):
    """One dense, spline or slider interpolant, many derivative specs per
    call.

    ``engine(points)`` returns an (N, M) tensor, e.g. price plus five
    Greeks.

    - Dense: every spec's derivative passes are applied once at
      construction (in f64, then cast); each call builds the per-point
      rows once per slice and contracts them against all M tensors
      (``ops.eval.eval_batch_models``).
    - Spline: routed in f64 on the device, then every piece x every
      spec on the masked route at f32 (flat, homogeneous piece grids of
      at most ``MASKED_MAX_PIECES`` pieces), else each occupied piece's
      specs on its own points (the routed route; the reference refuses
      the splines past its caps here).  A
      derivative spec refuses a point on a knot.
    - Slider: the additive value sum at most once per slice plus one
      owning-slide evaluation per derivative spec; a spec that crosses
      groups is exact zeros.

    ``dtype="dd"`` serves the report at near-f64 in native f64: dense
    through ``ops.eval_dd.dd_multi_runner`` (on a CUDA device one f64
    kernel launch per spec per slice, each against its
    pre-differentiated tensor), a flat spline through one such runner
    per piece (the points grouped by piece on the device), a slider
    through one f64 contraction (``slider_eval.slider_dd_multi_runner``).

    ``mesh``/``data_axis`` serve the report data-parallel, as in
    :class:`BatchedEvaluator`.
    """

    def __init__(self, interpolant, specs, dtype=torch.float32,
                 bucket_sizes: Tuple[int, ...] = _DEFAULT_BUCKETS,
                 mesh=None, data_axis: str = "dp", *, device):
        self._init_device(device, bucket_sizes, mesh, data_axis)
        self._kind = _family(interpolant)
        if self._kind == "tt":
            raise TypeError(
                "MultiSpecEvaluator serves ChebyshevApproximation, "
                "ChebyshevSpline and ChebyshevSlider objects (TT models: "
                "differentiate() per spec + MultiModelEvaluator)")
        sibling = (lambda: MultiSpecEvaluator(
            interpolant, specs, dtype=torch.float64,
            bucket_sizes=bucket_sizes, mesh=mesh, data_axis=data_axis,
            device=device))
        if self._kind in ("spline", "slider"):
            _check_dtype("MultiSpecEvaluator", dtype)
            _check_built(interpolant, self._kind)
            self.num_dimensions = interpolant.num_dimensions
            self.specs = self._validated_specs(specs)
            self._init_family(interpolant, self.specs, dtype, sibling)
            return
        grid = _dense_snapshot(interpolant, "MultiSpecEvaluator", dtype,
                               self.device)
        if dtype == "dd":
            _check_dd_shape(tuple(interpolant.tensor_values.shape))
        self._init_dd(interpolant, dtype, sibling)
        self._nodes, self._weights, self._diffs = grid
        self.num_dimensions = interpolant.num_dimensions
        self._domain = [tuple(b) for b in interpolant.domain]
        self.specs = self._validated_specs(specs)
        if self._dd:
            self._dd_runner = eval_dd.dd_multi_runner(
                interpolant.tensor_values.to(self.device), self._nodes,
                self._weights, self._diffs, self.specs)
        else:
            self._spec_tensors = tuple(
                _spec_tensor(interpolant, s, self.dtype, self.device)
                for s in self.specs)

    def _validated_specs(self, specs):
        specs = tuple(_validated_orders(s, self.num_dimensions)
                      for s in specs)
        if not specs:
            raise ValueError("MultiSpecEvaluator needs at least one spec")
        return specs

    def _run(self, points: torch.Tensor) -> torch.Tensor:
        if self._kind in ("spline", "slider"):
            return self._specs_run(points)
        if self._dd:
            return self._dd_runner(points).T    # (N, M) -> (M, N)
        return eval_ops.eval_batch_models(
            self._spec_tensors, self._nodes, self._weights, self._diffs,
            points, (0,) * self.num_dimensions)

    def __call__(self, points) -> torch.Tensor:
        """(N, d) points -> (N, len(specs)) tensor on the engine device."""
        points = self._intake(points)
        sibling = self._dd_sibling(points)
        if sibling is not None:
            return sibling(points)
        return self._sliced(points).T


class MultiModelEvaluator(_Engine):
    """One query batch against a *book* of same-grid interpolants.

    M dense interpolants sharing one grid (identical ``domain`` and
    ``n_nodes``) evaluate at N points for the cost of one barycentric
    row build plus M GEMMs per slice (``ops.eval.eval_batch_models``);
    the per-point row work amortizes across the whole book.

    TT books stack rank-padded cores and run one batched chain over the
    model axis (``ops.tt_eval.tt_eval_batch_models``); a derivative spec
    swaps in each model's analytic-derivative TT.  Every model pays the
    book-wide max-rank chain cost, so split a book with one high-rank
    outlier into rank-homogeneous sub-books.  Zero-padded bonds add
    exact zeros: a model's values are the same in any book.

    ``dtype="dd"`` serves the book at near-f64 (native f64): dense books
    through ``ops.eval_dd.dd_models_runner``, TT books through
    ``ops.tt_eval_dd.tt_dd_book_runner``; both hold every model's
    prepared operands, so a dd book has no size limit here.  Out-of-
    domain calls go to an f64 sibling book.

    One fixed derivative spec, hoisted per model at construction.
    ``mesh``/``data_axis`` serve the book data-parallel, as in
    :class:`BatchedEvaluator`.

    Example
    -------
    >>> book = MultiModelEvaluator(models, dtype=torch.float32,
    ...                            device="cuda")
    >>> book.warmup()
    >>> values = book(points)        # (M, N)
    """

    def __init__(self, interpolants, dtype=torch.float32,
                 derivative_order: Optional[Sequence[int]] = None,
                 bucket_sizes: Tuple[int, ...] = _DEFAULT_BUCKETS,
                 mesh=None, data_axis: str = "dp", *, device):
        from pychebyshev_tpu_torch.models.approximation import (
            ChebyshevApproximation,
        )
        from pychebyshev_tpu_torch.models.tensor_train import ChebyshevTT

        self._init_device(device, bucket_sizes, mesh, data_axis)
        interpolants = list(interpolants)
        if not interpolants:
            raise ValueError("interpolants must be a non-empty sequence")
        kinds = {type(m) for m in interpolants}
        if len(kinds) > 1 or kinds - {ChebyshevApproximation, ChebyshevTT}:
            raise TypeError(
                f"MultiModelEvaluator supports a homogeneous book of "
                f"ChebyshevApproximation or ChebyshevTT models, got "
                f"{sorted(t.__name__ for t in kinds)}"
            )
        _check_dtype("MultiModelEvaluator", dtype)
        first = interpolants[0]
        self._tt = isinstance(first, ChebyshevTT)
        for i, m in enumerate(interpolants):
            if self._tt:
                m._check_built()
                if dtype == "dd":
                    _check_tt_dd(m, prefix=f"interpolants[{i}] ")
            elif m.tensor_values is None:
                raise RuntimeError("all interpolants must be built")
        if dtype == "dd" and not self._tt:
            shape = tuple(first.tensor_values.shape)
            if not eval_dd.supports_dd(shape):
                raise ValueError(
                    f"grid shape {shape} is outside the digit-GEMM plan "
                    f"budget")
        for i, m in enumerate(interpolants[1:], start=1):
            if (list(m.n_nodes) != list(first.n_nodes)
                    or [list(b) for b in m.domain]
                    != [list(b) for b in first.domain]):
                raise ValueError(
                    f"interpolants[{i}] grid (n_nodes/domain) differs "
                    f"from interpolants[0]; multi-model evaluation "
                    f"requires one shared grid"
                )
        book = list(interpolants)
        self._init_dd(first, dtype, lambda: MultiModelEvaluator(
            book, dtype=torch.float64, derivative_order=derivative_order,
            bucket_sizes=bucket_sizes, mesh=mesh, data_axis=data_axis,
            device=device))
        self.num_dimensions = first.num_dimensions
        self.num_models = len(interpolants)
        self._domain = [tuple(b) for b in first.domain]
        orders = _validated_orders(derivative_order, self.num_dimensions)
        if self._tt:
            self._init_tt_book(interpolants, orders)
        else:
            self._init_dense_book(interpolants, orders)

    def _init_tt_book(self, interpolants, orders) -> None:
        first = interpolants[0]
        if any(list(m._dim_order) != list(first._dim_order)
               for m in interpolants):
            raise ValueError(
                "all TT models must share one dim_order; reorder() "
                "them to a common storage frame first"
            )
        if any(o != 0 for o in orders):
            # Analytic derivative TTs evaluate like any other TT.
            interpolants = [m.differentiate(list(orders))
                            for m in interpolants]
        self._tt_domain = np.asarray(first.domain, dtype=np.float64)
        self._init_frame(first._dim_order)
        if self._dd:
            self._dd_book_runner = tt_eval_dd.tt_dd_book_runner(
                tuple(tuple(torch.tensor(c, dtype=torch.float64,
                                         device=self.device)
                            for c in m._coeff_cores)
                      for m in interpolants),
                self._tt_domain)
            return
        # Zero-pad every bond to the book-wide max rank and stack: one
        # (M, r, n, r) tensor per dim, batched through the chain.
        self._tt_cores = tt_eval.stack_rank_padded(
            [m._coeff_cores for m in interpolants], self.dtype, self.device)

    def _init_dense_book(self, interpolants, orders) -> None:
        first = interpolants[0]
        nodes, weights, diffs = first._grid_tuples()
        self._nodes, self._weights, self._diffs = (
            tuple(a.to(device=self.device, dtype=self.dtype) for a in grp)
            for grp in (nodes, weights, diffs))
        if self._dd:
            # Every model's operands (derivative passes folded) are
            # prepared now and held by the runner.
            self._dd_book_runner = eval_dd.dd_models_runner(
                tuple(m.tensor_values.to(self.device)
                      for m in interpolants),
                self._nodes, self._weights, self._diffs, orders)
        else:
            self._tensors = tuple(
                _spec_tensor(m, orders, self.dtype, self.device)
                for m in interpolants)

    def _run(self, points: torch.Tensor) -> torch.Tensor:
        if self._dd:
            return self._dd_book_runner(points)
        if self._tt:
            return tt_eval.tt_eval_batch_models(self._tt_cores,
                                                self._tt_domain, points)
        return eval_ops.eval_batch_models(
            self._tensors, self._nodes, self._weights, self._diffs, points,
            (0,) * self.num_dimensions)

    def __call__(self, points) -> torch.Tensor:
        """Evaluate every model at (N, d) points -> (M, N) tensor on the
        engine device."""
        return self._serve(points)


def build_book(function, num_dimensions, domain, n_nodes, *,
               additional_data=None, num_models=None,
               max_derivative_order: int = 2, verbose: bool = False,
               mesh=None, data_axis: str = "dp", device):
    """Build M same-grid dense interpolants from ONE vectorized call.

    The build-side counterpart of :class:`MultiModelEvaluator`: a book
    of M products priced over one shared grid evaluates every (grid
    point, model) pair in a single batched call to *function*, instead
    of M sequential ``build()`` loops.

    Parameters
    ----------
    function : callable ``f(points, additional_data) -> (G, M)``,
        vectorized over both grid points and models: ``points`` is the
        full ``(G, num_dimensions)`` Chebyshev grid in C order (host
        NumPy) and the return carries one column per model.  A NumPy
        result is built on the host and moved to ``device``; a torch
        tensor goes to ``device`` without passing through the host.
    num_dimensions, domain, n_nodes : as in
        :class:`~pychebyshev_tpu_torch.ChebyshevApproximation`;
        ``n_nodes`` must be explicit positive ints.
    num_models : optional expected M; validates the output width.
    max_derivative_order : forwarded to every model.
    mesh : optional device mesh (``parallel.sharding``): the grid rows
        shard over ``data_axis`` and each rank calls *function* once on
        its block, as an (n, num_dimensions) f64 tensor on the mesh's
        device (a function that does not answer with a tensor is
        refused); uneven grids pad with the first grid point.  The
        gathered book is on every rank.
    device : where the models live (under a mesh, the mesh's device).

    Returns
    -------
    list[ChebyshevApproximation] -- M fully-built models SHARING one set
    of node/weight/differentiation tensors.  Each model reports the
    book's wall time as its ``build_time`` and the shared grid size G as
    ``n_evaluations``.
    """
    import time as _time

    from pychebyshev_tpu_torch.models.approximation import (
        ChebyshevApproximation,
        _unwrap_typed,
    )

    domain, n_nodes, _ = _unwrap_typed(domain, n_nodes, None)
    if n_nodes is None or any(
        not isinstance(n, (int, np.integer)) or n <= 0
        for n in list(n_nodes)
    ):
        raise ValueError(
            "build_book requires explicit positive int n_nodes; "
            "error-threshold auto-N calibrates one model's error and "
            "does not extend to a shared book grid"
        )
    if num_models is not None and int(num_models) < 1:
        raise ValueError(f"num_models must be >= 1, got {num_models}")

    start = _time.time()
    # The template owns the grid tensors every model shares (and runs
    # the full ctor validation on domain / n_nodes).
    template = ChebyshevApproximation(
        None, num_dimensions, domain, n_nodes,
        max_derivative_order=max_derivative_order, defer_build=True,
        device=device)
    grid = ChebyshevApproximation.nodes(num_dimensions, domain, n_nodes)
    points = grid["full_grid"]
    shape = grid["shape"]
    n_grid = int(points.shape[0])

    if mesh is not None:
        sharding.check_device(mesh, device, "build_book")
        refusal = (
            "build_book(mesh=...) requires a vectorized book function of "
            "an (N, d) tensor (the sharded grid reaches it as a tensor on "
            "the mesh's device); drop mesh= for host/NumPy oracles")
        values = sharding._dp_apply(
            lambda p: sharding.call_on_shard(function, p, additional_data,
                                             refusal),
            torch.as_tensor(points, dtype=torch.float64,
                            device=template.device),
            mesh, data_axis, dim=0)
    else:
        values = function(points, additional_data)
    on_host = not isinstance(values, torch.Tensor)
    values = (np.asarray(values, dtype=np.float64) if on_host
              else values.detach().to(device=template.device,
                                      dtype=torch.float64))
    if values.ndim != 2 or int(values.shape[0]) != n_grid:
        raise ValueError(
            f"book function must return shape (G, M) = ({n_grid}, "
            f"num_models); got {tuple(values.shape)}"
        )
    n_models = int(values.shape[1])
    if num_models is not None and n_models != int(num_models):
        raise ValueError(
            f"book function returned {n_models} model columns, "
            f"expected num_models={int(num_models)}"
        )

    col_finite = (np.isfinite(values).all(axis=0) if on_host
                  else torch.isfinite(values).all(dim=0).cpu().numpy())
    if not col_finite.all():
        bad = np.nonzero(~col_finite)[0].tolist()
        raise ValueError(
            f"book function returned non-finite values in model "
            f"column(s) {bad}; build cannot proceed with NaN/Inf in "
            f"tensor_values"
        )

    # (G, M) -> (M, *shape): one transpose+reshape, where the values are.
    stacked = values.T.reshape((n_models,) + tuple(shape))
    elapsed = _time.time() - start

    models = []
    for m in range(n_models):
        model = ChebyshevApproximation._from_grid(template, stacked[m],
                                                  share_grid=True)
        model.build_time = elapsed
        model.n_evaluations = n_grid
        models.append(model)
    if verbose:
        where = "host" if on_host else "device"
        print(f"Built a {n_models}-model book in {elapsed:.3f}s "
              f"({n_grid:,} grid points x {n_models} models, one "
              f"{where} call)")
    return models


def save_book(path, models) -> None:
    """Checkpoint a same-grid dense book to ONE pickle-free ``.npz``
    (the shared grid once, the M tensors stacked); :func:`load_book`
    reconstructs M grid-sharing models.  The file is the JAX package's
    format (``utils.native_save.write_book_npz``)."""
    from pychebyshev_tpu_torch.utils.native_save import write_book_npz
    write_book_npz(path, models)


def load_book(path, *, device):
    """Load a dense book saved by :func:`save_book` onto ``device``
    (grid-sharing models, validated through ``from_values``)."""
    from pychebyshev_tpu_torch.utils.native_save import read_book_npz
    return read_book_npz(path, device=device)


def integrate_book(models, bounds, dtype=None) -> np.ndarray:
    """Box integrals of a same-grid dense book -> (M, B) in one pass.

    The book analog of :meth:`ChebyshevApproximation.integrate_batch`:
    the per-box sub-interval quadrature rows are built once per slice and
    contracted against every model's tensor
    (``ops.integrate.integrate_box_batch_models``): a portfolio's bucket
    masses or expected exposures for the cost of one row build plus M
    GEMMs, on the first model's device.

    Parameters
    ----------
    models : sequence of built same-grid ``ChebyshevApproximation``.
    bounds : (B, d, 2) boxes inside the shared domain.
    dtype : None (f64), ``torch.float32``, or ``"dd"`` (the near-f64
        tier in native f64; grids outside ``ops.eval_dd.supports_dd``
        take the f64 path).
    """
    from pychebyshev_tpu_torch.models.approximation import (
        ChebyshevApproximation,
    )
    from pychebyshev_tpu_torch.ops import integrate as integrate_ops
    from pychebyshev_tpu_torch.utils.calculus import normalize_bounds_batch

    models = list(models)
    if not models:
        raise ValueError("models must be a non-empty sequence")
    first = models[0]
    for i, m in enumerate(models):
        if not isinstance(m, ChebyshevApproximation):
            raise TypeError(
                f"models[{i}] is {type(m).__name__}; integrate_book "
                f"takes a dense book")
        if m.tensor_values is None:
            raise RuntimeError("all models must be built")
        if i and (list(m.n_nodes) != list(first.n_nodes)
                  or [list(b) for b in m.domain]
                  != [list(b) for b in first.domain]):
            raise ValueError(
                f"models[{i}] grid (n_nodes/domain) differs from "
                f"models[0]; a book shares one grid")
    arr = normalize_bounds_batch(integrate_ops.host_array(bounds),
                                 first.domain)
    tensors = tuple(m.tensor_values.to(first.device) for m in models)
    domain = np.asarray(first.domain, dtype=np.float64)
    tier = integrate_ops.tier(dtype)
    if tier == "dd" and eval_dd.supports_dd(
            tuple(int(n) for n in first.n_nodes)):
        out = integrate_ops.integrate_box_batch_models_dd(tensors, domain,
                                                          arr)
    else:
        out = integrate_ops.integrate_box_batch_models(
            tensors, domain, arr,
            dtype=torch.float64 if tier == "dd" else tier)
    return out.cpu().numpy()

"""Serving engines for batched queries (dense interpolants).

The port of ``pychebyshev_tpu.serving``, dense branch.  An engine
snapshots an interpolant's arrays at a chosen dtype on its device, with
the derivative passes it serves applied once, and answers any batch.

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

Spline, slider and tensor-train interpolants (dd included) and mesh
sharding are not ported yet.

Example
-------
>>> engine = BatchedEvaluator(cheb, dtype=torch.float32, device="cuda")
>>> engine.warmup()
>>> values = engine(points)          # any N
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from pychebyshev_tpu_torch.ops import eval as eval_ops
from pychebyshev_tpu_torch.ops import eval_dd, fused_eval

__all__ = ["BatchedEvaluator", "MultiSpecEvaluator"]

_DEFAULT_BUCKETS = (1 << 10, 1 << 14, 1 << 17, 1 << 20)


def _dense_snapshot(interpolant, engine: str, dtype, device):
    """(nodes, weights, diffs) of a built dense interpolant at ``dtype``
    (f64 for ``"dd"``) on ``device``, or an error naming what is not
    served."""
    from pychebyshev_tpu_torch.models.approximation import (
        ChebyshevApproximation,
    )
    if isinstance(dtype, str) and dtype != "dd":
        raise ValueError(
            f"{engine}: dtype={dtype!r} is not a tier of this engine; use "
            f"torch.float32, torch.float64 or 'dd'")
    if dtype not in ("dd", torch.float32, torch.float64):
        raise ValueError(f"{engine}: dtype must be torch.float32, "
                         f"torch.float64 or 'dd', got {dtype}")
    if not isinstance(interpolant, ChebyshevApproximation):
        raise TypeError(
            f"{engine} serves dense ChebyshevApproximation objects; "
            f"{type(interpolant).__name__} serving is not ported yet (it "
            f"comes with its family's slice of the port, see ROADMAP.md)")
    if interpolant.tensor_values is None:
        raise RuntimeError("interpolant is not built")
    if dtype == "dd":
        shape = tuple(interpolant.tensor_values.shape)
        if not eval_dd.supports_dd(shape):
            raise ValueError(
                f"grid shape {shape} is outside the digit-GEMM plan "
                f"budget; serve at dtype=torch.float64 instead")
        dtype = torch.float64
    nodes, weights, diffs = interpolant._grid_tuples()
    return tuple(tuple(a.to(device=device, dtype=dtype) for a in grp)
                 for grp in (nodes, weights, diffs))


def _spec_tensor(interpolant, orders, dtype, device):
    """The value tensor with ``orders`` applied in f64, then cast."""
    tensor = interpolant.tensor_values.to(device)
    diffs = [m.to(device) for m in interpolant.diff_matrices]
    return eval_ops.apply_derivative_passes(tensor, diffs, orders).to(
        dtype).contiguous()


def _validated_orders(orders, num_dimensions):
    orders = tuple(int(o) for o in (orders or [0] * num_dimensions))
    if len(orders) != num_dimensions:
        raise ValueError(
            f"derivative_order length {len(orders)} does not match "
            f"num_dimensions {num_dimensions}")
    return orders


class _Engine:
    """Points intake, the slice loop and the dd tier's out-of-domain
    route, shared by both engines."""

    def _intake(self, points) -> torch.Tensor:
        # dtype= converts host input straight to the engine's dtype: a
        # list of Python floats must not pass through float32.
        pts = torch.as_tensor(points, dtype=self.dtype, device=self.device)
        if pts.dim() != 2 or pts.shape[1] != self.num_dimensions:
            raise ValueError(
                f"points must have shape (N, {self.num_dimensions}); "
                f"got {tuple(pts.shape)}")
        return pts

    def _init_dd(self, interpolant, dtype, sibling):
        """Set the engine's tier.  A dd engine computes in f64 and keeps
        ``sibling`` (an f64 engine's constructor) for out-of-domain
        calls: the reference's dd contract holds in the domain only, so
        such a call is served at f64, reference extrapolation included."""
        self._dd = dtype == "dd"
        self.dtype = torch.float64 if self._dd else dtype
        if self._dd:
            self._dd_domain = torch.tensor(
                interpolant.domain, dtype=torch.float64, device=self.device)
            self._dd_fallback = None
            self._dd_fallback_ctor = sibling

    def _dd_sibling(self, points: torch.Tensor):
        """The f64 sibling engine when a dd engine gets a batch with a
        point outside the domain (one device-to-host read), else None."""
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
        join the results along the points axis (the last one)."""
        step = self.bucket_sizes[-1]
        outs = [self._run(points[i:i + step])
                for i in range(0, points.shape[0], step)]
        if not outs:
            return self._run(points)
        return torch.cat(outs, dim=-1)

    def warmup(self) -> None:
        """Run one smallest-bucket batch at the domain centre: builds the
        kernel and packs its operands before the first request."""
        centre = torch.tensor([0.5 * (lo + hi) for lo, hi in self._domain],
                              dtype=self.dtype, device=self.device)
        self._run(centre.expand(self.bucket_sizes[0], -1).contiguous())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class BatchedEvaluator(_Engine):
    """Batched evaluation of a dense interpolant at one derivative spec.

    Parameters
    ----------
    interpolant : a built ``ChebyshevApproximation``.
    dtype : torch.float32 (throughput), torch.float64 (parity) or "dd"
        (the near-f64 tier, f64 results).
    derivative_order : fixed per-dim derivative spec; None = values.
    bucket_sizes : ascending sizes; the largest caps one call's slice.
    use_fused : ``None`` = the fused kernel for f32 CUDA engines whose
        grid ``supports_fused`` covers; ``True`` forces it (raising
        outside the envelope), ``False`` the plain path.  A dd engine
        picks its route itself (``ops.eval_dd``) and refuses ``True``.
    device : the engine's device (required).
    """

    def __init__(self, interpolant, dtype=torch.float32,
                 derivative_order: Optional[Sequence[int]] = None,
                 bucket_sizes: Tuple[int, ...] = _DEFAULT_BUCKETS,
                 use_fused: bool = None, *, device):
        self.device = torch.device(device)
        grid = _dense_snapshot(interpolant, "BatchedEvaluator", dtype,
                               self.device)
        self._init_dd(interpolant, dtype, lambda: BatchedEvaluator(
            interpolant, dtype=torch.float64,
            derivative_order=derivative_order, bucket_sizes=bucket_sizes,
            device=device))
        self._nodes, self._weights, self._diffs = grid
        self.num_dimensions = interpolant.num_dimensions
        self.bucket_sizes = tuple(sorted(int(b) for b in bucket_sizes))
        self._domain = [tuple(b) for b in interpolant.domain]
        orders = _validated_orders(derivative_order, self.num_dimensions)
        self._tensor = _spec_tensor(interpolant, orders, self.dtype,
                                    self.device)
        self._orders = (0,) * self.num_dimensions
        if self._dd:
            if use_fused:
                raise ValueError("dtype='dd' picks its own route; it does "
                                 "not compose with use_fused")
            self._dd_runner = eval_dd.dd_models_runner(
                (self._tensor,), self._nodes, self._weights, self._diffs,
                self._orders)
            use_fused = False
        elif use_fused is None:
            use_fused = (dtype == torch.float32
                         and self.device.type == "cuda"
                         and fused_eval.supports_fused(
                             tuple(self._tensor.shape), dtype))
        elif use_fused and dtype != torch.float32:
            raise ValueError("use_fused needs dtype=torch.float32")
        self._use_fused = bool(use_fused)

    def _run(self, points: torch.Tensor) -> torch.Tensor:
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
        points = self._intake(points)
        sibling = self._dd_sibling(points)
        if sibling is not None:
            return sibling(points)
        return self._sliced(points)


class MultiSpecEvaluator(_Engine):
    """One dense interpolant, many derivative specs per call.

    ``engine(points)`` returns an (N, M) tensor — e.g. price plus five
    Greeks.  Every spec's derivative passes are applied once at
    construction (in f64, then cast); each call builds the per-point rows
    once per slice and contracts them against all M tensors
    (``ops.eval.eval_batch_models``).

    ``dtype="dd"`` serves the report at near-f64 through
    ``ops.eval_dd.dd_multi_runner``, which holds every spec's packed
    operands: on a CUDA device one f64 kernel launch per spec per slice,
    each against its pre-differentiated tensor.
    """

    def __init__(self, interpolant, specs, dtype=torch.float32,
                 bucket_sizes: Tuple[int, ...] = _DEFAULT_BUCKETS, *,
                 device):
        self.device = torch.device(device)
        grid = _dense_snapshot(interpolant, "MultiSpecEvaluator", dtype,
                               self.device)
        self._init_dd(interpolant, dtype, lambda: MultiSpecEvaluator(
            interpolant, specs, dtype=torch.float64,
            bucket_sizes=bucket_sizes, device=device))
        self._nodes, self._weights, self._diffs = grid
        self.num_dimensions = interpolant.num_dimensions
        self.bucket_sizes = tuple(sorted(int(b) for b in bucket_sizes))
        self._domain = [tuple(b) for b in interpolant.domain]
        self.specs = tuple(_validated_orders(s, self.num_dimensions)
                           for s in specs)
        if not self.specs:
            raise ValueError("MultiSpecEvaluator needs at least one spec")
        if self._dd:
            self._dd_runner = eval_dd.dd_multi_runner(
                interpolant.tensor_values.to(self.device), self._nodes,
                self._weights, self._diffs, self.specs)
        else:
            self._spec_tensors = tuple(
                _spec_tensor(interpolant, s, self.dtype, self.device)
                for s in self.specs)

    def _run(self, points: torch.Tensor) -> torch.Tensor:
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

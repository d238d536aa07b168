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

Spline, slider and tensor-train interpolants, the ``"dd"`` tier and
mesh sharding are not ported yet.

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
from pychebyshev_tpu_torch.ops import fused_eval

__all__ = ["BatchedEvaluator", "MultiSpecEvaluator"]

_DEFAULT_BUCKETS = (1 << 10, 1 << 14, 1 << 17, 1 << 20)


def _dense_snapshot(interpolant, engine: str, dtype, device):
    """(nodes, weights, diffs) of a built dense interpolant at ``dtype``
    on ``device``, or a TypeError naming what is not ported."""
    from pychebyshev_tpu_torch.models.approximation import (
        ChebyshevApproximation,
    )
    if isinstance(dtype, str):
        raise ValueError(
            f"{engine}: dtype={dtype!r} is not ported yet (the 'dd' tier "
            f"comes with a later slice of the port); use torch.float32 or "
            f"torch.float64")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{engine}: dtype must be torch.float32 or "
                         f"torch.float64, got {dtype}")
    if not isinstance(interpolant, ChebyshevApproximation):
        raise TypeError(
            f"{engine} serves dense ChebyshevApproximation objects; "
            f"{type(interpolant).__name__} serving is not ported yet (it "
            f"comes with its family's slice of the port, see ROADMAP.md)")
    if interpolant.tensor_values is None:
        raise RuntimeError("interpolant is not built")
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
    """Points intake and the slice loop shared by both engines."""

    def _intake(self, points) -> torch.Tensor:
        pts = torch.as_tensor(points, device=self.device).to(self.dtype)
        if pts.dim() != 2 or pts.shape[1] != self.num_dimensions:
            raise ValueError(
                f"points must have shape (N, {self.num_dimensions}); "
                f"got {tuple(pts.shape)}")
        return pts

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
    dtype : torch.float32 (throughput) or torch.float64 (parity).
    derivative_order : fixed per-dim derivative spec; None = values.
    bucket_sizes : ascending sizes; the largest caps one call's slice.
    use_fused : ``None`` = the fused kernel for f32 CUDA engines whose
        grid ``supports_fused`` covers; ``True`` forces it (raising
        outside the envelope), ``False`` the plain path.
    device : the engine's device (required).
    """

    def __init__(self, interpolant, dtype=torch.float32,
                 derivative_order: Optional[Sequence[int]] = None,
                 bucket_sizes: Tuple[int, ...] = _DEFAULT_BUCKETS,
                 use_fused: bool = None, *, device):
        self.device = torch.device(device)
        self.dtype = dtype
        grid = _dense_snapshot(interpolant, "BatchedEvaluator", dtype,
                               self.device)
        self._nodes, self._weights, self._diffs = grid
        self.num_dimensions = interpolant.num_dimensions
        self.bucket_sizes = tuple(sorted(int(b) for b in bucket_sizes))
        self._domain = [tuple(b) for b in interpolant.domain]
        orders = _validated_orders(derivative_order, self.num_dimensions)
        self._tensor = _spec_tensor(interpolant, orders, dtype, self.device)
        self._orders = (0,) * self.num_dimensions
        if use_fused is None:
            use_fused = (dtype == torch.float32
                         and self.device.type == "cuda"
                         and fused_eval.supports_fused(
                             tuple(self._tensor.shape), dtype))
        elif use_fused and dtype != torch.float32:
            raise ValueError("use_fused needs dtype=torch.float32")
        self._use_fused = bool(use_fused)

    def _run(self, points: torch.Tensor) -> torch.Tensor:
        if self._use_fused:
            return fused_eval.fused_eval_batch(
                self._tensor, self._nodes, self._weights, self._diffs,
                points, self._orders)
        return eval_ops.eval_batch(self._tensor, self._nodes, self._weights,
                                   self._diffs, points, self._orders)

    def __call__(self, points) -> torch.Tensor:
        """Evaluate at (N, d) points -> (N,) tensor on the engine device."""
        return self._sliced(self._intake(points))


class MultiSpecEvaluator(_Engine):
    """One dense interpolant, many derivative specs per call.

    ``engine(points)`` returns an (N, M) tensor — e.g. price plus five
    Greeks.  Every spec's derivative passes are applied once at
    construction (in f64, then cast); each call builds the per-point rows
    once per slice and contracts them against all M tensors
    (``ops.eval.eval_batch_models``).
    """

    def __init__(self, interpolant, specs, dtype=torch.float32,
                 bucket_sizes: Tuple[int, ...] = _DEFAULT_BUCKETS, *,
                 device):
        self.device = torch.device(device)
        self.dtype = dtype
        grid = _dense_snapshot(interpolant, "MultiSpecEvaluator", dtype,
                               self.device)
        self._nodes, self._weights, self._diffs = grid
        self.num_dimensions = interpolant.num_dimensions
        self.bucket_sizes = tuple(sorted(int(b) for b in bucket_sizes))
        self._domain = [tuple(b) for b in interpolant.domain]
        self.specs = tuple(_validated_orders(s, self.num_dimensions)
                           for s in specs)
        if not self.specs:
            raise ValueError("MultiSpecEvaluator needs at least one spec")
        self._spec_tensors = tuple(
            _spec_tensor(interpolant, s, dtype, self.device)
            for s in self.specs)

    def _run(self, points: torch.Tensor) -> torch.Tensor:
        return eval_ops.eval_batch_models(
            self._spec_tensors, self._nodes, self._weights, self._diffs,
            points, (0,) * self.num_dimensions)

    def __call__(self, points) -> torch.Tensor:
        """(N, d) points -> (N, len(specs)) tensor on the engine device."""
        return self._sliced(self._intake(points)).T

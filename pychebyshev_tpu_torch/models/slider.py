"""ChebyshevSlider: additive (sliding-technique) decomposition, on
PyTorch.

The port of ``pychebyshev_tpu.models.slider`` (serving surface).
Approximates ``f(x) ~= f(z) + sum_i [s_i(x_{G_i}) - f(z)]`` over a
partition of the dims with pivot z; each slide is a low-dimensional
:class:`ChebyshevApproximation` on ``device``, so the build costs the
*sum* of the groups' grid sizes instead of their product.

- Single points run on the host through each slide's host path.
- Batches run on the device (``ops.slider_eval``): the value sums the
  slides' batched evaluations; a derivative spec confined to one group
  is that slide's derivative, and one that crosses groups is exactly 0.
- ``eval_batch_dd`` is the near-f64 tier in native f64: one contraction
  of every slide's rows put side by side against the stacked slide
  tensors.

Batched results: ``eval_batch_device`` and ``eval_batch_dd`` return
tensors on the device; ``eval_batch`` and the ``vectorized_*`` spellings
return NumPy arrays.

- Calculus follows the additive decomposition: ``integrate`` in closed
  form, batched integrals and conditional expectations one dense batch
  per slide, roots and 1-D optima on resampled slices.

- ``fit`` solves the additive least-squares design from scattered
  samples in one solve (``utils.fitting.fit_additive_tensors``) and
  re-gauges every slide to the pivot.  The Sobol family follows the
  additive form (cross-group interactions are exactly zero).
The global ``minimize``/``maximize`` (``dim=None``) and
``critical_points`` are exact under the additive decomposition: one
certified search, or one stationary set, per slide
(``utils.globalcalc``).

``fit(mesh=)`` accumulates its normal equations data-parallel over a
device mesh (``utils.fitting``).
"""

from __future__ import annotations

import os
import pickle
import time
import warnings
from typing import Callable, List

import numpy as np
import torch

from pychebyshev_tpu_torch.models.approximation import ChebyshevApproximation
from pychebyshev_tpu_torch.ops import eval_dd, slider_eval
from pychebyshev_tpu_torch.ops.chebyshev import nodes_for_dim_np
from pychebyshev_tpu_torch.ops.integrate import host_array
from pychebyshev_tpu_torch.utils.algebra import check_compatible, is_scalar
from pychebyshev_tpu_torch.utils.calculus import (
    normalize_bounds,
    optimize_resampled_batch,
    roots_1d_batch,
    scenario_slice_points,
    validate_calculus_args,
    validate_calculus_args_batch,
    validate_partial_integrate_args_batch,
)
from pychebyshev_tpu_torch.utils.extrude_slice import (
    normalize_extrusion_params,
    normalize_slicing_params,
)
from pychebyshev_tpu_torch.utils import globalcalc

__all__ = ["ChebyshevSlider"]


class ChebyshevSlider:
    """Additive Chebyshev decomposition around a pivot point.

    Parameters mirror the JAX package's constructor; ``vectorized``
    marks ``function`` as batch-capable, and ``device`` (required,
    keyword-only) places every slide's tensors.
    """

    def __init__(self, function: Callable, num_dimensions: int, domain,
                 n_nodes, partition, pivot_point,
                 max_derivative_order: int = 2, additional_data=None, *,
                 device, vectorized: bool = False):
        from pychebyshev_tpu_torch import Domain, Ns
        if isinstance(domain, Domain):
            domain = list(domain.bounds)
        if isinstance(n_nodes, Ns):
            n_nodes = list(n_nodes.counts)

        self.device = torch.device(device)
        self.function = function
        self.num_dimensions = num_dimensions
        self.domain = [list(b) for b in domain]
        self.n_nodes = list(n_nodes)
        self.partition = [list(g) for g in partition]
        self.pivot_point = list(pivot_point)
        self.max_derivative_order = max_derivative_order
        self.descriptor: str = ""
        self.additional_data = additional_data
        self.vectorized = bool(vectorized)

        if any(len(g) == 0 for g in self.partition):
            raise ValueError("Partition groups must be non-empty")
        all_dims = sorted(d for group in self.partition for d in group)
        if all_dims != list(range(num_dimensions)):
            raise ValueError(
                f"Partition must cover all dimensions "
                f"0..{num_dimensions - 1} exactly once. "
                f"Got dimensions: {all_dims}"
            )

        self._dim_to_slide = {d: slide_idx
                              for slide_idx, group in enumerate(self.partition)
                              for d in group}
        self.slides: List[ChebyshevApproximation] = []
        self.pivot_value: float = 0.0
        self._built = False
        self._cached_error_estimate = None
        self._derivative_id_registry: dict = {}
        self._derivative_id_to_orders: list = []

    # ------------------------------------------------------------------
    # Build
    # ------------------------------------------------------------------

    def build(self, verbose: bool | int = True) -> None:
        """Build one low-dim approximation per group (off-group dims fixed
        at the pivot)."""
        if self.function is None:
            raise RuntimeError(
                "Cannot build: no function assigned. "
                "This object was created via load() or a factory."
            )
        start = time.time()
        self._cached_error_estimate = None

        if self.vectorized:
            pivot_arr = np.asarray([self.pivot_point], dtype=np.float64)
            self.pivot_value = float(np.asarray(
                self.function(pivot_arr, self.additional_data)).reshape(-1)[0])
        else:
            self.pivot_value = float(
                self.function(self.pivot_point, self.additional_data))

        if verbose:
            print(f"Building {self.num_dimensions}D Chebyshev Slider "
                  f"({len(self.partition)} slides, "
                  f"{self.total_build_evals:,} evaluations)...")
        from pychebyshev_tpu_torch.utils.progress import progress_iter

        self.slides = []
        for slide_idx, group in enumerate(progress_iter(
                self.partition, total=len(self.partition),
                enabled=(verbose == 2), desc="Building slides")):
            slide = ChebyshevApproximation(
                self._make_slide_func(group), len(group),
                [self.domain[d] for d in group],
                [self.n_nodes[d] for d in group],
                max_derivative_order=self.max_derivative_order,
                additional_data=self.additional_data, device=self.device,
                vectorized=self.vectorized,
            )
            slide.build(verbose=False)
            self.slides.append(slide)
            if verbose:
                print(f"  Slide {slide_idx + 1}/{len(self.partition)}: "
                      f"dims {group}")
        if verbose:
            print(f"Build complete in {time.time() - start:.3f}s")
        self._built = True

    def _make_slide_func(self, group):
        """Slide closure: fills off-group dims with the pivot."""
        pivot = list(self.pivot_point)
        function = self.function
        if self.vectorized:
            group_arr = np.asarray(group, dtype=np.intp)
            pivot_arr = np.asarray(pivot, dtype=np.float64)

            def slide_func(sub_points, data):
                sub_points = np.asarray(sub_points, dtype=np.float64)
                full = np.tile(pivot_arr, (sub_points.shape[0], 1))
                full[:, group_arr] = sub_points
                return function(full, data)
        else:
            def slide_func(sub_point, data):
                full_point = list(pivot)
                for local_i, global_d in enumerate(group):
                    full_point[global_d] = sub_point[local_i]
                return function(full_point, data)
        return slide_func

    # ------------------------------------------------------------------
    # Derivative-id registry
    # ------------------------------------------------------------------

    def get_derivative_id(self, derivative_order) -> int:
        """Stable per-process id for a derivative-orders tuple."""
        from pychebyshev_tpu_torch.utils.derivative_ids import (
            register_derivative_id,
        )
        return register_derivative_id(self, derivative_order)

    def _resolve_derivative_args(self, derivative_order, derivative_id):
        """Resolve orders xor id; raises on both/neither/unknown."""
        from pychebyshev_tpu_torch.utils.derivative_ids import (
            resolve_derivative_args,
        )
        return resolve_derivative_args(self, derivative_order,
                                       derivative_id)

    # ------------------------------------------------------------------
    # Evaluation
    # ------------------------------------------------------------------

    def _active_slides(self, derivative_order) -> set:
        return {self._dim_to_slide[d]
                for d, order in enumerate(derivative_order) if order > 0}

    def eval(self, point, derivative_order=None, *, derivative_id=None
             ) -> float:
        """The sliding sum at one point, on the host; derivatives route
        to the owning slide (cross-group mixed partials are exactly 0)."""
        if not self._built:
            raise RuntimeError("Call build() before eval().")
        derivative_order = self._resolve_derivative_args(
            derivative_order, derivative_id)

        if any(o > 0 for o in derivative_order):
            active = self._active_slides(derivative_order)
            if len(active) > 1:
                return 0.0
            slide_idx = active.pop()
            group = self.partition[slide_idx]
            return self.slides[slide_idx].vectorized_eval(
                [point[d] for d in group],
                [derivative_order[d] for d in group])

        result = self.pivot_value
        for slide_idx, group in enumerate(self.partition):
            slide_val = self.slides[slide_idx].vectorized_eval(
                [point[d] for d in group], [0] * len(group))
            result += slide_val - self.pivot_value
        return result

    def eval_multi(self, point, derivative_orders) -> List[float]:
        """Multiple derivative specs at one point."""
        return [self.eval(point, do) for do in derivative_orders]

    vectorized_eval = eval
    vectorized_eval_multi = eval_multi

    def _points(self, points) -> torch.Tensor:
        pts = torch.as_tensor(points, dtype=torch.float64,
                              device=self.device)
        if pts.dim() != 2 or pts.shape[1] != self.num_dimensions:
            raise ValueError(
                f"points must have shape (N, {self.num_dimensions}), "
                f"got {tuple(pts.shape)}")
        return pts

    def _orders(self, derivative_order, derivative_id=None):
        if derivative_order is not None or derivative_id is not None:
            derivative_order = self._resolve_derivative_args(
                derivative_order, derivative_id)
        if derivative_order is None:
            derivative_order = [0] * self.num_dimensions
        if len(derivative_order) != self.num_dimensions:
            raise ValueError(
                f"derivative_order length {len(derivative_order)} does "
                f"not match num_dimensions {self.num_dimensions}"
            )
        return [int(o) for o in derivative_order]

    def _slide_data(self):
        return tuple((s.tensor_values,) + s._grid_tuples()
                     for s in self.slides)

    def _groups(self):
        return tuple(tuple(int(d) for d in g) for g in self.partition)

    def eval_batch_device(self, points, derivative_order=None, *,
                          derivative_id=None) -> torch.Tensor:
        """Batched f64 evaluation, result left on the device: values sum
        the slides' batched evaluations; a derivative spec runs its
        owning slide (or is exactly 0 across groups)."""
        if not self._built:
            raise RuntimeError("Call build() before eval_batch().")
        pts = self._points(points)
        orders = self._orders(derivative_order, derivative_id)
        if any(o > 0 for o in orders):
            active = self._active_slides(orders)
            if len(active) > 1:
                return pts.new_zeros(pts.shape[0])
            slide_idx = active.pop()
            group = self.partition[slide_idx]
            return self.slides[slide_idx].eval_batch_device(
                pts[:, group], [orders[d] for d in group])
        return slider_eval.slider_value_batch(
            self._slide_data(), self.pivot_value, self._groups(), pts)

    def eval_batch(self, points, derivative_order=None, *,
                   derivative_id=None) -> np.ndarray:
        """Batched f64 evaluation: (N, d) points -> (N,) NumPy values."""
        return self.eval_batch_device(
            points, derivative_order,
            derivative_id=derivative_id).cpu().numpy()

    vectorized_eval_batch = eval_batch

    def eval_batch_dd(self, points, derivative_order=None,
                      mode: str = "accurate") -> torch.Tensor:
        """Near-f64 batched evaluation, result left on the device.

        The slider's dd tier (``ops.slider_eval.slider_batch_dd``) in
        native f64: one contraction of the slides' rows put side by side
        against the stacked slide tensors.  Derivative specs keep the
        reference's routing.  An out-of-domain batch (one device-to-host
        read decides it), or slides the reference's plan refuses, take
        the f64 path, reference extrapolation included.
        """
        if not self._built:
            raise RuntimeError("Call build() before eval_batch_dd().")
        if mode not in ("accurate", "fast"):
            raise ValueError(
                f"mode must be 'accurate' or 'fast', got {mode!r}")
        pts = self._points(points)
        orders = self._orders(derivative_order)
        shapes = [tuple(s.tensor_values.shape) for s in self.slides]
        dom = torch.tensor(self.domain, dtype=torch.float64,
                           device=self.device)
        out_of_domain = bool(((pts < dom[:, 0]) | (pts > dom[:, 1]))
                             .any().item())
        if out_of_domain or not slider_eval.slider_dd_plan(shapes)["ok"]:
            return self.eval_batch_device(pts, orders)
        cutoff = eval_dd.FAST_PAIR_CUTOFF if mode == "fast" else None
        return slider_eval.slider_batch_dd(
            self._slide_data(), self.pivot_value, self._groups(), pts,
            orders=orders, cutoff=cutoff)

    def _multi_spec_plans(self, orders_list):
        """Routing plan per derivative spec: ``("value",)``, ``("zero",)``
        for a spec that crosses groups, else ``("slide", idx,
        sub_orders)`` (``ops.slider_eval.spec_plan``).  Shared by the
        class path and the serving engines so their routing cannot
        diverge."""
        for orders in orders_list:
            if len(orders) != self.num_dimensions:
                raise ValueError(
                    f"derivative_order length {len(orders)} does not "
                    f"match num_dimensions {self.num_dimensions}"
                )
        return list(slider_eval.spec_plan(self._groups(), orders_list))

    def vectorized_eval_batch_multi(self, points, derivative_orders
                                    ) -> np.ndarray:
        """Batch x multi-spec evaluation -> (N, len(derivative_orders))
        NumPy array: the value sum at most once, one owning-slide
        evaluation per derivative spec, exact zeros across groups."""
        if not self._built:
            raise RuntimeError(
                "Call build() before vectorized_eval_batch_multi()."
            )
        pts = self._points(points)
        orders_list = tuple(tuple(int(o) for o in orders)
                            for orders in derivative_orders)
        if not orders_list:
            return np.zeros((pts.shape[0], 0))
        plan = self._multi_spec_plans(orders_list)
        out = slider_eval.slider_multi_batch(
            self._slide_data(), self.pivot_value, self._groups(),
            tuple(plan), pts)
        return out.T.cpu().numpy()

    eval_batch_multi = vectorized_eval_batch_multi

    # ------------------------------------------------------------------
    # Error estimation + properties
    # ------------------------------------------------------------------

    def error_estimate(self, tail: int = 1) -> float:
        """Sum of per-slide estimates (cross-group interaction error is
        not included)."""
        if not self._built:
            raise RuntimeError("Call build() before error_estimate().")
        if tail == 1 and self._cached_error_estimate is not None:
            return self._cached_error_estimate
        est = sum(slide.error_estimate(tail) for slide in self.slides)
        if tail == 1:
            self._cached_error_estimate = est
        return est

    @property
    def total_build_evals(self) -> int:
        """Sum over groups of their grid sizes."""
        return sum(int(np.prod([self.n_nodes[d] for d in group]))
                   for group in self.partition)

    # ------------------------------------------------------------------
    # Serialization + ergonomics
    # ------------------------------------------------------------------

    def __getstate__(self) -> dict:
        from pychebyshev_tpu_torch._version import __version__
        state = self.__dict__.copy()
        state["function"] = None
        state["device"] = str(self.device)
        state["_pychebyshev_version"] = __version__
        return state

    def __setstate__(self, state: dict) -> None:
        from pychebyshev_tpu_torch._version import __version__
        saved = state.pop("_pychebyshev_version", None)
        if saved is not None and saved != __version__:
            warnings.warn(
                f"This object was saved with pychebyshev-tpu {saved}, but "
                f"you are loading it with {__version__}. Evaluation results "
                f"may differ if internal data layout changed.",
                UserWarning,
                stacklevel=2,
            )
        self.__dict__.update(state)
        self.function = None
        self.device = torch.device(state["device"])

    def is_construction_finished(self) -> bool:
        """True iff built and usable."""
        return self._built

    def get_constructor_type(self) -> str:
        """Class name."""
        return type(self).__name__

    def get_used_ns(self) -> list:
        """Per-dim node counts."""
        return list(self.n_nodes)

    def set_descriptor(self, descriptor: str) -> None:
        """Attach a free-form text label."""
        if not isinstance(descriptor, str):
            raise TypeError(
                f"descriptor must be str, got {type(descriptor).__name__}"
            )
        self.descriptor = descriptor

    def get_descriptor(self) -> str:
        """The descriptor label (default '')."""
        return self.descriptor

    def get_max_derivative_order(self) -> int:
        """Maximum queryable derivative order."""
        return self.max_derivative_order

    def get_special_points(self):
        """Always None: sliders have no special-point surface."""
        return None

    def get_error_threshold(self):
        """Always None: slider builds have no auto-N threshold mode."""
        return None

    def get_num_evaluation_points(self) -> int:
        """Slide grid points (pivot singleton excluded)."""
        return int(self.total_build_evals)

    def get_evaluation_points(self) -> np.ndarray:
        """Slide grids lifted into d-D space (off-group dims at pivot)."""
        pivot = np.array(self.pivot_point, dtype=np.float64)
        rows = []
        for slide, group in zip(self.slides, self.partition):
            grid = slide.get_evaluation_points()
            full = np.tile(pivot, (len(grid), 1))
            full[:, group] = grid
            rows.append(full)
        return np.concatenate(rows, axis=0)

    def clone(self) -> "ChebyshevSlider":
        """Independent deep copy (function not duplicated)."""
        import copy
        return copy.deepcopy(self)

    def differentiate(self, derivative_order) -> "ChebyshevSlider":
        """A first-class slider of the given derivative, term by term:
        all-zero orders copy the slider; orders touching one group
        differentiate that slide and zero the others (pivot 0); orders
        spanning several groups give the identically-zero slider."""
        if not self._built:
            raise RuntimeError("Call build() before differentiate().")
        orders = [int(o) for o in derivative_order]
        if len(orders) != self.num_dimensions:
            raise ValueError(
                f"derivative_order length {len(orders)} does not match "
                f"num_dimensions {self.num_dimensions}"
            )
        if any(o < 0 for o in orders):
            raise ValueError("derivative orders must be >= 0")

        def _zero_like(slide):
            return ChebyshevApproximation._from_grid(
                slide, slide.tensor_values * 0.0)

        active = self._active_slides(orders)
        if not active:
            new_slides = [s.differentiate([0] * len(g))
                          for s, g in zip(self.slides, self.partition)]
            return ChebyshevSlider._from_slides(
                self, new_slides, self.pivot_value)
        if len(active) > 1:
            return ChebyshevSlider._from_slides(
                self, [_zero_like(s) for s in self.slides], 0.0)
        owner = active.pop()
        new_slides = [
            s.differentiate([orders[d] for d in g]) if i == owner
            else _zero_like(s)
            for i, (s, g) in enumerate(zip(self.slides, self.partition))
        ]
        return ChebyshevSlider._from_slides(self, new_slides, 0.0)

    def to_tt(self, tolerance: float = 1e-12):
        """Exact TT form of the sliding sum on this slider's device.

        ``f = sum_g s_g - (G-1) p`` is a sum of group-local terms, which
        a tensor train holds through an accumulator and a pass-through
        channel: rank 2 between groups, the slide's rank plus 1 or 2
        inside a group.  Non-contiguous partitions use the TT's
        ``dim_order`` frame (storage order = groups concatenated).  The
        result's ``max_rank`` is the uncapped TT bound, so later TT
        algebra has rounding headroom.
        """
        if not self._built:
            raise RuntimeError("Call build() first")
        from pychebyshev_tpu_torch.models import tt_algorithms as tta
        from pychebyshev_tpu_torch.models.tensor_train import ChebyshevTT

        n_groups = len(self.partition)
        # Per-group VALUE cores of the slide tensors, constant folded
        # into the first group so f = sum of group terms exactly.
        group_cores: List[List[np.ndarray]] = []
        for g, slide in enumerate(self.slides):
            w = np.array(slide.tensor_values.detach().cpu().numpy(),
                         dtype=np.float64)
            if g == 0:
                w = w - (n_groups - 1) * self.pivot_value
            group_cores.append(
                tta.tt_svd_from_tensor(w, max_rank=int(w.size),
                                       tol=tolerance))

        # Bond channel layout [acc? | partial? | pass?]: acc exists once
        # the first group's term has completed; partial carries the
        # current group's slide between its own cores; pass carries the
        # constant 1 that seeds later groups and dies once the last
        # group starts.
        value_cores: List[np.ndarray] = []
        in_acc = in_partial = False
        in_pass = True
        for g, cores_g in enumerate(group_cores):
            k = len(cores_g)
            last_g = g == n_groups - 1
            for m, b in enumerate(cores_g):
                rho_l, n_m, rho_r = b.shape
                completes = m == k - 1
                out_acc = in_acc or completes
                out_partial = not completes
                out_pass = not last_g
                r_in = ((1 if in_acc else 0)
                        + (rho_l if in_partial else 0)
                        + (1 if in_pass else 0))
                r_out = ((1 if out_acc else 0)
                         + (rho_r if out_partial else 0)
                         + (1 if out_pass else 0))
                core = np.zeros((r_in, n_m, r_out))
                i_acc = 0 if in_acc else None
                i_par = (1 if in_acc else 0) if in_partial else None
                i_pass = r_in - 1 if in_pass else None
                o_acc = 0 if out_acc else None
                o_par = (1 if out_acc else 0) if out_partial else None
                o_pass = r_out - 1 if out_pass else None
                one = np.ones(n_m, dtype=np.float64)
                if i_acc is not None:
                    core[i_acc, :, o_acc] = one
                if out_partial:
                    if in_partial:
                        core[i_par:i_par + rho_l, :,
                             o_par:o_par + rho_r] = b
                    else:
                        # The group's term starts: pass seeds partial.
                        core[i_pass, :, o_par:o_par + rho_r] = b[0]
                else:
                    # The group's term completes into the accumulator.
                    if in_partial:
                        core[i_par:i_par + rho_l, :, o_acc] = b[:, :, 0]
                    else:
                        core[i_pass, :, o_acc] = b[0, :, 0]
                if o_pass is not None:
                    core[i_pass, :, o_pass] = one
                value_cores.append(core)
                in_acc, in_partial = out_acc, out_partial
                in_pass = out_pass

        coeff_cores = [tta.value_core_to_coeff_core(c)
                       for c in value_cores]
        storage_dims = [d for group in self.partition for d in group]
        storage_domain = [list(self.domain[d]) for d in storage_dims]
        storage_n = [int(self.n_nodes[d]) for d in storage_dims]
        if len(storage_n) > 1:
            cap = max(
                min(int(np.prod(storage_n[:j + 1])),
                    int(np.prod(storage_n[j + 1:])))
                for j in range(len(storage_n) - 1))
        else:
            cap = 1
        return ChebyshevTT._from_coeff_cores(
            coeff_cores, storage_domain, storage_n,
            dim_order=storage_dims, max_rank=cap, tolerance=tolerance,
            max_derivative_order=self.max_derivative_order,
            additional_data=self.additional_data,
            descriptor=self.descriptor, method="slider",
            device=self.device)

    @staticmethod
    def is_dimensionality_allowed(num_dimensions: int) -> bool:
        """Whether this class supports ``num_dimensions`` (any >= 1)."""
        return isinstance(num_dimensions, int) and num_dimensions >= 1

    def save(self, path: str | os.PathLike,
             format: str = "pickle") -> None:
        """Save to pickle (default) or the pickle-free ``.npz`` (slide
        tensors and metadata); the function is not saved."""
        if not self._built:
            raise RuntimeError(
                "Cannot save an unbuilt slider. Call build() first."
            )
        if format == "pickle":
            with open(os.fspath(path), "wb") as f:
                pickle.dump(self, f, protocol=pickle.HIGHEST_PROTOCOL)
        elif format == "npz":
            from pychebyshev_tpu_torch.utils.native_save import write_npz
            write_npz(path, self)
        else:
            raise ValueError(
                f"format must be 'pickle' or 'npz', got {format!r}"
            )

    @classmethod
    def load(cls, path: str | os.PathLike, *, device) -> "ChebyshevSlider":
        """Load from pickle or ``.npz`` (magic-sniffed) onto ``device``;
        only unpickle files this program wrote."""
        from pychebyshev_tpu_torch.utils import native_save
        if native_save.detect_npz(path):
            obj = native_save.read_npz(path, device=device)
            if not isinstance(obj, cls):
                raise TypeError(
                    f"Expected a {cls.__name__} checkpoint, got "
                    f"{type(obj).__name__}"
                )
            return obj
        with open(os.fspath(path), "rb") as f:
            obj = pickle.load(f)  # noqa: S301
        if not isinstance(obj, cls):
            raise TypeError(
                f"Expected a {cls.__name__} instance, got "
                f"{type(obj).__name__}"
            )
        obj.device = torch.device(device)
        for slide in obj.slides:
            slide._move_to(device)
        return obj

    @classmethod
    def fit(cls, points, values, num_dimensions, domain, n_nodes,
            partition, pivot_point, *, l2: float = 0.0,
            sample_weight=None, rcond=None, derivative_data=None,
            engine: str = "host", mesh=None, data_axis: str = "dp",
            max_derivative_order: int = 2, device) -> "ChebyshevSlider":
        """Least-squares slider from SCATTERED high-dimensional samples.

        The additive model ``c0 + sum_i h_i(x_{G_i})`` is jointly linear
        in the intercept and every slide's nodal tensor, so a 10-D fit
        is ONE small solve with ``1 + sum_i prod(n[G_i])`` columns
        (``utils/fitting.py::fit_additive_tensors``).  The k constant
        redundancies of the additive form are resolved by re-gauging
        every slide to the pivot (``g_i(z_{G_i}) = f_hat(z)``), so the
        assembled slider satisfies the sliding identity exactly.

        ``derivative_data`` blocks must differentiate dims of at most
        one partition group.  ``engine`` / ``mesh`` / ``device`` as in
        :meth:`ChebyshevApproximation.fit`.  Returns a fully-built
        slider on ``device``; ``fit_diagnostics`` as in the dense fit
        (plus ``columns``).
        """
        from pychebyshev_tpu_torch.ops.chebyshev import (
            barycentric_weights_np,
        )
        from pychebyshev_tpu_torch.utils.fitting import (
            barycentric_rows_np,
            fit_additive_tensors,
        )

        if any(len(g) == 0 for g in partition):
            raise ValueError("Partition groups must be non-empty")
        all_dims = sorted(d for group in partition for d in group)
        if all_dims != list(range(num_dimensions)):
            raise ValueError(
                f"Partition must cover all dimensions "
                f"0..{num_dimensions - 1} exactly once. "
                f"Got dimensions: {all_dims}"
            )
        if len(pivot_point) != num_dimensions:
            raise ValueError(
                f"pivot_point length {len(pivot_point)} does not match "
                f"num_dimensions {num_dimensions}")
        if len(domain) != num_dimensions or len(n_nodes) != num_dimensions:
            raise ValueError(
                f"len(domain)={len(domain)} and len(n_nodes)="
                f"{len(n_nodes)} must both equal num_dimensions="
                f"{num_dimensions}")

        tensors, c0, diagnostics = fit_additive_tensors(
            points, values, domain, n_nodes, partition, l2=l2,
            sample_weight=sample_weight, rcond=rcond,
            derivative_data=derivative_data, engine=engine,
            mesh=mesh, data_axis=data_axis, device=device)

        # Re-gauge: pin every slide to the pivot.  With b_i = h_i(z_i)
        # and p = c0 + sum b_i, the slides g_i = h_i + (p - b_i) give
        # p + sum(g_i - p) = c0 + sum h_i -- the same predictions, now
        # in slider form with g_i(z_i) = p = f_hat(z).
        pivot_vals = []
        for group, tensor in zip(partition, tensors):
            v = tensor
            for dim in group:
                nd = nodes_for_dim_np(float(domain[dim][0]),
                                      float(domain[dim][1]),
                                      int(n_nodes[dim]))
                row = barycentric_rows_np(
                    np.asarray([float(pivot_point[dim])]), nd,
                    barycentric_weights_np(nd))[0]
                v = np.tensordot(row, v, axes=(0, 0))
            pivot_vals.append(float(v))
        p = c0 + float(np.sum(pivot_vals))

        slides = [
            ChebyshevApproximation.from_values(
                tensor + (p - b), len(group),
                [list(domain[dim]) for dim in group],
                [int(n_nodes[dim]) for dim in group],
                max_derivative_order=max_derivative_order, device=device)
            for group, tensor, b in zip(partition, tensors, pivot_vals)
        ]
        obj = cls._assemble(
            num_dimensions=num_dimensions, domain=domain,
            n_nodes=list(n_nodes), partition=partition,
            pivot_point=list(pivot_point), slides=slides, pivot_value=p,
            max_derivative_order=max_derivative_order, device=device)
        obj.fit_diagnostics = diagnostics
        return obj

    @classmethod
    def _from_slides(cls, source, slides, pivot_value):
        """New slider sharing metadata from *source* with new slides."""
        return cls._assemble(
            num_dimensions=source.num_dimensions, domain=source.domain,
            n_nodes=source.n_nodes, partition=source.partition,
            pivot_point=source.pivot_point, slides=slides,
            pivot_value=pivot_value,
            max_derivative_order=source.max_derivative_order,
            device=source.device)

    @classmethod
    def _assemble(cls, *, num_dimensions, domain, n_nodes, partition,
                  pivot_point, slides, pivot_value, max_derivative_order,
                  device, descriptor="", additional_data=None):
        """One built-object factory for slides made elsewhere
        (``_from_slides``, ``utils.convert``)."""
        obj = object.__new__(cls)
        obj.device = torch.device(device)
        obj.function = None
        obj.num_dimensions = num_dimensions
        obj.domain = [list(b) for b in domain]
        obj.n_nodes = list(n_nodes)
        obj.max_derivative_order = max_derivative_order
        obj.partition = [list(g) for g in partition]
        obj.pivot_point = list(pivot_point)
        obj.slides = list(slides)
        obj.pivot_value = pivot_value
        obj._dim_to_slide = {d: si for si, group in enumerate(obj.partition)
                             for d in group}
        obj._built = True
        obj.descriptor = descriptor
        obj.additional_data = additional_data
        obj.vectorized = False
        obj._cached_error_estimate = None
        obj._derivative_id_registry = {}
        obj._derivative_id_to_orders = []
        return obj

    # ------------------------------------------------------------------
    # Extrude / slice
    # ------------------------------------------------------------------

    def extrude(self, params) -> "ChebyshevSlider":
        """Each new dim becomes a 1-dim slide whose tensor is constant at
        the pivot value (contributes 0 to the sliding sum); existing
        group indices are remapped."""
        if not self._built:
            raise RuntimeError("Call build() first")
        sorted_params = normalize_extrusion_params(params,
                                                   self.num_dimensions)
        domain = [list(b) for b in self.domain]
        n_nodes = list(self.n_nodes)
        pivot_point = list(self.pivot_point)
        partition = [list(g) for g in self.partition]
        slides = list(self.slides)
        for dim_idx, (lo, hi), n in sorted_params:
            for group in partition:
                for i in range(len(group)):
                    if group[i] >= dim_idx:
                        group[i] += 1
            slides.append(ChebyshevApproximation.from_values(
                np.full(n, self.pivot_value), 1, [[lo, hi]], [n],
                max_derivative_order=self.max_derivative_order,
                device=self.device))
            partition.append([dim_idx])
            domain.insert(dim_idx, [lo, hi])
            n_nodes.insert(dim_idx, n)
            pivot_point.insert(dim_idx, 0.5 * (lo + hi))
        return ChebyshevSlider._assemble(
            num_dimensions=self.num_dimensions + len(sorted_params),
            domain=domain, n_nodes=n_nodes, partition=partition,
            pivot_point=pivot_point, slides=slides,
            pivot_value=self.pivot_value,
            max_derivative_order=self.max_derivative_order,
            device=self.device)

    def slice(self, params) -> "ChebyshevSlider":
        """Fix dims at values.

        Multi-dim groups slice the slide's tensor; a single-dim group's
        value is absorbed as a delta into the pivot value and every other
        slide's tensor, and the group disappears.
        """
        if not self._built:
            raise RuntimeError("Call build() first")
        sorted_params = normalize_slicing_params(params, self.num_dimensions)
        for dim_idx, value in sorted_params:
            lo, hi = self.domain[dim_idx]
            if value < lo or value > hi:
                raise ValueError(
                    f"Slice value {value} for dim {dim_idx} is outside "
                    f"domain [{lo}, {hi}]"
                )
        domain = [list(b) for b in self.domain]
        n_nodes = list(self.n_nodes)
        pivot_point = list(self.pivot_point)
        partition = [list(g) for g in self.partition]
        slides = list(self.slides)
        pivot_value = self.pivot_value
        for dim_idx, value in sorted_params:  # descending
            slide_idx = next(si for si, group in enumerate(partition)
                             if dim_idx in group)
            group = partition[slide_idx]
            if len(group) > 1:
                slides[slide_idx] = slides[slide_idx].slice(
                    (group.index(dim_idx), value))
                group.remove(dim_idx)
            else:
                s_val = slides[slide_idx].vectorized_eval([value], [0])
                delta = s_val - pivot_value
                for i in range(len(slides)):
                    if i != slide_idx:
                        slides[i] = ChebyshevApproximation._from_grid(
                            slides[i], slides[i].tensor_values + delta)
                pivot_value = s_val
                del partition[slide_idx]
                del slides[slide_idx]
            for g in partition:
                for i in range(len(g)):
                    if g[i] > dim_idx:
                        g[i] -= 1
            del domain[dim_idx]
            del n_nodes[dim_idx]
            del pivot_point[dim_idx]
        return ChebyshevSlider._assemble(
            num_dimensions=self.num_dimensions - len(sorted_params),
            domain=domain, n_nodes=n_nodes, partition=partition,
            pivot_point=pivot_point, slides=slides,
            pivot_value=pivot_value,
            max_derivative_order=self.max_derivative_order,
            device=self.device)

    # ------------------------------------------------------------------
    # Integration
    # ------------------------------------------------------------------

    def integrate(self, dims=None, bounds=None):
        """Closed-form integration of the sliding sum.

        With ``F = p + sum_i (s_i - p)`` and integration set ``T`` of
        measure ``V = prod_{d in T} m_d``, each additive term integrates
        independently::

            int_T F = p*V + sum_i  V/vol_in(G_i) * (R_i - p*vol_in(G_i))

        where ``vol_in(G_i)`` is the measure of the group's dims that lie
        in ``T`` and ``R_i`` is the slide reduced over those dims (a
        scalar when the whole group is integrated, a lower-dim tensor
        otherwise).  Scalar terms fold into the new pivot constant;
        tensor terms become the surviving slides, re-centred so the
        sliding identity holds for the new pivot.
        """
        if not self._built:
            raise RuntimeError("Call build() first")
        if dims is None:
            integ_dims = list(range(self.num_dimensions))
        elif isinstance(dims, int):
            integ_dims = [dims]
        else:
            integ_dims = sorted(set(dims))
        for d in integ_dims:
            if d < 0 or d >= self.num_dimensions:
                raise ValueError(
                    f"dim {d} out-of-range [0, {self.num_dimensions - 1}]"
                )
        integ_set = frozenset(integ_dims)

        # Per-dim measure of the integration range; 1.0 off the set, so
        # products over arbitrary dim subsets are plain slicing.
        range_by_dim = dict(zip(integ_dims,
                                normalize_bounds(integ_dims, bounds,
                                                 self.domain)))
        measure = np.ones(self.num_dimensions)
        for d in integ_dims:
            lo, hi = range_by_dim[d] or self.domain[d]
            measure[d] = hi - lo
        total_vol = float(np.prod(measure[integ_dims]))

        def reduce_slide(slide, group):
            """The slide integrated over its in-set local dims, and the
            measure of those dims."""
            local = [i for i, d in enumerate(group) if d in integ_set]
            sub = [range_by_dim[group[i]] for i in local]
            if any(b is not None for b in sub):
                reduced = slide.integrate(dims=local, bounds=sub)
            else:
                reduced = slide.integrate(dims=local)
            return reduced, float(np.prod(measure[
                [group[i] for i in local]]))

        # One pass: scalars accumulate into the pivot constant, tensors
        # become surviving slides (recorded before re-centring, since the
        # final constant is known only when the pass completes).
        const = self.pivot_value * total_vol
        survivors = []  # (scaled tensor values, template, kept global dims)
        for group, slide in zip(self.partition, self.slides):
            n_in = sum(d in integ_set for d in group)
            if n_in == len(group):
                full_val, inner_vol = reduce_slide(slide, group)
                const += (total_vol / inner_vol) * (
                    float(full_val) - self.pivot_value * inner_vol)
            elif n_in == 0:
                survivors.append((total_vol * slide.tensor_values,
                                  slide, list(group)))
            else:
                part, inner_vol = reduce_slide(slide, group)
                survivors.append(((total_vol / inner_vol)
                                  * part.tensor_values, part,
                                  [d for d in group if d not in integ_set]))

        if len(integ_dims) == self.num_dimensions:
            return float(const)
        if not survivors:
            raise RuntimeError(
                "internal error: surviving dims but every group was "
                "integrated away")

        # Renumber surviving global dims: d -> d minus integrated dims
        # below it.
        removed_below = np.cumsum(
            [1 if d in integ_set else 0 for d in
             range(self.num_dimensions)])
        remap = [d - int(removed_below[d])
                 for d in range(self.num_dimensions)]
        kept_dims = [d for d in range(self.num_dimensions)
                     if d not in integ_set]

        # Re-centre: F' = const + sum_j (h_j - p*V)  ==>  slide'_j =
        # h_j + (const - p*V), pivot' = const.
        recentre = const - self.pivot_value * total_vol
        return ChebyshevSlider._assemble(
            num_dimensions=len(kept_dims),
            domain=[list(self.domain[d]) for d in kept_dims],
            n_nodes=[self.n_nodes[d] for d in kept_dims],
            partition=[[remap[d] for d in kept] for _, _, kept in survivors],
            pivot_point=[self.pivot_point[d] for d in kept_dims],
            slides=[ChebyshevApproximation._from_grid(tmpl, vals + recentre)
                    for vals, tmpl, _ in survivors],
            pivot_value=const,
            max_derivative_order=self.max_derivative_order,
            device=self.device, descriptor=self.descriptor,
            additional_data=self.additional_data)

    def integrate_batch(self, bounds, dtype=None) -> np.ndarray:
        """Integrals over a batch of axis-aligned boxes, one dense
        batched integral per slide.

        The additive decomposition integrates term by term,

            int_box F = p*V*(1 - m) + sum_i V / V_{G_i} * int_{box_{G_i}} s_i

        with V the box measure, V_{G_i} the measure of the box restricted
        to group i, and each slide's restricted integral a dense
        :meth:`ChebyshevApproximation.integrate_batch` over all B boxes.
        Zero-measure boxes integrate to an exact 0.  ``bounds``:
        (B, d, 2); ``dtype`` as in the dense class.  Returns (B,).
        """
        if not self._built:
            raise RuntimeError("Call build() first")
        # Full-box integration is the no-remaining-dims case of the
        # conditional-expectation decomposition (which needs no 0/0
        # masking: off-group measures multiply instead of dividing).
        bounds = np.asarray(host_array(bounds), dtype=np.float64)
        return self.partial_integrate_batch(
            list(range(self.num_dimensions)), bounds,
            np.zeros((bounds.shape[0] if bounds.ndim else 0, 0)),
            dtype=dtype)

    def partial_integrate_batch(self, dims, bounds, points,
                                derivative_order=None,
                                dtype=None) -> np.ndarray:
        """Batched conditional expectations through the additive
        decomposition.

        With box measure ``V`` over the integrated ``dims`` and
        ``V_{S\\G_i}`` the measure over integrated dims OUTSIDE group i,

            int_box f(., pts) = p*V*(1 - m)
                                + sum_i V_{S\\G_i} * M_i(b)

        where ``M_i`` integrates slide i over its in-box group dims and
        evaluates its remaining group dims at the scenario coordinates
        (a dense :meth:`partial_integrate_batch` / ``eval_batch``).
        Derivatives on remaining dims route to the owning slide; a mixed
        partial across groups is exactly 0.

        ``bounds``: (B, len(dims), 2) in sorted ``dims`` order;
        ``points``: (B, d - len(dims)) ascending remaining-dim order;
        ``derivative_order``: per-remaining-dim orders or None.
        Returns (B,).
        """
        if not self._built:
            raise RuntimeError("Call build() first")
        dims, arr, remaining, pts, rem_orders = \
            validate_partial_integrate_args_batch(
                self.num_dimensions, self.domain, dims, host_array(bounds),
                host_array(points), derivative_order,
                max_order=self.max_derivative_order)
        int_set = set(dims)
        col_of = {k: i for i, k in enumerate(dims)}
        pcol_of = {k: i for i, k in enumerate(remaining)}
        order_of = {k: int(o) for k, o in zip(remaining, rem_orders)}
        widths = arr[..., 1] - arr[..., 0]
        vol = np.prod(widths, axis=1)
        n_rows = arr.shape[0]

        deriv_dims = {k for k, o in order_of.items() if o}
        if deriv_dims:
            owners = {self._dim_to_slide[k] for k in deriv_dims}
            if len(owners) > 1:
                # Cross-group mixed partials of an additive sum vanish.
                return np.zeros(n_rows)
            slide_ids = [owners.pop()]
            total = np.zeros(n_rows)
        else:
            slide_ids = list(range(len(self.slides)))
            total = self.pivot_value * vol * (1.0 - len(self.slides))

        for i in slide_ids:
            group = self.partition[i]
            slide = self.slides[i]
            g_int = [j for j, k in enumerate(group) if k in int_set]
            g_eval = [j for j, k in enumerate(group) if k not in int_set]
            off_cols = [col_of[k] for k in dims if k not in set(group)]
            v_off = (np.prod(widths[:, off_cols], axis=1)
                     if off_cols else np.ones(n_rows))
            sub_pts = pts[:, [pcol_of[group[j]] for j in g_eval]]
            sub_orders = [order_of[group[j]] for j in g_eval]
            if g_int:
                sub_bounds = arr[:, [col_of[group[j]] for j in g_int], :]
                part = slide.partial_integrate_batch(
                    g_int, sub_bounds, sub_pts,
                    derivative_order=sub_orders, dtype=dtype)
            else:
                part = slide.vectorized_eval_batch(sub_pts, sub_orders)
            total = total + v_off * part
        return total

    # ------------------------------------------------------------------
    # 1-D reduction + roots / optimization
    # ------------------------------------------------------------------

    def _to_1d_chebyshev(self, sliced_1d: "ChebyshevSlider"):
        """Resample a 1-D slider at its Chebyshev nodes into a dense 1-D
        approximation on this device."""
        assert sliced_1d.num_dimensions == 1
        n = sliced_1d.n_nodes[0]
        a, b = sliced_1d.domain[0]
        cheb_nodes = nodes_for_dim_np(a, b, int(n))
        values = sliced_1d.eval_batch(cheb_nodes[:, None])
        return ChebyshevApproximation.from_values(
            values, num_dimensions=1, domain=[(float(a), float(b))],
            n_nodes=[int(n)], device=self.device)

    def _sliced_1d(self, dim, fixed):
        dim, slice_params = validate_calculus_args(
            self.num_dimensions, dim, fixed, self.domain)
        return self._to_1d_chebyshev(
            self.slice(slice_params) if slice_params else self)

    def roots(self, dim=None, fixed=None):
        """Roots along *dim*: slice to 1-D, resample, colleague matrix."""
        if not self._built:
            raise RuntimeError("Call build() first")
        return self._sliced_1d(dim, fixed).roots()

    def minimize(self, dim=None, fixed=None, *, tol=1e-9,
                 max_boxes=5000, polish=True):
        """Minimum of the slider.

        With ``dim``: the 1-D minimum along that dim — ``(value,
        location)`` floats.  With ``dim=None`` on a multi-dimensional
        slider: the GLOBAL minimum over the whole box — EXACT under the
        additive decomposition (the sum of per-slide global minima;
        cross-group curvature is zero), each slide solved by the
        certified branch-and-bound of ``ops.subdivision``.  Returns
        ``(value, point)`` with an ``(ndim,)`` point; ``fixed`` may pin
        a subset of dims.
        """
        return self._optimize(dim, fixed, "min", tol=tol,
                              max_boxes=max_boxes, polish=polish)

    def maximize(self, dim=None, fixed=None, *, tol=1e-9,
                 max_boxes=5000, polish=True):
        """Maximum of the slider — see :meth:`minimize` for the 1-D
        (``dim`` given) vs exact-global (``dim=None``) forms."""
        return self._optimize(dim, fixed, "max", tol=tol,
                              max_boxes=max_boxes, polish=polish)

    def critical_points(self, fixed=None, *, grad_tol=1e-8, delta=5e-3,
                        max_boxes=50000, separation=1e-6,
                        max_points=10000):
        """All interior stationary points — EXACT under the additive
        decomposition: the cartesian product of per-slide stationary
        sets, classified from the block-diagonal Hessian.  See
        ``ChebyshevApproximation.critical_points``."""
        if not self._built:
            raise RuntimeError("Call build() first")
        return globalcalc.critical_points_slider(
            self, fixed=fixed, grad_tol=grad_tol, delta=delta,
            max_boxes=max_boxes, separation=separation,
            max_points=max_points)

    def _optimize(self, dim, fixed, mode, *, tol=1e-9, max_boxes=5000,
                  polish=True):
        if not self._built:
            raise RuntimeError("Call build() first")
        if dim is None and self.num_dimensions > 1:
            return globalcalc.global_optimize_slider(
                self, mode, fixed, tol=tol, max_boxes=max_boxes,
                polish=polish)
        one_d = self._sliced_1d(dim, fixed)
        return one_d.minimize() if mode == "min" else one_d.maximize()

    def _scenario_slice_values(self, dim, fixed_cols, batch):
        """(B, n) slice values along *dim*: one batched evaluation at the
        dim's own nodes (exact: the sliding sum is a polynomial in
        *dim*), then to the host."""
        lo, hi = self.domain[dim]
        n = int(self.n_nodes[dim])
        nodes = nodes_for_dim_np(float(lo), float(hi), n)
        pts = scenario_slice_points(
            self.num_dimensions, dim, fixed_cols, batch, nodes)
        vals = self.eval_batch(pts)
        return vals.reshape(batch, n), nodes, (float(lo), float(hi))

    def roots_batch(self, dim=None, fixed=None) -> list:
        """Roots along *dim* for a batch of scenarios (scalar or (B,)
        arrays in ``fixed``): a list of B sorted root arrays; one
        batched evaluation plus one stacked colleague eigensolve."""
        if not self._built:
            raise RuntimeError("Call build() first")
        dim, cols, batch = validate_calculus_args_batch(
            self.num_dimensions, dim, fixed, self.domain)
        vals, _, dom = self._scenario_slice_values(dim, cols, batch)
        return roots_1d_batch(vals, dom)

    def minimize_batch(self, dim=None, fixed=None):
        """Batched :meth:`minimize`: ((B,) values, (B,) locations)."""
        return self._optimize_batch(dim, fixed, "min")

    def maximize_batch(self, dim=None, fixed=None):
        """Batched :meth:`maximize`: ((B,) values, (B,) locations)."""
        return self._optimize_batch(dim, fixed, "max")

    def _optimize_batch(self, dim, fixed, mode):
        if not self._built:
            raise RuntimeError("Call build() first")
        dim, cols, batch = validate_calculus_args_batch(
            self.num_dimensions, dim, fixed, self.domain)
        vals, nodes, dom = self._scenario_slice_values(dim, cols, batch)
        return optimize_resampled_batch(vals, nodes, dom, mode)

    # ------------------------------------------------------------------
    # Algebra
    # ------------------------------------------------------------------

    def _check_slider_compatible(self, other):
        check_compatible(self, other)
        if self.partition != other.partition:
            raise ValueError(
                f"Partition mismatch: {self.partition} vs {other.partition}"
            )
        if self.pivot_point != other.pivot_point:
            raise ValueError(
                f"Pivot point mismatch: {self.pivot_point} vs "
                f"{other.pivot_point}"
            )

    def _combined(self, other, op):
        self._check_slider_compatible(other)
        slides = [ChebyshevApproximation._from_grid(
            a, op(a.tensor_values, b.tensor_values.to(a.device)))
            for a, b in zip(self.slides, other.slides)]
        return ChebyshevSlider._from_slides(
            self, slides, op(self.pivot_value, other.pivot_value))

    def __add__(self, other):
        if type(self) is not type(other):
            return NotImplemented
        return self._combined(other, lambda a, b: a + b)

    def __sub__(self, other):
        if type(self) is not type(other):
            return NotImplemented
        return self._combined(other, lambda a, b: a - b)

    def __mul__(self, scalar):
        if not is_scalar(scalar):
            return NotImplemented
        s = float(scalar)
        slides = [ChebyshevApproximation._from_grid(sl, sl.tensor_values * s)
                  for sl in self.slides]
        return ChebyshevSlider._from_slides(self, slides,
                                            self.pivot_value * s)

    def __rmul__(self, scalar):
        return self.__mul__(scalar)

    def __truediv__(self, scalar):
        if not is_scalar(scalar):
            return NotImplemented
        return self.__mul__(1.0 / float(scalar))

    def __neg__(self):
        return self.__mul__(-1.0)

    # The in-place forms rebind each slide's tensor to a new one.
    def __iadd__(self, other):
        self._check_slider_compatible(other)
        for a, b in zip(self.slides, other.slides):
            a.tensor_values = a.tensor_values + b.tensor_values.to(a.device)
            a._cached_error_estimate = None
        self.pivot_value += other.pivot_value
        self._cached_error_estimate = None
        return self

    def __isub__(self, other):
        self._check_slider_compatible(other)
        for a, b in zip(self.slides, other.slides):
            a.tensor_values = a.tensor_values - b.tensor_values.to(a.device)
            a._cached_error_estimate = None
        self.pivot_value -= other.pivot_value
        self._cached_error_estimate = None
        return self

    def __imul__(self, scalar):
        if not is_scalar(scalar):
            return NotImplemented
        s = float(scalar)
        for sl in self.slides:
            sl.tensor_values = sl.tensor_values * s
            sl._cached_error_estimate = None
        self.pivot_value *= s
        self._cached_error_estimate = None
        return self

    def __itruediv__(self, scalar):
        if not is_scalar(scalar):
            return NotImplemented
        return self.__imul__(1.0 / float(scalar))

    # ------------------------------------------------------------------
    # Printing
    # ------------------------------------------------------------------

    # ------------------------------------------------------------------
    # Sensitivity and plots
    # ------------------------------------------------------------------

    def sobol_indices(self) -> dict:
        """Analytic Sobol indices from the additive decomposition.

        The slider form f ~ const + sum_G g_G(x_G) with independent
        inputs makes cross-group interactions exactly zero, so the
        global variance is the sum of per-slide variances and each
        slide's internal Sobol structure (``utils.sensitivity``) scales
        by V_G / V_total.  Indices are keyed by original dim index.
        """
        if not self._built:
            raise RuntimeError("Call build() before sobol_indices().")
        from pychebyshev_tpu_torch.utils.sensitivity import (
            chebyshev_coefficient_tensor,
            sobol_from_coeffs,
        )
        per_slide = [
            sobol_from_coeffs(
                chebyshev_coefficient_tensor(slide.tensor_values),
                len(group))
            for group, slide in zip(self.partition, self.slides)
        ]
        # sobol_from_coeffs variances carry the unnormalized Chebyshev
        # measure mass pi^{ndim of that tensor}; divide it out so slides
        # over different group sizes combine consistently.
        v_norm = [res["variance"] / np.pi ** len(group)
                  for group, res in zip(self.partition, per_slide)]
        v_total_norm = sum(v_norm)
        first = {}
        total = {}
        for group, res, v in zip(self.partition, per_slide, v_norm):
            scale = v / v_total_norm if v_total_norm > 0 else 0.0
            for j, d in enumerate(group):
                first[d] = res["first_order"][j] * scale
                total[d] = res["total_order"][j] * scale
        return {
            "first_order": dict(sorted(first.items())),
            "total_order": dict(sorted(total.items())),
            # report in the dense convention (mass pi^num_dimensions)
            "variance": v_total_norm * np.pi ** self.num_dimensions,
        }

    def interaction_matrix(self) -> np.ndarray:
        """(d, d) pure pairwise Sobol interaction shares.  Cross-group
        entries are EXACTLY zero by the additive form; within a
        multi-dim group the slide's own pair shares scale by its
        variance fraction."""
        if not self._built:
            raise RuntimeError("Call build() first")
        from pychebyshev_tpu_torch.utils.sensitivity import (
            chebyshev_coefficient_tensor,
            pair_interactions_from_coeffs,
        )
        out = np.zeros((self.num_dimensions, self.num_dimensions))
        v_norm = []
        slide_pairs = []
        for group, slide in zip(self.partition, self.slides):
            coeffs = chebyshev_coefficient_tensor(slide.tensor_values)
            pairs, variance = pair_interactions_from_coeffs(
                coeffs, len(group), return_variance=True)
            v_norm.append(variance / np.pi ** len(group))
            slide_pairs.append(pairs)
        v_total = sum(v_norm)
        if v_total <= 0:
            return out
        for group, pairs, v in zip(self.partition, slide_pairs, v_norm):
            scale = v / v_total
            for a, da in enumerate(group):
                for b, db in enumerate(group):
                    out[da, db] = pairs[a, b] * scale
        return out

    def suggest_partition(self, threshold: float = 1e-8) -> list:
        """Additive partition implied by :meth:`interaction_matrix`.
        Never coarser than the slider's own partition, but it can be
        FINER, when a multi-dim group's dims turn out not to interact
        within the slide."""
        from pychebyshev_tpu_torch.utils.sensitivity import (
            partition_from_interactions,
        )
        return partition_from_interactions(self.interaction_matrix(),
                                           threshold)

    def plot_1d(self, ax=None, n_points=200, fixed=None):
        """1-D slice plot (requires matplotlib)."""
        from pychebyshev_tpu_torch.utils.viz import plot_1d_impl
        return plot_1d_impl(self, ax=ax, n_points=n_points, fixed=fixed)

    def plot_2d_surface(self, ax=None, n_points=50, fixed=None):
        """2-D surface plot (requires matplotlib)."""
        from pychebyshev_tpu_torch.utils.viz import plot_2d_surface_impl
        return plot_2d_surface_impl(self, ax=ax, n_points=n_points,
                                    fixed=fixed)

    def plot_2d_contour(self, ax=None, n_points=50, n_levels=20, fixed=None):
        """2-D contour plot (requires matplotlib)."""
        from pychebyshev_tpu_torch.utils.viz import plot_2d_contour_impl
        return plot_2d_contour_impl(self, ax=ax, n_points=n_points,
                                    n_levels=n_levels, fixed=fixed)

    def __repr__(self) -> str:
        return (f"ChebyshevSlider(dims={self.num_dimensions}, "
                f"slides={len(self.partition)}, "
                f"partition={self.partition}, built={self._built}, "
                f"device={self.device})")

    def __str__(self) -> str:
        status = "built" if self._built else "not built"
        full_tensor_evals = int(np.prod(self.n_nodes))
        max_display = 6

        def _fmt(seq):
            if len(seq) > max_display:
                return ("[" + ", ".join(str(v) for v in seq[:max_display])
                        + ", ...]")
            return str(seq)

        if self.num_dimensions > max_display:
            domain_str = (" x ".join(
                f"[{lo}, {hi}]" for lo, hi in self.domain[:max_display])
                + " x ...")
        else:
            domain_str = " x ".join(f"[{lo}, {hi}]"
                                    for lo, hi in self.domain)

        lines = [
            f"ChebyshevSlider ({self.num_dimensions}D, "
            f"{len(self.partition)} slides, {status})",
            f"  Partition: {_fmt(self.partition)}",
            f"  Pivot:     {_fmt(self.pivot_point)}",
            f"  Nodes:     {_fmt(self.n_nodes)} "
            f"({self.total_build_evals:,} vs {full_tensor_evals:,} full "
            f"tensor)",
            f"  Domain:    {domain_str}",
        ]
        if self._built and self.slides:
            lines.append(f"  Error est: {self.error_estimate():.2e}")
            lines.append("  Slides:")
            for i, (group, slide) in enumerate(zip(self.partition,
                                                   self.slides)):
                slide_evals = int(np.prod([self.n_nodes[d] for d in group]))
                lines.append(f"    [{i}] dims {group}: {slide_evals:,} "
                             f"evals, built in {slide.build_time:.3f}s")
        return "\n".join(lines)


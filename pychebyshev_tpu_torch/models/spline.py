"""ChebyshevSpline: piecewise Chebyshev interpolation at user knots, on
PyTorch.

The port of ``pychebyshev_tpu.models.spline`` (serving surface).  The
domain is cut at interior knots into a Cartesian grid of pieces, each an
independent :class:`ChebyshevApproximation` on ``device``, which
restores spectral convergence across kinks.

- Single points route to their piece on the host and run through the
  piece's host path (the C kernels of ``cpp/hosteval.c`` where the
  library builds).
- Batches route in f64 on the device (``ops.spline_eval``), then each
  occupied piece evaluates its own points (the routed route; the card's
  sweep found the masked route slower at f64 for every piece count
  above one).  A point on a knot belongs to the right piece.

Batched results: ``eval_batch_device`` and ``eval_batch_dd`` return
tensors on the device; ``eval_batch`` and the ``vectorized_*`` spellings
return NumPy arrays.

Calculus runs piece by piece through the dense class: integrals clip
every box to every piece, conditional expectations route the remaining
dims as batches do, roots and 1-D optima merge the pieces' answers.

``fit`` routes scattered samples to their pieces on the host (with
``ops.spline_eval``'s routing: a point on a knot belongs to the right
piece) and fits
each piece through ``utils.fitting``.  The Sobol family aggregates the
pieces by volume x variance; ``compose`` and ``hadamard`` work piece by
piece; the plots and the ``.npz`` format are the dense class's.
The certified global ``minimize``/``maximize`` (``dim=None``) search
each piece with one shared incumbent, and ``critical_points`` merges
the pieces' stationary points (``utils.globalcalc``).

``fit(mesh=)`` accumulates every piece's normal equations
data-parallel over a device mesh (``utils.fitting``).
"""

from __future__ import annotations

import itertools
import os
import pickle
import time
import warnings
from typing import List, Tuple

import numpy as np
import torch

from pychebyshev_tpu_torch.config import NODE_COINCIDENCE_TOL
from pychebyshev_tpu_torch.models.approximation import (
    ChebyshevApproximation,
    _private_f64,
)
from pychebyshev_tpu_torch.ops import spline_eval
from pychebyshev_tpu_torch.ops.chebyshev import nodes_for_dim_np
from pychebyshev_tpu_torch.ops.integrate import host_array
from pychebyshev_tpu_torch.utils.algebra import check_compatible, is_scalar
from pychebyshev_tpu_torch.utils.calculus import (
    normalize_bounds,
    optimize_1d,
    optimize_resampled_batch,
    roots_1d,
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

__all__ = ["ChebyshevSpline", "is_nested_n_nodes"]


def _merged_roots(chunks, domain) -> np.ndarray:
    """Sorted roots of the pieces, neighbours closer than 1e-10 of the
    dim's scale collapsed (a root on a knot is found by both pieces)."""
    if not chunks:
        return np.array([], dtype=float)
    combined = np.sort(np.concatenate(chunks))
    if len(combined) > 1:
        scale = abs(domain[1] - domain[0]) + 1
        combined = combined[np.concatenate(
            [[True], np.diff(combined) > 1e-10 * scale])]
    return combined


def is_nested_n_nodes(n_nodes) -> bool:
    """True if n_nodes is in nested (per-sub-interval) form."""
    return n_nodes is not None and any(
        isinstance(x, (list, tuple)) for x in n_nodes
    )


def _check_orders(orders, num_dimensions) -> Tuple[int, ...]:
    orders = tuple(int(o) for o in orders)
    if len(orders) != num_dimensions:
        raise ValueError(
            f"derivative_order length {len(orders)} does not match "
            f"num_dimensions {num_dimensions}"
        )
    return orders


class ChebyshevSpline:
    """Piecewise Chebyshev interpolation with user-specified knots.

    Parameters mirror the JAX package's constructor: flat or nested
    (per-piece) ``n_nodes``, per-dim ``knots``, auto-N via
    ``error_threshold``, ``defer_build``, and ``vectorized`` (forwarded
    to every piece).  ``device`` (required, keyword-only) places every
    piece's tensors.
    """

    def __init__(self, function, num_dimensions, domain, n_nodes=None,
                 knots=None, max_derivative_order=2, error_threshold=None,
                 max_n=64, additional_data=None, *, device,
                 defer_build=False, n_workers=None, vectorized=False):
        from pychebyshev_tpu_torch import Domain, Ns
        from pychebyshev_tpu_torch.utils.parallel_build import (
            normalize_n_workers,
        )

        if isinstance(domain, Domain):
            domain = list(domain.bounds)
        if isinstance(n_nodes, Ns):
            n_nodes = list(n_nodes.counts)

        self.device = torch.device(device)
        self.function = function
        self.num_dimensions = num_dimensions
        self.domain = [list(b) for b in domain]
        self.error_threshold = error_threshold
        if max_n < 3:
            raise ValueError(
                f"max_n must be at least 3 (the initial N of the doubling "
                f"loop), got max_n={max_n}. For a grid smaller than 3 per "
                f"dimension, pass n_nodes explicitly instead of using "
                f"error-threshold auto-calibration."
            )
        self.max_n = max_n
        self.n_workers = normalize_n_workers(n_workers)
        self.vectorized = bool(vectorized)

        if n_nodes is None:
            if error_threshold is None:
                raise ValueError(
                    "Must provide either n_nodes (explicit) or "
                    "error_threshold (auto-N). Got neither."
                )
            n_nodes = [None] * num_dimensions
        else:
            n_nodes = list(n_nodes)
            if any(n is None for n in n_nodes) and error_threshold is None:
                raise ValueError(
                    "None entries in n_nodes require error_threshold to be "
                    "set (auto-N mode)."
                )

        self._n_nodes_nested = is_nested_n_nodes(n_nodes)
        if self._n_nodes_nested:
            if not all(isinstance(x, (list, tuple)) for x in n_nodes):
                raise ValueError(
                    "n_nodes must be fully nested (all dims as lists) when "
                    "any dim is nested; got mixed form"
                )

        self.n_nodes = n_nodes
        if knots is None:
            knots = [[] for _ in range(num_dimensions)]
        self.knots = [list(k) for k in knots]
        self.max_derivative_order = max_derivative_order
        self.additional_data = additional_data
        self._derivative_id_registry: dict = {}
        self._derivative_id_to_orders: list = []
        self.descriptor: str = ""

        for d in range(num_dimensions):
            lo, hi = domain[d]
            for k in self.knots[d]:
                if not (lo < k < hi):
                    raise ValueError(
                        f"Knot {k} for dimension {d} is not strictly "
                        f"inside domain [{lo}, {hi}]"
                    )
            if self.knots[d] != sorted(self.knots[d]):
                raise ValueError(f"Knots for dimension {d} must be sorted")
            if len(set(self.knots[d])) != len(self.knots[d]):
                raise ValueError(
                    f"Knots for dimension {d} contain duplicates")

        self._intervals = self._compute_intervals(num_dimensions, domain,
                                                  self.knots)
        self._shape = tuple(len(iv) for iv in self._intervals)

        if self._n_nodes_nested:
            for d in range(num_dimensions):
                expected = len(self.knots[d]) + 1
                if len(n_nodes[d]) != expected:
                    raise ValueError(
                        f"n_nodes[{d}] must have {expected} entries "
                        f"(one per sub-interval); got {len(n_nodes[d])}"
                    )
                inner = list(n_nodes[d])
                if any(x is None for x in inner) and error_threshold is None:
                    raise ValueError(
                        "None entries in nested n_nodes require "
                        "error_threshold to be set (auto-N mode)."
                    )
                n_nodes[d] = inner
            self.n_nodes = n_nodes

        self._pieces: List[ChebyshevApproximation | None] = (
            [None] * int(np.prod(self._shape)))
        self._built = False
        self._build_time = 0.0
        self._cached_error_estimate = None

        if defer_build:
            if function is not None:
                raise ValueError(
                    "defer_build=True requires function=None (the "
                    "deferred-construction workflow expects values to be "
                    "supplied via set_original_function_values() later)"
                )
            for flat_idx, multi_idx in enumerate(self._piece_indices()):
                self._pieces[flat_idx] = ChebyshevApproximation(
                    None, self.num_dimensions, self._sub_domain(multi_idx),
                    self._piece_n_nodes(multi_idx),
                    max_derivative_order=self.max_derivative_order,
                    additional_data=self.additional_data,
                    device=self.device, defer_build=True,
                    n_workers=self.n_workers,
                )

    def _piece_indices(self):
        return itertools.product(*[range(s) for s in self._shape])

    def _sub_domain(self, multi_idx):
        return [list(self._intervals[d][multi_idx[d]])
                for d in range(self.num_dimensions)]

    def _piece_n_nodes(self, multi_idx):
        if self._n_nodes_nested:
            return [self.n_nodes[d][multi_idx[d]]
                    for d in range(self.num_dimensions)]
        return list(self.n_nodes)

    # ------------------------------------------------------------------
    # Build / deferred construction
    # ------------------------------------------------------------------

    def set_original_function_values(self, per_piece_values) -> None:
        """Fill every piece's tensor atomically (all validated first)."""
        if len(per_piece_values) != len(self._pieces):
            raise ValueError(
                f"expected {len(self._pieces)} piece tensors, "
                f"got {len(per_piece_values)}"
            )
        validated = []
        for i, (piece, vals) in enumerate(zip(self._pieces,
                                              per_piece_values)):
            if piece is None:
                raise RuntimeError(f"piece {i} is None — invalid state")
            if piece.tensor_values is not None:
                raise RuntimeError(
                    f"piece {i} is already constructed; "
                    "set_original_function_values() is for defer_build=True "
                    "splines"
                )
            arr = np.asarray(vals, dtype=np.float64)
            expected_shape = tuple(piece.n_nodes)
            if arr.shape != expected_shape:
                raise ValueError(
                    f"piece {i}: values shape {arr.shape} does not match "
                    f"expected {expected_shape}"
                )
            if not np.isfinite(arr).all():
                raise ValueError(
                    f"piece {i}: values contains NaN or Inf (must be finite)"
                )
            validated.append(arr)
        for piece, arr in zip(self._pieces, validated):
            piece.tensor_values = _private_f64(arr, piece.device)
            piece._offer_host_tensor(arr)
            piece.function = None
        self._built = True
        self.function = None

    def build(self, verbose: bool | int = True) -> None:
        """Build every piece on its sub-domain."""
        if self.function is None:
            raise RuntimeError(
                "Cannot build: no function assigned. "
                "This object was created via from_values() or load()."
            )
        start = time.time()
        self._cached_error_estimate = None
        total_pieces = int(np.prod(self._shape))
        if verbose:
            print(f"Building {self.num_dimensions}D Chebyshev Spline "
                  f"({total_pieces} pieces)...")
        from pychebyshev_tpu_torch.utils.progress import progress_iter

        for flat_idx, multi_idx in enumerate(progress_iter(
                self._piece_indices(), total=total_pieces,
                enabled=(verbose == 2), desc="Building spline pieces")):
            sub_domain = self._sub_domain(multi_idx)
            piece = ChebyshevApproximation(
                self.function, self.num_dimensions, sub_domain,
                self._piece_n_nodes(multi_idx),
                max_derivative_order=self.max_derivative_order,
                error_threshold=self.error_threshold, max_n=self.max_n,
                additional_data=self.additional_data, device=self.device,
                n_workers=self.n_workers, vectorized=self.vectorized,
            )
            piece.build(verbose=False)
            self._pieces[flat_idx] = piece
            if verbose:
                print(f"  Piece {flat_idx + 1}/{total_pieces}: "
                      f"domain {sub_domain}, n_nodes={piece.n_nodes}")

        self._build_time = time.time() - start
        self._built = True
        # Auto-N: when every piece landed on the same counts, record them
        # as the flat n_nodes; pieces that resolved differently keep the
        # None sentinels and stay off an f32 engine's masked route.
        if (self.error_threshold is not None
                and not is_nested_n_nodes(self.n_nodes)
                and any(n is None for n in self.n_nodes)):
            counts = {tuple(p.n_nodes) for p in self._pieces}
            if len(counts) == 1:
                self.n_nodes = [int(n) for n in counts.pop()]
        if verbose:
            print(f"Build complete in {self._build_time:.3f}s")

    # ------------------------------------------------------------------
    # Piece routing + evaluation
    # ------------------------------------------------------------------

    def _pieces_stackable(self) -> bool:
        """Whether an f32 engine's masked route may stack the pieces:
        flat n_nodes
        spelling AND homogeneous piece grids (an auto-N build can resolve
        pieces to different counts under a flat spelling)."""
        if is_nested_n_nodes(self.n_nodes):
            return False
        return len({tuple(p.n_nodes) for p in self._pieces}) == 1

    def _find_piece(self, point):
        """(flat_idx, piece) containing *point*; a point on a knot routes
        to the right piece (searchsorted side='right')."""
        multi_idx = []
        for d in range(self.num_dimensions):
            if len(self.knots[d]) == 0:
                multi_idx.append(0)
            else:
                idx = int(np.searchsorted(self.knots[d], point[d],
                                          side="right"))
                multi_idx.append(min(idx, self._shape[d] - 1))
        flat = int(np.ravel_multi_index(multi_idx, self._shape))
        return flat, self._pieces[flat]

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

    def _check_knot_boundary(self, point, derivative_order) -> None:
        """Derivatives at a knot are ill-defined (left/right differ)."""
        if all(d == 0 for d in derivative_order):
            return
        for d in range(self.num_dimensions):
            if derivative_order[d] > 0:
                for k in self.knots[d]:
                    if abs(point[d] - k) < NODE_COINCIDENCE_TOL:
                        raise ValueError(
                            f"Derivative w.r.t. dimension {d} is not "
                            f"defined at knot x[{d}]={k}. The left and "
                            f"right derivatives may differ at this point."
                        )

    def eval(self, point, derivative_order=None, *, derivative_id=None):
        """Evaluate at a point on the host (routes to the containing
        piece)."""
        if not self._built:
            raise RuntimeError("Call build() before eval().")
        derivative_order = self._resolve_derivative_args(
            derivative_order, derivative_id)
        self._check_knot_boundary(point, derivative_order)
        _, piece = self._find_piece(point)
        return piece.vectorized_eval(point, derivative_order)

    def eval_multi(self, point, derivative_orders):
        """Multiple derivative specs at one point (shared weights)."""
        if not self._built:
            raise RuntimeError("Call build() before eval_multi().")
        for do in derivative_orders:
            self._check_knot_boundary(point, do)
        _, piece = self._find_piece(point)
        return piece.vectorized_eval_multi(point, derivative_orders)

    def _points(self, points) -> torch.Tensor:
        pts = torch.as_tensor(points, dtype=torch.float64,
                              device=self.device)
        if pts.dim() != 2 or pts.shape[1] != self.num_dimensions:
            raise ValueError(
                f"points must have shape (N, {self.num_dimensions}), "
                f"got {tuple(pts.shape)}")
        return pts

    def _flat(self, pts: torch.Tensor) -> torch.Tensor:
        return spline_eval.route_piece_indices(
            self.knots, spline_eval.piece_strides(
                [len(k) for k in self.knots]), pts)

    def _piece_arrays(self):
        return [(p.tensor_values,) + p._grid_tuples() for p in self._pieces]

    def eval_batch_device(self, points, derivative_order=None, *,
                          derivative_id=None) -> torch.Tensor:
        """Batched f64 evaluation, result left on the device: points
        grouped by piece, each occupied piece on its own points
        (``ops.spline_eval.routed_eval_batch``)."""
        if not self._built:
            raise RuntimeError("Call build() before eval_batch().")
        orders = _check_orders(self._resolve_derivative_args(
            derivative_order, derivative_id), self.num_dimensions)
        pts = self._points(points)
        return spline_eval.routed_eval_batch(self._piece_arrays(),
                                             self._flat(pts), pts, orders)

    def eval_batch(self, points, derivative_order=None, *,
                   derivative_id=None) -> np.ndarray:
        """Batched f64 evaluation: (N, d) points -> (N,) NumPy values."""
        return self.eval_batch_device(
            points, derivative_order,
            derivative_id=derivative_id).cpu().numpy()

    def eval_batch_dd(self, points, derivative_order=None,
                      mode: str = "accurate") -> torch.Tensor:
        """Near-f64 batched evaluation, result left on the device.

        Points route to their pieces on the device (f64, the same rule
        as :meth:`eval_batch`); each occupied piece evaluates its points
        through the dense dd tier (``ChebyshevApproximation.
        eval_batch_dd``: on a CUDA device the f64 kernel wherever
        ``supports_fused_dd`` covers the piece grid).  Pieces outside the
        tier's plan, and points outside a piece's sub-domain, take the
        f64 path per piece, as in the reference.
        """
        if not self._built:
            raise RuntimeError("Call build() before eval_batch_dd().")
        if mode not in ("accurate", "fast"):
            raise ValueError(
                f"mode must be 'accurate' or 'fast', got {mode!r}")
        if derivative_order is None:
            derivative_order = [0] * self.num_dimensions
        orders = _check_orders(derivative_order, self.num_dimensions)
        pts = self._points(points)
        return spline_eval.routed_apply(
            self._flat(pts), pts,
            lambda i, p: self._pieces[i].eval_batch_dd(p, orders,
                                                       mode=mode))

    def vectorized_eval_batch_multi(self, points, derivative_orders
                                    ) -> np.ndarray:
        """Batch x multi-spec evaluation -> (N, len(derivative_orders))
        NumPy array: each occupied piece's rows shared across the specs,
        routed as in :meth:`eval_batch`.  A point on a knot takes the
        right piece's one-sided derivatives."""
        if not self._built:
            raise RuntimeError(
                "Call build() before vectorized_eval_batch_multi()."
            )
        orders_list = tuple(_check_orders(o, self.num_dimensions)
                            for o in derivative_orders)
        pts = self._points(points)
        if not orders_list:
            return np.zeros((pts.shape[0], 0))
        return spline_eval.routed_eval_batch_multi(
            self._piece_arrays(), self._flat(pts), pts,
            orders_list).cpu().numpy()

    vectorized_eval = eval
    vectorized_eval_multi = eval_multi
    vectorized_eval_batch = eval_batch
    eval_batch_multi = vectorized_eval_batch_multi

    # ------------------------------------------------------------------
    # Error estimation + properties
    # ------------------------------------------------------------------

    def error_estimate(self, tail: int = 1) -> float:
        """Max over pieces (disjoint sub-domains: the worst one governs)."""
        if not self._built:
            raise RuntimeError("Call build() before error_estimate().")
        if tail == 1 and self._cached_error_estimate is not None:
            return self._cached_error_estimate
        est = max(piece.error_estimate(tail) for piece in self._pieces)
        if tail == 1:
            self._cached_error_estimate = est
        return est

    @property
    def num_pieces(self) -> int:
        """Total pieces (Cartesian product of per-dim interval counts)."""
        return int(np.prod(self._shape))

    @property
    def total_build_evals(self) -> int:
        """Total function evaluations across pieces (0 if unknowable)."""
        if self._built:
            return sum(int(p.n_evaluations) for p in self._pieces)
        if self._n_nodes_nested:
            total = 0
            for multi_idx in self._piece_indices():
                piece_n = self._piece_n_nodes(multi_idx)
                if any(n is None for n in piece_n):
                    return 0
                total += int(np.prod(piece_n))
            return total
        if any(n is None for n in self.n_nodes):
            return 0
        return int(np.prod(self.n_nodes)) * int(np.prod(self._shape))

    @property
    def build_time(self) -> float:
        """Wall-clock seconds of the most recent build()."""
        return self._build_time

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

    def _move_to(self, device) -> None:
        self.device = torch.device(device)
        for p in self._pieces:
            p._move_to(device)

    def is_construction_finished(self) -> bool:
        """True iff this spline is built and usable."""
        return self._built

    def get_constructor_type(self) -> str:
        """Class name."""
        return type(self).__name__

    def get_used_ns(self) -> list:
        """Per-dim n_nodes preserving nested vs flat shape."""
        return [list(piece) if isinstance(piece, list) else piece
                for piece in self.n_nodes]

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

    @staticmethod
    def is_dimensionality_allowed(num_dimensions: int) -> bool:
        """Whether this class supports ``num_dimensions`` (any >= 1)."""
        return isinstance(num_dimensions, int) and num_dimensions >= 1

    def get_error_threshold(self):
        """The error_threshold ctor kwarg, or None."""
        return self.error_threshold

    def get_num_evaluation_points(self) -> int:
        """Grid points summed across pieces."""
        return int(sum(int(np.prod(p.n_nodes)) for p in self._pieces))

    def get_evaluation_points(self) -> np.ndarray:
        """Concatenated per-piece grids (pieces in C-order)."""
        return np.concatenate(
            [p.get_evaluation_points() for p in self._pieces], axis=0)

    def clone(self) -> "ChebyshevSpline":
        """Independent deep copy (function not duplicated)."""
        import copy
        return copy.deepcopy(self)

    def get_special_points(self):
        """Per-dimension knot/kink locations."""
        return self.knots

    def save(self, path: str | os.PathLike, format: str = "pickle") -> None:
        """Save to pickle (default) or .pcb binary (flat n_nodes only)."""
        if not self._built:
            raise RuntimeError(
                "Cannot save an unbuilt ChebyshevSpline. Call build() first."
            )
        if format == "pickle":
            with open(path, "wb") as f:
                pickle.dump(self, f, protocol=pickle.HIGHEST_PROTOCOL)
        elif format == "binary":
            from pychebyshev_tpu_torch.utils import binary
            with open(path, "wb") as f:
                binary.write_spline(f, self)
        elif format == "npz":
            from pychebyshev_tpu_torch.utils.native_save import write_npz
            write_npz(path, self)
        else:
            raise ValueError(
                f"format must be 'pickle', 'binary', or 'npz'; "
                f"got {format!r}"
            )

    @classmethod
    def load(cls, path: str | os.PathLike, *, device) -> "ChebyshevSpline":
        """Load from pickle, ``.pcb`` or ``.npz`` (magic-sniffed) onto
        ``device``; only unpickle files this program wrote."""
        from pychebyshev_tpu_torch.utils import binary, native_save
        if binary.detect_format(path) == "binary":
            with open(path, "rb") as f:
                return binary.read_spline(f, device=device)
        if native_save.detect_npz(path):
            obj = native_save.read_npz(path, device=device)
            if not isinstance(obj, cls):
                raise TypeError(
                    f"Expected a {cls.__name__} checkpoint, got "
                    f"{type(obj).__name__}"
                )
            return obj
        with open(path, "rb") as f:
            obj = pickle.load(f)  # noqa: S301
        if not isinstance(obj, cls):
            raise TypeError(
                f"Expected a {cls.__name__} instance, got "
                f"{type(obj).__name__}"
            )
        obj._move_to(device)
        return obj

    # ------------------------------------------------------------------
    # Deferred-values workflow and factories
    # ------------------------------------------------------------------

    @staticmethod
    def nodes(num_dimensions, domain, n_nodes, knots) -> dict:
        """Per-piece grid info (flat n_nodes only)."""
        if is_nested_n_nodes(n_nodes):
            raise NotImplementedError(
                "ChebyshevSpline.nodes() accepts only flat n_nodes "
                "(one int per dim, shared across pieces). Nested "
                "per-sub-interval n_nodes is supported via __init__ "
                "but not via the nodes()/from_values() workflow."
            )
        ChebyshevSpline._validate_domain_knots(num_dimensions, domain, knots)
        intervals = ChebyshevSpline._compute_intervals(
            num_dimensions, domain, knots)
        piece_shape = tuple(len(iv) for iv in intervals)
        pieces_info = []
        for multi_idx in np.ndindex(*piece_shape):
            sub_domain = [intervals[d][multi_idx[d]]
                          for d in range(num_dimensions)]
            piece_nodes = ChebyshevApproximation.nodes(
                num_dimensions, [list(sd) for sd in sub_domain], n_nodes)
            pieces_info.append({
                "piece_index": multi_idx,
                "sub_domain": sub_domain,
                "nodes_per_dim": piece_nodes["nodes_per_dim"],
                "full_grid": piece_nodes["full_grid"],
                "shape": piece_nodes["shape"],
            })
        return {
            "pieces": pieces_info,
            "num_pieces": int(np.prod(piece_shape)),
            "piece_shape": piece_shape,
        }

    @staticmethod
    def _validate_domain_knots(num_dimensions, domain, knots):
        for d in range(num_dimensions):
            lo, hi = domain[d]
            if lo >= hi:
                raise ValueError(
                    f"domain[{d}]: lo={lo} must be strictly less than "
                    f"hi={hi}"
                )
            for k in knots[d]:
                if not (lo < k < hi):
                    raise ValueError(
                        f"Knot {k} for dimension {d} is not strictly "
                        f"inside domain [{lo}, {hi}]"
                    )
            if list(knots[d]) != sorted(knots[d]):
                raise ValueError(f"Knots for dimension {d} must be sorted")
            if len(knots[d]) != len(set(knots[d])):
                raise ValueError(
                    f"Knots for dimension {d} contain duplicates"
                )

    @staticmethod
    def _compute_intervals(num_dimensions, domain, knots):
        intervals = []
        for d in range(num_dimensions):
            lo, hi = domain[d]
            edges = [lo] + list(knots[d]) + [hi]
            intervals.append(
                [(edges[i], edges[i + 1]) for i in range(len(edges) - 1)]
            )
        return intervals

    @classmethod
    def from_values(cls, piece_values, num_dimensions, domain, n_nodes,
                    knots, max_derivative_order: int = 2, *,
                    device) -> "ChebyshevSpline":
        """Fully-built spline from per-piece pre-computed values."""
        if is_nested_n_nodes(n_nodes):
            raise NotImplementedError(
                "ChebyshevSpline.from_values() accepts only flat n_nodes "
                "(one int per dim, shared across pieces). Nested "
                "per-sub-interval n_nodes is supported via __init__ "
                "but not via the nodes()/from_values() workflow."
            )
        cls._validate_domain_knots(num_dimensions, domain, knots)
        intervals = cls._compute_intervals(num_dimensions, domain, knots)
        piece_shape = tuple(len(iv) for iv in intervals)
        total_pieces = int(np.prod(piece_shape))
        if len(piece_values) != total_pieces:
            raise ValueError(
                f"Expected {total_pieces} piece_values, got "
                f"{len(piece_values)}"
            )
        expected_shape = tuple(n_nodes)
        for flat_idx, pv in enumerate(piece_values):
            if tuple(np.shape(pv)) != expected_shape:
                raise ValueError(
                    f"piece_values[{flat_idx}] has shape "
                    f"{tuple(np.shape(pv))}, expected {expected_shape}"
                )
        pieces = []
        for flat_idx, multi_idx in enumerate(np.ndindex(*piece_shape)):
            sub_domain = [list(intervals[d][multi_idx[d]])
                          for d in range(num_dimensions)]
            pieces.append(ChebyshevApproximation.from_values(
                piece_values[flat_idx], num_dimensions, sub_domain, n_nodes,
                max_derivative_order=max_derivative_order, device=device))
        return cls._assemble(num_dimensions=num_dimensions, domain=domain,
                             n_nodes=list(n_nodes), knots=knots,
                             pieces=pieces,
                             max_derivative_order=max_derivative_order,
                             device=device)

    @classmethod
    def fit(cls, points, values, num_dimensions, domain, n_nodes, knots,
            *, l2: float = 0.0, sample_weight=None, rcond=None,
            derivative_data=None, engine: str = "host",
            mesh=None, data_axis: str = "dp",
            max_derivative_order: int = 2, device) -> "ChebyshevSpline":
        """Least-squares spline from SCATTERED samples (kinked data).

        Points route to their pieces exactly like ``eval_batch`` (a
        point on a knot belongs to the right piece) and each piece
        solves its own linear least-squares fit over its sub-domain
        (``utils/fitting.py``): pieces never see each other's samples,
        which is what lets the result capture a kink the samples
        straddle.  Flat ``n_nodes`` only (as ``from_values``).

        Every piece must contain samples (and at least
        ``prod(n_nodes)`` of them when ``l2 == 0``); a ``ValueError``
        names the starved piece otherwise.  ``derivative_data`` blocks
        route like the value samples.  ``engine`` / ``mesh`` /
        ``device`` forward to every piece's dense solve (see
        :meth:`ChebyshevApproximation.fit`).

        Returns a fully-built spline on ``device``; ``fit_diagnostics``
        aggregates the overall training rms plus one per-piece
        diagnostics dict.
        """
        from pychebyshev_tpu_torch.utils.fitting import (
            fit_dense_tensor,
            normalize_derivative_data,
        )

        if is_nested_n_nodes(n_nodes):
            raise NotImplementedError(
                "ChebyshevSpline.fit() accepts only flat n_nodes (one "
                "int per dim, shared across pieces), like from_values()."
            )
        cls._validate_domain_knots(num_dimensions, domain, knots)
        points = np.asarray(points, dtype=np.float64)
        values = np.asarray(values, dtype=np.float64)
        if points.ndim != 2 or points.shape[1] != num_dimensions:
            raise ValueError(
                f"points must be (N, {num_dimensions}), got "
                f"{points.shape}")
        if values.shape != (points.shape[0],):
            raise ValueError(
                f"values must be ({points.shape[0]},), got "
                f"{values.shape}")
        if sample_weight is not None:
            sample_weight = np.asarray(sample_weight, dtype=np.float64)
            if sample_weight.shape != (points.shape[0],):
                raise ValueError(
                    f"sample_weight must be ({points.shape[0]},), got "
                    f"{sample_weight.shape}")

        deriv_blocks = normalize_derivative_data(
            derivative_data, num_dimensions, domain, n_nodes)

        intervals = cls._compute_intervals(num_dimensions, domain, knots)
        piece_shape = tuple(len(iv) for iv in intervals)
        strides = spline_eval.piece_strides([len(k) for k in knots])

        def route(pts):
            return spline_eval.route_piece_indices(knots, strides,
                                                   pts).numpy()

        flat_idx = route(points)
        block_idx = [route(pts) for pts, _, _, _ in deriv_blocks]

        piece_values, per_piece = [], []
        sse, w_total = 0.0, 0.0
        for p, multi_idx in enumerate(np.ndindex(*piece_shape)):
            mask = flat_idx == p
            if not mask.any():
                sub = [list(intervals[d][multi_idx[d]])
                       for d in range(num_dimensions)]
                raise ValueError(
                    f"piece {p} (sub-domain {sub}) received no "
                    f"samples; add samples there or move the knots"
                )
            sub_domain = [list(intervals[d][multi_idx[d]])
                          for d in range(num_dimensions)]
            piece_blocks = []
            for (pts, orders, vals, weight), b_idx in zip(deriv_blocks,
                                                          block_idx):
                b_mask = b_idx == p
                if b_mask.any():
                    piece_blocks.append(
                        (pts[b_mask], orders, vals[b_mask], weight))
            try:
                tensor, diag = fit_dense_tensor(
                    points[mask], values[mask], sub_domain, n_nodes,
                    l2=l2, rcond=rcond,
                    derivative_data=piece_blocks or None,
                    sample_weight=(None if sample_weight is None
                                   else sample_weight[mask]),
                    engine=engine, mesh=mesh, data_axis=data_axis,
                    device=device)
            except ValueError as e:
                # Per-piece failures (underdetermined, all-zero weights
                # within the piece, ...) name the piece: the global
                # inputs may look fine while one piece starves.
                raise ValueError(
                    f"piece {p} (sub-domain {sub_domain}): {e}"
                ) from None
            piece_values.append(tensor)
            per_piece.append(diag)
            sse += diag["sse"]
            w_total += (float(np.sum(sample_weight[mask]))
                        if sample_weight is not None
                        else float(diag["n_samples"]))

        obj = cls.from_values(piece_values, num_dimensions, domain,
                              list(n_nodes), knots,
                              max_derivative_order=max_derivative_order,
                              device=device)
        obj.fit_diagnostics = {
            "rms": float(np.sqrt(sse / w_total)) if w_total > 0 else 0.0,
            "sse": sse,
            "n_samples": int(points.shape[0]),
            "l2": float(l2),
            "per_piece": per_piece,
            "max_abs_residual": max(
                d["max_abs_residual"] for d in per_piece),
        }
        if deriv_blocks:
            obj.fit_diagnostics["n_derivative_rows"] = int(
                sum(b[0].shape[0] for b in deriv_blocks))
            obj.fit_diagnostics["objective_sse"] = float(
                sum(d.get("objective_sse", d["sse"]) for d in per_piece))
        return obj

    @classmethod
    def _assemble(cls, *, num_dimensions, domain, n_nodes, knots, pieces,
                  max_derivative_order, device):
        """One built-object factory for pieces made elsewhere
        (``from_values``, ``_from_pieces``, ``utils.convert``)."""
        obj = object.__new__(cls)
        obj.device = torch.device(device)
        obj.function = None
        obj.num_dimensions = num_dimensions
        obj.domain = [list(b) for b in domain]
        obj.n_nodes = [list(n) if isinstance(n, (list, tuple)) else n
                       for n in n_nodes]
        obj._n_nodes_nested = is_nested_n_nodes(obj.n_nodes)
        obj.max_derivative_order = max_derivative_order
        obj.error_threshold = None
        obj.max_n = 64
        obj.knots = [list(k) for k in knots]
        obj._intervals = cls._compute_intervals(num_dimensions, domain,
                                                obj.knots)
        obj._shape = tuple(len(iv) for iv in obj._intervals)
        obj._pieces = list(pieces)
        obj._built = True
        obj._build_time = 0.0
        obj._cached_error_estimate = None
        obj.descriptor = ""
        obj.additional_data = None
        obj.n_workers = None
        obj.vectorized = False
        obj._derivative_id_registry = {}
        obj._derivative_id_to_orders = []
        return obj

    @classmethod
    def _from_pieces(cls, source, pieces):
        """New spline with *source*'s grid metadata and new pieces."""
        return cls._assemble(
            num_dimensions=source.num_dimensions, domain=source.domain,
            n_nodes=source.n_nodes, knots=source.knots, pieces=pieces,
            max_derivative_order=source.max_derivative_order,
            device=source.device)

    def differentiate(self, derivative_order) -> "ChebyshevSpline":
        """A first-class spline of the given derivative: every piece
        differentiated spectrally, same knot layout."""
        if not self._built:
            raise RuntimeError("Call build() first")
        orders = [int(o) for o in derivative_order]
        if len(orders) != self.num_dimensions:
            raise ValueError(
                f"derivative_order length {len(orders)} does not match "
                f"num_dimensions {self.num_dimensions}"
            )
        if any(o < 0 for o in orders):
            raise ValueError("derivative orders must be >= 0")
        return ChebyshevSpline._from_pieces(
            self, [piece.differentiate(orders) for piece in self._pieces])

    def _piece_grid(self) -> np.ndarray:
        """The pieces as an object array of the piece-grid shape."""
        grid = np.empty(len(self._pieces), dtype=object)
        grid[:] = self._pieces
        return grid.reshape(self._shape)

    def _reshaped(self, pieces, domain, n_nodes, knots) -> "ChebyshevSpline":
        """New spline of ``pieces`` on a changed grid (extrude, slice,
        partial integrate)."""
        return ChebyshevSpline._assemble(
            num_dimensions=len(domain), domain=domain, n_nodes=n_nodes,
            knots=knots, pieces=list(pieces),
            max_derivative_order=self.max_derivative_order,
            device=self.device)

    # ------------------------------------------------------------------
    # Extrusion / slicing
    # ------------------------------------------------------------------

    def extrude(self, params) -> "ChebyshevSpline":
        """Add constant dims (each piece extruded; new dim has no knots)."""
        if not self._built:
            raise RuntimeError("Call build() first")
        sorted_params = normalize_extrusion_params(params,
                                                   self.num_dimensions)
        knots = [list(k) for k in self.knots]
        domain = [list(b) for b in self.domain]
        n_nodes = list(self.n_nodes)
        for dim_idx, (lo, hi), n in sorted_params:
            knots.insert(dim_idx, [])
            domain.insert(dim_idx, [lo, hi])
            n_nodes.insert(dim_idx, [n] if self._n_nodes_nested else n)
        pieces = []
        for piece in self._pieces:
            for dim_idx, bounds, n in sorted_params:
                piece = piece.extrude((dim_idx, bounds, n))
            pieces.append(piece)
        return self._reshaped(pieces, domain, n_nodes, knots)

    def slice(self, params) -> "ChebyshevSpline":
        """Fix dims at values; only the containing pieces survive per dim
        (a value on a knot takes the right piece)."""
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
        knots = [list(k) for k in self.knots]
        shape = list(self._shape)
        domain = [list(b) for b in self.domain]
        n_nodes = list(self.n_nodes)
        pieces_arr = self._piece_grid()
        for dim_idx, value in sorted_params:  # descending
            interval_idx = 0
            if knots[dim_idx]:
                interval_idx = min(int(np.searchsorted(
                    knots[dim_idx], value, side="right")),
                    shape[dim_idx] - 1)
            pieces_arr = np.take(pieces_arr, interval_idx, axis=dim_idx)
            flat = pieces_arr.ravel()
            for i in range(len(flat)):
                flat[i] = flat[i].slice((dim_idx, value))
            pieces_arr = flat.reshape(pieces_arr.shape)
            for part in (knots, shape, domain, n_nodes):
                del part[dim_idx]
        return self._reshaped(pieces_arr.ravel(), domain, n_nodes, knots)

    # ------------------------------------------------------------------
    # Calculus
    # ------------------------------------------------------------------

    def integrate(self, dims=None, bounds=None):
        """Sum of piece integrals (full) or piece-summed lower-dim spline
        (partial), with per-piece clipped sub-bounds."""
        if not self._built:
            raise RuntimeError("Call build() first")
        if dims is None:
            dims = list(range(self.num_dimensions))
        elif isinstance(dims, int):
            dims = [dims]
        dims = sorted(set(dims))
        for d in dims:
            if d < 0 or d >= self.num_dimensions:
                raise ValueError(
                    f"dim {d} out of range [0, {self.num_dimensions - 1}]"
                )
        per_dim_bounds = normalize_bounds(dims, bounds, self.domain)
        dim_to_idx = {d: i for i, d in enumerate(dims)}

        def _clip(bd, piece_lo, piece_hi):
            """Overlap of bounds with a piece interval: (skip,
            bounds_or_None); bounds within 1e-14 of the piece's own
            interval integrate the whole piece."""
            if bd is None:
                return False, None
            overlap_lo = max(bd[0], piece_lo)
            overlap_hi = min(bd[1], piece_hi)
            if overlap_lo >= overlap_hi:
                return True, None
            if (abs(overlap_lo - piece_lo) < 1e-14
                    and abs(overlap_hi - piece_hi) < 1e-14):
                return False, None
            return False, (overlap_lo, overlap_hi)

        pieces_arr = self._piece_grid()
        if len(dims) == self.num_dimensions:
            total = 0.0
            for idx in np.ndindex(*self._shape):
                piece_bounds = []
                for d in range(self.num_dimensions):
                    skip, pb = _clip(per_dim_bounds[dim_to_idx[d]],
                                     *self._intervals[d][idx[d]])
                    if skip:
                        break
                    piece_bounds.append(pb)
                else:
                    piece = pieces_arr[idx]
                    if all(b is None for b in piece_bounds):
                        total += piece.integrate()
                    else:
                        total += piece.integrate(bounds=piece_bounds)
            return total

        # Partial: integrate each piece along d, sum the pieces along
        # that axis of the piece grid.
        knots = [list(k) for k in self.knots]
        intervals = [list(iv) for iv in self._intervals]
        domain = [list(b) for b in self.domain]
        n_nodes = list(self.n_nodes)
        for d in sorted(dims, reverse=True):
            bd = per_dim_bounds[dim_to_idx[d]]

            def _integrate_line(dim_pieces):
                integrated = []
                for piece_idx, p in enumerate(dim_pieces):
                    skip, pb = _clip(bd, *intervals[d][piece_idx])
                    if skip:
                        continue
                    if pb is None:
                        integrated.append(p.integrate(dims=[d]))
                    else:
                        integrated.append(p.integrate(dims=[d], bounds=[pb]))
                if not integrated:
                    integrated.append(dim_pieces[0].integrate(dims=[d]) * 0.0)
                result = integrated[0]
                for other in integrated[1:]:
                    result = result + other
                return result

            new_shape = [n for i, n in enumerate(pieces_arr.shape) if i != d]
            new_pieces = np.empty(new_shape, dtype=object)
            for idx in np.ndindex(*new_shape):
                line = list(idx)
                line.insert(d, slice(None))
                new_pieces[idx] = _integrate_line(
                    list(pieces_arr[tuple(line)].ravel()))
            pieces_arr = new_pieces
            for part in (knots, intervals, domain, n_nodes):
                del part[d]
        return self._reshaped(pieces_arr.ravel(), domain, n_nodes, knots)

    def integrate_batch(self, bounds, dtype=None) -> np.ndarray:
        """Integrals over a batch of axis-aligned boxes: every piece
        clips all B boxes to its sub-box at once (disjoint dims clamp to
        zero measure, which integrates to an exact 0) and runs a dense
        :meth:`ChebyshevApproximation.integrate_batch` over the whole
        batch; piece contributions sum.  Boxes may straddle knots.

        ``bounds``: (B, d, 2) per-box, per-dim (lo, hi) inside the
        domain; ``dtype`` as in the dense class.  Returns (B,).
        """
        if not self._built:
            raise RuntimeError("Call build() first")
        # Full-box integration is the no-remaining-dims case of the
        # conditional-expectation path.
        bounds = np.asarray(host_array(bounds), dtype=np.float64)
        return self.partial_integrate_batch(
            list(range(self.num_dimensions)), bounds,
            np.zeros((bounds.shape[0] if bounds.ndim else 0, 0)),
            dtype=dtype)

    def partial_integrate_batch(self, dims, bounds, points,
                                derivative_order=None,
                                dtype=None) -> np.ndarray:
        """Batched conditional expectations across pieces.

        Integrated ``dims`` clip every scenario box to every piece (as
        in :meth:`integrate_batch`); remaining dims route each scenario
        to its piece, in f64 on the device as :meth:`eval_batch` does (a
        point on a knot belongs to the right piece, derivatives
        included); each piece runs a dense
        :meth:`~ChebyshevApproximation.partial_integrate_batch` over the
        whole batch and contributes only to its routed scenarios.

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
        col_of = {k: i for i, k in enumerate(dims)}
        strides = spline_eval.piece_strides([len(k) for k in self.knots])
        routed = [k for k in remaining if self.knots[k]]
        # One device pass and one read: the remaining dims' share of each
        # scenario's flat piece index.
        route = np.zeros(arr.shape[0], dtype=np.int64)
        if routed and arr.shape[0]:
            route = spline_eval.route_piece_indices(
                [self.knots[k] for k in routed],
                [strides[k] for k in routed],
                self._points_on_device(pts[:, [remaining.index(k)
                                               for k in routed]])
            ).cpu().numpy()
        total = np.zeros(arr.shape[0], dtype=np.float64)
        pieces_arr = self._piece_grid()
        for idx in np.ndindex(*self._shape):
            mask = route == sum(idx[k] * strides[k] for k in routed)
            if not mask.any():
                continue
            lo = arr[..., 0].copy()
            hi = arr[..., 1].copy()
            for k in dims:
                p_lo, p_hi = self._intervals[k][idx[k]]
                lo[:, col_of[k]] = np.clip(lo[:, col_of[k]], p_lo, p_hi)
                hi[:, col_of[k]] = np.clip(hi[:, col_of[k]], p_lo, p_hi)
            hi = np.maximum(hi, lo)
            if not ((hi > lo).all(axis=1) & mask).any():
                continue
            vals = pieces_arr[idx].partial_integrate_batch(
                dims, np.stack([lo, hi], axis=-1), pts,
                derivative_order=rem_orders, dtype=dtype)
            total += np.where(mask, vals, 0.0)
        return total

    def _points_on_device(self, pts: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(pts, dtype=np.float64),
                               device=self.device)

    def roots(self, dim=None, fixed=None) -> np.ndarray:
        """Merged and deduplicated roots across the pieces of the 1-D
        slice."""
        if not self._built:
            raise RuntimeError("Call build() first")
        dim, slice_params = validate_calculus_args(
            self.num_dimensions, dim, fixed, self.domain)
        sliced = self.slice(slice_params) if slice_params else self
        all_roots = [roots_1d(p._host_1d()[0], p.domain[0])
                     for p in sliced._pieces]
        return _merged_roots(all_roots, self.domain[dim])

    def minimize(self, dim=None, fixed=None, *, tol=1e-9,
                 max_boxes=5000, polish=True):
        """Minimum of the spline.

        With ``dim``: the 1-D minimum along that dim, best over pieces
        — ``(value, location)`` floats.  With ``dim=None`` on a
        multi-dimensional spline: the CERTIFIED GLOBAL minimum over the
        whole domain (``fixed`` may pin a subset of dims) — ``(value,
        point)`` with an ``(ndim,)`` point.  Each piece runs the
        coefficient-space branch-and-bound of ``ops.subdivision``;
        kinks are handled exactly because every knot plane belongs to
        both neighboring pieces' closed boxes.
        """
        return self._optimize(dim, fixed, "min", tol=tol,
                              max_boxes=max_boxes, polish=polish)

    def maximize(self, dim=None, fixed=None, *, tol=1e-9,
                 max_boxes=5000, polish=True):
        """Maximum of the spline — see :meth:`minimize` for the 1-D
        (``dim`` given) vs certified-global (``dim=None``) forms."""
        return self._optimize(dim, fixed, "max", tol=tol,
                              max_boxes=max_boxes, polish=polish)

    def critical_points(self, fixed=None, *, grad_tol=1e-8, delta=5e-3,
                        max_boxes=50000, separation=1e-6):
        """Stationary points per piece (one-sided at knot planes),
        merged and classified — see
        ``ChebyshevApproximation.critical_points``."""
        if not self._built:
            raise RuntimeError("Call build() first")
        return globalcalc.critical_points_spline(
            self, fixed=fixed, grad_tol=grad_tol, delta=delta,
            max_boxes=max_boxes, separation=separation)

    def _optimize(self, dim, fixed, mode, *, tol=1e-9, max_boxes=5000,
                  polish=True):
        if not self._built:
            raise RuntimeError("Call build() first")
        if dim is None and self.num_dimensions > 1:
            return globalcalc.global_optimize_spline(
                self, mode, fixed, tol=tol, max_boxes=max_boxes,
                polish=polish)
        dim, slice_params = validate_calculus_args(
            self.num_dimensions, dim, fixed, self.domain)
        sliced = self.slice(slice_params) if slice_params else self
        sign = 1.0 if mode == "min" else -1.0
        best_val, best_loc = sign * float("inf"), 0.0
        for p in sliced._pieces:
            val, loc = optimize_1d(*p._host_1d(), p.domain[0], mode=mode)
            if sign * val < sign * best_val:
                best_val, best_loc = val, loc
        return best_val, best_loc

    def _scenario_interval_values(self, dim, fixed_cols, batch):
        """Per dim-interval (B, n) slice resamples for batched calculus.

        Yields ``(values, nodes, interval)`` per interval of *dim*: the
        slice along *dim* is piecewise-polynomial with breaks at the
        dim's knots, so each interval resamples at its own Type-I nodes
        (n = the most nodes among the interval's pieces: resampling a
        lower-degree piece at more nodes stays exact, which also covers
        nested per-piece grids).  One batched evaluation per interval
        routes every scenario to its piece on the device.
        """
        pieces_arr = self._piece_grid()
        for k, (lo, hi) in enumerate(self._intervals[dim]):
            in_interval = np.take(pieces_arr, k, axis=dim).ravel()
            n = max(int(p.n_nodes[dim]) for p in in_interval)
            nodes = nodes_for_dim_np(float(lo), float(hi), n)
            pts = scenario_slice_points(
                self.num_dimensions, dim, fixed_cols, batch, nodes)
            vals = self.eval_batch(pts, [0] * self.num_dimensions)
            yield vals.reshape(batch, n), nodes, (float(lo), float(hi))

    def roots_batch(self, dim=None, fixed=None) -> list:
        """Roots along *dim* for a batch of scenarios (scalar or (B,)
        arrays in ``fixed``): a list of B sorted root arrays, merged and
        deduplicated across the dim's intervals as in :meth:`roots`."""
        if not self._built:
            raise RuntimeError("Call build() first")
        dim, cols, batch = validate_calculus_args_batch(
            self.num_dimensions, dim, fixed, self.domain)
        per_row = [[] for _ in range(batch)]
        for vals, _, interval in self._scenario_interval_values(
                dim, cols, batch):
            for b, r in enumerate(roots_1d_batch(vals, interval)):
                per_row[b].append(r)
        return [_merged_roots(chunks, self.domain[dim])
                for chunks in per_row]

    def minimize_batch(self, dim=None, fixed=None):
        """Batched :meth:`minimize`: ((B,) values, (B,) locations), best
        across the dim's intervals per scenario."""
        return self._optimize_batch(dim, fixed, "min")

    def maximize_batch(self, dim=None, fixed=None):
        """Batched :meth:`maximize`: ((B,) values, (B,) locations), best
        across the dim's intervals per scenario."""
        return self._optimize_batch(dim, fixed, "max")

    def _optimize_batch(self, dim, fixed, mode):
        if not self._built:
            raise RuntimeError("Call build() first")
        dim, cols, batch = validate_calculus_args_batch(
            self.num_dimensions, dim, fixed, self.domain)
        best_val = best_loc = None
        for vals, nodes, interval in self._scenario_interval_values(
                dim, cols, batch):
            v, loc = optimize_resampled_batch(vals, nodes, interval, mode)
            if best_val is None:
                best_val, best_loc = v, loc
            else:
                take = v < best_val if mode == "min" else v > best_val
                best_val = np.where(take, v, best_val)
                best_loc = np.where(take, loc, best_loc)
        return best_val, best_loc

    # ------------------------------------------------------------------
    # Arithmetic operators
    # ------------------------------------------------------------------

    def _check_spline_compatible(self, other):
        check_compatible(self, other)
        if self.knots != other.knots:
            raise ValueError(f"Knot mismatch: {self.knots} vs {other.knots}")

    def _combined(self, other, op):
        self._check_spline_compatible(other)
        return ChebyshevSpline._from_pieces(self, [
            ChebyshevApproximation._from_grid(
                ps, op(ps.tensor_values, po.tensor_values.to(ps.device)))
            for ps, po in zip(self._pieces, other._pieces)])

    def __add__(self, other):
        if type(self) is not type(other):
            return NotImplemented
        return self._combined(other, torch.add)

    def __sub__(self, other):
        if type(self) is not type(other):
            return NotImplemented
        return self._combined(other, torch.sub)

    def __mul__(self, scalar):
        if not is_scalar(scalar):
            return NotImplemented
        s = float(scalar)
        return ChebyshevSpline._from_pieces(self, [
            ChebyshevApproximation._from_grid(p, p.tensor_values * s)
            for p in self._pieces])

    def __rmul__(self, scalar):
        return self.__mul__(scalar)

    def __truediv__(self, scalar):
        if not is_scalar(scalar):
            return NotImplemented
        return self.__mul__(1.0 / float(scalar))

    def __neg__(self):
        return self.__mul__(-1.0)

    def _update_pieces(self, fn):
        """Rebind every piece's tensor to ``fn(piece, index)`` (a new
        tensor, so every cache keyed on the old one refreshes)."""
        for i, p in enumerate(self._pieces):
            p.tensor_values = fn(p, i)
            p._cached_error_estimate = None
        self._cached_error_estimate = None
        return self

    def __iadd__(self, other):
        self._check_spline_compatible(other)
        return self._update_pieces(
            lambda p, i: p.tensor_values
            + other._pieces[i].tensor_values.to(p.device))

    def __isub__(self, other):
        self._check_spline_compatible(other)
        return self._update_pieces(
            lambda p, i: p.tensor_values
            - other._pieces[i].tensor_values.to(p.device))

    def __imul__(self, scalar):
        if not is_scalar(scalar):
            return NotImplemented
        s = float(scalar)
        return self._update_pieces(lambda p, i: p.tensor_values * s)

    def __itruediv__(self, scalar):
        if not is_scalar(scalar):
            return NotImplemented
        return self.__imul__(1.0 / float(scalar))

    # ------------------------------------------------------------------
    # Printing
    # ------------------------------------------------------------------

    # ------------------------------------------------------------------
    # Sensitivity
    # ------------------------------------------------------------------

    def sobol_indices(self) -> dict:
        """Per-piece Sobol indices aggregated by volume x variance."""
        from pychebyshev_tpu_torch.utils.sensitivity import (
            chebyshev_coefficient_tensor,
            sobol_from_coeffs,
        )
        if not self._built:
            raise RuntimeError("Call build() first")

        total_variance = 0.0
        first_energy = {d: 0.0 for d in range(self.num_dimensions)}
        total_energy = {d: 0.0 for d in range(self.num_dimensions)}

        for piece in self._pieces:
            if piece is None:
                continue
            vol = 1.0
            for d in range(self.num_dimensions):
                lo, hi = piece.domain[d]
                vol *= (hi - lo)
            coeffs = chebyshev_coefficient_tensor(piece.tensor_values)
            res = sobol_from_coeffs(coeffs, self.num_dimensions)
            total_variance += vol * res["variance"]
            for d in range(self.num_dimensions):
                first_energy[d] += vol * res["first_order"][d] * res["variance"]
                total_energy[d] += vol * res["total_order"][d] * res["variance"]

        if total_variance == 0:
            zeros = {d: 0.0 for d in range(self.num_dimensions)}
            return {"first_order": dict(zeros), "total_order": dict(zeros),
                    "variance": 0.0}
        return {
            "first_order": {d: first_energy[d] / total_variance
                            for d in range(self.num_dimensions)},
            "total_order": {d: total_energy[d] / total_variance
                            for d in range(self.num_dimensions)},
            "variance": total_variance,
        }

    def interaction_matrix(self) -> np.ndarray:
        """(d, d) pure pairwise Sobol interaction shares, aggregated
        over pieces by volume x variance like :meth:`sobol_indices`."""
        from pychebyshev_tpu_torch.utils.sensitivity import (
            chebyshev_coefficient_tensor,
            pair_interactions_from_coeffs,
        )
        if not self._built:
            raise RuntimeError("Call build() first")
        d = self.num_dimensions
        out = np.zeros((d, d))
        total_variance = 0.0
        for piece in self._pieces:
            if piece is None:
                continue
            vol = float(np.prod([hi - lo for lo, hi in piece.domain]))
            coeffs = chebyshev_coefficient_tensor(piece.tensor_values)
            pairs, variance = pair_interactions_from_coeffs(
                coeffs, d, return_variance=True)
            total_variance += vol * variance
            out += vol * variance * pairs
        if total_variance <= 0:
            return np.zeros((d, d))
        return out / total_variance

    def suggest_partition(self, threshold: float = 1e-8) -> list:
        """Additive partition implied by :meth:`interaction_matrix`
        (union-find over above-threshold pairs)."""
        from pychebyshev_tpu_torch.utils.sensitivity import (
            partition_from_interactions,
        )
        return partition_from_interactions(self.interaction_matrix(),
                                           threshold)

    # ------------------------------------------------------------------
    # Node-wise products and plots
    # ------------------------------------------------------------------

    def compose(self, g) -> "ChebyshevSpline":
        """Scalar-function composition per piece (see
        ``ChebyshevApproximation.compose``); each piece's grid must
        resolve ``g∘f`` on its sub-domain."""
        return ChebyshevSpline._from_pieces(
            self, [p.compose(g) for p in self._pieces])

    def hadamard(self, other) -> "ChebyshevSpline":
        """Node-wise product spline (per-piece ``hadamard``; see
        ``ChebyshevApproximation.hadamard`` for the accuracy caveat)."""
        if type(self) is not type(other):
            raise TypeError(
                f"hadamard requires another {type(self).__name__}, got "
                f"{type(other).__name__}"
            )
        self._check_spline_compatible(other)
        return ChebyshevSpline._from_pieces(
            self, [ps.hadamard(po)
                   for ps, po in zip(self._pieces, other._pieces)])

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
        return (f"ChebyshevSpline(dims={self.num_dimensions}, "
                f"pieces={self.num_pieces}, shape={self._shape}, "
                f"built={self._built}, device={self.device})")

    def __str__(self) -> str:
        status = "built" if self._built else "not built"
        max_display = 6
        if self.num_dimensions > max_display:
            nodes_str = ("[" + ", ".join(
                str(n) for n in self.n_nodes[:max_display]) + ", ...]")
            knots_str = ("[" + ", ".join(
                str(k) for k in self.knots[:max_display]) + ", ...]")
            domain_str = (" x ".join(
                f"[{lo}, {hi}]" for lo, hi in self.domain[:max_display])
                + " x ...")
        else:
            nodes_str = str(self.n_nodes)
            knots_str = str(self.knots)
            domain_str = " x ".join(f"[{lo}, {hi}]"
                                    for lo, hi in self.domain)
        shape_str = " x ".join(str(s) for s in self._shape)

        lines = [
            f"ChebyshevSpline ({self.num_dimensions}D, {status})",
            f"  Nodes:       {nodes_str} per piece",
            f"  Knots:       {knots_str}",
            f"  Pieces:      {self.num_pieces} ({shape_str})",
        ]
        if self._built:
            lines.append(f"  Build:       {self._build_time:.3f}s "
                         f"({self.total_build_evals:,} function evals)")
        lines.append(f"  Domain:      {domain_str}")
        if self._built:
            lines.append(f"  Error est:   {self.error_estimate():.2e}")
        return "\n".join(lines)

    # ------------------------------------------------------------------
    # Adaptive knot placement
    # ------------------------------------------------------------------

    @classmethod
    def auto_knots(cls, function, num_dimensions, domain, *,
                   max_knots_per_dim: int = 5, n_scan_points: int = 200,
                   threshold_factor: float = 5.0,
                   n_nodes_per_piece: int = 10,
                   additional_data=None, device) -> "ChebyshevSpline":
        """Build a spline with knots auto-placed at detected kinks.

        Probes every dim along an axis-aligned line through the domain
        centre, locates |curvature| spikes (``> threshold_factor x`` the
        dim's mean curvature), collapses each spike run to its strongest
        sample, and uses the surviving abscissae (capped per dim) as
        knots.
        """
        lows = np.array([d[0] for d in domain], dtype=np.float64)
        highs = np.array([d[1] for d in domain], dtype=np.float64)
        center = 0.5 * (lows + highs)

        steps = np.linspace(0.0, 1.0, n_scan_points)
        abscissae = lows[:, None] + steps[None, :] * (highs - lows)[:, None]
        probes = np.broadcast_to(
            center, (num_dimensions, n_scan_points, num_dimensions)
        ).copy()
        diag = np.arange(num_dimensions)
        probes[diag, :, diag] = abscissae

        samples = np.fromiter(
            (function([float(c) for c in p], additional_data)
             for p in probes.reshape(-1, num_dimensions)),
            dtype=np.float64, count=num_dimensions * n_scan_points,
        ).reshape(num_dimensions, n_scan_points)

        finite_rows = np.isfinite(samples).all(axis=1)
        if not finite_rows.all():
            bad_dim = int(np.flatnonzero(~finite_rows)[0])
            raise ValueError(
                f"auto_knots scan produced non-finite samples while "
                f"probing dim {bad_dim}; the target function must stay "
                f"finite over the whole domain"
            )

        curvature = np.abs(np.diff(samples, n=2, axis=1))
        run_gap = max(1, n_scan_points // (4 * max_knots_per_dim))

        knots = []
        for d in range(num_dimensions):
            curv = curvature[d]
            scale = float(curv.mean()) if curv.size else 0.0
            spikes = (np.flatnonzero(curv > threshold_factor * scale)
                      if scale > 0.0 else np.array([], dtype=int))
            if spikes.size == 0:
                knots.append([])
                continue
            run_starts = np.flatnonzero(np.diff(spikes) > run_gap) + 1
            reps = np.array([run[np.argmax(curv[run])]
                             for run in np.split(spikes, run_starts)])
            if reps.size > max_knots_per_dim:
                strongest = np.argsort(curv[reps])[::-1][:max_knots_per_dim]
                reps = reps[strongest]
            # A spike at curvature index i peaks at sample i+1.
            knots.append(sorted(float(x) for x in abscissae[d, reps + 1]))

        spl = cls(function, num_dimensions, domain,
                  n_nodes=[n_nodes_per_piece] * num_dimensions,
                  knots=knots, additional_data=additional_data,
                  device=device)
        spl.build(verbose=False)
        return spl


"""ChebyshevApproximation: full-tensor multi-dimensional Chebyshev
interpolation with analytical derivatives, on PyTorch.

The port of ``pychebyshev_tpu.models.approximation`` (main-path surface):
construction with a fixed grid or auto-N (``special_points`` with knots
returns a ``ChebyshevSpline``), single-point host evaluation, batched
f64, f32 and near-f64 device evaluation, multi-spec batches, the error
estimate, ``differentiate``, the algebra operators, ``from_values``,
``to_tt``, pickle / ``.pcb`` serialization, ``extrude``/``slice``, and
the calculus: ``integrate``, batched box integrals and conditional
expectations (f64, f32, near-f64; ``ops.integrate``), and roots and 1-D
optima, per call or for a batch of scenarios; ``fit`` from scattered
samples (``utils.fitting``: host, ``device`` and ``device-dd``
engines), the Sobol family (``utils.sensitivity``), ``hadamard``,
``compose``, the plots and the pickle-free ``.npz`` format.

- Grid data (nodes, barycentric weights, differentiation matrices) and
  the value tensor live on ``device`` as float64 tensors.
- Single-point queries run on the host against cached copies: through
  the C kernels of ``cpp/hosteval.c`` (``utils.ceval``) where the library
  builds, else in NumPy.
- Batched queries run on the device through ``ops.eval``; on a CUDA
  device the f32 path goes through the hand-written kernel in
  ``ops.fused_eval`` wherever ``supports_fused`` covers the grid, and
  the near-f64 ``eval_batch_dd`` through its f64 instance
  (``ops.fused_dd``) wherever ``supports_fused_dd`` does.
- Root finding and 1-D optimisation solve the colleague eigenproblem on
  the host (``utils.calculus``) over slice values computed on the
  device.
- The certified global ``minimize``/``maximize`` (``dim=None``),
  ``critical_points`` and ``solve_system`` run the coefficient-space
  branch-and-bound of ``ops.subdivision`` on the host, with the box
  statistics of large tensors on the device (``utils.globalcalc``).

``fit(mesh=)`` accumulates its normal equations data-parallel over a
device mesh (``utils.fitting``).
"""

from __future__ import annotations

import os
import pickle
import time
import warnings
from typing import List

import numpy as np
import torch

from pychebyshev_tpu_torch.config import DEFAULT_DTYPE, NODE_COINCIDENCE_TOL
from pychebyshev_tpu_torch.ops import eval as eval_ops
from pychebyshev_tpu_torch.ops import eval_dd, fused_eval
from pychebyshev_tpu_torch.ops import integrate as integrate_ops
from pychebyshev_tpu_torch.ops.integrate import host_array
from pychebyshev_tpu_torch.ops.chebyshev import (
    barycentric_weights_np,
    differentiation_matrix_np,
    nodes_for_dim_np,
)
from pychebyshev_tpu_torch.ops.dct import _coeff_matrix_np
from pychebyshev_tpu_torch.ops.quadrature import (
    fejer1_weights,
    sub_interval_weights,
)
from pychebyshev_tpu_torch.utils import ceval, globalcalc
from pychebyshev_tpu_torch.utils.algebra import check_compatible, is_scalar
from pychebyshev_tpu_torch.utils.calculus import (
    normalize_bounds,
    normalize_bounds_batch,
    optimize_1d,
    optimize_1d_batch,
    roots_1d,
    roots_1d_batch,
    scenario_slice_points,
    validate_calculus_args,
    validate_calculus_args_batch,
    validate_partial_integrate_args_batch,
)
from pychebyshev_tpu_torch.utils.extrude_slice import (
    extrude_tensor,
    normalize_extrusion_params,
    normalize_slicing_params,
)

__all__ = ["ChebyshevApproximation"]


def _private_f64(values, device) -> torch.Tensor:
    """A float64 tensor on ``device`` that shares NO memory with the
    caller (``torch.as_tensor`` of a NumPy array is zero-copy on the CPU,
    so a caller mutating its array would mutate the interpolant)."""
    if isinstance(values, torch.Tensor):
        return values.detach().to(device=device, dtype=DEFAULT_DTYPE,
                                  copy=True)
    return torch.tensor(np.asarray(values, dtype=np.float64),
                        dtype=DEFAULT_DTYPE, device=device)


def _unwrap_typed(domain, n_nodes, special_points=None):
    """Unwrap the Domain / Ns / SpecialPoints typed helpers."""
    from pychebyshev_tpu_torch import Domain, Ns, SpecialPoints
    if isinstance(domain, Domain):
        domain = list(domain.bounds)
    if isinstance(n_nodes, Ns):
        n_nodes = list(n_nodes.counts)
    if isinstance(special_points, SpecialPoints):
        special_points = [list(k) for k in special_points.knots_per_dim]
    return domain, n_nodes, special_points


def _validate_special_points_shape(special_points, n_nodes, num_dimensions,
                                   domain) -> None:
    """Shape/content validation before the spline dispatch (the
    reference's rules and messages)."""
    for d in range(num_dimensions):
        lo, hi = domain[d]
        pts = list(special_points[d])
        for k in pts:
            if not (lo < k < hi):
                raise ValueError(
                    f"Special point {k} for dimension {d} is not strictly "
                    f"inside domain [{lo}, {hi}]"
                )
        if pts != sorted(pts):
            raise ValueError(
                f"special_points for dimension {d} must be sorted"
            )
        if len(set(pts)) != len(pts):
            raise ValueError(f"Coinciding special points in dimension {d}")

    if n_nodes is None:
        return

    any_nested = any(isinstance(x, (list, tuple)) for x in n_nodes)
    all_nested = all(isinstance(x, (list, tuple)) for x in n_nodes)
    if any_nested and not all_nested:
        raise ValueError(
            f"n_nodes must be fully nested (all dims as lists) when any "
            f"dim is nested; got mixed form {n_nodes!r}"
        )
    if not all_nested:
        raise ValueError(
            f"n_nodes must be nested as List[List[int]] when special_points "
            f"is present; got {n_nodes!r}"
        )
    for d in range(num_dimensions):
        expected = len(special_points[d]) + 1
        if len(n_nodes[d]) != expected:
            raise ValueError(
                f"n_nodes[{d}] must have {expected} entries "
                f"(one per sub-interval); got {len(n_nodes[d])}"
            )


def _with_padded_rows(grid: dict) -> dict:
    """Augment a host-grid dict with padded (d, n_max) node/weight
    mirrors for the vectorized single-point row build.

    Pad lanes carry node +inf and weight 0 (exactly 0.0 contribution to
    numerator and denominator), so one set of array ops covers ragged
    dims.  Idempotent; mutates and returns *grid*.
    """
    if "nodes_pad" not in grid:
        ns = [len(n) for n in grid["nodes"]]
        n_max = max(ns)
        nodes_pad = np.full((len(ns), n_max), np.inf)
        weights_pad = np.zeros((len(ns), n_max))
        for d, (nd, wd) in enumerate(zip(grid["nodes"], grid["weights"])):
            nodes_pad[d, :ns[d]] = nd
            weights_pad[d, :ns[d]] = wd
        grid["nodes_pad"] = nodes_pad
        grid["weights_pad"] = weights_pad
        grid["n_per_dim"] = ns
    return grid


def _same_tensors(keyed, current) -> bool:
    """Cache check for mutable tensors: same objects, same versions."""
    tensors, versions = keyed
    return (len(tensors) == len(current)
            and all(a is b for a, b in zip(tensors, current))
            and versions == tuple(t._version for t in current))


def _cache_key(tensors):
    return tuple(tensors), tuple(t._version for t in tensors)


class ChebyshevApproximation:
    """Full-tensor Chebyshev interpolant on a Type-I node grid.

    Parameters mirror the JAX package's constructor; ``device`` (required,
    keyword-only) places the grid and value tensors.  ``vectorized=True``
    marks ``function`` as batch-capable
    (``f(points_array (N, d), data) -> (N,) values``).

    ``special_points`` declaring any knot makes the constructor return a
    :class:`ChebyshevSpline` on the same ``device`` (``n_nodes`` then
    nested, one count per sub-interval), as in the reference.
    """

    def __new__(cls, function=None, num_dimensions=None, domain=None,
                n_nodes=None, max_derivative_order=2, error_threshold=None,
                max_n=64, special_points=None, additional_data=None, *,
                device=None, defer_build=False, n_workers=None,
                vectorized=False):
        domain, n_nodes, special_points = _unwrap_typed(
            domain, n_nodes, special_points)
        if special_points is not None:
            if (num_dimensions is not None
                    and len(special_points) != num_dimensions):
                raise ValueError(
                    f"special_points must have {num_dimensions} entries, "
                    f"got {len(special_points)}"
                )
            for d, sp in enumerate(special_points):
                if not isinstance(sp, (list, tuple)):
                    raise ValueError(
                        f"special_points[{d}] must be a list/tuple of "
                        f"floats, got {type(sp).__name__}: {sp!r}"
                    )
            if any(len(sp) > 0 for sp in special_points):
                from pychebyshev_tpu_torch.models.spline import (
                    ChebyshevSpline,
                )
                if device is None:
                    raise TypeError(
                        "ChebyshevApproximation() missing required "
                        "keyword-only argument: 'device'")
                _validate_special_points_shape(
                    special_points, n_nodes, num_dimensions, domain)
                return ChebyshevSpline(
                    function, num_dimensions, domain, n_nodes=n_nodes,
                    knots=special_points,
                    max_derivative_order=max_derivative_order,
                    error_threshold=error_threshold, max_n=max_n,
                    additional_data=additional_data, device=device,
                    defer_build=defer_build, n_workers=n_workers,
                    vectorized=vectorized,
                )
        return super().__new__(cls)

    def __init__(self, function, num_dimensions, domain, n_nodes=None,
                 max_derivative_order=2, error_threshold=None, max_n=64,
                 special_points=None, additional_data=None, *,
                 device, defer_build=False, n_workers=None,
                 vectorized=False):
        from pychebyshev_tpu_torch.utils.parallel_build import (
            normalize_n_workers,
        )

        domain, n_nodes, special_points = _unwrap_typed(
            domain, n_nodes, special_points)

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
        self.max_derivative_order = max_derivative_order
        self.special_points = special_points
        self.descriptor: str = ""
        self.additional_data = additional_data
        self.n_workers = normalize_n_workers(n_workers)
        self.vectorized = bool(vectorized)
        self._derivative_id_registry: dict = {}
        self._derivative_id_to_orders: list = []

        # Normalize n_nodes — None entries mean "auto this dim".
        if n_nodes is None:
            if error_threshold is None and not defer_build:
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
        self.n_nodes = n_nodes
        # The user's original intent (None sentinels intact), so a
        # rebuild re-runs the doubling loop.
        self._original_n_nodes = list(self.n_nodes)

        self.tensor_values = None
        self.weights = None
        self.diff_matrices = None
        self.build_time: float = 0.0
        self.n_evaluations: int = 0
        self._cached_error_estimate = None

        if defer_build:
            if function is not None:
                raise ValueError(
                    "defer_build=True requires function=None (the "
                    "deferred-construction workflow expects values to be "
                    "supplied via set_original_function_values() later)"
                )
            if any(not isinstance(n, (int, np.integer)) or n <= 0
                   for n in self.n_nodes):
                raise ValueError(
                    "defer_build=True requires explicit positive int "
                    "n_nodes; auto-N (error_threshold) is not supported in "
                    "deferred mode"
                )
            self._generate_nodes()
            self._compute_grid_data()
            return

        self.nodes: List[torch.Tensor] = []
        if all(n is not None for n in self.n_nodes):
            self._generate_nodes()

    # ------------------------------------------------------------------
    # Grid construction
    # ------------------------------------------------------------------

    def _generate_nodes(self) -> None:
        """Populate ``self.nodes`` (ascending Chebyshev grid per dim),
        computed on the host and copied to the device."""
        host = [
            nodes_for_dim_np(self.domain[d][0], self.domain[d][1],
                             int(self.n_nodes[d]))
            for d in range(self.num_dimensions)
        ]
        self.nodes = [_private_f64(h, self.device) for h in host]
        self._host_nodes_cache = (_cache_key(self.nodes), host)

    def _nodes_np(self) -> list[np.ndarray]:
        """Host NumPy copies of ``self.nodes``, cached by identity and
        version."""
        cache = getattr(self, "_host_nodes_cache", None)
        if cache is None or not _same_tensors(cache[0], self.nodes):
            cache = (_cache_key(self.nodes),
                     [a.detach().cpu().numpy().copy() for a in self.nodes])
            self._host_nodes_cache = cache
        return cache[1]

    def _compute_grid_data(self) -> None:
        """Barycentric weights and differentiation matrices, computed on
        the host (kept in ``_host_grid`` for single-point eval) and
        copied to the device."""
        host_nodes = self._nodes_np()
        host_weights = [barycentric_weights_np(nd) for nd in host_nodes]
        host_diffs = [differentiation_matrix_np(host_nodes[d],
                                                host_weights[d])
                      for d in range(self.num_dimensions)]
        self.weights = [_private_f64(w, self.device) for w in host_weights]
        self.diff_matrices = [_private_f64(m, self.device)
                              for m in host_diffs]
        self._host_grid = _with_padded_rows({
            "nodes": host_nodes,
            "weights": host_weights,
            "diffs_t": [np.ascontiguousarray(m.T) for m in host_diffs],
        })

    def _grid_tuples(self):
        """(nodes, weights, diffs) as tuples for the batched kernels."""
        return (tuple(self.nodes), tuple(self.weights),
                tuple(self.diff_matrices))

    def set_original_function_values(self, values) -> None:
        """Fill a ``defer_build=True`` object's tensor with explicit values."""
        if self.tensor_values is not None:
            raise RuntimeError(
                "interpolant is already constructed; "
                "set_original_function_values() is for defer_build=True "
                "objects"
            )
        arr = np.asarray(values, dtype=np.float64)
        expected_shape = tuple(self.n_nodes)
        if arr.shape != expected_shape:
            raise ValueError(
                f"values shape {arr.shape} does not match expected "
                f"{expected_shape}"
            )
        if not np.isfinite(arr).all():
            raise ValueError("values contains NaN or Inf (must be finite)")
        self.tensor_values = _private_f64(arr, self.device)
        self._offer_host_tensor(arr)
        self.function = None

    # ------------------------------------------------------------------
    # Build
    # ------------------------------------------------------------------

    def build(self, verbose: bool | int = True) -> None:
        """Evaluate the function on the grid (doubling loop if auto-N)."""
        if self.function is None:
            raise RuntimeError(
                "Cannot build: no function assigned. "
                "This object was created via from_values() or load()."
            )
        if any(n is None for n in self._original_n_nodes):
            self._build_with_threshold(verbose=verbose)
        else:
            self._build_fixed_grid(verbose=verbose)

    def _build_with_threshold(self, verbose: bool | int = True) -> None:
        """Double the worst auto dim until error <= threshold or max_n.
        ``n_evaluations`` and ``build_time`` accumulate across rounds."""
        if self.error_threshold is None:
            raise RuntimeError("auto-N needs error_threshold")
        current = [n if n is not None else 3 for n in self._original_n_nodes]
        auto_dims = [i for i, n in enumerate(self._original_n_nodes)
                     if n is None]

        total_evals = 0
        total_time = 0.0
        while True:
            self.n_nodes = list(current)
            self._cached_error_estimate = None
            self._generate_nodes()
            self._build_fixed_grid(verbose=verbose)
            total_evals += self.n_evaluations
            total_time += self.build_time

            per_dim = self._error_estimate_per_dim()
            err = float(sum(per_dim))
            self._cached_error_estimate = err
            if verbose:
                print(f"[auto-N] n_nodes={current}, error={err:.3e}")
            if err <= self.error_threshold:
                break

            candidates = [(per_dim[i], i) for i in auto_dims
                          if current[i] < self.max_n]
            if not candidates:
                warnings.warn(
                    f"max_n={self.max_n} reached on all auto dims before "
                    f"error_threshold={self.error_threshold:.2e} satisfied "
                    f"(last error={err:.3e}). Increase max_n or relax "
                    f"error_threshold.",
                    RuntimeWarning,
                    stacklevel=3,
                )
                break
            candidates.sort(key=lambda t: (-t[0], t[1]))
            worst = candidates[0][1]
            current[worst] = min(2 * current[worst], self.max_n)

        self.n_evaluations = total_evals
        self.build_time = total_time

    def _evaluate_on_grid(self, verbose: bool | int):
        """Evaluate ``self.function`` at every grid point: one batched
        call for vectorized functions, else a host loop or process pool."""
        shape = tuple(int(n) for n in self.n_nodes)
        if self.vectorized:
            grid = self.get_evaluation_points()
            vals = self.function(grid, self.additional_data)
            if isinstance(vals, torch.Tensor):
                return vals.detach().to(DEFAULT_DTYPE).reshape(shape)
            return np.asarray(vals, dtype=np.float64).reshape(shape)

        host_nodes = self._nodes_np()
        if self.n_workers is None or self.n_workers == 1:
            from pychebyshev_tpu_torch.utils.progress import progress_iter
            out = np.zeros(shape)
            for idx in progress_iter(np.ndindex(*shape),
                                     total=int(np.prod(shape)),
                                     enabled=(verbose == 2), desc="build"):
                point = [float(host_nodes[d][idx[d]])
                         for d in range(self.num_dimensions)]
                out[idx] = float(self.function(point, self.additional_data))
            return out
        from pychebyshev_tpu_torch.utils.parallel_build import (
            evaluate_in_parallel,
        )
        points = [
            [float(host_nodes[d][idx[d]]) for d in range(self.num_dimensions)]
            for idx in np.ndindex(*shape)
        ]
        flat = evaluate_in_parallel(self.function, points,
                                    self.additional_data, self.n_workers)
        return flat.reshape(shape)

    def _build_fixed_grid(self, verbose: bool | int = True) -> None:
        total = int(np.prod(self.n_nodes))
        if verbose:
            print(f"Building {self.num_dimensions}D Chebyshev approximation "
                  f"({total:,} evaluations)...")

        start = time.time()
        self._cached_error_estimate = None

        values = self._evaluate_on_grid(verbose)
        self.n_evaluations = total

        if isinstance(values, np.ndarray):
            finite = np.isfinite(values)
        else:
            finite = torch.isfinite(values).cpu().numpy()
        if not finite.all():
            raise ValueError(
                f"function returned non-finite values at "
                f"{int((~finite).sum())} grid point(s); build cannot "
                f"proceed with NaN/Inf in tensor_values"
            )
        self.tensor_values = _private_f64(values, self.device)

        self._compute_grid_data()
        if isinstance(values, np.ndarray):
            self._offer_host_tensor(values)
        self.build_time = time.time() - start

        if verbose:
            total_weights = sum(int(w.shape[0]) for w in self.weights)
            print(f"  Built in {self.build_time:.3f}s "
                  f"({total_weights} weights, {total_weights * 8} bytes)")

    # ------------------------------------------------------------------
    # Host single-point evaluation
    # ------------------------------------------------------------------

    def _offer_host_tensor(self, host_values: np.ndarray) -> None:
        """Seed the host eval cache from values already on the host (a
        private copy: the source may be caller-owned memory)."""
        grid = getattr(self, "_host_grid", None)
        if grid is None:
            return
        self._host_cache = (_cache_key([self.tensor_values]), {
            "tensor": np.array(host_values, dtype=np.float64, order="C"),
            **_with_padded_rows(grid),
        })

    def _host_arrays(self):
        """Cached NumPy copies of the tensor and grid data for the
        single-point paths, keyed on the tensor's identity and version
        (a tensor mutated in place is read back afresh)."""
        cache = getattr(self, "_host_cache", None)
        if cache is None or not _same_tensors(cache[0],
                                              [self.tensor_values]):
            grid = getattr(self, "_host_grid", None) or {
                "nodes": [a.detach().cpu().numpy() for a in self.nodes],
                "weights": [a.detach().cpu().numpy() for a in self.weights],
                "diffs_t": [np.ascontiguousarray(
                    a.detach().cpu().numpy().T)
                    for a in self.diff_matrices],
            }
            grid = _with_padded_rows(grid)
            cache = (_cache_key([self.tensor_values]), {
                "tensor": np.array(self.tensor_values.detach().cpu().numpy(),
                                   dtype=np.float64, order="C"),
                **grid})
            self._host_cache = cache
        return cache[1]

    @staticmethod
    def _host_point(point, ns):
        """Normalize a query point to a 1-D length-d float64 array."""
        pt = np.asarray(point, dtype=np.float64)
        if pt.ndim != 1 or pt.shape[0] != len(ns):
            pt = np.array([float(np.ravel(pt[d])[0])
                           for d in range(len(ns))])
        return pt

    def _host_coeff_rows(self, point):
        """Per-dim normalized barycentric rows for one point on the host
        (one-hot at a node within 1e-14)."""
        h = self._host_arrays()
        ns = h["n_per_dim"]
        pt = self._host_point(point, ns)
        gaps = pt[:, None] - h["nodes_pad"]
        # An exact-node coincidence makes one lane inf/nan here; that dim
        # is replaced by its one-hot row below.
        with np.errstate(divide="ignore", invalid="ignore"):
            raw = h["weights_pad"] / gaps
            scaled = raw / raw.sum(axis=1)[:, None]
        absg = np.abs(gaps)
        nearest = absg.argmin(axis=1)
        exact = absg[np.arange(len(ns)), nearest] < NODE_COINCIDENCE_TOL
        rows = []
        for d in range(self.num_dimensions):
            if exact[d]:
                row = np.zeros(ns[d])
                row[nearest[d]] = 1.0
            else:
                row = scaled[d, :ns[d]]
            rows.append(row)
        return rows

    def _host_cpack(self, h):
        """The C kernels' pack for the host arrays ``h``, or None.  It
        lives in the ``_host_arrays`` dict, so a tensor edited in place
        (a new ``_version``) gets a new pack with the new values."""
        if "cpack" not in h:
            h["cpack"] = ceval.make_pack(h)
        return h["cpack"]

    def _host_contract(self, rows) -> float:
        """Contract the cached host tensor with one coefficient row per
        dim, highest dim first (each step is a single flattened GEMV)."""
        current = self._host_arrays()["tensor"]
        for row in reversed(rows):
            n = current.shape[-1]
            current = (current.reshape(-1, n) @ row).reshape(
                current.shape[:-1])
        return float(current)

    def _host_single_eval(self, point, derivative_order) -> float:
        """One point on the host: derivatives fold into the rows
        (``r . (D^k t) == ((D^T)^k r) . t``), then the tensor contracts
        one GEMV per dim, highest dim first.

        The fused C kernel does all of it in one call where the library
        is available; when it declines (a semantic decision), or there
        is no library, the NumPy path below decides.
        """
        h = self._host_arrays()
        pack = self._host_cpack(h)
        if pack is not None:
            pt = np.ascontiguousarray(
                self._host_point(point, h["n_per_dim"]))
            val = ceval.eval_single(pack, pt, derivative_order)
            if val is not None:
                return val
        rows = self._host_coeff_rows(point)
        for d, k in enumerate(derivative_order):
            for _ in range(int(k)):
                rows[d] = h["diffs_t"][d] @ rows[d]
        return self._host_contract(rows)

    def eval(self, point, derivative_order=None, *, derivative_id=None):
        """Single-point evaluation on the host."""
        derivative_order = self._resolve_derivative_args(
            derivative_order, derivative_id)
        if self.tensor_values is None:
            raise RuntimeError("Call build() first")
        return self._host_single_eval(point, derivative_order)

    vectorized_eval = eval

    def fast_eval(self, point, derivative_order=None, *, derivative_id=None):
        """Deprecated alias for :meth:`vectorized_eval`."""
        derivative_order = self._resolve_derivative_args(
            derivative_order, derivative_id)
        warnings.warn(
            "fast_eval() is deprecated and will be removed in a future "
            "version. Use vectorized_eval() instead.",
            DeprecationWarning,
            stacklevel=2,
        )
        return self.vectorized_eval(point, derivative_order)

    def eval_batch_host(self, points, derivative_order=None, *,
                        derivative_id=None) -> np.ndarray:
        """Batched evaluation computed on the host: (N, d) -> (N,).

        The latency-oriented counterpart of
        :meth:`vectorized_eval_batch`: no device dispatch; each point
        pays one memory-bound C pass over the cached host tensor, so a
        small batch answers with no warm-up.  Without the C library it
        is the per-point NumPy path.
        """
        derivative_order = self._resolve_derivative_args(
            derivative_order, derivative_id)
        if self.tensor_values is None:
            raise RuntimeError("Call build() first")
        if isinstance(points, torch.Tensor):
            points = points.detach().cpu().numpy()
        points = np.asarray(points, dtype=np.float64)
        if points.ndim != 2 or points.shape[1] != self.num_dimensions:
            raise ValueError(
                f"points must have shape (N, {self.num_dimensions}), "
                f"got {points.shape}")
        pack = self._host_cpack(self._host_arrays())
        if pack is not None and len(points):
            out = ceval.eval_batch_host(pack, points, derivative_order)
            if out is not None:
                return out
        return np.array([self._host_single_eval(p, derivative_order)
                         for p in points])

    def vectorized_eval_multi(self, point, derivative_orders):
        """Multiple derivative specs at one point -> list of floats.

        The normalized barycentric rows are built once and each spec's
        rows derived from them by folding ``(D^T)^k`` into the row,
        memoized on (dim, order); specs sharing a trailing (dim, order)
        pattern share the partial contraction over those dims.  The C
        multi-spec kernel does the same in one call; it declines
        odd-shaped inputs, which the NumPy path below accepts.
        """
        if self.tensor_values is None:
            raise RuntimeError("Call build() first")
        h = self._host_arrays()
        pack = self._host_cpack(h)
        if pack is not None:
            pt = np.ascontiguousarray(
                self._host_point(point, h["n_per_dim"]))
            vals = ceval.eval_multi(pack, pt, derivative_orders)
            if vals is not None:
                return vals
        base = self._host_coeff_rows(point)
        ndim = self.num_dimensions

        row_for = {}  # (dim, order) -> derivative-folded row

        def derived_row(d, k):
            k = int(k)
            if k == 0:
                return base[d]
            if (d, k) not in row_for:
                row_for[(d, k)] = h["diffs_t"][d] @ derived_row(d, k - 1)
            return row_for[(d, k)]

        suffix_cache = {}

        def contract_from(spec, d):
            """Tensor with dims d..ndim-1 contracted away."""
            if d == ndim:
                return h["tensor"]
            key = tuple(int(o) for o in spec[d:])
            hit = suffix_cache.get(key)
            if hit is None:
                inner = contract_from(spec, d + 1)
                row = derived_row(d, spec[d])
                n = inner.shape[-1]
                hit = (inner.reshape(-1, n) @ row).reshape(
                    inner.shape[:-1])
                suffix_cache[key] = hit
            return hit

        return [float(contract_from(spec, 0))
                for spec in derivative_orders]

    eval_multi = vectorized_eval_multi

    # ------------------------------------------------------------------
    # Batched device evaluation
    # ------------------------------------------------------------------

    def _points(self, points, dtype) -> torch.Tensor:
        pts = torch.as_tensor(points, dtype=dtype, device=self.device)
        if pts.dim() != 2 or pts.shape[1] != self.num_dimensions:
            raise ValueError(
                f"points must have shape (N, {self.num_dimensions}), "
                f"got {tuple(pts.shape)}")
        return pts

    def _orders(self, derivative_order):
        if derivative_order is None:
            return (0,) * self.num_dimensions
        orders = tuple(int(o) for o in derivative_order)
        if len(orders) != self.num_dimensions:
            raise ValueError(
                f"derivative_order length {len(orders)} does not "
                f"match num_dimensions {self.num_dimensions}")
        return orders

    def vectorized_eval_batch(self, points, derivative_order=None, *,
                              derivative_id=None) -> np.ndarray:
        """Batched f64 evaluation: (N, d) points -> (N,) NumPy values."""
        derivative_order = self._resolve_derivative_args(
            derivative_order, derivative_id)
        return self.eval_batch_device(
            points, derivative_order).cpu().numpy()

    eval_batch = vectorized_eval_batch

    def eval_batch_device(self, points, derivative_order=None
                          ) -> torch.Tensor:
        """Batched f64 evaluation, result left on the device."""
        if self.tensor_values is None:
            raise RuntimeError("Call build() first")
        nodes, weights, diffs = self._grid_tuples()
        return eval_ops.eval_batch(
            self.tensor_values, nodes, weights, diffs,
            self._points(points, DEFAULT_DTYPE),
            self._orders(derivative_order))

    def eval_batch_f32(self, points, derivative_order=None, *,
                       use_fused: bool = None) -> torch.Tensor:
        """Throughput-mode batched evaluation in float32, on the device.

        ``use_fused=None`` routes a CUDA interpolant through the fused
        kernel (``ops.fused_eval``) wherever ``supports_fused`` covers
        the grid, and everything else through the plain f32 path of
        ``ops.eval``.  ``True`` forces the fused route (a CPU tensor then
        runs the kernel's plain version), ``False`` the plain path.
        Derivative passes run in f64 before the cast on both routes.
        """
        if self.tensor_values is None:
            raise RuntimeError("Call build() first")
        orders = self._orders(derivative_order)
        nodes, weights, diffs = self._grid_tuples()
        shape = tuple(self.tensor_values.shape)
        if use_fused is None:
            use_fused = (self.device.type == "cuda"
                         and fused_eval.supports_fused(shape, torch.float32))
        pts = self._points(points, torch.float32)
        if use_fused:
            return fused_eval.fused_eval_batch(
                self.tensor_values, nodes, weights, diffs, pts, orders)
        tensor32 = eval_ops.apply_derivative_passes(
            self.tensor_values, diffs, orders).to(torch.float32)
        return eval_ops.eval_batch(
            tensor32, tuple(a.to(torch.float32) for a in nodes),
            tuple(a.to(torch.float32) for a in weights), (), pts,
            (0,) * self.num_dimensions)

    def eval_batch_dd(self, points, derivative_order=None,
                      mode: str = "accurate") -> torch.Tensor:
        """Near-f64 batched evaluation, result left on the device.

        The reference's dd tier (``ops.eval_dd``), served in native f64:
        on a CUDA device through the f64 kernel (``ops.fused_dd``)
        wherever ``supports_fused_dd`` covers the grid.  Results deviate
        from ``eval_batch_device`` by f64 summation order only, well
        inside the tier's 1e-10 contract.

        ``mode``: ``"accurate"`` (default) or ``"fast"``; the reference
        trades accuracy for speed there, while f64 already meets both
        modes' accuracy, so the result is the same.  An out-of-domain
        batch, or a grid outside ``supports_dd``, takes the f64 path, as
        in the reference.
        """
        if self.tensor_values is None:
            raise RuntimeError("Call build() first")
        if mode not in ("accurate", "fast"):
            raise ValueError(
                f"mode must be 'accurate' or 'fast', got {mode!r}")
        cutoff = eval_dd.FAST_PAIR_CUTOFF if mode == "fast" else None
        orders = self._orders(derivative_order)
        nodes, weights, diffs = self._grid_tuples()
        pts = self._points(points, DEFAULT_DTYPE)
        dom = torch.tensor(self.domain, dtype=DEFAULT_DTYPE,
                           device=self.device)
        out_of_domain = bool(((pts < dom[:, 0]) | (pts > dom[:, 1]))
                             .any().item())
        if not out_of_domain and eval_dd.supports_dd(
                self.tensor_values.shape):
            return eval_dd.eval_batch_dd(self.tensor_values, nodes, weights,
                                         diffs, pts, orders, cutoff=cutoff)
        return eval_ops.eval_batch(self.tensor_values, nodes, weights, diffs,
                                   pts, orders)

    def vectorized_eval_batch_multi(self, points, derivative_orders
                                    ) -> np.ndarray:
        """Batch x multi-spec f64 evaluation -> (N, len(derivative_orders))
        NumPy array; the rows are shared across specs."""
        if self.tensor_values is None:
            raise RuntimeError("Call build() first")
        orders_list = tuple(self._orders(o) for o in derivative_orders)
        pts = self._points(points, DEFAULT_DTYPE)
        if not orders_list:
            return np.zeros((pts.shape[0], 0))
        nodes, weights, diffs = self._grid_tuples()
        out = eval_ops.eval_batch_multi(
            self.tensor_values, nodes, weights, diffs, pts, orders_list)
        return out.cpu().numpy().T

    eval_batch_multi = vectorized_eval_batch_multi

    # ------------------------------------------------------------------
    # Derivative ids
    # ------------------------------------------------------------------

    def get_derivative_id(self, derivative_order) -> int:
        """Stable session-local id for a derivative-orders tuple."""
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
    # Error estimation and grid points
    # ------------------------------------------------------------------

    def _error_estimate_per_dim(self, tail: int = 1) -> List[float]:
        """Per-dim max |coefficient| over the last ``tail`` rows of all
        1-D slices (one cosine-matrix contraction per axis)."""
        if self.tensor_values is None:
            raise RuntimeError("Call build() first")
        per_dim = []
        for d in range(self.num_dimensions):
            n = self.tensor_values.shape[d]
            mat = torch.tensor(_coeff_matrix_np(n), dtype=DEFAULT_DTYPE,
                               device=self.device)
            coeffs = torch.tensordot(self.tensor_values, mat,
                                     dims=([d], [1]))   # coeff axis last
            take = min(max(1, int(tail)), n)
            per_dim.append(float(coeffs[..., n - take:].abs().max()))
        return per_dim

    def error_estimate(self, tail: int = 1) -> float:
        """Sup-norm error estimate: sum over dims of max |c_{n-1}|
        (``tail=2`` reads the last two coefficient rows per dim)."""
        if tail == 1 and self._cached_error_estimate is not None:
            return self._cached_error_estimate
        total = float(sum(self._error_estimate_per_dim(tail)))
        if tail == 1:
            self._cached_error_estimate = total
        return total

    def get_num_evaluation_points(self) -> int:
        """prod(n_nodes) — where f was (or will be) evaluated."""
        return int(np.prod(self.n_nodes))

    def get_evaluation_points(self) -> np.ndarray:
        """(N, d) grid of evaluation points in C-order."""
        grids = np.meshgrid(*self._nodes_np(), indexing="ij")
        return np.stack([g.ravel() for g in grids], axis=-1).astype(np.float64)

    # ------------------------------------------------------------------
    # Ergonomics surface
    # ------------------------------------------------------------------

    def is_construction_finished(self) -> bool:
        """True iff this interpolant is built and usable."""
        return self.tensor_values is not None

    def get_constructor_type(self) -> str:
        """Class name (MoCaX getConstructorType convention)."""
        return type(self).__name__

    def get_used_ns(self) -> list:
        """Resolved per-dim node counts."""
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

    @staticmethod
    def is_dimensionality_allowed(num_dimensions: int) -> bool:
        """Whether this class supports ``num_dimensions`` (any >= 1)."""
        return isinstance(num_dimensions, int) and num_dimensions >= 1

    def get_special_points(self):
        """special_points declared at construction (None or empty lists)."""
        return self.special_points

    def get_error_threshold(self):
        """The error_threshold ctor kwarg (target precision), or None."""
        return self.error_threshold

    def clone(self) -> "ChebyshevApproximation":
        """Independent deep copy (function is not duplicated)."""
        import copy
        return copy.deepcopy(self)

    @staticmethod
    def nodes(num_dimensions: int, domain, n_nodes) -> dict:
        """Grid info without evaluating a function: ``nodes_per_dim``,
        ``full_grid`` (C-order), ``shape``."""
        if len(domain) != num_dimensions or len(n_nodes) != num_dimensions:
            raise ValueError(
                f"len(domain)={len(domain)} and len(n_nodes)={len(n_nodes)} "
                f"must both equal num_dimensions={num_dimensions}"
            )
        nodes_per_dim = [
            nodes_for_dim_np(domain[d][0], domain[d][1], int(n_nodes[d]))
            for d in range(num_dimensions)
        ]
        grids = np.meshgrid(*nodes_per_dim, indexing="ij")
        full_grid = np.column_stack([g.ravel() for g in grids])
        return {
            "nodes_per_dim": nodes_per_dim,
            "full_grid": full_grid,
            "shape": tuple(n_nodes),
        }

    def differentiate(self, derivative_order) -> "ChebyshevApproximation":
        """A first-class interpolant of the given derivative: the
        spectral differentiation matrices applied to the value tensor
        once (in f64, on the device)."""
        if self.tensor_values is None:
            raise RuntimeError("Call build() first")
        orders = tuple(int(o) for o in derivative_order)
        if len(orders) != self.num_dimensions:
            raise ValueError(
                f"derivative_order length {len(orders)} does not match "
                f"num_dimensions {self.num_dimensions}"
            )
        if any(o < 0 for o in orders):
            raise ValueError("derivative orders must be >= 0")
        _, _, diffs = self._grid_tuples()
        new_tensor = eval_ops.apply_derivative_passes(self.tensor_values,
                                                      diffs, orders)
        return ChebyshevApproximation._from_grid(self, new_tensor)

    @classmethod
    def _from_grid(cls, source, tensor_values, share_grid=False):
        """New built instance on *source*'s grid and device (the operator
        factory).  ``share_grid`` makes it hold *source*'s node, weight
        and differentiation tensors themselves (a book's models share
        one grid; nothing edits those in place)."""
        return cls._from_parts(
            source.device, tensor_values, source.nodes, source.weights,
            source.diff_matrices, source.domain, source.n_nodes,
            source.max_derivative_order,
            host_grid=getattr(source, "_host_grid", None),
            share_grid=share_grid)

    @classmethod
    def _from_parts(cls, device, tensor_values, nodes, weights, diffs,
                    domain, n_nodes, max_derivative_order, host_grid=None,
                    share_grid=False):
        """New built instance from grid parts (the factory of the
        operators, ``extrude``, ``slice`` and partial ``integrate``).
        Every tensor it holds is its own copy, unless ``share_grid``
        (then the grid tensors are the caller's): torch tensors change
        in place, so sharing the source's value tensor would let an edit
        of one interpolant change the other.  ``host_grid``, host NumPy
        that nothing edits in place, may be shared."""
        obj = object.__new__(cls)
        obj.device = device
        obj.function = None
        obj.num_dimensions = len(n_nodes)
        obj.domain = [list(b) for b in domain]
        obj.n_nodes = list(n_nodes)
        obj._original_n_nodes = list(n_nodes)
        obj.max_derivative_order = max_derivative_order
        obj.error_threshold = None
        obj.max_n = 64
        if share_grid:
            obj.nodes, obj.weights = list(nodes), list(weights)
            obj.diff_matrices = list(diffs)
        else:
            obj.nodes = [_private_f64(a, device) for a in nodes]
            obj.weights = [_private_f64(a, device) for a in weights]
            obj.diff_matrices = [_private_f64(a, device) for a in diffs]
        if host_grid is not None:
            obj._host_grid = host_grid
        obj.tensor_values = _private_f64(tensor_values, device)
        if isinstance(tensor_values, np.ndarray):
            obj._offer_host_tensor(tensor_values)
        obj.build_time = 0.0
        obj.n_evaluations = 0
        obj._cached_error_estimate = None
        obj.special_points = None
        obj.descriptor = ""
        obj.additional_data = None
        obj.n_workers = None
        obj.vectorized = False
        obj._derivative_id_registry = {}
        obj._derivative_id_to_orders = []
        return obj

    def _parts(self):
        """Mutable lists of the grid parts, for the shape-changing
        methods."""
        return (list(self.nodes), list(self.weights),
                list(self.diff_matrices), [list(b) for b in self.domain],
                list(self.n_nodes))

    def _assemble(self, tensor, nodes, weights, diffs, domain, n_nodes):
        return ChebyshevApproximation._from_parts(
            self.device, tensor, nodes, weights, diffs, domain, n_nodes,
            self.max_derivative_order)

    # ------------------------------------------------------------------
    # Extrusion / slicing
    # ------------------------------------------------------------------

    def extrude(self, params) -> "ChebyshevApproximation":
        """Add constant dimensions (partition-of-unity replication)."""
        if self.tensor_values is None:
            raise RuntimeError("Call build() first")
        sorted_params = normalize_extrusion_params(params,
                                                   self.num_dimensions)
        tensor = self.tensor_values
        nodes, weights, diffs, domain, n_nodes = self._parts()
        for dim_idx, (lo, hi), n in sorted_params:
            tensor = extrude_tensor(tensor, dim_idx, n)
            new_nodes = nodes_for_dim_np(lo, hi, int(n))
            new_weights = barycentric_weights_np(new_nodes)
            nodes.insert(dim_idx, new_nodes)
            weights.insert(dim_idx, new_weights)
            diffs.insert(dim_idx, differentiation_matrix_np(new_nodes,
                                                            new_weights))
            domain.insert(dim_idx, [lo, hi])
            n_nodes.insert(dim_idx, int(n))
        return self._assemble(tensor, nodes, weights, diffs, domain, n_nodes)

    def slice(self, params) -> "ChebyshevApproximation":
        """Fix dimensions at values, contracting the tensor
        barycentrically (an exact index select at a node)."""
        if self.tensor_values is None:
            raise RuntimeError("Call build() first")
        sorted_params = normalize_slicing_params(params, self.num_dimensions)
        for dim_idx, value in sorted_params:
            lo, hi = self.domain[dim_idx]
            if value < lo or value > hi:
                raise ValueError(
                    f"Slice value {value} for dim {dim_idx} is outside "
                    f"domain [{lo}, {hi}]"
                )
        tensor = self.tensor_values
        nodes, weights, diffs, domain, n_nodes = self._parts()
        for dim_idx, value in sorted_params:  # descending order
            tensor = eval_ops.contract_dim_at_value(
                tensor, dim_idx, nodes[dim_idx], weights[dim_idx], value)
            for part in (nodes, weights, diffs, domain, n_nodes):
                del part[dim_idx]
        return self._assemble(tensor, nodes, weights, diffs, domain, n_nodes)

    # ------------------------------------------------------------------
    # Calculus
    # ------------------------------------------------------------------

    def integrate(self, dims=None, bounds=None):
        """Fejer-1 quadrature over ``dims`` (all by default), on the
        device: a float when every dim is integrated, else the
        interpolant of the remaining dims.  ``bounds`` gives a
        sub-interval (or None for the whole dim) per integrated dim."""
        if self.tensor_values is None:
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

        tensor = self.tensor_values
        nodes, weights, diffs, domain, n_nodes = self._parts()
        for d in sorted(dims, reverse=True):
            a, b = domain[d]
            scale = (b - a) / 2.0
            bd = per_dim_bounds[dim_to_idx[d]]
            if bd is None:
                quad_w = fejer1_weights(int(n_nodes[d]))
            else:
                t_lo = 2.0 * (bd[0] - a) / (b - a) - 1.0
                t_hi = 2.0 * (bd[1] - a) / (b - a) - 1.0
                quad_w = sub_interval_weights(int(n_nodes[d]), t_lo, t_hi)
            # quad_w * scale is a new array: the cached weights stay
            # untouched.
            w = torch.tensor(quad_w * scale, dtype=DEFAULT_DTYPE,
                             device=self.device)
            tensor = torch.tensordot(tensor, w, dims=([d], [0]))
            for part in (nodes, weights, diffs, domain, n_nodes):
                del part[d]
        if not n_nodes:
            return float(tensor)
        return self._assemble(tensor, nodes, weights, diffs, domain, n_nodes)

    def integrate_batch(self, bounds, dtype=None) -> np.ndarray:
        """Integrals over a batch of axis-aligned boxes in one pass.

        The batched-evaluation contraction with per-box sub-interval
        quadrature rows in place of barycentric rows
        (``ops.integrate``): bucketed expected values, bucket
        probabilities over scenario grids, CDF tables.

        Parameters
        ----------
        bounds : (B, d, 2) array-like: per-box, per-dim (lo, hi) inside
            the domain.  Zero-measure dims (lo == hi) are allowed and
            contribute an exact 0.
        dtype : None (f64, the parity tier), ``torch.float32`` (the
            throughput tier) or ``"dd"`` (the near-f64 tier, served in
            native f64; grids outside ``ops.eval_dd.supports_dd`` take
            the f64 path, as in the reference).

        Returns
        -------
        (B,) ndarray of box integrals.
        """
        if self.tensor_values is None:
            raise RuntimeError("Call build() first")
        arr = normalize_bounds_batch(host_array(bounds), self.domain)
        tier = integrate_ops.tier(dtype)
        domain = np.asarray(self.domain, dtype=np.float64)
        if tier == "dd" and eval_dd.supports_dd(self.tensor_values.shape):
            out = integrate_ops.integrate_box_batch_dd(self.tensor_values,
                                                       domain, arr)
        else:
            out = integrate_ops.integrate_box_batch(
                self.tensor_values, domain, arr,
                dtype=DEFAULT_DTYPE if tier == "dd" else tier)
        return out.cpu().numpy()

    def partial_integrate_batch(self, dims, bounds, points,
                                derivative_order=None,
                                dtype=None) -> np.ndarray:
        """Batched conditional expectations: integrate over per-scenario
        boxes on ``dims``, evaluate at per-scenario coordinates on the
        rest, in one pass.

        Equivalent to ``self.integrate(dims, bounds=bounds[b])
        .vectorized_eval(points[b], derivative_order)`` for every
        scenario b, without B intermediate objects: quadrature rows on
        ``dims``, (derivative-folded) barycentric rows on the rest.

        Parameters
        ----------
        dims : int or sequence: dims to integrate (at least one).
        bounds : (B, len(dims), 2) per-scenario boxes, columns in sorted
            ``dims`` order, inside those dims' domain.
        points : (B, d - len(dims)) coordinates for the remaining dims
            in ascending dim order.
        derivative_order : per-REMAINING-dim orders (ascending dim
            order), or None.
        dtype : None (f64), ``torch.float32`` or ``"dd"`` (native f64,
            with the reference's fallback outside its plan).

        Returns
        -------
        (B,) ndarray.
        """
        if self.tensor_values is None:
            raise RuntimeError("Call build() first")
        dims, arr, remaining, pts, rem_orders = \
            validate_partial_integrate_args_batch(
                self.num_dimensions, self.domain, dims, host_array(bounds),
                host_array(points), derivative_order,
                max_order=self.max_derivative_order)
        full_orders = [0] * self.num_dimensions
        for k, o in zip(remaining, rem_orders):
            full_orders[k] = o
        tier = integrate_ops.tier(dtype)
        nodes, weights, diffs = self._grid_tuples()
        args = (self.tensor_values, np.asarray(self.domain, np.float64),
                nodes, weights, diffs, tuple(dims), arr, pts)
        if tier == "dd" and eval_dd.supports_dd(self.tensor_values.shape):
            out = integrate_ops.partial_integrate_eval_batch_dd(
                *args, orders=tuple(full_orders))
        else:
            out = integrate_ops.partial_integrate_eval_batch(
                *args, orders=tuple(full_orders),
                dtype=DEFAULT_DTYPE if tier == "dd" else tier)
        return out.cpu().numpy()

    def _host_1d(self):
        """(values, nodes, weights, diff matrix) of a 1-D interpolant as
        host NumPy."""
        return tuple(a.detach().cpu().numpy() for a in (
            self.tensor_values, self.nodes[0], self.weights[0],
            self.diff_matrices[0]))

    def roots(self, dim=None, fixed=None) -> np.ndarray:
        """Roots along one dimension (others fixed): the slice's
        colleague matrix, on the host."""
        if self.tensor_values is None:
            raise RuntimeError("Call build() first")
        dim, slice_params = validate_calculus_args(
            self.num_dimensions, dim, fixed, self.domain)
        sliced = self.slice(slice_params) if slice_params else self
        return roots_1d(sliced._host_1d()[0], sliced.domain[0])

    def minimize(self, dim=None, fixed=None, *, tol=1e-9,
                 max_boxes=5000, polish=True):
        """Minimum of the interpolant.

        With ``dim`` given: the 1-D minimum along that dim with every
        other dim pinned by ``fixed`` — ``(value, location)`` floats (on
        a 1-D interpolant ``dim`` may be omitted).

        With ``dim=None`` on a multi-dimensional interpolant: the
        CERTIFIED GLOBAL minimum over the whole box (``fixed`` may pin
        any subset of dims) — ``(value, point)`` with ``point`` an
        ``(ndim,)`` array.  Branch-and-bound over Chebyshev enclosures
        in coefficient space (``ops.subdivision``, box statistics of
        large tensors on ``device``), certified to ``tol`` unless a
        RuntimeWarning reports the remaining gap; ``polish`` runs exact
        line searches through the winner afterwards.
        """
        return self._optimize(dim, fixed, "min", tol=tol,
                              max_boxes=max_boxes, polish=polish)

    def maximize(self, dim=None, fixed=None, *, tol=1e-9,
                 max_boxes=5000, polish=True):
        """Maximum of the interpolant — see :meth:`minimize` for the
        1-D (``dim`` given) vs certified-global (``dim=None``) forms."""
        return self._optimize(dim, fixed, "max", tol=tol,
                              max_boxes=max_boxes, polish=polish)

    def critical_points(self, fixed=None, *, grad_tol=1e-8, delta=5e-3,
                        max_boxes=50000, separation=1e-6):
        """All interior stationary points, classified.

        Subdivision isolation on the spectral gradient system plus one
        batched Newton polish; each result is a
        ``CriticalPoint(point, value, kind)`` with kind one of
        ``"minimum" | "maximum" | "saddle" | "degenerate"`` (Hessian
        eigenvalue test).  ``fixed`` pins a subset of dims first.
        """
        if self.tensor_values is None:
            raise RuntimeError("Call build() first")
        return globalcalc.critical_points_dense(
            self, fixed=fixed, grad_tol=grad_tol, delta=delta,
            max_boxes=max_boxes, separation=separation)

    def _optimize(self, dim, fixed, mode, *, tol=1e-9, max_boxes=5000,
                  polish=True):
        if self.tensor_values is None:
            raise RuntimeError("Call build() first")
        if dim is None and self.num_dimensions > 1:
            return globalcalc.global_optimize_dense(
                self, mode, fixed, tol=tol, max_boxes=max_boxes,
                polish=polish)
        dim, slice_params = validate_calculus_args(
            self.num_dimensions, dim, fixed, self.domain)
        sliced = self.slice(slice_params) if slice_params else self
        return optimize_1d(*sliced._host_1d(), sliced.domain[0], mode=mode)

    def _scenario_slice_values(self, dim, fixed_cols, batch):
        """(B, n) values of the 1-D slice along *dim* for B scenarios:
        one f64 batched evaluation at the dim's own nodes on the device
        (exact: a polynomial resampled at its Type-I nodes), then to the
        host."""
        pts = scenario_slice_points(
            self.num_dimensions, dim, fixed_cols, batch,
            self._nodes_np()[dim])
        vals = self.eval_batch_device(pts).cpu().numpy()
        return vals.reshape(batch, -1)

    def roots_batch(self, dim=None, fixed=None) -> list:
        """Roots along *dim* for a batch of scenarios.

        ``fixed`` maps every other dim to a scalar or a (B,) array of
        scenario values; returns a list of B sorted root arrays.  One
        batched resampling on the device plus one stacked colleague
        eigensolve on the host replace B ``roots()`` calls: exercise
        boundaries and breakevens across scenario grids.
        """
        if self.tensor_values is None:
            raise RuntimeError("Call build() first")
        dim, cols, batch = validate_calculus_args_batch(
            self.num_dimensions, dim, fixed, self.domain)
        vals = self._scenario_slice_values(dim, cols, batch)
        return roots_1d_batch(vals, self.domain[dim])

    def minimize_batch(self, dim=None, fixed=None):
        """Batched :meth:`minimize`: ((B,) min values, (B,) locations)
        for scenario arrays in ``fixed``."""
        return self._optimize_batch(dim, fixed, "min")

    def maximize_batch(self, dim=None, fixed=None):
        """Batched :meth:`maximize`: ((B,) max values, (B,) locations)
        for scenario arrays in ``fixed``."""
        return self._optimize_batch(dim, fixed, "max")

    def _optimize_batch(self, dim, fixed, mode):
        if self.tensor_values is None:
            raise RuntimeError("Call build() first")
        dim, cols, batch = validate_calculus_args_batch(
            self.num_dimensions, dim, fixed, self.domain)
        vals = self._scenario_slice_values(dim, cols, batch)
        nodes, weights, diff = (a.detach().cpu().numpy() for a in (
            self.nodes[dim], self.weights[dim], self.diff_matrices[dim]))
        return optimize_1d_batch(vals, nodes, weights, diff,
                                 self.domain[dim], mode=mode)

    # ------------------------------------------------------------------
    # Arithmetic operators
    # ------------------------------------------------------------------

    def __add__(self, other):
        if type(self) is not type(other):
            return NotImplemented
        check_compatible(self, other)
        return ChebyshevApproximation._from_grid(
            self, self.tensor_values + other.tensor_values.to(self.device))

    def __sub__(self, other):
        if type(self) is not type(other):
            return NotImplemented
        check_compatible(self, other)
        return ChebyshevApproximation._from_grid(
            self, self.tensor_values - other.tensor_values.to(self.device))

    def __mul__(self, scalar):
        if not is_scalar(scalar):
            return NotImplemented
        return ChebyshevApproximation._from_grid(
            self, self.tensor_values * float(scalar))

    def __rmul__(self, scalar):
        return self.__mul__(scalar)

    def __truediv__(self, scalar):
        if not is_scalar(scalar):
            return NotImplemented
        return self.__mul__(1.0 / float(scalar))

    def __neg__(self):
        return self.__mul__(-1.0)

    # The in-place forms rebind tensor_values to a new tensor (as the
    # reference does), so every cache keyed on the old one refreshes.
    def __iadd__(self, other):
        check_compatible(self, other)
        self.tensor_values = (self.tensor_values
                              + other.tensor_values.to(self.device))
        self._cached_error_estimate = None
        return self

    def __isub__(self, other):
        check_compatible(self, other)
        self.tensor_values = (self.tensor_values
                              - other.tensor_values.to(self.device))
        self._cached_error_estimate = None
        return self

    def __imul__(self, scalar):
        if not is_scalar(scalar):
            return NotImplemented
        self.tensor_values = self.tensor_values * float(scalar)
        self._cached_error_estimate = None
        return self

    def __itruediv__(self, scalar):
        if not is_scalar(scalar):
            return NotImplemented
        return self.__imul__(1.0 / float(scalar))

    # ------------------------------------------------------------------
    # Serialization
    # ------------------------------------------------------------------

    def __getstate__(self) -> dict:
        """Picklable state: arrays as NumPy, device as a string, no
        function, version-stamped."""
        from pychebyshev_tpu_torch._version import __version__

        state = self.__dict__.copy()
        state["function"] = None
        # host-side caches are recomputable, not state
        for key in ("_host_cache", "_host_grid", "_host_nodes_cache"):
            state.pop(key, None)
        for key in ("nodes", "weights", "diff_matrices"):
            if state.get(key) is not None:
                state[key] = [a.detach().cpu().numpy() for a in state[key]]
        if state.get("tensor_values") is not None:
            state["tensor_values"] = (
                state["tensor_values"].detach().cpu().numpy())
        state["device"] = str(self.device)
        state["_pychebyshev_version"] = __version__
        return state

    def __setstate__(self, state: dict) -> None:
        """Restore onto the device the object was saved from."""
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
        for key in ("nodes", "weights", "diff_matrices"):
            if getattr(self, key, None) is not None:
                setattr(self, key, [_private_f64(a, self.device)
                                    for a in getattr(self, key)])
        if self.tensor_values is not None:
            self.tensor_values = _private_f64(self.tensor_values,
                                              self.device)

    def save(self, path: str | os.PathLike, format: str = "pickle") -> None:
        """Save to pickle (default), the portable ``.pcb`` binary, or the
        pickle-free ``.npz``."""
        if self.tensor_values is None:
            raise RuntimeError(
                "Cannot save an unbuilt ChebyshevApproximation. Call "
                "build() first."
            )
        if format == "pickle":
            with open(path, "wb") as f:
                pickle.dump(self, f, protocol=pickle.HIGHEST_PROTOCOL)
        elif format == "binary":
            from pychebyshev_tpu_torch.utils import binary
            with open(path, "wb") as f:
                binary.write_approx(f, self)
        elif format == "npz":
            from pychebyshev_tpu_torch.utils.native_save import write_npz
            write_npz(path, self)
        else:
            raise ValueError(
                f"format must be 'pickle', 'binary', or 'npz'; "
                f"got {format!r}"
            )

    @classmethod
    def load(cls, path: str | os.PathLike, *,
             device) -> "ChebyshevApproximation":
        """Load from pickle, ``.pcb`` or ``.npz`` (magic-sniffed) onto
        ``device``.

        A pickle is first restored onto the device it was saved from,
        then moved; only unpickle files this program wrote.
        """
        from pychebyshev_tpu_torch.utils import binary, native_save
        if binary.detect_format(path) == "binary":
            with open(path, "rb") as f:
                return binary.read_approx(f, device=device)
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

    @staticmethod
    def peek_format_version(filename: str) -> int:
        """Major format version from a .pcb header."""
        from pychebyshev_tpu_torch.utils.binary import peek_format_version
        return peek_format_version(filename)

    @classmethod
    def get_optimal_n1(cls, function, domain_1d, error_threshold,
                       max_n: int = 64, *, device) -> int:
        """Smallest N hitting ``error_threshold`` on a 1-D build (the
        auto-N doubling loop, built on ``device``)."""
        lo, hi = domain_1d
        cheb = cls(function, 1, [[lo, hi]],
                   error_threshold=error_threshold, max_n=max_n,
                   device=device)
        cheb._build_with_threshold(verbose=False)
        return int(cheb.n_nodes[0])

    def _move_to(self, device) -> None:
        """Move the grid and value tensors to ``device`` (a restored
        pickle starts on the device it was saved from)."""
        device = torch.device(device)
        if self.device != device:
            self.device = device
            self.nodes = [a.to(device) for a in self.nodes]
            self.weights = [a.to(device) for a in self.weights]
            self.diff_matrices = [a.to(device) for a in self.diff_matrices]
            if self.tensor_values is not None:
                self.tensor_values = self.tensor_values.to(device)

    @classmethod
    def from_values(cls, tensor_values, num_dimensions, domain, n_nodes,
                    max_derivative_order: int = 2, *,
                    device) -> "ChebyshevApproximation":
        """Fully-built interpolant from pre-computed grid values."""
        if isinstance(tensor_values, torch.Tensor):
            tensor_values = tensor_values.detach().cpu().numpy()
        tensor_values = np.asarray(tensor_values, dtype=float)

        if len(domain) != num_dimensions or len(n_nodes) != num_dimensions:
            raise ValueError(
                f"len(domain)={len(domain)} and len(n_nodes)={len(n_nodes)} "
                f"must both equal num_dimensions={num_dimensions}"
            )
        expected_shape = tuple(n_nodes)
        if tensor_values.shape != expected_shape:
            raise ValueError(
                f"tensor_values.shape={tensor_values.shape} does not match "
                f"n_nodes={expected_shape}"
            )
        if not np.isfinite(tensor_values).all():
            raise ValueError("tensor_values contains NaN or Inf")
        for d in range(num_dimensions):
            lo, hi = domain[d]
            if lo >= hi:
                raise ValueError(
                    f"domain[{d}]: lo={lo} must be strictly less than "
                    f"hi={hi}"
                )

        obj = object.__new__(cls)
        obj.device = torch.device(device)
        obj.function = None
        obj.num_dimensions = num_dimensions
        obj.domain = [list(bounds) for bounds in domain]
        obj.n_nodes = list(n_nodes)
        obj._original_n_nodes = list(n_nodes)
        obj.max_derivative_order = max_derivative_order
        obj.error_threshold = None
        obj.max_n = 64
        obj._generate_nodes()
        obj.tensor_values = _private_f64(tensor_values, obj.device)
        obj._compute_grid_data()
        obj._offer_host_tensor(tensor_values)
        obj.build_time = 0.0
        obj.n_evaluations = 0
        obj._cached_error_estimate = None
        obj.special_points = None
        obj.descriptor = ""
        obj.additional_data = None
        obj.n_workers = None
        obj.vectorized = False
        obj._derivative_id_registry = {}
        obj._derivative_id_to_orders = []
        return obj

    def to_tt(self, max_rank=None, tolerance: float = 1e-12, *,
              order=None, sup_target: float = None):
        """Compress this dense interpolant into a :class:`ChebyshevTT`.

        The inverse of ``ChebyshevTT.to_dense``: TT-SVD of the value
        tensor (host NumPy) at the given relative singular-value
        ``tolerance``.  Returns an independent object on this
        interpolant's device; grid metadata, ``max_derivative_order``,
        ``additional_data`` and the descriptor carry over.

        ``order``: ``None`` keeps the canonical dim order; ``"auto"``
        searches dim permutations (exhaustive for d <= 6, greedy
        adjacent-swap descent beyond) for the cheapest serving rank
        chain — the result stores it as its ``dim_order`` frame, so
        queries stay user-frame; an explicit permutation pins one.

        ``sup_target``: per-bond error budgeting — instead of the
        uniform relative singular-value ``tolerance``, greedily trim
        bond ranks while the reconstruction's MEASURED grid sup
        deviation stays within ``sup_target * max|values|``
        (``models.tt_algorithms.tt_trim_cores``).  The result carries
        ``compression_diagnostics`` (order, bond ranks, measured grid
        sup deviation, chain flops).
        """
        if self.tensor_values is None:
            raise RuntimeError("Call build() first")
        from pychebyshev_tpu_torch.models.tensor_train import ChebyshevTT
        from pychebyshev_tpu_torch.models import tt_algorithms as tta
        d = self.num_dimensions
        sizes = [int(n) for n in self.n_nodes]
        if max_rank is None:
            # Uncapped: tight tolerances legitimately need bond ranks
            # past max(n_nodes), which is from_values' None default.
            max_rank = max(
                min(int(np.prod(sizes[:k + 1])),
                    int(np.prod(sizes[k + 1:])))
                for k in range(len(sizes) - 1)) if d > 1 else 1
        arr = self._host_arrays()["tensor"]
        # sup_target drives ranks via measured trimming; the SVD then
        # runs tight so trimming owns the whole error budget.
        svd_tol = (tolerance if sup_target is None
                   else min(tolerance, float(sup_target) * 1e-3))

        def _ranks_cost(perm):
            cores = tta.tt_svd_from_tensor(
                arr.transpose(perm), max_rank=max_rank, tol=svd_tol)
            return cores, sum(c.shape[0] * c.shape[1] * c.shape[2]
                              for c in cores)

        if order is None:
            perm = tuple(range(d))
            value_cores, _ = _ranks_cost(perm)
        elif order == "auto":
            if d <= 6:
                import itertools
                perm, (value_cores, best) = None, (None, None)
                for p in itertools.permutations(range(d)):
                    cores, cost = _ranks_cost(p)
                    if best is None or cost < best:
                        perm, value_cores, best = p, cores, cost
            else:
                perm = list(range(d))
                value_cores, best = _ranks_cost(tuple(perm))
                improved = True
                while improved:
                    improved = False
                    for k in range(d - 1):
                        cand = list(perm)
                        cand[k], cand[k + 1] = cand[k + 1], cand[k]
                        cores, cost = _ranks_cost(tuple(cand))
                        if cost < best:
                            perm, value_cores, best = cand, cores, cost
                            improved = True
                perm = tuple(perm)
        else:
            perm = tuple(int(p) for p in order)
            if sorted(perm) != list(range(d)):
                raise ValueError(
                    f"order must be a permutation of range({d}); "
                    f"got {order!r}")
            value_cores, _ = _ranks_cost(perm)

        diagnostics = None
        if sup_target is not None:
            value_cores, diagnostics = tta.tt_trim_cores(
                value_cores, arr.transpose(perm), float(sup_target))
            diagnostics["order"] = list(perm)

        # Every branch builds from the ALREADY-COMPUTED cores (the
        # canonical path used to round-trip through from_values and
        # re-run the identical TT-SVD — 2x the compression cost).
        coeff_cores = [tta.value_core_to_coeff_core(c)
                       for c in value_cores]
        obj = ChebyshevTT._from_coeff_cores(
            coeff_cores,
            [list(self.domain[p]) for p in perm],
            [sizes[p] for p in perm],
            dim_order=list(perm), max_rank=max_rank,
            tolerance=tolerance,
            max_derivative_order=self.max_derivative_order,
            additional_data=self.additional_data,
            descriptor=self.descriptor, method="svd", device=self.device)
        if diagnostics is not None:
            obj.compression_diagnostics = diagnostics
        return obj

    @classmethod
    def fit(cls, points, values, num_dimensions, domain, n_nodes, *,
            l2: float = 0.0, sample_weight=None, rcond=None,
            derivative_data=None, engine: str = "host",
            mesh=None, data_axis: str = "dp",
            max_derivative_order: int = 2, additional_data=None,
            device) -> "ChebyshevApproximation":
        """Least-squares interpolant from SCATTERED samples.

        Solves for the nodal-value tensor that best explains arbitrary
        in-domain samples ``(points, values)`` in the (optionally
        weighted, optionally ``l2``-regularized) least-squares sense:
        the model is linear in its tensor, so the fit is one linear
        solve (``utils/fitting.py``).  The result is an ordinary,
        fully-built interpolant on ``device``.

        Parameters
        ----------
        points : (N, num_dimensions) in-domain sample coordinates.
        values : (N,) sample values.
        l2 : Tikhonov penalty on the nodal values (required > 0 when
            N < prod(n_nodes); recommended for noisy data).
        sample_weight : optional (N,) non-negative weights.
        rcond : pseudoinverse cutoff for the unregularized path.
        derivative_data : optional gradient-enhanced observation blocks
            ``[(points_b, orders_b, values_b[, weight_b]), ...]``
            (``utils/fitting.py::normalize_derivative_data``).
        engine : ``"host"`` (default; exact f64 normal equations),
            ``"device"`` (``A^T A`` accumulated on ``device`` in IEEE
            f32, the throughput tier for millions of noisy samples) or
            ``"device-dd"`` (accumulated on ``device`` in native f64).
            The solve and the residual diagnostics stay host f64.
        mesh : optional device mesh (device engines only,
            ``parallel.sharding``): the samples shard over ``data_axis``
            and the normal equations are reduced across it (see
            ``utils.fitting``); every rank gets the same model.
        device : where the device engines run and the result lives
            (under a mesh, the mesh's device).

        Returns
        -------
        A built ``ChebyshevApproximation``; ``fit_diagnostics`` records
        ``rms`` / ``max_abs_residual`` (training residuals),
        ``n_samples``, ``grid_points``, ``l2``, ``rank`` (plus per-block
        ``derivative_blocks`` when derivative data was given).
        """
        from pychebyshev_tpu_torch.utils.fitting import fit_dense_tensor

        if len(n_nodes) != num_dimensions or len(domain) != num_dimensions:
            raise ValueError(
                f"len(domain)={len(domain)} and len(n_nodes)="
                f"{len(n_nodes)} must both equal num_dimensions="
                f"{num_dimensions}"
            )
        tensor, diagnostics = fit_dense_tensor(
            points, values, domain, n_nodes, l2=l2,
            sample_weight=sample_weight, rcond=rcond,
            derivative_data=derivative_data, engine=engine,
            mesh=mesh, data_axis=data_axis, device=device)
        obj = cls.from_values(tensor, num_dimensions, domain,
                              list(n_nodes),
                              max_derivative_order=max_derivative_order,
                              device=device)
        obj.additional_data = additional_data
        obj.fit_diagnostics = diagnostics
        obj.n_evaluations = int(diagnostics["n_samples"])
        return obj

    # ------------------------------------------------------------------
    # Sensitivity
    # ------------------------------------------------------------------

    def sobol_indices(self) -> dict:
        """Analytic first/total-order Sobol indices from the spectral
        expansion."""
        from pychebyshev_tpu_torch.utils.sensitivity import (
            chebyshev_coefficient_tensor,
            sobol_from_coeffs,
        )
        if self.tensor_values is None:
            raise RuntimeError("Call build() first")
        coeffs = chebyshev_coefficient_tensor(self.tensor_values)
        return sobol_from_coeffs(coeffs, self.num_dimensions)

    def interaction_matrix(self) -> np.ndarray:
        """(d, d) pure pairwise Sobol interaction shares.  Zero (to
        roundoff) exactly where the function separates additively;
        threshold it with :meth:`suggest_partition` to pick a slider
        partition."""
        from pychebyshev_tpu_torch.utils.sensitivity import (
            chebyshev_coefficient_tensor,
            pair_interactions_from_coeffs,
        )
        if self.tensor_values is None:
            raise RuntimeError("Call build() first")
        coeffs = chebyshev_coefficient_tensor(self.tensor_values)
        return pair_interactions_from_coeffs(coeffs,
                                             self.num_dimensions)

    def suggest_partition(self, threshold: float = 1e-8) -> list:
        """Additive partition implied by :meth:`interaction_matrix`
        (union-find over above-threshold pairs)."""
        from pychebyshev_tpu_torch.utils.sensitivity import (
            partition_from_interactions,
        )
        return partition_from_interactions(self.interaction_matrix(),
                                           threshold)

    # ------------------------------------------------------------------
    # Node-wise products
    # ------------------------------------------------------------------

    def compose(self, g) -> "ChebyshevApproximation":
        """Scalar-function composition ``g(f(x))`` as a new interpolant:
        ``g`` applied elementwise to the value tensor (a float64 torch
        tensor on this interpolant's device; ``g`` may return a tensor
        or an array of the same shape) -- the interpolant of ``g∘f``
        sampled at this grid.  Accurate when the grid resolves ``g∘f``;
        check ``result.error_estimate()``."""
        vals = g(self.tensor_values)
        if tuple(np.shape(vals)) != tuple(self.tensor_values.shape):
            raise ValueError(
                f"g must map values elementwise; output shape "
                f"{tuple(np.shape(vals))} != "
                f"{tuple(self.tensor_values.shape)}"
            )
        return ChebyshevApproximation._from_grid(self, vals)

    def hadamard(self, other) -> "ChebyshevApproximation":
        """Node-wise product surrogate: interpolant of ``f·g`` sampled
        at the shared grid.  The product roughly doubles the polynomial
        degree, so it is accurate only when the shared grid resolves it
        (check ``result.error_estimate()``)."""
        if type(self) is not type(other):
            raise TypeError(
                f"hadamard requires another {type(self).__name__}, got "
                f"{type(other).__name__}"
            )
        check_compatible(self, other)
        return ChebyshevApproximation._from_grid(
            self, self.tensor_values * other.tensor_values)

    # ------------------------------------------------------------------
    # Plotting (optional host-side extras)
    # ------------------------------------------------------------------

    def plot_convergence(self, target_error=None, max_n=64, ax=None):
        """Error-decay sweep over increasing N (requires matplotlib);
        each build runs on this interpolant's device."""
        try:
            import matplotlib.pyplot as plt
        except ImportError:
            raise ImportError(
                "plot_convergence requires matplotlib"
            )
        if self.function is None:
            raise RuntimeError(
                "plot_convergence requires a function-bound interpolant "
                "(this object has function=None)"
            )
        ns = list(range(4, max_n + 1, 2))
        errors = []
        for n in ns:
            cheb = ChebyshevApproximation(
                self.function, self.num_dimensions, self.domain,
                n_nodes=[n] * self.num_dimensions,
                additional_data=self.additional_data,
                vectorized=self.vectorized, device=self.device,
            )
            cheb.build(verbose=False)
            errors.append(cheb.error_estimate())
        if ax is None:
            _, ax = plt.subplots()
        ax.semilogy(ns, errors, marker="o")
        ax.set_xlabel("Number of nodes per dimension (N)")
        ax.set_ylabel("Error estimate (log scale)")
        ax.set_title(f"Convergence — {self.num_dimensions}-D Chebyshev")
        if target_error is not None:
            ax.axhline(target_error, linestyle="--", color="red",
                       label=f"target={target_error}")
            ax.legend()
        return ax

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
        built = self.tensor_values is not None
        return (f"ChebyshevApproximation(dims={self.num_dimensions}, "
                f"n_nodes={self.n_nodes}, built={built}, "
                f"device={self.device})")

    def __str__(self) -> str:
        built = self.tensor_values is not None
        has_none = any(n is None for n in self.n_nodes)
        total_nodes_str = ("auto" if has_none
                           else f"{int(np.prod(self.n_nodes)):,}")
        status = "built" if built else "not built"

        max_display = 6
        if self.num_dimensions > max_display:
            nodes_str = ("[" + ", ".join(str(n)
                         for n in self.n_nodes[:max_display]) + ", ...]")
            domain_str = (" x ".join(f"[{lo}, {hi}]" for lo, hi
                          in self.domain[:max_display]) + " x ...")
        else:
            nodes_str = str(self.n_nodes)
            domain_str = " x ".join(f"[{lo}, {hi}]"
                                    for lo, hi in self.domain)

        lines = [
            f"ChebyshevApproximation ({self.num_dimensions}D, {status})",
            f"  Nodes:       {nodes_str} ({total_nodes_str} total)",
            f"  Domain:      {domain_str}",
            f"  Device:      {self.device}",
        ]
        if built:
            lines.append(f"  Build:       {self.build_time:.3f}s, "
                         f"{self.n_evaluations:,} evaluations")
            lines.append(f"  Error est:   {self.error_estimate():.2e}")
        lines.append(f"  Derivatives: up to order {self.max_derivative_order}")
        return "\n".join(lines)


"""ChebyshevTT: Chebyshev interpolation in Tensor Train format, on
PyTorch.

The port of ``pychebyshev_tpu.models.tensor_train`` (serving surface).
Builds from O(d n r^2) function evaluations via TT-Cross (maxvol
pivoting), TT-SVD, or rank-adaptive ALS, on the host in NumPy
(``models.tt_algorithms``); stores Chebyshev *coefficient* cores as host
float64 arrays; evaluates batches on ``device`` through the contraction
chain in ``ops.tt_eval`` (one GEMM + batched reduction per dimension),
and single points on the host through the C kernel of
``cpp/hosteval.c`` (``utils.ceval``) with a NumPy chain behind it.

Frame discipline: the storage order of cores may be a permutation
``_dim_order`` of the user's dims (set by ``with_auto_order``/
``reorder``/``to_tt(order=...)``).  All public methods accept user-frame
indices/coordinates and permute exactly once into storage frame; no
method mutates ``_dim_order`` temporarily, so concurrent evaluation is
race-free by construction.

Batched results: ``eval_batch`` and ``eval_batch_dd`` return tensors on
the device; the ``vectorized_*`` spellings return NumPy arrays.

Calculus: ``integrate`` and ``extrude``/``slice`` work on the host
cores; ``integrate_batch`` and ``partial_integrate_batch`` run the chain
with moment rows on the device (``ops.integrate``); roots and 1-D optima
resample slices on the device and solve on the host; ``to_slider``
slices through the pivot.

``fit`` completes a TT from scattered samples by alternating least
squares (``utils.fitting.fit_tt_cores``: host f64, or the ``device``
engine with rows, interfaces and Grams on the device in f32);
``run_completion`` refines a built TT against the full grid
(``tt_algorithms.als_fixed_rank_sweeps``).  The Sobol family runs on the
coefficient cores (``utils.sensitivity``); ``hadamard`` and ``compose``
work in value space with TT rounding; the plots and the ``.npz`` format
are shared with the other classes.
The global ``minimize``/``maximize`` (``dim=None``) and
``critical_points`` search through the coefficient cores with the
interval transfer-matrix bound, on the host (``utils.globalcalc``).

``build(mesh=)`` and ``run_completion(mesh=)`` shard every oracle batch
over a device mesh (``parallel.sharding.sharded_vectorized``);
``fit(mesh=)`` shards the ALS rows (``utils.fitting``).
"""

from __future__ import annotations

import os
import pickle
import time
import warnings
from typing import Callable, List, Optional

import numpy as np
import torch

from pychebyshev_tpu_torch.config import NODE_COINCIDENCE_TOL
from pychebyshev_tpu_torch.models import tt_algorithms as tta
from pychebyshev_tpu_torch.ops import integrate as integrate_ops
from pychebyshev_tpu_torch.ops import tt_eval_dd
from pychebyshev_tpu_torch.ops.chebyshev import (
    barycentric_weights_np,
    differentiation_matrix_np,
    nodes_for_dim_np,
)
from pychebyshev_tpu_torch.ops.integrate import host_array
from pychebyshev_tpu_torch.ops.quadrature import (
    fejer1_weights,
    sub_interval_weights,
)
from pychebyshev_tpu_torch.ops.tt_eval import tt_eval_batch
from pychebyshev_tpu_torch.parallel import sharding
from pychebyshev_tpu_torch.utils import ceval
from pychebyshev_tpu_torch.utils.algebra import is_scalar
from pychebyshev_tpu_torch.utils.calculus import (
    normalize_bounds,
    normalize_bounds_batch,
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

__all__ = ["ChebyshevTT"]


def _unwrap_typed(domain, n_nodes):
    """Unwrap the Domain / Ns typed helpers."""
    from pychebyshev_tpu_torch import Domain, Ns
    if isinstance(domain, Domain):
        domain = list(domain.bounds)
    if isinstance(n_nodes, Ns):
        n_nodes = list(n_nodes.counts)
    return domain, n_nodes


def _same_arrays(keyed, current) -> bool:
    return (len(keyed) == len(current)
            and all(a is b for a, b in zip(keyed, current)))


class ChebyshevTT:
    """Chebyshev interpolant in TT format for high-dimensional functions.

    Parameters mirror the JAX package's constructor; ``device``
    (required, keyword-only) is where batched evaluation runs.
    ``vectorized=True`` marks ``function`` as batch-capable
    (``f(points (N, d), data) -> (N,)``, host NumPy) so the build oracle
    issues one batched call per cross block.
    """

    def __init__(self, function: Callable, num_dimensions: int,
                 domain, n_nodes, max_rank: int = 10,
                 tolerance: float = 1e-6, max_sweeps: int = 10,
                 additional_data=None, *, device,
                 max_derivative_order: int = 2,
                 vectorized: bool = False):
        domain, n_nodes = _unwrap_typed(domain, n_nodes)
        if len(domain) != num_dimensions:
            raise ValueError(
                f"domain has {len(domain)} entries but "
                f"num_dimensions={num_dimensions}"
            )
        if len(n_nodes) != num_dimensions:
            raise ValueError(
                f"n_nodes has {len(n_nodes)} entries but "
                f"num_dimensions={num_dimensions}"
            )

        self.device = torch.device(device)
        self.function = function
        self.num_dimensions = num_dimensions
        self.domain = [list(b) for b in domain]
        self.n_nodes = [int(n) for n in n_nodes]
        self.max_rank = max_rank
        self.tolerance = tolerance
        self.max_sweeps = max_sweeps
        self.max_derivative_order = max_derivative_order
        self.vectorized = bool(vectorized)

        self._coeff_cores: Optional[List[np.ndarray]] = None
        self._built = False
        self.descriptor: str = ""
        self.additional_data = additional_data
        self._tt_ranks: Optional[List[int]] = None
        self._build_time: float = 0.0
        self._total_build_evals: int = 0
        self._cached_error_estimate: Optional[float] = None
        self.method: Optional[str] = None
        # _dim_order[k] = original (user-frame) dim stored at TT position k.
        self._dim_order: List[int] = list(range(num_dimensions))

    # ------------------------------------------------------------------
    # Build
    # ------------------------------------------------------------------

    def _storage_grids(self) -> List[np.ndarray]:
        """Per-storage-position Chebyshev node arrays (ascending)."""
        return [
            nodes_for_dim_np(self.domain[d][0], self.domain[d][1],
                             self.n_nodes[d])
            for d in range(self.num_dimensions)
        ]

    def build(self, verbose: bool | int = True, seed: Optional[int] = None,
              method: str = "cross", init_rank: Optional[int] = None,
              kick: int = 2, refine_sweeps: int = 0,
              refine_samples: int = 0, mesh=None,
              data_axis: str = "dp") -> None:
        """Build value cores (cross / svd / als) on the host, convert to
        coefficient cores via the DCT-II cosine matrix.

        ``init_rank``/``kick`` (cross only): warm-start the cross with
        small random index sets and enrich them by ``kick`` random rows
        per stalled sweep.  Lets bond ranks grow past the per-dim node
        counts (up to ``max_rank``) for higher accuracy, where the
        default full-size start cannot.

        ``refine_sweeps``/``refine_samples`` (cross only): after the
        cross, run ``refine_sweeps`` masked-ALS completion sweeps over
        the entries the cross already evaluated (free) plus
        ``refine_samples`` extra random grid samples.  Defaults off, so
        that a seeded build is the plain cross.

        ``mesh`` (requires ``vectorized=True`` with a vectorized function
        of an (N, d) tensor): shard every oracle batch (the cross
        matrices, the full grid of svd/als, the refinement samples) over
        the mesh's ``data_axis``.  Eval counts match the unsharded build,
        and the cores are bit-identical to it whenever the function's
        value at a point does not depend on the batch around it.
        """
        if method not in ("cross", "svd", "als"):
            raise ValueError(
                f"method must be 'cross', 'svd', or 'als', got {method!r}"
            )
        if self.function is None:
            raise RuntimeError(
                "Cannot build: no function assigned. "
                "This object was created via from_values() or load()."
            )
        self.method = method
        start = time.time()
        self._cached_error_estimate = None

        full_tensor_size = int(np.prod(self.n_nodes))
        if verbose:
            print(f"Building {self.num_dimensions}D ChebyshevTT "
                  f"(max_rank={self.max_rank}, method={method!r})...")
            print(f"  Full tensor would need {full_tensor_size:,} "
                  f"evaluations")

        grids = self._storage_grids()
        oracle = self._oracle(grids, mesh, data_axis, "build")

        if method == "cross":
            if verbose:
                print("  Running TT-Cross...")
            value_cores = tta.tt_cross(
                oracle, list(self.n_nodes), max_rank=self.max_rank,
                tol=self.tolerance, max_sweeps=self.max_sweeps,
                verbose=verbose, seed=seed, init_rank=init_rank,
                kick=kick)
            if refine_sweeps > 0:
                if refine_samples > 0:
                    rng = np.random.default_rng(seed)
                    extra = np.column_stack([
                        rng.integers(0, nn, size=refine_samples)
                        for nn in self.n_nodes])
                    oracle.eval_many(np.unique(extra, axis=0))
                obs_idx, obs_vals = oracle.observations()
                value_cores = tta.masked_als_refine(
                    value_cores, obs_idx, obs_vals,
                    n_sweeps=refine_sweeps)
                if verbose:
                    print(f"  Masked-ALS refinement: {refine_sweeps} "
                          f"sweeps over {len(obs_vals):,} observed "
                          f"entries (total evals {oracle.n_evals:,})")
        elif method == "svd":
            if verbose:
                print(f"  Building full tensor "
                      f"({full_tensor_size:,} evaluations)...")
            target = oracle.full_tensor(list(self.n_nodes))
            value_cores = tta.tt_svd_from_tensor(
                target, max_rank=self.max_rank, tol=self.tolerance)
            if verbose:
                ranks = [1] + [c.shape[2] for c in value_cores]
                print(f"  TT-SVD ranks: {ranks}")
        else:  # als
            if verbose:
                print("  Running TT-ALS...")
            target = oracle.full_tensor(list(self.n_nodes))
            value_cores = tta.tt_als(
                target, max_rank=self.max_rank, tol=self.tolerance,
                random_state=seed, verbose=bool(verbose))

        self._total_build_evals = oracle.n_evals
        self._coeff_cores = [tta.value_core_to_coeff_core(c)
                             for c in value_cores]
        self._tt_ranks = [1] + [c.shape[2] for c in self._coeff_cores]
        self._build_time = time.time() - start
        self._built = True

        if verbose:
            tt_storage = sum(c.size for c in self._coeff_cores)
            print(f"  Built in {self._build_time:.3f}s "
                  f"({self._total_build_evals:,} function evaluations)")
            print(f"  TT ranks: {self._tt_ranks}")
            print(f"  Compression: {full_tensor_size:,} -> {tt_storage:,} "
                  f"elements ({full_tensor_size / tt_storage:.1f}x)")

    def _oracle(self, grids, mesh, data_axis: str, name: str):
        """The batched, caching oracle over ``grids``; under a mesh its
        batches shard over ``data_axis`` of the model's device."""
        oracle = tta.GridOracle(self.function, grids,
                                additional_data=self.additional_data,
                                vectorized=self.vectorized, mesh=mesh,
                                data_axis=data_axis)
        if mesh is not None:
            sharding.check_device(mesh, self.device,
                                  f"{type(self).__name__}.{name}")
        return oracle

    def _check_built(self) -> None:
        if not self._built:
            raise RuntimeError("Call build() before using this method.")

    # ------------------------------------------------------------------
    # Orthogonalization + completion
    # ------------------------------------------------------------------

    def orth_left(self, position: int) -> None:
        """Left-orthogonalize cores [0..position-1] in place (tensor
        unchanged; R factors absorbed rightward)."""
        self._check_built()
        d = self.num_dimensions
        if not (1 <= position < d):
            raise ValueError(
                f"position must be in [1, {d - 1}] for orth_left, "
                f"got {position}"
            )
        for k in range(position):
            self._coeff_cores[k], self._coeff_cores[k + 1] = (
                tta.orth_left_core(self._coeff_cores[k],
                                   self._coeff_cores[k + 1]))

    def orth_right(self, position: int) -> None:
        """Right-orthogonalize cores [position+1..d-1] in place."""
        self._check_built()
        d = self.num_dimensions
        if not (0 <= position < d - 1):
            raise ValueError(
                f"position must be in [0, {d - 2}] for orth_right, "
                f"got {position}"
            )
        for k in range(d - 1, position, -1):
            self._coeff_cores[k - 1], self._coeff_cores[k] = (
                tta.orth_right_core(self._coeff_cores[k - 1],
                                    self._coeff_cores[k]))

    def run_completion(self, tolerance: float = 1e-8, max_iter: int = 50,
                       verbose: bool = False, mesh=None,
                       data_axis: str = "dp") -> None:
        """Refine the TT at its current rank via fixed-rank ALS sweeps
        against fresh grid samples (re-evaluates the function on the full
        grid; rank does not grow).  ``mesh`` shards the full-grid
        oracle evaluation like :meth:`build`."""
        self._check_built()
        if self.function is None:
            raise RuntimeError(
                "run_completion requires self.function to be callable; "
                "the TT was loaded from a source without the original "
                "function."
            )
        value_cores = [tta.coeff_core_to_value_core(c)
                       for c in self._coeff_cores]
        oracle = self._oracle(self._storage_grids(), mesh, data_axis,
                              "run_completion")
        target = oracle.full_tensor(list(self.n_nodes))
        refined = tta.als_fixed_rank_sweeps(
            value_cores, target, tolerance=tolerance, max_iter=max_iter,
            verbose=verbose)
        self._coeff_cores = [tta.value_core_to_coeff_core(c)
                             for c in refined]
        self._cached_error_estimate = None

    # ------------------------------------------------------------------
    # Inner product / integration / calculus
    # ------------------------------------------------------------------

    def inner_product(self, other: "ChebyshevTT") -> float:
        """Frobenius inner product of the two coefficient tensors via
        core-chain contraction, O(d n r_s^2 r_o^2)."""
        self._check_built()
        if not isinstance(other, ChebyshevTT):
            raise ValueError(
                f"other must be a ChebyshevTT, got {type(other).__name__}"
            )
        other._check_built()
        if not np.allclose(np.asarray(self.domain, dtype=float),
                           np.asarray(other.domain, dtype=float)):
            raise ValueError(
                "inner_product requires matching domains; "
                f"got {self.domain} vs {other.domain}"
            )
        if list(self.n_nodes) != list(other.n_nodes):
            raise ValueError(
                "inner_product requires matching n_nodes; "
                f"got {self.n_nodes} vs {other.n_nodes}"
            )
        if list(self._dim_order) != list(other._dim_order):
            raise ValueError(
                f"inner_product requires matching _dim_order: "
                f"{self._dim_order} vs {other._dim_order}. "
                f"Call other = other.reorder(self._dim_order) to align "
                f"before computing inner_product."
            )
        m = np.array([[1.0]])
        for k in range(self.num_dimensions):
            m = np.einsum("ij,ipa,jpb->ab", m, self._coeff_cores[k],
                          other._coeff_cores[k])
        return float(m[0, 0])

    def _user_frame_domain(self) -> list:
        """Domain list indexed by user-frame dims."""
        return [self.domain[self._dim_order.index(u)]
                for u in range(self.num_dimensions)]

    def to_dense(self) -> np.ndarray:
        """Materialize the full value tensor (axes in user-frame order)."""
        self._check_built()
        value_cores = [tta.coeff_core_to_value_core(c)
                       for c in self._coeff_cores]
        result = tta.tt_reconstruct(value_cores).reshape(
            tuple(self.n_nodes))
        canonical = list(range(self.num_dimensions))
        if self._dim_order != canonical:
            inv = [0] * self.num_dimensions
            for storage_pos, orig_dim in enumerate(self._dim_order):
                inv[orig_dim] = storage_pos
            result = np.transpose(result, axes=inv)
        return result

    def integrate(self, dims=None, bounds=None):
        """Fejer-1 quadrature contraction through the value cores (host
        NumPy).

        Full integration chains the contracted (r_l, r_r) matrices to a
        scalar; partial integration absorbs pending matrices into the
        next kept core.  ``dims``/``bounds`` are user-frame.
        """
        self._check_built()
        if dims is None:
            dims_sorted = list(range(self.num_dimensions))
        elif isinstance(dims, int):
            dims_sorted = [dims]
        else:
            dims_sorted = sorted(set(dims))

        if any(d < 0 or d >= self.num_dimensions for d in dims_sorted):
            raise ValueError(
                f"dims contains out-of-range index "
                f"(num_dimensions={self.num_dimensions}, dims={dims_sorted})"
            )

        storage_for = {d: self._dim_order.index(d) for d in dims_sorted}
        integrated_storage = sorted(storage_for.values())
        integrated_set = set(integrated_storage)

        bounds_storage_dims = [storage_for[d] for d in dims_sorted]
        normalized = normalize_bounds(
            bounds_storage_dims, bounds, self.domain,
            dim_labels=dims_sorted)

        # Quadrature weights per storage position (physical scaling
        # baked in; the products are new arrays, the cache stays).
        weights_per_storage = {}
        for sp, bd in zip(bounds_storage_dims, normalized):
            n = self.n_nodes[sp]
            a, b = self.domain[sp]
            scale = (b - a) / 2.0
            if bd is None:
                weights_per_storage[sp] = fejer1_weights(n) * scale
            else:
                t_lo = 2.0 * (bd[0] - a) / (b - a) - 1.0
                t_hi = 2.0 * (bd[1] - a) / (b - a) - 1.0
                weights_per_storage[sp] = (
                    sub_interval_weights(n, t_lo, t_hi) * scale)

        contracted = {}
        for sp in integrated_storage:
            val_core = tta.coeff_core_to_value_core(self._coeff_cores[sp])
            contracted[sp] = np.einsum("rjs,j->rs", val_core,
                                       weights_per_storage[sp])

        if len(dims_sorted) == self.num_dimensions:
            result = contracted[integrated_storage[0]]
            for sp in integrated_storage[1:]:
                result = result @ contracted[sp]
            return float(result.ravel()[0])

        # Partial: absorb pending products into the next kept core.
        new_cores = []
        pending = None
        for k in range(self.num_dimensions):
            if k in integrated_set:
                m = contracted[k]
                pending = m if pending is None else pending @ m
                continue
            core = self._coeff_cores[k].copy()
            if pending is not None:
                core = np.einsum("lr,rjs->ljs", pending, core)
                pending = None
            new_cores.append(core)
        if pending is not None and new_cores:
            new_cores[-1] = np.einsum("ljs,sr->ljr", new_cores[-1], pending)

        kept = [sp for sp in range(self.num_dimensions)
                if sp not in integrated_set]
        return self._assemble(
            cores=new_cores,
            domain=[self.domain[sp] for sp in kept],
            n_nodes=[self.n_nodes[sp] for sp in kept],
            dim_order=self._renumbered([self._dim_order[sp] for sp in kept],
                                       set(dims_sorted)),
        )

    def _renumbered(self, live_dims, removed) -> List[int]:
        """Surviving user dims renumbered ascending (removed dims out)."""
        new_index = {}
        for orig_d in range(self.num_dimensions):
            if orig_d not in removed:
                new_index[orig_d] = len(new_index)
        return [new_index[d] for d in live_dims]

    def _storage_boxes(self, bounds) -> np.ndarray:
        """Validated user-frame (B, d, 2) boxes, columns permuted into
        the storage frame."""
        arr = normalize_bounds_batch(host_array(bounds),
                                     self._user_frame_domain())
        if self._dim_order != list(range(self.num_dimensions)):
            arr = arr[:, self._dim_order, :]
        return arr

    def integrate_batch(self, bounds, dtype=None) -> np.ndarray:
        """Integrals over a batch of axis-aligned boxes in one pass.

        The coefficient-core rank chain runs with Chebyshev moment rows
        instead of polynomial rows (``ops.integrate.
        tt_integrate_box_batch``), on the device.

        Parameters
        ----------
        bounds : (B, d, 2) array-like: per-box, per-dim (lo, hi) in the
            USER frame, inside the domain.  Zero-measure dims integrate
            to an exact 0.
        dtype : None (f64), ``torch.float32``, or ``"dd"`` (native f64
            on the ``groups="auto"`` chain; chains outside the
            reference's dd plan take the f64 path).

        Returns
        -------
        (B,) ndarray of box integrals.
        """
        self._check_built()
        arr = self._storage_boxes(bounds)
        tier = integrate_ops.tier(dtype)
        domain = np.asarray(self.domain, dtype=np.float64)
        if tier == "dd":
            cores = self._cores_on_device(torch.float64)
            if tt_eval_dd.tt_supports_dd([c.shape for c in cores]):
                return integrate_ops.tt_integrate_box_batch_dd(
                    cores, domain, arr, groups="auto").cpu().numpy()
            tier = torch.float64
        return integrate_ops.tt_integrate_box_batch(
            self._cores_on_device(tier), domain, arr,
            dtype=tier).cpu().numpy()

    def partial_integrate_batch(self, dims, bounds, points,
                                dtype=None) -> np.ndarray:
        """Batched conditional expectations (user frame): integrate over
        per-scenario boxes on ``dims``, evaluate the remaining dims at
        per-scenario coordinates, in one rank chain (moment rows on
        integrated dims, polynomial rows elsewhere; value only).

        ``bounds``: (B, len(dims), 2) in sorted user-``dims`` order;
        ``points``: (B, d - len(dims)) in ascending remaining user-dim
        order.  ``dtype`` as in :meth:`integrate_batch`.  Returns (B,).
        """
        self._check_built()
        dims, arr, remaining, pts, _ = \
            validate_partial_integrate_args_batch(
                self.num_dimensions, self._user_frame_domain(), dims,
                host_array(bounds), host_array(points))

        # User -> storage frame: the chain's int_dims are storage
        # positions; its bounds/points columns follow storage order.
        storage_int = sorted(self._dim_order.index(k) for k in dims)
        arr_cols = [dims.index(self._dim_order[sp]) for sp in storage_int]
        storage_rem = [sp for sp in range(self.num_dimensions)
                       if sp not in set(storage_int)]
        pts_cols = [remaining.index(self._dim_order[sp])
                    for sp in storage_rem]
        args = (np.asarray(self.domain, dtype=np.float64),
                tuple(storage_int), arr[:, arr_cols, :], pts[:, pts_cols])
        tier = integrate_ops.tier(dtype)
        if tier == "dd":
            cores = self._cores_on_device(torch.float64)
            if tt_eval_dd.tt_supports_dd([c.shape for c in cores]):
                return integrate_ops.tt_partial_integrate_eval_batch_dd(
                    cores, *args, groups="auto").cpu().numpy()
            tier = torch.float64
        return integrate_ops.tt_partial_integrate_eval_batch(
            self._cores_on_device(tier), *args, dtype=tier).cpu().numpy()

    def _to_1d_chebyshev(self, sliced_1d: "ChebyshevTT"):
        """1-D dense ChebyshevApproximation (on this device) from a 1-D
        TT."""
        from pychebyshev_tpu_torch.models.approximation import (
            ChebyshevApproximation,
        )
        assert sliced_1d.num_dimensions == 1
        values = np.asarray(sliced_1d.to_dense(), dtype=float).reshape(-1)
        a, b = sliced_1d.domain[0]
        return ChebyshevApproximation.from_values(
            values, num_dimensions=1, domain=[(float(a), float(b))],
            n_nodes=[int(sliced_1d.n_nodes[0])], device=self.device)

    def _sliced_1d(self, dim, fixed) -> "ChebyshevTT":
        dim, slice_params = validate_calculus_args(
            self.num_dimensions, dim, fixed, self._user_frame_domain())
        return self._to_1d_chebyshev(
            self.slice(slice_params) if slice_params else self)

    def roots(self, dim=None, fixed=None):
        """Roots along *dim* (user frame): slice to 1-D, resample dense,
        colleague-matrix root finding."""
        self._check_built()
        return self._sliced_1d(dim, fixed).roots()

    def minimize(self, dim=None, fixed=None, *, tol=1e-9,
                 max_boxes=50000, polish=True):
        """Minimum of the TT.

        With ``dim``: the 1-D minimum along that user-frame dim —
        ``(value, location)`` floats.  With ``dim=None`` on a
        multi-dimensional TT: the GLOBAL minimum over the whole box via
        branch-and-bound directly through the coefficient cores
        (``ops.subdivision.minimize_tt_cores`` — no ``n^d``
        materialization; the enclosure is the interval transfer-matrix
        bound, so certification can need more boxes than the dense
        path).  Returns ``(value, point)`` with an ``(ndim,)``
        user-frame point; ``fixed`` may pin a subset.
        """
        return self._optimize(dim, fixed, "min", tol=tol,
                              max_boxes=max_boxes, polish=polish)

    def maximize(self, dim=None, fixed=None, *, tol=1e-9,
                 max_boxes=50000, polish=True):
        """Maximum of the TT — see :meth:`minimize` for the 1-D
        (``dim`` given) vs global (``dim=None``) forms."""
        return self._optimize(dim, fixed, "max", tol=tol,
                              max_boxes=max_boxes, polish=polish)

    def critical_points(self, fixed=None, *, grad_tol=1e-8, delta=5e-3,
                        max_boxes=50000, separation=1e-6):
        """All interior stationary points: interval-transfer-chain
        isolation on the d analytic gradient TTs (no ``n^d``
        materialization), Newton polish through gradient/Hessian TTs,
        Hessian classification.  See
        ``ChebyshevApproximation.critical_points``."""
        self._check_built()
        return globalcalc.critical_points_tt(
            self, fixed=fixed, grad_tol=grad_tol, delta=delta,
            max_boxes=max_boxes, separation=separation)

    def _optimize(self, dim, fixed, mode, *, tol=1e-9, max_boxes=50000,
                  polish=True):
        self._check_built()
        if dim is None and self.num_dimensions > 1:
            return globalcalc.global_optimize_tt(
                self, mode, fixed, tol=tol, max_boxes=max_boxes,
                polish=polish)
        one_d = self._sliced_1d(dim, fixed)
        return one_d.minimize() if mode == "min" else one_d.maximize()

    def _scenario_slice_values(self, dim, fixed_cols, batch):
        """(B, n) slice values along user-frame *dim*: one batched f64
        chain at the dim's own nodes on the device (exact), then to the
        host."""
        lo, hi = self._user_frame_domain()[dim]
        n = int(self.n_nodes[self._dim_order.index(dim)])
        nodes = nodes_for_dim_np(float(lo), float(hi), n)
        pts = scenario_slice_points(
            self.num_dimensions, dim, fixed_cols, batch, nodes)
        vals = self.eval_batch(pts).cpu().numpy()
        return vals.reshape(batch, n), nodes, (float(lo), float(hi))

    def roots_batch(self, dim=None, fixed=None) -> list:
        """Roots along user-frame *dim* for a batch of scenarios (scalar
        or (B,) arrays in ``fixed``): a list of B sorted root arrays;
        one batched chain plus one stacked colleague eigensolve."""
        self._check_built()
        dim, cols, batch = validate_calculus_args_batch(
            self.num_dimensions, dim, fixed, self._user_frame_domain())
        vals, _, dom = self._scenario_slice_values(dim, cols, batch)
        return roots_1d_batch(vals, dom)

    def minimize_batch(self, dim=None, fixed=None):
        """Batched :meth:`minimize`: ((B,) values, (B,) locations)."""
        return self._optimize_batch(dim, fixed, "min")

    def maximize_batch(self, dim=None, fixed=None):
        """Batched :meth:`maximize`: ((B,) values, (B,) locations)."""
        return self._optimize_batch(dim, fixed, "max")

    def _optimize_batch(self, dim, fixed, mode):
        self._check_built()
        dim, cols, batch = validate_calculus_args_batch(
            self.num_dimensions, dim, fixed, self._user_frame_domain())
        vals, nodes, dom = self._scenario_slice_values(dim, cols, batch)
        return optimize_resampled_batch(vals, nodes, dom, mode)

    def to_slider(self, partition, pivot_point):
        """Additive (sliding-technique) projection of this TT, with zero
        function evaluations.

        Builds ``f(z) + sum_g [f|_{off-group dims at z}(x_g) - f(z)]``
        from the TT: every slide is an exact TT ``slice`` at the pivot,
        densified over its few group dims.  Exact to the TT's own
        accuracy when f is additive across ``partition``; otherwise the
        sliding-technique approximation.  The inverse direction of
        :meth:`ChebyshevSlider.to_tt`; the slider lives on this TT's
        device.
        """
        self._check_built()
        from pychebyshev_tpu_torch.models.approximation import (
            ChebyshevApproximation,
        )
        from pychebyshev_tpu_torch.models.slider import ChebyshevSlider

        groups_in = [list(g) for g in partition]
        if any(len(g) == 0 for g in groups_in):
            raise ValueError("Partition groups must be non-empty")
        if any(int(d) != d for g in groups_in for d in g):
            raise ValueError(
                f"Partition dims must be integers; got {groups_in}")
        partition = [[int(d) for d in g] for g in groups_in]
        covered = sorted(d for g in partition for d in g)
        if covered != list(range(self.num_dimensions)):
            raise ValueError(
                f"Partition must cover all dimensions "
                f"0..{self.num_dimensions - 1} exactly once. "
                f"Got dimensions: {covered}"
            )
        pivot_point = [float(v) for v in pivot_point]
        if len(pivot_point) != self.num_dimensions:
            raise ValueError(
                f"pivot_point length {len(pivot_point)} does not match "
                f"num_dimensions {self.num_dimensions}"
            )
        user_domain = self._user_frame_domain()
        user_n = [self.n_nodes[self._dim_order.index(u)]
                  for u in range(self.num_dimensions)]
        for d, v in enumerate(pivot_point):
            lo, hi = user_domain[d]
            if v < lo or v > hi:
                raise ValueError(
                    f"pivot_point[{d}] = {v} is outside the domain "
                    f"[{lo}, {hi}]"
                )

        pivot_value = float(self.eval(pivot_point))
        slides = []
        for group in partition:
            off = [(d, pivot_point[d]) for d in range(self.num_dimensions)
                   if d not in group]
            sub = self.slice(off) if off else self
            # slice renumbers survivors ascending; reorder the dense
            # axes to the group's listed order.
            values = sub.to_dense()
            ascending = sorted(group)
            perm = [ascending.index(d) for d in group]
            if perm != list(range(len(group))):
                values = np.transpose(values, axes=perm)
            slides.append(ChebyshevApproximation.from_values(
                values, len(group), [user_domain[d] for d in group],
                [user_n[d] for d in group],
                max_derivative_order=self.max_derivative_order,
                device=self.device))

        return ChebyshevSlider._assemble(
            num_dimensions=self.num_dimensions, domain=user_domain,
            n_nodes=user_n, partition=partition,
            pivot_point=pivot_point, slides=slides,
            pivot_value=pivot_value,
            max_derivative_order=self.max_derivative_order,
            device=self.device, descriptor=self.descriptor,
            additional_data=self.additional_data)

    # ------------------------------------------------------------------
    # Extrude / slice
    # ------------------------------------------------------------------

    def extrude(self, params) -> "ChebyshevTT":
        """Insert rank-preserving constant cores for the new dims.

        In coefficient space the constant function 1 has only c0 = 1, so
        the inserted core is ``core[i, 0, i] = 1``.
        """
        self._check_built()
        norm_params = normalize_extrusion_params(params, self.num_dimensions)
        identity = self._dim_order == list(range(self.num_dimensions))

        new_cores = list(self._coeff_cores)
        new_domain = list(self.domain)
        new_n_nodes = list(self.n_nodes)
        new_dim_order = list(self._dim_order)

        def _insert_constant_core(cores, pos, n_new):
            if pos == 0 or pos == len(cores):
                r_at = 1
            else:
                r_at = cores[pos - 1].shape[2]
            core = np.zeros((r_at, n_new, r_at))
            core[:, 0, :] = np.eye(r_at)
            return cores[:pos] + [core] + cores[pos:]

        for dim_idx, (lo, hi), n_new in sorted(norm_params,
                                               key=lambda p: p[0]):
            if identity:
                new_cores = _insert_constant_core(new_cores, dim_idx, n_new)
                new_domain.insert(dim_idx, [lo, hi])
                new_n_nodes.insert(dim_idx, n_new)
                new_dim_order = list(range(len(new_cores)))
            else:
                storage_pos = len(new_cores)
                new_cores = _insert_constant_core(new_cores, storage_pos,
                                                  n_new)
                new_domain.append([lo, hi])
                new_n_nodes.append(n_new)
                new_dim_order = [d if d < dim_idx else d + 1
                                 for d in new_dim_order]
                new_dim_order.append(dim_idx)

        return self._assemble(new_cores, new_domain, new_n_nodes,
                              new_dim_order)

    def slice(self, params) -> "ChebyshevTT":
        """Contract cores at fixed values (barycentric row in value
        space, absorbed into a neighbor core).  ``params`` is
        user-frame."""
        self._check_built()
        norm_params = normalize_slicing_params(params, self.num_dimensions)

        # Validate values in user frame against storage-frame domains.
        for dim_idx, value in norm_params:
            storage_pos = self._dim_order.index(dim_idx)
            lo, hi = self.domain[storage_pos]
            if value < lo or value > hi:
                raise ValueError(
                    f"Slice value {value} for dim {dim_idx} is outside "
                    f"domain [{lo}, {hi}]"
                )

        new_cores = list(self._coeff_cores)
        new_domain = list(self.domain)
        new_n_nodes = list(self.n_nodes)
        live_dim_order = list(self._dim_order)

        translated = [(live_dim_order.index(dim_idx), value)
                      for dim_idx, value in norm_params]
        for storage_pos, value in sorted(translated, key=lambda t: -t[0]):
            lo, hi = new_domain[storage_pos]
            nodes = nodes_for_dim_np(lo, hi, new_n_nodes[storage_pos])
            value_core = tta.coeff_core_to_value_core(
                new_cores[storage_pos])

            diff = value - nodes
            exact_idx = int(np.argmin(np.abs(diff)))
            if np.abs(diff[exact_idx]) < NODE_COINCIDENCE_TOL:
                m = value_core[:, exact_idx, :]
            else:
                w = barycentric_weights_np(nodes)
                w_over_diff = w / diff
                w_norm = w_over_diff / np.sum(w_over_diff)
                m = np.einsum("rjs,j->rs", value_core, w_norm)

            if storage_pos < len(new_cores) - 1:
                new_cores[storage_pos + 1] = np.einsum(
                    "lr,rjs->ljs", m, new_cores[storage_pos + 1])
            else:
                new_cores[storage_pos - 1] = np.einsum(
                    "ijs,sr->ijr", new_cores[storage_pos - 1], m)
            del new_cores[storage_pos]
            new_domain.pop(storage_pos)
            new_n_nodes.pop(storage_pos)
            live_dim_order.pop(storage_pos)

        if len(new_cores) == 0:
            raise RuntimeError("internal error: cannot slice all dimensions")

        return self._assemble(
            new_cores, new_domain, new_n_nodes,
            self._renumbered(live_dim_order,
                             {dim_idx for dim_idx, _ in norm_params}))

    def _assemble(self, cores, domain, n_nodes, dim_order,
                  max_rank=None) -> "ChebyshevTT":
        """Internal factory for derived TTs (algebra/reorder/
        differentiate results), on this object's device."""
        obj = self.__class__.__new__(self.__class__)
        obj.device = self.device
        obj.function = None
        obj.num_dimensions = len(n_nodes)
        obj.domain = [list(b) for b in domain]
        obj.n_nodes = [int(n) for n in n_nodes]
        obj.max_rank = self.max_rank if max_rank is None else max_rank
        obj.tolerance = self.tolerance
        obj.max_sweeps = self.max_sweeps
        obj.max_derivative_order = self.max_derivative_order
        obj.additional_data = self.additional_data
        obj.descriptor = self.descriptor
        obj.method = self.method
        obj.vectorized = False
        obj._coeff_cores = cores
        obj._tt_ranks = [c.shape[0] for c in cores] + [cores[-1].shape[2]]
        obj._built = True
        obj._build_time = 0.0
        obj._total_build_evals = 0
        obj._cached_error_estimate = None
        obj._dim_order = list(dim_order)
        return obj

    # ------------------------------------------------------------------
    # Evaluation
    # ------------------------------------------------------------------

    def _storage_point(self, point):
        canonical = list(range(self.num_dimensions))
        if self._dim_order != canonical:
            return [point[self._dim_order[k]]
                    for k in range(self.num_dimensions)]
        return list(point)

    def eval(self, point) -> float:
        """Evaluate at a single point via the TT contraction chain."""
        self._check_built()
        point_storage = self._storage_point(point)
        return self._eval_storage_frame(point_storage,
                                        [0] * self.num_dimensions)

    def _eval_storage_frame(self, point_storage, derivative_order_storage
                            ) -> float:
        """Evaluate at a storage-frame point (value or FD derivative).

        Single points run the contraction chain on the host: through
        the C kernel where the library is available (it declines nothing
        a well-formed chain can hold), else in NumPy.  The device path
        would pay a dispatch per call; batches belong in
        :meth:`eval_batch`.
        """
        if all(o == 0 for o in derivative_order_storage):
            pack = self._host_cpack()
            if pack is not None:
                pt = np.ascontiguousarray(point_storage,
                                          dtype=np.float64)
                if pt.ndim == 1 and pt.shape[0] == self.num_dimensions:
                    val = ceval.tt_eval_single(pack, pt)
                    if val is not None:
                        return val
            row = np.ones((1, 1))
            for d, core in enumerate(self._coeff_cores):
                a, b = self.domain[d]
                scaled = 2.0 * (point_storage[d] - a) / (b - a) - 1.0
                n = core.shape[1]
                q = np.empty(n)
                q[0] = 1.0
                if n > 1:
                    q[1] = scaled
                for k in range(2, n):
                    q[k] = 2.0 * scaled * q[k - 1] - q[k - 2]
                row = row @ np.einsum("j,ijk->ik", q, core)
            return float(row[0, 0])
        return self._fd_derivative(point_storage, derivative_order_storage)

    def _host_cpack(self):
        """ctypes pack for the C single-point kernel, cached with the
        same identity-keyed discipline as :meth:`_cores_on_device`
        (mutation paths replace core ndarrays; the keyed tuple is
        retained so ids cannot be recycled)."""
        cores = tuple(self._coeff_cores)
        hit = self.__dict__.get("_host_cpack_cache")
        if hit is not None and _same_arrays(hit[0], cores):
            return hit[1]
        pack = ceval.make_tt_pack(cores, np.asarray(self.domain,
                                                    dtype=np.float64))
        self.__dict__["_host_cpack_cache"] = (cores, pack)
        return pack

    def _cores_on_device(self, dtype) -> tuple:
        """Device copies of the coefficient cores, cached per dtype and
        device.

        Keyed on the host core arrays' identities, with the keyed
        ndarrays RETAINED in the cache entry: every mutation path in
        this class REPLACES core ndarrays (orth / rounding / algebra
        assemble fresh arrays), so changed cores miss, and pinning the
        old arrays keeps their ids from being recycled by the allocator,
        which would otherwise let a twice-replaced core list collide
        with a stale entry.  The device tensors themselves are private
        to this cache, so nothing edits them in place.  Avoids
        re-uploading the cores on every batched eval.
        """
        cache = self.__dict__.setdefault("_dev_cores", {})
        dkey = (dtype, str(self.device))
        cores = tuple(self._coeff_cores)
        hit = cache.get(dkey)
        if hit is not None and _same_arrays(hit[0], cores):
            return hit[1]
        dev = tuple(torch.tensor(c, dtype=dtype, device=self.device)
                    for c in cores)
        cache[dkey] = (cores, dev)
        return dev

    def _storage_points(self, points, dtype=torch.float64) -> torch.Tensor:
        """(N, d) user-frame points as a tensor on the device at
        ``dtype``, columns permuted into the storage frame."""
        pts = torch.as_tensor(points, dtype=dtype, device=self.device)
        if pts.dim() != 2 or pts.shape[1] != self.num_dimensions:
            raise ValueError(
                f"points must have shape (N, {self.num_dimensions}), "
                f"got {tuple(pts.shape)}")
        if self._dim_order != list(range(self.num_dimensions)):
            pts = pts[:, self._dim_order]
        return pts

    def eval_batch(self, points) -> torch.Tensor:
        """Evaluate at (N, d) points in f64 -> (N,) tensor on the
        device."""
        self._check_built()
        return tt_eval_batch(self._cores_on_device(torch.float64),
                             np.asarray(self.domain, dtype=np.float64),
                             self._storage_points(points))

    def eval_batch_dd(self, points, mode: str = "accurate",
                      groups="auto") -> torch.Tensor:
        """Near-f64 batched evaluation -> (N,) f64 tensor on the device.

        The reference's dd tier (``ops.tt_eval_dd``), served in native
        f64: the same chain as :meth:`eval_batch`, per-dim or grouped.
        Core shapes outside the reference's digit-plan budget, and
        out-of-domain batches, take the per-dim f64 chain, as in the
        reference.

        ``mode``: ``"accurate"`` (default) or ``"fast"``; the reference
        trades accuracy for speed there, while f64 already meets both
        modes' accuracy, so the result is the same.

        ``groups``: ``"auto"`` (default) serves the grouping
        ``tt_dd_auto_groups`` picks; ``None`` forces the per-dim chain;
        a tuple of contiguous group sizes pins an explicit grouping.
        """
        self._check_built()
        if mode not in ("accurate", "fast"):
            raise ValueError(
                f"mode must be 'accurate' or 'fast', got {mode!r}")
        pts = self._storage_points(points)
        cores = self._cores_on_device(torch.float64)
        domain = np.asarray(self.domain, dtype=np.float64)
        dom = torch.tensor(domain, device=self.device)
        # One device-to-host read decides the route for the whole batch.
        out_of_domain = bool(((pts < dom[:, 0]) | (pts > dom[:, 1]))
                             .any().item())
        if not out_of_domain and tt_eval_dd.tt_supports_dd(
                [c.shape for c in cores]):
            cutoff = (tt_eval_dd.FAST_PAIR_CUTOFF if mode == "fast"
                      else None)
            return tt_eval_dd.tt_eval_batch_dd(cores, domain, pts,
                                               cutoff=cutoff,
                                               groups=groups)
        return tt_eval_batch(cores, domain, pts)

    def eval_multi(self, point, derivative_orders) -> List[float]:
        """Value + finite-difference derivatives at one point.

        Coordinates and orders are permuted once into storage frame, then
        each spec evaluates through the storage-frame helper (no
        ``_dim_order`` mutation: the race-free discipline).
        """
        self._check_built()
        canonical = list(range(self.num_dimensions))
        if self._dim_order != canonical:
            point_storage = [point[self._dim_order[k]]
                             for k in range(self.num_dimensions)]
            derivs_storage = [
                [do[self._dim_order[k]] for k in range(self.num_dimensions)]
                for do in derivative_orders
            ]
        else:
            point_storage = list(point)
            derivs_storage = [list(do) for do in derivative_orders]
        return [self._eval_storage_frame(point_storage, ds)
                for ds in derivs_storage]

    # Cross-family naming symmetry with the dense class.
    vectorized_eval = eval
    vectorized_eval_multi = eval_multi

    def _eval_batch_multi_device(self, points, derivative_orders
                                 ) -> torch.Tensor:
        """:meth:`vectorized_eval_batch_multi` with the result left on
        the device.  The shifted batches are built there too: the clip
        (``a + 1.5h``, ``b - 1.5h``), steps and coefficients are the
        per-point path's, in the same order."""
        self._check_built()
        # Validate spec lengths BEFORE the dim-order remap: indexing a
        # too-short spec through a permuted _dim_order would raise a
        # confusing IndexError instead of this ValueError.
        for do in derivative_orders:
            if len(do) != self.num_dimensions:
                raise ValueError(
                    f"derivative_order length {len(do)} does not "
                    f"match num_dimensions {self.num_dimensions}"
                )
        pts = self._storage_points(points)
        derivs = [[do[self._dim_order[k]]
                   for k in range(self.num_dimensions)]
                  for do in derivative_orders]

        n = pts.shape[0]
        if not derivs:
            return pts.new_zeros((n, 0))
        stacks = []       # shifted point batches, one (N, d) per term
        combine = []      # per spec: list of (stack offset, coeff)
        for do in derivs:
            active = [(d, int(o)) for d, o in enumerate(do) if o > 0]
            if any(o not in (1, 2) for _, o in active):
                bad = next(o for _, o in active if o not in (1, 2))
                raise ValueError(
                    f"Derivative order {bad} not supported (use 1 or 2)")
            base = pts.clone()
            steps = {}
            for d, _ in active:
                h = self._fd_step(d)
                a, b = self.domain[d]
                base[:, d].clamp_(a + 1.5 * h, b - 1.5 * h)
                steps[d] = h
            # Tensor-product stencil across the active dims.
            terms = [({}, 1.0)]
            for d, order in active:
                h = steps[d]
                if order == 1:
                    stencil = [(h, 0.5 / h), (-h, -0.5 / h)]
                else:
                    inv_h2 = 1.0 / (h * h)
                    stencil = [(h, inv_h2), (0.0, -2.0 * inv_h2),
                               (-h, inv_h2)]
                terms = [({**shifts, d: delta}, c * w)
                         for shifts, c in terms
                         for delta, w in stencil]
            spec_terms = []
            for shifts, coeff in terms:
                shifted = base.clone()
                for d, delta in shifts.items():
                    shifted[:, d] += delta
                spec_terms.append((len(stacks), coeff))
                stacks.append(shifted)
            combine.append(spec_terms)

        all_vals = tt_eval_batch(
            self._cores_on_device(torch.float64),
            np.asarray(self.domain, dtype=np.float64),
            torch.cat(stacks, dim=0))
        out = pts.new_zeros((n, len(derivs)))
        for j, spec_terms in enumerate(combine):
            for offset, coeff in spec_terms:
                out[:, j] += coeff * all_vals[offset * n:(offset + 1) * n]
        return out

    def vectorized_eval_batch_multi(self, points, derivative_orders
                                    ) -> np.ndarray:
        """Batch x multi-spec evaluation -> (N, len(derivative_orders))
        NumPy array.

        A whole TT Greek report in one batched chain.  Each spec's
        central-difference stencil (the same per-dim {+h, -h} /
        {+h, 0, -h} products with boundary nudges that
        :meth:`eval_multi` applies point-at-a-time) is expanded into
        shifted copies of the query batch on the device; every shifted
        batch from every spec is concatenated and evaluated in ONE
        ``tt_eval_batch`` call, then recombined with the stencil
        coefficients.  The stencil (points, shifts, coefficients) is
        identical to the per-point path; only the contraction backend
        differs, so agreement is to roundoff.
        """
        return self._eval_batch_multi_device(
            points, derivative_orders).cpu().numpy()

    eval_batch_multi = vectorized_eval_batch_multi

    # --- finite differences (storage frame) ---------------------------

    def _fd_step(self, d: int) -> float:
        a, b = self.domain[d]
        return (b - a) * 1e-4

    def _nudge_point(self, point, d: int, h: float):
        pt = list(point)
        a, b = self.domain[d]
        needed = h * 1.5
        if pt[d] - a < needed:
            pt[d] = a + needed
        if b - pt[d] < needed:
            pt[d] = b - needed
        return pt

    def _fd_derivative(self, point, deriv_order) -> float:
        active = [(d, o) for d, o in enumerate(deriv_order) if o > 0]
        if len(active) == 1:
            d, order = active[0]
            return self._fd_single_dim(point, d, order)
        if len(active) == 2:
            (d1, o1), (d2, o2) = active
            if o1 == 1 and o2 == 1:
                return self._fd_cross_deriv(point, d1, d2)
        return self._fd_nested(point, active)

    def _fd_single_dim(self, point, d: int, order: int) -> float:
        h = self._fd_step(d)
        pt = self._nudge_point(point, d, h)
        zero = [0] * self.num_dimensions
        pt_plus, pt_minus = list(pt), list(pt)
        pt_plus[d] += h
        pt_minus[d] -= h
        if order == 1:
            return (self._eval_storage_frame(pt_plus, zero)
                    - self._eval_storage_frame(pt_minus, zero)) / (2.0 * h)
        if order == 2:
            f_plus = self._eval_storage_frame(pt_plus, zero)
            f_center = self._eval_storage_frame(pt, zero)
            f_minus = self._eval_storage_frame(pt_minus, zero)
            return (f_plus - 2.0 * f_center + f_minus) / (h * h)
        raise ValueError(
            f"Derivative order {order} not supported (use 1 or 2)")

    def _fd_cross_deriv(self, point, d1: int, d2: int) -> float:
        h1, h2 = self._fd_step(d1), self._fd_step(d2)
        pt = self._nudge_point(self._nudge_point(point, d1, h1), d2, h2)
        zero = [0] * self.num_dimensions

        def at(delta1, delta2):
            p = list(pt)
            p[d1] += delta1
            p[d2] += delta2
            return self._eval_storage_frame(p, zero)

        return (at(h1, h2) - at(h1, -h2) - at(-h1, h2)
                + at(-h1, -h2)) / (4.0 * h1 * h2)

    def _fd_nested(self, point, active_dims) -> float:
        if not active_dims:
            return self._eval_storage_frame(point,
                                            [0] * self.num_dimensions)
        d, order = active_dims[0]
        remaining = active_dims[1:]
        h = self._fd_step(d)
        pt = self._nudge_point(point, d, h)
        pt_plus, pt_minus = list(pt), list(pt)
        pt_plus[d] += h
        pt_minus[d] -= h
        if order == 1:
            return (self._fd_nested(pt_plus, remaining)
                    - self._fd_nested(pt_minus, remaining)) / (2.0 * h)
        if order == 2:
            return (self._fd_nested(pt_plus, remaining)
                    - 2.0 * self._fd_nested(pt, remaining)
                    + self._fd_nested(pt_minus, remaining)) / (h * h)
        raise ValueError(
            f"Derivative order {order} not supported (use 1 or 2)")

    # ------------------------------------------------------------------
    # Error estimate + properties
    # ------------------------------------------------------------------

    def differentiate(self, derivative_order) -> "ChebyshevTT":
        """Analytic spectral derivative as a new TT.

        Applies the barycentric differentiation matrix along the node
        axis of each targeted core in *value space* (convert core ->
        values, ``D^k`` passes, convert back); rank structure is
        untouched, so the result is an exact TT of the interpolant's
        derivative.  Evaluating it matches the dense class's analytic
        derivatives to roundoff, unlike the central finite differences
        of :meth:`eval_multi`.

        Parameters
        ----------
        derivative_order : sequence of int (user-frame, one per dim).
        """
        self._check_built()
        if len(derivative_order) != self.num_dimensions:
            raise ValueError(
                f"derivative_order length {len(derivative_order)} does "
                f"not match num_dimensions {self.num_dimensions}"
            )

        new_cores = []
        for sp, core in enumerate(self._coeff_cores):
            order = int(derivative_order[self._dim_order[sp]])
            if order == 0:
                new_cores.append(core.copy())
                continue
            if order < 0:
                raise ValueError(
                    f"derivative order must be >= 0, got {order}"
                )
            lo, hi = self.domain[sp]
            nodes = nodes_for_dim_np(lo, hi, self.n_nodes[sp])
            d_mat = differentiation_matrix_np(
                nodes, barycentric_weights_np(nodes))
            value_core = tta.coeff_core_to_value_core(core)
            for _ in range(order):
                value_core = np.einsum("ij,ajb->aib", d_mat, value_core)
            new_cores.append(tta.value_core_to_coeff_core(value_core))

        return self._assemble(new_cores, self.domain, self.n_nodes,
                              self._dim_order)

    def error_estimate(self, tail: int = 1) -> float:
        """Sum over dims of max |last Chebyshev coefficient| in each core.

        ``tail=2`` reads the last two coefficient slices per core —
        robust to parity-symmetric functions whose alternating zero
        coefficients blank the single-slice probe (see
        ChebyshevApproximation.error_estimate)."""
        self._check_built()
        if tail == 1 and self._cached_error_estimate is not None:
            return self._cached_error_estimate
        total = sum(
            float(np.max(np.abs(core[:, -min(max(1, int(tail)),
                                             core.shape[1]):, :])))
            for core in self._coeff_cores)
        if tail == 1:
            self._cached_error_estimate = total
        return total

    @property
    def tt_ranks(self) -> List[int]:
        """[1, r_1, ..., r_{d-1}, 1]."""
        self._check_built()
        return list(self._tt_ranks)

    @property
    def compression_ratio(self) -> float:
        """Full-tensor elements / TT storage elements."""
        self._check_built()
        full_size = int(np.prod(self.n_nodes))
        return full_size / sum(c.size for c in self._coeff_cores)

    @property
    def total_build_evals(self) -> int:
        """Unique function evaluations used during build."""
        return self._total_build_evals

    @property
    def dim_order(self) -> List[int]:
        """dim_order[k] = original dim stored at TT position k."""
        return list(self._dim_order)

    def reorder(self, new_order, *, max_rank=None,
                tolerance=None) -> "ChebyshevTT":
        """New TT with storage permutation ``new_order`` via bubble-sorted
        adjacent TT-swaps (SVD-split per swap)."""
        self._check_built()
        new_order = list(new_order)
        d = self.num_dimensions
        if sorted(new_order) != list(range(d)):
            raise ValueError(
                f"new_order must be a permutation of range({d}); "
                f"got {new_order!r}"
            )
        if new_order == self._dim_order:
            return self.clone()

        eff_max_rank = self.max_rank if max_rank is None else max_rank
        eff_tol = self.tolerance if tolerance is None else tolerance

        current = list(self._dim_order)
        cores = [c.copy() for c in self._coeff_cores]
        n_nodes = list(self.n_nodes)
        domain = list(self.domain)

        for k in range(d):
            j = current.index(new_order[k])
            while j > k:
                cores = tta.tt_swap_adjacent(
                    cores, j - 1, max_rank=eff_max_rank, tolerance=eff_tol)
                current[j - 1], current[j] = current[j], current[j - 1]
                n_nodes[j - 1], n_nodes[j] = n_nodes[j], n_nodes[j - 1]
                domain[j - 1], domain[j] = domain[j], domain[j - 1]
                j -= 1

        return self._assemble(cores, domain, n_nodes, new_order)

    # ------------------------------------------------------------------
    # Serialization + ergonomics
    # ------------------------------------------------------------------

    def __getstate__(self) -> dict:
        """Picklable state: host cores, device as a string, no function,
        no device tensors, no ctypes state."""
        from pychebyshev_tpu_torch._version import __version__
        state = self.__dict__.copy()
        state["function"] = None
        state.pop("_dev_cores", None)  # device cache never pickles
        state.pop("_host_cpack_cache", None)  # ctypes state never pickles
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
        defaults = {
            "_cached_error_estimate": None,
            "additional_data": None,
            "descriptor": "",
            "max_derivative_order": 2,
            "vectorized": False,
        }
        for key, val in defaults.items():
            if not hasattr(self, key):
                setattr(self, key, val)
        if not hasattr(self, "_dim_order"):
            self._dim_order = list(range(self.num_dimensions))

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
        """Maximum queryable derivative order (via eval_multi FD)."""
        return self.max_derivative_order

    def get_special_points(self):
        """Always None — TT grids have no special-point surface."""
        return None

    def get_error_threshold(self):
        """Always None — TT builds target ``tolerance``, not the dense
        auto-N error_threshold mode."""
        return None

    def get_num_evaluation_points(self) -> int:
        """Full Cartesian grid size (TT-Cross samples a sparse subset;
        see ``total_build_evals`` for the actual count)."""
        return int(np.prod(self.n_nodes))

    def get_evaluation_points(self) -> np.ndarray:
        """Full Cartesian node grid, columns in user-frame order."""
        grids = self._storage_grids()
        mesh = np.meshgrid(*grids, indexing="ij")
        user_frame = [mesh[self._dim_order.index(u)]
                      for u in range(self.num_dimensions)]
        return np.stack([g.ravel() for g in user_frame],
                        axis=-1).astype(np.float64)

    def clone(self) -> "ChebyshevTT":
        """Independent deep copy (function not duplicated)."""
        import copy
        return copy.deepcopy(self)

    @classmethod
    def from_values(cls, tensor_values, num_dimensions: int, domain,
                    n_nodes, max_rank: Optional[int] = None,
                    tolerance: float = 1e-6,
                    max_derivative_order: int = 2, additional_data=None,
                    descriptor: str = "", *, device) -> "ChebyshevTT":
        """TT-SVD compression of a precomputed dense value tensor."""
        domain, n_nodes = _unwrap_typed(domain, n_nodes)
        if isinstance(tensor_values, torch.Tensor):
            tensor_values = tensor_values.detach().cpu().numpy()

        arr = np.asarray(tensor_values, dtype=np.float64)
        expected_shape = tuple(n_nodes)
        if arr.shape != expected_shape:
            raise ValueError(
                f"tensor_values shape {arr.shape} does not match expected "
                f"{expected_shape}"
            )
        if not np.isfinite(arr).all():
            raise ValueError(
                "tensor_values contains NaN or Inf — all values must be "
                "finite"
            )
        if max_rank is None:
            max_rank = max(n_nodes)

        value_cores = tta.tt_svd_from_tensor(arr, max_rank=max_rank,
                                             tol=tolerance)
        coeff_cores = [tta.value_core_to_coeff_core(c)
                       for c in value_cores]
        return cls._from_coeff_cores(
            coeff_cores, domain, n_nodes,
            dim_order=list(range(num_dimensions)), max_rank=max_rank,
            tolerance=tolerance, max_derivative_order=max_derivative_order,
            additional_data=additional_data, descriptor=descriptor,
            method="svd", device=device)

    @classmethod
    def fit(cls, points, values, num_dimensions: int, domain, n_nodes,
            *, max_rank: int = 5, l2: float = 1e-10, sweeps: int = 10,
            seed: int = 0, sample_weight=None, derivative_data=None,
            max_derivative_order: int = 2, additional_data=None,
            descriptor: str = "", engine: str = "host", mesh=None,
            data_axis: str = "dp", device) -> "ChebyshevTT":
        """TT completion from SCATTERED samples.

        Alternating least squares over the sample set: holding all
        cores but one fixed, the model is linear in that core, so each
        sweep is d small regularized solves with per-sample TT interface
        vectors (``utils/fitting.py::fit_tt_cores``).  NONCONVEX: the
        result is a local optimum dependent on ``seed``'s random init;
        check ``fit_diagnostics['rms']`` (and its per-sweep history)
        against the noise level.

        ``engine="device"`` runs the per-core designs, the Gram products
        and both interface chains on ``device`` in IEEE f32 (for
        noise-dominated huge-N fits); solves, QR and the residual
        diagnostics stay host f64.  ``mesh`` (device engine) shards the
        rows over ``data_axis`` and reduces the Grams and the residual
        across it.  The result lives on ``device``.
        """
        from pychebyshev_tpu_torch.utils.fitting import fit_tt_cores
        domain, n_nodes = _unwrap_typed(domain, n_nodes)
        if len(domain) != num_dimensions or len(n_nodes) != num_dimensions:
            raise ValueError(
                f"len(domain)={len(domain)} and len(n_nodes)="
                f"{len(n_nodes)} must both equal num_dimensions="
                f"{num_dimensions}")

        value_cores, diagnostics = fit_tt_cores(
            points, values, domain, n_nodes, max_rank=max_rank, l2=l2,
            sweeps=sweeps, seed=seed, sample_weight=sample_weight,
            derivative_data=derivative_data, engine=engine, mesh=mesh,
            data_axis=data_axis, device=device)
        coeff_cores = [tta.value_core_to_coeff_core(c)
                       for c in value_cores]
        # tolerance feeds downstream algebra's TT-rounding; 1e-12 keeps
        # the fitted structure (the fit itself has no grid tolerance).
        obj = cls._from_coeff_cores(
            coeff_cores, domain, n_nodes,
            dim_order=list(range(num_dimensions)), max_rank=max_rank,
            tolerance=1e-12, max_derivative_order=max_derivative_order,
            additional_data=additional_data, descriptor=descriptor,
            method="als", device=device)
        obj.fit_diagnostics = diagnostics
        return obj

    @classmethod
    def _from_coeff_cores(cls, coeff_cores, domain, n_nodes, *,
                          dim_order, max_rank, tolerance,
                          max_derivative_order=2, additional_data=None,
                          descriptor: str = "", method: str = "cores",
                          device) -> "ChebyshevTT":
        """One authoritative built-object factory for external cores.

        ``domain``/``n_nodes`` are STORAGE-frame (position k describes
        user dim ``dim_order[k]``).  Every factory that fabricates a
        TT from precomputed coefficient cores (``from_values``,
        ``ChebyshevApproximation.to_tt``, ``utils.convert``) routes here
        so the attribute list has a single owner.
        """
        obj = cls.__new__(cls)
        obj.device = torch.device(device)
        obj.function = None
        obj.num_dimensions = len(n_nodes)
        obj.domain = [list(b) for b in domain]
        obj.n_nodes = [int(n) for n in n_nodes]
        obj.max_rank = int(max_rank)
        obj.tolerance = tolerance
        obj.max_sweeps = 10
        obj.max_derivative_order = max_derivative_order
        obj.additional_data = additional_data
        obj.descriptor = descriptor
        obj.method = method
        obj.vectorized = False
        obj._coeff_cores = list(coeff_cores)
        obj._tt_ranks = ([c.shape[0] for c in coeff_cores]
                         + [coeff_cores[-1].shape[2]])
        obj._built = True
        obj._build_time = 0.0
        obj._total_build_evals = 0
        obj._cached_error_estimate = None
        obj._dim_order = list(dim_order)
        return obj

    @classmethod
    def with_auto_order(cls, function, num_dimensions: int, domain,
                        n_nodes, *, max_rank: int = 10,
                        tolerance: float = 1e-6, max_sweeps: int = 10,
                        additional_data=None, n_trials: int = 5,
                        method: str = "greedy_swap",
                        vectorized: bool = False,
                        device) -> "ChebyshevTT":
        """Build trying multiple dim orderings; keep the lowest total rank.

        ``greedy_swap`` tries adjacent transpositions from the canonical
        order; ``random`` samples ``n_trials`` permutations (seeded).
        The winner's :attr:`dim_order` records the chosen permutation and
        ``eval``/``eval_batch`` remap user coordinates transparently.
        """
        def build_with_order(order):
            perm_domain = [domain[order[k]] for k in range(num_dimensions)]
            perm_n_nodes = [n_nodes[order[k]]
                            for k in range(num_dimensions)]

            if vectorized:
                inv = np.argsort(np.asarray(order))

                def perm_f(points, ad):
                    pts = np.asarray(points)
                    return function(pts[:, inv], ad)
            else:
                def perm_f(point, ad):
                    orig = [0.0] * num_dimensions
                    for k in range(num_dimensions):
                        orig[order[k]] = point[k]
                    return function(orig, ad)

            tt = cls(perm_f, num_dimensions, perm_domain, perm_n_nodes,
                     max_rank=max_rank, tolerance=tolerance,
                     max_sweeps=max_sweeps,
                     additional_data=additional_data,
                     vectorized=vectorized, device=device)
            tt.build(verbose=False)
            tt._dim_order = list(order)
            return tt

        def total_rank(tt):
            return sum(tt.tt_ranks)

        canonical = list(range(num_dimensions))
        best_tt = build_with_order(canonical)
        best_rank = total_rank(best_tt)

        if method == "random":
            rng = np.random.default_rng(42)
            for _ in range(n_trials):
                perm = rng.permutation(num_dimensions).tolist()
                tt = build_with_order(perm)
                if total_rank(tt) < best_rank:
                    best_tt, best_rank = tt, total_rank(tt)
        elif method == "greedy_swap":
            improved = True
            trial = 0
            while improved and trial < n_trials:
                improved = False
                current = best_tt.dim_order
                for i in range(num_dimensions - 1):
                    trial_order = list(current)
                    trial_order[i], trial_order[i + 1] = (
                        trial_order[i + 1], trial_order[i])
                    tt = build_with_order(trial_order)
                    if total_rank(tt) < best_rank:
                        best_tt, best_rank = tt, total_rank(tt)
                        improved = True
                        break
                trial += 1
        else:
            raise ValueError(
                f"with_auto_order: unknown method {method!r}; "
                "expected 'greedy_swap' or 'random'"
            )
        return best_tt

    @staticmethod
    def nodes(num_dimensions, domain, n_nodes) -> dict:
        """Per-dim Chebyshev node arrays (no function evaluation)."""
        domain, n_nodes = _unwrap_typed(domain, n_nodes)
        if len(domain) != num_dimensions or len(n_nodes) != num_dimensions:
            raise ValueError(
                f"domain and n_nodes must have length {num_dimensions}"
            )
        nodes_per_dim = [
            nodes_for_dim_np(domain[d][0], domain[d][1], int(n_nodes[d]))
            for d in range(num_dimensions)
        ]
        return {"nodes_per_dim": nodes_per_dim}

    @staticmethod
    def is_dimensionality_allowed(num_dimensions: int) -> bool:
        """Whether this class supports ``num_dimensions`` (any >= 1)."""
        return isinstance(num_dimensions, int) and num_dimensions >= 1

    def save(self, path: str | os.PathLike,
             format: str = "pickle") -> None:
        """Save to pickle (default) or the pickle-free ``.npz`` (cores and
        metadata); the function is excluded either way."""
        self._check_built()
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
    def load(cls, path: str | os.PathLike, *, device) -> "ChebyshevTT":
        """Load from pickle or ``.npz`` (magic-sniffed) onto ``device``;
        only load trusted pickle files."""
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
        return obj

    # ------------------------------------------------------------------
    # Printing
    # ------------------------------------------------------------------

    def __repr__(self) -> str:
        return (f"ChebyshevTT(dims={self.num_dimensions}, "
                f"nodes={self.n_nodes}, max_rank={self.max_rank}, "
                f"built={self._built})")

    def __str__(self) -> str:
        status = "built" if self._built else "not built"
        full_tensor_size = int(np.prod(self.n_nodes))
        max_display = 6
        if self.num_dimensions > max_display:
            nodes_str = ("[" + ", ".join(
                str(n) for n in self.n_nodes[:max_display]) + ", ...]")
            domain_str = (" x ".join(
                f"[{lo}, {hi}]" for lo, hi in self.domain[:max_display])
                + " x ...")
        else:
            nodes_str = str(self.n_nodes)
            domain_str = " x ".join(f"[{lo}, {hi}]"
                                    for lo, hi in self.domain)

        lines = [
            f"ChebyshevTT ({self.num_dimensions}D, {status})",
            f"  Nodes:       {nodes_str}",
        ]
        if self._built:
            tt_storage = sum(c.size for c in self._coeff_cores)
            lines.append(f"  TT ranks:    {self._tt_ranks}")
            lines.append(f"  Compression: {full_tensor_size:,} -> "
                         f"{tt_storage:,} elements "
                         f"({full_tensor_size / tt_storage:.1f}x)")
            lines.append(f"  Build:       {self._build_time:.3f}s "
                         f"({self._total_build_evals:,} function evals)")
            lines.append(f"  Domain:      {domain_str}")
            lines.append(f"  Error est:   {self.error_estimate():.2e}")
        else:
            lines.append(f"  Domain:      {domain_str}")
        return "\n".join(lines)

    # ------------------------------------------------------------------
    # Algebra
    # ------------------------------------------------------------------

    def _check_compatible_tt(self, other) -> None:
        if not isinstance(other, ChebyshevTT):
            raise TypeError(
                f"unsupported operand type for ChebyshevTT: "
                f"{type(other).__name__}"
            )
        self._check_built()
        other._check_built()
        if self.num_dimensions != other.num_dimensions:
            raise ValueError(
                f"num_dimensions mismatch: {self.num_dimensions} vs "
                f"{other.num_dimensions}"
            )
        # Frame check first: a permuted sibling has storage-frame
        # n_nodes/domain that differ even when the user-frame grids are
        # identical, and the actionable message is the reorder hint.
        if self._dim_order != other._dim_order:
            raise ValueError(
                f"TT dim_order mismatch: {self._dim_order} vs "
                f"{other._dim_order}. Call other = "
                f"other.reorder(self.dim_order) to align before "
                f"adding/subtracting."
            )
        if list(self.n_nodes) != list(other.n_nodes):
            raise ValueError(
                f"n_nodes mismatch: {self.n_nodes} vs {other.n_nodes}"
            )
        if not np.allclose(np.asarray(self.domain, dtype=float),
                           np.asarray(other.domain, dtype=float)):
            raise ValueError(
                f"domain mismatch: {self.domain} vs {other.domain}"
            )

    def hadamard(self, other: "ChebyshevTT", *,
                 max_rank: Optional[int] = None,
                 tolerance: Optional[float] = None) -> "ChebyshevTT":
        """Node-wise product TT: interpolant of ``f·g`` at the shared
        grid.

        Exact construction in VALUE space (per-core Kronecker products
        give the elementwise product of the two value tensors with bond
        ranks ``r_a·r_b``), then TT-SVD rounding to ``max_rank``
        (default ``max(self.max_rank, other.max_rank)``).  The product
        roughly doubles the polynomial degree: accurate only when the
        shared grid resolves it (check ``result.error_estimate()``).
        """
        self._check_compatible_tt(other)
        target_rank = (max_rank if max_rank is not None
                       else max(self.max_rank, other.max_rank))
        prod_cores = []
        for ca, cb in zip(self._coeff_cores, other._coeff_cores):
            va = tta.coeff_core_to_value_core(ca)
            vb = tta.coeff_core_to_value_core(cb)
            ra_l, n, ra_r = va.shape
            rb_l, _, rb_r = vb.shape
            merged = np.einsum("anb,cnd->acnbd", va, vb)
            prod_cores.append(
                merged.reshape(ra_l * rb_l, n, ra_r * rb_r))
        tol = self.tolerance if tolerance is None else float(tolerance)
        rounded = tta.tt_round_cores(prod_cores, max_rank=target_rank,
                                     tolerance=tol)
        coeff = [tta.value_core_to_coeff_core(c) for c in rounded]
        return self._assemble(coeff, self.domain, self.n_nodes,
                              self._dim_order, max_rank=target_rank)

    def _constant_like(self, value: float,
                       max_rank: Optional[int] = None) -> "ChebyshevTT":
        """Rank-1 constant TT on this grid/frame (algebra helper) whose
        cap is ``max_rank`` (default this TT's)."""
        cores = []
        for n in self.n_nodes:
            vcore = np.full((1, int(n), 1), 1.0)
            cores.append(tta.value_core_to_coeff_core(vcore))
        cores[0] = cores[0] * float(value)
        return self._assemble(
            cores, self.domain, self.n_nodes, self._dim_order,
            max_rank=self.max_rank if max_rank is None else max_rank)

    def compose(self, g, *, degree: int = 16, f_range=None,
                max_rank: Optional[int] = None,
                tolerance: float = 1e-12,
                n_range_samples: int = 2048,
                seed: int = 0) -> "ChebyshevTT":
        """Scalar-function composition ``g(f(x))`` as a new TT.

        Chebyshev-expands ``g`` (vectorized over a 1-D NumPy array) to
        ``degree`` on the range of this interpolant and evaluates the
        expansion in TT arithmetic by the Clenshaw recurrence, each
        Chebyshev power built from rounded ``hadamard`` products, so the
        original function is not sampled again.  ``f_range`` is the
        (lo, hi) interval the expansion targets; by default it is the
        range of ``n_range_samples`` random evaluations (on the device)
        padded by 5%.  ``max_rank`` caps every intermediate (default:
        this TT's cap); ``tolerance`` is the intermediates' rounding
        threshold.  The result converges to the grid's interpolant of
        ``g∘f``; check ``result.error_estimate()``.
        """
        self._check_built()
        if degree < 1:
            raise ValueError(f"degree must be >= 1, got {degree}")
        cap = int(max_rank) if max_rank is not None else self.max_rank

        if f_range is None:
            rng = np.random.default_rng(seed)
            dom = np.asarray(self._user_frame_domain(), dtype=np.float64)
            pts = dom[:, 0] + (dom[:, 1] - dom[:, 0]) * rng.uniform(
                0.0, 1.0, size=(n_range_samples, self.num_dimensions))
            vals = self.eval_batch(pts)
            lo, hi = float(vals.min()), float(vals.max())
            pad = 0.05 * max(hi - lo, 1e-12)
            lo, hi = lo - pad, hi + pad
        else:
            lo, hi = float(f_range[0]), float(f_range[1])
            if not lo < hi:
                raise ValueError(
                    f"f_range must satisfy lo < hi, got ({lo}, {hi})")

        # Chebyshev coefficients of h(t) = g(mid + half*t) on [-1, 1].
        from numpy.polynomial.chebyshev import Chebyshev
        mid, half = 0.5 * (hi + lo), 0.5 * (hi - lo)
        series = Chebyshev.interpolate(
            lambda t: np.asarray(g(mid + half * t), dtype=np.float64),
            degree)
        coeffs = series.coef  # length degree+1
        if not np.isfinite(coeffs).all():
            raise ValueError(
                f"g returned non-finite values on the expansion range "
                f"({lo:.6g}, {hi:.6g}) — pass f_range explicitly to "
                f"restrict it to g's domain (the default pads the "
                f"sampled range of f by 5%)"
            )

        # Every intermediate carries the TIGHT rounding tolerance: the
        # operand's build tolerance would floor the whole composition at
        # that level, while the rank cap is the intended accuracy
        # control here.
        tol = float(tolerance)

        def _tight(tt):
            tt.tolerance = tol
            return tt

        t_tt = _tight(_tight(self * (1.0 / half))
                      + self._constant_like(-mid / half, max_rank=cap))

        # Clenshaw: b_k = c_k + 2 t⊙b_{k+1} - b_{k+2}.
        b1 = _tight(self._constant_like(0.0, max_rank=cap))
        b2 = _tight(self._constant_like(0.0, max_rank=cap))
        for k in range(degree, 0, -1):
            nxt = t_tt.hadamard(b1, max_rank=cap, tolerance=tol) * 2.0
            nxt = _tight(nxt - b2
                         + self._constant_like(float(coeffs[k]),
                                               max_rank=cap))
            b2, b1 = b1, nxt
        out = (t_tt.hadamard(b1, max_rank=cap, tolerance=tol) - b2
               + self._constant_like(float(coeffs[0]), max_rank=cap))
        rounded = tta.tt_round_cores(
            [c.copy() for c in out._coeff_cores], max_rank=cap,
            tolerance=tol)
        return self._assemble(rounded, self.domain, self.n_nodes,
                              self._dim_order, max_rank=cap)

    def __add__(self, other: "ChebyshevTT") -> "ChebyshevTT":
        """Block-diagonal core stacking + TT-SVD rounding to
        ``max(self.max_rank, other.max_rank)``."""
        self._check_compatible_tt(other)
        stacked = tta.tt_add_cores(self._coeff_cores, other._coeff_cores)
        target_rank = max(self.max_rank, other.max_rank)
        rounded = tta.tt_round_cores(stacked, max_rank=target_rank,
                                     tolerance=self.tolerance)
        return self._assemble(rounded, self.domain, self.n_nodes,
                              self._dim_order, max_rank=target_rank)

    def __neg__(self) -> "ChebyshevTT":
        self._check_built()
        new_cores = [c.copy() for c in self._coeff_cores]
        new_cores[0] = -new_cores[0]
        return self._assemble(new_cores, self.domain, self.n_nodes,
                              self._dim_order)

    def __sub__(self, other: "ChebyshevTT") -> "ChebyshevTT":
        return self + (-other)

    def __mul__(self, scalar) -> "ChebyshevTT":
        if not is_scalar(scalar):
            raise TypeError(
                f"ChebyshevTT * {type(scalar).__name__} is not supported "
                "(only scalar multiplication is defined for TT)"
            )
        self._check_built()
        new_cores = [c.copy() for c in self._coeff_cores]
        new_cores[0] = new_cores[0] * float(scalar)
        return self._assemble(new_cores, self.domain, self.n_nodes,
                              self._dim_order)

    def __rmul__(self, scalar) -> "ChebyshevTT":
        return self.__mul__(scalar)

    def __truediv__(self, scalar) -> "ChebyshevTT":
        if not is_scalar(scalar):
            raise TypeError(
                f"ChebyshevTT / {type(scalar).__name__} is not supported"
            )
        if float(scalar) == 0.0:
            raise ZeroDivisionError("division by zero")
        return self.__mul__(1.0 / float(scalar))

    def __iadd__(self, other) -> "ChebyshevTT":
        return self + other

    def __isub__(self, other) -> "ChebyshevTT":
        return self - other

    def __imul__(self, scalar) -> "ChebyshevTT":
        return self * scalar

    def __itruediv__(self, scalar) -> "ChebyshevTT":
        return self / scalar

    def vectorized_eval_batch(self, points, derivative_order=None
                              ) -> np.ndarray:
        """Batched evaluation -> (N,) NumPy array, matching the dense
        class's batch surface.

        A derivative spec runs through the batched stencil path
        (:meth:`vectorized_eval_batch_multi`): one chain for the whole
        batch instead of a host FD loop per point.
        """
        if derivative_order is not None and any(
                o != 0 for o in derivative_order):
            return self.vectorized_eval_batch_multi(
                points, [list(derivative_order)])[:, 0]
        return self.eval_batch(points).cpu().numpy()


    def sobol_indices(self) -> dict:
        """First/total-order Sobol indices from coefficient cores,
        O(d n r^2); keys are user-frame dims."""
        self._check_built()
        from pychebyshev_tpu_torch.utils.sensitivity import (
            sobol_from_tt_cores,
        )
        storage = sobol_from_tt_cores(self._coeff_cores)
        user_first, user_total = {}, {}
        for s in range(self.num_dimensions):
            user_d = self._dim_order[s]
            user_first[user_d] = storage["first_order"][s]
            user_total[user_d] = storage["total_order"][s]
        return {"first_order": user_first, "total_order": user_total,
                "variance": storage["variance"]}

    def interaction_matrix(self) -> np.ndarray:
        """(d, d) pure pairwise Sobol interaction shares, user-frame
        dims: entry (i, j) is ``S^closed_{ij} - S_i - S_j``, computed
        from the coefficient cores in O(d^3 n r^2).  Zero (to roundoff)
        exactly where the function is additively separable."""
        self._check_built()
        from pychebyshev_tpu_torch.utils.sensitivity import (
            tt_pair_interactions,
        )
        storage = tt_pair_interactions(self._coeff_cores)
        d = self.num_dimensions
        out = np.zeros((d, d))
        for si in range(d):
            for sj in range(d):
                out[self._dim_order[si], self._dim_order[sj]] = \
                    storage[si, sj]
        return out

    def suggest_partition(self, threshold: float = 1e-8) -> list:
        """Additive partition from the interaction matrix (user frame);
        feed it to :meth:`to_slider`."""
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

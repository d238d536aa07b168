"""Tensor-train construction and manipulation algorithms.

Host-side NumPy by design: TT-Cross / ALS / rounding manipulate
dynamically-ranked tiny matrices (r, n <= ~100) with data-dependent
pivoting and a black-box function oracle, shapes and control flow that
gain nothing from a device.  A copy of the JAX package's module (same
RNG, same NumPy calls, so a seeded build gives the same cores bit for
bit); ``GridOracle``'s ``mesh=`` shards its batches over a
``torch.distributed`` device mesh.  The device
hot path is elsewhere: ``ops.tt_eval`` (the batched query chain).

- ``maxvol``: Goreinov-Tyrtyshnikov maximal-volume row selection with
  column-pivoted-QR init + rank-1-update refinement.
- ``GridOracle``: every cross matrix / test batch is requested as an
  index array, the cache is consulted vectorially, and only the missing
  points are evaluated, in one batched call for a vectorized function.
- ``tt_cross``: DMRG-style alternating cross approximation with eval
  caching, per-bond rank caps, SVD-adaptive ranks, half-sweep
  convergence, best-cores tracking.
- ``tt_svd_from_tensor``: sequential truncated SVD.
- ``tt_als`` / ``als_fixed_rank_sweeps``: rank-adaptive ALS.  The cores
  are canonicalized around k, so the design matrix has orthonormal
  columns and the exact LS optimum is a direct projection
  ``core_k = <L-chain x e_{i_k} x R-chain, target>``: an einsum
  contraction, no solver.
- value <-> coefficient core transforms via the shared cosine matrices.
- TT add (block-diagonal), rounding (right-QR + left-SVD truncation),
  adjacent swap, exact merge of adjacent cores, measured-error trimming.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from pychebyshev_tpu_torch.ops.dct import _coeff_matrix_np, _synthesis_matrix_np
from pychebyshev_tpu_torch.parallel.sharding import sharded_vectorized

__all__ = [
    "maxvol",
    "GridOracle",
    "tt_cross",
    "tt_svd_from_tensor",
    "masked_als_refine",
    "orth_left_core",
    "orth_right_core",
    "als_fixed_rank_sweeps",
    "tt_als",
    "value_core_to_coeff_core",
    "coeff_core_to_value_core",
    "tt_reconstruct",
    "tt_add_cores",
    "tt_round_cores",
    "tt_round_cores_ranks",
    "tt_swap_adjacent",
    "tt_merge_cores",
    "tt_trim_cores",
]


# ======================================================================
# maxvol
# ======================================================================

def maxvol(a: np.ndarray, tol: float = 1.05,
           max_iters: int = 100) -> np.ndarray:
    """Indices of ~maximal-volume rows of a tall (m, r) matrix.

    Column-pivoted QR of ``a.T`` seeds the index set; then row swaps with
    rank-1 updates of the coefficient matrix ``B = a @ inv(a[idx])`` until
    ``max |B| <= tol``.
    """
    from scipy.linalg import qr as scipy_qr

    m, r = a.shape
    if m <= r:
        return np.arange(m, dtype=np.intp)

    _, _, piv = scipy_qr(a.T, pivoting=True)
    idx = piv[:r].copy().astype(np.intp)

    try:
        b = np.linalg.solve(a[idx].T, a.T).T
    except np.linalg.LinAlgError:
        return idx

    for _ in range(max_iters):
        i, j = np.unravel_index(np.argmax(np.abs(b)), b.shape)
        if np.abs(b[i, j]) <= tol:
            break
        idx[j] = i
        # Rank-1 update keeping b = a @ inv(a[idx]) after the swap.
        pivot = b[i, j]
        col_j = b[:, j].copy()
        row_i = b[i, :].copy()
        b -= np.outer(col_j, row_i) / pivot
        b[:, j] = col_j / pivot

    return idx


# ======================================================================
# Batched, cached function oracle over grid indices
# ======================================================================

class GridOracle:
    """Caching, batched evaluator of ``f`` at tensor-grid index tuples.

    Every cross matrix / test batch is requested as an index array, the
    cache is consulted vectorially, and only the *missing* points are
    evaluated: in a single batched call when the function is
    vectorized, or a host loop for black-box scalar callables.
    """

    def __init__(self, function: Callable, grids: List[np.ndarray],
                 additional_data=None, vectorized: bool = False,
                 mesh=None, data_axis: str = "dp"):
        self.function = function
        self.grids = [np.asarray(g, dtype=np.float64) for g in grids]
        self.additional_data = additional_data
        self.vectorized = vectorized
        self._cache: dict = {}
        # Under a mesh every batch of missing points shards over the
        # data axis; each rank evaluates its block as a tensor on the
        # mesh's device and all ranks get every value, so all ranks run
        # the same cross.
        self._eval_fn = function
        if mesh is not None:
            if not vectorized:
                raise ValueError(
                    "mesh-sharded oracle evaluation requires "
                    "vectorized=True (a vectorized function of an (N, d) "
                    "tensor); black-box scalar callables evaluate on host")
            self._eval_fn = sharded_vectorized(function, mesh, data_axis)

    @property
    def n_evals(self) -> int:
        """Number of unique function evaluations so far (cache size)."""
        return len(self._cache)

    def eval_many(self, idx_array: np.ndarray) -> np.ndarray:
        """Values of f at an (M, d) array of grid-index rows."""
        idx_array = np.asarray(idx_array, dtype=np.intp)
        m, d = idx_array.shape
        keys = [tuple(int(v) for v in row) for row in idx_array]
        missing = [k for k in set(keys) if k not in self._cache]

        if missing:
            pts = np.empty((len(missing), d), dtype=np.float64)
            for r, key in enumerate(missing):
                for dim in range(d):
                    pts[r, dim] = self.grids[dim][key[dim]]
            if self.vectorized:
                vals = np.asarray(
                    self._eval_fn(pts, self.additional_data),
                    dtype=np.float64).reshape(-1)
            else:
                vals = np.array([
                    float(self.function(list(pt), self.additional_data))
                    for pt in pts
                ])
            for key, v in zip(missing, vals):
                self._cache[key] = float(v)

        return np.array([self._cache[k] for k in keys], dtype=np.float64)

    def observations(self):
        """All cached (index_array, values) pairs — the free training
        set for post-cross refinement (every entry was already paid
        for during the cross)."""
        if not self._cache:
            # Well-shaped empty: (0, d) keys so column indexing works.
            return (np.zeros((0, len(self.grids)), dtype=np.intp),
                    np.zeros(0, dtype=np.float64))
        keys = np.array(list(self._cache.keys()), dtype=np.intp)
        vals = np.array([self._cache[tuple(k)] for k in keys],
                        dtype=np.float64)
        return keys, vals

    def full_tensor(self, n: List[int]) -> np.ndarray:
        """Evaluate f on the full Cartesian grid -> (n_0, ..., n_{d-1})."""
        idx = np.indices(n).reshape(len(n), -1).T
        return self.eval_many(idx).reshape(n)


# ======================================================================
# TT-Cross
# ======================================================================

def _tt_eval_at_indices(cores, grid_indices) -> float:
    v = np.ones((1, 1))
    for dim, core in enumerate(cores):
        v = v @ core[:, grid_indices[dim], :]
    return float(v[0, 0])


def _adaptive_rank(s: np.ndarray, cap: int) -> int:
    """Effective rank: singular values above 1e-12 * sigma_max, capped."""
    if len(s) == 0 or s[0] <= 0:
        return 1
    effective = int(np.sum(s > 1e-12 * s[0]))
    return max(1, min(cap, effective, len(s)))


def tt_cross(oracle: GridOracle, n: List[int], max_rank: int, tol: float,
             max_sweeps: int, verbose: bool | int = False,
             seed: Optional[int] = None,
             init_rank: Optional[int] = None,
             kick: int = 2) -> List[np.ndarray]:
    """Alternating TT-Cross with maxvol pivoting.

    Returns **value** cores (r_{k-1}, n_k, r_k); the caller converts to
    Chebyshev coefficient cores.  Unique-eval count is ``oracle.n_evals``.

    ``init_rank`` caps the size of the initial random right-index sets.
    Those first-sweep cross blocks are evaluated at *random* fibers, so
    oversizing them wastes unique evaluations.  Because the maxvol
    pivot sets bound the SVD rank at every bond, ranks alone can never
    grow past their starting sizes — so warm starts pair with
    **enrichment**: after each full sweep that has not converged,
    ``kick`` fresh random rows are appended to every right-index set
    (clipped by the rank caps), letting ranks climb while early sweeps
    pivot on small, cheap cross blocks.
    """
    # seed=None pins a FIXED default (not fresh entropy): the core path
    # is deterministic, so the only unseeded randomness was the error
    # check's test points — and a rare unlucky draw could stop the
    # sweep loop at a degraded snapshot (measured 1-in-40 builds off by
    # 1e-2 on a rank-2 target).  Deterministic-by-default kills that
    # flake class; pass an explicit seed to vary the draws.
    rng = np.random.default_rng(0 if seed is None else seed)
    d = len(n)

    # Per-bond theoretical rank caps: min over unfolding sizes.
    rank_caps = [1] * (d + 1)
    for k in range(1, d):
        rank_caps[k] = min(max_rank, int(np.prod(n[:k])),
                           int(np.prod(n[k:])))

    r = [1] * (d + 1)
    for k in range(1, d):
        r[k] = min(rank_caps[k], n[k - 1], n[k])
        if init_rank is not None:
            r[k] = min(r[k], init_rank)

    # Random right index sets (rows = right multi-indices for dims k+1..d-1).
    j_right: List[Optional[np.ndarray]] = [None] * d
    for k in range(d - 1):
        n_right = d - k - 1
        if n_right == 0:
            j_right[k] = np.zeros((1, 0), dtype=np.intp)
        else:
            j_right[k] = np.column_stack([
                rng.integers(0, n[k + 1 + j], size=r[k + 1])
                for j in range(n_right)
            ])
    j_right[d - 1] = np.zeros((1, 0), dtype=np.intp)

    j_left: List[Optional[np.ndarray]] = [None] * d
    j_left[0] = np.zeros((1, 0), dtype=np.intp)

    best_error = float("inf")
    best_cores = None
    stale_checks = 0
    n_test = min(20, max(5, d))

    def _cross_indices(left, right, nk):
        """(rl, nk, rr, d) index array for the cross block."""
        rl, rr = left.shape[0], right.shape[0]
        k_left = left.shape[1]
        out = np.empty((rl, nk, rr, d), dtype=np.intp)
        out[..., :k_left] = left[:, None, None, :]
        out[..., k_left] = np.arange(nk)[None, :, None]
        out[..., k_left + 1:] = right[None, None, :, :]
        return out

    def _check_error(cores_list) -> float:
        pts = np.column_stack([
            rng.integers(0, n[dim], size=n_test) for dim in range(d)
        ])
        tt_v = np.array([_tt_eval_at_indices(cores_list, pts[t])
                         for t in range(n_test)])
        ex_v = oracle.eval_many(pts)
        ref = np.linalg.norm(ex_v)
        diff = float(np.linalg.norm(tt_v - ex_v))
        return diff / ref if ref > 0 else diff

    cores: List[Optional[np.ndarray]] = [None] * d

    for sweep in range(max_sweeps):
        # ---------------- Left-to-right half-sweep ----------------
        for k in range(d - 1):
            left, right = j_left[k], j_right[k]
            rl, rr, nk = left.shape[0], right.shape[0], n[k]
            cap = rank_caps[k + 1]

            idx = _cross_indices(left, right, nk)
            c = oracle.eval_many(idx.reshape(-1, d)).reshape(rl * nk, rr)

            u, s, _ = np.linalg.svd(c, full_matrices=False)
            rank = _adaptive_rank(s, min(cap, u.shape[1]))
            u = u[:, :rank]

            if u.shape[0] > u.shape[1]:
                pivots = maxvol(u)
            else:
                pivots = np.arange(u.shape[0], dtype=np.intp)
            pivots = pivots[:rank]

            try:
                c_hat = u @ np.linalg.inv(u[pivots])
            except np.linalg.LinAlgError:
                c_hat = u
            cores[k] = c_hat.reshape(rl, nk, rank)

            # New left index set: pivot row p = (left index a, node i_k).
            new_left = np.empty((rank, k + 1), dtype=np.intp)
            for p_idx, prow in enumerate(pivots):
                a, ik = divmod(int(prow), nk)
                a = min(a, rl - 1)
                if k == 0:
                    new_left[p_idx] = [ik]
                else:
                    new_left[p_idx] = list(j_left[k][a]) + [ik]
            j_left[k + 1] = new_left
            r[k + 1] = rank

        # Last core: direct evaluation on (left, node) cross.
        left = j_left[d - 1]
        idx = _cross_indices(left, np.zeros((1, 0), dtype=np.intp), n[d - 1])
        c_last = oracle.eval_many(idx.reshape(-1, d)).reshape(
            left.shape[0], n[d - 1])
        cores[d - 1] = c_last[:, :, np.newaxis]

        # Half-sweep convergence check.
        rel_error_lr = _check_error(cores)
        if verbose:
            ranks_str = str([1] + [c.shape[2] for c in cores])
            print(f"    Sweep {sweep + 1} L->R: rel error = "
                  f"{rel_error_lr:.2e}, unique evals = {oracle.n_evals:,}, "
                  f"ranks = {ranks_str}")

        # Record best on ANY improvement; the 10% threshold below is
        # only the stale-stop criterion.  Decoupling them matters: a
        # <10% improvement that crosses tol must not be discarded.
        if rel_error_lr < best_error:
            if rel_error_lr < best_error * 0.9:
                stale_checks = 0
            else:
                stale_checks += 1
            best_error = rel_error_lr
            best_cores = [c.copy() for c in cores]
        else:
            stale_checks += 1

        if rel_error_lr < tol:
            if verbose:
                print(f"    Converged after {sweep + 1} sweeps (L->R)")
            break  # current cores just met tol
        if stale_checks >= 2:
            # Stagnated: two consecutive half-sweep checks without a
            # >=10% error reduction.  Further sweeps re-evaluate cross
            # blocks without moving the pivots, so stop and keep the
            # best cores seen (saves ~30% of unique evaluations on
            # typical smooth targets).
            if verbose:
                print(f"    No improvement in {stale_checks} checks "
                      f"(best = {best_error:.2e}) — stopping")
            if best_cores is not None:
                cores = best_cores
            break

        # ---------------- Right-to-left half-sweep ----------------
        for k in range(d - 1, 0, -1):
            left, right = j_left[k], j_right[k]
            rl, rr, nk = left.shape[0], right.shape[0], n[k]
            cap = rank_caps[k]

            idx = _cross_indices(left, right, nk)
            c = oracle.eval_many(idx.reshape(-1, d)).reshape(rl, nk * rr)

            u, s, _ = np.linalg.svd(c.T, full_matrices=False)
            rank = _adaptive_rank(s, min(cap, u.shape[1]))
            u = u[:, :rank]

            if u.shape[0] > u.shape[1]:
                pivots = maxvol(u)
            else:
                pivots = np.arange(u.shape[0], dtype=np.intp)
            pivots = pivots[:rank]

            try:
                c_hat_t = u @ np.linalg.inv(u[pivots])
            except np.linalg.LinAlgError:
                c_hat_t = u
            cores[k] = c_hat_t.T.reshape(rank, nk, rr)

            # New right index set: pivot row p = (node i_k, right index b).
            new_right = np.empty((rank, d - k), dtype=np.intp)
            for p_idx, prow in enumerate(pivots):
                ik, b = divmod(int(prow), max(rr, 1))
                ik = min(ik, nk - 1)
                b = min(b, max(rr, 1) - 1)
                if right.shape[1] == 0:
                    new_right[p_idx] = [ik]
                else:
                    new_right[p_idx] = [ik] + list(right[b])
            j_right[k - 1] = new_right
            r[k] = rank

        # First core: direct evaluation.
        right = j_right[0]
        idx = _cross_indices(np.zeros((1, 0), dtype=np.intp), right, n[0])
        c_first = oracle.eval_many(idx.reshape(-1, d)).reshape(
            n[0], right.shape[0])
        cores[0] = c_first[np.newaxis, :, :]

        rel_error = _check_error(cores)
        if verbose:
            print(f"    Sweep {sweep + 1} R->L: rel error = {rel_error:.2e}, "
                  f"unique evals = {oracle.n_evals:,}")

        if rel_error < best_error:
            if rel_error < best_error * 0.9:
                stale_checks = 0
            else:
                stale_checks += 1
            best_error = rel_error
            best_cores = [c.copy() for c in cores]
        else:
            stale_checks += 1

        if rel_error < tol:
            if verbose:
                print(f"    Converged after {sweep + 1} sweeps")
            break  # current cores just met tol
        if stale_checks >= 2:
            # Stagnated: two consecutive half-sweep checks without a
            # >=10% error reduction.  Further sweeps re-evaluate cross
            # blocks without moving the pivots, so stop and keep the
            # best cores seen (saves ~30% of unique evaluations on
            # typical smooth targets).
            if verbose:
                print(f"    No improvement in {stale_checks} checks "
                      f"(best = {best_error:.2e}) — stopping")
            if best_cores is not None:
                cores = best_cores
            break

        # Enrichment (warm-start mode): append `kick` fresh random rows
        # to every right-index set so the next L->R sweep can raise the
        # bond ranks past their current pivot-set sizes.
        if init_rank is not None and kick > 0:
            for k in range(d - 1):
                cur = j_right[k]
                want = min(rank_caps[k + 1], cur.shape[0] + kick)
                if want <= cur.shape[0]:
                    continue
                seen = {tuple(int(v) for v in row) for row in cur}
                fresh = []
                attempts = 0
                while len(fresh) < want - cur.shape[0] and attempts < 64:
                    cand = tuple(int(rng.integers(0, n[k + 1 + j]))
                                 for j in range(d - k - 1))
                    attempts += 1
                    if cand not in seen:
                        seen.add(cand)
                        fresh.append(cand)
                if fresh:
                    j_right[k] = np.vstack([
                        cur,
                        np.array(fresh, dtype=np.intp).reshape(
                            len(fresh), d - k - 1),
                    ])
    else:
        if best_cores is not None:
            cores = best_cores

    return cores


# ======================================================================
# TT-SVD
# ======================================================================

def masked_als_refine(cores: List[np.ndarray], idx_array: np.ndarray,
                      values: np.ndarray, n_sweeps: int = 2,
                      reg: float = 1e-10) -> List[np.ndarray]:
    """Fixed-rank ALS refinement of value cores against *observed*
    tensor entries only (TT completion).

    The cross interpolates exactly at its pivot crosses but carries no
    optimality away from them; a few least-squares sweeps over the
    entries the cross already evaluated (its cache — free) cut the
    off-pivot error 2-4x at ZERO additional function evaluations, and
    a few thousand extra random samples approach full-grid
    ``run_completion`` quality at ~1/10th its evaluation count.

    For each core k and node slice i, the model is linear in
    ``core_k[:, i, :]``: y_m = L_m^T core_k[:, i_m, :] R_m with L/R the
    partial chain products at the observed multi-index.  Normal
    equations with Tikhonov ``reg`` keep the solve stable when a slice
    is under-observed.
    """
    cores = [np.array(c, dtype=np.float64, copy=True) for c in cores]
    d = len(cores)
    idx_array = np.asarray(idx_array, dtype=np.intp)
    values = np.asarray(values, dtype=np.float64)

    for _ in range(n_sweeps):
        # Backward stops at 1: the next sweep's forward pass updates
        # core 0 with identical interfaces, so d-2..0 would solve it
        # twice in a row for nothing.
        for k in list(range(d)) + list(range(d - 2, 0, -1)):
            rl, nk, rr = cores[k].shape
            left = np.ones((len(values), 1))
            for j in range(k):
                cj = cores[j][:, idx_array[:, j], :]   # (rl_j, M, rr_j)
                left = np.einsum("mi,imj->mj", left, cj)
            right = np.ones((len(values), 1))
            for j in range(d - 1, k, -1):
                cj = cores[j][:, idx_array[:, j], :]
                right = np.einsum("imj,mj->mi", cj, right)

            new = cores[k]
            eye = np.eye(rl * rr)
            for i in range(nk):
                sel = idx_array[:, k] == i
                if not np.any(sel):
                    continue
                a = (left[sel][:, :, None]
                     * right[sel][:, None, :]).reshape(-1, rl * rr)
                gram = a.T @ a
                # RELATIVE Tikhonov, regularized toward the CURRENT
                # core slice: an absolute reg-to-zero collapses cores
                # whenever the function scale makes a.T@a tiny (e.g.
                # values ~1e-7), and under-observed directions must
                # keep their cross-built values, not shrink to 0.
                lam = reg * max(np.trace(gram) / (rl * rr), 1e-300)
                cur = new[:, i, :].reshape(rl * rr)
                rhs = a.T @ values[sel] + lam * cur
                try:
                    sol = np.linalg.solve(gram + lam * eye, rhs)
                except np.linalg.LinAlgError:
                    sol, *_ = np.linalg.lstsq(a, values[sel], rcond=None)
                new[:, i, :] = sol.reshape(rl, rr)
            cores[k] = new
    return cores


def tt_svd_from_tensor(tensor: np.ndarray, max_rank: int,
                       tol: float) -> List[np.ndarray]:
    """Sequential truncated SVD of a dense tensor -> value cores."""
    n = list(tensor.shape)
    d = len(n)
    cores = []
    c = np.asarray(tensor, dtype=np.float64)
    r_prev = 1

    for k in range(d - 1):
        c = c.reshape(r_prev * n[k], -1)
        u, s, vt = np.linalg.svd(c, full_matrices=False)
        rank = min(max_rank, len(s))
        if s[0] > 0:
            rank = max(1, min(rank, int(np.sum(s > tol * s[0]))))
        u, s, vt = u[:, :rank], s[:rank], vt[:rank, :]
        cores.append(u.reshape(r_prev, n[k], rank))
        c = s[:, None] * vt
        r_prev = rank

    cores.append(c.reshape(r_prev, n[d - 1], 1))
    return cores


# ======================================================================
# Orthogonalization
# ======================================================================

def orth_left_core(core_k, core_k1):
    """QR-orthogonalize core_k from the left; absorb R into core_k1."""
    r0, nk, r1 = core_k.shape
    q, rr = np.linalg.qr(core_k.reshape(r0 * nk, r1))
    return (q.reshape(r0, nk, q.shape[1]),
            np.einsum("ij,jpk->ipk", rr, core_k1))


def orth_right_core(core_km1, core_k):
    """LQ-orthogonalize core_k from the right; absorb L into core_{k-1}."""
    r_prev, nk, r_next = core_k.shape
    qt, rt = np.linalg.qr(core_k.reshape(r_prev, nk * r_next).T)
    new_core_k = qt.T.reshape(qt.shape[1], nk, r_next)
    left_factor = rt.T  # (r_prev, new_rank)
    return (np.einsum("ipk,kj->ipj", core_km1, left_factor), new_core_k)


# ======================================================================
# ALS
# ======================================================================

def tt_reconstruct(cores: List[np.ndarray]) -> np.ndarray:
    """Dense tensor from a chain of TT cores."""
    t = cores[0]
    for c in cores[1:]:
        t = np.einsum("...i,ijk->...jk", t, c)
    return t.squeeze(axis=0).squeeze(axis=-1)


def _project_core(cores: List[np.ndarray], target: np.ndarray,
                  k: int) -> np.ndarray:
    """Exact LS optimum for core k given canonicalized neighbors.

    With cores [0..k-1] left-orthogonal and [k+1..d-1] right-orthogonal,
    the ALS design matrix has orthonormal columns, so the optimum is the
    projection of the target tensor onto the interface bases:

        core_k[a, i, b] = sum_{grid} L_chain[a] * delta(i) * R_chain[b]
                            * target[grid]

    computed as two contraction sweeps over the target.
    """
    d = len(cores)
    p = target[np.newaxis, ...]  # (1, n_0, ..., n_{d-1})
    for j in range(k):
        # p: (r_j, n_j, rest...) x core_j (r_j, n_j, r_{j+1}) -> (r_{j+1}, rest...)
        p = np.einsum("ab...,abc->c...", p, cores[j])
    p = p[..., np.newaxis]  # (r_k, n_k, n_{k+1}, ..., n_{d-1}, 1)
    for j in range(d - 1, k, -1):
        # p: (..., n_j, r_{j+1}) x core_j (r_j, n_j, r_{j+1}) -> (..., r_j)
        p = np.einsum("...ab,cab->...c", p, cores[j])
    return p  # (r_k, n_k, r_{k+1})


def als_fixed_rank_sweeps(cores: List[np.ndarray], target: np.ndarray,
                          tolerance: float, max_iter: int,
                          verbose: bool = False) -> List[np.ndarray]:
    """Alternating LS sweeps at fixed rank against a dense target tensor.

    One outer iteration = L->R sweep + R->L sweep; stops when the
    relative Frobenius change of the reconstruction drops below
    ``tolerance``.  Mutates and returns ``cores``.
    """
    d = len(cores)
    prev_t = tt_reconstruct(cores)
    for outer in range(max_iter):
        for direction in ("left_to_right", "right_to_left"):
            order = (range(d) if direction == "left_to_right"
                     else range(d - 1, -1, -1))
            for k in order:
                # Canonicalize around k (left-orth [0..k-1], right-orth
                # [k+1..d-1]) so the projection is the exact LS optimum.
                for j in range(k):
                    cores[j], cores[j + 1] = orth_left_core(
                        cores[j], cores[j + 1])
                for j in range(d - 1, k, -1):
                    cores[j - 1], cores[j] = orth_right_core(
                        cores[j - 1], cores[j])
                cores[k] = _project_core(cores, target, k)

        t_new = tt_reconstruct(cores)
        rel_change = (np.linalg.norm(t_new - prev_t)
                      / (np.linalg.norm(prev_t) + 1e-30))
        if verbose:
            print(f"  ALS iter {outer + 1}: rel_change = {rel_change:.3e}")
        if rel_change < tolerance:
            break
        prev_t = t_new
    return cores


def tt_als(target: np.ndarray, max_rank: int, tol: float,
           random_state: Optional[int], verbose: bool = False
           ) -> List[np.ndarray]:
    """Rank-adaptive ALS against a dense target tensor.

    Starts at rank 1, re-initializes at rank+1 until the relative grid
    residual falls below ``tol`` or ``max_rank`` is reached.  Returns
    value cores.
    """
    rng = np.random.default_rng(random_state)
    n = list(target.shape)
    d = len(n)
    target_norm = max(float(np.linalg.norm(target)), 1e-30)

    def make_cores(rank: int) -> List[np.ndarray]:
        out = []
        for k in range(d):
            r_left = 1 if k == 0 else rank
            r_right = 1 if k == d - 1 else rank
            out.append(rng.standard_normal((r_left, n[k], r_right)))
        return out

    rank = 1
    cores = make_cores(rank)
    while True:
        cores = als_fixed_rank_sweeps(
            cores, target, tolerance=tol * 0.1, max_iter=5, verbose=verbose)
        err = float(np.linalg.norm(tt_reconstruct(cores) - target)
                    / target_norm)
        if verbose:
            print(f"[ALS] rank {rank}: grid_residual = {err:.3e} "
                  f"(target {tol:.1e})")
        if err < tol or rank >= max_rank:
            if verbose and err >= tol:
                print(f"[ALS] reached max_rank={max_rank} before tolerance")
            break
        rank += 1
        cores = make_cores(rank)
    return cores


# ======================================================================
# Value <-> coefficient core transforms
# ======================================================================

def value_core_to_coeff_core(value_core: np.ndarray) -> np.ndarray:
    """Values at ascending Type-I nodes (axis 1) -> Chebyshev coefficients.

    One cached cosine-matrix contraction encodes the full convention
    (axis reversal, DCT-II, 1/n, halve c0)."""
    n_k = value_core.shape[1]
    m = _coeff_matrix_np(n_k)  # (n, n): coeffs = m @ values
    return np.einsum("kj,ajb->akb", m, np.asarray(value_core, dtype=np.float64))


def coeff_core_to_value_core(coeff_core: np.ndarray) -> np.ndarray:
    """Exact inverse: coefficients -> values at ascending Type-I nodes."""
    n_k = coeff_core.shape[1]
    s = _synthesis_matrix_np(n_k)  # (n, n): values = s @ coeffs
    return np.einsum("ik,akb->aib", s, np.asarray(coeff_core, dtype=np.float64))


# ======================================================================
# TT algebra primitives
# ======================================================================

def tt_add_cores(cores_a: List[np.ndarray],
                 cores_b: List[np.ndarray]) -> List[np.ndarray]:
    """Exact TT of the sum via block-diagonal core stacking.

    End cores concatenate along their open rank (left core along right
    rank, right core along left rank); interior cores are block-diagonal.
    ``d == 1``: plain elementwise sum (both end invariants collide).
    """
    d = len(cores_a)
    if d != len(cores_b):
        raise ValueError("cores must have same length")

    if d == 1:
        a, b = cores_a[0], cores_b[0]
        if a.shape != b.shape:
            raise ValueError(f"core 0 shape mismatch: {a.shape} vs {b.shape}")
        return [a + b]

    out = []
    for k in range(d):
        a, b = cores_a[k], cores_b[k]
        ra_l, n, ra_r = a.shape
        rb_l, n_b, rb_r = b.shape
        if n != n_b:
            raise ValueError(f"core {k} n_nodes mismatch: {n} vs {n_b}")
        if k == 0:
            out.append(np.concatenate([a, b], axis=2))
        elif k == d - 1:
            out.append(np.concatenate([a, b], axis=0))
        else:
            block = np.zeros((ra_l + rb_l, n, ra_r + rb_r),
                             dtype=np.result_type(a.dtype, b.dtype))
            block[:ra_l, :, :ra_r] = a
            block[ra_l:, :, ra_r:] = b
            out.append(block)
    return out


def _svd_keep(s: np.ndarray, max_rank: int, tolerance: float) -> int:
    keep = min(max_rank, len(s))
    s_max = s[0] if len(s) > 0 else 0.0
    if s_max > 0 and tolerance > 0:
        keep = max(1, min(keep, int(np.sum(s > s_max * tolerance))))
    return max(1, keep)


def tt_round_cores(cores: List[np.ndarray], max_rank: int,
                   tolerance: float = 1e-12) -> List[np.ndarray]:
    """TT-SVD recompression: right-to-left QR sweep, then left-to-right
    SVD truncation at ``min(max_rank, #sv above s_max * tolerance)``."""
    cores = [np.asarray(c, dtype=np.float64).copy() for c in cores]
    d = len(cores)
    if d == 1:
        return cores

    # Right-canonicalize cores d-1 .. 1.
    for k in range(d - 1, 0, -1):
        r_l, n, r_r = cores[k].shape
        mat = cores[k].reshape(r_l, n * r_r)
        q, rr = np.linalg.qr(mat.T)
        qt = q.T
        cores[k] = qt.reshape(qt.shape[0], n, r_r)
        cores[k - 1] = np.einsum("ljs,sr->ljr", cores[k - 1], rr.T)

    # Truncate left-to-right.
    for k in range(d - 1):
        r_l, n, r_r = cores[k].shape
        u, s, vt = np.linalg.svd(cores[k].reshape(r_l * n, r_r),
                                 full_matrices=False)
        keep = _svd_keep(s, max_rank, tolerance)
        u, s, vt = u[:, :keep], s[:keep], vt[:keep, :]
        cores[k] = u.reshape(r_l, n, keep)
        cores[k + 1] = np.einsum("lr,rjs->ljs", s[:, None] * vt,
                                 cores[k + 1])
    return cores


def tt_round_cores_ranks(cores: List[np.ndarray],
                         bond_ranks: List[int]) -> List[np.ndarray]:
    """TT-SVD recompression to EXPLICIT per-bond rank caps.

    Same sweep as :func:`tt_round_cores` (right-QR canonicalization,
    then left-to-right SVD truncation) but bond ``k`` truncates to
    ``bond_ranks[k]`` instead of one global ``max_rank`` — the
    per-bond error-budgeting primitive :func:`tt_trim_cores` drives.
    ``bond_ranks`` has ``len(cores) - 1`` entries (internal bonds).
    """
    cores = [np.asarray(c, dtype=np.float64).copy() for c in cores]
    d = len(cores)
    if d == 1:
        return cores
    if len(bond_ranks) != d - 1:
        raise ValueError(
            f"bond_ranks needs {d - 1} entries, got {len(bond_ranks)}")

    for k in range(d - 1, 0, -1):
        r_l, n, r_r = cores[k].shape
        mat = cores[k].reshape(r_l, n * r_r)
        q, rr = np.linalg.qr(mat.T)
        qt = q.T
        cores[k] = qt.reshape(qt.shape[0], n, r_r)
        cores[k - 1] = np.einsum("ljs,sr->ljr", cores[k - 1], rr.T)

    for k in range(d - 1):
        r_l, n, r_r = cores[k].shape
        u, s, vt = np.linalg.svd(cores[k].reshape(r_l * n, r_r),
                                 full_matrices=False)
        keep = max(1, min(int(bond_ranks[k]), len(s)))
        u, s, vt = u[:, :keep], s[:keep], vt[:keep, :]
        cores[k] = u.reshape(r_l, n, keep)
        cores[k + 1] = np.einsum("lr,rjs->ljs", s[:, None] * vt,
                                 cores[k + 1])
    return cores


def tt_merge_cores(cores: List[np.ndarray],
                   groups: List[int]) -> List[np.ndarray]:
    """EXACTLY merge adjacent cores into per-group supercores.

    ``groups`` partitions the chain into contiguous runs (e.g.
    ``[2, 2, 1]`` for five cores); each run's cores contract into one
    supercore ``(r_left, prod(n_in_run), r_right)`` whose node axis is
    the row-major (first-dim-major) flattening — matching the
    Khatri-Rao row ordering of ``ops.eval._khatri_rao``.  No
    truncation anywhere: the merged chain represents the SAME tensor
    bit-for-bit (up to f64 contraction rounding).  This is the serving
    transform behind the grouped chains (``ops.tt_eval``,
    ``ops.tt_eval_dd``): interior bonds disappear into the supercore,
    so the per-point GEMMs contract over the group width instead of one
    dim's nodes.
    """
    groups = [int(g) for g in groups]
    if any(g < 1 for g in groups) or sum(groups) != len(cores):
        raise ValueError(
            f"groups {groups} must be positive and sum to {len(cores)}")
    out = []
    i = 0
    for g in groups:
        c = np.asarray(cores[i], dtype=np.float64)
        for j in range(i + 1, i + g):
            r0, n1, _ = c.shape
            nxt = np.asarray(cores[j], dtype=np.float64)
            _, n2, r2 = nxt.shape
            c = np.einsum("anb,bmc->anmc", c, nxt).reshape(r0, n1 * n2,
                                                           r2)
        out.append(c)
        i += g
    return out


def _chain_flops(cores_shapes) -> int:
    """Serving-cost proxy: per-point GEMM flops of the eval chain."""
    return int(sum(r_l * n * r_r for r_l, n, r_r in cores_shapes))


def tt_trim_cores(cores: List[np.ndarray], reference: np.ndarray,
                  sup_target: float):
    """Greedy per-bond rank trimming against a GRID SUP-NORM budget.

    The uniform-tolerance TT-SVD spends its error budget evenly across
    bonds, but serving cost is dominated by the largest bonds.  This
    routine trims bond ranks one at a time — each step cutting the
    bond with the best (chain-flop saving) / (sup-deviation increase)
    ratio — for as long as the reconstruction's max deviation from
    ``reference`` stays within ``sup_target * max|reference|``.  Every
    candidate is re-rounded from the INPUT cores (no compounding of
    successive truncations) and its deviation measured exactly on the
    full grid, so the returned guarantee is measured, not modeled.

    Returns ``(trimmed_cores, diagnostics)`` with diagnostics carrying
    the initial/final bond ranks, measured grid sup deviation
    (relative to ``max|reference|``), and chain-flop counts.  Host
    NumPy by design (compress-once, serve-forever workflow); cost is
    ~(total cuts) * (d - 1) roundings of tiny cores.
    """
    reference = np.asarray(reference, dtype=np.float64)
    scale = float(np.max(np.abs(reference))) or 1.0
    sup_target = float(sup_target)
    if sup_target <= 0:
        raise ValueError(f"sup_target must be > 0, got {sup_target}")
    d = len(cores)
    cores = [np.asarray(c, dtype=np.float64) for c in cores]
    if d == 1:
        return [c.copy() for c in cores], {
            "bond_ranks_initial": [], "bond_ranks": [],
            "grid_sup_dev": 0.0, "chain_flops_initial":
            _chain_flops([c.shape for c in cores]),
            "chain_flops": _chain_flops([c.shape for c in cores])}

    def _dev(cs):
        return float(np.max(np.abs(tt_reconstruct(cs) - reference))
                     ) / scale

    ranks0 = [cores[k].shape[2] for k in range(d - 1)]
    ranks = list(ranks0)
    current = tt_round_cores_ranks(cores, ranks)   # canonical baseline
    cur_dev = _dev(current)
    shapes = [c.shape for c in current]
    n_nodes = [s[1] for s in shapes]

    def _flops(rv):
        full = [1] + list(rv) + [1]
        return sum(full[k] * n_nodes[k] * full[k + 1] for k in range(d))

    while True:
        best = None
        for k in range(d - 1):
            if ranks[k] <= 1:
                continue
            trial = list(ranks)
            trial[k] -= 1
            cand = tt_round_cores_ranks(cores, trial)
            dev = _dev(cand)
            if dev > sup_target:
                continue
            saving = _flops(ranks) - _flops(trial)
            score = saving / max(dev - cur_dev, 1e-18)
            if best is None or score > best[0]:
                best = (score, k, cand, dev, trial)
        if best is None:
            break
        _, _, current, cur_dev, ranks = best

    diagnostics = {
        "bond_ranks_initial": ranks0,
        "bond_ranks": list(ranks),
        "grid_sup_dev": cur_dev,
        "chain_flops_initial": _flops(ranks0),
        "chain_flops": _flops(ranks),
    }
    return current, diagnostics


def tt_swap_adjacent(cores: List[np.ndarray], i: int, max_rank: int,
                     tolerance: float = 1e-12) -> List[np.ndarray]:
    """Swap storage axes i and i+1: merge the 2-core block, transpose the
    middle node axes, SVD-split with truncation.  Input not mutated."""
    if i < 0 or i >= len(cores) - 1:
        raise ValueError(f"i={i} out of range [0, {len(cores) - 1})")
    new_cores = [c.copy() for c in cores]
    a = new_cores[i]        # (r_l, n_a, r_m)
    b = new_cores[i + 1]    # (r_m, n_b, r_r)
    r_l, n_a, r_m = a.shape
    _, n_b, r_r = b.shape

    merged = np.einsum("lab,brs->lars", a, b)           # (r_l, n_a, n_b, r_r)
    merged = merged.transpose(0, 2, 1, 3)               # swap node axes
    u, s, vh = np.linalg.svd(merged.reshape(r_l * n_b, n_a * r_r),
                             full_matrices=False)
    keep = _svd_keep(s, max_rank, tolerance)
    u, s, vh = u[:, :keep], s[:keep], vh[:keep, :]

    new_cores[i] = (u * s).reshape(r_l, n_b, keep)
    new_cores[i + 1] = vh.reshape(keep, n_a, r_r)
    return new_cores

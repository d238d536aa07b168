"""Calculus helpers: rootfinding, 1-D optimization, bounds validation.

The port of ``pychebyshev_tpu.utils.calculus``, a copy: it is host
NumPy in both packages.  These are cold-path analysis routines over tiny
1-D coefficient vectors (n <= ~100): the colleague-matrix eigenproblem
(Good 1961) is a general nonsymmetric eig on the host; the surrounding
evaluation (slice values, candidate evaluation) runs through the
batched paths of the interpolant classes.
"""

from __future__ import annotations

import numpy as np

from pychebyshev_tpu_torch.config import NODE_COINCIDENCE_TOL

__all__ = [
    "normalize_bounds",
    "normalize_bounds_batch",
    "roots_1d",
    "roots_1d_batch",
    "optimize_1d",
    "optimize_1d_batch",
    "optimize_resampled_batch",
    "validate_calculus_args",
    "validate_calculus_args_batch",
    "validate_partial_integrate_args_batch",
    "scenario_slice_points",
    "slider_partition_intersect",
]


def normalize_bounds(dims, bounds, domain, dim_labels=None):
    """Normalize/validate ``integrate(bounds=...)``.

    Returns one ``(lo, hi)`` or ``None`` (= full domain) per entry of
    *dims*.  Raises ValueError on out-of-domain bounds, lo > hi, or
    length mismatch.  ``dim_labels`` overrides indices in error messages
    (callers with storage-frame dims pass user-frame labels).
    """
    if bounds is None:
        return [None] * len(dims)

    # A bare (lo, hi) pair is shorthand for a one-dim spec.
    if (isinstance(bounds, tuple) and len(bounds) == 2
            and not isinstance(bounds[0], (list, tuple))):
        bounds = [bounds]

    if len(bounds) != len(dims):
        raise ValueError(
            f"bounds length {len(bounds)} does not match the "
            f"{len(dims)} integrated dims"
        )

    labels = dims if dim_labels is None else dim_labels
    if len(labels) != len(dims):
        raise ValueError(
            f"dim_labels length {len(labels)} != dims length {len(dims)}"
        )

    def _one(spec, d, label):
        if spec is None:
            return None
        lo, hi = spec
        if hi < lo:
            raise ValueError(
                f"invalid sub-interval for dim {label}: lo={lo} > hi={hi}"
            )
        full_lo, full_hi = domain[d]
        # 1e-14 slack absorbs representation noise at the domain edges.
        if lo < full_lo - 1e-14 or hi > full_hi + 1e-14:
            raise ValueError(
                f"dim {label}: bounds ({lo}, {hi}) extend outside domain "
                f"[{full_lo}, {full_hi}]"
            )
        return (max(lo, full_lo), min(hi, full_hi))

    return [_one(spec, d, label)
            for spec, d, label in zip(bounds, dims, labels)]


def normalize_bounds_batch(bounds, domain) -> np.ndarray:
    """Validate a (B, d, 2) batch of axis-aligned boxes against *domain*.

    The batched counterpart of :func:`normalize_bounds` for the
    ``integrate_batch`` surface: every box must satisfy lo <= hi per dim
    and lie inside the domain (same 1e-14 representation slack).  Returns
    a float64 array clamped to the domain; degenerate (zero-measure)
    dims are allowed and integrate to exactly zero.
    """
    arr = np.asarray(bounds, dtype=np.float64)
    d = len(domain)
    if arr.ndim != 3 or arr.shape[1] != d or arr.shape[2] != 2:
        raise ValueError(
            f"bounds must have shape (B, {d}, 2) — one (lo, hi) pair per "
            f"dim per box; got {arr.shape}")
    if not np.isfinite(arr).all():
        raise ValueError("bounds contain non-finite values")
    lo, hi = arr[..., 0], arr[..., 1]
    inverted = hi < lo
    if inverted.any():
        b, dd = np.argwhere(inverted)[0]
        raise ValueError(
            f"invalid sub-interval for box {b}, dim {dd}: "
            f"lo={lo[b, dd]} > hi={hi[b, dd]}")
    dom = np.asarray(domain, dtype=np.float64)
    outside = (lo < dom[None, :, 0] - 1e-14) | (hi > dom[None, :, 1] + 1e-14)
    if outside.any():
        b, dd = np.argwhere(outside)[0]
        raise ValueError(
            f"box {b}, dim {dd}: bounds ({lo[b, dd]}, {hi[b, dd]}) extend "
            f"outside domain [{dom[dd, 0]}, {dom[dd, 1]}]")
    lo = np.maximum(lo, dom[None, :, 0])
    hi = np.maximum(np.minimum(hi, dom[None, :, 1]), lo)
    return np.stack([lo, hi], axis=-1)


def _filter_candidate_roots(candidates, domain) -> np.ndarray:
    """Colleague eigenvalues -> sorted deduped real roots in *domain*.

    Nearly-real eigenvalues landing in [-1, 1] (tol slack on both
    tests) are snapped onto the interval, mapped to the physical
    domain, sorted, and near-duplicate neighbours collapsed (the
    colleague matrix can report one root twice).
    """
    candidates = np.atleast_1d(candidates)
    tol = 1e-10
    keep = ((np.abs(candidates.imag) < tol)
            & (candidates.real >= -1.0 - tol)
            & (candidates.real <= 1.0 + tol))
    t = np.clip(candidates.real[keep], -1.0, 1.0)
    if t.size == 0:
        return np.array([], dtype=float)

    a, b = domain
    xs = np.sort((a + b + (b - a) * t) / 2.0)
    survivors = np.ones(xs.size, dtype=bool)
    survivors[1:] = np.diff(xs) > 1e-10 * (abs(b - a) + 1.0)
    return xs[survivors]


def roots_1d(values, domain) -> np.ndarray:
    """All real roots of a 1-D interpolant (values at ascending Type-I nodes).

    Chebyshev coefficients -> colleague-matrix roots
    (``numpy.polynomial.chebyshev.chebroots``) -> filter real roots in
    [-1, 1] -> map to the physical domain -> sort + dedupe.
    """
    from numpy.polynomial.chebyshev import chebroots

    from pychebyshev_tpu_torch.ops.dct import _coeff_matrix_np

    values = np.asarray(values, dtype=np.float64)
    candidates = chebroots(_coeff_matrix_np(values.size) @ values)
    return _filter_candidate_roots(candidates, domain)


def roots_1d_batch(values, domain) -> list:
    """Roots of B 1-D interpolants at once — values (B, n) at ascending
    Type-I nodes -> list of B sorted root arrays.

    Per-row results are BIT-IDENTICAL to :func:`roots_1d`: the
    coefficient transform runs as the same per-row GEMV (a batched GEMM
    can round a last ulp differently, which flips the root COUNT at
    tangential zeros — a double root's complex eigenvalue pair sits on
    the 1e-10 imag tolerance), and LAPACK applies the same eigensolve
    per matrix in a stack.  Only the companion assembly is batched: one
    stacked ``np.linalg.eigvals`` per effective-degree group (rows
    whose trailing coefficients are exact zeros need smaller companions
    — mirroring numpy's ``as_series`` trimming inside ``chebroots``).
    """
    from pychebyshev_tpu_torch.ops.dct import _coeff_matrix_np

    values = np.asarray(values, dtype=np.float64)
    if values.ndim != 2:
        raise ValueError(f"values must be (B, n); got shape {values.shape}")
    n_rows, n = values.shape
    coeff_mat = _coeff_matrix_np(n)
    coeffs = np.stack([coeff_mat @ row for row in values]) \
        if n_rows else np.zeros((0, n))

    nonzero = coeffs != 0.0
    length = np.where(nonzero.any(axis=1),
                      n - np.argmax(nonzero[:, ::-1], axis=1), 1)
    out = [None] * n_rows
    for size in np.unique(length):
        rows = np.nonzero(length == size)[0]
        if size == 1:
            empty = np.array([], dtype=float)
            for b in rows:
                out[b] = empty
            continue
        c = coeffs[rows, :size]
        if size == 2:
            eigs = (-c[:, 0] / c[:, 1])[:, None]
        else:
            # Batched numpy chebcompanion (symmetrized colleague form).
            m = size - 1
            mat = np.zeros((len(rows), m, m))
            off = np.full(m - 1, 0.5)
            off[0] = np.sqrt(0.5)
            diag_idx = np.arange(m - 1)
            mat[:, diag_idx, diag_idx + 1] = off
            mat[:, diag_idx + 1, diag_idx] = off
            scl = np.concatenate([[1.0], np.full(m - 1, np.sqrt(0.5))])
            mat[:, :, -1] -= (c[:, :-1] / c[:, -1:]) * (scl / scl[-1]) * 0.5
            # chebroots rotates the companion 180 degrees before the
            # eigensolve ("reduces error"); match it exactly, or double
            # roots flip between a real and a complex pair across the
            # imag tolerance, changing the root COUNT vs the per-call
            # path.
            eigs = np.linalg.eigvals(mat[:, ::-1, ::-1])
        for j, b in enumerate(rows):
            out[b] = _filter_candidate_roots(eigs[j], domain)
    return out


def optimize_1d(values, nodes, bary_weights, diff_matrix, domain,
                mode: str = "min"):
    """Min or max of a 1-D interpolant via derivative roots + endpoints.

    Returns ``(value, location)``.
    """
    values = np.asarray(values, dtype=np.float64)
    nodes = np.asarray(nodes, dtype=np.float64)
    bary_weights = np.asarray(bary_weights, dtype=np.float64)
    diff_matrix = np.asarray(diff_matrix, dtype=np.float64)

    deriv_values = diff_matrix @ values
    critical = roots_1d(deriv_values, domain)

    a, b = domain
    candidates = np.concatenate([[a], critical, [b]]).astype(np.float64)

    # Vectorized barycentric evaluation at all candidates (host, tiny).
    diff = candidates[:, None] - nodes[None, :]
    exact = np.abs(diff) < NODE_COINCIDENCE_TOL
    has_exact = exact.any(axis=1)
    safe = np.where(exact, 1.0, diff)
    w_over_diff = bary_weights[None, :] / safe
    vals = (w_over_diff * values[None, :]).sum(axis=1) / w_over_diff.sum(axis=1)
    if has_exact.any():
        vals = np.where(has_exact, values[exact.argmax(axis=1)], vals)

    idx = int(np.argmin(vals) if mode == "min" else np.argmax(vals))
    return float(vals[idx]), float(candidates[idx])


# Cap on the (rows x candidates x nodes) intermediate in
# optimize_1d_batch; rows chunk beyond it.
_OPT_CHUNK_ELEMS = 1 << 24


def optimize_1d_batch(values, nodes, bary_weights, diff_matrix, domain,
                      mode: str = "min"):
    """Batched :func:`optimize_1d`: values (B, n) -> ((B,) extrema,
    (B,) locations).

    Critical points come from :func:`roots_1d_batch` on the spectral
    derivative; per-row candidate lists (endpoints + critical points)
    are padded to a rectangle with the left endpoint — a duplicate
    candidate never changes a min/max — so the barycentric candidate
    evaluation stays one vectorized (B, K, n) pass.
    """
    values = np.asarray(values, dtype=np.float64)
    nodes = np.asarray(nodes, dtype=np.float64)
    bary_weights = np.asarray(bary_weights, dtype=np.float64)
    diff_matrix = np.asarray(diff_matrix, dtype=np.float64)
    n_rows = values.shape[0]

    # Bound the (B, K, n) candidate-evaluation intermediate: chunk rows
    # past ~_OPT_CHUNK_ELEMS worst-case elements (K <= n+1 candidates),
    # so large scenario batches never allocate gigabytes here.
    per_row_bound = (nodes.size + 1) * nodes.size
    chunk = max(256, _OPT_CHUNK_ELEMS // max(per_row_bound, 1))
    if n_rows > chunk:
        parts = [optimize_1d_batch(values[i:i + chunk], nodes,
                                   bary_weights, diff_matrix, domain,
                                   mode=mode)
                 for i in range(0, n_rows, chunk)]
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))

    # Per-row GEMV (not a batched GEMM) so the critical points are
    # bit-identical to optimize_1d's — see roots_1d_batch.
    deriv_values = np.stack([diff_matrix @ row for row in values]) \
        if n_rows else np.zeros_like(values)
    critical = roots_1d_batch(deriv_values, domain)
    a, b = domain
    width = max(len(c) for c in critical) if critical else 0
    candidates = np.full((n_rows, width + 2), a, dtype=np.float64)
    candidates[:, -1] = b
    for i, c in enumerate(critical):
        candidates[i, 1:1 + len(c)] = c

    diff = candidates[:, :, None] - nodes[None, None, :]
    exact = np.abs(diff) < NODE_COINCIDENCE_TOL
    has_exact = exact.any(axis=2)
    safe = np.where(exact, 1.0, diff)
    w_over_diff = bary_weights[None, None, :] / safe
    vals = ((w_over_diff * values[:, None, :]).sum(axis=2)
            / w_over_diff.sum(axis=2))
    if has_exact.any():
        nearest = np.take_along_axis(
            np.broadcast_to(values[:, None, :], exact.shape),
            exact.argmax(axis=2)[:, :, None], axis=2)[:, :, 0]
        vals = np.where(has_exact, nearest, vals)

    idx = vals.argmin(axis=1) if mode == "min" else vals.argmax(axis=1)
    rows = np.arange(n_rows)
    return vals[rows, idx], candidates[rows, idx]


def optimize_resampled_batch(values, nodes, domain, mode):
    """:func:`optimize_1d_batch` over a freshly-resampled slice —
    derives the barycentric weights and differentiation matrix from the
    nodes (the shared tail of every family's ``minimize_batch`` /
    ``maximize_batch`` except dense, which reuses its stored arrays)."""
    from pychebyshev_tpu_torch.ops.chebyshev import (
        barycentric_weights_np,
        differentiation_matrix_np,
    )
    weights = barycentric_weights_np(np.asarray(nodes))
    return optimize_1d_batch(
        values, nodes, weights,
        differentiation_matrix_np(np.asarray(nodes), weights), domain,
        mode=mode)


def validate_calculus_args_batch(ndim, dim, fixed, domain):
    """Validate batched roots/minimize/maximize args.

    ``fixed`` maps every dim except *dim* to a scalar or a (B,) array
    (scalars broadcast).  Returns ``(dim, fixed_cols, B)`` where
    ``fixed_cols`` is ``{d: (B,) float64 array}``.
    """
    if ndim == 1:
        raise ValueError(
            "batched calculus needs at least one fixed dim to batch "
            "over; on a 1-D interpolant use roots()/minimize()/"
            "maximize()")
    if dim is None:
        raise ValueError(
            "dim is required on a multi-dimensional interpolant")
    if not 0 <= dim < ndim:
        raise ValueError(f"dim {dim} out of range [0, {ndim - 1}]")

    fixed = dict(fixed) if fixed else {}
    required = set(range(ndim)) - {dim}
    if set(fixed) != required:
        missing = required - set(fixed)
        extra = set(fixed) - required
        parts = []
        if missing:
            parts.append(f"missing {sorted(missing)}")
        if extra:
            parts.append(f"unexpected {sorted(extra)}")
        raise ValueError(
            f"fixed must pin every dim except {dim}: "
            + "; ".join(parts))

    cols = {}
    batch = 1
    for d, v in fixed.items():
        arr = np.asarray(v, dtype=np.float64)
        if arr.ndim > 1:
            raise ValueError(
                f"fixed[{d}] must be a scalar or a 1-D array; got shape "
                f"{arr.shape}")
        if arr.size == 0:
            raise ValueError(f"fixed[{d}] is empty — no scenarios to batch")
        if arr.ndim == 1 and arr.size != 1:
            if batch not in (1, arr.size):
                raise ValueError(
                    f"fixed arrays disagree on batch length: {batch} "
                    f"vs {arr.size} (fixed[{d}])")
            batch = arr.size
        cols[d] = arr

    for d in sorted(cols):
        arr = np.broadcast_to(np.atleast_1d(cols[d]), (batch,))
        lo, hi = domain[d]
        # NaN compares False on both sides — flag non-finite explicitly.
        bad = (arr < lo) | (arr > hi) | ~np.isfinite(arr)
        if bad.any():
            i = int(np.argmax(bad))
            raise ValueError(
                f"fixed[{d}][{i}] = {arr[i]} lies outside that dim's "
                f"domain [{lo}, {hi}]")
        cols[d] = np.ascontiguousarray(arr, dtype=np.float64)
    return dim, cols, batch


def validate_partial_integrate_args_batch(ndim, domain, dims, bounds,
                                          points, derivative_order=None,
                                          max_order=None):
    """Shared preamble for ``partial_integrate_batch`` on every family.

    Normalizes/validates the integrated ``dims``, the (B, |dims|, 2)
    ``bounds`` (against those dims' domain), the (B, d-|dims|)
    ``points``, and the per-remaining-dim ``derivative_order`` (bounded
    by ``max_order`` when given).  Returns
    ``(dims, bounds_arr, remaining, points_arr, rem_orders)``.
    """
    if isinstance(dims, int):
        dims = [dims]
    dims = sorted(set(int(k) for k in dims))
    if not dims:
        raise ValueError(
            "dims must name at least one dim to integrate — use "
            "eval_batch for pure evaluation")
    for k in dims:
        if k < 0 or k >= ndim:
            raise ValueError(f"dim {k} out of range [0, {ndim - 1}]")
    arr = normalize_bounds_batch(bounds, [domain[k] for k in dims])
    remaining = [k for k in range(ndim) if k not in set(dims)]
    pts = np.asarray(points, dtype=np.float64)
    if pts.ndim != 2 or pts.shape != (arr.shape[0], len(remaining)):
        raise ValueError(
            f"points must have shape ({arr.shape[0]}, {len(remaining)}) "
            f"— one coordinate per remaining dim {remaining} per box; "
            f"got {pts.shape}")
    rem_orders = [int(o) for o in (derivative_order
                                   if derivative_order is not None
                                   else [0] * len(remaining))]
    if len(rem_orders) != len(remaining):
        raise ValueError(
            f"derivative_order must have one entry per remaining dim "
            f"{remaining}; got {len(rem_orders)}")
    for k, o in zip(remaining, rem_orders):
        if o < 0 or (max_order is not None and o > max_order):
            raise ValueError(
                f"derivative order {o} for dim {k} outside "
                f"[0, {max_order}]")
    return dims, arr, remaining, pts, rem_orders


def scenario_slice_points(ndim, dim, fixed_cols, batch, nodes_dim):
    """Query points resampling the 1-D slice along *dim* for B scenarios.

    Returns (B * n, ndim): scenario b's block holds ``nodes_dim`` in
    column *dim* and ``fixed_cols[d][b]`` in every other column — one
    fused eval_batch over these rows gives the (B, n) slice values that
    :func:`roots_1d_batch` / :func:`optimize_1d_batch` consume.
    Resampling a polynomial slice at its own Type-I nodes is exact, so
    batched calculus matches the per-call slice path.
    """
    nodes_dim = np.asarray(nodes_dim, dtype=np.float64)
    n = nodes_dim.size
    pts = np.empty((batch, n, ndim), dtype=np.float64)
    for d, col in fixed_cols.items():
        pts[:, :, d] = col[:, None]
    pts[:, :, dim] = nodes_dim[None, :]
    return pts.reshape(batch * n, ndim)


def validate_calculus_args(ndim, dim, fixed, domain):
    """Validate roots/minimize/maximize args.

    Returns ``(dim, slice_params)`` where slice_params fixes every other
    dimension.
    """
    fixed = dict(fixed) if fixed else {}

    if ndim == 1:
        if dim not in (None, 0):
            raise ValueError(
                f"a 1-D interpolant has only dim 0 (dim must be 0 or "
                f"omitted); got dim={dim}")
        if fixed:
            raise ValueError(
                "fixed must be empty on a 1-D interpolant — there are "
                "no other dims to pin")
        return 0, []

    if dim is None:
        raise ValueError(
            "dim is required on a multi-dimensional interpolant")
    if not 0 <= dim < ndim:
        raise ValueError(f"dim {dim} out of range [0, {ndim - 1}]")

    required = set(range(ndim)) - {dim}
    if set(fixed) != required:
        raise ValueError(
            f"fixed must pin every dim except {dim}; "
            f"missing {required - set(fixed)}"
        )

    out_of_domain = [(d, v) for d, v in fixed.items()
                     if not domain[d][0] <= v <= domain[d][1]]
    if out_of_domain:
        d, v = out_of_domain[0]
        raise ValueError(
            f"fixed[{d}] = {v} lies outside that dim's domain "
            f"[{domain[d][0]}, {domain[d][1]}]"
        )
    return dim, list(fixed.items())


def slider_partition_intersect(group_dims, integrate_dims):
    """Classify a slider group vs an integration set.

    Returns ``(kind, kept)`` with kind in {"full", "partial", "none"} and
    ``kept`` the group dims not being integrated.
    """
    group_set = set(group_dims)
    overlap = group_set & set(integrate_dims)
    if not overlap:
        return "none", list(group_dims)
    if overlap == group_set:
        return "full", []
    return "partial", [d for d in group_dims if d not in overlap]


# ----------------------------------------------------------------------
# Reference-name compat aliases (`from pychebyshev._calculus import ...`)
# ----------------------------------------------------------------------

def _integrate_tt_along_dim(core, weights):
    """Contract a (r_l, n, r_r) TT core's node axis with quadrature
    weights -> (r_l, r_r)."""
    import numpy as _np
    return _np.einsum("rjs,j->rs", core, weights)


def _compute_fejer1_weights(n):
    from pychebyshev_tpu_torch.ops.quadrature import fejer1_weights
    return fejer1_weights(n)


def _compute_sub_interval_weights(n, t_lo, t_hi):
    from pychebyshev_tpu_torch.ops.quadrature import sub_interval_weights
    return sub_interval_weights(n, t_lo, t_hi)


_slider_partition_intersect = slider_partition_intersect
_normalize_bounds = normalize_bounds
_roots_1d = roots_1d
_optimize_1d = optimize_1d
_validate_calculus_args = validate_calculus_args

"""Global (whole-domain) calculus for the four interpolant
families: certified global minimize/maximize, critical-point finding,
and N-D polynomial system solving.

The port of ``pychebyshev_tpu.utils.globalcalc``.  The machinery is
``ops/subdivision.py``'s coefficient-space branch-and-bound; this
module adapts it to each family's structure:

- dense grids: one coefficient tensor, direct;
- splines: per-piece search sharing one incumbent (kinks are exact —
  every piece boundary belongs to both neighbors' closed boxes);
- sliders: the additive decomposition makes the global optimum exactly
  separable — the sum of per-slide global optima;
- tensor trains: the same search through coefficient cores with an
  interval transfer-matrix enclosure (no n^d materialization).

Candidate polishing goes back through the models' own batched
evaluation (``eval_batch_host``, ``vectorized_eval_batch`` /
``vectorized_eval_batch_multi``, which return host NumPy), so the
host-side search and the device paths stay the same code the rest of
the package serves with.  The dense optimum searches run their large
box statistics on the model's ``device``; zero isolation (critical
points, systems) stays host NumPy as in the reference, and so do the
TT bounder's chains, O(d n^2 r^2) a box.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from pychebyshev_tpu_torch.ops.chebyshev import (
    _chebpts1_np,
    barycentric_weights_np,
    differentiation_matrix_np,
    nodes_for_dim_np,
)
from pychebyshev_tpu_torch.ops.dct import _coeff_matrix_np
from pychebyshev_tpu_torch.ops.integrate import host_array
from pychebyshev_tpu_torch.ops.subdivision import (
    GlobalResult,
    isolate_common_zeros,
    isolate_common_zeros_tt,
    minimize_coeff_tensor,
    minimize_tt_cores,
)
from pychebyshev_tpu_torch.utils.calculus import optimize_1d, roots_1d

__all__ = [
    "CriticalPoint",
    "validate_global_args",
    "dense_coeff_tensor",
    "global_optimize_dense",
    "global_optimize_spline",
    "global_optimize_slider",
    "global_optimize_tt",
    "critical_points_dense",
    "critical_points_slider",
    "critical_points_spline",
    "critical_points_tt",
    "solve_system",
]


class CriticalPoint(NamedTuple):
    """One interior stationary point: location, value, and its kind
    ("minimum", "maximum", "saddle", or "degenerate")."""

    point: np.ndarray
    value: float
    kind: str


# ----------------------------------------------------------------------
# Shared plumbing
# ----------------------------------------------------------------------

def validate_global_args(ndim: int, fixed, domain) -> Dict[int, float]:
    """Validate a partial ``fixed`` map for the global (dim=None) paths.

    Unlike :func:`utils.calculus.validate_calculus_args`, the global
    surface allows pinning any SUBSET of dims; at least one must remain
    free.
    """
    fixed = dict(fixed) if fixed else {}
    out: Dict[int, float] = {}
    for d, v in fixed.items():
        di = int(d)
        if not 0 <= di < ndim:
            raise ValueError(f"fixed dim {d} out of range [0, {ndim - 1}]")
        v = float(v)
        if not domain[di][0] <= v <= domain[di][1]:
            raise ValueError(
                f"fixed[{di}] = {v} lies outside that dim's domain "
                f"[{domain[di][0]}, {domain[di][1]}]")
        out[di] = v
    if len(out) >= ndim:
        raise ValueError(
            "fixed pins every dim — at least one dim must remain free "
            "for a global optimum (use eval() for a point value)")
    return out


def dense_coeff_tensor(tensor_values) -> np.ndarray:
    """Value tensor (ascending Type-I nodes per dim; host NumPy or a
    tensor on any device) -> Chebyshev coefficient tensor, host f64."""
    c = np.asarray(host_array(tensor_values), dtype=np.float64)
    for ax in range(c.ndim):
        mat = _coeff_matrix_np(c.shape[ax])
        c = np.moveaxis(np.tensordot(mat, c, axes=([1], [ax])), 0, ax)
    return c


def _local_to_phys(domain: np.ndarray, loc: np.ndarray) -> np.ndarray:
    return domain[:, 0] + (loc + 1.0) * 0.5 * (domain[:, 1] - domain[:, 0])


def _warn_uncertified(what: str, res: GlobalResult, tol: float,
                      max_boxes: int) -> None:
    if res.certified:
        return
    if res.boxes >= max_boxes:
        why = (f"branch-and-bound hit max_boxes={max_boxes}; raise "
               "max_boxes, or loosen tol (certifying below the build's "
               "own error estimate examines every oscillation cell)")
    else:
        why = ("the remaining gap is at the f64 roundoff/width floor — "
               "loosen tol (the certificate cannot go below ~1e-13 "
               "relative)")
    warnings.warn(
        f"{what}: remaining bound gap {res.gap:.3e} (> tol={tol:.1e}); "
        f"the returned optimum is the best point found but is not "
        f"certified — {why}",
        RuntimeWarning, stacklevel=3)


def _fill_point(ndim: int, free_dims: Sequence[int], free_loc: np.ndarray,
                fixed: Dict[int, float]) -> np.ndarray:
    out = np.empty(ndim)
    for d, v in fixed.items():
        out[d] = v
    for i, d in enumerate(free_dims):
        out[d] = free_loc[i]
    return out


def _value_batch_fn(model):
    """Zero-order batched evaluation closure for one model.

    Prefers the host tier when the model has one: polish fibers are
    ~n-point micro-batches, where a device dispatch and its copy back
    dominate the arithmetic.  Either way the values come back as host
    NumPy."""
    zero = [0] * model.num_dimensions
    fn = getattr(model, "eval_batch_host", None)
    if fn is None:
        fn = model.vectorized_eval_batch
    return lambda pts: fn(pts, zero)


def _host_grid_1d(lo: float, hi: float, n: int):
    """(nodes, barycentric weights, differentiation matrix) on host."""
    nodes = nodes_for_dim_np(lo, hi, n)
    weights = barycentric_weights_np(nodes)
    return nodes, weights, differentiation_matrix_np(nodes, weights)


def _coordinate_polish(eval_batch_fn, domain: np.ndarray,
                       n_nodes: Sequence[int], loc: np.ndarray, mode: str,
                       sweeps: int = 2) -> Tuple[float, np.ndarray]:
    """Cyclic exact line searches through the current best point.

    Each pass re-samples the 1-D fiber along one dim at that dim's own
    Type-I nodes (exact for the interpolant) and solves the fiber's
    global optimum with the existing colleague-matrix machinery.  The
    objective can only improve, so any certificate from the preceding
    branch-and-bound still holds.
    """
    d = domain.shape[0]
    loc = loc.copy()
    sign = 1.0 if mode == "min" else -1.0
    best = None
    for _ in range(max(int(sweeps), 0)):
        improved = False
        for i in range(d):
            n = int(n_nodes[i])
            nodes, weights, diff = _host_grid_1d(
                domain[i, 0], domain[i, 1], n)
            pts = np.tile(loc, (n, 1))
            pts[:, i] = nodes
            fiber = np.asarray(eval_batch_fn(pts), dtype=np.float64)
            val, x = optimize_1d(fiber, nodes, weights, diff,
                                 (domain[i, 0], domain[i, 1]), mode=mode)
            # The fiber passes through the current best point, so the
            # line optimum can only match or improve it.
            if best is None or sign * val < sign * best:
                improved = best is not None
                best = val
                loc[i] = x
        if not improved:
            break
    return float(best), loc


# ----------------------------------------------------------------------
# Dense grids
# ----------------------------------------------------------------------

def _optimize_dense_core(model, mode: str, tol: float, max_boxes: int,
                         polish: bool, seed_value: Optional[float] = None,
                         ) -> Tuple[float, np.ndarray, GlobalResult]:
    """Global optimum of one (already sliced) dense model.  Returns
    (value, physical location (m,), raw GlobalResult).  The search's
    large box statistics run on ``model.device``."""
    values = np.asarray(host_array(model.tensor_values), dtype=np.float64)
    m = values.ndim
    domain = np.asarray(model.domain, dtype=np.float64)
    sign = 1.0 if mode == "min" else -1.0

    if m == 1:
        val, x = optimize_1d(*model._host_1d(), model.domain[0], mode=mode)
        res = GlobalResult(sign * val, np.zeros(1), 0.0, True, 0)
        return val, np.array([x]), res

    coeffs = dense_coeff_tensor(values) * sign
    node_coords = [_chebpts1_np(n) for n in values.shape]
    res = minimize_coeff_tensor(
        coeffs, tol=tol, max_boxes=max_boxes,
        node_values=sign * values, node_coords=node_coords,
        seed_value=None if seed_value is None else sign * seed_value,
        device=model.device)
    value = sign * res.value
    loc = _local_to_phys(domain, res.location)
    if polish:
        value, loc = _coordinate_polish(
            _value_batch_fn(model), domain, values.shape, loc, mode)
    return value, loc, res


def global_optimize_dense(model, mode: str, fixed, *, tol: float,
                          max_boxes: int, polish: bool,
                          ) -> Tuple[float, np.ndarray]:
    """Certified global min/max of a dense interpolant over its box,
    optionally with a subset of dims pinned via ``fixed``."""
    ndim = model.num_dimensions
    fixed = validate_global_args(ndim, fixed, model.domain)
    target = model.slice(sorted(fixed.items())) if fixed else model
    free_dims = [d for d in range(ndim) if d not in fixed]

    value, loc, res = _optimize_dense_core(
        target, mode, tol, max_boxes, polish)
    _warn_uncertified(f"{mode}imize (global)", res, tol, max_boxes)
    return value, _fill_point(ndim, free_dims, loc, fixed)


# ----------------------------------------------------------------------
# Splines: per-piece search, one shared incumbent
# ----------------------------------------------------------------------

def global_optimize_spline(spline, mode: str, fixed, *, tol: float,
                           max_boxes: int, polish: bool,
                           ) -> Tuple[float, np.ndarray]:
    ndim = spline.num_dimensions
    fixed = validate_global_args(ndim, fixed, spline.domain)
    target = spline.slice(sorted(fixed.items())) if fixed else spline
    free_dims = [d for d in range(ndim) if d not in fixed]

    sign = 1.0 if mode == "min" else -1.0
    pieces = list(target._pieces)
    # Cheapest-first: order pieces by their best grid value so the
    # incumbent prunes later pieces' searches early.
    order = np.argsort([
        sign * float((np.min if mode == "min" else np.max)(
            host_array(p.tensor_values))) for p in pieces])

    best: Optional[float] = None
    best_loc: Optional[np.ndarray] = None
    best_piece = None
    for idx in order:
        piece = pieces[idx]
        val, loc, res = _optimize_dense_core(
            piece, mode, tol, max_boxes, polish=False, seed_value=best)
        if not res.certified:
            _warn_uncertified(f"{mode}imize (spline piece)", res, tol,
                              max_boxes)
        if best is None or sign * val < sign * best:
            best, best_loc, best_piece = val, loc, piece
    if polish and best_piece is not None and best_piece.num_dimensions > 1:
        best, best_loc = _coordinate_polish(
            _value_batch_fn(best_piece),
            np.asarray(best_piece.domain, dtype=np.float64),
            [int(n) for n in best_piece.tensor_values.shape],
            best_loc, mode)
    return best, _fill_point(ndim, free_dims, best_loc, fixed)


# ----------------------------------------------------------------------
# Sliders: exactly separable over the additive groups
# ----------------------------------------------------------------------

def global_optimize_slider(slider, mode: str, fixed, *, tol: float,
                           max_boxes: int, polish: bool,
                           ) -> Tuple[float, np.ndarray]:
    """Global optimum of an additive slider — EXACTLY the pivot value
    plus the sum of per-slide global offsets, each solved independently
    on its own low-dimensional grid (the cross-group Hessian is zero, so
    no joint search is needed)."""
    ndim = slider.num_dimensions
    fixed = validate_global_args(ndim, fixed, slider.domain)

    total = float(slider.pivot_value)
    point = np.empty(ndim)
    for d, v in fixed.items():
        point[d] = v
    # The groups' optima ADD, so each group's certificate must carry a
    # share of tol for the summed result to be certified to tol.
    n_searched = sum(
        1 for group in slider.partition
        if any(d not in fixed for d in group))
    tol_group = tol / max(n_searched, 1)
    for group, slide in zip(slider.partition, slider.slides):
        group = list(group)
        local_fixed = {i: fixed[d] for i, d in enumerate(group)
                       if d in fixed}
        if len(local_fixed) == len(group):
            pt = [local_fixed[i] for i in range(len(group))]
            val = float(slide.vectorized_eval(pt, [0] * len(group)))
            total += val - float(slider.pivot_value)
            continue
        sub = (slide.slice(sorted(local_fixed.items()))
               if local_fixed else slide)
        val, loc, res = _optimize_dense_core(sub, mode, tol_group,
                                             max_boxes, polish)
        _warn_uncertified(f"{mode}imize (slider group {group})", res, tol,
                          max_boxes)
        total += val - float(slider.pivot_value)
        free_local = [d for i, d in enumerate(group) if i not in local_fixed]
        for j, d in enumerate(free_local):
            point[d] = loc[j]
    return total, point


# ----------------------------------------------------------------------
# Tensor trains: the core-form bounder
# ----------------------------------------------------------------------

def global_optimize_tt(tt, mode: str, fixed, *, tol: float,
                       max_boxes: int, polish: bool,
                       ) -> Tuple[float, np.ndarray]:
    ndim = tt.num_dimensions
    fixed = validate_global_args(ndim, fixed, tt._user_frame_domain())
    target = tt.slice(sorted(fixed.items())) if fixed else tt
    free_dims = [d for d in range(ndim) if d not in fixed]

    m = target.num_dimensions
    sign = 1.0 if mode == "min" else -1.0
    cores = [np.asarray(c, dtype=np.float64)
             for c in target._coeff_cores]
    if sign < 0:
        cores = [c.copy() for c in cores]
        cores[0] = -cores[0]
    # target.domain / target.n_nodes are STORAGE-frame (core k holds
    # user dim _dim_order[k]); evaluation points are user-frame.
    order = list(target._dim_order)
    dom_s = np.asarray(target.domain, dtype=np.float64)
    dom_user = np.asarray(target._user_frame_domain(), dtype=np.float64)
    n_user = [int(target.n_nodes[order.index(d)]) for d in range(m)]

    # Deterministic lattice seed through the batched evaluation: cycle
    # each dim's own nodes with coprime-ish strides.
    n_seed = max(max(n_user), 17)
    seed_pts = np.empty((n_seed, m))
    for d in range(m):
        nodes = nodes_for_dim_np(dom_user[d, 0], dom_user[d, 1], n_user[d])
        seed_pts[:, d] = nodes[(np.arange(n_seed) * (2 * d + 1)) % n_user[d]]
    seed_vals = sign * np.asarray(
        _value_batch_fn(target)(seed_pts), dtype=np.float64).reshape(-1)
    i0 = int(np.argmin(seed_vals))
    seed_val = float(seed_vals[i0])
    seed_user = seed_pts[i0]
    width_s = dom_s[:, 1] - dom_s[:, 0]
    seed_loc_s = 2.0 * (seed_user[order] - dom_s[:, 0]) / width_s - 1.0

    res = minimize_tt_cores(cores, tol=tol, max_boxes=max_boxes,
                            seed_value=seed_val, seed_loc=seed_loc_s)
    _warn_uncertified(f"{mode}imize (TT global)", res, tol, max_boxes)
    value = sign * res.value
    loc_s = _local_to_phys(dom_s, res.location)
    loc_user = np.empty(m)
    for k, d in enumerate(order):
        loc_user[d] = loc_s[k]
    if polish and m > 1:
        value, loc_user = _coordinate_polish(
            _value_batch_fn(target), dom_user, n_user, loc_user, mode)
    return value, _fill_point(ndim, free_dims, loc_user, fixed)


# ----------------------------------------------------------------------
# Critical points (dense / spline) and system solving
# ----------------------------------------------------------------------

def _newton_polish(points: np.ndarray, domain: np.ndarray,
                   fg_fn, tol: float, max_iter: int = 30) -> Tuple[
                       np.ndarray, np.ndarray]:
    """Projected Newton on a square system.  ``fg_fn(pts) -> (F, J)``
    with F (K, d) residuals and J (K, d, d) Jacobians.  Iterates are
    clipped to the domain box.  Returns (points, final residuals)."""
    pts = points.copy()
    lo, hi = domain[:, 0], domain[:, 1]
    for _ in range(max_iter):
        F, J = fg_fn(pts)
        resid = np.abs(F).max(axis=1)
        if (resid <= 0.1 * tol).all():
            break
        try:
            step = np.linalg.solve(J, -F[..., None])[..., 0]
        except np.linalg.LinAlgError:
            step = np.stack([
                np.linalg.lstsq(J[k], -F[k], rcond=None)[0]
                for k in range(pts.shape[0])])
        # Trust region: cap each step at 5% of the box per iteration.
        cap = 0.05 * (hi - lo)
        step = np.clip(step, -cap, cap)
        pts = np.clip(pts + step, lo, hi)
    F, _ = fg_fn(pts)
    return pts, F


def _dedupe(points: np.ndarray, resid: np.ndarray, domain: np.ndarray,
            separation: float) -> np.ndarray:
    """Merge clustered candidates, keeping each cluster's smallest
    residual.  Returns indices into ``points``."""
    if points.shape[0] == 0:
        return np.zeros(0, dtype=int)
    width = domain[:, 1] - domain[:, 0]
    order = np.argsort(resid)
    kept: List[int] = []
    for i in order:
        dup = any(
            np.all(np.abs(points[i] - points[j]) <= separation * width)
            for j in kept)
        if not dup:
            kept.append(int(i))
    return np.array(sorted(kept), dtype=int)


def _hessian_specs(d: int) -> Tuple[List[Tuple[int, ...]],
                                    List[Tuple[int, int]]]:
    specs: List[Tuple[int, ...]] = []
    pairs: List[Tuple[int, int]] = []
    for i in range(d):
        for j in range(i, d):
            o = [0] * d
            o[i] += 1
            o[j] += 1
            specs.append(tuple(o))
            pairs.append((i, j))
    return specs, pairs


def _grad_specs(d: int) -> List[Tuple[int, ...]]:
    return [tuple(1 if j == i else 0 for j in range(d)) for i in range(d)]


def critical_points_dense(model, *, fixed=None, grad_tol: float = 1e-8,
                          delta: float = 5e-3, max_boxes: int = 50000,
                          separation: float = 1e-6,
                          ) -> List[CriticalPoint]:
    """All interior stationary points of a dense interpolant: isolate
    boxes where every partial's enclosure straddles zero, Newton-polish
    the survivors through one fused batch-x-multi-spec evaluation per
    iteration, then classify by Hessian eigenvalues."""
    ndim = model.num_dimensions
    fixed = validate_global_args(ndim, fixed, model.domain)
    target = model.slice(sorted(fixed.items())) if fixed else model
    free_dims = [d for d in range(ndim) if d not in fixed]

    m = target.num_dimensions
    domain = np.asarray(target.domain, dtype=np.float64)
    width = domain[:, 1] - domain[:, 0]

    if m == 1:
        values, _, _, diff = target._host_1d()
        xs = roots_1d(diff @ values, target.domain[0])
        out: List[CriticalPoint] = []
        for x in xs:
            val = float(target.vectorized_eval([x], [0]))
            d2 = float(target.vectorized_eval([x], [2]))
            scale = max(abs(d2), 1.0)
            kind = ("minimum" if d2 > 1e-7 * scale else
                    "maximum" if d2 < -1e-7 * scale else "degenerate")
            out.append(CriticalPoint(
                _fill_point(ndim, free_dims, np.array([x]), fixed),
                val, kind))
        return sorted(out, key=lambda c: c.value)

    # Gradient components as coefficient tensors (chain rule: physical
    # derivative tensors via the model's own diff matrices).
    grad_coeffs = [
        dense_coeff_tensor(target.differentiate(spec).tensor_values)
        for spec in _grad_specs(m)]
    cands_local = isolate_common_zeros(grad_coeffs, delta=delta,
                                       max_boxes=max_boxes)
    if cands_local.shape[0] == 0:
        return []
    cands = domain[:, 0] + (cands_local + 1.0) * 0.5 * width

    gspecs = _grad_specs(m)
    hspecs, pairs = _hessian_specs(m)

    def fg(pts):
        flat = np.asarray(target.vectorized_eval_batch_multi(
            pts, gspecs + hspecs), dtype=np.float64)
        F = flat[:, :m]
        H = np.zeros((pts.shape[0], m, m))
        for col, (i, j) in enumerate(pairs):
            H[:, i, j] = flat[:, m + col]
            H[:, j, i] = flat[:, m + col]
        return F, H

    pts, F = _newton_polish(cands, domain, fg, grad_tol)
    resid = np.abs(F).max(axis=1)
    ok = resid <= grad_tol
    pts, resid = pts[ok], resid[ok]
    keep = _dedupe(pts, resid, domain, separation)
    pts = pts[keep]

    out = []
    if pts.shape[0]:
        vals = np.asarray(_value_batch_fn(target)(pts),
                          dtype=np.float64).reshape(-1)
        _, H = fg(pts)
        for k in range(pts.shape[0]):
            eig = np.linalg.eigvalsh(H[k])
            scale = max(np.abs(eig).max(), 1.0)
            lam = 1e-7 * scale
            if (eig > lam).all():
                kind = "minimum"
            elif (eig < -lam).all():
                kind = "maximum"
            elif (np.abs(eig) > lam).all():
                kind = "saddle"
            else:
                kind = "degenerate"
            out.append(CriticalPoint(
                _fill_point(ndim, free_dims, pts[k], fixed),
                float(vals[k]), kind))
    return sorted(out, key=lambda c: c.value)


def critical_points_spline(spline, *, fixed=None, grad_tol: float = 1e-8,
                           delta: float = 5e-3, max_boxes: int = 50000,
                           separation: float = 1e-6,
                           ) -> List[CriticalPoint]:
    """Stationary points of a spline: the union over pieces of each
    piece's interior stationary points (one-sided at piece boundaries —
    a kink minimum where no piece has zero gradient is by definition
    not a stationary point; use the global ``minimize()`` for extrema).
    Duplicates on shared piece faces merge in the final dedupe."""
    ndim = spline.num_dimensions
    fixed = validate_global_args(ndim, fixed, spline.domain)
    target = spline.slice(sorted(fixed.items())) if fixed else spline

    found: List[CriticalPoint] = []
    for piece in target._pieces:
        found.extend(critical_points_dense(
            piece, grad_tol=grad_tol, delta=delta, max_boxes=max_boxes,
            separation=separation))
    if not found:
        return []
    pts = np.stack([c.point for c in found])
    resid = np.arange(pts.shape[0], dtype=np.float64)  # keep first-found
    domain = np.asarray(target.domain, dtype=np.float64)
    keep = _dedupe(pts, resid, domain, separation)
    free_dims = [d for d in range(ndim) if d not in fixed]
    out = []
    for i in keep:
        c = found[int(i)]
        out.append(CriticalPoint(
            _fill_point(ndim, free_dims, c.point, fixed), c.value, c.kind))
    return sorted(out, key=lambda c: c.value)


def _combine_kinds(kinds: Sequence[str]) -> str:
    """Classification of a block-diagonal Hessian from its blocks'
    kinds (the eigenvalue set is the union of the blocks')."""
    if "degenerate" in kinds:
        return "degenerate"
    if all(k == "minimum" for k in kinds):
        return "minimum"
    if all(k == "maximum" for k in kinds):
        return "maximum"
    return "saddle"


def critical_points_slider(slider, *, fixed=None, grad_tol: float = 1e-8,
                           delta: float = 5e-3, max_boxes: int = 50000,
                           separation: float = 1e-6,
                           max_points: int = 10000,
                           ) -> List[CriticalPoint]:
    """Stationary points of an additive slider — EXACT by structure:
    the gradient vanishes iff every slide's gradient vanishes on its
    own group, so the critical set is the cartesian product of per-slide
    critical sets, and the block-diagonal Hessian classifies from the
    per-slide kinds.  Beyond reference (and beyond its roadmap, which
    only assigns N-D rootfinding to the dense and spline classes)."""
    import itertools

    ndim = slider.num_dimensions
    fixed = validate_global_args(ndim, fixed, slider.domain)

    pivot = float(slider.pivot_value)
    factors = []   # per group: list of (dims, coords, value, kind|None)
    for group, slide in zip(slider.partition, slider.slides):
        group = list(group)
        local_fixed = {i: fixed[d] for i, d in enumerate(group)
                       if d in fixed}
        if len(local_fixed) == len(group):
            pt = [local_fixed[i] for i in range(len(group))]
            val = float(slide.vectorized_eval(pt, [0] * len(group)))
            factors.append([(group, np.asarray(pt, dtype=np.float64),
                             val, None)])
            continue
        local = {i: v for i, v in local_fixed.items()}
        cps = critical_points_dense(
            slide, fixed=local or None, grad_tol=grad_tol, delta=delta,
            max_boxes=max_boxes, separation=separation)
        if not cps:
            # One group with no interior stationary point means the
            # full gradient never vanishes.
            return []
        factors.append([(group, cp.point, cp.value, cp.kind)
                        for cp in cps])

    count = 1
    for f in factors:
        count *= len(f)
    if count > max_points:
        raise ValueError(
            f"the slider's critical set is the product of per-group "
            f"sets: {count} points exceeds max_points={max_points} — "
            "raise max_points or pin dims via fixed")

    out: List[CriticalPoint] = []
    for combo in itertools.product(*factors):
        point = np.empty(ndim)
        value = pivot
        kinds = []
        for group, coords, val, kind in combo:
            point[np.asarray(group, dtype=np.intp)] = coords
            value += val - pivot
            if kind is not None:
                kinds.append(kind)
        out.append(CriticalPoint(point, value, _combine_kinds(kinds)))
    return sorted(out, key=lambda c: c.value)


def critical_points_tt(tt, *, fixed=None, grad_tol: float = 1e-8,
                       delta: float = 5e-3, max_boxes: int = 50000,
                       separation: float = 1e-6) -> List[CriticalPoint]:
    """Stationary points of a TT: interval-transfer-chain isolation on
    the d analytic gradient TTs (no n^d materialization), then Newton
    polish with gradient/Hessian TTs evaluated through the shared batch
    kernel, then Hessian classification.  Beyond reference (and beyond
    its roadmap)."""
    ndim = tt.num_dimensions
    fixed = validate_global_args(ndim, fixed, tt._user_frame_domain())
    target = tt.slice(sorted(fixed.items())) if fixed else tt
    free_dims = [d for d in range(ndim) if d not in fixed]

    m = target.num_dimensions
    dom_user = np.asarray(target._user_frame_domain(), dtype=np.float64)

    def grad_spec(i):
        return tuple(1 if j == i else 0 for j in range(m))

    grads = [target.differentiate(grad_spec(i)) for i in range(m)]

    if m == 1:
        xs = roots_1d(np.asarray(grads[0].to_dense(), dtype=np.float64),
                      tuple(dom_user[0]))
        out: List[CriticalPoint] = []
        for x in xs:
            val = float(_value_batch_fn(target)(np.array([[x]]))[0])
            d2 = float(np.asarray(grads[0].vectorized_eval_batch(
                np.array([[x]]), [1]))[0])
            scale = max(abs(d2), 1.0)
            kind = ("minimum" if d2 > 1e-7 * scale else
                    "maximum" if d2 < -1e-7 * scale else "degenerate")
            out.append(CriticalPoint(
                _fill_point(ndim, free_dims, np.array([x]), fixed),
                val, kind))
        return sorted(out, key=lambda c: c.value)

    # Storage-frame isolation: every gradient TT shares target's
    # dim order.
    order = list(target._dim_order)
    dom_s = np.asarray(target.domain, dtype=np.float64)
    core_lists = [[np.asarray(c, dtype=np.float64)
                   for c in g._coeff_cores] for g in grads]
    cands_s = isolate_common_zeros_tt(core_lists, delta=delta,
                                      max_boxes=max_boxes)
    if cands_s.shape[0] == 0:
        return []
    phys_s = dom_s[:, 0] + (cands_s + 1.0) * 0.5 * (dom_s[:, 1]
                                                    - dom_s[:, 0])
    cands = np.empty_like(phys_s)
    for k, d in enumerate(order):
        cands[:, d] = phys_s[:, k]

    hessians = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i, m):
            hessians[i][j] = grads[i].differentiate(grad_spec(j))

    zero_m = [0] * m

    def fg(pts):
        F = np.stack([np.asarray(g.vectorized_eval_batch(pts, zero_m),
                                 dtype=np.float64).reshape(-1)
                      for g in grads], axis=1)
        H = np.zeros((pts.shape[0], m, m))
        for i in range(m):
            for j in range(i, m):
                h = np.asarray(hessians[i][j].vectorized_eval_batch(
                    pts, zero_m), dtype=np.float64).reshape(-1)
                H[:, i, j] = h
                H[:, j, i] = h
        return F, H

    pts, F = _newton_polish(cands, dom_user, fg, grad_tol)
    resid = np.abs(F).max(axis=1)
    ok = resid <= grad_tol
    pts, resid = pts[ok], resid[ok]
    keep = _dedupe(pts, resid, dom_user, separation)
    pts = pts[keep]

    out = []
    if pts.shape[0]:
        vals = np.asarray(_value_batch_fn(target)(pts),
                          dtype=np.float64).reshape(-1)
        _, H = fg(pts)
        for k in range(pts.shape[0]):
            eig = np.linalg.eigvalsh(H[k])
            scale = max(np.abs(eig).max(), 1.0)
            lam = 1e-7 * scale
            if (eig > lam).all():
                kind = "minimum"
            elif (eig < -lam).all():
                kind = "maximum"
            elif (np.abs(eig) > lam).all():
                kind = "saddle"
            else:
                kind = "degenerate"
            out.append(CriticalPoint(
                _fill_point(ndim, free_dims, pts[k], fixed),
                float(vals[k]), kind))
    return sorted(out, key=lambda c: c.value)


def solve_system(models: Sequence, *, tol: float = 1e-9,
                 delta: float = 5e-3, max_boxes: int = 50000,
                 separation: float = 1e-6) -> np.ndarray:
    """All isolated common zeros of ``d`` dense interpolants in ``d``
    dims over their shared domain — the use case the reference roadmap
    assigns to Moller-Stetter colleague matrices, solved here by
    subdivision pruning plus batched Newton (reference ``docs/roadmap.md``
    v0.21; no released counterpart).

    Returns a (K, d) array sorted lexicographically.  Raises if the
    models disagree on dimension/domain or the zero set is not isolated
    points.
    """
    models = list(models)
    if not models:
        raise ValueError("solve_system needs at least one interpolant")
    d = models[0].num_dimensions
    if len(models) != d:
        raise ValueError(
            f"solve_system needs exactly as many equations as dims: got "
            f"{len(models)} interpolants of dimension {d}")
    domain = np.asarray(models[0].domain, dtype=np.float64)
    for f in models[1:]:
        if f.num_dimensions != d or not np.allclose(
                np.asarray(f.domain, dtype=np.float64), domain):
            raise ValueError(
                "all interpolants must share one dimension count and "
                "domain")
    for f in models:
        if f.tensor_values is None:
            raise RuntimeError("Call build() first")

    coeffs = [dense_coeff_tensor(f.tensor_values) for f in models]
    cands_local = isolate_common_zeros(coeffs, delta=delta,
                                       max_boxes=max_boxes)
    if cands_local.shape[0] == 0:
        return np.zeros((0, d))
    width = domain[:, 1] - domain[:, 0]
    cands = domain[:, 0] + (cands_local + 1.0) * 0.5 * width

    gspecs = _grad_specs(d)
    value_spec = tuple([0] * d)

    def fg(pts):
        F = np.empty((pts.shape[0], d))
        J = np.empty((pts.shape[0], d, d))
        for i, f in enumerate(models):
            flat = np.asarray(f.vectorized_eval_batch_multi(
                pts, [value_spec] + gspecs), dtype=np.float64)
            F[:, i] = flat[:, 0]
            J[:, i, :] = flat[:, 1:]
        return F, J

    pts, F = _newton_polish(cands, domain, fg, tol)
    resid = np.abs(F).max(axis=1)
    ok = resid <= tol
    pts, resid = pts[ok], resid[ok]
    keep = _dedupe(pts, resid, domain, separation)
    pts = pts[keep]
    if pts.shape[0] == 0:
        return np.zeros((0, d))
    return pts[np.lexsort(pts.T[::-1])]

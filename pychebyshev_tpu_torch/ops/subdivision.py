"""Coefficient-space subdivision: certified global optimization and
zero isolation for Chebyshev interpolants, on PyTorch.

The port of ``pychebyshev_tpu.ops.subdivision``.  Instead of the
Moller-Stetter eigenproblem (dense nonsymmetric eigensolves of size
``n^d``), it runs **branch-and-bound in Chebyshev coefficient space**:

- An interpolant IS a polynomial, so its restriction to any sub-box is
  the same-degree polynomial re-expanded in the sub-box's Chebyshev
  basis.  That re-expansion is one exact ``(n, n)`` matrix per dim per
  box (built by resampling the basis — no quadrature error), and
  applying it to the coefficient tensor is a batch of small GEMMs.
- On each sub-box the Chebyshev enclosure ``|f - c_0| <= sum_{k!=0}
  |c_k|`` gives rigorous-to-roundoff lower/upper bounds (``|T_k| <= 1``),
  so boxes that cannot contain the optimum (or a zero of every system
  component) are *proved* away, not heuristically discarded.

The search itself (priority queues, pruning, anchoring, the TT bounder
and both zero isolators) is host NumPy, the reference's code unchanged:
its control flow is data-dependent and its per-box bookkeeping small.
The one heavy step, the per-round box statistics of a large dense
coefficient tensor (restriction chain, |c| mass, axis profiles, centre
and corner values), runs as batched f64 GEMMs in PyTorch on the model's
``device`` once the tensor holds ``_DEVICE_STATS_MIN_SIZE`` elements
(``_CPU_STATS_MIN_SIZE`` where the device is the CPU); smaller tensors,
every call with ``device=None`` and both zero isolators take the NumPy
route, which is bitwise the reference's.

Certification caveat: bounds are exact mathematics evaluated in f64
(not outward-rounded interval arithmetic), so certificates hold up to
O(n_total * eps * |c|) roundoff — ~1e-13 relative in practice.  Don't
request ``tol`` below that.
"""

from __future__ import annotations

import functools
import heapq
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pychebyshev_tpu_torch.ops.chebyshev import _chebpts1_np
from pychebyshev_tpu_torch.ops.dct import _coeff_matrix_np

__all__ = [
    "restriction_matrix",
    "restrict_box_coeffs",
    "box_enclosure",
    "center_values",
    "minimize_coeff_tensor",
    "minimize_tt_cores",
    "isolate_common_zeros",
    "isolate_common_zeros_tt",
    "GlobalResult",
]


class GlobalResult(NamedTuple):
    """Outcome of a branch-and-bound run (local [-1,1]^d coordinates)."""

    value: float          # best exact interpolant value found
    location: np.ndarray  # (d,) local coordinates of that value
    gap: float            # value - (proved lower bound); <= tol if certified
    certified: bool       # True when the search closed the gap to tol
    boxes: int            # number of boxes processed


# ----------------------------------------------------------------------
# Exact sub-interval re-expansion
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=4096)
def _restriction_matrix_cached(n: int, lo: float, hi: float) -> np.ndarray:
    if lo == hi:
        # Point restriction: the "sub-interval" basis is the constant
        # f(lo) — row 0 evaluates the parent basis at lo, the rest is 0.
        out = np.zeros((n, n))
        out[0] = np.polynomial.chebyshev.chebvander(
            np.array([lo]), n - 1)[0]
        return out
    mid = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo)
    t = _chebpts1_np(n)                       # local nodes of the sub-box
    u = np.clip(mid + half * t, -1.0, 1.0)    # their parent coordinates
    vander = np.polynomial.chebyshev.chebvander(u, n - 1)  # T_k(u)
    return np.ascontiguousarray(_coeff_matrix_np(n) @ vander)


def restriction_matrix(n: int, lo: float, hi: float) -> np.ndarray:
    """(n, n) map: coefficients on [-1, 1] -> coefficients of the same
    polynomial re-expanded on the sub-interval ``[lo, hi]`` (in that
    sub-interval's own Chebyshev basis).

    Exact by the resampling argument: a degree-(n-1) polynomial is
    recovered exactly from its values at n Type-I points, so composing
    "evaluate parent basis at the sub-box nodes" with the values->
    coefficients transform reproduces the restriction with no
    truncation.  ``lo == hi`` gives the point restriction (coefficients
    of the constant f(lo) — what a monotonicity collapse produces).
    Bisection produces dyadic endpoints, so the cache hits constantly
    during a search.
    """
    if not (-1.0 <= lo <= hi <= 1.0):
        raise ValueError(f"sub-interval [{lo}, {hi}] not inside [-1, 1]")
    return _restriction_matrix_cached(int(n), float(lo), float(hi))


def restrict_box_coeffs(coeffs: np.ndarray,
                        boxes: np.ndarray) -> np.ndarray:
    """Re-expand one coefficient tensor on a batch of sub-boxes.

    coeffs: (n_1, ..., n_d) parent coefficients on [-1, 1]^d, or
            (B, n_1, ..., n_d) per-box tensors (e.g. to re-restrict
            after a monotonicity collapse).
    boxes:  (B, d, 2) local sub-boxes.
    Returns (B, n_1, ..., n_d) per-box coefficient tensors.

    Each dim is one BLAS-batched mode product with that dim's per-box
    restriction matrix; dims whose interval is the full [-1, 1] are
    skipped (identity).
    """
    boxes = np.asarray(boxes, dtype=np.float64)
    bsz, d = boxes.shape[0], boxes.shape[1]
    if coeffs.ndim == d:
        out = np.broadcast_to(coeffs, (bsz,) + coeffs.shape).copy()
    elif coeffs.ndim == d + 1 and coeffs.shape[0] == bsz:
        # Always copy: the mode products below write in place, and the
        # caller's per-box tensors must survive the call.
        out = np.array(coeffs, dtype=np.float64, order="C")
    else:
        raise ValueError(
            f"coeffs shape {coeffs.shape} does not match boxes "
            f"({bsz}, {d}, 2)")
    shape = out.shape
    for axis in range(d):
        pairs = boxes[:, axis, :]
        full_rows = (pairs[:, 0] == -1.0) & (pairs[:, 1] == 1.0)
        if full_rows.all():
            continue
        # Contiguous (B, pre, n, post) view: matmul contracts the node
        # mode in place with NO transposes or layout copies.
        n = shape[axis + 1]
        pre = int(np.prod(shape[1:axis + 1], dtype=np.int64))
        post = int(np.prod(shape[axis + 2:], dtype=np.int64))
        x = out.reshape(bsz, pre, n, post)
        # Bisection reuses the same dyadic intervals across many boxes:
        # group by distinct interval so each group is ONE batched GEMM.
        uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
        for u, (lo, hi) in enumerate(uniq):
            if lo == -1.0 and hi == 1.0:
                continue
            mask = inv == u
            mat = restriction_matrix(n, lo, hi)
            x[mask] = np.matmul(mat, x[mask])
    return out


# ----------------------------------------------------------------------
# Enclosures from coefficients
# ----------------------------------------------------------------------

def box_enclosure(coeffs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(c0, radius) per box: f(box) is contained in [c0 - r, c0 + r].

    coeffs: (B, n_1, ..., n_d).  Uses |T_k| <= 1 on [-1, 1]:
    ``r = sum_{k != 0} |c_k|``.
    """
    flat = coeffs.reshape(coeffs.shape[0], -1)
    c0 = flat[:, 0]
    rad = np.abs(flat).sum(axis=1) - np.abs(c0)
    return c0, rad


@functools.lru_cache(maxsize=256)
def _t_at_zero(n: int) -> np.ndarray:
    """T_k(0) for k < n: the pattern 1, 0, -1, 0, 1, ..."""
    k = np.arange(n)
    out = np.where(k % 2 == 0, np.where(k % 4 == 0, 1.0, -1.0), 0.0)
    return out


def center_values(coeffs: np.ndarray) -> np.ndarray:
    """Exact interpolant value at each box's center, from coefficients."""
    out = coeffs
    for _ in range(coeffs.ndim - 1):
        out = out @ _t_at_zero(out.shape[-1])
    return out


@functools.lru_cache(maxsize=256)
def _coeff_diff_matrix(n: int) -> np.ndarray:
    """(n, n) Chebyshev-coefficient differentiation operator: maps the
    coefficients of p to those of p' on the SAME [-1, 1] interval
    (the physical 2/width chain factor is a positive constant, so sign
    tests — all the monotonicity reduction needs — can skip it)."""
    out = np.zeros((n, n))
    for k in range(1, n):
        # T_k' = 2k * sum_{j<k, j+k odd} T_j / (2 - delta_{j0})
        for j in range(k - 1, -1, -2):
            out[j, k] = 2.0 * k if j > 0 else float(k)
    return out


@functools.lru_cache(maxsize=256)
def _corner_eval_matrix(n: int) -> np.ndarray:
    """(2, n): T_k(-1) = (-1)^k on row 0, T_k(+1) = 1 on row 1."""
    k = np.arange(n)
    return np.stack([(-1.0) ** k, np.ones(n)])


def corner_values(coeffs: np.ndarray) -> np.ndarray:
    """Exact interpolant values at every box corner: (B, n_1..n_d) ->
    (B, 2, ..., 2) (index 0 = the dim's lower face, 1 = upper)."""
    out = np.ascontiguousarray(coeffs)
    for axis in range(1, coeffs.ndim):
        shape = out.shape
        n = shape[axis]
        pre = int(np.prod(shape[:axis], dtype=np.int64))
        post = int(np.prod(shape[axis + 1:], dtype=np.int64))
        out = np.matmul(_corner_eval_matrix(n),
                        out.reshape(pre, n, post)).reshape(
            shape[:axis] + (2,) + shape[axis + 1:])
    return out


def _tail_mass_per_dim(coeffs: np.ndarray) -> np.ndarray:
    """(B, d) sum of |c_k| over multi-indices with k_dim > 0 — how much
    the restricted polynomial still varies along each dim."""
    bsz = coeffs.shape[0]
    d = coeffs.ndim - 1
    total = np.abs(coeffs).reshape(bsz, -1).sum(axis=1)
    out = np.empty((bsz, d))
    for axis in range(d):
        zero_slice = np.take(np.abs(coeffs), 0, axis=axis + 1)
        out[:, axis] = total - zero_slice.reshape(bsz, -1).sum(axis=1)
    return out


def _split_boxes(boxes: np.ndarray, dims: np.ndarray) -> np.ndarray:
    """Bisect each box along its chosen dim -> (2B, d, 2)."""
    bsz, d = boxes.shape[0], boxes.shape[1]
    left = boxes.copy()
    right = boxes.copy()
    rows = np.arange(bsz)
    mids = 0.5 * (boxes[rows, dims, 0] + boxes[rows, dims, 1])
    left[rows, dims, 1] = mids
    right[rows, dims, 0] = mids
    return np.concatenate([left, right], axis=0)


# ----------------------------------------------------------------------
# Branch-and-bound global minimization
# ----------------------------------------------------------------------

# Boxes narrower than this in every dim are retired instead of split
# further: their remaining bound width is pure enclosure looseness, not
# location uncertainty, and splitting a zero-width interval is
# meaningless in f64.
_MIN_BOX_WIDTH = 1e-12


def _bnb_minimize(d: int, evaluate_boxes, *, tol: float, max_boxes: int,
                  beam: int, seed_value: float,
                  seed_loc: np.ndarray) -> GlobalResult:
    """Best-first branch-and-bound loop shared by the dense and TT
    bounders.

    ``evaluate_boxes(boxes, aux)`` maps a (B, d, 2) batch of local
    sub-boxes plus a length-B list of opaque per-box payloads (parent's
    payload for split children; ``None`` for the root) to
    ``(boxes, lb, cand_val, cand_loc, split_dim, aux_out)``:

    - ``boxes``: the boxes, possibly NARROWED in place (a monotonicity
      collapse pins a dim to one face when the gradient's enclosure has
      a fixed sign there — the minimum over the original box provably
      lies on that face, so bounds on the narrowed box bound the
      original) or REBASED into a new frame the payload describes (the
      dense bounder's anchor promotion);
    - ``lb``: a proved lower bound on each (narrowed) box;
    - ``cand_val`` / ``cand_loc``: an ATTAINED-or-overestimating value
      the bounder saw in the box and its ROOT-frame local coords
      (anchored evaluations add their rigorous anchor error, keeping
      the incumbent a valid upper bound on the true minimum);
    - ``split_dim``: the bisection dim, or -1 when nothing is left to
      split (the box is then retired, its lb folded into the gap);
    - ``aux_out``: the payload to carry on each returned box.

    Children re-derive from their anchor representation (exact
    restriction; anchor chains carry explicit rigorous error bounds
    folded into ``lb``/``cand_val``), so the returned ``value`` upper-
    bounds an attained value and ``gap`` bounds its distance from the
    true minimum.
    """
    tol = float(tol)
    if tol <= 0.0:
        raise ValueError(f"tol must be positive, got {tol}")

    best = float(seed_value)
    best_loc = np.asarray(seed_loc, dtype=np.float64).copy()

    def take_incumbent(cand_val, cand_loc):
        nonlocal best, best_loc
        imin = int(np.argmin(cand_val))
        if cand_val[imin] < best:
            best = float(cand_val[imin])
            best_loc = cand_loc[imin].copy()

    root = np.tile(np.array([[-1.0, 1.0]]), (d, 1))[None]
    boxes, lb, cand_val, cand_loc, split_dim, aux = evaluate_boxes(
        root, [None])
    take_incumbent(cand_val, cand_loc)
    # Heap of (lower_bound, counter, box, split_dim, payload).
    heap: List[Tuple[float, int, np.ndarray, int, object]] = []
    counter = 0
    retired_lb = np.inf  # best-possible value inside retired boxes
    lb0 = float(lb[0])
    if lb0 < best - tol:
        if split_dim[0] < 0:
            retired_lb = lb0
        else:
            heapq.heappush(heap, (lb0, counter, boxes[0],
                                  int(split_dim[0]), aux[0]))
            counter += 1

    processed = 1
    proved_lb = lb0
    while heap and processed < max_boxes:
        # The heap min is the global proved lower bound over open boxes.
        proved_lb = heap[0][0]
        if proved_lb >= best - tol:
            lb_all = min(proved_lb, retired_lb)
            return GlobalResult(best, best_loc, max(best - lb_all, 0.0),
                                lb_all >= best - tol, processed)
        batch, dims, payloads = [], [], []
        while heap and len(batch) < beam:
            box_lb, _, box, sd, pl = heapq.heappop(heap)
            if box_lb >= best - tol:
                continue
            batch.append(box)
            dims.append(sd)
            payloads.append(pl)
        if not batch:
            continue
        children = _split_boxes(np.stack(batch), np.asarray(dims))
        boxes, lbs, cand_val, cand_loc, split_dim, aux = evaluate_boxes(
            children, payloads + payloads)
        processed += children.shape[0]
        take_incumbent(cand_val, cand_loc)
        for i in np.argsort(lbs):
            if lbs[i] < best - tol:
                if split_dim[i] < 0:
                    retired_lb = min(retired_lb, float(lbs[i]))
                else:
                    heapq.heappush(heap, (float(lbs[i]), counter,
                                          boxes[i], int(split_dim[i]),
                                          aux[i]))
                    counter += 1

    if heap:
        proved_lb = min(proved_lb, heap[0][0], retired_lb)
        return GlobalResult(best, best_loc, max(best - proved_lb, 0.0),
                            False, processed)
    lb_all = min(proved_lb, retired_lb)
    if retired_lb < best - tol:
        return GlobalResult(best, best_loc, max(best - lb_all, 0.0),
                            False, processed)
    return GlobalResult(best, best_loc, min(tol, max(best - lb_all, 0.0)),
                        True, processed)


def truncate_coeff_tensor(coeffs: np.ndarray, budget: float
                          ) -> Tuple[np.ndarray, float]:
    """Crop trailing coefficient slices while the dropped |c| mass fits
    in ``budget``.  Returns (cropped tensor, dropped mass).

    Rigorous: |p - p_cropped| <= dropped everywhere on [-1, 1]^d
    (each dropped coefficient contributes at most |c_k|), so a search
    on the cropped tensor certifies the original up to ``dropped``.
    Smooth builds drop most of their n^d coefficients at any realistic
    tolerance — the single biggest cost lever for the subdivision
    search, whose per-box work is proportional to the tensor size.
    """
    out = coeffs
    dropped = 0.0
    if budget <= 0.0:
        return out, dropped
    for axis in range(out.ndim):
        mass = np.abs(out)
        other = tuple(i for i in range(out.ndim) if i != axis)
        if other:
            mass = mass.sum(axis=other)
        keep = out.shape[axis]
        while keep > 2 and dropped + mass[keep - 1] <= budget:
            dropped += float(mass[keep - 1])
            keep -= 1
        if keep < out.shape[axis]:
            out = np.ascontiguousarray(
                np.take(out, np.arange(keep), axis=axis))
    return out, dropped


def eval_coeff_tensor_at(coeffs: np.ndarray, loc: np.ndarray) -> float:
    """Exact value of the polynomial at one local point."""
    v = coeffs
    for x in np.asarray(loc, dtype=np.float64):
        v = np.tensordot(
            np.polynomial.chebyshev.chebvander(
                np.array([x]), v.shape[0] - 1)[0],
            v, axes=([0], [0]))
    return float(v)


def _choose_split_dims(boxes: np.ndarray, score: np.ndarray,
                       scale: Optional[np.ndarray] = None) -> np.ndarray:
    """Bisection dim per box from (tail score x width); -1 when every
    dim is at the width floor (nothing left to split).  ``scale`` maps
    local widths to root-frame widths (anchored frames), so the width
    floor stays an absolute root-frame quantity."""
    widths = boxes[:, :, 1] - boxes[:, :, 0]
    if scale is not None:
        widths = widths * scale
    ranked = np.where(widths > _MIN_BOX_WIDTH,
                      score * widths + widths * 1e-300, -np.inf)
    dims = np.argmax(ranked, axis=1)
    dims[~np.isfinite(ranked.max(axis=1))] = -1
    return dims


def _best_exact_in_box(cen: np.ndarray, corners: np.ndarray,
                       boxes: np.ndarray):
    """Cheapest exact candidates per box: its center and all 2^d
    corners (both precomputed).  Returns (values (B,), local
    locations (B, d))."""
    bsz, d = boxes.shape[0], boxes.shape[1]
    ci = np.argmin(corners, axis=1)
    cvals = corners[np.arange(bsz), ci]
    # Decode corner index bits -> lo/hi face per dim.
    bits = (ci[:, None] >> np.arange(d - 1, -1, -1)[None, :]) & 1
    clocs = np.where(bits == 0, boxes[:, :, 0], boxes[:, :, 1])
    mids = 0.5 * (boxes[:, :, 0] + boxes[:, :, 1])
    use_center = cen < cvals
    return (np.where(use_center, cen, cvals),
            np.where(use_center[:, None], mids, clocs))


# From this coefficient-tensor size on, per-round bound evaluation of a
# search on a CUDA device runs as batched f64 GEMMs and reductions in
# PyTorch on the card instead of NumPy passes on the host, which are
# memory-bound on temporaries.  Smaller tensors stay on NumPy, where a
# round's launches, transfers and anchor copies cost more than its
# arithmetic.  Set by chip_smoke.py on an H100 80GB HBM3 (700 W), four
# runs.  Phase 42, the main path's whole-box and K-pinned minima end to
# end (medians of two repeats, per run): 7.10 / 7.19 / 7.55 / 8.91 s at
# a threshold of 729, 7.70 / 7.37 / 6.57 / 8.37 at 2,401, 7.04 / 6.48 /
# 6.12 / 8.74 at 6,561 and 9.02 / 8.64 / 8.95 / 11.72 at 20,000, where
# the K-pinned 11^4 search goes to NumPy (0.15-0.27 s becomes 1.84-2.51
# s).  6,561 is the fastest in three runs of four; 729 to 6,561 differ
# by less than a run's repeats do (up to 1.97 s).  Phase 39, ms per
# call: the card wins from 7^4 = 2,401 on at 512 boxes, at 16 boxes in
# most runs but not all, and loses at 9^3 x 16.
_DEVICE_STATS_MIN_SIZE = 6561

# The same switch for a search whose device is the CPU: PyTorch on the
# host against NumPy on the host, same machine, same runs.  Phase 42: a
# CPU build's K-pinned 11^4 search takes 0.34-0.50 s at 2,401 against
# 1.72-2.56 s at 20,000.  Phase 39, ms per call: PyTorch wins at 512
# boxes from 2,401 on in every reading but one single-call one (13^4,
# 621 vs 582 ms), at 16 boxes in most runs but not all.
_CPU_STATS_MIN_SIZE = 2401

# Boxes per PyTorch call: the restriction chain holds about three
# (B,) + shape f64 intermediates at once, so each is capped at 1 GiB
# (a 21^5 tensor is 33 MB a box, 32 boxes a call; 11^5 takes 512 boxes
# in one call).
_STATS_CHUNK_BYTES = 1 << 30


def _on_device(size: int, device) -> bool:
    """Whether a tensor of ``size`` elements takes the PyTorch route."""
    if device is None:
        return False
    if torch.device(device).type == "cpu":
        return size >= _CPU_STATS_MIN_SIZE
    return size >= _DEVICE_STATS_MIN_SIZE


@functools.lru_cache(maxsize=256)
def _device_consts(n: int, device: torch.device):
    """(T_k(0), the (2, n) corner rows) as f64 tensors on ``device``."""
    return (torch.tensor(_t_at_zero(n), dtype=torch.float64, device=device),
            torch.tensor(_corner_eval_matrix(n), dtype=torch.float64,
                         device=device))


def _box_stats_torch(coeffs: torch.Tensor, mats, bsz: int,
                     batched: bool) -> torch.Tensor:
    """The six statistics of :func:`_sub_raw_stats` for ``bsz``
    sub-boxes, in f64 where ``coeffs`` lies: restriction chain, |c|
    mass, axis mass profiles, axis fibers, center and corner values.

    ``coeffs`` is one shared tensor of ``shape`` (broadcast over the
    boxes) or, with ``batched``, per-box tensors ``(B,) + shape``;
    ``mats`` holds per dim a (B, n, n) restriction stack on the same
    device, or None where every box spans the dim's full interval.
    Returns one (B, K) tensor, so the host reads it in one transfer:
    c0, total, center, the 2^d corners, then each dim's mass profile,
    then each dim's fiber.
    """
    shape = tuple(coeffs.shape[1:]) if batched else tuple(coeffs.shape)
    d = len(shape)
    sub = coeffs if batched else coeffs.expand((bsz,) + shape)
    # Per-box restriction: a mode product per dim, as a movedim and one
    # batched GEMM (f64 on the tensor cores, through cuBLAS, on a card).
    for i, mat in enumerate(mats):
        if mat is None:
            continue
        moved = sub.movedim(i + 1, -1)                  # (B, lead..., n)
        lead = tuple(moved.shape[1:-1])
        prod = torch.bmm(moved.reshape(bsz, -1, shape[i]),
                         mat.transpose(1, 2))
        sub = prod.reshape((bsz,) + lead + (shape[i],)).movedim(-1, i + 1)
    a = sub.abs()
    masses = []
    fibers = []
    for i in range(d):
        other = tuple(ax + 1 for ax in range(d) if ax != i)
        masses.append(a.sum(dim=other) if other else a)
        fibers.append(sub[(slice(None),) + (0,) * i + (slice(None),)
                          + (0,) * (d - 1 - i)])
    total = masses[0].sum(dim=1)
    c0 = sub.reshape(bsz, -1)[:, 0]
    cen = sub
    cor = sub
    for i in range(d):
        t0, corner = _device_consts(shape[i], sub.device)
        cen = torch.tensordot(cen, t0, dims=([1], [0]))
        cor = torch.tensordot(cor, corner, dims=([i + 1], [1])).movedim(
            -1, i + 1)
    return torch.cat([c0[:, None], total[:, None], cen.reshape(bsz, 1),
                      cor.reshape(bsz, -1)] + masses + fibers, dim=1)


def _device_raw_stats(coeffs, boxes: np.ndarray, shape, batched: bool):
    """:func:`_sub_raw_stats`'s tuple (host NumPy) through
    :func:`_box_stats_torch`, ``_STATS_CHUNK_BYTES`` of boxes a call.
    ``coeffs``: the shared device tensor, or with ``batched`` a list of
    per-box device tensors (stacked one chunk at a time)."""
    d = len(shape)
    bsz = boxes.shape[0]
    step = max(1, _STATS_CHUNK_BYTES // (8 * int(np.prod(shape))))
    device = coeffs[0].device if batched else coeffs.device
    parts = []
    for s in range(0, bsz, step):
        bx = boxes[s:s + step]
        mats = [None if m is None else torch.from_numpy(m).to(device)
                for m in _restriction_mats(shape, bx)]
        cf = torch.stack(coeffs[s:s + step]) if batched else coeffs
        parts.append(_box_stats_torch(cf, mats, bx.shape[0], batched).cpu())
    out = torch.cat(parts).numpy()
    cuts = np.cumsum([1, 1, 1, 2 ** d] + list(shape) + list(shape))
    c0, total, cen, cor, *rest = np.split(out, cuts[:-1], axis=1)
    return (c0[:, 0], total[:, 0], cen[:, 0], cor, rest[:d], rest[d:])


def _sub_raw_stats(sub: np.ndarray):
    """(c0, total, centers, corners, axis masses, axis-0 fibers) from
    a (B, *shape) batch of restricted coefficient tensors (the NumPy
    route; :func:`_box_stats_torch` computes the same quantities)."""
    bsz = sub.shape[0]
    d = sub.ndim - 1
    a = np.abs(sub)
    masses = []
    fibers = []
    for i in range(d):
        other = tuple(ax + 1 for ax in range(d) if ax != i)
        masses.append(a.sum(axis=other))
        fibers.append(sub[(slice(None),) + (0,) * i + (slice(None),)
                          + (0,) * (d - 1 - i)])
    total = masses[0].sum(axis=1)
    c0 = sub.reshape(bsz, -1)[:, 0]
    return (c0, total, center_values(sub),
            corner_values(sub).reshape(bsz, -1), masses, fibers)


def _derivative_ranges(shape, masses, fibers):
    """Per-dim enclosures of d q / d local_i on each box WITHOUT
    materializing derivative tensors: the exact constant term is an
    O(n) fiber dot, and the variation is bounded by the
    |.|-triangle-inequality column weights of the coefficient
    differentiation operator applied to the axis mass profile."""
    d = len(shape)
    bsz = fibers[0].shape[0]
    lo = np.empty((bsz, d))
    hi = np.empty((bsz, d))
    for i in range(d):
        dm = _coeff_diff_matrix(shape[i])
        g0 = fibers[i] @ dm[0]
        full = masses[i] @ np.abs(dm).sum(axis=0)  # >= sum |c'_km|
        rest = np.maximum(full - np.abs(g0), 0.0)
        lo[:, i] = g0 - rest
        hi[:, i] = g0 + rest
    return lo, hi


def _assemble_bounds(shape, boxes, raw):
    """lb / candidates / tails / gradient ranges from raw stats — the
    ONE owner of the bound formulas (shared by the broadcast and
    batched-coeffs stats closures; a one-sided fix here cannot desync
    the two paths)."""
    c0, total, cen, cor, masses, fibers = raw
    lb = c0 - (total - np.abs(c0))
    tails = np.stack([total - m[:, 0] for m in masses], axis=1)
    cand_val, cand_loc = _best_exact_in_box(cen, cor, boxes)
    glo, ghi = _derivative_ranges(shape, masses, fibers)
    # Mean-value form: q >= q(center) - sum_i max|dq/d local_i| —
    # quadratically tighter than the coefficient enclosure on small
    # boxes, rigorous by the mean value theorem.
    mv_slack = np.maximum(np.abs(glo), np.abs(ghi)).sum(axis=1)
    lb = np.maximum(lb, cen - mv_slack)
    return lb, cand_val, cand_loc, tails, glo, ghi


def _restriction_mats(shape, boxes):
    """Per-box restriction matrices for the device stats: per dim a
    (B, n, n) stack, the exact identity on rows whose interval is the
    full [-1, 1] (the NumPy route skips those rows), or None where
    every row is."""
    mats = []
    for i, n in enumerate(shape):
        pairs = boxes[:, i, :]
        full = (pairs[:, 0] == -1.0) & (pairs[:, 1] == 1.0)
        mats.append(None if full.all() else np.stack([
            np.eye(n) if f else restriction_matrix(n, lo, hi)
            for f, (lo, hi) in zip(full, pairs)]))
    return mats


def _make_full_stats(work: np.ndarray, device=None):
    """Per-tensor bound machinery: ``full_stats(boxes) -> (lb,
    cand_val, cand_loc, tails, glo, ghi)`` for batches of local
    sub-boxes of ``work``'s cube.  Tensors at or over the device's
    threshold (:func:`_on_device`) route through the PyTorch stats on
    ``device`` (``work`` copied there once, kept as
    ``full_stats.resident``), small ones, and every tensor with
    ``device=None``, through NumPy."""
    shape = work.shape
    resident = (torch.as_tensor(np.ascontiguousarray(work),
                                dtype=torch.float64, device=device)
                if _on_device(work.size, device) else None)

    def _raw_stats(boxes):
        if resident is not None:
            return _device_raw_stats(resident, boxes, shape, False)
        return _sub_raw_stats(restrict_box_coeffs(work, boxes))

    def full_stats(boxes):
        return _assemble_bounds(shape, boxes, _raw_stats(boxes))

    full_stats.raw_stats = _raw_stats
    full_stats.resident = resident
    return full_stats


# Round-4 note, kept for the record (the port's isolators stay host
# NumPy for the same reason): routing isolation through the
# fused jitted stats WITHOUT anchors was measured and refuted (31^3
# numpy 2.0 s vs fused 4.9 s; 25^4 59.7 s vs 68.7 s) — the isolation
# beam never amortizes the jit overhead, and its per-box work is
# lighter than minimize's.  The round-5 anchored loop below wins by
# TENSOR SHRINKAGE instead (the lever that bought minimize 29x): all K
# component tensors re-anchor together, and each anchor's rigorous
# cumulative truncation bound folds into the zero-exclusion margin so
# no box containing a true common zero is ever discarded.  (Those
# times are the JAX package's, on a host CPU.)


def _make_batched_stats(shape: Tuple[int, ...], device=None):
    """:func:`_make_full_stats` for PER-BOX coefficient tensors.

    ``full_stats(boxes, coeffs)`` with ``coeffs`` a length-B list of
    ``shape`` tensors — the anchored search's mixed-anchor batches:
    boxes from many small anchors of one (menu-rounded) shape evaluate
    in ONE call instead of one fragmented call per anchor.  On the
    device route (``full_stats.on_device``) the list holds the anchors'
    resident device tensors, stacked there a chunk at a time; on the
    NumPy route, their host arrays.  Shares the raw-stats and
    bound-assembly formulas with the broadcast closure
    (:func:`_sub_raw_stats` / :func:`_assemble_bounds`).  Nothing is
    cached per shape: the closure is cheap, and its route is read from
    :func:`_on_device` when it is made."""
    on_device = _on_device(int(np.prod(shape)), device)

    def _raw_stats(boxes, coeffs):
        if on_device:
            return _device_raw_stats(coeffs, boxes, shape, True)
        return _sub_raw_stats(np.stack([
            restrict_box_coeffs(coeffs[b], boxes[b:b + 1])[0]
            for b in range(boxes.shape[0])]))

    def full_stats(boxes, coeffs):
        return _assemble_bounds(shape, boxes,
                                _raw_stats(boxes, coeffs))

    full_stats.on_device = on_device
    return full_stats


# --------------------------------------------------------------------------
# Hierarchical anchoring: multilevel re-truncation of the search tree.
#
# Round-3 profiling showed certified search on large tensors spends
# ~100% of wall time in the fused bound evaluator, whose per-box cost
# is the ROOT tensor size — every box re-restricts from the root for
# exactness.  But a restricted polynomial on a small box is much
# smoother than the root: most of its Chebyshev mass truncates away
# within a tiny budget.  Anchoring makes that a multilevel scheme:
# when a subtree's box has descended _ANCHOR_DEPTH levels from its
# anchor, its restricted tensor is materialized ONCE (host restriction
# from the parent anchor), re-truncated with a geometrically-shrinking
# rigorous budget (total over any chain <= tol/4), and becomes the new
# local root for the subtree — descendants then pay the truncated size
# instead of n^d.  All error is explicit: each anchor carries the
# cumulative |p_restricted - p_anchor| bound; box lower bounds subtract
# it, incumbent candidates add it, so every certificate remains
# rigorous end-to-end.  Measured on an oscillatory 21^5 tensor this is
# the difference between 626 s (uncertified at max_boxes) and seconds
# (scripts/bench_global_calculus.py).
# --------------------------------------------------------------------------

_ANCHOR_DEPTH = 2              # levels between re-anchoring attempts
_ANCHOR_MIN_SIZE = 20000       # don't anchor below this tensor size
_ANCHOR_SHRINK = 0.6           # promote only if <= this size fraction
_ANCHOR_BYTE_BUDGET = 1 << 28  # stop creating anchors past 256 MB
_PROMOTE_BYTES_PER_CALL = 1 << 28  # host-restriction work cap per call
# Shape menu for anchor tensors: rounding keeps jit bucket reuse high
# in the JAX package; here it decides the anchors' truncated shapes,
# and so which boxes the search visits, as it does there.
_ANCHOR_SHAPE_MENU = (2, 3, 4, 5, 6, 7, 8, 9, 11, 13, 15, 17, 21, 25,
                      31, 41, 51, 65, 81, 101, 129)


def _menu_ceil(n: int, cap: int) -> int:
    for m in _ANCHOR_SHAPE_MENU:
        if m >= n:
            return min(m, cap)
    return cap


class _Anchor(NamedTuple):
    tensor: np.ndarray   # truncated restricted coefficient tensor
    eps: float           # cumulative rigorous |q_root - q_anchor| bound
    mid: np.ndarray      # (d,) root-frame center of the anchor box
    half: np.ndarray     # (d,) root-frame half-widths
    chain: int           # anchors above this one (root = 0)


def _make_anchored_evaluator(work: np.ndarray, tol_q: float,
                             monotonicity: bool, device=None):
    """The dense bounder's ``evaluate_boxes(boxes, aux)`` with
    hierarchical anchoring; aux = (anchor_id, depth_since_anchor).
    Each anchor's stats closure holds its tensor on ``device`` where
    the device route takes it, copied there once, when it is made."""
    d = work.ndim
    anchors = {0: _Anchor(work, 0.0, np.zeros(d), np.ones(d), 0)}
    stats = {0: _make_full_stats(work, device)}
    anchor_bytes = [work.nbytes]
    next_id = [1]

    def _promote(aid: int, box: np.ndarray):
        parent = anchors[aid]
        if parent.tensor.size < _ANCHOR_MIN_SIZE:
            return None
        if anchor_bytes[0] > _ANCHOR_BYTE_BUDGET:
            return None
        sub = restrict_box_coeffs(parent.tensor, box[None])[0]
        budget = tol_q * 2.0 ** -(parent.chain + 4)
        cropped, _ = truncate_coeff_tensor(sub, budget)
        shape = tuple(_menu_ceil(cropped.shape[i], sub.shape[i])
                      for i in range(d))
        if np.prod(shape) > _ANCHOR_SHRINK * parent.tensor.size:
            return None
        kept = sub[tuple(slice(0, s) for s in shape)]
        dropped = float(np.abs(sub).sum() - np.abs(kept).sum())
        if dropped > budget:
            return None
        mid = parent.mid + parent.half * 0.5 * (box[:, 0] + box[:, 1])
        half = parent.half * 0.5 * (box[:, 1] - box[:, 0])
        new_id = next_id[0]
        next_id[0] += 1
        anchors[new_id] = _Anchor(np.ascontiguousarray(kept),
                                  parent.eps + dropped, mid, half,
                                  parent.chain + 1)
        stats[new_id] = _make_full_stats(anchors[new_id].tensor, device)
        anchor_bytes[0] += kept.nbytes
        return new_id

    def evaluate_boxes(boxes, aux):
        bsz = boxes.shape[0]
        boxes = boxes.copy()
        out_aux = []
        promote_budget = _PROMOTE_BYTES_PER_CALL
        for b in range(bsz):
            if aux[b] is None:
                out_aux.append((0, 0))
                continue
            aid, depth = aux[b]
            depth += 1
            if depth >= _ANCHOR_DEPTH:
                parent = anchors[aid]
                eligible = (parent.tensor.size >= _ANCHOR_MIN_SIZE
                            and anchor_bytes[0] <= _ANCHOR_BYTE_BUDGET)
                if eligible and promote_budget >= parent.tensor.nbytes:
                    # Charge the ATTEMPT (the host restriction is paid
                    # whether or not the shrink check accepts), and on
                    # failure reset the depth counter so a lineage
                    # retries only every _ANCHOR_DEPTH levels — deeper
                    # boxes truncate better (a JAX-package round-4
                    # fix: the old success-only charge let failed
                    # attempts bypass the cap every round).
                    promote_budget -= parent.tensor.nbytes
                    new_id = _promote(aid, boxes[b])
                    if new_id is not None:
                        boxes[b] = np.tile(np.array([[-1.0, 1.0]]),
                                           (d, 1))
                        aid, depth = new_id, 0
                    else:
                        depth = 0
            out_aux.append((aid, depth))

        lb = np.empty(bsz)
        cand_val = np.empty(bsz)
        cand_loc = np.empty((bsz, d))
        split_dim = np.empty(bsz, dtype=np.intp)
        # Group by anchor-tensor SHAPE, not anchor id: deep searches
        # hold hundreds of small anchors, and per-anchor evaluation
        # fragments the beam into single-digit calls (measured ~40% of
        # the JAX package's round-4 wall time before this).  Boxes of
        # equal shape evaluate in ONE call — shared-anchor groups via
        # the broadcast stats, mixed-anchor groups via the
        # batched-coeffs stats with per-box tensors.
        by_shape = {}
        for b, (aid, _) in enumerate(out_aux):
            by_shape.setdefault(anchors[aid].tensor.shape,
                                []).append(b)

        for shape, idx_list in by_shape.items():
            idxs = np.asarray(idx_list)
            aids = [out_aux[b][0] for b in idx_list]
            gboxes = boxes[idxs]
            single = all(a == aids[0] for a in aids)
            if single:
                full_stats = stats[aids[0]]

                def run_stats(bx, sel=None, fs=full_stats):
                    return fs(bx)
            else:
                batched = _make_batched_stats(shape, device)
                gcoeffs = [stats[a].resident if batched.on_device
                           else anchors[a].tensor for a in aids]

                def run_stats(bx, sel=None, batched=batched,
                              gcoeffs=gcoeffs):
                    cf = (gcoeffs if sel is None
                          else [gcoeffs[i] for i in sel])
                    return batched(bx, cf)

            glb, gcv, gcl, gtails, glo, ghi = run_stats(gboxes)
            if monotonicity:
                # Monotonicity: wherever partial i has a fixed sign on
                # the box, the minimum lies on that face — collapse dim
                # i to a point restriction there and re-evaluate the
                # narrowed box.  The collapse proves q's own
                # face-minimality; the p certificate only uses
                # |p - q| <= eps on values.
                pinned = np.zeros(gboxes.shape[0], dtype=bool)
                for i in range(d):
                    still_wide = gboxes[:, i, 0] < gboxes[:, i, 1]
                    to_lo = still_wide & (glo[:, i] > 0.0)
                    to_hi = still_wide & (ghi[:, i] < 0.0)
                    gboxes[to_lo, i, 1] = gboxes[to_lo, i, 0]
                    gboxes[to_hi, i, 0] = gboxes[to_hi, i, 1]
                    pinned |= to_lo | to_hi
                if pinned.any():
                    sub = np.where(pinned)[0]
                    klb, kcv, kcl, ktails, _, _ = run_stats(
                        gboxes[sub], sub)
                    glb[sub] = np.maximum(glb[sub], klb)
                    better = kcv < gcv[sub]
                    gcv[sub] = np.where(better, kcv, gcv[sub])
                    gcl[sub] = np.where(better[:, None], kcl, gcl[sub])
                    gtails[sub] = ktails
            # Anchor error: lb must hold for the ROOT q, incumbents
            # must overestimate an attained root-q value.
            eps_v = np.array([anchors[a].eps for a in aids])
            mid_v = np.stack([anchors[a].mid for a in aids])
            half_v = np.stack([anchors[a].half for a in aids])
            lb[idxs] = glb - eps_v
            cand_val[idxs] = gcv + eps_v
            cand_loc[idxs] = mid_v + half_v * gcl
            boxes[idxs] = gboxes
            split_dim[idxs] = _choose_split_dims(gboxes, gtails,
                                                 scale=half_v)
        return boxes, lb, cand_val, cand_loc, split_dim, out_aux

    return evaluate_boxes


def minimize_coeff_tensor(
    coeffs: np.ndarray,
    *,
    tol: float = 1e-9,
    max_boxes: int = 20000,
    beam: int = 256,
    node_values: Optional[np.ndarray] = None,
    node_coords: Optional[Sequence[np.ndarray]] = None,
    monotonicity: bool = True,
    seed_value: Optional[float] = None,
    device=None,
) -> GlobalResult:
    """Certified global minimum of the polynomial with Chebyshev
    coefficient tensor ``coeffs`` over [-1, 1]^d.

    ``node_values``/``node_coords`` (the build tensor and its local
    node vectors) seed the incumbent for free when provided.

    ``monotonicity`` enables the reduction that makes boundary-attained
    optima fast: each partial's enclosure comes from differentiating
    the box-restricted coefficients in place (one shared matrix per
    dim — a single fat GEMM over the batch); wherever it has a fixed
    sign, the minimum provably lies on the corresponding face, so that
    dim collapses to a point restriction instead of being bisected.  A
    monotone region resolves in one collapse instead of splitting
    linearly toward the corner.

    ``device`` (a torch device, or None): where the box statistics of
    tensors at or over the device's threshold (:func:`_on_device`) run;
    None keeps every tensor on the NumPy route.
    """
    d = coeffs.ndim
    if d == 0:
        raise ValueError("scalar coefficient tensor")
    tol = float(tol)
    if tol <= 0.0:
        raise ValueError(f"tol must be positive, got {tol}")

    # Degree truncation: search the cropped polynomial q (|p - q| <=
    # eps <= tol/4 everywhere), then hand back an EXACT p value at the
    # winner with the eps folded into the certificate.
    work, eps = truncate_coeff_tensor(coeffs, 0.25 * tol)
    tol_q = max(tol - 2.0 * eps, 0.5 * tol)

    best = np.inf
    best_loc = np.zeros(d)
    if node_values is not None:
        flat_idx = int(np.argmin(node_values))
        # Node values are p values; q(x) <= p(x) + eps keeps the seed a
        # valid q incumbent.
        best = float(np.asarray(node_values).reshape(-1)[flat_idx]) + eps
        multi = np.unravel_index(flat_idx, node_values.shape)
        best_loc = np.array([node_coords[i][multi[i]] for i in range(d)])
    seeded = False
    if seed_value is not None and seed_value + eps < best:
        # An attainable value of the same objective found ELSEWHERE
        # (e.g. another spline piece): boxes that cannot beat it prune,
        # so per-piece searches share one incumbent.  Never reported as
        # this search's own location.
        best = float(seed_value) + eps
        seeded = True

    evaluate_boxes = _make_anchored_evaluator(work, tol_q, monotonicity,
                                              device)

    res = _bnb_minimize(d, evaluate_boxes, tol=tol_q, max_boxes=max_boxes,
                        beam=beam, seed_value=best, seed_loc=best_loc)
    if seeded and res.value == float(seed_value) + eps:
        # The external incumbent stood: this tensor holds nothing below
        # seed - gap, and the search's own location is meaningless.
        # Report against the seed (q >= seed + eps - gap_q everywhere
        # here, so p >= seed - gap_q) without re-evaluating.
        return GlobalResult(float(seed_value), res.location, res.gap,
                            res.certified, res.boxes)
    if eps == 0.0:
        return res
    # Translate the q certificate to p: p_min >= (q_best - gap_q) - eps
    # and the winner's exact p value is one cheap contraction.
    p_val = eval_coeff_tensor_at(coeffs, res.location)
    gap_p = p_val - (res.value - res.gap) + eps
    return GlobalResult(p_val, res.location, max(gap_p, 0.0),
                        res.certified and gap_p <= tol, res.boxes)


# ----------------------------------------------------------------------
# TT bounder: the same search through coefficient cores
# ----------------------------------------------------------------------

def _tt_box_stats(cores: Sequence[np.ndarray], box: np.ndarray):
    """(mid, radius, center, tails) for one local sub-box of a TT in
    coefficient-core form (cores: (r_{k-1}, n_k, r_k)).

    Restriction applies each dim's exact re-expansion matrix to that
    core's node mode (the TT stays a TT of identical ranks).  The
    enclosure is an INTERVAL TRANSFER CHAIN: each dim's restricted core
    becomes an interval (r x r) matrix — midpoint ``c'_0`` (the rank
    block's mean on the box) and radius ``sum_{k>0} |c'_k|`` (its
    variation, by |T_k| <= 1) — and the chain multiplies them with
    midpoint-radius interval arithmetic.  Unlike the naive
    triangle-inequality bound over rank paths (which never tightens when
    paths cancel), the interval product preserves matrix-level sign
    cancellation, so the radius contracts to 0 as the box shrinks —
    which is what makes certification possible at all on TT-Cross cores.
    O(d n r^2) per box for ANY d, where a dense tensor would be n^d.

    ``tails[k]`` re-runs the chain with only dim k's radius live — the
    share of the enclosure width owed to dim k, used to pick the
    bisection dim.
    """
    d = len(cores)
    mids: List[np.ndarray] = []
    rads: List[np.ndarray] = []
    cens: List[np.ndarray] = []
    for k, core in enumerate(cores):
        lo, hi = box[k]
        if not (lo == -1.0 and hi == 1.0):
            m = restriction_matrix(core.shape[1], lo, hi)
            core = np.einsum("rns,kn->rks", core, m)
        mids.append(core[:, 0, :])
        rads.append(np.abs(core[:, 1:, :]).sum(axis=1))
        cens.append(np.einsum("rns,n->rs",
                              core, _t_at_zero(core.shape[1])))

    def chain(live_rad) -> Tuple[float, float]:
        vm = np.ones((1, 1))
        vr = np.zeros((1, 1))
        for k in range(d):
            rk = rads[k] if live_rad[k] else np.zeros_like(rads[k])
            vm, vr = (vm @ mids[k],
                      np.abs(vm) @ rk + vr @ np.abs(mids[k]) + vr @ rk)
        return float(vm[0, 0]), float(vr[0, 0])

    mid, radius = chain([True] * d)
    vc = np.ones((1, 1))
    for k in range(d):
        vc = vc @ cens[k]
    tails = np.empty(d)
    for k in range(d):
        live = [False] * d
        live[k] = True
        tails[k] = chain(live)[1]
    return mid, radius, float(vc[0, 0]), tails


def _tt_interval_chains(mids, rads, cens, bsz: int, d: int):
    """The d+1 interval transfer-matrix chain runs over prepared
    per-dim (B, r, r) midpoint/radius/center blocks — shared by the
    broadcast and per-box-cores stats functions."""
    def chain(live):
        vm = np.ones((bsz, 1, 1))
        vr = np.zeros((bsz, 1, 1))
        for k in range(d):
            rk = rads[k] if live[k] else np.zeros_like(rads[k])
            vm, vr = (vm @ mids[k],
                      np.abs(vm) @ rk + vr @ np.abs(mids[k]) + vr @ rk)
        return vm[:, 0, 0], vr[:, 0, 0]

    mid, radius = chain([True] * d)
    vc = np.ones((bsz, 1, 1))
    for k in range(d):
        vc = vc @ cens[k]
    tails = np.empty((bsz, d))
    for k in range(d):
        live = [False] * d
        live[k] = True
        tails[:, k] = chain(live)[1]
    return mid, radius, vc[:, 0, 0], tails


def _tt_restrict_stats_dim(sub, boxes, k, bsz, broadcast_core=None):
    """Per-box restricted (mid, rad, cen) blocks for one dim; grouped
    one batched einsum per distinct (dyadic) interval."""
    n = sub.shape[2]
    pairs = boxes[:, k, :]
    uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
    all_full = (uniq.shape[0] == 1 and uniq[0, 0] == -1.0
                and uniq[0, 1] == 1.0)
    if not all_full:
        if broadcast_core is not None:
            sub = sub.copy()
        for u, (lo, hi) in enumerate(uniq):
            if lo == -1.0 and hi == 1.0:
                continue
            m = restriction_matrix(n, lo, hi)
            mask = inv == u
            sub[mask] = np.einsum("brns,kn->brks", sub[mask], m)
    return (np.ascontiguousarray(sub[:, :, 0, :]),
            np.abs(sub[:, :, 1:, :]).sum(axis=2),
            np.einsum("brns,n->brs", sub, _t_at_zero(n)))


def _tt_box_stats_batch(cores: Sequence[np.ndarray],
                        boxes: np.ndarray):
    """:func:`_tt_box_stats` over a (B, d, 2) batch in one numpy pass.

    Same interval transfer-matrix chain, vectorized: per dim the
    per-box restricted cores come from ONE grouped batched einsum per
    distinct (dyadic) interval, and the d+1 chain runs are batched
    (B, r, r) matmuls.  The per-box Python loop this replaces was the
    TT bounder's dominant cost (~35x the dense search's per-box time
    on the bench table).  Returns (mid (B,), radius (B,), center (B,),
    tails (B, d)).
    """
    boxes = np.asarray(boxes, dtype=np.float64)
    bsz, d = boxes.shape[0], boxes.shape[1]
    mids: List[np.ndarray] = []
    rads: List[np.ndarray] = []
    cens: List[np.ndarray] = []
    for k, core in enumerate(cores):
        r0, n, r1 = core.shape
        sub = np.broadcast_to(core, (bsz, r0, n, r1))
        m, r, cn = _tt_restrict_stats_dim(sub, boxes, k, bsz,
                                          broadcast_core=core)
        mids.append(m)
        rads.append(r)
        cens.append(cn)
    return _tt_interval_chains(mids, rads, cens, bsz, d)


def _tt_box_stats_batch_cores(stacked: Sequence[np.ndarray],
                              boxes: np.ndarray):
    """:func:`_tt_box_stats_batch` with PER-BOX cores — ``stacked`` is
    a list over dims of (B, r0, n, r1) arrays (the anchored search's
    mixed-anchor batches of one menu-rounded shape, exactly like the
    dense search's batched-coeffs stats)."""
    boxes = np.asarray(boxes, dtype=np.float64)
    bsz, d = boxes.shape[0], boxes.shape[1]
    mids: List[np.ndarray] = []
    rads: List[np.ndarray] = []
    cens: List[np.ndarray] = []
    for k in range(d):
        sub = np.ascontiguousarray(stacked[k])
        m, r, cn = _tt_restrict_stats_dim(sub, boxes, k, bsz)
        mids.append(m)
        rads.append(r)
        cens.append(cn)
    return _tt_interval_chains(mids, rads, cens, bsz, d)


# --------------------------------------------------------------------------
# TT anchoring: multilevel rank + degree re-truncation of the TT search.
#
# The TT bounder's per-box cost is the FULL chain — O(sum r n^2 r) core
# restrictions plus d+1 interval chain runs at the root's bond ranks —
# for every box, however deep.  But a TT restricted to a small box is
# numerically low-rank: its coefficient mass concentrates on the
# constant term, so both trailing DEGREE slices (abs-chain tail bounds,
# exactly like the dense search's truncate_coeff_tensor) and trailing
# SINGULAR VALUES (right-canonical TT-SVD sweep; Frobenius error is
# the root-sum-square of dropped sigmas, and sup <= sqrt(prod n) * Frob
# for a Chebyshev coefficient error tensor) truncate away within a
# rigorous budget.  Anchors carry the cumulative |q_root - q_anchor|
# bound; box lower bounds subtract it and incumbents add it, exactly
# like the dense anchoring, so certificates remain rigorous end-to-end
# (up to the module's stated f64 roundoff caveat).
# --------------------------------------------------------------------------

_TT_ANCHOR_MIN_COST = 4096     # don't anchor chains cheaper than this
# TT promote attempts are cheap individually (KB-scale cores) but a
# failed lineage would retry every _ANCHOR_DEPTH levels forever — on a
# 10-D rank-4 chain that measured 8x SLOWER than no anchoring at all.
# Failed attempts back off geometrically (truncation succeeds DEEP,
# where the restricted chain actually collapses), and each
# evaluate_boxes call attempts at most this many promotions.
_TT_PROMOTE_ATTEMPTS_PER_CALL = 64
# Only attempt promotion once the box is genuinely small in the ROOT
# frame: restricted-chain truncation is driven by (width/2)^k
# coefficient decay, so wide boxes cannot crop and the 2^d-wide
# shallow tree would otherwise burn ~23% of boxes on doomed attempts
# (measured on the 10-D bench chain).
_TT_ANCHOR_MAX_WIDTH = 0.25


def _tt_chain_cost(cores) -> float:
    """Per-box bound-evaluation cost proxy: the restriction einsums
    dominate (O(r_l n^2 r_r) per core)."""
    return float(sum(c.shape[0] * c.shape[1] * c.shape[1] * c.shape[2]
                     for c in cores))


def _tt_restrict_cores(cores, box: np.ndarray):
    """Exact restriction of every core to one local sub-box."""
    out = []
    for k, c in enumerate(cores):
        lo, hi = box[k]
        if lo == -1.0 and hi == 1.0:
            out.append(np.asarray(c, dtype=np.float64))
        else:
            m = restriction_matrix(c.shape[1], lo, hi)
            out.append(np.einsum("rns,kn->rks", c, m))
    return out


def _tt_degree_crop(cores, budget: float, menu: bool = False):
    """Crop trailing node slices per core while the RIGOROUS dropped
    sup mass fits in ``budget``.  The bound for dropping core k's last
    slice is the abs chain through that slice alone:
    ``pre_k @ |tail| @ suf_k`` (prefix from already-cropped cores,
    suffix from the uncropped originals — both conservative).

    ``menu=True`` rounds each cropped node count UP to the anchor
    shape menu (re-adding slices, which only shrinks the dropped
    mass): anchors of equal shape then batch into one stats call
    instead of fragmenting the beam (same trick as the dense
    search's ``_menu_ceil``)."""
    cores = [np.asarray(c, dtype=np.float64) for c in cores]
    d = len(cores)
    suf = [None] * d
    v = np.ones((cores[-1].shape[2], 1))
    for k in range(d - 1, -1, -1):
        suf[k] = v
        v = np.abs(cores[k]).sum(axis=1) @ v
    pre = np.ones((1, cores[0].shape[0]))
    dropped = 0.0
    for k in range(d):
        n_k = cores[k].shape[1]
        keep = n_k
        slice_bounds = []
        while keep > 2:
            tail = np.abs(cores[k][:, keep - 1, :])
            bound = float((pre @ tail @ suf[k])[0, 0])
            if dropped + bound <= budget:
                dropped += bound
                slice_bounds.append(bound)
                keep -= 1
            else:
                break
        if menu and keep < n_k:
            target = _menu_ceil(keep, n_k)
            while keep < target:
                dropped -= slice_bounds.pop()
                keep += 1
        if keep < n_k:
            cores[k] = np.ascontiguousarray(cores[k][:, :keep, :])
        pre = pre @ np.abs(cores[k]).sum(axis=1)
    return cores, dropped


def _tt_round_cores_bounded(cores, frob_budget: float):
    """TT-SVD recompression with a FROBENIUS error budget: the sweep of
    ``models.tt_algorithms.tt_round_cores`` (right-QR canonicalization,
    left-to-right SVD truncation) dropping trailing singular values
    greedily while the cumulative root-sum-square stays within
    ``frob_budget`` — the standard sequential-truncation bound
    ``|A - B|_F <= sqrt(sum dropped sigma^2)`` (right remainder stays
    canonical).  Returns (rounded cores, Frobenius bound actually
    spent)."""
    cores = [np.asarray(c, dtype=np.float64).copy() for c in cores]
    d = len(cores)
    if d == 1:
        return cores, 0.0
    for k in range(d - 1, 0, -1):
        r_l, n, r_r = cores[k].shape
        q, rr = np.linalg.qr(cores[k].reshape(r_l, n * r_r).T)
        qt = q.T
        cores[k] = qt.reshape(qt.shape[0], n, r_r)
        cores[k - 1] = np.einsum("ljs,sr->ljr", cores[k - 1], rr.T)
    budget2 = frob_budget * frob_budget
    dropped2 = 0.0
    for k in range(d - 1):
        r_l, n, r_r = cores[k].shape
        u, s, vt = np.linalg.svd(cores[k].reshape(r_l * n, r_r),
                                 full_matrices=False)
        keep = len(s)
        while keep > 1 and dropped2 + s[keep - 1] ** 2 <= budget2:
            dropped2 += float(s[keep - 1]) ** 2
            keep -= 1
        u, s, vt = u[:, :keep], s[:keep], vt[:keep, :]
        cores[k] = u.reshape(r_l, n, keep)
        cores[k + 1] = np.einsum("lr,rjs->ljs", s[:, None] * vt,
                                 cores[k + 1])
    return cores, float(np.sqrt(dropped2))


class _TTAnchor(NamedTuple):
    cores: Tuple[np.ndarray, ...]  # restricted + re-truncated chain
    eps: float                     # cumulative rigorous sup bound
    mid: np.ndarray                # (d,) root-frame center
    half: np.ndarray               # (d,) root-frame half-widths
    chain: int


def _make_tt_anchored_evaluator(cores0, tol_q: float, stats=None):
    """The TT bounder's ``evaluate_boxes(boxes, aux)`` with
    hierarchical rank/degree anchoring; aux = (anchor_id, depth,
    backoff).  ``stats`` (optional dict) collects attempt/success
    counters for benches and tests."""
    d = len(cores0)
    cores0 = tuple(np.asarray(c, dtype=np.float64) for c in cores0)
    anchors = {0: _TTAnchor(cores0, 0.0, np.zeros(d), np.ones(d), 0)}
    anchor_bytes = [sum(c.nbytes for c in cores0)]
    next_id = [1]
    if stats is not None:
        stats.setdefault("attempts", 0)
        stats.setdefault("anchors", 0)

    def _promote(aid: int, box: np.ndarray):
        parent = anchors[aid]
        sub = _tt_restrict_cores(parent.cores, box)
        budget = tol_q * 2.0 ** -(parent.chain + 4)
        cropped, deg_eps = _tt_degree_crop(sub, 0.5 * budget,
                                           menu=True)
        n_total = float(np.prod([c.shape[1] for c in cropped]))
        rounded, frob = _tt_round_cores_bounded(
            cropped, 0.5 * budget / np.sqrt(n_total))
        rank_eps = float(np.sqrt(n_total)) * frob
        if (_tt_chain_cost(rounded)
                > _ANCHOR_SHRINK * _tt_chain_cost(parent.cores)):
            return None
        mid = parent.mid + parent.half * 0.5 * (box[:, 0] + box[:, 1])
        half = parent.half * 0.5 * (box[:, 1] - box[:, 0])
        new_id = next_id[0]
        next_id[0] += 1
        anchors[new_id] = _TTAnchor(
            tuple(np.ascontiguousarray(c) for c in rounded),
            parent.eps + deg_eps + rank_eps, mid, half,
            parent.chain + 1)
        anchor_bytes[0] += sum(c.nbytes for c in rounded)
        if stats is not None:
            stats["anchors"] += 1
        return new_id

    def evaluate_boxes(boxes, aux):
        bsz = boxes.shape[0]
        boxes = boxes.copy()
        out_aux = []
        attempts = _TT_PROMOTE_ATTEMPTS_PER_CALL
        for b in range(bsz):
            if aux[b] is None:
                out_aux.append((0, 0, _ANCHOR_DEPTH))
                continue
            aid, depth, backoff = aux[b]
            depth += 1
            if depth >= backoff:
                parent = anchors[aid]
                root_w = float(np.max(
                    parent.half * (boxes[b, :, 1] - boxes[b, :, 0])))
                eligible = (_tt_chain_cost(parent.cores)
                            >= _TT_ANCHOR_MIN_COST
                            and root_w <= _TT_ANCHOR_MAX_WIDTH
                            and anchor_bytes[0] <= _ANCHOR_BYTE_BUDGET)
                if eligible and attempts > 0:
                    attempts -= 1
                    if stats is not None:
                        stats["attempts"] += 1
                    new_id = _promote(aid, boxes[b])
                    if new_id is not None:
                        boxes[b] = np.tile(np.array([[-1.0, 1.0]]),
                                           (d, 1))
                        aid, depth = new_id, 0
                        backoff = _ANCHOR_DEPTH
                    else:
                        # Truncation fires only once the restricted
                        # chain collapses; geometric backoff keeps
                        # failed lineages from paying the attempt
                        # forever (measured 8x pessimization without).
                        depth = 0
                        backoff = min(2 * backoff, 64)
            out_aux.append((aid, depth, backoff))

        lb = np.empty(bsz)
        cand_val = np.empty(bsz)
        cand_loc = np.empty((bsz, d))
        split_dim = np.empty(bsz, dtype=np.intp)
        # Group by chain SHAPE, not anchor id (deep searches hold
        # thousands of small anchors — per-anchor evaluation fragments
        # the beam into tiny chain calls; same fix as the dense
        # search's by-shape grouping, enabled by the menu-rounded
        # degree crops).
        by_shape = {}
        for b, (aid, *_) in enumerate(out_aux):
            key = tuple(c.shape for c in anchors[aid].cores)
            by_shape.setdefault(key, []).append(b)
        for key, idx_list in by_shape.items():
            idxs = np.asarray(idx_list)
            aids = [out_aux[b][0] for b in idx_list]
            gboxes = boxes[idxs]
            if all(a == aids[0] for a in aids):
                mid, radius, center, tails = _tt_box_stats_batch(
                    list(anchors[aids[0]].cores), gboxes)
            else:
                stacked = [np.stack([anchors[a].cores[k]
                                     for a in aids])
                           for k in range(d)]
                mid, radius, center, tails = _tt_box_stats_batch_cores(
                    stacked, gboxes)
            eps_v = np.array([anchors[a].eps for a in aids])
            mid_v = np.stack([anchors[a].mid for a in aids])
            half_v = np.stack([anchors[a].half for a in aids])
            lb[idxs] = mid - radius - eps_v
            cand_val[idxs] = center + eps_v
            local_mid = 0.5 * (gboxes[:, :, 0] + gboxes[:, :, 1])
            cand_loc[idxs] = mid_v + half_v * local_mid
            split_dim[idxs] = _choose_split_dims(gboxes, tails,
                                                 scale=half_v)
        return boxes, lb, cand_val, cand_loc, split_dim, out_aux

    return evaluate_boxes


def minimize_tt_cores(
    cores: Sequence[np.ndarray],
    *,
    tol: float = 1e-9,
    max_boxes: int = 20000,
    beam: int = 64,
    seed_value: float = np.inf,
    seed_loc: Optional[np.ndarray] = None,
) -> GlobalResult:
    """Certified global minimum of a TT in coefficient-core form over
    [-1, 1]^d — the n^d-free counterpart of
    :func:`minimize_coeff_tensor` for tensor-train interpolants.

    Hierarchical anchoring (round 5): subtrees re-restrict the chain to
    their box and re-truncate both degrees and BOND RANKS with rigorous
    cumulative sup bounds (see the block comment above), so deep boxes
    pay a collapsed chain instead of the root's full ranks."""
    d = len(cores)
    if seed_loc is None:
        seed_loc = np.zeros(d)

    evaluate_boxes = _make_tt_anchored_evaluator(cores, tol)

    return _bnb_minimize(d, evaluate_boxes, tol=tol, max_boxes=max_boxes,
                         beam=beam, seed_value=seed_value,
                         seed_loc=seed_loc)


class _TTSysAnchor(NamedTuple):
    """One re-anchoring of a whole TT system: all K component chains
    restricted to the anchor box and re-truncated together."""

    systems: Tuple[Tuple[np.ndarray, ...], ...]  # K core tuples
    eps: Tuple[float, ...]                       # per-component bounds
    mid: np.ndarray
    half: np.ndarray
    chain: int


def isolate_common_zeros_tt(
    core_lists: Sequence[Sequence[np.ndarray]],
    *,
    delta: float = 1e-3,
    max_boxes: int = 50000,
    beam: int = 128,
) -> np.ndarray:
    """Boxes (local storage-frame coords) that may contain a common
    zero of every TT in ``core_lists`` (each a list of coefficient
    cores), refined until narrower than ``delta`` per dim — the
    tensor-train counterpart of :func:`isolate_common_zeros`, bounding
    each component with the interval transfer-matrix chain instead of a
    dense enclosure (no n^d materialization).

    Returns surviving box centers (K, d).  Raises on budget exhaustion
    with wide boxes open (likely a non-isolated zero set).

    Hierarchical anchoring (round 5): deep subtrees re-restrict ALL K
    chains to their box and re-truncate degrees and bond ranks with
    rigorous per-component sup bounds (the machinery of the anchored
    ``minimize_tt_cores``), each bound widening its component's
    zero-exclusion margin — conservative by construction, so a box
    containing a true common zero is never discarded.  Attempts are
    width-gated and back off geometrically (the TT lessons measured on
    the minimize side).
    """
    d = len(core_lists[0])
    for cores in core_lists:
        if len(cores) != d:
            raise ValueError("all system components must share one "
                             "dimensionality")
    if not (0.0 < delta < 1.0):
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    systems0 = tuple(tuple(np.asarray(c, dtype=np.float64)
                           for c in cores) for cores in core_lists)
    margins = []
    for cores in systems0:
        z = np.ones((1, 1))
        for core in cores:
            z = z @ np.abs(core).sum(axis=1)
        margins.append(1e-12 * max(float(z[0, 0]), 1e-300))

    anchors = {0: _TTSysAnchor(systems0, (0.0,) * len(systems0),
                               np.zeros(d), np.ones(d), 0)}
    next_id = [1]

    def _promote(aid: int, box: np.ndarray):
        parent = anchors[aid]
        new_systems, new_eps, new_cost = [], [], 0.0
        for k, cores in enumerate(parent.systems):
            sub = _tt_restrict_cores(list(cores), box)
            budget = margins[k] * 2.0 ** -(parent.chain + 1)
            cropped, deg_eps = _tt_degree_crop(sub, 0.5 * budget,
                                               menu=True)
            n_total = float(np.prod([c.shape[1] for c in cropped]))
            rounded, frob = _tt_round_cores_bounded(
                cropped, 0.5 * budget / np.sqrt(n_total))
            new_systems.append(tuple(np.ascontiguousarray(c)
                                     for c in rounded))
            new_eps.append(parent.eps[k] + deg_eps
                           + float(np.sqrt(n_total)) * frob)
            new_cost += _tt_chain_cost(rounded)
        if new_cost > _ANCHOR_SHRINK * sum(
                _tt_chain_cost(cs) for cs in parent.systems):
            return None
        mid = parent.mid + parent.half * 0.5 * (box[:, 0] + box[:, 1])
        half = parent.half * 0.5 * (box[:, 1] - box[:, 0])
        new_id = next_id[0]
        next_id[0] += 1
        anchors[new_id] = _TTSysAnchor(tuple(new_systems),
                                       tuple(new_eps), mid, half,
                                       parent.chain + 1)
        return new_id

    active = np.tile(np.array([[-1.0, 1.0]]), (d, 1))[None]
    active_aux: List[object] = [None]
    done: List[np.ndarray] = []
    processed = 1
    while active.shape[0]:
        if processed > max_boxes:
            raise ValueError(
                f"zero isolation exceeded max_boxes={max_boxes} with "
                f"{active.shape[0]} boxes still open — the solution set "
                "is probably not isolated points (try a larger delta, "
                "or reduce the system)")
        batch = active[:beam].copy()
        batch_aux = active_aux[:beam]
        active = active[beam:]
        active_aux = active_aux[beam:]
        bsz = batch.shape[0]

        attempts = _TT_PROMOTE_ATTEMPTS_PER_CALL
        aux = []
        for b in range(bsz):
            if batch_aux[b] is None:
                aux.append((0, 0, _ANCHOR_DEPTH))
                continue
            aid, depth, backoff = batch_aux[b]
            depth += 1
            if depth >= backoff:
                parent = anchors[aid]
                root_w = float(np.max(
                    parent.half * (batch[b, :, 1] - batch[b, :, 0])))
                cost = sum(_tt_chain_cost(cs) for cs in parent.systems)
                if (cost >= _TT_ANCHOR_MIN_COST
                        and root_w <= _TT_ANCHOR_MAX_WIDTH
                        and attempts > 0):
                    attempts -= 1
                    new_id = _promote(aid, batch[b])
                    if new_id is not None:
                        batch[b] = np.tile(np.array([[-1.0, 1.0]]),
                                           (d, 1))
                        aid, depth = new_id, 0
                        backoff = _ANCHOR_DEPTH
                    else:
                        depth = 0
                        backoff = min(2 * backoff, 64)
            aux.append((aid, depth, backoff))

        keep = np.ones(bsz, dtype=bool)
        tails = np.zeros((bsz, d))
        by_aid = {}
        for b, (aid, *_) in enumerate(aux):
            by_aid.setdefault(aid, []).append(b)
        for aid, idx_list in by_aid.items():
            anc = anchors[aid]
            idxs = np.asarray(idx_list)
            for k, cores in enumerate(anc.systems):
                live = idxs[keep[idxs]]
                if not live.size:
                    break
                mid, radius, _, t = _tt_box_stats_batch(
                    list(cores), batch[live])
                keep[live] &= (np.abs(mid)
                               <= radius + margins[k] + anc.eps[k])
                tails[live] += t

        halfs = np.stack([anchors[a].half for a, *_ in aux])
        mids = np.stack([anchors[a].mid for a, *_ in aux])
        batch, tails = batch[keep], tails[keep]
        halfs, mids = halfs[keep], mids[keep]
        aux = [a for a, kp in zip(aux, keep) if kp]
        if not batch.shape[0]:
            continue
        widths = (batch[:, :, 1] - batch[:, :, 0]) * halfs
        narrow = np.all(widths <= delta, axis=1)
        centers = mids + halfs * 0.5 * (batch[:, :, 0] + batch[:, :, 1])
        done.extend(centers[narrow])
        wide = batch[~narrow]
        if wide.shape[0]:
            w = widths[~narrow]
            score = np.where(w > delta,
                             w * (tails[~narrow] + 1e-300), -np.inf)
            dims = np.argmax(score, axis=1)
            children = _split_boxes(wide, dims)
            processed += children.shape[0]
            wide_aux = [a for a, nr in zip(aux, narrow) if not nr]
            active = (np.concatenate([active, children])
                      if active.shape[0] else children)
            active_aux = active_aux + wide_aux + wide_aux

    if not done:
        return np.zeros((0, d))
    return np.stack(done)


# ----------------------------------------------------------------------
# Zero isolation for polynomial systems (critical points, solve_system)
# ----------------------------------------------------------------------

class _ZeroAnchor(NamedTuple):
    """One re-anchoring of the WHOLE system: all K component tensors
    restricted to the anchor box and re-truncated together."""

    tensors: Tuple[np.ndarray, ...]   # K truncated restricted tensors
    eps: Tuple[float, ...]            # per-component cumulative sup
    #                                   bounds |p_k_root - q_k_anchor|
    mid: np.ndarray                   # (d,) root-frame center
    half: np.ndarray                  # (d,) root-frame half-widths
    chain: int                        # anchors above this one


def isolate_common_zeros(
    coeff_tensors: Sequence[np.ndarray],
    *,
    delta: float = 1e-3,
    max_boxes: int = 50000,
    beam: int = 128,
) -> np.ndarray:
    """Boxes (local coords) that may contain a common zero of every
    polynomial in ``coeff_tensors``, refined until each is narrower than
    ``delta`` per dim.

    A box is *proved free* of solutions as soon as any component's
    enclosure excludes 0 (``|c0| > radius + margin + eps``).  Returns
    the surviving box centers, (K, d) — candidates for Newton polishing
    by the caller.  Raises if the budget is exhausted with wide boxes
    still open (the zero set is then likely non-isolated — a manifold,
    not points).

    Hierarchical anchoring (round 5): like the dense minimize bounder,
    a subtree that has descended ``_ANCHOR_DEPTH`` levels re-restricts
    ALL K component tensors once, re-truncates each with a rigorous
    budget geometrically tied to its roundoff margin (cumulative
    ``eps_k < margin_k`` over any chain), and serves its descendants
    from the small anchor tensors — per-box restriction cost drops
    from the root n^d to the truncated size.  Rigor is one-sided by
    construction: the anchored exclusion test widens by ``eps_k``, so
    a box containing a true common zero of the ORIGINAL system is
    never discarded (if p_k(x*) = 0 in the box then the anchored
    enclosure satisfies |c0| <= rad + eps_k <= rad + margin + eps_k).

    Host NumPy at every size, as in the reference (see the note above
    :func:`_make_batched_stats`).
    """
    d = coeff_tensors[0].ndim
    for t in coeff_tensors:
        if t.ndim != d:
            raise ValueError("all system components must share one "
                             "dimensionality")
    if not (0.0 < delta < 1.0):
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    tensors0 = tuple(np.ascontiguousarray(t, dtype=np.float64)
                     for t in coeff_tensors)
    margins = [1e-12 * max(float(np.abs(t).sum()), 1e-300)
               for t in tensors0]

    anchors = {0: _ZeroAnchor(tensors0, (0.0,) * len(tensors0),
                              np.zeros(d), np.ones(d), 0)}
    anchor_bytes = [sum(t.nbytes for t in tensors0)]
    next_id = [1]

    def _promote(aid: int, box: np.ndarray):
        parent = anchors[aid]
        new_tensors, new_eps, total = [], [], 0
        for k, tensor in enumerate(parent.tensors):
            sub = restrict_box_coeffs(tensor, box[None])[0]
            budget = margins[k] * 2.0 ** -(parent.chain + 1)
            cropped, dropped = truncate_coeff_tensor(sub, budget)
            new_tensors.append(np.ascontiguousarray(cropped))
            new_eps.append(parent.eps[k] + dropped)
            total += cropped.size
        if total > _ANCHOR_SHRINK * sum(t.size for t in parent.tensors):
            return None
        mid = parent.mid + parent.half * 0.5 * (box[:, 0] + box[:, 1])
        half = parent.half * 0.5 * (box[:, 1] - box[:, 0])
        new_id = next_id[0]
        next_id[0] += 1
        anchors[new_id] = _ZeroAnchor(tuple(new_tensors),
                                      tuple(new_eps), mid, half,
                                      parent.chain + 1)
        anchor_bytes[0] += sum(t.nbytes for t in new_tensors)
        return new_id

    active = np.tile(np.array([[-1.0, 1.0]]), (d, 1))[None]
    active_aux: List[object] = [None]
    done: List[np.ndarray] = []
    processed = 1
    while active.shape[0]:
        if processed > max_boxes:
            raise ValueError(
                f"zero isolation exceeded max_boxes={max_boxes} with "
                f"{active.shape[0]} boxes still open — the solution set "
                "is probably not isolated points (try a larger delta, "
                "or reduce the system)")
        batch = active[:beam].copy()
        batch_aux = active_aux[:beam]
        active = active[beam:]
        active_aux = active_aux[beam:]
        bsz = batch.shape[0]

        promote_budget = _PROMOTE_BYTES_PER_CALL
        aux = []
        for b in range(bsz):
            if batch_aux[b] is None:
                aux.append((0, 0))
                continue
            aid, depth = batch_aux[b]
            depth += 1
            if depth >= _ANCHOR_DEPTH:
                parent = anchors[aid]
                pbytes = sum(t.nbytes for t in parent.tensors)
                eligible = (sum(t.size for t in parent.tensors)
                            >= _ANCHOR_MIN_SIZE
                            and anchor_bytes[0] <= _ANCHOR_BYTE_BUDGET)
                if eligible and promote_budget >= pbytes:
                    # Charge the ATTEMPT; on failure reset the depth
                    # counter so a lineage retries every _ANCHOR_DEPTH
                    # levels (same accounting as the minimize bounder).
                    promote_budget -= pbytes
                    new_id = _promote(aid, batch[b])
                    if new_id is not None:
                        batch[b] = np.tile(np.array([[-1.0, 1.0]]),
                                           (d, 1))
                        aid, depth = new_id, 0
                    else:
                        depth = 0
            aux.append((aid, depth))

        keep = np.ones(bsz, dtype=bool)
        tails = np.zeros((bsz, d))
        by_aid = {}
        for b, (aid, _) in enumerate(aux):
            by_aid.setdefault(aid, []).append(b)
        for aid, idx_list in by_aid.items():
            anc = anchors[aid]
            idxs = np.asarray(idx_list)
            for k, tensor in enumerate(anc.tensors):
                live = idxs[keep[idxs]]
                if not live.size:
                    break
                sub = restrict_box_coeffs(tensor, batch[live])
                c0, rad = box_enclosure(sub)
                # The roundoff margin keeps zeros attained exactly on
                # the domain boundary or a bisection plane from being
                # "proved" away by ~eps noise in the restriction
                # products (the enclosure there is a knife edge:
                # [c0 - rad, 0]); the anchor eps widens the test the
                # same conservative direction.
                keep[live] &= (np.abs(c0)
                               <= rad + margins[k] + anc.eps[k])
                tails[live] += _tail_mass_per_dim(sub)

        halfs = np.stack([anchors[a].half for a, _ in aux])
        mids = np.stack([anchors[a].mid for a, _ in aux])
        batch, tails = batch[keep], tails[keep]
        halfs, mids = halfs[keep], mids[keep]
        aux = [a for a, k in zip(aux, keep) if k]
        if not batch.shape[0]:
            continue
        # Width tests and split scores live in the ROOT frame.
        widths = (batch[:, :, 1] - batch[:, :, 0]) * halfs
        narrow = np.all(widths <= delta, axis=1)
        centers = mids + halfs * 0.5 * (batch[:, :, 0] + batch[:, :, 1])
        done.extend(centers[narrow])
        wide = batch[~narrow]
        if wide.shape[0]:
            # Split the widest dim, weighted by residual variation.
            w = widths[~narrow]
            score = np.where(w > delta,
                             w * (tails[~narrow] + 1e-300), -np.inf)
            dims = np.argmax(score, axis=1)
            children = _split_boxes(wide, dims)
            processed += children.shape[0]
            wide_aux = [a for a, n in zip(aux, narrow) if not n]
            active = (np.concatenate([active, children])
                      if active.shape[0] else children)
            active_aux = active_aux + wide_aux + wide_aux

    if not done:
        return np.zeros((0, d))
    return np.stack(done)

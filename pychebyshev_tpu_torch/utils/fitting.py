"""Least-squares construction of interpolants from scattered data.

The port of ``pychebyshev_tpu.utils.fitting``.  The dense model is
*linear* in its nodal-value tensor: with per-dim barycentric
coefficient rows ``r_k(x)`` (the rows ``ops.eval.barycentric_coefficients``
builds),

    f_T(x) = < r_1(x) (x) ... (x) r_d(x) , T >

so fitting T to samples ``(x_j, y_j)`` is ordinary (optionally
Tikhonov-regularized, optionally weighted) linear least squares with
the Khatri-Rao design matrix ``A[j] = kron_k r_k(x_j)``.  The normal
equations accumulate one chunk of rows at a time (A is never
materialized beyond one chunk); the solve and every residual
diagnostic run on the host in f64.  The additive (slider) design
``[1 | A_1 | ... | A_k]`` and the TT-ALS core designs work the same way.

Sizing: the normal matrix is (G, G) with ``G = prod(n_nodes)``, capped
at ``_MAX_GRID_POINTS``; accumulation costs ``N * G**2`` flops.

Engines:

- ``"host"``: NumPy f64, a copy of the reference's loops (the same
  bits).
- ``"device"``: rows built in f32 on ``device`` and the Gram
  ``rows.T @ rows`` / ``rows.T @ y`` accumulated in IEEE f32, one chunk
  at a time.  The products must not run in TF32: on a CUDA device the
  engine refuses to run while torch's f32 matmul precision is not
  ``"highest"``.
- ``"device-dd"``: the reference's near-f64 tier.  Its digit-plane
  GEMMs and TwoSum ladders exist because the TPU has no f64; here the
  rows and the Gram are native f64 on ``device`` (an f64
  ``torch.matmul``).  As in the reference, each derivative block has its
  own accumulator and the blocks are summed in f64.
- The TT ALS ``"device"`` engine keeps the per-dim rows, both interface
  chains and the core Grams on ``device`` in f32; solves and QR run on
  the host in f64.

``mesh=`` (a ``torch.distributed`` device mesh, ``parallel.sharding``;
device engines only) accumulates data-parallel over ``data_axis``.  The
chunk boundaries do not depend on any mesh (``_fit_chunk_size``, capped
at ``_DD_MAX_CHUNK`` for ``device-dd``):

- ``"device"``: each rank takes its contiguous block of every chunk's
  rows (the chunk padded to a multiple of the axis, ``_chunk_alloc``),
  and its f32 Gram is ``all_reduce``d (SUM): within the f32 tier of the
  single-device accumulation, not bitwise.
- ``"device-dd"``: the reference's dd tier summed integers, so a sharded
  fit was bit-identical to one on a single device.  Here each chunk's
  f64 partial Gram is computed whole by one rank (chunk ``c`` by rank
  ``c mod P``), every partial is gathered to every rank, and each block
  adds them to its accumulator in chunk order from zero, exactly as the
  single device does (``_chunk_partials``): bitwise the single-device
  result at any mesh size.  Per-rank sums are never all-reduced.
- TT ``"device"``: each rank holds its contiguous block of the rows and
  their interfaces; the core Grams and the sweep's SSE are
  ``all_reduce``d (SUM).

Every rank returns the same result.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pychebyshev_tpu_torch.config import NODE_COINCIDENCE_TOL
from pychebyshev_tpu_torch.models.tt_algorithms import orth_right_core
from pychebyshev_tpu_torch.ops.chebyshev import (
    barycentric_weights_np,
    differentiation_matrix_np,
    nodes_for_dim_np,
)
from pychebyshev_tpu_torch.ops.eval import barycentric_coefficients
# The ONE row-wise Kronecker definition (pure broadcasting, so it works
# on NumPy inputs unchanged); the fitted tensor's reshape depends on its
# C-order index convention, so fitting shares it with the eval path
# rather than keep a second copy.
from pychebyshev_tpu_torch.ops.eval import _khatri_rao
from pychebyshev_tpu_torch.parallel import sharding

__all__ = ["barycentric_rows_np", "fit_dense_tensor",
           "fit_additive_tensors", "fit_tt_cores",
           "normalize_derivative_data"]

# Normal-matrix cap: 4096**2 f64 = 128 MB.
_MAX_GRID_POINTS = 4096
# Target elements per design chunk (chunk_rows * G): ~268 MB f64.
_CHUNK_ELEMS = 1 << 25


def barycentric_rows_np(x: np.ndarray, nodes: np.ndarray,
                        weights: np.ndarray) -> np.ndarray:
    """Host mirror of ``ops.eval.barycentric_coefficients``.

    (N,) coordinates -> (N, n) normalized coefficient rows; exact node
    hits (within ``NODE_COINCIDENCE_TOL``) degrade to one-hot rows.
    """
    x = np.asarray(x, dtype=np.float64)
    diff = x[:, None] - nodes[None, :]
    exact = np.abs(diff) < NODE_COINCIDENCE_TOL
    has_exact = exact.any(axis=1)
    safe = np.where(exact, 1.0, diff)
    w_over_diff = weights[None, :] / safe
    rows = w_over_diff / w_over_diff.sum(axis=1, keepdims=True)
    if has_exact.any():
        hot = np.zeros_like(rows)
        hot[np.arange(x.shape[0]), exact.argmax(axis=1)] = 1.0
        rows = np.where(has_exact[:, None], hot, rows)
    return rows


def normalize_derivative_data(derivative_data, d: int,
                              domain: Sequence[Sequence[float]],
                              n_nodes: Sequence[int]):
    """Validate derivative-observation blocks for the fitters.

    ``derivative_data`` is a sequence of blocks, each
    ``(points, orders, values)`` or ``(points, orders, values, weight)``:
    derivative observations ``d^{|orders|} f / dx^orders (points_j) =
    values_j``, all sharing one ``orders`` multi-index per block (the
    differential-machine-learning shape: AAD pathwise Greeks observed
    alongside prices).  ``weight`` (default 1.0, must be > 0) scales the
    block's squared residuals in the objective — use it to balance the
    derivative scale against the values (a common choice is
    ``var(values) / var(block values)``).

    Returns a list of ``(points (Nb, d) f64, orders tuple, values (Nb,)
    f64, weight float)`` tuples.  Model derivatives of order
    ``>= n_nodes[k]`` are identically zero (degree ``n_k - 1``
    polynomials), so such blocks are rejected rather than silently
    fitting constants against zero rows.
    """
    if derivative_data is None:
        return []
    blocks = []
    for bi, block in enumerate(derivative_data):
        if len(block) not in (3, 4):
            raise ValueError(
                f"derivative_data[{bi}] must be (points, orders, values)"
                f" or (points, orders, values, weight), got "
                f"{len(block)} elements")
        pts = np.asarray(block[0], dtype=np.float64)
        vals = np.asarray(block[2], dtype=np.float64)
        weight = float(block[3]) if len(block) == 4 else 1.0
        orders_raw = block[1]
        if len(orders_raw) != d:
            raise ValueError(
                f"derivative_data[{bi}]: orders must have length {d}, "
                f"got {len(orders_raw)}")
        orders = []
        for k, o in enumerate(orders_raw):
            if not isinstance(o, (int, np.integer)) or o < 0:
                raise ValueError(
                    f"derivative_data[{bi}]: orders[{k}] must be a "
                    f"non-negative int, got {o!r}")
            if int(o) >= int(n_nodes[k]):
                raise ValueError(
                    f"derivative_data[{bi}]: orders[{k}]={int(o)} >= "
                    f"n_nodes[{k}]={int(n_nodes[k])} — a degree-"
                    f"{int(n_nodes[k]) - 1} model's derivative of that "
                    f"order is identically zero; raise n_nodes[{k}] or "
                    f"drop the block")
            orders.append(int(o))
        if pts.ndim != 2 or pts.shape[1] != d:
            raise ValueError(
                f"derivative_data[{bi}]: points must be (N, {d}), got "
                f"{pts.shape}")
        nb = pts.shape[0]
        if nb == 0:
            raise ValueError(
                f"derivative_data[{bi}]: needs at least one sample")
        if vals.shape != (nb,):
            raise ValueError(
                f"derivative_data[{bi}]: values must be ({nb},), got "
                f"{vals.shape}")
        if not np.isfinite(pts).all():
            raise ValueError(
                f"derivative_data[{bi}]: points contain NaN or Inf")
        if not np.isfinite(vals).all():
            raise ValueError(
                f"derivative_data[{bi}]: values contain NaN or Inf")
        if not np.isfinite(weight) or weight <= 0.0:
            raise ValueError(
                f"derivative_data[{bi}]: weight must be finite and "
                f"> 0, got {weight}")
        for k in range(d):
            lo, hi = float(domain[k][0]), float(domain[k][1])
            col = pts[:, k]
            if col.min() < lo - 1e-12 or col.max() > hi + 1e-12:
                raise ValueError(
                    f"derivative_data[{bi}]: points[:, {k}] outside "
                    f"domain [{lo}, {hi}] — fitting does not "
                    f"extrapolate")
        blocks.append((pts, tuple(orders), vals, weight))
    return blocks


class _DimDesign:
    """Per-dim design-row factory with cached D^order folds.

    A derivative observation's design row along dim ``k`` is the plain
    barycentric coefficient row folded through the spectral
    differentiation matrix: ``r_k(x) @ D_k^{o_k}`` (the row form of the
    eval kernel's tensor-side ``apply_derivative_passes`` — same D, same
    one-sided node-hit semantics via the one-hot rows).
    """

    def __init__(self, nodes, weights):
        self.nodes = nodes
        self.weights = weights
        self._pows = {}

    def _dpow(self, k: int, order: int):
        base = self._pows.get((k, 1))
        if base is None:
            base = differentiation_matrix_np(self.nodes[k],
                                             self.weights[k])
            self._pows[(k, 1)] = base
        key = (k, order)
        if key not in self._pows:
            self._pows[key] = np.linalg.matrix_power(base, order)
        return self._pows[key]

    def rows(self, x: np.ndarray, k: int, order: int = 0) -> np.ndarray:
        r = barycentric_rows_np(x, self.nodes[k], self.weights[k])
        if order:
            r = r @ self._dpow(k, order)
        return r


def _capped_block_rows(blocks, counts):
    """Informative-row cap for derivative blocks (determinedness).

    ``D^o`` along dim k annihilates the degree-<o polynomial subspace,
    so a block's design rows span at most ``prod_k (n_k - o_k)``
    directions no matter how many observations it holds; counting its
    raw row count toward the ``l2 == 0`` determinedness check would
    let a rank-deficient system through to a silent min-norm solve.
    ``counts`` may be a sub-selection (the additive fitter passes one
    group's dims with the matching order slice).
    """
    total = 0
    for pts, orders, _, _ in blocks:
        span = int(np.prod([c - o for c, o in zip(counts, orders)]))
        total += min(pts.shape[0], span)
    return total


# The reference's dd tier caps its chunk at 2^15 rows (its digit
# budget, 2 * C * 2^(2b) < 2^24 with b >= 4); the port keeps the cap so
# its dd tier sums the same chunks in the same order.
_DD_MAX_CHUNK = 1 << 15


def _fit_chunk_size(grid_points, blocks, cap=None):
    """Device accumulation chunk, capped at the data size.

    Bigger chunks than the host path: each chunk is a handful of
    launches, so amortize them; (C, G) f32 intermediates at ~64 MB fit
    the device comfortably.  Cap at the largest block's row count
    rounded up to a power of two (the reference's bucketing; the chunk
    boundaries are kept so the dd tier sums in the reference's chunks).

    The chunk is deliberately MESH-INDEPENDENT: the dd tier's
    cross-chunk accumulation order, and with it the sharding contract
    of the module docstring, does not depend on any mesh.
    """
    chunk = int(max(256, (1 << 24) // max(grid_points, 1)))
    max_rows = max(pts.shape[0] for pts, _, _, _ in blocks)
    bucket = 1 << int(np.ceil(np.log2(max(max_rows, 256))))
    chunk = min(chunk, bucket)
    if cap is not None:
        chunk = min(chunk, int(cap))
    return chunk


def _chunk_alloc(chunk, mesh, data_axis):
    """Rows a chunk occupies on the mesh: rounded up to a multiple of
    the data axis so that it splits evenly (the padded rows are empty)."""
    if mesh is None:
        return chunk
    return chunk + (-chunk) % sharding.axis_size(mesh, data_axis)



def _layout_for_block(groups=None, owner=None):
    """Static design-layout key for the device steps.

    ``("dense",)`` — one Khatri-Rao block over all dims (the dense
    fit).  ``("additive", groups, owner)`` — the slider design
    ``[1 | A_1 | ... | A_k]``; ``owner`` is ``None`` for value-like
    rows or the owning group's index for differentiated blocks (zero
    intercept + zero non-owner columns, mirroring the host
    ``_block_chunk_fn``).
    """
    if groups is None:
        return ("dense",)
    return ("additive", tuple(tuple(int(x) for x in g) for g in groups),
            owner)



def _check_device_engine(name, engine, mesh, device) -> None:
    """The port's own checks of a fit call: a device engine needs an
    explicit ``device`` (the port never probes for one), and under a
    mesh it must name the mesh's device."""
    if engine != "host" and device is None:
        raise ValueError(
            f"engine={engine!r} needs an explicit device= (the port "
            f"never probes for a device)")
    if mesh is not None:
        sharding.check_device(mesh, device, name)


def _require_ieee_f32(device: torch.device) -> None:
    """Refuse to run the f32 engines' products in TF32 on a CUDA device
    (TF32 keeps about three decimal digits; the tier is IEEE f32)."""
    if (device.type == "cuda"
            and torch.get_float32_matmul_precision() != "highest"):
        raise ValueError(
            "engine='device' accumulates in IEEE float32, but torch's "
            "float32 matmul precision is "
            f"{torch.get_float32_matmul_precision()!r} (TF32); call "
            "torch.set_float32_matmul_precision('highest') first")


def _device_rows(pts, nodes, weights, dpows, layout):
    """Design rows of one chunk on the device, in the dtype of ``pts``.

    ``dpows[k]`` is the ``D^o`` fold of dim k, or ``None`` at order 0
    (the reference folds an identity there, which is exact).  ``layout``
    is :func:`_layout_for_block`'s key.
    """
    def dim_rows(k):
        rows = barycentric_coefficients(pts[:, k], nodes[k], weights[k])
        return rows if dpows[k] is None else rows @ dpows[k]

    if layout[0] == "dense":
        return _khatri_rao([dim_rows(k) for k in range(pts.shape[1])])
    _, groups, owner = layout
    n_rows = pts.shape[0]
    fill = torch.ones if owner is None else torch.zeros
    cols = [fill((n_rows, 1), dtype=pts.dtype, device=pts.device)]
    for gi, g in enumerate(groups):
        if owner is not None and gi != owner:
            size = int(np.prod([nodes[k].shape[0] for k in g]))
            cols.append(torch.zeros((n_rows, size), dtype=pts.dtype,
                                    device=pts.device))
        else:
            cols.append(_khatri_rao([dim_rows(k) for k in g]))
    return torch.cat(cols, dim=1)


def _chunk_partials(block, layout, nodes, weights, dim_design, chunk, *,
                    device, dtype):
    """Yield each chunk's partial ``(A^T A, A^T y)`` of one block, on
    ``device`` in ``dtype``, in chunk order."""
    n_rows, partial = _block_partials(block, layout, nodes, weights,
                                      dim_design, device=device, dtype=dtype)
    for start in range(0, n_rows, chunk):
        yield partial(start, start + chunk)


def _block_partials(block, layout, nodes, weights, dim_design, *, device,
                    dtype):
    """``(n_rows, partial)`` of one block: ``partial(lo, hi)`` is the
    ``(A^T A, A^T y)`` of its rows ``[lo, hi)`` on ``device`` in
    ``dtype`` (zeros for an empty range).

    ``block`` is ``(points, orders, values, sqrt_row_scale)`` (host
    NumPy); its arrays move to the device once and are sliced there.
    """
    pts, orders, vals, sqrt_scale = block
    nodes_t = [torch.as_tensor(nd, dtype=dtype, device=device)
               for nd in nodes]
    weights_t = [torch.as_tensor(w, dtype=dtype, device=device)
                 for w in weights]
    dpows = [None if orders[k] == 0 else torch.as_tensor(
        dim_design._dpow(k, orders[k]), dtype=dtype, device=device)
        for k in range(len(nodes))]
    pts_t = torch.as_tensor(pts, dtype=dtype, device=device)
    y_t = torch.as_tensor(vals, dtype=dtype, device=device)
    sw_t = torch.as_tensor(sqrt_scale, dtype=dtype, device=device)

    def partial(lo, hi):
        sl = slice(lo, hi)
        sw = sw_t[sl]
        rows = _device_rows(pts_t[sl], nodes_t, weights_t, dpows,
                            layout) * sw[:, None]
        return rows.T @ rows, rows.T @ (y_t[sl] * sw)
    return pts.shape[0], partial


def _device_normal_accumulation(blocks, nodes, weights, dim_design,
                                grid_points, layouts=None, mesh=None,
                                data_axis: str = "dp", *, device):
    """Accumulate the normal equations on ``device`` (the f32 tier).

    ``blocks`` is a list of ``(points, orders, values, sqrt_row_scale)``
    where ``sqrt_row_scale`` is the per-row sqrt-weight vector (ones
    when unweighted).  Rows are built in float32
    (``ops.eval.barycentric_coefficients``) and every chunk's Gram and
    right-hand side are added to one f32 accumulator: ~1e-4-class
    normal-matrix entries, far below Monte-Carlo noise in the huge-``N``
    regime this serves.  Under ``mesh`` each rank takes its block of
    every chunk's rows and the Gram is ``all_reduce``d over
    ``data_axis``.  Returns f64 host ``(ata, aty)``.
    """
    device = torch.device(device)
    _require_ieee_f32(device)
    chunk = _fit_chunk_size(grid_points, blocks)
    if layouts is None:
        layouts = [("dense",)] * len(blocks)
    size, rank = 1, 0
    if mesh is not None:
        size = sharding.axis_size(mesh, data_axis)
        rank = mesh.get_local_rank(data_axis)
    per = _chunk_alloc(chunk, mesh, data_axis) // size
    ata = torch.zeros((grid_points, grid_points), dtype=torch.float32,
                      device=device)
    aty = torch.zeros(grid_points, dtype=torch.float32, device=device)
    for block, layout in zip(blocks, layouts):
        n_rows, partial = _block_partials(
            block, layout, nodes, weights, dim_design, device=device,
            dtype=torch.float32)
        for start in range(0, n_rows, chunk):
            lo = start + rank * per
            d_ata, d_aty = partial(lo, max(lo, min(lo + per,
                                                   start + chunk)))
            ata += d_ata
            aty += d_aty
    if mesh is not None:
        group = mesh.get_group(data_axis)
        sharding._all_reduce(ata, group)
        sharding._all_reduce(aty, group)
    return (ata.cpu().numpy().astype(np.float64),
            aty.cpu().numpy().astype(np.float64))


def _device_normal_accumulation_dd(blocks, nodes, weights, dim_design,
                                   grid_points, layouts=None, mesh=None,
                                   data_axis: str = "dp", *, device):
    """The near-f64 tier on ``device``, in native f64.

    Same contract as :func:`_device_normal_accumulation`.  Each block
    has its own f64 accumulator, to which the chunk partials of
    :func:`_chunk_partials` are added in chunk order (the sharding
    contract of the module docstring); the blocks are summed in f64 on
    the host.  The chunk is capped at ``_DD_MAX_CHUNK`` rows, as in the
    reference, so the boundaries are the reference's.  The reference's
    refusal of a chunk without digit budget cannot trigger under that
    cap, and the digit planes it budgets are not ported.  Under ``mesh``
    the chunks are shared out and every partial is gathered, then added
    in the same order (the module note): bitwise this result.
    """
    device = torch.device(device)
    chunk = _fit_chunk_size(grid_points, blocks, cap=_DD_MAX_CHUNK)
    if layouts is None:
        layouts = [("dense",)] * len(blocks)
    ata = np.zeros((grid_points, grid_points))
    aty = np.zeros(grid_points)
    for block, layout in zip(blocks, layouts):
        b_ata = torch.zeros((grid_points, grid_points),
                            dtype=torch.float64, device=device)
        b_aty = torch.zeros(grid_points, dtype=torch.float64,
                            device=device)
        partials = (_chunk_partials(
            block, layout, nodes, weights, dim_design, chunk,
            device=device, dtype=torch.float64) if mesh is None
            else _gathered_partials(block, layout, nodes, weights,
                                    dim_design, chunk, mesh, data_axis,
                                    device=device))
        for d_ata, d_aty in partials:
            b_ata += d_ata
            b_aty += d_aty
        ata += b_ata.cpu().numpy()
        aty += b_aty.cpu().numpy()
    return ata, aty



def _gathered_partials(block, layout, nodes, weights, dim_design, chunk,
                       mesh, data_axis, *, device):
    """Yield every chunk's f64 partial of one block, in chunk order, on
    every rank of ``data_axis``: in rounds of P chunks, rank ``r``
    computes chunk ``round * P + r`` and one ``all_gather`` hands all P
    partials to every rank."""
    size = sharding.axis_size(mesh, data_axis)
    rank = mesh.get_local_rank(data_axis)
    group = mesh.get_group(data_axis)
    n_rows, partial = _block_partials(block, layout, nodes, weights,
                                      dim_design, device=device,
                                      dtype=torch.float64)
    n_chunks = -(-n_rows // chunk)
    for first in range(0, n_chunks, size):
        lo = (first + rank) * chunk
        d_ata, d_aty = partial(lo, max(lo, min(lo + chunk, n_rows)))
        both = sharding._all_gather_rows(
            torch.cat([d_ata, d_aty[None, :]])[None], group, size)
        for c in range(min(size, n_chunks - first)):
            yield both[c, :-1], both[c, -1]


def _block_residual_stats(design_chunk_fn, sol, pts, vals, chunk):
    """Chunked unweighted residual stats for one derivative block."""
    sse = 0.0
    max_abs = 0.0
    nb = pts.shape[0]
    for start in range(0, nb, chunk):
        sl = slice(start, min(start + chunk, nb))
        res = design_chunk_fn(sl) @ sol - vals[sl]
        sse += float(np.sum(res * res))
        max_abs = max(max_abs, float(np.max(np.abs(res))))
    return sse, max_abs


def fit_dense_tensor(
    points: np.ndarray,
    values: np.ndarray,
    domain: Sequence[Sequence[float]],
    n_nodes: Sequence[int],
    *,
    l2: float = 0.0,
    sample_weight: Optional[np.ndarray] = None,
    rcond: Optional[float] = None,
    derivative_data=None,
    engine: str = "host",
    mesh=None,
    data_axis: str = "dp",
    device=None,
) -> Tuple[np.ndarray, dict]:
    """Solve the scattered-data least-squares fit for a dense grid.

    Parameters
    ----------
    points : (N, d) sample coordinates, finite, inside ``domain``.
    values : (N,) sample values, finite.
    domain : d pairs (lo, hi).
    n_nodes : d positive ints (explicit; no auto-N).
    l2 : Tikhonov penalty ``l2 * ||T||^2`` on the nodal values.
        Required (> 0) when N < prod(n_nodes).
    sample_weight : optional (N,) non-negative per-sample weights
        (weighted SSE ``sum w_j (f(x_j) - y_j)^2``).
    rcond : cutoff for the pseudoinverse solve used when ``l2 == 0``
        (forwarded to ``np.linalg.lstsq``).
    derivative_data : optional derivative-observation blocks
        ``[(points_b, orders_b, values_b[, weight_b]), ...]`` (see
        :func:`normalize_derivative_data`) — gradient-enhanced fitting:
        each block adds rows ``kron_k (r_k(x) @ D_k^{o_k})`` to the
        same linear system, so AAD/pathwise Greeks tighten the fit at
        no structural cost.  Block rows count toward the
        determinedness requirement.

    Returns
    -------
    (tensor, diagnostics): the (n_1, ..., n_d) nodal-value tensor and a
    dict with ``rms`` (weighted training rms over the VALUE samples),
    ``max_abs_residual`` (unweighted |residual| max, excluding
    zero-weight samples), ``n_samples``, ``grid_points``, ``l2``,
    ``rank`` (None for the Cholesky path).  With derivative blocks:
    ``derivative_blocks`` (per-block unweighted ``rms`` /
    ``max_abs_residual`` / ``orders`` / ``weight`` / ``n_samples``) and
    ``objective_sse`` (the full weighted objective).

    ``engine="device"`` accumulates the normal equations on ``device``
    in IEEE f32 (:func:`_device_normal_accumulation`); use it for huge
    noisy datasets, where its ~1e-4-class normal-matrix rounding sits
    far below the sampling noise.  ``engine="device-dd"`` accumulates
    in native f64 on ``device`` (:func:`_device_normal_accumulation_dd`):
    f64-class normal equations, the device engine for exact-recovery
    and tight-noise fits.  The default ``"host"`` engine stays exact
    f64.  Residual diagnostics are computed on host in f64 for every
    engine.  ``device`` is required by the device engines.

    ``mesh`` (device engines): data-parallel accumulation over
    ``data_axis`` (the module note); every rank returns the same fit.
    """
    points = np.asarray(points, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    d = len(n_nodes)
    if len(domain) != d:
        raise ValueError(
            f"len(domain)={len(domain)} must equal len(n_nodes)={d}")
    if points.ndim != 2 or points.shape[1] != d:
        raise ValueError(
            f"points must be (N, {d}), got {points.shape}")
    n_samples = points.shape[0]
    if values.shape != (n_samples,):
        raise ValueError(
            f"values must be ({n_samples},), got {values.shape}")
    if n_samples == 0:
        raise ValueError("need at least one sample")
    if not np.isfinite(points).all():
        raise ValueError("points contain NaN or Inf")
    if not np.isfinite(values).all():
        raise ValueError("values contain NaN or Inf")
    l2 = float(l2)
    if l2 < 0.0 or not np.isfinite(l2):
        raise ValueError(f"l2 must be finite and >= 0, got {l2}")
    if engine not in ("host", "device", "device-dd"):
        raise ValueError(
            f"engine must be 'host', 'device' or 'device-dd', got "
            f"{engine!r}")
    if mesh is not None and engine == "host":
        raise ValueError(
            "mesh= requires a device engine ('device' or "
            "'device-dd'); the host engine is single-process f64")
    _check_device_engine("fit_dense_tensor", engine, mesh, device)
    if engine == "device" and l2 == 0.0:
        # Exactly-determined systems squared through an f32-tier A^T A
        # (cond ~ squared) can lose most of the recovered accuracy;
        # the host engine is the exact-recovery path (docstring).
        warnings.warn(
            "engine='device' accumulates the normal equations in the "
            "f32 tier; an exact-recovery (l2=0) fit should use "
            "engine='host' (f64) unless sampling noise dominates.",
            UserWarning, stacklevel=3)

    counts: List[int] = []
    for k, n in enumerate(n_nodes):
        if not isinstance(n, (int, np.integer)) or n < 1:
            raise ValueError(
                f"n_nodes[{k}] must be a positive int, got {n!r}")
        counts.append(int(n))
    grid_points = int(np.prod(counts))
    if grid_points > _MAX_GRID_POINTS:
        raise ValueError(
            f"prod(n_nodes)={grid_points} exceeds the fit solver cap "
            f"({_MAX_GRID_POINTS}); fit a coarser grid (then refine "
            f"with to_tt/spline composition) — the normal matrix is "
            f"dense (G, G)"
        )
    for k in range(d):
        lo, hi = float(domain[k][0]), float(domain[k][1])
        if not (lo < hi):
            raise ValueError(
                f"domain[{k}]: lo={lo} must be strictly less than "
                f"hi={hi}")
        col = points[:, k]
        if col.min() < lo - 1e-12 or col.max() > hi + 1e-12:
            raise ValueError(
                f"points[:, {k}] outside domain [{lo}, {hi}] — "
                f"fitting does not extrapolate; clip or widen the "
                f"domain"
            )
    if sample_weight is not None:
        sample_weight = np.asarray(sample_weight, dtype=np.float64)
        if sample_weight.shape != (n_samples,):
            raise ValueError(
                f"sample_weight must be ({n_samples},), got "
                f"{sample_weight.shape}")
        if not np.isfinite(sample_weight).all() or (
                sample_weight < 0).any():
            raise ValueError(
                "sample_weight must be finite and non-negative")
        if not (sample_weight > 0).any():
            raise ValueError("sample_weight must not be all zero")
    blocks = normalize_derivative_data(derivative_data, d, domain, counts)
    informative = (min(n_samples, grid_points)
                   + _capped_block_rows(blocks, counts))
    if l2 == 0.0 and informative < grid_points:
        raise ValueError(
            f"underdetermined fit: {informative} informative rows "
            f"(value samples + derivative observations capped at their "
            f"D^o rank) < {grid_points} grid values; pass l2 > 0 or "
            f"add samples"
        )

    nodes = [nodes_for_dim_np(float(domain[k][0]), float(domain[k][1]),
                              counts[k]) for k in range(d)]
    weights = [barycentric_weights_np(nd) for nd in nodes]
    dim_design = _DimDesign(nodes, weights)

    chunk = max(1024, _CHUNK_ELEMS // max(grid_points, 1))

    def _block_chunk_fn(pts, orders=(0,) * d):
        def fn(sl):
            return _khatri_rao([
                dim_design.rows(pts[sl, k], k, orders[k])
                for k in range(d)
            ])
        return fn

    # The value design is the all-zero-orders special case.
    _design_chunk = _block_chunk_fn(points)

    if engine in ("device", "device-dd"):
        ones = (np.sqrt(sample_weight) if sample_weight is not None
                else np.ones(n_samples))
        spec = [(points, (0,) * d, values, ones)]
        spec += [(pts, orders, vals,
                  np.full(pts.shape[0], np.sqrt(weight)))
                 for pts, orders, vals, weight in blocks]
        accumulate = (_device_normal_accumulation_dd
                      if engine == "device-dd"
                      else _device_normal_accumulation)
        ata, aty = accumulate(spec, nodes, weights, dim_design,
                              grid_points, mesh=mesh, data_axis=data_axis,
                              device=device)
    else:
        ata = np.zeros((grid_points, grid_points))
        aty = np.zeros(grid_points)
        for start in range(0, n_samples, chunk):
            sl = slice(start, min(start + chunk, n_samples))
            rows = _design_chunk(sl)
            y = values[sl]
            if sample_weight is not None:
                sw = np.sqrt(sample_weight[sl])
                rows = rows * sw[:, None]
                y = y * sw
            ata += rows.T @ rows
            aty += rows.T @ y
        for pts, orders, vals, weight in blocks:
            block_fn = _block_chunk_fn(pts, orders)
            for start in range(0, pts.shape[0], chunk):
                sl = slice(start, min(start + chunk, pts.shape[0]))
                rows = block_fn(sl) * np.sqrt(weight)
                ata += rows.T @ rows
                aty += rows.T @ (vals[sl] * np.sqrt(weight))

    rank = None
    min_norm = False
    if l2 > 0.0:
        solve_mat = ata + l2 * np.eye(grid_points)
        try:
            flat = np.linalg.solve(solve_mat, aty)
        except np.linalg.LinAlgError:
            flat, _, rank, _ = np.linalg.lstsq(solve_mat, aty,
                                               rcond=rcond)
    else:
        flat, _, rank, _ = np.linalg.lstsq(ata, aty, rcond=rcond)
        # The informative-row gate above is a rank UPPER bound only:
        # duplicated points (or a zero-order derivative block repeating
        # the value samples) double-count, pass the gate, and land
        # here rank-deficient — in which case lstsq silently returned
        # the min-norm solution.  Surface it.
        if rank is not None and rank < grid_points:
            min_norm = True
            warnings.warn(
                f"fit is rank-deficient ({rank} < {grid_points} grid "
                f"values) despite passing the informative-row check "
                f"(e.g. duplicated sample points); the solution is the "
                f"minimum-norm one. Pass l2 > 0 or deduplicate "
                f"samples.", UserWarning, stacklevel=3)

    # Training residuals: one exact chunked re-pass over ALL samples
    # (O(N*G) — negligible next to the O(N*G^2) accumulation, and it
    # avoids the catastrophic cancellation of the t'AtAt - 2t'Aty + yty
    # quadratic form on near-exact fits).  max_abs_residual is the
    # unweighted |residual|, excluding zero-weight samples (they do not
    # participate in the fit); sse/rms are weighted.
    sse = 0.0
    max_abs = 0.0
    for start in range(0, n_samples, chunk):
        sl = slice(start, min(start + chunk, n_samples))
        res = _design_chunk(sl) @ flat - values[sl]
        if sample_weight is not None:
            sw = sample_weight[sl]
            sse += float(np.sum(sw * res * res))
            live = sw > 0
            if live.any():
                max_abs = max(max_abs, float(np.max(np.abs(res[live]))))
        else:
            sse += float(np.sum(res * res))
            max_abs = max(max_abs, float(np.max(np.abs(res))))
    w_total = (float(np.sum(sample_weight)) if sample_weight is not None
               else float(n_samples))
    diagnostics = {
        "rms": float(np.sqrt(sse / w_total)) if w_total > 0 else 0.0,
        "sse": sse,
        "n_samples": n_samples,
        "grid_points": grid_points,
        "l2": l2,
        "rank": None if rank is None else int(rank),
        "max_abs_residual": max_abs,
        "engine": engine,
        "min_norm": min_norm,
    }
    if blocks:
        block_diags = []
        objective_sse = sse
        for pts, orders, vals, weight in blocks:
            b_sse, b_max = _block_residual_stats(
                _block_chunk_fn(pts, orders), flat, pts, vals, chunk)
            objective_sse += weight * b_sse
            block_diags.append({
                "orders": list(orders),
                "n_samples": int(pts.shape[0]),
                "weight": weight,
                "rms": float(np.sqrt(b_sse / pts.shape[0])),
                "max_abs_residual": b_max,
            })
        diagnostics["derivative_blocks"] = block_diags
        diagnostics["objective_sse"] = objective_sse
    return flat.reshape(tuple(counts)), diagnostics


def fit_additive_tensors(
    points: np.ndarray,
    values: np.ndarray,
    domain: Sequence[Sequence[float]],
    n_nodes: Sequence[int],
    groups: Sequence[Sequence[int]],
    *,
    l2: float = 0.0,
    sample_weight: Optional[np.ndarray] = None,
    rcond: Optional[float] = None,
    derivative_data=None,
    engine: str = "host",
    mesh=None,
    data_axis: str = "dp",
    device=None,
) -> Tuple[List[np.ndarray], float, dict]:
    """Scattered-data least squares for an ADDITIVE (slider) model.

    Fits ``f(x) ~ c0 + sum_i h_i(x_{G_i})`` where each ``h_i`` is a
    dense Chebyshev interpolant over its group's dims — jointly linear
    in (c0, all nodal tensors), so the whole high-dimensional additive
    fit is ONE small solve: the design is ``[1 | A_1 | ... | A_k]``
    with per-group Khatri-Rao blocks, ``P = 1 + sum_i prod(n[G_i])``
    columns (e.g. five 2-dim groups of 7 nodes in 10-D: 246 columns —
    where a dense 10-D fit is impossible).  The additive decomposition
    carries k inherent constant redundancies (a constant moves freely
    between blocks and the intercept); the ``l2 = 0`` path resolves
    them with the pseudoinverse's minimum-norm solution and callers
    re-gauge (``ChebyshevSlider.fit`` pins every slide to the pivot).

    Returns ``(tensors, c0, diagnostics)`` — one (n[g] ...) tensor per
    group, the intercept, and the same diagnostics dict as
    ``fit_dense_tensor`` (plus ``columns``); residual semantics match
    it (weighted rms over all samples; unweighted max excluding
    zero-weight samples).

    ``derivative_data`` blocks (see :func:`normalize_derivative_data`)
    must differentiate dims of at most ONE group: the additive model's
    cross-group mixed partials are identically zero (the same exact-zero
    rule the slider eval router applies), so such observations carry no
    information about the unknowns and are rejected.  A block owning
    group ``G_i`` contributes rows that are zero outside ``G_i``'s
    columns (and zero in the intercept column for any differentiated
    block).

    ``engine`` / ``mesh`` / ``data_axis`` / ``device``: as in
    :func:`fit_dense_tensor` — the additive design accumulates on
    ``device`` through the same f32 or f64 chunk machinery (the
    concatenated ``[1 | A_i]`` layout is a row-build variant).
    """
    points = np.asarray(points, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    d = len(n_nodes)
    if len(domain) != d:
        raise ValueError(
            f"len(domain)={len(domain)} must equal len(n_nodes)={d}")
    if points.ndim != 2 or points.shape[1] != d:
        raise ValueError(f"points must be (N, {d}), got {points.shape}")
    n_samples = points.shape[0]
    if values.shape != (n_samples,):
        raise ValueError(
            f"values must be ({n_samples},), got {values.shape}")
    if n_samples == 0:
        raise ValueError("need at least one sample")
    if not np.isfinite(points).all():
        raise ValueError("points contain NaN or Inf")
    if not np.isfinite(values).all():
        raise ValueError("values contain NaN or Inf")
    l2 = float(l2)
    if l2 < 0.0 or not np.isfinite(l2):
        raise ValueError(f"l2 must be finite and >= 0, got {l2}")
    if any(len(g) == 0 for g in groups):
        raise ValueError("groups must be non-empty")
    flat_dims = sorted(dim for g in groups for dim in g)
    if flat_dims != list(range(d)):
        raise ValueError(
            f"groups must cover dims 0..{d - 1} exactly once, got "
            f"{flat_dims}")

    counts: List[int] = []
    for k, n in enumerate(n_nodes):
        if not isinstance(n, (int, np.integer)) or n < 1:
            raise ValueError(
                f"n_nodes[{k}] must be a positive int, got {n!r}")
        counts.append(int(n))
    group_sizes = [int(np.prod([counts[dim] for dim in g]))
                   for g in groups]
    columns = 1 + int(np.sum(group_sizes))
    if columns > _MAX_GRID_POINTS:
        raise ValueError(
            f"additive design has {columns} columns, exceeding the fit "
            f"solver cap ({_MAX_GRID_POINTS}); reduce group node counts"
        )
    for k in range(d):
        lo, hi = float(domain[k][0]), float(domain[k][1])
        if not (lo < hi):
            raise ValueError(
                f"domain[{k}]: lo={lo} must be strictly less than "
                f"hi={hi}")
        col = points[:, k]
        if col.min() < lo - 1e-12 or col.max() > hi + 1e-12:
            raise ValueError(
                f"points[:, {k}] outside domain [{lo}, {hi}] — "
                f"fitting does not extrapolate; clip or widen the "
                f"domain"
            )
    if sample_weight is not None:
        sample_weight = np.asarray(sample_weight, dtype=np.float64)
        if sample_weight.shape != (n_samples,):
            raise ValueError(
                f"sample_weight must be ({n_samples},), got "
                f"{sample_weight.shape}")
        if not np.isfinite(sample_weight).all() or (
                sample_weight < 0).any():
            raise ValueError(
                "sample_weight must be finite and non-negative")
        if not (sample_weight > 0).any():
            raise ValueError("sample_weight must not be all zero")
    deriv_blocks = normalize_derivative_data(derivative_data, d, domain,
                                             counts)
    dim_to_group = {}
    for gi, g in enumerate(groups):
        for dim in g:
            dim_to_group[dim] = gi
    block_owner: List[Optional[int]] = []
    for bi, (_, orders, _, _) in enumerate(deriv_blocks):
        owner_set = {dim_to_group[k] for k, o in enumerate(orders) if o}
        if len(owner_set) > 1:
            raise ValueError(
                f"derivative_data[{bi}]: orders differentiate dims in "
                f"{len(owner_set)} groups — the additive model's "
                f"cross-group mixed partials are identically zero, so "
                f"the observation is uninformative; split it into "
                f"single-group blocks")
        block_owner.append(owner_set.pop() if owner_set else None)

    # Effective dof excludes the k constant redundancies.
    dof = columns - len(groups)
    # Determinedness (l2 == 0): differentiated blocks inform ONLY the
    # owner group's columns, and at most prod_{dim in g}(n_dim - o_dim)
    # directions there (D^o annihilates low degrees); undifferentiated
    # blocks act as additional value rows.  Both a global and a
    # per-group necessary condition are enforced — raw row totals would
    # let a structurally rank-deficient system through to a silent
    # min-norm solve (e.g. one starved group).
    value_like = n_samples + sum(
        pts.shape[0] for (pts, _, _, _), owner
        in zip(deriv_blocks, block_owner) if owner is None)
    owned_caps = [0] * len(groups)
    for (pts, orders, _, _), owner in zip(deriv_blocks, block_owner):
        if owner is not None:
            span = int(np.prod([counts[dim] - orders[dim]
                                for dim in groups[owner]]))
            owned_caps[owner] += min(pts.shape[0], span)
    if l2 == 0.0:
        informative = min(value_like, dof) + sum(owned_caps)
        if informative < dof:
            raise ValueError(
                f"underdetermined fit: {informative} informative rows "
                f"(value-like samples + derivative observations capped "
                f"at their D^o rank) < {dof} effective unknowns; pass "
                f"l2 > 0 or add samples"
            )
        for gi, size in enumerate(group_sizes):
            have = value_like + owned_caps[gi]
            if have < size - 1:
                raise ValueError(
                    f"underdetermined fit: group {gi} "
                    f"(dims {list(groups[gi])}) is informed by only "
                    f"{have} rows for its {size} nodal values; "
                    f"derivative observations for other groups cannot "
                    f"constrain it — pass l2 > 0 or add samples"
                )

    nodes = [nodes_for_dim_np(float(domain[k][0]), float(domain[k][1]),
                              counts[k]) for k in range(d)]
    weights = [barycentric_weights_np(nd) for nd in nodes]
    dim_design = _DimDesign(nodes, weights)

    def _block_chunk_fn(pts, orders=(0,) * d, owner=None):
        # owner None: ordinary additive row (the value design and
        # undifferentiated blocks).  Differentiated blocks zero the
        # intercept and every non-owner group's columns.
        def fn(sl):
            n_rows = pts[sl].shape[0]
            cols = [np.ones((n_rows, 1)) if owner is None
                    else np.zeros((n_rows, 1))]
            for gi, g in enumerate(groups):
                if owner is not None and gi != owner:
                    cols.append(np.zeros((n_rows, group_sizes[gi])))
                else:
                    cols.append(_khatri_rao([
                        dim_design.rows(pts[sl, dim], dim, orders[dim])
                        for dim in g
                    ]))
            return np.concatenate(cols, axis=1)
        return fn

    _design_chunk = _block_chunk_fn(points)

    if engine not in ("host", "device", "device-dd"):
        raise ValueError(
            f"engine must be 'host', 'device' or 'device-dd', got "
            f"{engine!r}")
    if mesh is not None and engine == "host":
        raise ValueError(
            "mesh= requires a device engine ('device' or "
            "'device-dd'); the host engine is single-process f64")
    _check_device_engine("fit_additive_tensors", engine, mesh, device)
    chunk = max(1024, _CHUNK_ELEMS // max(columns, 1))
    if engine in ("device", "device-dd"):
        ones = (np.sqrt(sample_weight) if sample_weight is not None
                else np.ones(n_samples))
        spec = [(points, (0,) * d, values, ones)]
        layouts = [_layout_for_block(groups, None)]
        for (pts, orders, vals, weight), owner in zip(deriv_blocks,
                                                      block_owner):
            spec.append((pts, orders, vals,
                         np.full(pts.shape[0], np.sqrt(weight))))
            layouts.append(_layout_for_block(groups, owner))
        accumulate = (_device_normal_accumulation_dd
                      if engine == "device-dd"
                      else _device_normal_accumulation)
        ata, aty = accumulate(spec, nodes, weights, dim_design,
                              columns, layouts, mesh=mesh,
                              data_axis=data_axis, device=device)
    else:
        ata = np.zeros((columns, columns))
        aty = np.zeros(columns)
        for start in range(0, n_samples, chunk):
            sl = slice(start, min(start + chunk, n_samples))
            rows = _design_chunk(sl)
            y = values[sl]
            if sample_weight is not None:
                sw = np.sqrt(sample_weight[sl])
                rows = rows * sw[:, None]
                y = y * sw
            ata += rows.T @ rows
            aty += rows.T @ y
        for (pts, orders, vals, weight), owner in zip(deriv_blocks,
                                                      block_owner):
            block_fn = _block_chunk_fn(pts, orders, owner)
            for start in range(0, pts.shape[0], chunk):
                sl = slice(start, min(start + chunk, pts.shape[0]))
                rows = block_fn(sl) * np.sqrt(weight)
                ata += rows.T @ rows
                aty += rows.T @ (vals[sl] * np.sqrt(weight))

    rank = None
    if l2 > 0.0:
        reg = np.full(columns, l2)
        reg[0] = 0.0  # never penalize the intercept
        solve_mat = ata + np.diag(reg)
        try:
            theta = np.linalg.solve(solve_mat, aty)
        except np.linalg.LinAlgError:
            theta, _, rank, _ = np.linalg.lstsq(solve_mat, aty,
                                                rcond=rcond)
    else:
        theta, _, rank, _ = np.linalg.lstsq(ata, aty, rcond=rcond)

    sse = 0.0
    max_abs = 0.0
    for start in range(0, n_samples, chunk):
        sl = slice(start, min(start + chunk, n_samples))
        res = _design_chunk(sl) @ theta - values[sl]
        if sample_weight is not None:
            sw = sample_weight[sl]
            sse += float(np.sum(sw * res * res))
            live = sw > 0
            if live.any():
                max_abs = max(max_abs, float(np.max(np.abs(res[live]))))
        else:
            sse += float(np.sum(res * res))
            max_abs = max(max_abs, float(np.max(np.abs(res))))
    w_total = (float(np.sum(sample_weight)) if sample_weight is not None
               else float(n_samples))

    c0 = float(theta[0])
    tensors, offset = [], 1
    for g, size in zip(groups, group_sizes):
        shape = tuple(counts[dim] for dim in g)
        tensors.append(theta[offset:offset + size].reshape(shape))
        offset += size
    diagnostics = {
        "rms": float(np.sqrt(sse / w_total)) if w_total > 0 else 0.0,
        "sse": sse,
        "n_samples": n_samples,
        "columns": columns,
        "l2": l2,
        "rank": None if rank is None else int(rank),
        "max_abs_residual": max_abs,
        "engine": engine,
    }
    if deriv_blocks:
        block_diags = []
        objective_sse = sse
        for (pts, orders, vals, weight), owner in zip(deriv_blocks,
                                                      block_owner):
            b_sse, b_max = _block_residual_stats(
                _block_chunk_fn(pts, orders, owner), theta, pts, vals,
                chunk)
            objective_sse += weight * b_sse
            block_diags.append({
                "orders": list(orders),
                "n_samples": int(pts.shape[0]),
                "weight": weight,
                "rms": float(np.sqrt(b_sse / pts.shape[0])),
                "max_abs_residual": b_max,
            })
        diagnostics["derivative_blocks"] = block_diags
        diagnostics["objective_sse"] = objective_sse
    return tensors, c0, diagnostics



# --------------------------------------------------------------------------
# TT-ALS on the device.
#
# Profiled in the reference (host, 5-D rank-5 n=7, N = 5e5 x 3 sweeps):
# the per-core design rows and Gram accumulation take ~75% of the wall
# time and the interface chains another ~21%; the core solves are
# 0.02 s.  The device engine keeps the f32 per-dim rows and both
# interface chains resident on the device, forms each chunk's
# (C, r*n*r) design only there, and accumulates A^T A / A^T y in IEEE
# f32 -- the dense device engine's precision (noise-dominated huge-N
# fits; exact-recovery fits stay on the host engine).  Solves and QR
# stay host f64.
# --------------------------------------------------------------------------


def _tt_als_sweeps_device(rows, y_all, sqrt_w, cores, ranks, counts,
                          l2, sweeps, w_total, mesh=None,
                          data_axis: str = "dp", *, device):
    """The ALS sweep loop with device-resident rows, interfaces and
    Grams.

    Same iteration structure and early-stop criterion as the host loop
    in :func:`fit_tt_cores`; returns (cores, ranks, sweep_rms) with
    cores as host f64 arrays (solves and QR run on the host).  Under
    ``mesh`` each rank holds its contiguous block of the rows and the
    Grams and the SSE are ``all_reduce``d over ``data_axis``."""
    device = torch.device(device)
    _require_ieee_f32(device)
    f32 = torch.float32
    d = len(rows)
    n = rows[0].shape[0]
    if sqrt_w is None:
        sqrt_w = np.ones(n)
    group = None
    if mesh is not None:
        size = sharding.axis_size(mesh, data_axis)
        per = -(-n // size)
        lo = min(n, mesh.get_local_rank(data_axis) * per)
        sl = slice(lo, min(n, lo + per))
        rows = [r[sl] for r in rows]
        y_all, sqrt_w = y_all[sl], sqrt_w[sl]
        n = rows[0].shape[0]
        group = mesh.get_group(data_axis)

    def reduce(t):
        return t if group is None else sharding._all_reduce(t, group)
    rows_dev = [torch.as_tensor(r, dtype=f32, device=device) for r in rows]
    y_dev = torch.as_tensor(y_all, dtype=f32, device=device)
    sw_dev = torch.as_tensor(sqrt_w, dtype=f32, device=device)
    ones_dev = torch.ones((n, 1), dtype=f32, device=device)

    def core_dev(k):
        return torch.as_tensor(cores[k], dtype=f32, device=device)

    def iface_right(interface, rows_k, core):
        m = torch.einsum("ni,aib->nab", rows_k, core)
        return torch.einsum("nab,nb->na", m, interface)

    def iface_left(interface, rows_k, core):
        m = torch.einsum("ni,aib->nab", rows_k, core)
        return torch.einsum("na,nab->nb", interface, m)

    chunk = max(8192, (1 << 23) // max(
        max(ranks[k] * counts[k] * ranks[k + 1] for k in range(d)), 1))

    sweep_rms: List[float] = []
    for sweep in range(int(sweeps)):
        right = [None] * (d + 1)
        right[d] = ones_dev
        for k in range(d - 1, 0, -1):
            right[k] = iface_right(right[k + 1], rows_dev[k], core_dev(k))
        left = ones_dev
        for k in range(d):
            r0, nk, r1 = ranks[k], counts[k], ranks[k + 1]
            p_cols = r0 * nk * r1
            ata = torch.zeros((p_cols, p_cols), dtype=f32, device=device)
            aty = torch.zeros(p_cols, dtype=f32, device=device)
            for start in range(0, n, chunk):
                sl = slice(start, start + chunk)
                sw = sw_dev[sl]
                design = torch.einsum(
                    "na,ni,nb->naib", left[sl], rows_dev[k][sl],
                    right[k + 1][sl]).reshape(-1, p_cols) * sw[:, None]
                ata += design.T @ design
                aty += design.T @ (y_dev[sl] * sw)
            ata64 = reduce(ata).cpu().numpy().astype(np.float64)
            aty64 = reduce(aty).cpu().numpy().astype(np.float64)
            if l2 > 0.0:
                ata64 = ata64 + l2 * np.eye(p_cols)
            try:
                sol = np.linalg.solve(ata64, aty64)
            except np.linalg.LinAlgError:
                sol, _, _, _ = np.linalg.lstsq(ata64, aty64, rcond=None)
            cores[k] = sol.reshape(r0, nk, r1)
            if k < d - 1:
                rm, nm, r1m = cores[k].shape
                q, rr = np.linalg.qr(cores[k].reshape(rm * nm, r1m))
                cores[k] = q.reshape(rm, nm, q.shape[1])
                cores[k + 1] = np.einsum("ij,jpk->ipk", rr, cores[k + 1])
                ranks[k + 1] = cores[k].shape[2]
                left = iface_left(left, rows_dev[k], core_dev(k))
        m = torch.einsum("ni,aib->nab", rows_dev[d - 1], core_dev(d - 1))
        preds = torch.einsum("nb,nb->n",
                             torch.einsum("na,nab->nb", left, m),
                             right[d])
        res = ((preds - y_dev) * sw_dev).to(torch.float64)
        sse = float(reduce((res * res).sum()))
        sweep_rms.append(float(np.sqrt(sse / w_total)))
        if sweep > 0 and sweep_rms[-2] - sweep_rms[-1] < (
                1e-4 * max(sweep_rms[-2], 1e-300)):
            break
    return cores, ranks, sweep_rms


def _tt_chain_preds(rows, cores) -> np.ndarray:
    """Host-f64 per-row predictions of a value-core chain (one
    interface pass; used for the device engine's exact diagnostics)."""
    u = np.ones((rows[0].shape[0], 1))
    for k, core in enumerate(cores):
        m = np.einsum("ni,aib->nab", rows[k], core)
        u = np.einsum("na,nab->nb", u, m)
    return u[:, 0]


def fit_tt_cores(
    points: np.ndarray,
    values: np.ndarray,
    domain: Sequence[Sequence[float]],
    n_nodes: Sequence[int],
    *,
    max_rank: int = 5,
    l2: float = 1e-10,
    sweeps: int = 10,
    seed: int = 0,
    sample_weight: Optional[np.ndarray] = None,
    derivative_data=None,
    engine: str = "host",
    mesh=None,
    data_axis: str = "dp",
    device=None,
) -> Tuple[List[np.ndarray], dict]:
    """Scattered-data TT completion via alternating least squares.

    Fits a tensor-train of VALUE cores to arbitrary in-domain samples:
    holding all cores but one fixed, the model is linear in that core
    (design row ``kron(L_j, r_k(x_j), R_j)`` with per-sample left/right
    interface vectors), so each ALS step is a small regularized solve;
    sweeps run left-to-right with QR re-orthogonalization after every
    core (interfaces stay well-conditioned, the standard TT-ALS
    discipline — cf. the grid-based ``tt_algorithms.tt_als``).

    Unlike the dense/additive fits this objective is NONCONVEX (the TT
    manifold): convergence is to a local optimum dependent on the
    random init (``seed``).  Low-rank-representable targets recover
    reliably; check ``diagnostics['rms']`` (per-sweep history in
    ``diagnostics['sweep_rms']``) against the noise level and re-seed
    or raise ``max_rank`` when it plateaus high.

    Returns ``(value_cores, diagnostics)`` — cores are
    ``(r_{k-1}, n_k, r_k)`` value-space tensors (convert with
    ``tt_algorithms.value_core_to_coeff_core``).

    ``derivative_data`` blocks (see :func:`normalize_derivative_data`)
    compose freely with the TT structure: a derivative observation's
    per-dim design row is the barycentric row folded through
    ``D_k^{o_k}``, so the blocks simply STACK onto the sample set (per-
    row weights carry the block weights) and every ALS core solve sees
    them as additional rows.  ``sweep_rms`` then tracks the full
    weighted objective; the returned ``rms`` / ``max_abs_residual``
    stay value-block-only with per-block stats in
    ``derivative_blocks``.

    ``engine="device"`` runs the sweep's dominant terms — the per-core
    design-row materialization, the Gram products, and both interface
    chains — on ``device`` in IEEE f32, with solves/QR on the host.
    Same accuracy caveat as the dense device engine: for
    noise-dominated huge-N fits; exact-recovery fits stay on
    ``"host"``.  ``mesh=`` shards the rows over ``data_axis`` (the
    module note).  Residual diagnostics are host f64 for every engine.
    """
    if engine not in ("host", "device"):
        raise ValueError(
            f"engine must be 'host' or 'device', got {engine!r}")
    if mesh is not None and engine == "host":
        raise ValueError(
            "mesh= requires engine='device'; the host engine is "
            "single-process f64")
    _check_device_engine("fit_tt_cores", engine, mesh, device)
    if engine == "device" and l2 == 0.0:
        warnings.warn(
            "engine='device' accumulates the normal equations in the "
            "f32 tier (~1e-4-class Gram entries); prefer "
            "engine='host' (f64) unless sampling noise dominates.",
            RuntimeWarning, stacklevel=2)
    points = np.asarray(points, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    d = len(n_nodes)
    if d < 2:
        raise ValueError("TT fit needs at least 2 dimensions")
    if len(domain) != d:
        raise ValueError(
            f"len(domain)={len(domain)} must equal len(n_nodes)={d}")
    if points.ndim != 2 or points.shape[1] != d:
        raise ValueError(f"points must be (N, {d}), got {points.shape}")
    n_samples = points.shape[0]
    if values.shape != (n_samples,):
        raise ValueError(
            f"values must be ({n_samples},), got {values.shape}")
    if n_samples == 0:
        raise ValueError("need at least one sample")
    if not np.isfinite(points).all():
        raise ValueError("points contain NaN or Inf")
    if not np.isfinite(values).all():
        raise ValueError("values contain NaN or Inf")
    l2 = float(l2)
    if l2 < 0.0 or not np.isfinite(l2):
        raise ValueError(f"l2 must be finite and >= 0, got {l2}")
    if not isinstance(max_rank, (int, np.integer)) or max_rank < 1:
        raise ValueError(f"max_rank must be a positive int, got "
                         f"{max_rank!r}")
    if not isinstance(sweeps, (int, np.integer)) or sweeps < 1:
        raise ValueError(f"sweeps must be a positive int, got {sweeps!r}")
    counts: List[int] = []
    for k, n in enumerate(n_nodes):
        if not isinstance(n, (int, np.integer)) or n < 1:
            raise ValueError(
                f"n_nodes[{k}] must be a positive int, got {n!r}")
        counts.append(int(n))
    for k in range(d):
        lo, hi = float(domain[k][0]), float(domain[k][1])
        if not (lo < hi):
            raise ValueError(
                f"domain[{k}]: lo={lo} must be strictly less than "
                f"hi={hi}")
        col = points[:, k]
        if col.min() < lo - 1e-12 or col.max() > hi + 1e-12:
            raise ValueError(
                f"points[:, {k}] outside domain [{lo}, {hi}] — "
                f"fitting does not extrapolate; clip or widen the "
                f"domain"
            )
    if sample_weight is not None:
        sample_weight = np.asarray(sample_weight, dtype=np.float64)
        if sample_weight.shape != (n_samples,):
            raise ValueError(
                f"sample_weight must be ({n_samples},), got "
                f"{sample_weight.shape}")
        if not np.isfinite(sample_weight).all() or (
                sample_weight < 0).any():
            raise ValueError(
                "sample_weight must be finite and non-negative")
        if not (sample_weight > 0).any():
            raise ValueError("sample_weight must not be all zero")

    deriv_blocks = normalize_derivative_data(derivative_data, d, domain,
                                             counts)

    # Valid TT ranks: clamp against both boundary products.
    ranks = [1] + [int(max_rank)] * (d - 1) + [1]
    for k in range(1, d):
        ranks[k] = min(ranks[k], ranks[k - 1] * counts[k - 1])
    for k in range(d - 1, 0, -1):
        ranks[k] = min(ranks[k], ranks[k + 1] * counts[k])
    max_core = max(ranks[k] * counts[k] * ranks[k + 1] for k in range(d))
    n_rows_total = n_samples + sum(b[0].shape[0] for b in deriv_blocks)
    informative = n_samples + _capped_block_rows(deriv_blocks, counts)
    if l2 == 0.0 and informative < max_core:
        raise ValueError(
            f"underdetermined fit: {informative} informative rows "
            f"(value samples + derivative observations capped at their "
            f"D^o rank) < {max_core} unknowns in the largest core; "
            f"pass l2 > 0 or add samples"
        )

    nodes = [nodes_for_dim_np(float(domain[k][0]), float(domain[k][1]),
                              counts[k]) for k in range(d)]
    weights = [barycentric_weights_np(nd) for nd in nodes]
    dim_design = _DimDesign(nodes, weights)
    # Per-dim design rows for the value samples and every derivative
    # block, STACKED: d arrays (N_total, n_k).  Blocks differ from
    # value rows only by the folded D^o — the ALS below is oblivious.
    rows = [
        np.concatenate(
            [dim_design.rows(points[:, k], k)]
            + [dim_design.rows(pts[:, k], k, orders[k])
               for pts, orders, _, _ in deriv_blocks], axis=0)
        for k in range(d)
    ]
    y_all = np.concatenate(
        [values] + [vals for _, _, vals, _ in deriv_blocks])
    if sample_weight is not None or deriv_blocks:
        w_all = np.concatenate(
            [sample_weight if sample_weight is not None
             else np.ones(n_samples)]
            + [np.full(pts.shape[0], weight)
               for pts, _, _, weight in deriv_blocks])
    else:
        w_all = None
    sqrt_w = np.sqrt(w_all) if w_all is not None else None
    w_total = (float(np.sum(w_all)) if w_all is not None
               else float(n_samples))

    rng = np.random.default_rng(seed)
    scale = (np.std(values) or 1.0) ** (1.0 / d)
    cores = [rng.standard_normal((ranks[k], counts[k], ranks[k + 1]))
             * scale / np.sqrt(ranks[k] * ranks[k + 1])
             for k in range(d)]
    # Right-orthogonalize 2..d so the first solve sees conditioned
    # interfaces.
    for k in range(d - 1, 0, -1):
        cores[k - 1], cores[k] = orth_right_core(cores[k - 1], cores[k])

    def _interface_step(interface, core, rows_k, side):
        """Advance a per-sample interface through one core."""
        m = np.einsum("ni,aib->nab", rows_k, core)
        if side == "left":
            return np.einsum("na,nab->nb", interface, m)
        return np.einsum("nab,nb->na", m, interface)

    sweep_rms: List[float] = []
    if engine == "device":
        cores, ranks, sweep_rms = _tt_als_sweeps_device(
            rows, y_all, sqrt_w, cores, ranks, counts, l2, sweeps,
            w_total, mesh, data_axis, device=device)
        # Exact f64 residual diagnostics for every engine (the
        # dense fitters' convention): one host chain pass.
        res = _tt_chain_preds(rows, cores) - y_all
    else:
        for sweep in range(int(sweeps)):
            # Right interfaces for every position, from the current cores.
            right = [None] * (d + 1)
            right[d] = np.ones((n_rows_total, 1))
            for k in range(d - 1, 0, -1):
                right[k] = _interface_step(right[k + 1], cores[k], rows[k],
                                           "right")
            left = np.ones((n_rows_total, 1))
            preds = None
            for k in range(d):
                r0, nk, r1 = ranks[k], counts[k], ranks[k + 1]
                p_cols = r0 * nk * r1
                chunk = max(1024, _CHUNK_ELEMS // max(p_cols, 1))

                def _design_chunk(sl):
                    return np.einsum(
                        "na,ni,nb->naib", left[sl], rows[k][sl],
                        right[k + 1][sl]).reshape(-1, p_cols)

                ata = np.zeros((p_cols, p_cols))
                aty = np.zeros(p_cols)
                for start in range(0, n_rows_total, chunk):
                    sl = slice(start, min(start + chunk, n_rows_total))
                    dchunk = _design_chunk(sl)
                    y = y_all[sl]
                    if sqrt_w is not None:
                        dchunk = dchunk * sqrt_w[sl, None]
                        y = y * sqrt_w[sl]
                    ata += dchunk.T @ dchunk
                    aty += dchunk.T @ y
                if l2 > 0.0:
                    ata = ata + l2 * np.eye(p_cols)
                try:
                    sol = np.linalg.solve(ata, aty)
                except np.linalg.LinAlgError:
                    sol, _, _, _ = np.linalg.lstsq(ata, aty, rcond=None)
                cores[k] = sol.reshape(r0, nk, r1)
                if k < d - 1:
                    # Left-orthogonalize and advance the left interface.
                    rm, nm, r1m = cores[k].shape
                    q, rr = np.linalg.qr(cores[k].reshape(rm * nm, r1m))
                    cores[k] = q.reshape(rm, nm, q.shape[1])
                    cores[k + 1] = np.einsum("ij,jpk->ipk", rr,
                                             cores[k + 1])
                    ranks[k + 1] = cores[k].shape[2]
                    left = _interface_step(left, cores[k], rows[k], "left")
                else:
                    preds = np.empty(n_rows_total)
                    for start in range(0, n_rows_total, chunk):
                        sl = slice(start, min(start + chunk, n_rows_total))
                        preds[sl] = _design_chunk(sl) @ sol
            res = preds - y_all
            if w_all is not None:
                sse = float(np.sum(w_all * res * res))
            else:
                sse = float(np.sum(res * res))
            sweep_rms.append(float(np.sqrt(sse / w_total)))
            if sweep > 0 and sweep_rms[-2] - sweep_rms[-1] < (
                    1e-4 * max(sweep_rms[-2], 1e-300)):
                break

    # Headline residuals are VALUE-block-only (matching the dense
    # fitter); per-block stats follow.  ``res`` holds the last sweep's
    # residuals over all stacked rows.
    val_res = res[:n_samples]
    if sample_weight is not None:
        live = sample_weight > 0
        val_max = (float(np.max(np.abs(val_res[live]))) if live.any()
                   else 0.0)
        val_sse = float(np.sum(sample_weight * val_res * val_res))
        val_w = float(np.sum(sample_weight))
    else:
        val_max = float(np.max(np.abs(val_res)))
        val_sse = float(np.sum(val_res * val_res))
        val_w = float(n_samples)
    diagnostics = {
        "rms": (float(np.sqrt(val_sse / val_w)) if val_w > 0 else 0.0),
        "sse": val_sse,
        "sweep_rms": sweep_rms,
        "n_samples": n_samples,
        "tt_ranks": list(ranks),
        "l2": l2,
        "seed": int(seed),
        "max_abs_residual": val_max,
    }
    if deriv_blocks:
        block_diags = []
        offset = n_samples
        objective_sse = val_sse
        for pts, orders, vals, weight in deriv_blocks:
            nb = pts.shape[0]
            b_res = res[offset:offset + nb]
            offset += nb
            b_sse = float(np.sum(b_res * b_res))
            objective_sse += weight * b_sse
            block_diags.append({
                "orders": list(orders),
                "n_samples": int(nb),
                "weight": weight,
                "rms": float(np.sqrt(b_sse / nb)),
                "max_abs_residual": float(np.max(np.abs(b_res))),
            })
        diagnostics["derivative_blocks"] = block_diags
        diagnostics["objective_sse"] = objective_sse
    return cores, diagnostics

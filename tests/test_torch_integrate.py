"""The port's box integrals and conditional expectations against the
JAX package's, on the CPU, for all four families and ``integrate_book``.

Same seeded boxes, points and interpolants go to both packages.
Tolerances (scale-normalized max deviation): f64 <= 1e-12, f32 <= 2e-4,
dd <= 1e-10 of the JAX package (the port serves dd in native f64, so
its dd also equals its own f64).  Zero-measure boxes integrate to an
exact 0.0 at every tier.  Each JAX entry point runs once per family,
through module-scoped results.
"""

import math

import numpy as np
import pytest
import torch

import pychebyshev_tpu as jx
from pychebyshev_tpu import serving as jax_serving
from pychebyshev_tpu.ops import integrate as jax_integrate
from pychebyshev_tpu_torch import (
    ChebyshevApproximation,
    ChebyshevSlider,
    ChebyshevSpline,
    ChebyshevTT,
    serving,
)
from pychebyshev_tpu_torch.ops import integrate as ops

F64_TOL = 1e-12
F32_TOL = 2e-4
DD_TOL = 1e-10
DOM3 = [[-1.0, 1.0], [0.0, 2.0], [-1.0, 1.0]]
NS3 = [9, 8, 7]
DOM_SP = [[0.0, 2.0], [0.0, 1.0], [-1.0, 1.0]]
KNOTS = [[1.0], [], [0.0]]
DOM_SL = [[-1.0, 1.0]] * 4
PARTITION = [[0], [1, 2], [3]]
PIVOT = [0.1, 0.2, -0.1, 0.0]
B = 24
ZERO_ROWS = [3, 7]
TIERS = ["f64", "f32", "dd"]


def smooth3(p, _=None):
    p = np.asarray(p, dtype=np.float64)
    return (np.sin(p[:, 0]) * np.exp(0.3 * p[:, 1]) + p[:, 2] ** 2
            + 0.1 * p[:, 0] * p[:, 2])


def payoff3(p, _=None):
    p = np.asarray(p, dtype=np.float64)
    return (np.maximum(p[:, 0] - 1.0, 0.0) * np.exp(-0.1 * p[:, 1])
            + 0.1 * np.abs(p[:, 2]) * p[:, 0])


def grouped4(p, _=None):
    p = np.asarray(p, dtype=np.float64)
    return (np.sin(p[:, 0]) + p[:, 1] * p[:, 2] + np.exp(0.3 * p[:, 3])
            + np.cos(p[:, 1]))


def _dev(a, ref):
    a = np.asarray(a, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert a.shape == ref.shape
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-300)


def _tol(tier):
    return {"f64": F64_TOL, "f32": F32_TOL, "dd": DD_TOL}[tier]


def _jax_dtype(tier):
    return {"f64": None, "f32": np.float32, "dd": "dd"}[tier]


def _port_dtype(tier):
    return {"f64": None, "f32": torch.float32, "dd": "dd"}[tier]


def _boxes(domain, seed, n=B):
    rng = np.random.default_rng(seed)
    dom = np.asarray(domain, dtype=np.float64)
    lo = rng.uniform(dom[:, 0], dom[:, 1], (n, len(domain)))
    hi = rng.uniform(lo, dom[None, :, 1])
    boxes = np.stack([lo, hi], axis=-1)
    boxes[0] = dom                                  # the whole domain
    for r in ZERO_ROWS:
        if r < n:
            boxes[r, r % len(domain), 1] = boxes[r, r % len(domain), 0]
    return boxes


def _points(domain, dims, seed, n=B):
    rng = np.random.default_rng(seed)
    dom = np.asarray(domain, dtype=np.float64)[dims]
    return rng.uniform(dom[:, 0], dom[:, 1], (n, len(dims)))


@pytest.fixture(scope="module")
def dense():
    ref = jx.ChebyshevApproximation(smooth3, 3, DOM3, NS3, vectorized=True)
    ref.build(verbose=False)
    port = ChebyshevApproximation(smooth3, 3, DOM3, NS3, vectorized=True,
                                  device="cpu")
    port.build(verbose=False)
    return ref, port


@pytest.fixture(scope="module")
def tt(dense):
    ref, port = dense
    order = [2, 0, 1]                  # a storage frame that is not 0..d-1
    return (ref.to_tt(tolerance=1e-13, order=order),
            port.to_tt(tolerance=1e-13, order=order))


@pytest.fixture(scope="module")
def spline():
    ref = jx.ChebyshevSpline(payoff3, 3, DOM_SP, n_nodes=[8, 7, 6],
                             knots=KNOTS, vectorized=True)
    ref.build(verbose=False)
    port = ChebyshevSpline(payoff3, 3, DOM_SP, n_nodes=[8, 7, 6],
                           knots=KNOTS, vectorized=True, device="cpu")
    port.build(verbose=False)
    return ref, port


@pytest.fixture(scope="module")
def slider():
    args = (grouped4, 4, DOM_SL, [7, 8, 6, 7], PARTITION, PIVOT)
    ref = jx.ChebyshevSlider(*args, vectorized=True)
    ref.build(verbose=False)
    port = ChebyshevSlider(*args, vectorized=True, device="cpu")
    port.build(verbose=False)
    return ref, port


# Each family's box batch and conditional-expectation case: integrated
# dims, points over the others, derivative orders on them.
CASES = {
    "dense": (DOM3, [0, 2], [1]),
    "tt": (DOM3, [0, 2], None),
    "spline": (DOM_SP, [1, 2], [1]),       # routes dim 0, knot at 1.0
    "slider": (DOM_SL, [0, 1], [0, 1]),    # cuts the group [1, 2]
}


def _inputs(family):
    domain, dims, orders = CASES[family]
    rest = [k for k in range(len(domain)) if k not in dims]
    boxes = _boxes(domain, 21)
    pts = _points(domain, rest, 22)
    if family == "spline":
        pts[5, 0] = 1.0                     # a routed point on the knot
        pts[6, 0] = 1.0
    return boxes, boxes[:, dims, :], dims, pts, orders


@pytest.fixture(scope="module")
def results(dense, tt, spline, slider):
    """Every JAX and port result, each JAX entry point run once."""
    models = {"dense": dense, "tt": tt, "spline": spline, "slider": slider}
    out = {}
    for family, (ref, port) in models.items():
        boxes, sub, dims, pts, orders = _inputs(family)
        for tier in TIERS:
            out[family, "box", tier] = (
                ref.integrate_batch(boxes, dtype=_jax_dtype(tier)),
                port.integrate_batch(boxes, dtype=_port_dtype(tier)))
        for tier in ("f64", "dd"):
            kw = {} if orders is None else {"derivative_order": orders}
            out[family, "partial", tier] = (
                ref.partial_integrate_batch(dims, sub, pts,
                                            dtype=_jax_dtype(tier), **kw),
                port.partial_integrate_batch(dims, sub, pts,
                                             dtype=_port_dtype(tier), **kw))
    ref, port = dense
    book_ref = [ref, ref * 2.0, ref.differentiate([1, 0, 0])]
    book = [port, port * 2.0, port.differentiate([1, 0, 0])]
    boxes = _inputs("dense")[0]
    for tier in TIERS:
        out["book", tier] = (
            jax_serving.integrate_book(book_ref, boxes,
                                       dtype=_jax_dtype(tier)),
            serving.integrate_book(book, boxes, dtype=_port_dtype(tier)))
    return out


FAMILIES = ["dense", "tt", "spline", "slider"]


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("family", FAMILIES)
def test_box_integrals_match_jax(results, family, tier):
    ref, got = results[family, "box", tier]
    assert isinstance(got, np.ndarray) and got.shape == (B,)
    assert _dev(got, ref) <= _tol(tier)
    assert got.dtype == np.asarray(ref).dtype
    assert (got[ZERO_ROWS] == 0.0).all()
    if tier == "dd":      # native f64
        np.testing.assert_array_equal(got, results[family, "box", "f64"][1])


@pytest.mark.parametrize("tier", ["f64", "dd"])
@pytest.mark.parametrize("family", FAMILIES)
def test_conditional_expectations_match_jax(results, family, tier):
    ref, got = results[family, "partial", tier]
    assert got.shape == (B,)
    assert _dev(got, ref) <= _tol(tier)


@pytest.mark.parametrize("tier", TIERS)
def test_integrate_book_matches_jax_and_each_model(results, dense, tier):
    ref, got = results["book", tier]
    assert got.shape == (3, B)
    assert _dev(got, ref) <= _tol(tier)
    assert (got[:, ZERO_ROWS] == 0.0).all()
    port = dense[1]
    single = port.integrate_batch(_inputs("dense")[0],
                                  dtype=_port_dtype(tier))
    np.testing.assert_array_equal(got[0], single)


def test_f32_partial_and_the_book_stay_in_f32(dense):
    ref, port = dense
    boxes, sub, dims, pts, orders = _inputs("dense")
    got = port.partial_integrate_batch(dims, sub, pts, orders,
                                       dtype=torch.float32)
    want = ref.partial_integrate_batch(dims, sub, pts, orders,
                                       dtype=np.float32)
    assert got.dtype == np.float32
    assert _dev(got, want) <= F32_TOL


def test_integrate_full_and_partial(dense, tt, spline, slider):
    bounds3 = [(-0.5, 0.7), (0.25, 1.5), None]
    cases = ((dense, bounds3), (tt, bounds3),
             (spline, [(0.5, 1.5), (0.25, 0.75), None]),
             (slider, [(-0.5, 0.7), (0.25, 0.9), None, None]))
    pt = [0.3, -0.4]
    for (ref, port), bounds in cases:
        full_ref, full = ref.integrate(), port.integrate()
        assert abs(full - full_ref) <= F64_TOL * abs(full_ref)
        b_ref, b_got = ref.integrate(bounds=bounds), port.integrate(
            bounds=bounds)
        assert abs(b_got - b_ref) <= F64_TOL * abs(b_ref)
    # partial: a lower-dim interpolant of the same family, on the device
    for ref, port in (dense, spline):
        part_ref = ref.integrate(dims=[1], bounds=[(0.25, 0.75)])
        part = port.integrate(dims=[1], bounds=[(0.25, 0.75)])
        assert type(part) is type(port) and part.num_dimensions == 2
        assert abs(part.eval(pt, [0, 0]) - part_ref.eval(pt, [0, 0])) \
            <= F64_TOL * max(abs(part_ref.eval(pt, [0, 0])), 1.0)
    part_ref, part = tt[0].integrate(dims=[1]), tt[1].integrate(dims=[1])
    assert part._dim_order == part_ref._dim_order
    assert abs(part.eval(pt) - part_ref.eval(pt)) <= F64_TOL * abs(
        part_ref.eval(pt))
    part_ref = slider[0].integrate(dims=[1, 3], bounds=[(-0.5, 0.5), None])
    part = slider[1].integrate(dims=[1, 3], bounds=[(-0.5, 0.5), None])
    assert part.partition == part_ref.partition
    assert abs(part.eval(pt, [0, 0]) - part_ref.eval(pt, [0, 0])) <= F64_TOL


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("family", FAMILIES)
def test_empty_batches(dense, tt, spline, slider, family, tier):
    """Shape (0,) at every tier (the JAX package's dd path raises
    ZeroDivisionError here, so only the port is run)."""
    port = {"dense": dense, "tt": tt, "spline": spline,
            "slider": slider}[family][1]
    domain, dims, _ = CASES[family]
    got = port.integrate_batch(np.zeros((0, len(domain), 2)),
                               dtype=_port_dtype(tier))
    assert got.shape == (0,)
    got = port.partial_integrate_batch(
        dims, np.zeros((0, len(dims), 2)),
        np.zeros((0, len(domain) - len(dims))), dtype=_port_dtype(tier))
    assert got.shape == (0,)


def _same_error(call_ref, call_port, exc=ValueError):
    with pytest.raises(exc) as want:
        call_ref()
    with pytest.raises(exc) as got:
        call_port()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("family", FAMILIES)
def test_validation_errors_are_the_references(dense, tt, spline, slider,
                                              family):
    ref, port = {"dense": dense, "tt": tt, "spline": spline,
                 "slider": slider}[family]
    domain, dims, _ = CASES[family]
    d = len(domain)
    boxes = _boxes(domain, 21, 4)
    outside = boxes.copy()
    outside[2, 1, 1] = domain[1][1] + 0.5
    inverted = boxes.copy()
    inverted[1, 0] = inverted[1, 0, ::-1] + [0.1, -0.1]
    bad_nan = boxes.copy()
    bad_nan[0, 0, 0] = np.nan
    for bad in (outside, inverted, bad_nan, boxes[:, :d - 1]):
        _same_error(lambda: ref.integrate_batch(bad),
                    lambda: port.integrate_batch(bad))
    pts = np.zeros((4, d - 2))
    sub = boxes[:, :2]
    for bad_dims in ([], [d], [-1]):
        _same_error(lambda: ref.partial_integrate_batch(bad_dims, sub, pts),
                    lambda: port.partial_integrate_batch(bad_dims, sub, pts))
    _same_error(lambda: ref.partial_integrate_batch([0, 1], sub, pts[:2]),
                lambda: port.partial_integrate_batch([0, 1], sub, pts[:2]))
    _same_error(lambda: ref.partial_integrate_batch([0, 1], outside[:, :2],
                                                    pts),
                lambda: port.partial_integrate_batch([0, 1], outside[:, :2],
                                                     pts))
    _same_error(lambda: ref.integrate(dims=[d]),
                lambda: port.integrate(dims=[d]))
    _same_error(lambda: ref.integrate(bounds=[(domain[0][0] - 1, 0.0)]
                                      + [None] * (d - 1)),
                lambda: port.integrate(bounds=[(domain[0][0] - 1, 0.0)]
                                       + [None] * (d - 1)))


def test_dd_refusals_are_the_references(dense, tt):
    ref, port = dense
    boxes, sub, dims, pts, _ = _inputs("dense")
    args = (np.asarray(DOM3), (0, 2), sub[:4], pts[:4])
    _same_error(
        lambda: jax_integrate.partial_integrate_eval_batch_dd(
            ref.tensor_values, args[0], ref.nodes, ref.weights,
            ref.diff_matrices, *args[1:], orders=(1, 0, 0)),
        lambda: ops.partial_integrate_eval_batch_dd(
            port.tensor_values, args[0], port.nodes, port.weights,
            port.diff_matrices, *args[1:], orders=(1, 0, 0)))
    _same_error(
        lambda: jax_integrate.integrate_box_batch_models_dd(
            (), args[0], boxes[:4]),
        lambda: ops.integrate_box_batch_models_dd((), args[0], boxes[:4]))
    t_ref, t_port = tt
    cores_ref = t_ref._cores_on_device(np.float64)
    cores = t_port._cores_on_device(torch.float64)
    dom = np.asarray(t_port.domain)
    for groups in ((2, 2), (0, 3), (4,)):
        _same_error(
            lambda: jax_integrate.tt_integrate_box_batch_dd(
                cores_ref, dom, boxes[:4], groups=groups),
            lambda: ops.tt_integrate_box_batch_dd(cores, dom, boxes[:4],
                                                  groups=groups))
    wide = [np.zeros((1, 1 << 14, 1))]
    _same_error(
        lambda: jax_integrate.tt_integrate_box_batch_dd(
            wide, [[0.0, 1.0]], np.zeros((1, 1, 2))),
        lambda: ops.tt_integrate_box_batch_dd(wide, [[0.0, 1.0]],
                                              np.zeros((1, 1, 2))))


@pytest.mark.parametrize("groups", [None, "auto", (2, 1), (1, 2), (3,)])
def test_tt_dd_groupings_agree(tt, groups):
    _, port = tt
    boxes, sub, dims, pts, _ = _inputs("tt")
    cores = port._cores_on_device(torch.float64)
    dom = np.asarray(port.domain)
    storage = boxes[:, port._dim_order, :]
    want = ops.tt_integrate_box_batch(cores, dom, storage)
    got = ops.tt_integrate_box_batch_dd(cores, dom, storage, groups=groups)
    assert _dev(got, want) <= F64_TOL
    got = ops.tt_partial_integrate_eval_batch_dd(
        cores, dom, (0,), storage[:, [0]], storage[:, 1:, 0], groups=groups)
    want = ops.tt_partial_integrate_eval_batch(
        cores, dom, (0,), storage[:, [0]], storage[:, 1:, 0])
    assert _dev(got, want) <= F64_TOL


@pytest.mark.parametrize("shape", [(9,), (2,) * 6])
def test_dd_outside_the_plan_takes_the_f64_path(shape):
    """1-D grids and right groups of 4 dims are outside the reference's
    dd plan: the class path serves f64, the ops entry refuses."""
    domain = [[0.0, 1.0]] * len(shape)
    cheb = ChebyshevApproximation.from_values(
        np.random.default_rng(0).standard_normal(shape), len(shape),
        domain, list(shape), device="cpu")
    boxes = _boxes(domain, 4, 8)
    np.testing.assert_array_equal(cheb.integrate_batch(boxes, dtype="dd"),
                                  cheb.integrate_batch(boxes))
    with pytest.raises(ValueError, match="outside digit-GEMM budget"):
        ops.integrate_box_batch_dd(cheb.tensor_values, domain, boxes)


def test_integrate_book_refusals(dense, tt):
    ref, port = dense
    boxes = _inputs("dense")[0]
    other = ChebyshevApproximation(smooth3, 3, DOM3, [9, 8, 6],
                                   vectorized=True, device="cpu")
    other.build(verbose=False)
    other_ref = jx.ChebyshevApproximation(smooth3, 3, DOM3, [9, 8, 6],
                                          vectorized=True)
    other_ref.build(verbose=False)
    _same_error(lambda: jax_serving.integrate_book([], boxes),
                lambda: serving.integrate_book([], boxes))
    _same_error(lambda: jax_serving.integrate_book([ref, other_ref], boxes),
                lambda: serving.integrate_book([port, other], boxes))
    _same_error(lambda: jax_serving.integrate_book([ref, tt[0]], boxes),
                lambda: serving.integrate_book([port, tt[1]], boxes),
                TypeError)
    unbuilt = ChebyshevApproximation(None, 3, DOM3, NS3, device="cpu",
                                     defer_build=True)
    with pytest.raises(RuntimeError, match="all models must be built"):
        serving.integrate_book([port, unbuilt], boxes)


def test_in_place_edits_are_read_by_the_next_call(spline, slider):
    """Tensors are mutable: the calculus keeps no snapshot of them."""
    cheb = ChebyshevApproximation(smooth3, 3, DOM3, NS3, vectorized=True,
                                  device="cpu")
    cheb.build(verbose=False)
    boxes = _inputs("dense")[0]
    before = cheb.integrate_batch(boxes, dtype="dd")
    cheb.tensor_values.mul_(2.0)
    for tier in TIERS:
        got = cheb.integrate_batch(boxes, dtype=_port_dtype(tier))
        assert _dev(got, 2.0 * before) <= _tol(tier)
    assert abs(cheb.integrate() - 2.0 * cheb.integrate() / 2.0) == 0.0
    spl = spline[1].clone()
    sp_boxes = _inputs("spline")[0]
    before = spl.integrate_batch(sp_boxes)
    for p in spl._pieces:
        p.tensor_values.mul_(-1.0)
    np.testing.assert_allclose(spl.integrate_batch(sp_boxes), -before,
                               rtol=0, atol=1e-14 * np.abs(before).max())
    sl = slider[1].clone()
    sl_boxes = _inputs("slider")[0]
    before = sl.integrate_batch(sl_boxes)
    sl.slides[1].tensor_values.add_(1.0)
    widths = np.prod(sl_boxes[..., 1] - sl_boxes[..., 0], axis=1)
    np.testing.assert_allclose(sl.integrate_batch(sl_boxes),
                               before + widths, rtol=1e-13, atol=1e-13)


def test_closed_forms():
    """Sanity on functions the interpolants hold exactly."""
    f = ChebyshevApproximation.from_values(
        np.ones((5, 4)), 2, [[0.0, 2.0], [-1.0, 3.0]], [5, 4], device="cpu")
    boxes = np.array([[[0.5, 1.5], [0.0, 2.0]], [[1.0, 1.0], [-1.0, 3.0]]])
    np.testing.assert_allclose(f.integrate_batch(boxes), [2.0, 0.0],
                               rtol=1e-14)
    assert math.isclose(f.integrate(), 8.0, rel_tol=1e-14)
    np.testing.assert_allclose(
        f.partial_integrate_batch(1, boxes[:, [1]], [[0.3], [1.7]]),
        [2.0, 4.0], rtol=1e-14)

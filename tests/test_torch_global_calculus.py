"""The port's global calculus against the JAX package's, on the CPU, for
all four families: certified global ``minimize``/``maximize``
(``dim=None``, with and without ``fixed``), ``critical_points``,
``solve_system``, the uncertified warning and the error texts.

Each port model is the JAX model moved over with ``utils.convert``'s
``*_from_jax_state``, so both searches start from the same tensors.
Values are held to 1e-12 of the function's scale, unique optimum
locations to 1e-8 of the dim's width, critical points to equal counts
and kinds and 1e-8 on the points.  Grids have at most 9 nodes a dim.
"""

import warnings

import numpy as np
import pytest

import pychebyshev_tpu as jx
import pychebyshev_tpu_torch as pt
from pychebyshev_tpu.utils import globalcalc as jax_gc
from pychebyshev_tpu_torch.utils import globalcalc as gc
from pychebyshev_tpu_torch.utils.convert import (
    from_jax_state,
    slider_from_jax_state,
    spline_from_jax_state,
    tt_from_jax_state,
)

VAL_TOL = 1e-12       # times the function's scale
LOC_TOL = 1e-8        # times the dim's width
DOM = [[-1.0, 1.0], [0.0, 1.0], [-1.0, 1.0]]
FAMILIES = ["dense", "spline", "slider", "tt"]
SCALE = 2.0           # max |f| on DOM of both test functions (1.97)


def well(p, _=None):
    """A tilted double well in x0 coupled to bowls in x1, x2: two minima
    of different depth and a saddle, a unique global minimum and
    maximum.  Degree 4, so 9 nodes represent it exactly."""
    p = np.asarray(p, dtype=np.float64)
    return ((p[:, 0] ** 2 - 0.25) ** 2 + 0.05 * p[:, 0]
            + (p[:, 1] - 0.4) ** 2 + 0.5 * (p[:, 2] + 0.2) ** 2
            + 0.1 * p[:, 1] * p[:, 2])


def kinked_well(p, _=None):
    """``well`` plus a kink on the knot x0 = 0.1."""
    p = np.asarray(p, dtype=np.float64)
    return well(p) + 0.2 * np.abs(p[:, 0] - 0.1)


def _dense_state(m):
    return {"tensor_values": np.asarray(m.tensor_values),
            "domain": m.domain, "n_nodes": m.n_nodes,
            "nodes": [np.asarray(a) for a in m.nodes],
            "weights": [np.asarray(a) for a in m.weights],
            "diff_matrices": [np.asarray(a) for a in m.diff_matrices],
            "max_derivative_order": m.max_derivative_order}


def _pair(family):
    kw = dict(vectorized=True)
    if family == "dense":
        ref = jx.ChebyshevApproximation(well, 3, DOM, [9, 7, 8], **kw)
        ref.build(verbose=False)
        return ref, from_jax_state(_dense_state(ref), device="cpu")
    if family == "spline":
        ref = jx.ChebyshevSpline(kinked_well, 3, DOM, n_nodes=[9, 5, 5],
                                 knots=[[0.1], [], []], **kw)
        ref.build(verbose=False)
        state = {"domain": ref.domain, "n_nodes": ref.n_nodes,
                 "knots": ref.knots,
                 "max_derivative_order": ref.max_derivative_order,
                 "pieces": [_dense_state(p) for p in ref._pieces]}
        return ref, spline_from_jax_state(state, device="cpu")
    if family == "slider":
        ref = jx.ChebyshevSlider(well, 3, DOM, [9, 5, 5], [[0], [1, 2]],
                                 [0.1, 0.5, 0.0], **kw)
        ref.build(verbose=False)
        state = {"domain": ref.domain, "n_nodes": ref.n_nodes,
                 "partition": ref.partition,
                 "pivot_point": ref.pivot_point,
                 "pivot_value": ref.pivot_value,
                 "max_derivative_order": ref.max_derivative_order,
                 "slides": [_dense_state(s) for s in ref.slides]}
        return ref, slider_from_jax_state(state, device="cpu")
    dense = jx.ChebyshevApproximation(well, 3, DOM, [9, 5, 5], **kw)
    dense.build(verbose=False)
    # a storage frame that is not 0..d-1
    ref = dense.to_tt(tolerance=1e-13, order=[1, 2, 0])
    state = ref.__getstate__()
    state["_coeff_cores"] = [np.asarray(c) for c in state["_coeff_cores"]]
    return ref, tt_from_jax_state(state, device="cpu")


@pytest.fixture(scope="module")
def models():
    return {f: _pair(f) for f in FAMILIES}


def _quiet(fn):
    """fn()'s result and its RuntimeWarning texts."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        out = fn()
    return out, [str(w.message) for w in caught
                 if issubclass(w.category, RuntimeWarning)]


@pytest.fixture(scope="module")
def optima(models):
    """Both packages' global optima: family -> (mode, fixed) -> pair."""
    out = {}
    for family, (ref, port) in models.items():
        for mode in ("minimize", "maximize"):
            for fixed in (None, {1: 0.75}, {1: 0.75, 2: -0.5}):
                key = (mode, None if fixed is None else tuple(fixed.items()))
                out[family, key] = (
                    _quiet(lambda: getattr(ref, mode)(fixed=fixed)),
                    _quiet(lambda: getattr(port, mode)(fixed=fixed)))
    return out


@pytest.mark.parametrize("fixed", [None, ((1, 0.75),),
                                   ((1, 0.75), (2, -0.5))])
@pytest.mark.parametrize("mode", ["minimize", "maximize"])
@pytest.mark.parametrize("family", FAMILIES)
def test_global_optimum_matches_jax(models, optima, family, mode, fixed):
    ref, port = models[family]
    ((want_v, want_x), want_w), ((got_v, got_x), got_w) = \
        optima[family, (mode, fixed)]
    assert isinstance(got_x, np.ndarray) and got_x.shape == (3,)
    assert abs(got_v - want_v) <= VAL_TOL * SCALE
    width = np.diff(np.asarray(DOM), axis=1)[:, 0]
    assert (np.abs(got_x - want_x) <= LOC_TOL * width).all()
    for dim, value in fixed or ():
        assert got_x[dim] == value
    assert got_w == want_w


def test_global_optima_are_true_optima(models, optima):
    """The dense family's certified minimum lies below every point of a
    dense grid and at the tilted well's deeper minimum."""
    (_, _), ((v, x), warned) = optima["dense", ("minimize", None)]
    assert not warned
    g = np.stack(np.meshgrid(np.linspace(-1, 1, 41), np.linspace(0, 1, 21),
                             np.linspace(-1, 1, 41), indexing="ij"),
                 axis=-1).reshape(-1, 3)
    assert well(g).min() >= v - 1e-9
    assert x[0] < 0.0


@pytest.mark.parametrize("fixed", [None, {2: -0.5}, {1: 0.75, 2: -0.5}])
@pytest.mark.parametrize("family", FAMILIES)
def test_critical_points_match_jax(models, family, fixed):
    ref, port = models[family]
    want = ref.critical_points(fixed=fixed)
    got = port.critical_points(fixed=fixed)
    assert [c.kind for c in got] == [c.kind for c in want]
    assert all(isinstance(c, pt.CriticalPoint) for c in got)
    for a, b in zip(got, want):
        assert np.abs(a.point - b.point).max() <= 1e-8
        assert abs(a.value - b.value) <= VAL_TOL * SCALE
    if family != "spline" and fixed is None:
        assert [c.kind for c in got] == ["minimum", "minimum", "saddle"]


def _circle_line(pkg, **kw):
    f1 = pkg.ChebyshevApproximation(
        lambda p, _: p[:, 0] ** 2 + p[:, 1] ** 2 - 0.64, 2,
        [[-1, 1]] * 2, [7, 7], vectorized=True, **kw)
    f2 = pkg.ChebyshevApproximation(
        lambda p, _: p[:, 0] - p[:, 1], 2, [[-1, 1]] * 2, [7, 7],
        vectorized=True, **kw)
    for f in (f1, f2):
        f.build(verbose=False)
    return [f1, f2]


def test_solve_system_matches_jax():
    want_models = _circle_line(jx)
    got_models = [from_jax_state(_dense_state(m), device="cpu")
                  for m in want_models]
    want = jx.solve_system(want_models)
    got = pt.solve_system(got_models)
    assert got.shape == want.shape == (2, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.abs(got), np.sqrt(0.32), atol=1e-10)
    # a system with no common zero: the circle against a shifted line
    far = pt.ChebyshevApproximation(lambda p, _: p[:, 0] - p[:, 1] + 1.9,
                                    2, [[-1, 1]] * 2, [7, 7],
                                    vectorized=True, device="cpu")
    far.build(verbose=False)
    assert pt.solve_system([got_models[0], far]).shape == (0, 2)


def test_solve_system_errors_are_the_references():
    want_models = _circle_line(jx)
    got_models = _circle_line(pt, device="cpu")
    other = pt.ChebyshevApproximation(lambda p, _: p[:, 0], 2,
                                      [[-1, 2], [-1, 1]], [5, 5],
                                      vectorized=True, device="cpu")
    other.build(verbose=False)
    jx_other = jx.ChebyshevApproximation(lambda p, _: p[:, 0], 2,
                                         [[-1, 2], [-1, 1]], [5, 5],
                                         vectorized=True)
    jx_other.build(verbose=False)
    unbuilt = pt.ChebyshevApproximation(lambda p, _: p[:, 0], 2,
                                        [[-1, 1]] * 2, [5, 5],
                                        vectorized=True, device="cpu")
    jx_unbuilt = jx.ChebyshevApproximation(lambda p, _: p[:, 0], 2,
                                           [[-1, 1]] * 2, [5, 5],
                                           vectorized=True)
    cases = [([], []), (want_models[:1], got_models[:1]),
             ([want_models[0], jx_other], [got_models[0], other]),
             ([want_models[0], jx_unbuilt], [got_models[0], unbuilt])]
    for want_args, got_args in cases:
        with pytest.raises((ValueError, RuntimeError)) as want:
            jx.solve_system(want_args)
        with pytest.raises(type(want.value)) as got:
            pt.solve_system(got_args)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("family", FAMILIES)
def test_uncertified_run_warns_as_the_reference(models, family):
    ref, port = models[family]
    (want_v, _), want_w = _quiet(lambda: ref.minimize(tol=1e-12,
                                                      max_boxes=3))
    (got_v, _), got_w = _quiet(lambda: port.minimize(tol=1e-12,
                                                     max_boxes=3))
    assert got_w == want_w
    if family != "slider":
        assert got_w and "is not certified" in got_w[0]
    assert abs(got_v - want_v) <= VAL_TOL * SCALE


@pytest.mark.parametrize("family", FAMILIES)
def test_global_errors_are_the_references(models, family):
    ref, port = models[family]
    calls = [
        lambda m: m.minimize(fixed={3: 0.0}),
        lambda m: m.maximize(fixed={1: 2.0}),
        lambda m: m.minimize(fixed={0: 0.0, 1: 0.5, 2: 0.0}),
        lambda m: m.critical_points(fixed={0: 0.0, 1: 0.5, 2: 0.0}),
        lambda m: m.minimize(tol=-1.0),
    ]
    for call in calls:
        with pytest.raises(ValueError) as want:
            call(ref)
        with pytest.raises(ValueError) as got:
            call(port)
        assert str(got.value) == str(want.value)


def test_unbuilt_models_say_call_build_first():
    kw = dict(vectorized=True, device="cpu")
    unbuilt = [
        pt.ChebyshevApproximation(well, 3, DOM, [5, 5, 5], **kw),
        pt.ChebyshevSpline(kinked_well, 3, DOM, n_nodes=[5, 5, 5],
                           knots=[[0.1], [], []], **kw),
        pt.ChebyshevSlider(well, 3, DOM, [5, 5, 5], [[0], [1, 2]],
                           [0.0, 0.5, 0.0], **kw),
        pt.ChebyshevTT(well, 3, DOM, [5, 5, 5], **kw)]
    for model in unbuilt:
        for call in (model.minimize, model.maximize, model.critical_points):
            with pytest.raises(RuntimeError, match="build"):
                call()


def test_public_names_cover_the_references():
    assert set(jx.__all__) <= set(pt.__all__)
    assert pt.CriticalPoint._fields == jx.CriticalPoint._fields
    assert gc.__all__ == jax_gc.__all__


def test_host_helpers_are_bitwise_copies(models):
    ref, _ = models["dense"]
    values = np.asarray(ref.tensor_values)
    np.testing.assert_array_equal(gc.dense_coeff_tensor(values),
                                  jax_gc.dense_coeff_tensor(values))
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1.0, 1.0, (30, 3))
    pts[10:20] = pts[:10] + 1e-9
    resid = rng.uniform(0.0, 1.0, 30)
    dom = np.asarray(DOM)
    np.testing.assert_array_equal(gc._dedupe(pts, resid, dom, 1e-6),
                                  jax_gc._dedupe(pts, resid, dom, 1e-6))
    for kinds in (["minimum"], ["minimum", "maximum"], ["saddle"],
                  ["maximum", "degenerate"], ["maximum", "maximum"]):
        assert gc._combine_kinds(kinds) == jax_gc._combine_kinds(kinds)
    assert gc._hessian_specs(3) == jax_gc._hessian_specs(3)
    assert gc.validate_global_args(3, {0: 0.5}, DOM) == \
        jax_gc.validate_global_args(3, {0: 0.5}, DOM)

"""The port's roots, 1-D optima and scenario batches against the JAX
package's, on the CPU, for all four families.

Same seeded interpolants and scenarios go to both packages.  Roots and
optimum locations are held to 1e-10 absolute on the dim's domain (and
root counts to equality), optimum values to 1e-12 of the function's
scale.  ``utils.calculus`` is a copy of the reference's host NumPy and
must agree bitwise on the same arrays.
"""

import numpy as np
import pytest

import pychebyshev_tpu as jx
from pychebyshev_tpu.utils import calculus as jax_calculus
from pychebyshev_tpu_torch import (
    ChebyshevApproximation,
    ChebyshevSlider,
    ChebyshevSpline,
)
from pychebyshev_tpu_torch.utils import calculus

LOC_TOL = 1e-10
VAL_TOL = 1e-12
DOM = [[-1.0, 1.0], [0.0, 1.0], [-1.0, 1.0]]
NS = [9, 7, 6]
B = 16
FAMILIES = ["dense", "tt", "spline", "slider"]


def wave(p, _=None):
    p = np.asarray(p, dtype=np.float64)
    return (np.cos(3.0 * p[:, 0] + 0.4) + 0.5 * p[:, 1] * p[:, 2]
            - 0.2 * p[:, 2])


def kink(p, _=None):
    p = np.asarray(p, dtype=np.float64)
    return (np.abs(p[:, 0] - 0.2) - 0.3 + 0.2 * p[:, 1] * p[:, 2]
            + 0.1 * p[:, 2] + 0.05 * p[:, 0] ** 2)


def _pair(family):
    if family in ("dense", "tt"):
        ref = jx.ChebyshevApproximation(wave, 3, DOM, NS, vectorized=True)
        port = ChebyshevApproximation(wave, 3, DOM, NS, vectorized=True,
                                      device="cpu")
    elif family == "spline":
        kw = dict(n_nodes=NS, knots=[[0.2], [], []], vectorized=True)
        ref = jx.ChebyshevSpline(kink, 3, DOM, **kw)
        port = ChebyshevSpline(kink, 3, DOM, device="cpu", **kw)
    else:
        args = (wave, 3, DOM, NS, [[0], [1, 2]], [0.1, 0.5, 0.0])
        ref = jx.ChebyshevSlider(*args, vectorized=True)
        port = ChebyshevSlider(*args, vectorized=True, device="cpu")
    ref.build(verbose=False)
    port.build(verbose=False)
    if family == "tt":          # a storage frame that is not 0..d-1
        return (ref.to_tt(tolerance=1e-13, order=[1, 2, 0]),
                port.to_tt(tolerance=1e-13, order=[1, 2, 0]))
    return ref, port


@pytest.fixture(scope="module")
def models():
    return {f: _pair(f) for f in FAMILIES}


@pytest.fixture(scope="module")
def scenarios():
    rng = np.random.default_rng(7)
    fixed = {1: rng.uniform(0.0, 1.0, B), 2: rng.uniform(-1.0, 1.0, B)}
    fixed[1][3] = 1.0                          # on the domain's edge
    return fixed


@pytest.fixture(scope="module")
def batched(models, scenarios):
    """Both packages' roots_batch / minimize_batch / maximize_batch."""
    out = {}
    for family, (ref, port) in models.items():
        for name in ("roots_batch", "minimize_batch", "maximize_batch"):
            out[family, name] = (
                getattr(ref, name)(dim=0, fixed=scenarios),
                getattr(port, name)(dim=0, fixed=scenarios))
    return out


def _same_roots(got, want):
    assert got.shape == want.shape
    if want.size:
        assert np.abs(got - want).max() <= LOC_TOL


@pytest.mark.parametrize("family", FAMILIES)
def test_roots_batch_matches_jax(batched, family):
    want, got = batched[family, "roots_batch"]
    assert len(got) == B
    assert sum(r.size for r in got) >= B     # every scenario has roots
    for g, w in zip(got, want):
        _same_roots(g, w)


@pytest.mark.parametrize("mode", ["minimize_batch", "maximize_batch"])
@pytest.mark.parametrize("family", FAMILIES)
def test_optima_batch_match_jax(batched, family, mode):
    (want_v, want_x), (got_v, got_x) = batched[family, mode]
    assert got_v.shape == got_x.shape == (B,)
    assert np.abs(got_x - want_x).max() <= LOC_TOL
    assert np.abs(got_v - want_v).max() <= VAL_TOL * np.abs(want_v).max()


@pytest.mark.parametrize("family", FAMILIES)
def test_single_calls_match_jax_and_the_batch(models, scenarios, batched,
                                              family):
    ref, port = models[family]
    for i in (0, 3, 9):
        fixed = {1: float(scenarios[1][i]), 2: float(scenarios[2][i])}
        got = port.roots(dim=0, fixed=fixed)
        _same_roots(got, ref.roots(dim=0, fixed=fixed))
        _same_roots(got, batched[family, "roots_batch"][1][i])
        for mode in ("minimize", "maximize"):
            v, x = getattr(port, mode)(dim=0, fixed=fixed)
            v_ref, x_ref = getattr(ref, mode)(dim=0, fixed=fixed)
            assert abs(x - x_ref) <= LOC_TOL
            assert abs(v - v_ref) <= VAL_TOL * max(abs(v_ref), 1.0)
            bv, bx = batched[family, mode + "_batch"][1]
            assert abs(x - bx[i]) <= LOC_TOL
            assert abs(v - bv[i]) <= VAL_TOL * max(abs(v_ref), 1.0)


@pytest.mark.parametrize("family", FAMILIES)
def test_other_dims_and_scalar_fixed(models, family):
    """Batches along a dim other than 0, scalars broadcast."""
    ref, port = models[family]
    fixed = {0: np.linspace(-0.9, 0.9, 5), 1: 0.25}
    got_v, got_x = port.maximize_batch(dim=2, fixed=fixed)
    want_v, want_x = ref.maximize_batch(dim=2, fixed=fixed)
    assert np.abs(got_x - want_x).max() <= LOC_TOL
    assert np.abs(got_v - want_v).max() <= VAL_TOL * np.abs(want_v).max()


@pytest.mark.parametrize("family", FAMILIES)
def test_global_forms_wait_and_errors_are_the_references(models, family):
    """The global forms (ported: the name is the calculus slice's) give
    the reference's optimum; every invalid call raises its error."""
    ref, port = models[family]
    for mode in ("minimize", "maximize"):
        got_v, got_x = getattr(port, mode)(fixed={2: 0.5})
        want_v, want_x = getattr(ref, mode)(fixed={2: 0.5})
        assert abs(got_v - want_v) <= VAL_TOL * max(abs(want_v), 1.0)
        assert np.abs(got_x - want_x).max() <= 1e-8
    calls = [
        lambda m: m.roots(),                              # dim required
        lambda m: m.roots(dim=5, fixed={}),
        lambda m: m.roots(dim=0, fixed={1: 0.5}),         # missing dim 2
        lambda m: m.minimize(dim=0, fixed={1: 3.0, 2: 0.0}),
        lambda m: m.roots_batch(dim=0, fixed={1: [0.1, 0.2], 2: [0.1] * 3}),
        lambda m: m.roots_batch(dim=0, fixed={1: [0.1, 5.0], 2: 0.0}),
        lambda m: m.maximize_batch(dim=0, fixed={1: [], 2: 0.0}),
        lambda m: m.minimize_batch(dim=0, fixed={1: 0.1}),
        lambda m: m.minimize_batch(fixed={1: 0.1, 2: 0.0}),
    ]
    for call in calls:
        with pytest.raises(ValueError) as want:
            call(ref)
        with pytest.raises(ValueError) as got:
            call(port)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("family", ["dense", "spline"])
def test_one_dimensional_forms(family):
    def f(p, _=None):
        x = np.asarray(p, dtype=np.float64)[:, 0]
        return np.abs(x - 0.2) - 0.3 + 0.05 * x ** 2 if family == "spline" \
            else np.cos(3.0 * x) - 0.1 * x
    if family == "dense":
        ref = jx.ChebyshevApproximation(f, 1, [[-1.0, 1.0]], [9],
                                        vectorized=True)
        port = ChebyshevApproximation(f, 1, [[-1.0, 1.0]], [9],
                                      vectorized=True, device="cpu")
    else:
        kw = dict(n_nodes=[9], knots=[[0.2]], vectorized=True)
        ref = jx.ChebyshevSpline(f, 1, [[-1.0, 1.0]], **kw)
        port = ChebyshevSpline(f, 1, [[-1.0, 1.0]], device="cpu", **kw)
    ref.build(verbose=False)
    port.build(verbose=False)
    _same_roots(port.roots(), ref.roots())
    assert port.roots().size == 2
    for mode in ("minimize", "maximize"):
        v, x = getattr(port, mode)()
        v_ref, x_ref = getattr(ref, mode)()
        assert abs(x - x_ref) <= LOC_TOL and abs(v - v_ref) <= VAL_TOL
    with pytest.raises(ValueError, match="no other dims"):
        port.roots(fixed={0: 0.1})
    with pytest.raises(ValueError, match="at least one fixed dim"):
        port.roots_batch(dim=0, fixed={})


def test_host_helpers_are_bitwise_copies():
    rng = np.random.default_rng(11)
    x = np.polynomial.chebyshev.chebpts1(9)[::-1]
    vals = np.stack([np.cos(3 * x + s) for s in rng.uniform(0, 3, 20)])
    vals[0, :] = 0.0                                   # no roots
    vals[1] = x ** 2 - 0.25                            # two roots
    dom = (-2.0, 3.0)
    for got, want in zip(calculus.roots_1d_batch(vals, dom),
                         jax_calculus.roots_1d_batch(vals, dom)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(calculus.roots_1d(vals[1], dom),
                                  jax_calculus.roots_1d(vals[1], dom))
    for mode in ("min", "max"):
        for got, want in zip(
                calculus.optimize_resampled_batch(vals, x, dom, mode),
                jax_calculus.optimize_resampled_batch(vals, x, dom, mode)):
            np.testing.assert_array_equal(got, want)
    cols = {1: np.arange(4.0), 2: np.full(4, 0.5)}
    np.testing.assert_array_equal(
        calculus.scenario_slice_points(3, 0, cols, 4, x),
        jax_calculus.scenario_slice_points(3, 0, cols, 4, x))
    boxes = np.array([[[0.0, 1.0], [0.2, 0.2]], [[-1e-15, 0.5], [0.1, 1.0]]])
    np.testing.assert_array_equal(
        calculus.normalize_bounds_batch(boxes, [[0, 1], [0, 1]]),
        jax_calculus.normalize_bounds_batch(boxes, [[0, 1], [0, 1]]))
    for group, dims in (([0, 1], [1]), ([2], [0, 1]), ([0], [0])):
        assert (calculus.slider_partition_intersect(group, dims)
                == jax_calculus.slider_partition_intersect(group, dims))

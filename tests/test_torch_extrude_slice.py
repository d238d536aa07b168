"""The port's extrude, slice and ``ChebyshevTT.to_slider`` against the
JAX package's, on the CPU, for all four families.

Same interpolants and parameters go to both packages; the results are
compared on the same seeded points (scale-normalized, <= 1e-12) and in
their metadata, a slice at a node is an exact index select, and the
validation errors carry the reference's texts.
"""

import numpy as np
import pytest
import torch

import pychebyshev_tpu as jx
from pychebyshev_tpu_torch import (
    ChebyshevApproximation,
    ChebyshevSlider,
    ChebyshevSpline,
)
from pychebyshev_tpu_torch.ops.chebyshev import nodes_for_dim_np

F64_TOL = 1e-12
DOM = [[-1.0, 1.0], [0.0, 2.0], [-1.0, 1.0]]
NS = [8, 7, 6]
FAMILIES = ["dense", "tt", "spline", "slider"]


def smooth(p, _=None):
    p = np.asarray(p, dtype=np.float64)
    return (np.sin(p[:, 0]) * np.exp(0.3 * p[:, 1]) + p[:, 2] ** 2
            + 0.2 * p[:, 1] * p[:, 2])


def kinked(p, _=None):
    p = np.asarray(p, dtype=np.float64)
    return np.abs(p[:, 0] - 0.25) * np.exp(-0.1 * p[:, 1]) + p[:, 2]


def _pair(family):
    if family in ("dense", "tt"):
        ref = jx.ChebyshevApproximation(smooth, 3, DOM, NS, vectorized=True)
        port = ChebyshevApproximation(smooth, 3, DOM, NS, vectorized=True,
                                      device="cpu")
    elif family == "spline":
        kw = dict(n_nodes=NS, knots=[[0.25], [], []], vectorized=True)
        ref = jx.ChebyshevSpline(kinked, 3, DOM, **kw)
        port = ChebyshevSpline(kinked, 3, DOM, device="cpu", **kw)
    else:
        args = (smooth, 3, DOM, NS, [[0], [1, 2]], [0.1, 1.0, -0.2])
        ref = jx.ChebyshevSlider(*args, vectorized=True)
        port = ChebyshevSlider(*args, vectorized=True, device="cpu")
    ref.build(verbose=False)
    port.build(verbose=False)
    if family == "tt":          # a storage frame that is not 0..d-1
        return (ref.to_tt(tolerance=1e-13, order=[2, 0, 1]),
                port.to_tt(tolerance=1e-13, order=[2, 0, 1]))
    return ref, port


@pytest.fixture(scope="module")
def models():
    return {f: _pair(f) for f in FAMILIES}


def _values(model, pts):
    """Batched f64 values as NumPy, for either package and any family."""
    d = model.num_dimensions
    try:
        out = model.eval_batch(pts, [0] * d)
    except TypeError:
        out = model.eval_batch(pts)
    if isinstance(out, torch.Tensor):
        out = out.cpu().numpy()
    return np.asarray(out)


def _dev(a, ref):
    a = np.asarray(a, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert a.shape == ref.shape
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-300)


def _pts(domain, n=200, seed=3):
    rng = np.random.default_rng(seed)
    dom = np.asarray(domain, dtype=np.float64)
    return rng.uniform(dom[:, 0], dom[:, 1], (n, len(domain)))


def _meta(model):
    keys = ("num_dimensions", "n_nodes", "domain", "knots", "partition",
            "pivot_point", "_dim_order")
    return {k: getattr(model, k) for k in keys if hasattr(model, k)}


EXTRUSIONS = [(1, (0.0, 3.0), 5),
              [(0, (-2.0, 2.0), 4), (4, (1.0, 2.0), 3)]]
SLICES = [(1, 0.7), [(0, 0.25), (2, -0.4)], (1, "node")]


@pytest.mark.parametrize("params", range(len(EXTRUSIONS)))
@pytest.mark.parametrize("family", FAMILIES)
def test_extrude_matches_jax(models, family, params):
    ref, port = models[family]
    spec = EXTRUSIONS[params]
    got, want = port.extrude(spec), ref.extrude(spec)
    assert type(got) is type(port) and got.device == port.device
    assert _meta(got) == _meta(want)
    pts = _pts(got.domain)
    assert _dev(_values(got, pts), _values(want, pts)) <= F64_TOL
    # constant along a new dim: the values do not move with it
    moved = pts.copy()
    new_dim = spec[0] if isinstance(spec, tuple) else spec[0][0]
    lo, hi = got.domain[new_dim]
    moved[:, new_dim] = lo + hi - moved[:, new_dim]
    assert _dev(_values(got, moved), _values(got, pts)) <= F64_TOL


@pytest.mark.parametrize("params", range(len(SLICES)))
@pytest.mark.parametrize("family", FAMILIES)
def test_slice_matches_jax(models, family, params):
    ref, port = models[family]
    spec = SLICES[params]
    if spec == (1, "node"):     # dim 1 has no knots: every piece's node
        spec = (1, float(nodes_for_dim_np(*DOM[1], NS[1])[2]))
    got, want = port.slice(spec), ref.slice(spec)
    assert type(got) is type(port)
    assert _meta(got) == _meta(want)
    pts = _pts(got.domain)
    assert _dev(_values(got, pts), _values(want, pts)) <= F64_TOL


def test_dense_slice_at_a_node_is_an_index_select(models):
    _, port = models["dense"]
    nodes = port._nodes_np()[1]
    got = port.slice((1, float(nodes[4])))
    np.testing.assert_array_equal(got.tensor_values.numpy(),
                                  port.tensor_values[:, 4, :].numpy())


def test_results_own_their_tensors(models):
    _, port = models["dense"]
    ext = port.extrude((0, (0.0, 1.0), 3))
    sl = port.slice((0, 0.3))
    before = port.integrate()
    ext.tensor_values.mul_(5.0)
    sl.tensor_values.mul_(5.0)
    assert port.integrate() == before


@pytest.mark.parametrize("family", FAMILIES)
def test_errors_are_the_references(models, family):
    ref, port = models[family]
    calls = [
        lambda m: m.extrude((1, (1.0, 0.0), 4)),          # lo >= hi
        lambda m: m.extrude((1, (0.0, 1.0), 1)),          # n < 2
        lambda m: m.extrude((7, (0.0, 1.0), 4)),          # out of range
        lambda m: m.extrude([(1, (0.0, 1.0), 4), (1, (0.0, 1.0), 3)]),
        lambda m: m.slice((0, 5.0)),                      # outside
        lambda m: m.slice([(0, 0.1), (1, 0.1), (2, 0.1)]),  # all dims
        lambda m: m.slice([(0, 0.1), (0, 0.2)]),
        lambda m: m.slice((3, 0.1)),
    ]
    for call in calls:
        with pytest.raises(ValueError) as want:
            call(ref)
        with pytest.raises(ValueError) as got:
            call(port)
        assert str(got.value) == str(want.value)
    with pytest.raises(TypeError) as want:
        ref.slice((0.5, 0.1))
    with pytest.raises(TypeError) as got:
        port.slice((0.5, 0.1))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("partition,pivot", [
    ([[0], [1], [2]], [0.0, 1.0, 0.0]),
    ([[2, 0], [1]], [0.3, 0.5, -0.6]),
])
def test_to_slider_matches_jax(models, partition, pivot):
    ref, port = models["tt"]
    got = port.to_slider(partition, pivot)
    want = ref.to_slider(partition, pivot)
    assert isinstance(got, ChebyshevSlider) and got.device == port.device
    assert _meta(got) == _meta(want)
    assert abs(got.pivot_value - want.pivot_value) <= F64_TOL
    for s_got, s_want in zip(got.slides, want.slides):
        assert _dev(s_got.tensor_values.numpy(),
                    np.asarray(s_want.tensor_values)) <= F64_TOL
    pts = _pts(DOM)
    assert _dev(got.eval_batch(pts), want.eval_batch(pts)) <= F64_TOL
    # the slider is exact on the lines through the pivot (held to the
    # function's scale: on the first line the values are rounding noise)
    scale = np.abs(port.eval_batch(pts).numpy()).max()
    line = np.tile(np.asarray(pivot), (20, 1))
    line[:, 1] = np.linspace(0.0, 2.0, 20)
    assert np.abs(got.eval_batch(line)
                  - port.eval_batch(line).numpy()).max() <= F64_TOL * scale


def test_to_slider_errors_are_the_references(models):
    ref, port = models["tt"]
    calls = [
        lambda m: m.to_slider([[0], [], [1, 2]], [0.0, 1.0, 0.0]),
        lambda m: m.to_slider([[0], [1]], [0.0, 1.0, 0.0]),
        lambda m: m.to_slider([[0], [1], [2]], [0.0, 1.0]),
        lambda m: m.to_slider([[0], [1], [2]], [0.0, 3.0, 0.0]),
        lambda m: m.to_slider([[0.5], [1], [2]], [0.0, 1.0, 0.0]),
    ]
    for call in calls:
        with pytest.raises(ValueError) as want:
            call(ref)
        with pytest.raises(ValueError) as got:
            call(port)
        assert str(got.value) == str(want.value)

"""The port's serving engines on splines, against the JAX package's
engines, on the CPU.

Tolerances (scale-normalized): f64 engines <= 1e-12 of the JAX f64
engine; f32 <= 2e-4; ``dtype="dd"`` (native f64 here) <= 1e-12 of the
port's f64 and <= 1e-10 of the JAX dd engine.  Routing is held exactly:
an f32 engine's piece indices equal the JAX f64 routing on points on
the knots and within one f32 ulp of them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pychebyshev_tpu import ChebyshevSpline as JaxSpline
from pychebyshev_tpu import serving as jax_serving
from pychebyshev_tpu.ops import spline_eval as jax_spline_eval
from pychebyshev_tpu_torch import (
    BatchedEvaluator,
    ChebyshevSpline,
    MultiSpecEvaluator,
)
from pychebyshev_tpu_torch.ops import eval_dd, fused_dd, spline_eval

F64_TOL = 1e-12
F32_TOL = 2e-4
DD_VS_JAX_DD = 1e-10
BUCKETS = (256, 1024)
DOM = [[0.0, 2.0], [0.0, 1.0]]
KNOTS = [[0.6, 1.0], [0.5]]
SPECS = [[0, 0], [1, 0], [0, 1], [1, 1]]
TIERS = {"f32": (jnp.float32, torch.float32, F32_TOL),
         "f64": (jnp.float64, torch.float64, F64_TOL),
         "dd": ("dd", "dd", F64_TOL)}


def _f(x, _):
    return (max(x[0] - 1.0, 0.0) + abs(x[0] - 0.6) * x[1]
            + np.exp(-0.3 * x[1]) * np.sin(x[0]) + abs(x[1] - 0.5))


def _dev(a, ref):
    a = np.asarray(a, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert a.shape == ref.shape
    return np.abs(a - ref).max() / np.abs(ref).max()


def _points(n, seed, domain=DOM):
    rng = np.random.default_rng(seed)
    lo = np.array([b[0] for b in domain])
    hi = np.array([b[1] for b in domain])
    return lo + (hi - lo) * rng.uniform(0.01, 0.99, size=(n, len(domain)))


@pytest.fixture(scope="module")
def pair():
    ref = JaxSpline(_f, 2, DOM, [9, 8], KNOTS)
    ref.build(verbose=False)
    port = ChebyshevSpline(_f, 2, DOM, [9, 8], KNOTS, device="cpu")
    port.build(verbose=False)
    return ref, port


@pytest.fixture(scope="module")
def pts():
    return _points(1500, 31)         # spans two slices of the 1024 bucket


@pytest.fixture(scope="module")
def jax_f64(pair, pts):
    """The JAX f64 engines' answers on ``pts``, computed once per spec."""
    ref, _ = pair
    cache = {}

    def answer(specs):
        key = repr(specs)
        if key not in cache:
            if specs is None or isinstance(specs[0], int):
                cache[key] = jax_serving.BatchedEvaluator(
                    ref, dtype=jnp.float64, derivative_order=specs,
                    bucket_sizes=BUCKETS)(pts)
            else:
                cache[key] = jax_serving.MultiSpecEvaluator(
                    ref, specs, dtype=jnp.float64,
                    bucket_sizes=BUCKETS)(pts)
        return cache[key]
    return answer


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("orders", [None, [1, 0]], ids=["value", "d0"])
def test_batched_evaluator(pair, pts, jax_f64, tier, orders):
    ref, port = pair
    jdt, tdt, tol = TIERS[tier]
    want64 = jax_f64(orders)
    engine = BatchedEvaluator(port, dtype=tdt, derivative_order=orders,
                              bucket_sizes=BUCKETS, device="cpu")
    engine.warmup()
    got = engine(pts)
    assert isinstance(got, torch.Tensor) and got.shape == (len(pts),)
    assert got.dtype == (torch.float32 if tier == "f32" else torch.float64)
    assert _dev(got, want64) <= tol
    if tier == "dd":
        same_tier = jax_serving.BatchedEvaluator(
            ref, dtype="dd", derivative_order=orders,
            bucket_sizes=BUCKETS)(pts)
        assert _dev(got, same_tier) <= DD_VS_JAX_DD
        f64 = BatchedEvaluator(port, dtype=torch.float64,
                               derivative_order=orders, device="cpu")(pts)
        assert _dev(got, f64) <= F64_TOL


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_multi_spec_evaluator(pair, pts, jax_f64, tier):
    ref, port = pair
    jdt, tdt, tol = TIERS[tier]
    want64 = jax_f64(SPECS)
    engine = MultiSpecEvaluator(port, SPECS, dtype=tdt,
                                bucket_sizes=BUCKETS, device="cpu")
    engine.warmup()
    got = engine(pts)
    assert got.shape == (len(pts), len(SPECS))
    for k in range(len(SPECS)):
        assert _dev(got[:, k], want64[:, k]) <= tol
    if tier == "dd":
        same_tier = jax_serving.MultiSpecEvaluator(
            ref, SPECS, dtype="dd", bucket_sizes=BUCKETS)(pts)
        assert _dev(got, same_tier) <= DD_VS_JAX_DD


def test_f32_engine_routes_knot_ulp_points_in_f64(pair, monkeypatch):
    """Points on the knots and one (and a third of one) f32 ulp either
    side: the f32 engine's piece indices equal the JAX f64 routing, where
    routing on f32 coordinates would send the sub-ulp points right."""
    _, port = pair
    rows = []
    for d, knots in enumerate(KNOTS):
        for k in knots:
            ulp = float(np.spacing(np.float32(k)))
            for off in (0.0, ulp, -ulp, ulp / 3, -ulp / 3):
                p = [0.3, 0.25]
                p[d] = k + off
                rows.append(p)
    pts = np.array(rows)
    seen = []
    route = spline_eval.route_piece_indices
    monkeypatch.setattr(spline_eval, "route_piece_indices",
                        lambda *a, **k: seen.append(route(*a, **k))
                        or seen[-1])
    for dtype in (torch.float32, torch.float64):
        engine = BatchedEvaluator(port, dtype=dtype, device="cpu")
        out = engine(pts)
        assert out.dtype == dtype
    strides = spline_eval.piece_strides([len(k) for k in KNOTS])
    want = jax_spline_eval.route_piece_indices(KNOTS, strides, pts)
    assert len(seen) == 2
    for flat in seen:
        np.testing.assert_array_equal(flat.numpy(), want)
    # Rows 0-4 are 0.6 + (0, ulp, -ulp, ulp/3, -ulp/3): the points below
    # the knot, the sub-ulp one included, stay in the left piece.
    assert want[1] == want[3] == want[0]
    assert want[2] == want[4] != want[0]


@pytest.mark.parametrize("tier", ["f32", "dd"])
def test_engines_refuse_a_derivative_on_a_knot(pair, tier):
    _, port = pair
    tdt = TIERS[tier][1]
    on_knot = np.array([[0.3, 0.2], [1.0, 0.7]])
    engine = BatchedEvaluator(port, dtype=tdt, derivative_order=[1, 0],
                              device="cpu")
    with pytest.raises(ValueError, match=r"not defined at knot x\[0\]=1.0 "
                                         r"\(point 1\)"):
        engine(on_knot)
    # Values on a knot are fine (the right piece), and a derivative in a
    # dim without a knot there is fine too.
    BatchedEvaluator(port, dtype=tdt, device="cpu")(on_knot)
    multi = MultiSpecEvaluator(port, [[0, 0], [0, 1]], dtype=tdt,
                               device="cpu")
    multi(on_knot)
    with pytest.raises(ValueError, match=r"x\[1\]=0.5"):
        multi(np.array([[0.3, 0.5]]))


def test_dd_engine_out_of_domain_goes_to_the_f64_sibling(pair, pts):
    _, port = pair
    ood = pts[:64].copy()
    ood[5, 0] = 2.5
    dd = BatchedEvaluator(port, dtype="dd", device="cpu")(ood)
    f64 = BatchedEvaluator(port, dtype=torch.float64, device="cpu")(ood)
    assert torch.equal(dd, f64)
    got = MultiSpecEvaluator(port, SPECS, dtype="dd", device="cpu")(ood)
    want = MultiSpecEvaluator(port, SPECS, dtype=torch.float64,
                              device="cpu")(ood)
    assert torch.equal(got, want)


def test_3d_dd_spline_takes_the_k3_route():
    """A >= 3-D piece grid goes to the f64 kernel's pack (its plain
    version on the CPU, so the launch counter stays 0)."""
    def f(x, _):
        return abs(x[0]) * np.cos(x[1]) + x[2] ** 2 * x[1]

    dom = [[-1.0, 1.0]] * 3
    ref = JaxSpline(f, 3, dom, [7, 7, 7], [[0.0], [], []])
    ref.build(verbose=False)
    port = ChebyshevSpline(f, 3, dom, [7, 7, 7], [[0.0], [], []],
                           device="cpu")
    port.build(verbose=False)
    assert fused_dd.supports_fused_dd((7, 7, 7))
    p = _points(700, 4, dom)
    before = fused_dd.launches
    engine = BatchedEvaluator(port, dtype="dd", device="cpu")
    got = engine(p)
    assert fused_dd.launches == before
    want = BatchedEvaluator(port, dtype=torch.float64, device="cpu")(p)
    assert _dev(got, want) <= F64_TOL
    assert _dev(port.eval_batch_dd(p, [0, 1, 0]),
                ref.eval_batch(p, [0, 1, 0])) <= F64_TOL
    assert _dev(port.eval_batch_dd(p), ref.eval_batch_dd(p)) <= DD_VS_JAX_DD


def test_routed_engines_serve_nested_and_large_splines(pair, pts, jax_f64,
                                                       monkeypatch):
    ref, port = pair
    want, want_report = jax_f64(None), jax_f64(SPECS)
    # An f32 engine stacks up to MASKED_MAX_PIECES pieces; f64 engines
    # always route.
    for cap, route in ((6, "masked"), (2, "routed")):
        monkeypatch.setattr(spline_eval, "MASKED_MAX_PIECES", cap)
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.float64, F64_TOL)):
            masked = route == "masked" and dtype == torch.float32
            engine = BatchedEvaluator(port, dtype=dtype, device="cpu")
            assert engine._specs_run.masked == masked
            assert _dev(engine(pts), want) <= tol
            report = MultiSpecEvaluator(port, SPECS, dtype=dtype,
                                        device="cpu")
            assert report._specs_run.masked == masked
            assert _dev(report(pts), want_report) <= tol
    nested = ChebyshevSpline(_f, 2, DOM, [[9, 7, 9], [8, 6]], KNOTS,
                             device="cpu")
    nested.build(verbose=False)
    got = BatchedEvaluator(nested, dtype=torch.float64, device="cpu")(pts)
    assert _dev(got, nested.eval_batch(pts, [0, 0])) <= F64_TOL
    with pytest.raises(ValueError, match="flat n_nodes"):
        BatchedEvaluator(nested, dtype="dd", device="cpu")
    got = MultiSpecEvaluator(nested, SPECS, dtype=torch.float64,
                             device="cpu")(pts)
    assert _dev(got, nested.vectorized_eval_batch_multi(pts, SPECS)) <= (
        F64_TOL)


def test_engine_arguments(pair):
    _, port = pair
    with pytest.raises(ValueError, match="no fused kernel"):
        BatchedEvaluator(port, dtype=torch.float32, use_fused=True,
                         device="cpu")
    with pytest.raises(ValueError, match="'qd' is not a tier"):
        MultiSpecEvaluator(port, SPECS, dtype="qd", device="cpu")
    with pytest.raises(ValueError, match="derivative_order length 3"):
        BatchedEvaluator(port, derivative_order=[0, 0, 0], device="cpu")
    with pytest.raises(ValueError, match="at least one spec"):
        MultiSpecEvaluator(port, [], device="cpu")
    unbuilt = ChebyshevSpline(_f, 2, DOM, [5, 5], KNOTS, device="cpu")
    with pytest.raises(RuntimeError, match="not built"):
        BatchedEvaluator(unbuilt, device="cpu")
    with pytest.raises(TypeError, match="device"):
        BatchedEvaluator(port)


def test_stacked_piece_cache_sees_in_place_edits(pair, pts, monkeypatch):
    """The class path holds no stacked copy of the pieces: an in-place
    edit of a piece tensor is read by the next call.  An engine (the f32
    masked route's stack, the f64 routed pieces) holds its own copy."""
    _, port = pair
    spl = port.clone()
    monkeypatch.setattr(spline_eval, "MASKED_MAX_PIECES", 6)
    masked = BatchedEvaluator(spl, dtype=torch.float32, device="cpu")
    assert masked._specs_run.masked
    stacked_before = masked(pts)
    before = spl.eval_batch(pts, [0, 0])
    spl._pieces[2].tensor_values.mul_(3.0)
    after = spl.eval_batch(pts, [0, 0])
    flat = spline_eval.route_piece_indices(
        spl.knots, spline_eval.piece_strides([2, 1]), pts).numpy()
    np.testing.assert_allclose(after[flat == 2], 3.0 * before[flat == 2],
                               rtol=1e-13)
    np.testing.assert_array_equal(after[flat != 2], before[flat != 2])
    # The engine snapshots: an edit after construction does not reach it.
    engine = BatchedEvaluator(spl, dtype=torch.float64, device="cpu")
    spl._pieces[2].tensor_values.mul_(0.5)
    assert _dev(engine(pts), after) == 0.0
    assert torch.equal(masked(pts), stacked_before)


def test_dd_plan_refusal_matches_the_reference():
    assert not eval_dd.supports_dd((9,))
    spl = ChebyshevSpline(lambda x, _: abs(x[0]), 1, [[-1, 1]], [9], [[0.0]],
                          device="cpu")
    spl.build(verbose=False)
    with pytest.raises(ValueError, match=r"grid shape \(9,\) is outside"):
        BatchedEvaluator(spl, dtype="dd", device="cpu")
    # The class path's dd takes the f64 path for such pieces.
    p = np.linspace(-0.9, 0.9, 7)[:, None]
    np.testing.assert_allclose(spl.eval_batch_dd(p).numpy(),
                               spl.eval_batch(p, [0]), rtol=0, atol=1e-15)

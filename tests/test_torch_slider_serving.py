"""The port's slider serving: ``ops.slider_eval`` and the slider engines,
against the JAX package, on the CPU.

Tolerances (scale-normalized): f64 paths <= 1e-12 of the JAX f64 path;
f32 engines <= 2e-4 of f64 (the value sum ``sum s_i - (S-1) pivot``
cancels in f32); the dd tier (native f64 here) <= 1e-12 of the port's
f64 and <= 1e-10 of the JAX dd tier.  A spec that crosses groups is
exact zeros.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pychebyshev_tpu import ChebyshevSlider as JaxSlider
from pychebyshev_tpu import serving as jax_serving
from pychebyshev_tpu.ops import slider_eval as jax_slider_eval
from pychebyshev_tpu_torch import (
    BatchedEvaluator,
    ChebyshevSlider,
    MultiSpecEvaluator,
)
from pychebyshev_tpu_torch.ops import slider_eval

F64_TOL = 1e-12
F32_TOL = 2e-4
DD_VS_JAX_DD = 1e-10
BUCKETS = (256, 1024)
D = 6
W = np.linspace(0.5, 1.5, D)
PARTITION = [[0, 1], [2], [3], [4], [5]]
SPECS = ((0, 0, 0, 0, 0, 0),      # value
         (1, 0, 0, 0, 0, 0),      # group [0,1] partial
         (0, 0, 1, 0, 0, 0),      # singleton partial
         (0, 0, 0, 2, 0, 0),      # second derivative
         (1, 1, 0, 0, 0, 0),      # mixed partial inside a group
         (0, 0, 1, 1, 0, 0))      # cross-group -> exact zero
TIERS = {"f32": (jnp.float32, torch.float32, F32_TOL),
         "f64": (jnp.float64, torch.float64, F64_TOL),
         "dd": ("dd", "dd", F64_TOL)}


def basket(p, _=None):
    p = np.asarray(p, dtype=np.float64)
    return (np.sum(W * np.sin(p), axis=1) + 0.25 * np.sum(p ** 2, axis=1)
            + p[:, 0] * p[:, 1] + 3.0)


def _dev(a, ref):
    a = np.asarray(a, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert a.shape == ref.shape
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.fixture(scope="module")
def pair():
    ref = JaxSlider(basket, D, [[-1, 1]] * D, [9] * D, PARTITION,
                    [0.2] * D, vectorized=True)
    ref.build(verbose=False)
    port = ChebyshevSlider(basket, D, [[-1, 1]] * D, [9] * D, PARTITION,
                           [0.2] * D, vectorized=True, device="cpu")
    port.build(verbose=False)
    return ref, port


@pytest.fixture(scope="module")
def pts():
    return np.random.default_rng(0).uniform(-1, 1, (1500, D))


def _data(sl):
    return sl._slide_data() if isinstance(sl, ChebyshevSlider) else tuple(
        (s.tensor_values,) + s._grid_tuples() for s in sl.slides)


GROUPS = tuple(tuple(g) for g in PARTITION)


class TestOpsParity:
    def test_value_and_multi_match_jax(self, pair, pts):
        ref, port = pair
        want = np.asarray(jax_slider_eval.slider_value_batch(
            _data(ref), ref.pivot_value, GROUPS, jnp.asarray(pts)))
        got = slider_eval.slider_value_batch(
            _data(port), port.pivot_value, GROUPS, torch.tensor(pts))
        assert _dev(got, want) <= F64_TOL
        plan = tuple(port._multi_spec_plans(SPECS))
        assert plan == tuple(ref._multi_spec_plans(SPECS))
        got = slider_eval.slider_multi_batch(
            _data(port), port.pivot_value, GROUPS, plan, torch.tensor(pts))
        want = np.asarray(jax_slider_eval.slider_multi_batch(
            _data(ref), ref.pivot_value, GROUPS, plan, jnp.asarray(pts)))
        assert _dev(got, want) <= F64_TOL

    @pytest.mark.parametrize("orders", [None, SPECS[4], SPECS[5]],
                             ids=["value", "mixed", "cross"])
    def test_batch_dd(self, pair, pts, orders):
        ref, port = pair
        got = slider_eval.slider_batch_dd(
            _data(port), port.pivot_value, GROUPS, pts, orders=orders)
        assert got.dtype == torch.float64
        f64 = port.eval_batch(pts, orders)
        want_dd = np.asarray(jax_slider_eval.slider_batch_dd(
            _data(ref), ref.pivot_value, GROUPS, pts, orders=orders))
        if orders == SPECS[5]:
            assert not torch.any(got) and not np.any(want_dd)
            return
        assert _dev(got, f64) <= F64_TOL
        assert _dev(got, want_dd) <= DD_VS_JAX_DD

    def test_multi_batch_dd(self, pair, pts):
        ref, port = pair
        got = slider_eval.slider_multi_batch_dd(
            _data(port), port.pivot_value, GROUPS, SPECS, pts)
        assert got.shape == (len(pts), len(SPECS))
        f64 = port.vectorized_eval_batch_multi(pts, SPECS)
        want_dd = np.asarray(jax_slider_eval.slider_multi_batch_dd(
            _data(ref), ref.pivot_value, GROUPS, SPECS, pts))
        for k in range(5):
            assert _dev(got[:, k], f64[:, k]) <= F64_TOL
            assert _dev(got[:, k], want_dd[:, k]) <= DD_VS_JAX_DD
        assert not torch.any(got[:, 5])
        empty = slider_eval.slider_multi_batch_dd(
            _data(port), port.pivot_value, GROUPS, (), pts[:3])
        assert empty.shape == (3, 0)
        with pytest.raises(ValueError, match="length"):
            slider_eval.slider_dd_multi_runner(
                _data(port), port.pivot_value, GROUPS, [(0, 0)])


class TestPlan:
    @pytest.mark.parametrize("shapes", [
        [(9,)] * 10, [(9, 9), (9,), (9,)], [(5, 5, 5, 5)],
        [(1 << 12,)] * 16, [(40, 40, 40)], []])
    def test_plan_matches_the_reference(self, shapes):
        assert (slider_eval.slider_dd_plan(shapes)["ok"]
                == jax_slider_eval.slider_dd_plan(shapes)["ok"])

    def test_ops_raises_outside_budget(self):
        data = ((torch.zeros((5, 5, 5, 5)), (), (), ()),)
        with pytest.raises(ValueError, match="digit-GEMM budget"):
            slider_eval.slider_batch_dd(data, 0.0, ((0, 1, 2, 3),),
                                        np.zeros((4, 4)))


class TestClassSurface:
    def test_matches_eval_batch_and_jax(self, pair, pts):
        ref, port = pair
        got = port.eval_batch_dd(pts)
        assert isinstance(got, torch.Tensor)
        assert _dev(got, port.eval_batch(pts)) <= F64_TOL
        assert _dev(got, ref.eval_batch_dd(pts)) <= DD_VS_JAX_DD
        fast = port.eval_batch_dd(pts, mode="fast")
        assert _dev(fast, port.eval_batch(pts)) <= F64_TOL

    def test_bad_mode_and_unbuilt(self, pair, pts):
        with pytest.raises(ValueError, match="mode"):
            pair[1].eval_batch_dd(pts, mode="warp")
        sl = ChebyshevSlider(basket, D, [[-1, 1]] * D, [9] * D,
                             [[i] for i in range(D)], [0.0] * D,
                             device="cpu")
        with pytest.raises(RuntimeError, match="build"):
            sl.eval_batch_dd(np.zeros((2, D)))

    def test_wide_group_and_out_of_domain_take_f64(self, pts):
        sl = ChebyshevSlider(basket, D, [[-1, 1]] * D, [5] * D,
                             [[0, 1, 2, 3], [4], [5]], [0.0] * D,
                             vectorized=True, device="cpu")
        sl.build(verbose=False)
        assert torch.equal(sl.eval_batch_dd(pts[:64]),
                           sl.eval_batch_device(pts[:64]))
        with pytest.raises(ValueError, match="plan budget"):
            BatchedEvaluator(sl, dtype="dd", device="cpu")
        with pytest.raises(ValueError, match="plan budget"):
            MultiSpecEvaluator(sl, SPECS, dtype="dd", device="cpu")


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("k", [0, 2, 5], ids=["value", "singleton",
                                              "cross"])
def test_batched_evaluator(pair, pts, tier, k):
    ref, port = pair
    jdt, tdt, tol = TIERS[tier]
    orders = list(SPECS[k])
    want = port.eval_batch(pts, orders)
    engine = BatchedEvaluator(port, dtype=tdt, derivative_order=orders,
                              bucket_sizes=BUCKETS, device="cpu")
    engine.warmup()
    got = engine(pts)
    assert got.shape == (len(pts),)
    assert got.dtype == (torch.float32 if tier == "f32" else torch.float64)
    if k == 5:
        assert not torch.any(got)
        return
    assert _dev(got, want) <= tol
    if tier != "f32":
        jax_engine = jax_serving.BatchedEvaluator(
            ref, dtype=jdt, derivative_order=orders, bucket_sizes=BUCKETS)
        assert _dev(got, jax_engine(pts)) <= (
            DD_VS_JAX_DD if tier == "dd" else F64_TOL)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_multi_spec_evaluator(pair, pts, tier):
    ref, port = pair
    jdt, tdt, tol = TIERS[tier]
    want = port.vectorized_eval_batch_multi(pts, SPECS)
    engine = MultiSpecEvaluator(port, SPECS, dtype=tdt,
                                bucket_sizes=BUCKETS, device="cpu")
    engine.warmup()
    got = engine(pts)
    assert got.shape == (len(pts), len(SPECS))
    for k in range(5):
        assert _dev(got[:, k], want[:, k]) <= tol
    assert not torch.any(got[:, 5])
    if tier == "dd":
        jax_report = jax_serving.MultiSpecEvaluator(
            ref, SPECS, dtype="dd", bucket_sizes=BUCKETS)(pts)
        assert _dev(got[:, :5], jax_report[:, :5]) <= DD_VS_JAX_DD
        assert torch.equal(engine(pts), got)        # repeat calls agree


def test_f32_value_sum_holds_the_ceiling_against_cancellation():
    """Ten slides around a large pivot: sum s_i - 9 pivot cancels in
    f32, and must still hold 2e-4 of f64."""
    def f(p, _=None):
        p = np.asarray(p, dtype=np.float64)
        return 100.0 + np.sum(0.1 * np.sin(p), axis=1)

    sl = ChebyshevSlider(f, 10, [[-1, 1]] * 10, [9] * 10,
                         [[i] for i in range(10)], [0.0] * 10,
                         vectorized=True, device="cpu")
    sl.build(verbose=False)
    p = np.random.default_rng(3).uniform(-1, 1, (2000, 10))
    f32 = BatchedEvaluator(sl, dtype=torch.float32, device="cpu")(p)
    f64 = BatchedEvaluator(sl, dtype=torch.float64, device="cpu")(p)
    assert _dev(f32, f64) <= F32_TOL
    assert _dev(f64, f(p)) <= 1e-9         # 9 nodes a dim


def test_dd_engines_send_out_of_domain_to_the_f64_sibling(pair, pts):
    _, port = pair
    ood = pts[:64].copy()
    ood[3, 2] = 1.5
    for orders in (None, list(SPECS[1])):
        dd = BatchedEvaluator(port, dtype="dd", derivative_order=orders,
                              device="cpu")(ood)
        f64 = BatchedEvaluator(port, dtype=torch.float64,
                               derivative_order=orders, device="cpu")(ood)
        assert torch.equal(dd, f64)
    got = MultiSpecEvaluator(port, SPECS, dtype="dd", device="cpu")(ood)
    want = MultiSpecEvaluator(port, SPECS, dtype=torch.float64,
                              device="cpu")(ood)
    assert torch.equal(got, want)
    assert _dev(port.eval_batch_dd(ood), port.eval_batch(ood)) == 0.0


def test_engine_arguments_and_snapshots(pair, pts):
    _, port = pair
    with pytest.raises(ValueError, match="no fused kernel"):
        BatchedEvaluator(port, dtype=torch.float32, use_fused=True,
                         device="cpu")
    with pytest.raises(ValueError, match="derivative_order length"):
        BatchedEvaluator(port, derivative_order=[0, 0], device="cpu")
    with pytest.raises(ValueError, match="'qd' is not a tier"):
        BatchedEvaluator(port, dtype="qd", device="cpu")
    unbuilt = ChebyshevSlider(basket, D, [[-1, 1]] * D, [5] * D, PARTITION,
                              [0.0] * D, device="cpu")
    with pytest.raises(RuntimeError, match="not built"):
        MultiSpecEvaluator(unbuilt, SPECS, device="cpu")
    clone = port.clone()
    engine = BatchedEvaluator(clone, dtype=torch.float64, device="cpu")
    before = engine(pts)
    clone.slides[0].tensor_values.mul_(2.0)
    assert torch.equal(engine(pts), before)

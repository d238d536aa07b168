"""PyTorch port of the near-f64 ("dd") tier against the JAX package.

The port serves the dd APIs in native f64 (``ops.eval_dd``, the class
method ``eval_batch_dd`` and the dd serving engines).  Tolerances
(scale-normalized): <= 1e-10 of the JAX dd results, the tier's
contract; <= 1e-12 of the JAX f64 results, since the port's dd values
are f64 and differ from them in summation order only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import BS_DOMAIN_5D, bs_price_vectorized
from pychebyshev_tpu import ChebyshevApproximation as JaxApprox
from pychebyshev_tpu import serving as jax_serving
from pychebyshev_tpu.ops import eval_dd as jax_dd
from pychebyshev_tpu_torch import (
    BatchedEvaluator,
    ChebyshevApproximation,
    MultiSpecEvaluator,
)
from pychebyshev_tpu_torch.ops import eval_dd, fused_dd

DD_TOL = 1e-10
F64_TOL = 1e-12
BUCKETS = (128, 512)
SPECS = [(0, 0, 0, 0, 0), (1, 0, 0, 0, 0), (2, 0, 0, 0, 0),
         (0, 0, 1, 0, 0), (0, 0, 0, 1, 0), (0, 0, 0, 0, 1)]


def _dev(a, ref):
    a = np.asarray(a, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert a.shape == ref.shape
    return np.abs(a - ref).max() / np.abs(ref).max()


def _port_of(ref):
    return ChebyshevApproximation.from_values(
        np.asarray(ref.tensor_values), ref.num_dimensions, ref.domain,
        ref.n_nodes, device="cpu")


@pytest.fixture(scope="module")
def pair():
    ref = JaxApprox(bs_price_vectorized, 5, BS_DOMAIN_5D, [7] * 5,
                    vectorized=True)
    ref.build(verbose=False)
    return ref, _port_of(ref)


@pytest.fixture(scope="module")
def pts():
    rng = np.random.default_rng(31)
    lo = np.array([b[0] for b in BS_DOMAIN_5D])
    hi = np.array([b[1] for b in BS_DOMAIN_5D])
    return lo + (hi - lo) * rng.uniform(0.02, 0.98, (700, 5))


@pytest.fixture(scope="module")
def small():
    """A 3-D (9, 8, 7) pair, a grid both dd routes of the port take."""
    ref = JaxApprox(lambda p, _: np.sin(p[:, 0]) * np.exp(p[:, 1])
                    + p[:, 2] ** 3, 3, [[-1, 1], [0, 2], [-2, 2]],
                    [9, 8, 7], vectorized=True)
    ref.build(verbose=False)
    rng = np.random.default_rng(3)
    p = np.column_stack([rng.uniform(-1, 1, 300), rng.uniform(0, 2, 300),
                         rng.uniform(-2, 2, 300)])
    return ref, _port_of(ref), p


def _port_grid(port):
    return (port.tensor_values, *port._grid_tuples())


@pytest.mark.parametrize("orders", [(0,) * 5, (1, 0, 0, 0, 0),
                                    (0, 0, 0, 0, 1)])
def test_eval_batch_dd_matches_reference(pair, pts, orders):
    ref, port = pair
    want_dd = np.asarray(jax_dd.eval_batch_dd(
        ref.tensor_values, *ref._grid_tuples(), pts, orders))
    want64 = np.asarray(ref.vectorized_eval_batch(pts, list(orders)))
    got = eval_dd.eval_batch_dd(*_port_grid(port), pts, orders)
    assert got.dtype == torch.float64 and got.shape == (len(pts),)
    assert _dev(got.numpy(), want_dd) <= DD_TOL
    assert _dev(got.numpy(), want64) <= F64_TOL
    # The 5-D grid goes through the f64 kernel's route (its plain
    # version on the CPU), bit for bit.
    direct = fused_dd.fused_eval_batch_dd_reference(
        *_port_grid(port), torch.tensor(pts), orders)
    assert torch.equal(got, direct)


def test_multi_matches_reference_and_single(pair, pts):
    ref, port = pair
    want = np.asarray(jax_dd.eval_batch_dd_multi(
        ref.tensor_values, *ref._grid_tuples(), pts, SPECS))
    got = eval_dd.eval_batch_dd_multi(*_port_grid(port), pts, SPECS)
    assert got.shape == (len(pts), len(SPECS))
    for m, s in enumerate(SPECS):
        assert _dev(got[:, m].numpy(), want[:, m]) <= DD_TOL, s
        want64 = ref.vectorized_eval_batch(pts, list(s))
        assert _dev(got[:, m].numpy(), want64) <= F64_TOL, s
        single = eval_dd.eval_batch_dd(*_port_grid(port), pts, s)
        assert torch.equal(got[:, m], single), s
    empty = eval_dd.eval_batch_dd_multi(*_port_grid(port), pts[:5], ())
    assert empty.shape == (5, 0)
    with pytest.raises(ValueError, match="length"):
        eval_dd.eval_batch_dd_multi(*_port_grid(port), pts, ((0, 0),))


def test_models_matches_reference(small):
    ref, port, p = small
    rng = np.random.default_rng(8)
    books = [np.asarray(ref.tensor_values) * (1 + 0.2 * k)
             + rng.standard_normal((9, 8, 7)) * 0.1 for k in range(3)]
    want = np.asarray(jax_dd.eval_batch_dd_models(
        tuple(jnp.asarray(b) for b in books), *ref._grid_tuples(), p,
        (0, 1, 0)))
    nodes, weights, diffs = port._grid_tuples()
    tensors = tuple(torch.tensor(b) for b in books)
    got = eval_dd.eval_batch_dd_models(tensors, nodes, weights, diffs, p,
                                       (0, 1, 0))
    assert got.shape == (3, len(p))
    runner = eval_dd.dd_models_runner(tensors, nodes, weights, diffs,
                                      (0, 1, 0))
    for i in range(3):
        assert _dev(got[i].numpy(), want[i]) <= DD_TOL
        assert torch.equal(runner(p)[i], got[i])
    with pytest.raises(ValueError, match="non-empty"):
        eval_dd.eval_batch_dd_models((), nodes, weights, diffs, p)
    with pytest.raises(ValueError, match="one grid shape"):
        eval_dd.eval_batch_dd_models((tensors[0], tensors[0][:5]), nodes,
                                     weights, diffs, p)


def test_multi_runner_holds_its_operands(small, monkeypatch):
    """The runner packs every spec once, at construction."""
    ref, port, p = small
    specs = ((0, 0, 0), (1, 0, 0), (0, 2, 0))
    runner = eval_dd.dd_multi_runner(*_port_grid(port), specs)
    calls = []
    real = fused_dd._pack
    monkeypatch.setattr(fused_dd, "_pack",
                        lambda *a: calls.append(1) or real(*a))
    first = runner(p)
    assert torch.equal(runner(p), first) and calls == []
    want = np.asarray(jax_dd.eval_batch_dd_multi(
        ref.tensor_values, *ref._grid_tuples(), p, specs))
    for m in range(len(specs)):
        assert _dev(first[:, m].numpy(), want[:, m]) <= DD_TOL


@pytest.mark.parametrize("mode", ["accurate", "fast"])
def test_class_method_modes(pair, pts, mode):
    ref, port = pair
    want_dd = np.asarray(ref.eval_batch_dd(pts, mode="accurate"))
    want64 = np.asarray(ref.vectorized_eval_batch(pts, [0] * 5))
    got = port.eval_batch_dd(pts, mode=mode)
    assert got.dtype == torch.float64
    assert _dev(got.numpy(), want_dd) <= DD_TOL
    assert _dev(got.numpy(), want64) <= F64_TOL
    # f64 is inside every cutoff's error: the mode changes nothing.
    assert torch.equal(got, port.eval_batch_dd(pts))
    delta = port.eval_batch_dd(pts, [1, 0, 0, 0, 0], mode=mode)
    assert _dev(delta.numpy(),
                ref.vectorized_eval_batch(pts, [1, 0, 0, 0, 0])) <= F64_TOL


def test_bad_mode_message_matches_reference(pair):
    ref, port = pair
    with pytest.raises(ValueError) as want:
        ref.eval_batch_dd(np.zeros((4, 5)), mode="quick")
    with pytest.raises(ValueError) as got:
        port.eval_batch_dd(np.zeros((4, 5)), mode="quick")
    assert str(got.value) == str(want.value)


def test_cutoff_is_validated_and_changes_nothing(small):
    _, port, p = small
    base = eval_dd.eval_batch_dd(*_port_grid(port), p)
    for cutoff in (eval_dd.FAST_PAIR_CUTOFF, 44, 20.5):
        assert torch.equal(
            eval_dd.eval_batch_dd(*_port_grid(port), p, cutoff=cutoff), base)
    for bad in (-1, "fast", True, float("nan")):
        with pytest.raises(ValueError, match="cutoff"):
            eval_dd.eval_batch_dd(*_port_grid(port), p, cutoff=bad)


@pytest.mark.parametrize("shape", [
    (21,), (6, 6), (5, 5), (7,) * 4, (11,) * 5, (13,) * 5, (15,) * 5,
    (17,) * 5, (19,) * 5, (21,) * 5, (9,) * 6, (11,) * 7, (21, 21, 21),
    (64,) * 4, (200, 200, 200), (3, 4096), (4096, 3), (2,) * 12,
    (3, 5, 7), (8, 9, 7)])
def test_plan_agrees_with_reference(shape):
    assert eval_dd.supports_dd(shape) == jax_dd.supports_dd(shape)
    want = jax_dd.dd_plan(shape)
    got = eval_dd.dd_plan(shape)
    assert got["ok"] == want["ok"]
    if got["ok"]:
        for key in ("s", "n_left", "n_right"):
            assert got[key] == want[key], key


def test_unsupported_shape_errors_match_reference():
    big = np.zeros((200, 200, 200))
    assert not eval_dd.supports_dd(big.shape)
    jgrid = (jnp.asarray(big), (), (), ())
    tgrid = (torch.tensor(big), (), (), ())
    pts = np.zeros((4, 3))
    calls = [
        (lambda g: jax_dd.eval_batch_dd(*g, pts),
         lambda g: eval_dd.eval_batch_dd(*g, pts)),
        (lambda g: jax_dd.eval_batch_dd_multi(*g, pts, ((0, 0, 0),)),
         lambda g: eval_dd.eval_batch_dd_multi(*g, pts, ((0, 0, 0),))),
        (lambda g: jax_dd.eval_batch_dd_models((g[0],), *g[1:], pts),
         lambda g: eval_dd.eval_batch_dd_models((g[0],), *g[1:], pts)),
        (lambda g: jax_dd.dd_multi_runner(*g, ((0, 0, 0),)),
         lambda g: eval_dd.dd_multi_runner(*g, ((0, 0, 0),))),
    ]
    for jax_call, port_call in calls:
        with pytest.raises(ValueError) as want:
            jax_call(jgrid)
        with pytest.raises(ValueError) as got:
            port_call(tgrid)
        assert str(got.value) == str(want.value)


def test_1d_grid_takes_the_f64_path():
    import math
    ref = JaxApprox(lambda x, _: math.sin(x[0]), 1, [[-1, 1]], [21])
    ref.build(verbose=False)
    port = _port_of(ref)
    p = np.linspace(-0.9, 0.9, 64).reshape(-1, 1)
    got = port.eval_batch_dd(p)
    assert torch.equal(got, port.eval_batch_device(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.eval_batch_dd(p)),
                               rtol=0, atol=1e-12)


def test_2d_grid_takes_the_plain_f64_route():
    """(6, 6) is inside the dd plan but under the kernel's 3 dims: the
    plain f64 route of ``ops.eval`` serves it."""
    ref = JaxApprox(lambda p, _: p[:, 0] * p[:, 1] + np.sin(p[:, 0]), 2,
                    [[-1, 1], [-1, 1]], [6, 6], vectorized=True)
    ref.build(verbose=False)
    port = _port_of(ref)
    p = np.random.default_rng(5).uniform(-1, 1, (50, 2))
    assert eval_dd.supports_dd((6, 6))
    assert not fused_dd.supports_fused_dd((6, 6))
    got = port.eval_batch_dd(p, [1, 0])
    assert _dev(got.numpy(), np.asarray(ref.eval_batch_dd(p, [1, 0]))) \
        <= DD_TOL
    assert _dev(got.numpy(), ref.vectorized_eval_batch(p, [1, 0])) <= F64_TOL
    multi = eval_dd.eval_batch_dd_multi(*_port_grid(port), p,
                                        ((0, 0), (1, 0)))
    assert torch.equal(multi[:, 1], got)


def test_out_of_domain_takes_the_f64_path(pair, pts):
    ref, port = pair
    ood = pts[:40].copy()
    ood[3, 0] = 130.0            # S above its domain's 120
    ood[7, 4] = 0.0              # r below its domain's 0.01
    got = port.eval_batch_dd(ood)
    assert torch.equal(got, port.eval_batch_device(ood))
    assert _dev(got.numpy(), np.asarray(ref.eval_batch_dd(ood))) <= F64_TOL


class TestEngines:
    @pytest.mark.parametrize("orders", [None, (1, 0, 0, 0, 0)])
    def test_batched_evaluator_dd(self, pair, pts, orders):
        ref, port = pair
        want_dd = jax_serving.BatchedEvaluator(
            ref, dtype="dd", derivative_order=orders,
            bucket_sizes=BUCKETS)(pts)
        want64 = jax_serving.BatchedEvaluator(
            ref, dtype=jnp.float64, derivative_order=orders,
            bucket_sizes=BUCKETS)(pts)
        engine = BatchedEvaluator(port, dtype="dd", derivative_order=orders,
                                  bucket_sizes=BUCKETS, device="cpu")
        engine.warmup()
        for n in (1, 129, 700):   # a single point, ragged, two slices
            got = engine(pts[:n])
            assert got.dtype == torch.float64 and got.shape == (n,)
            assert _dev(got.numpy(), want_dd[:n]) <= DD_TOL
            assert _dev(got.numpy(), want64[:n]) <= F64_TOL
        assert fused_dd.launches == 0

    def test_multi_spec_evaluator_dd(self, pair, pts):
        ref, port = pair
        want_dd = jax_serving.MultiSpecEvaluator(
            ref, SPECS, dtype="dd", bucket_sizes=BUCKETS)(pts)
        want64 = jax_serving.MultiSpecEvaluator(
            ref, SPECS, dtype=jnp.float64, bucket_sizes=BUCKETS)(pts)
        engine = MultiSpecEvaluator(port, SPECS, dtype="dd",
                                    bucket_sizes=BUCKETS, device="cpu")
        engine.warmup()
        got = engine(pts)
        assert got.shape == (len(pts), len(SPECS))
        assert got.dtype == torch.float64
        for k in range(len(SPECS)):
            assert _dev(got[:, k].numpy(), want_dd[:, k]) <= DD_TOL
            assert _dev(got[:, k].numpy(), want64[:, k]) <= F64_TOL

    def test_out_of_domain_calls_take_the_f64_sibling(self, pair, pts):
        _, port = pair
        ood = pts[:50].copy()
        ood[5, 1] = 85.0          # K below its domain's 90
        for make in (
                lambda dt: BatchedEvaluator(port, dtype=dt,
                                            bucket_sizes=BUCKETS,
                                            device="cpu"),
                lambda dt: MultiSpecEvaluator(port, SPECS, dtype=dt,
                                              bucket_sizes=BUCKETS,
                                              device="cpu")):
            dd, f64 = make("dd"), make(torch.float64)
            dd(pts[:50])
            assert dd._dd_fallback is None      # in-domain: no sibling
            assert torch.equal(dd(ood), f64(ood))
            assert dd._dd_fallback is not None

    def test_engines_refuse_what_the_reference_refuses(self):
        ref = JaxApprox(lambda x, _: x[0] ** 2, 1, [[-1, 1]], [9])
        ref.build(verbose=False)
        port = _port_of(ref)
        for engine in (lambda **k: BatchedEvaluator(port, **k),
                       lambda **k: MultiSpecEvaluator(port, [(0,)], **k)):
            with pytest.raises(ValueError, match="plan budget"):
                engine(dtype="dd", device="cpu")
        port3 = ChebyshevApproximation(
            lambda x, _: x[0] + x[1] * x[2], 3, [[-1, 1]] * 3, [5, 5, 5],
            device="cpu")
        port3.build(verbose=False)
        with pytest.raises(ValueError, match="use_fused"):
            BatchedEvaluator(port3, dtype="dd", use_fused=True,
                             device="cpu")

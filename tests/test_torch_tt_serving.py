"""The port's serving engines on tensor trains and books, against the
JAX package's engines, on the CPU.

Tolerances (scale-normalized): f64 engines <= 1e-12 of the JAX f64
engine; f32 <= 2e-4; ``dtype="dd"`` (native f64 here) <= 1e-12 of the
JAX f64 engine and <= 1e-9 of the JAX dd engine (whose own digit tier is
1e-10-class on these small grids).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pychebyshev_tpu import ChebyshevApproximation as JaxApprox
from pychebyshev_tpu import ChebyshevTT as JaxTT
from pychebyshev_tpu import serving as jax_serving
from pychebyshev_tpu_torch import (
    BatchedEvaluator,
    ChebyshevApproximation,
    ChebyshevTT,
    MultiModelEvaluator,
    MultiSpecEvaluator,
)

F64_TOL = 1e-12
F32_TOL = 2e-4
DD_VS_JAX_DD = 1e-9

DOM = [[-1.0, 1.0], [0.0, 2.0], [-1.0, 1.0], [0.0, 1.0]]
NS = [7, 6, 8, 5]
PERM = [2, 0, 3, 1]
TIERS = {"f32": (jnp.float32, torch.float32, F32_TOL),
         "f64": (jnp.float64, torch.float64, F64_TOL),
         "dd": ("dd", "dd", F64_TOL)}
BUCKETS = (256, 1024)


def _f(p, _=None):
    p = np.asarray(p, dtype=np.float64)
    return (np.sin(p[:, 0]) * np.cos(p[:, 1]) + p[:, 2] ** 2 * p[:, 0]
            + np.exp(0.3 * p[:, 3]) * p[:, 1])


def _g(p, _=None):
    p = np.asarray(p, dtype=np.float64)
    return np.cos(p[:, 0] + p[:, 2]) * (1.0 + p[:, 1]) + 0.2 * p[:, 3]


def _dev(a, ref):
    a = np.asarray(a, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert a.shape == ref.shape
    return np.abs(a - ref).max() / np.abs(ref).max()


def _points(n, seed, lo=0.02, hi=0.98):
    rng = np.random.default_rng(seed)
    dom = np.asarray(DOM)
    return dom[:, 0] + (dom[:, 1] - dom[:, 0]) * rng.uniform(
        lo, hi, size=(n, 4))


def _tt_pair(fn, max_rank, seed):
    ref = JaxTT(fn, 4, DOM, NS, max_rank=max_rank, vectorized=True)
    ref.build(verbose=False, seed=seed)
    port = ChebyshevTT(fn, 4, DOM, NS, max_rank=max_rank, vectorized=True,
                       device="cpu")
    port.build(verbose=False, seed=seed)
    return ref, port


@pytest.fixture(scope="module")
def tts():
    """(canonical pair, reordered pair, a second low-rank pair)."""
    ref, port = _tt_pair(_f, 6, 5)
    low_ref, low_port = _tt_pair(_g, 2, 6)
    return {"canonical": (ref, port),
            "reordered": (ref.reorder(PERM), port.reorder(PERM)),
            "low": (low_ref, low_port)}


@pytest.fixture(scope="module")
def dense():
    out = []
    for fn in (_f, _g):
        ref = JaxApprox(fn, 4, DOM, NS, vectorized=True)
        ref.build(verbose=False)
        port = ChebyshevApproximation(fn, 4, DOM, NS, vectorized=True,
                                      device="cpu")
        port.build(verbose=False)
        out.append((ref, port))
    return out


@pytest.fixture(scope="module")
def pts():
    return _points(1500, 31)         # spans two slices of the 1024 bucket


@pytest.mark.parametrize("frame", ["canonical", "reordered"])
@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("orders", [None, [1, 0, 0, 0], [0, 1, 0, 2]],
                         ids=["value", "delta", "mixed"])
def test_tt_batched_evaluator(tts, pts, frame, tier, orders):
    ref, port = tts[frame]
    jdt, tdt, tol = TIERS[tier]
    want64 = jax_serving.BatchedEvaluator(
        ref, dtype=jnp.float64, derivative_order=orders,
        bucket_sizes=BUCKETS)(pts)
    engine = BatchedEvaluator(port, dtype=tdt, derivative_order=orders,
                              bucket_sizes=BUCKETS, device="cpu")
    engine.warmup()
    got = engine(pts)
    assert isinstance(got, torch.Tensor) and got.shape == (len(pts),)
    assert got.dtype == (torch.float32 if tier == "f32" else torch.float64)
    assert _dev(got, want64) <= tol
    same_tier = jax_serving.BatchedEvaluator(
        ref, dtype=jdt, derivative_order=orders, bucket_sizes=BUCKETS)(pts)
    assert _dev(got, same_tier) <= (DD_VS_JAX_DD if tier == "dd" else tol)
    if orders is not None:
        host = port.differentiate(orders)
        assert _dev(got[:32], [host.eval(p) for p in pts[:32]]) <= tol
    # ragged sizes, a list of floats, and one point
    for n in (1, 257):
        assert _dev(engine(pts[:n].tolist()), want64[:n]) <= tol


def test_tt_dd_engine_out_of_domain_goes_to_the_f64_sibling(tts, pts):
    for frame in ("canonical", "reordered"):
        ref, port = tts[frame]
        ood = pts.copy()
        ood[11, 1] = 2.4                       # user dim 1 above [0, 2]
        engine = BatchedEvaluator(port, dtype="dd", bucket_sizes=BUCKETS,
                                  device="cpu")
        assert engine._dd_fallback is None
        got = engine(ood)
        assert engine._dd_fallback is not None
        sibling = BatchedEvaluator(port, dtype=torch.float64,
                                   bucket_sizes=BUCKETS, device="cpu")
        assert torch.equal(got, sibling(ood))
        want = jax_serving.BatchedEvaluator(ref, dtype="dd",
                                            bucket_sizes=BUCKETS)(ood)
        assert _dev(got, want) <= F64_TOL
        assert _dev(got[11:12], [port.eval(ood[11])]) <= F64_TOL


def test_tt_engine_refusals(tts):
    _, port = tts["canonical"]
    wide = ChebyshevTT.from_values(
        np.cos(np.linspace(0, 1, 1 << 14)), 1, [[0.0, 1.0]], [1 << 14],
        max_rank=1, device="cpu")
    with pytest.raises(ValueError, match=r"TT core shapes \[\(1, 16384, 1\)"
                                         r"\] are outside the digit-GEMM "
                                         r"plan budget; serve at dtype="
                                         r"torch.float64 instead"):
        BatchedEvaluator(wide, dtype="dd", device="cpu")
    assert BatchedEvaluator(wide, dtype=torch.float64, device="cpu")(
        [[0.5]]).shape == (1,)
    with pytest.raises(ValueError, match="'qd' is not a tier"):
        BatchedEvaluator(port, dtype="qd", device="cpu")
    with pytest.raises(ValueError, match="no fused kernel"):
        BatchedEvaluator(port, use_fused=True, device="cpu")
    with pytest.raises(ValueError, match="derivative_order length 2"):
        BatchedEvaluator(port, derivative_order=[1, 0], device="cpu")
    unbuilt = ChebyshevTT(_f, 4, DOM, NS, device="cpu")
    with pytest.raises(RuntimeError, match="Call build"):
        BatchedEvaluator(unbuilt, device="cpu")
    with pytest.raises(ValueError, match=r"shape \(N, 4\)"):
        BatchedEvaluator(port, device="cpu")(np.zeros((3, 5)))
    with pytest.raises(TypeError, match=r"differentiate\(\) per spec \+ "
                                        r"MultiModelEvaluator"):
        MultiSpecEvaluator(port, [[0, 0, 0, 0]], device="cpu")
    with pytest.raises(TypeError, match="device"):
        MultiModelEvaluator([port])


def test_engine_snapshots_its_cores(tts, pts):
    """The engine owns device copies: later algebra on the model (which
    replaces its host cores) does not reach a built engine."""
    _, base = tts["canonical"]
    port = base.clone()
    engine = BatchedEvaluator(port, dtype=torch.float64, device="cpu")
    before = engine(pts[:64])
    port._coeff_cores[0] = port._coeff_cores[0] * 2.0
    assert torch.equal(engine(pts[:64]), before)
    assert _dev(port.eval_batch(pts[:64]), 2.0 * before) <= F64_TOL


GREEKS = [None, [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1],
          [2, 0, 0, 0]]


@pytest.mark.parametrize("frame", ["canonical", "reordered"])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_tt_risk_report_book(tts, pts, frame, tier):
    """Price plus five differentiate()d Greeks as one TT book."""
    ref, port = tts[frame]
    jdt, tdt, tol = TIERS[tier]
    ref_models = [ref if o is None else ref.differentiate(o) for o in GREEKS]
    port_models = [port if o is None else port.differentiate(o)
                   for o in GREEKS]
    book = MultiModelEvaluator(port_models, dtype=tdt,
                               bucket_sizes=BUCKETS, device="cpu")
    book.warmup()
    got = book(pts)
    assert got.shape == (6, len(pts)) and book.num_models == 6
    want64 = jax_serving.MultiModelEvaluator(
        ref_models, dtype=jnp.float64, bucket_sizes=BUCKETS)(pts)
    scale = np.abs(want64).max(axis=1, keepdims=True)
    assert (np.abs(got.double().numpy() - want64) / scale).max() <= tol
    same_tier = jax_serving.MultiModelEvaluator(
        ref_models, dtype=jdt, bucket_sizes=BUCKETS)(pts)
    assert (np.abs(got.double().numpy() - same_tier) / scale).max() <= (
        DD_VS_JAX_DD if tier == "dd" else tol)
    for i, m in enumerate(port_models):
        single = BatchedEvaluator(m, dtype=tdt, bucket_sizes=BUCKETS,
                                  device="cpu")(pts)
        assert _dev(got[i], single) <= (1e-6 if tier == "f32" else 1e-14)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_tt_book_rank_padding_and_derivative_order(tts, pts, tier):
    """A rank-6 model and a rank-2 model in one book: zero-padded bonds
    change no value, with or without a shared derivative spec."""
    jdt, tdt, tol = TIERS[tier]
    (ref_a, port_a), (ref_b, port_b) = tts["canonical"], tts["low"]
    assert max(port_a.tt_ranks) > max(port_b.tt_ranks)
    for orders in (None, [0, 0, 1, 0]):
        book = MultiModelEvaluator([port_a, port_b], dtype=tdt,
                                   derivative_order=orders,
                                   bucket_sizes=BUCKETS, device="cpu")
        got = book(pts)
        want = jax_serving.MultiModelEvaluator(
            [ref_a, ref_b], dtype=jnp.float64, derivative_order=orders,
            bucket_sizes=BUCKETS)(pts)
        for i, m in enumerate((port_a, port_b)):
            assert _dev(got[i], want[i]) <= tol
            single = BatchedEvaluator(m, dtype=tdt, derivative_order=orders,
                                      bucket_sizes=BUCKETS,
                                      device="cpu")(pts)
            assert _dev(got[i], single) <= (1e-6 if tier == "f32"
                                            else 1e-14)


def test_tt_dd_book_out_of_domain_gets_user_frame_points_back(tts, pts):
    ref, port = tts["reordered"]
    ood = pts[:300].copy()
    ood[5, 3] = -0.2                           # user dim 3 below [0, 1]
    models = [port, port.differentiate([1, 0, 0, 0])]
    book = MultiModelEvaluator(models, dtype="dd", bucket_sizes=BUCKETS,
                               device="cpu")
    got = book(ood)
    sibling = MultiModelEvaluator(models, dtype=torch.float64,
                                  bucket_sizes=BUCKETS, device="cpu")
    assert torch.equal(got, sibling(ood))
    want = jax_serving.MultiModelEvaluator(
        [ref, ref.differentiate([1, 0, 0, 0])], dtype="dd",
        bucket_sizes=BUCKETS)(ood)
    assert _dev(got, want) <= F64_TOL
    assert _dev(got[0, 5:6], [port.eval(ood[5])]) <= F64_TOL


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("orders", [None, [0, 1, 0, 0]],
                         ids=["value", "d1"])
def test_dense_book(dense, pts, tier, orders):
    jdt, tdt, tol = TIERS[tier]
    refs, ports = [r for r, _ in dense], [p for _, p in dense]
    book = MultiModelEvaluator(ports, dtype=tdt, derivative_order=orders,
                               bucket_sizes=BUCKETS, device="cpu")
    book.warmup()
    got = book(pts)
    assert got.shape == (2, len(pts))
    want = jax_serving.MultiModelEvaluator(
        refs, dtype=jnp.float64, derivative_order=orders,
        bucket_sizes=BUCKETS)(pts)
    for i, m in enumerate(ports):
        assert _dev(got[i], want[i]) <= tol
        single = BatchedEvaluator(m, dtype=tdt, derivative_order=orders,
                                  bucket_sizes=BUCKETS, device="cpu")(pts)
        assert _dev(got[i], single) <= (1e-6 if tier == "f32" else 1e-13)
    if tier == "dd":
        ood = pts[:100].copy()
        ood[3, 0] = 1.5
        sibling = MultiModelEvaluator(ports, dtype=torch.float64,
                                      derivative_order=orders,
                                      bucket_sizes=BUCKETS, device="cpu")
        assert torch.equal(book(ood), sibling(ood))


def test_book_refusals(tts, dense):
    _, tt = tts["canonical"]
    _, tt_low = tts["low"]
    _, tt_reordered = tts["reordered"]
    (_, d0), (_, d1) = dense
    with pytest.raises(ValueError, match="non-empty"):
        MultiModelEvaluator([], device="cpu")
    with pytest.raises(TypeError, match="homogeneous book of "
                                        "ChebyshevApproximation or "
                                        "ChebyshevTT models"):
        MultiModelEvaluator([tt, d0], device="cpu")
    with pytest.raises(TypeError, match="homogeneous book"):
        MultiModelEvaluator([object()], device="cpu")
    with pytest.raises(ValueError, match="'qd' is not a tier"):
        MultiModelEvaluator([tt], dtype="qd", device="cpu")
    relabelled = tt_low.clone()
    relabelled._dim_order = [1, 0, 2, 3]
    with pytest.raises(ValueError, match="all TT models must share one "
                                         "dim_order; reorder"):
        MultiModelEvaluator([tt, relabelled], device="cpu")
    with pytest.raises(ValueError, match=r"interpolants\[1\] grid \(n_nodes"
                                         r"/domain\) differs"):
        MultiModelEvaluator([tt, tt_reordered], device="cpu")
    other = ChebyshevApproximation.from_values(
        np.zeros((7, 6, 8, 4)), 4, DOM, [7, 6, 8, 4], device="cpu")
    with pytest.raises(ValueError, match=r"interpolants\[1\] grid"):
        MultiModelEvaluator([d0, other], device="cpu")
    with pytest.raises(RuntimeError, match="all interpolants must be built"):
        MultiModelEvaluator(
            [d0, ChebyshevApproximation(_f, 4, DOM, NS, device="cpu")],
            device="cpu")
    with pytest.raises(RuntimeError, match="Call build"):
        MultiModelEvaluator([ChebyshevTT(_f, 4, DOM, NS, device="cpu")],
                            device="cpu")
    with pytest.raises(ValueError, match="derivative_order length 3"):
        MultiModelEvaluator([d0, d1], derivative_order=[1, 0, 0],
                            device="cpu")
    wide = ChebyshevTT.from_values(
        np.cos(np.linspace(0, 1, 1 << 14)), 1, [[0.0, 1.0]], [1 << 14],
        max_rank=1, device="cpu")
    with pytest.raises(ValueError, match=r"interpolants\[0\] TT core shapes"
                                         r".*outside the digit-GEMM plan"):
        MultiModelEvaluator([wide], dtype="dd", device="cpu")
    line = ChebyshevApproximation.from_values(
        np.zeros(9), 1, [[0.0, 1.0]], [9], device="cpu")
    with pytest.raises(ValueError, match=r"grid shape \(9,\) is outside the "
                                         r"digit-GEMM plan budget"):
        MultiModelEvaluator([line], dtype="dd", device="cpu")

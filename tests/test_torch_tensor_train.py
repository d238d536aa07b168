"""The port's ``ChebyshevTT`` against the JAX package's, on the CPU.

Same seeded builds through both packages: the host algorithms are the
same NumPy calls with the same RNG, so coefficient cores are held
BITWISE equal.  Evaluation tolerances (scale-normalized): f64 chain
<= 1e-12; the dd surface (native f64) <= 1e-12 of the JAX f64 chain;
finite-difference reports <= 1e-6 up to total order 2 and <= 5e-3 at
total order 3 (the 1/h^k stencils, h = 1e-4 of the range, amplify the
rounding of either backend alike).
"""

import pickle

import numpy as np
import pytest
import torch

from pychebyshev_tpu import ChebyshevApproximation as JaxApprox
from pychebyshev_tpu import ChebyshevTT as JaxTT
from pychebyshev_tpu_torch import (
    ChebyshevApproximation,
    ChebyshevTT,
    Domain,
    Ns,
)
from pychebyshev_tpu_torch.utils.convert import tt_from_jax_state

F64_TOL = 1e-12
FD_TOL = 1e-6
FD_TOL_ORDER_3 = 5e-3

DOM = [[-1.0, 1.0], [0.0, 2.0], [-1.0, 1.0], [0.0, 1.0]]
NS = [7, 6, 8, 5]
PERM = [2, 0, 3, 1]


def _f(p, _=None):
    p = np.asarray(p, dtype=np.float64)
    return (np.sin(p[:, 0]) * np.cos(p[:, 1]) + p[:, 2] ** 2 * p[:, 0]
            + np.exp(0.3 * p[:, 3]) * p[:, 1])


def _f_scalar(x, _=None):
    return float(_f(np.asarray([x]))[0])


def _dev(a, ref):
    a = np.asarray(a, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert a.shape == ref.shape
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-300)


def _same_cores(port, ref):
    assert len(port._coeff_cores) == len(ref._coeff_cores)
    for a, b in zip(port._coeff_cores, ref._coeff_cores):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == np.float64 and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _points(n, seed, lo=0.02, hi=0.98):
    rng = np.random.default_rng(seed)
    dom = np.asarray(DOM)
    return dom[:, 0] + (dom[:, 1] - dom[:, 0]) * rng.uniform(
        lo, hi, size=(n, 4))


def _build(cls, **kw):
    build_kw = {k: kw.pop(k) for k in list(kw)
                if k in ("seed", "method", "init_rank", "kick",
                         "refine_sweeps", "refine_samples")}
    extra = {"device": "cpu"} if cls is ChebyshevTT else {}
    tt = cls(_f, 4, DOM, NS, vectorized=True, **kw, **extra)
    tt.build(verbose=False, **build_kw)
    return tt


@pytest.fixture(scope="module")
def pair():
    kw = dict(max_rank=6, seed=5)
    return _build(JaxTT, **kw), _build(ChebyshevTT, **kw)


@pytest.fixture(scope="module")
def reordered(pair):
    ref, port = pair
    return ref.reorder(PERM), port.reorder(PERM)


BUILDS = {
    "cross": dict(max_rank=6, seed=5),
    "cross_seedless": dict(max_rank=4),
    "cross_tight": dict(max_rank=8, tolerance=1e-10, max_sweeps=6, seed=1),
    "cross_warm_start": dict(max_rank=7, seed=2, init_rank=2, kick=2),
    "cross_refined": dict(max_rank=5, seed=3, refine_sweeps=2,
                          refine_samples=200),
    "svd": dict(max_rank=6, method="svd"),
    "als": dict(max_rank=5, method="als", seed=7),
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_seeded_build_gives_bitwise_equal_cores(name):
    ref, port = _build(JaxTT, **BUILDS[name]), \
        _build(ChebyshevTT, **BUILDS[name])
    _same_cores(port, ref)
    assert port.tt_ranks == ref.tt_ranks
    assert port.total_build_evals == ref.total_build_evals
    assert port.method == ref.method
    assert port.compression_ratio == ref.compression_ratio
    assert port.error_estimate() == ref.error_estimate()
    assert port.error_estimate(tail=2) == ref.error_estimate(tail=2)


def test_scalar_oracle_build_is_bitwise_too():
    ref = JaxTT(_f_scalar, 4, DOM, [5, 5, 5, 5], max_rank=4)
    ref.build(verbose=False, seed=9)
    port = ChebyshevTT(_f_scalar, 4, Domain(DOM), Ns([5, 5, 5, 5]),
                       max_rank=4, device="cpu")
    port.build(verbose=False, seed=9)
    _same_cores(port, ref)


def test_constructor_and_build_errors():
    with pytest.raises(TypeError, match="device"):
        ChebyshevTT(_f, 4, DOM, NS)
    with pytest.raises(ValueError, match="domain has 3 entries"):
        ChebyshevTT(_f, 4, DOM[:3], NS, device="cpu")
    with pytest.raises(ValueError, match="n_nodes has 3 entries"):
        ChebyshevTT(_f, 4, DOM, NS[:3], device="cpu")
    tt = ChebyshevTT(_f, 4, DOM, NS, device="cpu")
    with pytest.raises(ValueError, match="method must be"):
        tt.build(method="qr")
    with pytest.raises(RuntimeError, match="Call build"):
        tt.eval_batch(np.zeros((1, 4)))
    assert "built=False" in repr(tt) and "not built" in str(tt)
    with pytest.raises(ValueError, match="requires vectorized=True"):
        tt.build(verbose=False, mesh=object())  # a scalar oracle


def test_single_point_eval(pair, reordered):
    for ref, port in (pair, reordered):
        for p in _points(25, 1):
            assert port.eval(p) == pytest.approx(ref.eval(p), rel=1e-14,
                                                 abs=1e-15)
            assert port.vectorized_eval(list(p)) == port.eval(p)


def test_numpy_chain_behind_the_c_path(pair):
    _, port = pair
    p = _points(1, 2)[0]
    want = port.eval(p)
    port.__dict__["_host_cpack_cache"] = (tuple(port._coeff_cores), None)
    try:
        assert port.eval(p) == pytest.approx(want, rel=1e-14)
    finally:
        port.__dict__.pop("_host_cpack_cache")


def test_eval_batch(pair, reordered):
    pts = _points(2048, 3)
    for ref, port in (pair, reordered):
        got = port.eval_batch(pts)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
        assert _dev(got, ref.eval_batch(pts)) <= F64_TOL
        np_out = port.vectorized_eval_batch(pts)
        assert isinstance(np_out, np.ndarray)
        np.testing.assert_array_equal(np_out, got.numpy())
        host = [port.eval(p) for p in pts[:64]]
        assert _dev(got[:64], host) <= F64_TOL
        # a list of floats stays f64
        assert torch.equal(port.eval_batch(pts[:5].tolist()), got[:5])
    with pytest.raises(ValueError, match=r"shape \(N, 4\)"):
        pair[1].eval_batch(np.zeros((3, 5)))


@pytest.mark.parametrize("mode", ["accurate", "fast"])
@pytest.mark.parametrize("groups", ["auto", None, (2, 2), (1, 3)])
def test_eval_batch_dd(pair, reordered, mode, groups):
    pts = _points(1024, 4)
    for ref, port in (pair, reordered):
        got = port.eval_batch_dd(pts, mode=mode, groups=groups)
        assert got.dtype == torch.float64
        assert _dev(got, ref.eval_batch(pts)) <= F64_TOL
        assert _dev(got, ref.eval_batch_dd(pts, mode=mode, groups=groups)) \
            <= (1e-8 if mode == "fast" else 1e-9)


def test_eval_batch_dd_routes_and_errors(pair, reordered):
    ref, port = reordered
    ood = _points(256, 5)
    ood[7, 0] = 1.25                      # user dim 0 above its domain
    got = port.eval_batch_dd(ood, groups=(2, 2))
    assert torch.equal(got, port.eval_batch(ood))       # the f64 chain
    assert _dev(got, ref.eval_batch_dd(ood)) <= F64_TOL
    with pytest.raises(ValueError, match="mode must be 'accurate' or "
                                         "'fast'"):
        port.eval_batch_dd(ood, mode="exact")
    # a one-core chain is inside the plan; a wide grid is not, and takes
    # the f64 chain as the reference does
    wide = ChebyshevTT.from_values(
        np.cos(np.linspace(0, 1, 1 << 14)), 1, [[0.0, 1.0]], [1 << 14],
        max_rank=1, device="cpu")
    pts = np.linspace(0.1, 0.9, 7)[:, None]
    assert torch.equal(wide.eval_batch_dd(pts), wide.eval_batch(pts))


SPECS = [[0, 0, 0, 0], [1, 0, 0, 0], [0, 2, 0, 0], [1, 0, 1, 0],
         [0, 0, 1, 2], [1, 1, 1, 0]]


def test_eval_multi_matches_reference(pair, reordered):
    for ref, port in (pair, reordered):
        for p in _points(6, 6, lo=0.0, hi=1.0):
            got = port.eval_multi(p, SPECS)
            want = ref.eval_multi(p, SPECS)
            np.testing.assert_allclose(got, want, rtol=FD_TOL, atol=FD_TOL)
            assert port.vectorized_eval_multi(p, SPECS[:2]) == got[:2]
    with pytest.raises(ValueError, match="not supported"):
        pair[1].eval_multi(_points(1, 6)[0], [[3, 0, 0, 0]])


def test_batch_multi_matches_per_point_and_reference(pair, reordered):
    pts = _points(300, 7, lo=0.0, hi=1.0)       # boundary nudges included
    for ref, port in (pair, reordered):
        got = port.vectorized_eval_batch_multi(pts, SPECS)
        assert isinstance(got, np.ndarray) and got.shape == (300, 6)
        want = ref.vectorized_eval_batch_multi(pts, SPECS)
        per_point = np.array([port.eval_multi(p, SPECS) for p in pts[:40]])
        low = [j for j, s in enumerate(SPECS) if sum(s) <= 2]
        high = [j for j, s in enumerate(SPECS) if sum(s) == 3]
        assert low and high and len(low) + len(high) == len(SPECS)
        for cols, tol in ((low, FD_TOL), (high, FD_TOL_ORDER_3)):
            np.testing.assert_allclose(got[:, cols], want[:, cols],
                                       rtol=tol, atol=tol)
            np.testing.assert_allclose(got[:40][:, cols],
                                       per_point[:, cols], rtol=tol,
                                       atol=tol)
        np.testing.assert_array_equal(got[:, 0],
                                      port.eval_batch(pts).numpy())
        dev_out = port._eval_batch_multi_device(pts, SPECS)
        assert isinstance(dev_out, torch.Tensor)
        np.testing.assert_array_equal(dev_out.numpy(), got)
        one = port.vectorized_eval_batch(pts, [1, 0, 0, 0])
        np.testing.assert_array_equal(one, got[:, 1])
        assert port.eval_batch_multi(pts[:3], []).shape == (3, 0)
    with pytest.raises(ValueError, match="derivative_order length 3"):
        pair[1].vectorized_eval_batch_multi(pts, [[1, 0, 0]])
    with pytest.raises(ValueError, match="Derivative order 3 not "
                                         "supported"):
        pair[1].vectorized_eval_batch_multi(pts, [[3, 0, 0, 0]])


@pytest.mark.parametrize("orders", [[1, 0, 0, 0], [0, 2, 0, 0],
                                    [1, 0, 1, 0], [0, 0, 0, 0]])
def test_differentiate(pair, reordered, orders):
    pts = _points(512, 8)
    for ref, port in (pair, reordered):
        d_ref, d_port = ref.differentiate(orders), port.differentiate(orders)
        _same_cores(d_port, d_ref)
        assert d_port.dim_order == d_ref.dim_order
        assert d_port.device == port.device
        assert _dev(d_port.eval_batch(pts), d_ref.eval_batch(pts)) \
            <= F64_TOL
    with pytest.raises(ValueError, match="derivative_order length"):
        pair[1].differentiate([1, 0])
    with pytest.raises(ValueError, match="must be >= 0"):
        pair[1].differentiate([-1, 0, 0, 0])


def test_differentiate_matches_dense_analytic_derivative():
    dense = ChebyshevApproximation(_f, 4, DOM, NS, vectorized=True,
                                   device="cpu")
    dense.build(verbose=False)
    tt = dense.to_tt(tolerance=1e-14)
    pts = _points(512, 9)
    for orders in ([1, 0, 0, 0], [0, 0, 2, 0]):
        got = tt.differentiate(orders).eval_batch(pts)
        assert _dev(got, dense.vectorized_eval_batch(pts, orders)) <= 1e-10


def test_reorder_and_dim_order(pair, reordered):
    ref, port = pair
    r_ref, r_port = reordered
    assert r_port.dim_order == PERM == r_ref.dim_order
    _same_cores(r_port, r_ref)
    assert r_port.n_nodes == [NS[k] for k in PERM]
    assert r_port.domain == [DOM[k] for k in PERM]
    pts = _points(512, 10)
    assert _dev(r_port.eval_batch(pts), port.eval_batch(pts)) <= 1e-6
    same = port.reorder(port.dim_order)
    assert same is not port
    _same_cores(same, port)
    back = r_port.reorder([0, 1, 2, 3], tolerance=1e-12)
    assert _dev(back.eval_batch(pts), r_port.eval_batch(pts)) <= 1e-9
    np.testing.assert_array_equal(r_port.get_evaluation_points(),
                                  r_ref.get_evaluation_points())
    with pytest.raises(ValueError, match="permutation"):
        port.reorder([0, 1, 2, 2])


def test_to_dense_inner_product_orth(pair, reordered):
    for ref, port in (pair, reordered):
        np.testing.assert_array_equal(port.to_dense(), ref.to_dense())
        assert port.to_dense().shape == tuple(NS)
        assert port.inner_product(port) == ref.inner_product(ref)
    ref, port = (pickle.loads(pickle.dumps(m)) for m in pair)
    p = _points(1, 11)[0]
    v0 = port.eval(p)
    dev0 = port._cores_on_device(torch.float64)
    for m in (ref, port):
        m.orth_left(2)
        m.orth_right(1)
    _same_cores(port, ref)
    assert port.eval(p) == pytest.approx(v0, rel=1e-12)
    # the mutation replaced the host cores: the device cache must miss
    assert port._cores_on_device(torch.float64) is not dev0
    assert _dev(port.eval_batch(p[None, :]), [v0]) <= F64_TOL
    with pytest.raises(ValueError, match="orth_left"):
        port.orth_left(0)
    with pytest.raises(ValueError, match="orth_right"):
        port.orth_right(3)
    with pytest.raises(ValueError, match="matching domains"):
        pair[1].inner_product(reordered[1])
    relabelled = pair[1].clone()
    relabelled._dim_order = [1, 0, 2, 3]
    with pytest.raises(ValueError, match="matching _dim_order"):
        pair[1].inner_product(relabelled)
    with pytest.raises(ValueError, match="must be a ChebyshevTT"):
        pair[1].inner_product(3.0)


def test_algebra(pair, reordered):
    pts = _points(512, 12)
    for ref, port in (pair, reordered):
        other_ref, other_port = ref * 0.5, port * 0.5
        cases = {
            "add": (ref + other_ref, port + other_port),
            "sub": (ref - other_ref, port - other_port),
            "neg": (-ref, -port),
            "mul": (ref * 3, port * 3),
            "rmul": (2.5 * ref, 2.5 * port),
            "div": (ref / 4.0, port / 4.0),
        }
        for name, (r, p) in cases.items():
            _same_cores(p, r)
            assert p.dim_order == r.dim_order and p.max_rank == r.max_rank
            assert _dev(p.eval_batch(pts), r.eval_batch(pts)) <= F64_TOL, \
                name
        acc_ref, acc_port = ref, port
        acc_ref += other_ref
        acc_port += other_port
        acc_ref -= ref
        acc_port -= port
        acc_ref *= 2.0
        acc_port *= 2.0
        acc_ref /= 3.0
        acc_port /= 3.0
        _same_cores(acc_port, acc_ref)
    port = pair[1]
    with pytest.raises(TypeError, match="only scalar multiplication"):
        port * port
    with pytest.raises(TypeError, match="is not supported"):
        port / "2"
    with pytest.raises(ZeroDivisionError):
        port / 0
    with pytest.raises(TypeError, match="unsupported operand"):
        port + 1.0
    with pytest.raises(ValueError, match="dim_order mismatch"):
        port + reordered[1]
    other = ChebyshevTT.from_values(np.zeros((7, 6, 8)), 3, DOM[:3], NS[:3],
                                    device="cpu")
    with pytest.raises(ValueError, match="num_dimensions mismatch"):
        port + other
    shifted = ChebyshevTT.from_values(
        np.zeros(tuple(NS)), 4, [[-1, 1], [0, 2], [-1, 1], [0, 2]], NS,
        device="cpu")
    with pytest.raises(ValueError, match="domain mismatch"):
        port + shifted
    coarse = ChebyshevTT.from_values(np.zeros((7, 6, 8, 4)), 4, DOM,
                                     [7, 6, 8, 4], device="cpu")
    with pytest.raises(ValueError, match="n_nodes mismatch"):
        port + coarse


def test_device_core_cache_is_keyed_on_host_arrays_and_dtype(pair):
    port = pickle.loads(pickle.dumps(pair[1]))
    d64 = port._cores_on_device(torch.float64)
    assert port._cores_on_device(torch.float64) is d64
    d32 = port._cores_on_device(torch.float32)
    assert d32[0].dtype == torch.float32 and d32 is not d64
    assert port._cores_on_device(torch.float64) is d64
    # replacing a core array (what every mutation path does) misses
    pts = _points(32, 13)
    before = port.eval_batch(pts)
    port._coeff_cores[0] = port._coeff_cores[0] * 2.0
    assert port._cores_on_device(torch.float64) is not d64
    assert _dev(port.eval_batch(pts), 2.0 * before) <= F64_TOL
    assert port.eval(pts[0]) == pytest.approx(2.0 * float(before[0]),
                                              rel=1e-12)
    # the stale entry's arrays stay pinned until it is replaced
    assert port._dev_cores[(torch.float32, "cpu")][0][0] is not \
        port._coeff_cores[0]


def test_pickle_save_load_clone(pair, tmp_path):
    _, port = pair
    pts = _points(64, 14)
    port.eval_batch(pts)
    port.eval(pts[0])                       # fill both caches
    state = port.__getstate__()
    assert "_dev_cores" not in state and "_host_cpack_cache" not in state
    assert state["function"] is None and state["device"] == "cpu"
    assert all(isinstance(c, np.ndarray) for c in state["_coeff_cores"])
    clone = pickle.loads(pickle.dumps(port))
    assert clone.function is None and clone.device == torch.device("cpu")
    _same_cores(clone, port)
    assert torch.equal(clone.eval_batch(pts), port.eval_batch(pts))
    path = tmp_path / "tt.pkl"
    port.save(path)
    loaded = ChebyshevTT.load(path, device="cpu")
    _same_cores(loaded, port)
    assert loaded.eval(pts[0]) == port.eval(pts[0])
    with pytest.raises(RuntimeError, match="no function assigned"):
        loaded.build(verbose=False)
    twin = port.clone()
    twin._coeff_cores[0][...] = 0.0
    assert port.eval(pts[0]) != 0.0
    port.save(tmp_path / "tt.npz", format="npz")
    _same_cores(ChebyshevTT.load(tmp_path / "tt.npz", device="cpu"), port)
    with pytest.raises(ValueError, match="format must be"):
        port.save(path, format="hdf5")
    np.savez(tmp_path / "other.npz", a=np.zeros(2))
    with pytest.raises(KeyError, match="__version__"):
        ChebyshevTT.load(tmp_path / "other.npz", device="cpu")
    with open(tmp_path / "list.pkl", "wb") as f:
        pickle.dump([1, 2], f)
    with pytest.raises(TypeError, match="Expected a ChebyshevTT"):
        ChebyshevTT.load(tmp_path / "list.pkl", device="cpu")


def test_getters_and_printing(pair):
    ref, port = pair
    assert port.is_construction_finished()
    assert port.get_constructor_type() == "ChebyshevTT"
    assert port.get_used_ns() == NS
    assert port.get_max_derivative_order() == 2
    assert port.get_special_points() is None
    assert port.get_error_threshold() is None
    assert port.get_num_evaluation_points() == int(np.prod(NS))
    np.testing.assert_array_equal(port.get_evaluation_points(),
                                  ref.get_evaluation_points())
    port.set_descriptor("book A")
    assert port.get_descriptor() == "book A"
    with pytest.raises(TypeError):
        port.set_descriptor(3)
    port.set_descriptor("")
    assert repr(port) == repr(ref)
    assert str(port).splitlines()[:3] == str(ref).splitlines()[:3]
    assert ChebyshevTT.is_dimensionality_allowed(7)
    assert not ChebyshevTT.is_dimensionality_allowed(0)
    got = ChebyshevTT.nodes(4, Domain(DOM), Ns(NS))["nodes_per_dim"]
    want = JaxTT.nodes(4, DOM, NS)["nodes_per_dim"]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_from_values_and_with_auto_order(pair):
    ref, port = pair
    dense = ref.to_dense()
    a = JaxTT.from_values(dense, 4, DOM, NS, tolerance=1e-10)
    b = ChebyshevTT.from_values(torch.tensor(dense), 4, DOM, NS,
                                tolerance=1e-10, device="cpu")
    _same_cores(b, a)
    assert b.method == "svd" and b.max_rank == a.max_rank
    with pytest.raises(ValueError, match="does not match expected"):
        ChebyshevTT.from_values(dense, 4, DOM, [7, 6, 8, 6], device="cpu")
    bad = dense.copy()
    bad[0, 0, 0, 0] = np.nan
    with pytest.raises(ValueError, match="NaN or Inf"):
        ChebyshevTT.from_values(bad, 4, DOM, NS, device="cpu")
    for method in ("greedy_swap", "random"):
        kw = dict(max_rank=4, n_trials=2, method=method, vectorized=True)
        ra = JaxTT.with_auto_order(_f, 4, DOM, NS, **kw)
        rb = ChebyshevTT.with_auto_order(_f, 4, DOM, NS, device="cpu", **kw)
        assert rb.dim_order == ra.dim_order
        _same_cores(rb, ra)
    with pytest.raises(ValueError, match="unknown method"):
        ChebyshevTT.with_auto_order(_f, 4, DOM, NS, max_rank=2,
                                    method="best", vectorized=True,
                                    device="cpu")


@pytest.fixture(scope="module")
def dense_pair():
    ref = JaxApprox(_f, 4, DOM, NS, vectorized=True)
    ref.build(verbose=False)
    port = ChebyshevApproximation(_f, 4, DOM, NS, vectorized=True,
                                  device="cpu")
    port.build(verbose=False)
    return ref, port


@pytest.mark.parametrize("kw", [
    dict(), dict(tolerance=1e-13), dict(max_rank=3),
    dict(order="auto"), dict(order=[3, 1, 0, 2]),
    dict(sup_target=1e-6), dict(order="auto", sup_target=1e-8),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_to_tt(dense_pair, kw):
    ref, port = dense_pair
    a, b = ref.to_tt(**kw), port.to_tt(**kw)
    _same_cores(b, a)
    assert b.dim_order == a.dim_order and b.tt_ranks == a.tt_ranks
    assert b.domain == a.domain and b.n_nodes == a.n_nodes
    assert b.max_rank == a.max_rank and b.method == "svd"
    assert b.device == port.device
    if "sup_target" in kw:
        assert b.compression_diagnostics == a.compression_diagnostics
    else:
        assert not hasattr(b, "compression_diagnostics")
    pts = _points(512, 15)
    assert _dev(b.eval_batch(pts), a.eval_batch(pts)) <= F64_TOL
    if kw.get("tolerance") == 1e-13:
        dense_vals = port.eval_batch_device(pts)
        for groups in ("auto", None, (2, 2)):
            assert _dev(b.eval_batch_dd(pts, groups=groups), dense_vals) \
                <= F64_TOL


def test_to_tt_errors(dense_pair):
    _, port = dense_pair
    with pytest.raises(ValueError, match="permutation"):
        port.to_tt(order=[0, 1, 2, 2])
    fresh = ChebyshevApproximation(_f, 4, DOM, NS, device="cpu")
    with pytest.raises(RuntimeError, match="build"):
        fresh.to_tt()


def _tt_state(ref):
    state = ref.__getstate__()
    state["_coeff_cores"] = [np.asarray(c) for c in state["_coeff_cores"]]
    return state


def test_tt_from_jax_state_round_trip(pair, reordered):
    for ref, port in (pair, reordered):
        got = tt_from_jax_state(_tt_state(ref), device="cpu")
        _same_cores(got, ref)
        assert got.dim_order == ref.dim_order
        assert got.tt_ranks == ref.tt_ranks
        assert got.total_build_evals == ref.total_build_evals
        assert (got.max_rank, got.tolerance, got.max_sweeps, got.method) \
            == (ref.max_rank, ref.tolerance, ref.max_sweeps, ref.method)
        assert got.function is None
        pts = _points(256, 16)
        assert torch.equal(got.eval_batch(pts), port.eval_batch(pts))
        # private copies: editing the state's arrays does not reach it
        state = _tt_state(ref)
        got = tt_from_jax_state(state, device="cpu")
        v = got.eval(pts[0])
        state["_coeff_cores"][0][...] = 0.0
        assert got.eval(pts[0]) == v


def test_tt_from_jax_state_refuses_bad_states(pair):
    ref, _ = pair
    state = _tt_state(ref)
    lacking = {k: v for k, v in state.items() if k != "_dim_order"}
    with pytest.raises(ValueError, match=r"state lacks \['_dim_order'\]"):
        tt_from_jax_state(lacking, device="cpu")
    broken = dict(state)
    broken["_coeff_cores"] = list(state["_coeff_cores"])
    broken["_coeff_cores"][1] = broken["_coeff_cores"][1][:-1]
    with pytest.raises(ValueError, match="inconsistent TT bond chain"):
        tt_from_jax_state(broken, device="cpu")
    wrong_n = dict(state, n_nodes=[7, 6, 8, 6])
    with pytest.raises(ValueError, match=r"_coeff_cores\[3\] has shape"):
        tt_from_jax_state(wrong_n, device="cpu")
    with pytest.raises(ValueError, match="not a permutation"):
        tt_from_jax_state(dict(state, _dim_order=[0, 1, 1, 3]),
                          device="cpu")
    with pytest.raises(ValueError, match="cores and"):
        tt_from_jax_state(dict(state, n_nodes=[7, 6, 8]), device="cpu")


NOT_PORTED = ["integrate", "integrate_batch", "partial_integrate_batch",
              "roots", "minimize", "maximize", "critical_points",
              "roots_batch", "minimize_batch", "maximize_batch",
              "to_slider", "extrude", "slice", "run_completion",
              "sobol_indices", "interaction_matrix", "suggest_partition",
              "hadamard", "compose", "plot_1d", "plot_2d_surface",
              "plot_2d_contour", "fit"]


# Ported with the calculus slice.
CALCULUS = ["integrate", "integrate_batch", "partial_integrate_batch",
            "roots", "roots_batch", "minimize_batch", "maximize_batch",
            "to_slider", "extrude", "slice"]


@pytest.fixture(scope="module")
def untouched_pair():
    """``pair`` as built: the reference's in-place algebra in
    ``test_algebra`` rewrites ``pair``'s reference object."""
    kw = dict(max_rank=6, seed=5)
    return _build(JaxTT, **kw), _build(ChebyshevTT, **kw)


# Ported with the host-tail and fit slice.
HOST_TAIL = ["run_completion", "sobol_indices", "interaction_matrix",
             "suggest_partition", "hadamard", "compose", "plot_1d",
             "plot_2d_surface", "plot_2d_contour", "fit"]


# Ported with the global-calculus slice: called with two dims pinned
# (the bare 4-D search certifies in seconds, not milliseconds).
GLOBAL = ["minimize", "maximize", "critical_points"]
GLOBAL_FIXED = {1: 1.0, 3: 0.5}


@pytest.mark.parametrize("name", NOT_PORTED)
def test_later_slices_raise_by_name(untouched_pair, name):
    """Every name the earlier slices left waiting is ported now: each
    gives the reference's result or raises its error."""
    ref, port = untouched_pair
    assert hasattr(JaxTT, name)
    assert name in CALCULUS + HOST_TAIL + GLOBAL
    if name not in GLOBAL:
        _bare_call_as_reference(ref, port, name)
        return
    want = getattr(ref, name)(fixed=GLOBAL_FIXED)
    got = getattr(port, name)(fixed=GLOBAL_FIXED)
    if name == "critical_points":
        assert [c.kind for c in got] == [c.kind for c in want]
        np.testing.assert_allclose(_flat_result([c.point for c in got]),
                                   _flat_result([c.point for c in want]),
                                   rtol=0, atol=1e-10)
        return
    # the optimum value is unique; x2 = -1 and x2 = 1 tie on the point
    assert abs(got[0] - want[0]) <= F64_TOL * max(abs(want[0]), 1.0)
    assert got[1][1] == 1.0 and got[1][3] == 0.5
    assert abs(got[1][0] - want[1][0]) <= 1e-8


def _bare_call_as_reference(ref, port, name):
    """Called with no arguments, a method ported by an earlier slice
    returns what the reference's returns, or raises its error."""
    try:
        want = getattr(ref, name)()
    except Exception as exc:  # noqa: BLE001 - the reference's own error
        with pytest.raises(type(exc)) as got:
            getattr(port, name)()
        assert str(got.value) == str(exc)
        return
    np.testing.assert_allclose(_flat_result(getattr(port, name)()),
                               _flat_result(want),
                               rtol=1e-12, atol=1e-10)


def _flat_result(result):
    """A bare call's result as a flat list of floats: dict values in key
    order, nested lists in order, a plot's line data; nothing for
    None."""
    if result is None:
        return []
    if isinstance(result, dict):
        return [v for k in sorted(result) for v in _flat_result(result[k])]
    if isinstance(result, (list, tuple)):
        return [v for item in result for v in _flat_result(item)]
    if hasattr(result, "get_lines"):
        import matplotlib.pyplot as plt
        data = [v for line in result.get_lines()
                for v in np.ravel(line.get_xydata())]
        plt.close(result.figure)
        return data
    return np.ravel(np.asarray(result, float)).tolist()


# ----------------------------------------------------------------------
# The host algorithms (a copy) against the reference's, helper by helper
# ----------------------------------------------------------------------

def _helper_cases(tta, cores, dense):
    """name -> result of one ``tt_algorithms`` helper on fixed inputs."""
    rng = np.random.default_rng(3)
    tall = rng.standard_normal((40, 5))
    return {
        "maxvol": lambda: tta.maxvol(tall),
        "tt_svd_from_tensor": lambda: tta.tt_svd_from_tensor(
            dense, max_rank=4, tol=1e-9),
        "value_coeff_round_trip": lambda: [
            tta.coeff_core_to_value_core(tta.value_core_to_coeff_core(c))
            for c in cores],
        "orth_left_core": lambda: tta.orth_left_core(cores[0], cores[1]),
        "orth_right_core": lambda: tta.orth_right_core(cores[2], cores[3]),
        "tt_reconstruct": lambda: tta.tt_reconstruct(cores),
        "tt_add_cores": lambda: tta.tt_add_cores(cores, cores),
        "tt_round_cores": lambda: tta.tt_round_cores(
            tta.tt_add_cores(cores, cores), max_rank=6, tolerance=1e-10),
        "tt_round_cores_ranks": lambda: tta.tt_round_cores_ranks(
            [c.copy() for c in cores], [2, 3, 2]),
        "tt_swap_adjacent": lambda: tta.tt_swap_adjacent(
            [c.copy() for c in cores], 1, max_rank=6, tolerance=1e-10),
        "tt_merge_cores": lambda: tta.tt_merge_cores(cores, [2, 2]),
        "tt_trim_cores": lambda: tta.tt_trim_cores(
            [c.copy() for c in cores], dense, 1e-3),
        "masked_als_refine": lambda: tta.masked_als_refine(
            [c.copy() for c in cores],
            np.stack([rng.integers(0, n, 300) for n in NS], axis=1),
            rng.standard_normal(300), n_sweeps=1),
        "als_fixed_rank_sweeps": lambda: tta.als_fixed_rank_sweeps(
            [c.copy() for c in cores], dense, tolerance=1e-8, max_iter=2),
    }


def _flat(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _flat(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for item in x for v in _flat(item)]
    return [np.asarray(x)]


HELPERS = ["maxvol", "tt_svd_from_tensor", "value_coeff_round_trip",
           "orth_left_core", "orth_right_core", "tt_reconstruct",
           "tt_add_cores", "tt_round_cores", "tt_round_cores_ranks",
           "tt_swap_adjacent", "tt_merge_cores", "tt_trim_cores",
           "masked_als_refine", "als_fixed_rank_sweeps"]


@pytest.mark.parametrize("name", HELPERS)
def test_tt_algorithm_helper_is_bitwise_the_reference(pair, name):
    from pychebyshev_tpu.models import tt_algorithms as jax_tta
    from pychebyshev_tpu_torch.models import tt_algorithms as port_tta
    ref, _ = pair
    cores = [np.asarray(c) for c in ref._coeff_cores]
    dense = ref.to_dense()
    want = _flat(_helper_cases(jax_tta, cores, dense)[name]())
    got = _flat(_helper_cases(port_tta, cores, dense)[name]())
    assert len(got) == len(want) and len(got) >= 1
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()


def test_grid_oracle_takes_no_mesh_and_caches():
    from pychebyshev_tpu_torch.models.tt_algorithms import GridOracle
    grids = [np.linspace(0, 1, n) for n in (3, 4)]
    calls = []

    def f(p, _):
        calls.append(len(p))
        return p[:, 0] + 10 * p[:, 1]

    oracle = GridOracle(f, grids, vectorized=True)
    idx = np.array([[0, 0], [2, 3], [0, 0]])
    np.testing.assert_allclose(oracle.eval_many(idx), [0.0, 11.0, 0.0])
    assert oracle.n_evals == 2 and calls == [2]
    oracle.eval_many(idx)
    assert calls == [2]                      # all cached
    assert oracle.full_tensor([3, 4]).shape == (3, 4)
    assert oracle.n_evals == 12
    keys, vals = oracle.observations()
    assert keys.shape == (12, 2) and vals.shape == (12,)
    # mesh=None is the oracle above; a scalar oracle takes no mesh.
    plain = GridOracle(f, grids, vectorized=True, mesh=None)
    np.testing.assert_array_equal(plain.full_tensor([3, 4]),
                                  oracle.full_tensor([3, 4]))
    with pytest.raises(ValueError, match="requires vectorized=True"):
        GridOracle(f, grids, vectorized=False, mesh=object())


def test_threads_share_one_tt(reordered):
    """Concurrent single-point, FD and batched calls on one reordered TT:
    no method mutates ``_dim_order``, scratch is per thread, and the
    device-core cache fills once."""
    import threading
    _, port = reordered
    port = port.clone()
    pts = _points(200, 17)
    want_single = [port.eval(p) for p in pts]
    want_multi = [port.eval_multi(p, SPECS[:3]) for p in pts[:40]]
    want_batch = port.eval_batch(pts)
    errors = []

    def work(kind):
        try:
            for _ in range(3):
                if kind == 0:
                    assert [port.eval(p) for p in pts] == want_single
                elif kind == 1:
                    got = [port.eval_multi(p, SPECS[:3]) for p in pts[:40]]
                    assert got == want_multi
                else:
                    assert torch.equal(port.eval_batch(pts), want_batch)
                assert port.dim_order == PERM
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(k % 3,))
               for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors

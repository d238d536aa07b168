"""PyTorch port of ``ChebyshevApproximation`` against the JAX package.

Both packages build the 5-D Black-Scholes interpolant on a 7^5 grid.
Tolerances (scale-normalized max deviation): f64 paths <= 1e-12,
f32 paths <= 2e-4 of the JAX f64 result.
"""

import io
import math
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import BS_DOMAIN_5D, bs_price_vectorized
from pychebyshev_tpu import ChebyshevApproximation as JaxApprox
from pychebyshev_tpu_torch import ChebyshevApproximation, Domain, Ns
from pychebyshev_tpu_torch.utils.convert import from_jax_state

F64_TOL = 1e-12
F32_TOL = 2e-4
FIXTURES = Path(__file__).parent / "fixtures"
GREEKS = [(0, 0, 0, 0, 0), (1, 0, 0, 0, 0), (2, 0, 0, 0, 0),
          (0, 0, 1, 0, 0), (0, 0, 0, 1, 0), (0, 0, 0, 0, 1)]


def _dev(a, ref):
    a = np.asarray(a, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert a.shape == ref.shape
    return np.abs(a - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def pair():
    ref = JaxApprox(bs_price_vectorized, 5, BS_DOMAIN_5D, [7] * 5,
                    vectorized=True)
    ref.build(verbose=False)
    port = ChebyshevApproximation(bs_price_vectorized, 5,
                                  Domain(BS_DOMAIN_5D), Ns([7] * 5),
                                  vectorized=True, device="cpu")
    port.build(verbose=False)
    return ref, port


@pytest.fixture(scope="module")
def pts():
    rng = np.random.default_rng(11)
    lo = np.array([b[0] for b in BS_DOMAIN_5D])
    hi = np.array([b[1] for b in BS_DOMAIN_5D])
    p = lo + (hi - lo) * rng.uniform(0.02, 0.98, (997, 5))
    return p


def _state(ref):
    return {
        "tensor_values": np.asarray(ref.tensor_values),
        "domain": ref.domain,
        "n_nodes": ref.n_nodes,
        "nodes": [np.asarray(a) for a in ref.nodes],
        "weights": [np.asarray(a) for a in ref.weights],
        "diff_matrices": [np.asarray(a) for a in ref.diff_matrices],
        "max_derivative_order": ref.max_derivative_order,
    }


def test_build_matches_reference_tensor(pair):
    ref, port = pair
    assert port.tensor_values.dtype == torch.float64
    assert port.tensor_values.device.type == "cpu"
    np.testing.assert_array_equal(port.tensor_values.numpy(),
                                  np.asarray(ref.tensor_values))
    assert port.n_evaluations == 7 ** 5


@pytest.mark.parametrize("orders", GREEKS)
def test_single_point_eval(pair, pts, orders):
    ref, port = pair
    node_pt = [float(np.asarray(ref.nodes[d])[3]) for d in range(5)]
    sample = [node_pt] + [list(p) for p in pts[:15]]
    want = np.array([ref.vectorized_eval(p, list(orders)) for p in sample])
    got = np.array([port.vectorized_eval(p, list(orders)) for p in sample])
    assert _dev(got, want) <= F64_TOL
    assert port.eval(sample[1], list(orders)) == got[1]


@pytest.mark.parametrize("orders", GREEKS)
def test_batched_f64_and_f32(pair, pts, orders):
    ref, port = pair
    want = ref.vectorized_eval_batch(pts, list(orders))
    got = port.vectorized_eval_batch(pts, list(orders))
    assert isinstance(got, np.ndarray)
    assert _dev(got, want) <= F64_TOL
    dev = port.eval_batch_device(pts, orders)
    assert dev.dtype == torch.float64
    assert _dev(dev.numpy(), want) <= F64_TOL
    for use_fused in (None, True, False):
        f32 = port.eval_batch_f32(pts, orders, use_fused=use_fused)
        assert f32.dtype == torch.float32
        assert _dev(f32.numpy(), want) <= F32_TOL


def test_batched_multi(pair, pts):
    ref, port = pair
    want = ref.vectorized_eval_batch_multi(pts, GREEKS)
    got = port.vectorized_eval_batch_multi(pts, GREEKS)
    assert got.shape == (len(pts), len(GREEKS))
    for k in range(len(GREEKS)):
        assert _dev(got[:, k], want[:, k]) <= F64_TOL


def test_error_estimate(pair):
    ref, port = pair
    assert math.isclose(port.error_estimate(), ref.error_estimate(),
                        rel_tol=1e-12)
    assert math.isclose(port.error_estimate(tail=2),
                        ref.error_estimate(tail=2), rel_tol=1e-12)


def test_auto_n_picks_the_reference_grid():
    def f(x, _):
        return math.exp(-x[0]) * math.cos(3.0 * x[1])

    kw = dict(n_nodes=[None, None], error_threshold=1e-8, max_n=40)
    ref = JaxApprox(f, 2, [[-1, 1], [0, 2]], **kw)
    ref.build(verbose=False)
    port = ChebyshevApproximation(f, 2, [[-1, 1], [0, 2]], device="cpu",
                                  **kw)
    port.build(verbose=False)
    assert port.n_nodes == ref.n_nodes
    assert port.n_evaluations == ref.n_evaluations
    # The converged estimate is at roundoff level (~1e-11), so compare it
    # on the scale of the values rather than relative to itself.
    scale = np.abs(np.asarray(ref.tensor_values)).max()
    assert (abs(port.error_estimate() - ref.error_estimate())
            <= F64_TOL * scale)


def test_from_values_and_from_jax_state(pair, pts):
    ref, port = pair
    want = ref.vectorized_eval_batch(pts, [0] * 5)
    values = np.asarray(ref.tensor_values).copy()
    obj = ChebyshevApproximation.from_values(values, 5, BS_DOMAIN_5D,
                                             [7] * 5, device="cpu")
    values += 1.0  # the caller's array is not the interpolant's
    assert _dev(obj.vectorized_eval_batch(pts, [0] * 5), want) <= F64_TOL
    moved = from_jax_state(_state(ref), device="cpu")
    np.testing.assert_array_equal(moved.vectorized_eval_batch(pts, [0] * 5),
                                  port.vectorized_eval_batch(pts, [0] * 5))


def test_from_jax_state_rejects_a_grid_that_is_not_bitwise(pair):
    ref, _ = pair
    state = _state(ref)
    state["weights"][2] = np.nextafter(state["weights"][2], np.inf)
    with pytest.raises(ValueError, match="weights\\[2\\]"):
        from_jax_state(state, device="cpu")
    state = _state(ref)
    del state["diff_matrices"]
    with pytest.raises(ValueError, match="diff_matrices"):
        from_jax_state(state, device="cpu")


def test_pcb_bytes_identical_and_round_trip(pair, pts, tmp_path):
    ref, port = pair
    ref.save(tmp_path / "ref.pcb", format="binary")
    port.save(tmp_path / "port.pcb", format="binary")
    assert ((tmp_path / "port.pcb").read_bytes()
            == (tmp_path / "ref.pcb").read_bytes())
    loaded = ChebyshevApproximation.load(tmp_path / "ref.pcb", device="cpu")
    moved = from_jax_state(_state(ref), device="cpu")
    np.testing.assert_array_equal(loaded.tensor_values.numpy(),
                                  moved.tensor_values.numpy())
    for a, b in zip(loaded._grid_tuples(), moved._grid_tuples()):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert loaded.domain == moved.domain and loaded.n_nodes == moved.n_nodes


def test_pcb_fixture_matches_expected_values():
    cheb = ChebyshevApproximation.load(FIXTURES / "approx_5d_bs.pcb",
                                       device="cpu")
    rows = np.loadtxt(FIXTURES / "approx_5d_bs.expected")
    pts, expected = rows[:, :-1], rows[:, -1]
    assert _dev(cheb.vectorized_eval_batch(pts, [0] * 5), expected) <= F64_TOL
    host = [cheb.vectorized_eval(list(p), [0] * 5) for p in pts]
    assert _dev(host, expected) <= F64_TOL


def test_pickle_round_trip(pair, pts):
    _, port = pair
    buf = io.BytesIO()
    pickle.dump(port, buf)
    clone = pickle.loads(buf.getvalue())
    assert clone.function is None and clone.device == port.device
    np.testing.assert_array_equal(
        clone.vectorized_eval_batch(pts, [1, 0, 0, 0, 0]),
        port.vectorized_eval_batch(pts, [1, 0, 0, 0, 0]))
    assert (clone.vectorized_eval(list(pts[0]), [0] * 5)
            == port.vectorized_eval(list(pts[0]), [0] * 5))


def test_save_load_pickle(pair, pts, tmp_path):
    _, port = pair
    port.save(tmp_path / "port.pkl")
    clone = ChebyshevApproximation.load(tmp_path / "port.pkl", device="cpu")
    np.testing.assert_array_equal(clone.vectorized_eval_batch(pts, [0] * 5),
                                  port.vectorized_eval_batch(pts, [0] * 5))


def test_host_cache_follows_in_place_mutation(pts):
    obj = ChebyshevApproximation.from_values(
        np.ones((3, 4, 5)), 3, [[0, 1]] * 3, [3, 4, 5], device="cpu")
    p = [0.3, 0.6, 0.9]
    assert math.isclose(obj.vectorized_eval(p, [0, 0, 0]), 1.0)
    obj.tensor_values.add_(2.0)
    assert math.isclose(obj.vectorized_eval(p, [0, 0, 0]), 3.0)


def test_device_is_required_and_knots_are_not_ported():
    with pytest.raises(TypeError):
        ChebyshevApproximation(None, 1, [[0, 1]], [5])
    # Knots are ported now: special_points dispatches to the port's
    # ChebyshevSpline on the same device, and still needs one.
    from pychebyshev_tpu_torch import ChebyshevSpline
    spline = ChebyshevApproximation(None, 1, [[0, 1]], [[5, 5]],
                                    special_points=[[0.5]], device="cpu",
                                    defer_build=True)
    assert type(spline) is ChebyshevSpline
    assert spline.device == torch.device("cpu")
    with pytest.raises(TypeError, match="device"):
        ChebyshevApproximation(None, 1, [[0, 1]], [[5, 5]],
                               special_points=[[0.5]])


def test_derivative_ids_and_deferred_build(pair):
    ref, _ = pair
    obj = ChebyshevApproximation(None, 5, BS_DOMAIN_5D, [7] * 5,
                                 defer_build=True, device="cpu")
    obj.set_original_function_values(np.asarray(ref.tensor_values))
    did = obj.get_derivative_id([1, 0, 0, 0, 0])
    assert obj.get_derivative_id([1, 0, 0, 0, 0]) == did
    p = [100.0, 100.0, 1.0, 0.2, 0.03]
    assert math.isclose(obj.vectorized_eval(p, derivative_id=did),
                        ref.vectorized_eval(p, [1, 0, 0, 0, 0]),
                        rel_tol=1e-12)


# ----------------------------------------------------------------------
# Host multi-spec and batch paths, and to_tt
# ----------------------------------------------------------------------

def test_vectorized_eval_multi_matches_reference(pair, pts):
    """Price plus five Greeks at one point: the C multi kernel where the
    library is built (then bitwise, same source and flags), else the
    NumPy suffix path (<= 1e-12)."""
    ref, port = pair
    for p in pts[:12]:
        got = port.vectorized_eval_multi(p, GREEKS)
        want = ref.vectorized_eval_multi(p, GREEKS)
        assert _dev(got, want) <= F64_TOL
        single = [port.vectorized_eval(p, list(o)) for o in GREEKS]
        assert _dev(got, single) <= 1e-10
    assert port.eval_multi(pts[0], GREEKS[:2]) == \
        port.vectorized_eval_multi(pts[0], GREEKS[:2])
    fresh = ChebyshevApproximation(bs_price_vectorized, 5, BS_DOMAIN_5D,
                                   [5] * 5, device="cpu")
    with pytest.raises(RuntimeError, match="build"):
        fresh.vectorized_eval_multi(pts[0], GREEKS)


@pytest.mark.parametrize("orders", GREEKS[:3])
def test_eval_batch_host_matches_reference_and_device(pair, pts, orders):
    ref, port = pair
    got = port.eval_batch_host(pts[:200], list(orders))
    assert isinstance(got, np.ndarray) and got.shape == (200,)
    assert _dev(got, ref.eval_batch_host(pts[:200], list(orders))) \
        <= F64_TOL
    assert _dev(got, port.eval_batch_device(pts[:200], orders)) <= 1e-10
    did = port.get_derivative_id(list(orders))
    np.testing.assert_array_equal(
        port.eval_batch_host(pts[:5], derivative_id=did), got[:5])


@pytest.mark.parametrize("tolerance", [1e-6, 1e-13])
def test_to_tt_of_the_bs_interpolant(pair, pts, tolerance):
    """Exact-compression serving: the TT-SVD cores are bitwise the
    reference's; at 1e-13 the chain (dd surface, both routes) is within
    1e-12 of the dense f64 path."""
    ref, port = pair
    a, b = ref.to_tt(tolerance=tolerance), port.to_tt(tolerance=tolerance)
    assert b.tt_ranks == a.tt_ranks
    for x, y in zip(a._coeff_cores, b._coeff_cores):
        np.testing.assert_array_equal(np.asarray(x), y)
    dense = port.eval_batch_device(pts)
    assert _dev(b.eval_batch(pts), a.eval_batch(pts)) <= F64_TOL
    if tolerance == 1e-13:
        for groups in ("auto", None, (2, 2, 1)):
            assert _dev(b.eval_batch_dd(pts, groups=groups), dense) \
                <= F64_TOL
        for p in pts[:8]:
            assert abs(b.eval(p) - port.eval(p, [0] * 5)) <= \
                F64_TOL * float(dense.abs().max())
    else:
        assert _dev(b.eval_batch(pts), dense) <= 1e-4


SLICE_NAMES = ("integrate", "integrate_batch", "partial_integrate_batch",
               "roots", "minimize", "maximize", "roots_batch",
               "minimize_batch", "maximize_batch", "extrude", "slice",
               "fit", "run_completion", "hadamard", "compose",
               "sobol_indices", "interaction_matrix", "suggest_partition",
               "plot_1d", "plot_2d_surface", "plot_2d_contour",
               "plot_convergence")


@pytest.mark.parametrize("name", ["ChebyshevApproximation", "ChebyshevTT",
                                  "ChebyshevSpline", "ChebyshevSlider"])
def test_public_surface_matches_the_reference(name):
    """Every public name of the reference class exists on the port's,
    and none of them waits for a later slice (only ``mesh=`` does)."""
    import pychebyshev_tpu
    import pychebyshev_tpu_torch

    ref_cls = getattr(pychebyshev_tpu, name)
    cls = getattr(pychebyshev_tpu_torch, name)
    public = sorted(n for n in dir(ref_cls) if not n.startswith("_"))
    missing = [n for n in public if not hasattr(cls, n)]
    assert not missing, missing
    waiting = [n for n in public
               if "Not ported yet" in (getattr(cls, n).__doc__ or "")]
    assert not set(waiting) & set(SLICE_NAMES + ("to_slider",))
    assert waiting == []
    assert "critical_points" in public


def test_dense_surface_gaps_are_closed(pair, pts, tmp_path):
    ref, port = pair
    with pytest.warns(DeprecationWarning, match="fast_eval"):
        got = port.fast_eval(pts[0], [1, 0, 0, 0, 0])
    assert got == port.eval(pts[0], [1, 0, 0, 0, 0])
    path = tmp_path / "bs.pcb"
    port.save(path, format="binary")
    assert (ChebyshevApproximation.peek_format_version(path)
            == JaxApprox.peek_format_version(path))
    f = lambda x, _: math.exp(math.sin(3.0 * x[0]))  # noqa: E731
    assert (ChebyshevApproximation.get_optimal_n1(f, [-1.0, 1.0], 1e-8,
                                                  device="cpu")
            == JaxApprox.get_optimal_n1(f, [-1.0, 1.0], 1e-8))
    text, text_ref = str(port).splitlines(), str(ref).splitlines()
    assert text[0] == text_ref[0] and text[1:3] == text_ref[1:3]
    assert text[3] == "  Device:      cpu"
    assert text[-1] == text_ref[-1]
    assert float(text[-2].split()[-1]) == pytest.approx(
        float(text_ref[-2].split()[-1]), rel=1e-2)
    unbuilt = ChebyshevApproximation(None, 2, [[0, 1], [0, 1]], [3, 4],
                                     device="cpu", defer_build=True)
    assert str(unbuilt).splitlines()[0] == (
        "ChebyshevApproximation (2D, not built)")

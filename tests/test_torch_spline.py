"""The port's ChebyshevSpline against the JAX package's, on the CPU.

Same functions, knots and points go to both packages.  Tolerances
(scale-normalized max deviation): batched f64 paths <= 1e-12 of the JAX
package, single-point ``eval``/``eval_multi`` values <= 1e-14; the
reference's own assertions are kept beside them.
"""

import math
import pickle

import numpy as np
import pytest
import torch

from pychebyshev_tpu import ChebyshevApproximation as JaxApprox
from pychebyshev_tpu import ChebyshevSpline as JaxSpline
from pychebyshev_tpu_torch import (
    ChebyshevApproximation,
    ChebyshevSpline,
    SpecialPoints,
)
from pychebyshev_tpu_torch.ops import spline_eval
from pychebyshev_tpu_torch.utils.convert import spline_from_jax_state

F64_TOL = 1e-12
HOST_TOL = 1e-14
FIXTURES = __import__("pathlib").Path(__file__).parent / "fixtures"


def abs_kink(x, _):
    return abs(x[0])


def payoff_2d(x, _):
    # call-payoff kink along dim 0 at K=1.0, smooth in dim 1
    return max(x[0] - 1.0, 0.0) * math.exp(-0.1 * x[1])


def kinked_3d(x, _):
    return abs(x[0]) * (1.0 + x[1] ** 2) + abs(x[2] - 0.2) * x[1]


def _dev(a, ref):
    a = np.asarray(a, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert a.shape == ref.shape
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-300)


def _pair(fn, dim, domain, n_nodes, knots, **kw):
    ref = JaxSpline(fn, dim, domain, n_nodes, knots, **kw)
    ref.build(verbose=False)
    port = ChebyshevSpline(fn, dim, domain, n_nodes, knots, device="cpu",
                           **kw)
    port.build(verbose=False)
    return ref, port


@pytest.fixture(scope="module")
def spline_abs():
    return _pair(abs_kink, 1, [[-1, 1]], [11], [[0.0]])


@pytest.fixture(scope="module")
def spline_2d():
    return _pair(payoff_2d, 2, [[0.0, 2.0], [0.0, 1.0]], [12, 10],
                 [[1.0], []])


@pytest.fixture(scope="module")
def spline_3d():
    return _pair(kinked_3d, 3, [[-1, 1], [-1, 1], [-1, 1]], [7, 7, 7],
                 [[0.0], [], [0.2]])


def _box(domain, n, seed):
    rng = np.random.default_rng(seed)
    lo = np.array([b[0] for b in domain])
    hi = np.array([b[1] for b in domain])
    return lo + (hi - lo) * rng.uniform(size=(n, len(domain)))


class TestAccuracy:
    def test_abs_recovered_exactly(self, spline_abs):
        ref, port = spline_abs
        for x in [-0.73, -0.3, 0.001, 0.5, 0.99]:
            got = port.eval([x], [0])
            assert abs(got - abs(x)) < 1e-12
            assert abs(got - ref.eval([x], [0])) <= HOST_TOL

    def test_knot_point_routes_right(self, spline_abs):
        assert abs(spline_abs[1].eval([0.0], [0])) < 1e-13

    def test_derivative_piecewise(self, spline_abs):
        ref, port = spline_abs
        assert abs(port.eval([0.5], [1]) - 1.0) < 1e-10
        assert abs(port.eval([-0.5], [1]) + 1.0) < 1e-10
        assert abs(port.eval([0.5], [1]) - ref.eval([0.5], [1])) < 1e-12

    def test_derivative_at_knot_raises(self, spline_abs):
        with pytest.raises(ValueError, match="not defined"):
            spline_abs[1].eval([0.0], [1])

    def test_2d_payoff(self, spline_2d):
        ref, port = spline_2d
        for pt in [[0.5, 0.3], [1.5, 0.7], [1.0001, 0.1]]:
            got = port.eval(pt, [0, 0])
            assert abs(got - payoff_2d(pt, None)) < 1e-10
            assert abs(got - ref.eval(pt, [0, 0])) <= HOST_TOL

    def test_spline_beats_plain_approximation(self):
        plain = ChebyshevApproximation(abs_kink, 1, [[-1, 1]], [15],
                                       device="cpu")
        plain.build(verbose=False)
        sp = ChebyshevSpline(abs_kink, 1, [[-1, 1]], [15], [[0.0]],
                             device="cpu")
        sp.build(verbose=False)
        x = 0.137
        assert abs(sp.eval([x], [0]) - abs(x)) < 1e-12
        assert abs(plain.vectorized_eval([x], [0]) - abs(x)) > 1e-4


class TestDispatch:
    def test_special_points_dispatches_to_spline(self):
        obj = ChebyshevApproximation(
            abs_kink, 1, [[-1, 1]], n_nodes=[[15, 15]],
            special_points=[[0.0]], device="cpu")
        assert isinstance(obj, ChebyshevSpline)
        assert obj.device == torch.device("cpu")
        obj.build(verbose=False)
        assert abs(obj.eval([0.4], [0]) - 0.4) < 1e-12

    def test_flat_dispatch_returns_port_spline(self):
        # The dispatch the slice's contract names: knots in dim 0 only.
        obj = ChebyshevApproximation(
            payoff_2d, 2, [[0.0, 2.0], [0.0, 1.0]], [[9, 9], [9]],
            special_points=[[1.0], []], device="cpu")
        assert type(obj) is ChebyshevSpline

    def test_empty_special_points_stays_approximation(self):
        obj = ChebyshevApproximation(
            abs_kink, 1, [[-1, 1]], [15], special_points=[[]], device="cpu")
        assert type(obj) is ChebyshevApproximation
        assert obj.get_special_points() == [[]]

    def test_typed_helper(self):
        obj = ChebyshevApproximation(
            abs_kink, 1, [[-1, 1]], n_nodes=[[9, 9]],
            special_points=SpecialPoints(knots_per_dim=[[0.0]]),
            device="cpu")
        assert isinstance(obj, ChebyshevSpline)

    @pytest.mark.parametrize("args, kwargs", [
        ((abs_kink, 1, [[-1, 1]], [[9, 9]]), {"special_points": [[2.0]]}),
        ((abs_kink, 2, [[-1, 1], [-1, 1]]), {"special_points": [[0.0]]}),
        ((abs_kink, 1, [[-1, 1]], [9]), {"special_points": [[0.0]]}),
        ((abs_kink, 1, [[-1, 1]]), {"special_points": [0.0]}),
    ], ids=["outside", "wrong-length", "flat-n_nodes", "not-nested"])
    def test_special_points_validation(self, args, kwargs):
        with pytest.raises(ValueError) as port_err:
            ChebyshevApproximation(*args, device="cpu", **kwargs)
        with pytest.raises(ValueError) as jax_err:
            JaxApprox(*args, **kwargs)
        assert str(port_err.value) == str(jax_err.value)

    def test_dispatch_needs_a_device(self):
        with pytest.raises(TypeError, match="device"):
            ChebyshevApproximation(abs_kink, 1, [[-1, 1]], [[9, 9]],
                                   special_points=[[0.0]])

    def test_knot_validation(self):
        with pytest.raises(ValueError, match="sorted"):
            ChebyshevSpline(abs_kink, 1, [[-1, 1]], [9], [[0.5, -0.5]],
                            device="cpu")
        with pytest.raises(ValueError, match="strictly"):
            ChebyshevSpline(abs_kink, 1, [[-1, 1]], [9], [[1.0]],
                            device="cpu")


class TestBatchRouting:
    @pytest.mark.parametrize("orders", [[0, 0], [1, 0], [0, 1]])
    def test_batch_matches_jax(self, spline_2d, orders):
        ref, port = spline_2d
        pts = _box(port.domain, 500, 11)
        got = port.eval_batch(pts, orders)
        assert isinstance(got, np.ndarray)
        assert _dev(got, ref.eval_batch(pts, orders)) <= F64_TOL

    def test_batch_matches_single(self, spline_2d):
        port = spline_2d[1]
        pts = _box(port.domain, 50, 11)
        batch = port.eval_batch(pts, [0, 0])
        singles = [port.eval(list(p), [0, 0]) for p in pts]
        np.testing.assert_allclose(batch, singles, atol=1e-13)

    def test_batch_spans_pieces(self, spline_abs):
        pts = np.array([[-0.5], [0.5], [-0.1], [0.9], [0.0]])
        out = spline_abs[1].eval_batch(pts, [0])
        np.testing.assert_allclose(out, [0.5, 0.5, 0.1, 0.9, 0.0],
                                   atol=1e-12)

    def test_3d_masked_and_routed_agree_with_jax(self, spline_3d):
        # The class path routes; the masked route (all 4 pieces stacked,
        # one batched pass) computes the same numbers at f64.
        ref, port = spline_3d
        pts = _box(port.domain, 600, 5)
        want = ref.eval_batch(pts, [0, 1, 0])
        flat = spline_eval.route_piece_indices(
            port.knots, spline_eval.piece_strides(
                [len(k) for k in port.knots]), pts)
        stacked = spline_eval.stack_pieces(port._pieces)
        masked = spline_eval.masked_eval_batch(
            *stacked, flat, torch.as_tensor(pts), (0, 1, 0))
        multi = spline_eval.masked_eval_batch_multi(
            *stacked, flat, torch.as_tensor(pts), [[0, 1, 0], [1, 0, 0]])
        routed = port.eval_batch(pts, [0, 1, 0])
        for got in (masked, routed, multi[0]):
            assert _dev(got, want) <= F64_TOL
        assert _dev(multi[1], ref.eval_batch(pts, [1, 0, 0])) <= F64_TOL

    def test_eval_multi(self, spline_2d):
        ref, port = spline_2d
        pt = [0.5, 0.5]
        multi = port.eval_multi(pt, [[0, 0], [0, 1]])
        assert abs(multi[0] - port.eval(pt, [0, 0])) < 1e-13
        assert abs(multi[1] - port.eval(pt, [0, 1])) < 1e-13
        want = ref.eval_multi([1.4, 0.5], [[0, 0], [1, 0]])
        got = port.eval_multi([1.4, 0.5], [[0, 0], [1, 0]])
        assert abs(got[0] - want[0]) <= HOST_TOL * abs(want[0])

    def test_derivative_id(self, spline_2d):
        port = spline_2d[1]
        did = port.get_derivative_id([0, 1])
        assert (port.eval([0.5, 0.5], derivative_id=did)
                == port.eval([0.5, 0.5], [0, 1]))

    def test_routing_matches_jax_at_knots(self, spline_3d):
        from pychebyshev_tpu.ops import spline_eval as jax_spline_eval
        port = spline_3d[1]
        strides = spline_eval.piece_strides([len(k) for k in port.knots])
        pts = _box(port.domain, 64, 3)
        pts[:8, 0] = 0.0
        pts[8:16, 2] = 0.2
        pts[16:20] = [[-1.5, 0, 0.2], [1.5, 0, 0.3], [0, 0, -3], [1, 1, 1]]
        got = spline_eval.route_piece_indices(port.knots, strides, pts)
        want = jax_spline_eval.route_piece_indices(port.knots, strides, pts)
        np.testing.assert_array_equal(got.numpy(), want)


class TestNestedNs:
    def test_nested_n_nodes(self):
        ref, port = _pair(abs_kink, 1, [[-1, 1]], [[9, 17]], [[0.0]])
        assert port._pieces[0].n_nodes == [9]
        assert port._pieces[1].n_nodes == [17]
        assert abs(port.eval([0.6], [0]) - 0.6) < 1e-12
        assert port.get_used_ns() == [[9, 17]]
        pts = np.linspace(-0.95, 0.95, 41)[:, None]
        assert not port._pieces_stackable()
        assert _dev(port.eval_batch(pts, [1]),
                    ref.eval_batch(pts, [1])) <= F64_TOL

    def test_nested_length_validation(self):
        with pytest.raises(ValueError, match="entries"):
            ChebyshevSpline(abs_kink, 1, [[-1, 1]], [[9, 9, 9]], [[0.0]],
                            device="cpu")

    def test_auto_n_per_piece(self):
        ref, port = _pair(abs_kink, 1, [[-1, 1]], None, [[0.0]],
                          error_threshold=1e-10)
        assert port.error_estimate() <= 1e-10
        assert port.n_nodes == ref.n_nodes
        assert abs(port.error_estimate() - ref.error_estimate()) <= 1e-15


class TestAlgebra:
    def test_add_and_scalar(self, spline_abs):
        ref, port = spline_abs
        for op in (lambda s: s + s, lambda s: s * 3.0, lambda s: -s,
                   lambda s: s - 0.5 * s, lambda s: s / 4.0):
            got, want = op(port), op(ref)
            assert isinstance(got, ChebyshevSpline)
            for x in (-0.4, 0.2, 0.3):
                assert abs(got.eval([x], [0])
                           - want.eval([x], [0])) <= HOST_TOL

    def test_results_own_their_tensors(self, spline_abs):
        port = spline_abs[1]
        total = port + port
        before = port.eval([0.3], [0])
        total._pieces[1].tensor_values.mul_(2.0)
        assert port.eval([0.3], [0]) == before

    def test_inplace(self):
        ref, port = _pair(abs_kink, 1, [[-1, 1]], [9], [[0.0]])
        tensor = port._pieces[0].tensor_values
        port *= 2.0
        ref *= 2.0
        assert port._pieces[0].tensor_values is not tensor
        assert abs(port.eval([0.3], [0]) - 0.6) < 1e-12
        port += port.clone()
        port /= 4.0
        assert abs(port.eval([-0.3], [0]) - 0.3) < 1e-12

    def test_knot_mismatch(self, spline_abs):
        other = ChebyshevSpline(abs_kink, 1, [[-1, 1]], [11], [[0.5]],
                                device="cpu")
        other.build(verbose=False)
        with pytest.raises(ValueError, match="Knot mismatch"):
            _ = spline_abs[1] + other

    def test_differentiate(self, spline_2d):
        ref, port = spline_2d
        pts = _box(port.domain, 200, 4)
        got = port.differentiate([1, 0]).eval_batch(pts, [0, 0])
        assert _dev(got, ref.differentiate([1, 0]).eval_batch(
            pts, [0, 0])) <= F64_TOL


class TestSerialization:
    def test_pickle_roundtrip(self, spline_2d, tmp_path):
        port = spline_2d[1]
        p = tmp_path / "sp.pkl"
        port.save(p)
        loaded = ChebyshevSpline.load(p, device="cpu")
        pt = [0.7, 0.2]
        assert loaded.eval(pt, [0, 0]) == port.eval(pt, [0, 0])
        pts = _box(port.domain, 32, 2)
        np.testing.assert_array_equal(loaded.eval_batch(pts, [0, 0]),
                                      port.eval_batch(pts, [0, 0]))

    def test_binary_bytes_equal_the_reference(self, spline_2d, tmp_path):
        ref, port = spline_2d
        port.save(tmp_path / "port.pcb", format="binary")
        ref.save(str(tmp_path / "ref.pcb"), format="binary")
        raw = (tmp_path / "port.pcb").read_bytes()
        assert raw[:4] == b"PCB\x00"
        assert raw[6:8] == (2).to_bytes(2, "little")
        assert raw == (tmp_path / "ref.pcb").read_bytes()
        loaded = ChebyshevSpline.load(tmp_path / "ref.pcb", device="cpu")
        pt = [1.3, 0.8]
        assert abs(loaded.eval(pt, [0, 0])
                   - port.eval(pt, [0, 0])) < 1e-14

    def test_pcb_fixture_matches_expected_values(self):
        spl = ChebyshevSpline.load(FIXTURES / "spline_1d_kink.pcb",
                                   device="cpu")
        rows = np.loadtxt(FIXTURES / "spline_1d_kink.expected")
        pts, expected = rows[:, :-1], rows[:, -1]
        assert _dev(spl.eval_batch(pts, [0]), expected) <= F64_TOL
        host = [spl.eval(list(p), [0]) for p in pts]
        assert _dev(host, expected) <= F64_TOL

    def test_binary_rejects_nested(self, tmp_path):
        sp = ChebyshevSpline(abs_kink, 1, [[-1, 1]], [[9, 11]], [[0.0]],
                             device="cpu")
        sp.build(verbose=False)
        with pytest.raises(NotImplementedError):
            sp.save(tmp_path / "x.pcb", format="binary")
        with pytest.raises(NotImplementedError, match="flat n_nodes"):
            sp.save(tmp_path / "x.npz", format="npz")

    def test_nodes_from_values_roundtrip(self, spline_abs):
        info = ChebyshevSpline.nodes(1, [[-1, 1]], [11], [[0.0]])
        want = JaxSpline.nodes(1, [[-1, 1]], [11], [[0.0]])
        assert info["num_pieces"] == want["num_pieces"] == 2
        for a, b in zip(info["pieces"], want["pieces"]):
            np.testing.assert_array_equal(a["full_grid"], b["full_grid"])
        piece_values = [
            np.abs(piece["full_grid"][:, 0]).reshape(piece["shape"])
            for piece in info["pieces"]
        ]
        sp = ChebyshevSpline.from_values(piece_values, 1, [[-1, 1]], [11],
                                         [[0.0]], device="cpu")
        for x in [-0.8, -0.2, 0.3, 0.7]:
            assert abs(sp.eval([x], [0])
                       - spline_abs[1].eval([x], [0])) < 1e-14

    def test_defer_build(self):
        sp = ChebyshevSpline(None, 1, [[-1, 1]], [9], [[0.0]],
                             defer_build=True, device="cpu")
        assert not sp.is_construction_finished()
        vals = [np.abs(p.get_evaluation_points()[:, 0]).reshape(9)
                for p in sp._pieces]
        sp.set_original_function_values(vals)
        assert sp.is_construction_finished()
        assert abs(sp.eval([0.5], [0]) - 0.5) < 1e-12

    def test_defer_build_atomic(self):
        sp = ChebyshevSpline(None, 1, [[-1, 1]], [9], [[0.0]],
                             defer_build=True, device="cpu")
        with pytest.raises(ValueError):
            sp.set_original_function_values([np.zeros(9), np.zeros(7)])
        assert all(p.tensor_values is None for p in sp._pieces)

    def test_from_jax_state(self, spline_3d):
        ref, port = spline_3d
        state = {
            "domain": ref.domain, "n_nodes": ref.n_nodes,
            "knots": ref.knots,
            "max_derivative_order": ref.max_derivative_order,
            "pieces": [{
                "tensor_values": np.asarray(p.tensor_values),
                "domain": p.domain, "n_nodes": p.n_nodes,
                "nodes": [np.asarray(a) for a in p.nodes],
                "weights": [np.asarray(a) for a in p.weights],
                "diff_matrices": [np.asarray(a) for a in p.diff_matrices],
                "max_derivative_order": p.max_derivative_order,
            } for p in ref._pieces]}
        moved = spline_from_jax_state(state, device="cpu")
        pts = _box(port.domain, 100, 8)
        assert _dev(moved.eval_batch(pts, [0, 0, 0]),
                    ref.eval_batch(pts, [0, 0, 0])) <= F64_TOL
        state["pieces"] = state["pieces"][:-1]
        with pytest.raises(ValueError, match="cells"):
            spline_from_jax_state(state, device="cpu")


class TestBatchMulti:
    SPECS = [[0, 0], [1, 0], [0, 1], [1, 1], [2, 0]]

    def test_masked_matches_jax_and_per_spec(self, spline_2d):
        ref, port = spline_2d
        pts = _box(port.domain, 400, 7)
        out = port.vectorized_eval_batch_multi(pts, self.SPECS)
        assert out.shape == (400, 5)
        want = ref.vectorized_eval_batch_multi(pts, self.SPECS)
        assert _dev(out, want) <= F64_TOL
        flat = spline_eval.route_piece_indices(
            port.knots, spline_eval.piece_strides(
                [len(k) for k in port.knots]), pts)
        masked = spline_eval.masked_eval_batch_multi(
            *spline_eval.stack_pieces(port._pieces), flat,
            torch.as_tensor(pts), self.SPECS)
        assert _dev(masked.T, want) <= F64_TOL
        for j, orders in enumerate(self.SPECS):
            np.testing.assert_allclose(out[:, j],
                                       port.eval_batch(pts, orders),
                                       atol=1e-12)

    def test_matches_eval_multi_single_point(self, spline_2d):
        port = spline_2d[1]
        pt = [0.7, 0.4]
        orders_list = [[0, 0], [1, 0], [0, 2]]
        batch = port.vectorized_eval_batch_multi([pt], orders_list)
        np.testing.assert_allclose(batch[0],
                                   port.eval_multi(pt, orders_list),
                                   atol=1e-12)

    def test_knot_point_one_sided(self, spline_abs):
        out = spline_abs[1].vectorized_eval_batch_multi([[0.0]], [[0], [1]])
        assert abs(out[0, 0]) < 1e-13
        assert abs(out[0, 1] - 1.0) < 1e-10

    def test_routed_route_matches_jax(self, spline_3d):
        # The class path groups points by piece (the reference stacks
        # this 4-piece spline on its masked route).
        ref, port = spline_3d
        pts = _box(port.domain, 200, 3)
        orders_list = [[0, 0, 0], [1, 0, 0]]
        want = ref.vectorized_eval_batch_multi(pts, orders_list)
        out = port.vectorized_eval_batch_multi(pts, orders_list)
        assert _dev(out, want) <= F64_TOL
        for j, orders in enumerate(orders_list):
            np.testing.assert_allclose(out[:, j],
                                       port.eval_batch(pts, orders),
                                       atol=1e-12)

    def test_validation(self, spline_2d):
        with pytest.raises(ValueError, match="does not match"):
            spline_2d[1].vectorized_eval_batch_multi(np.zeros((2, 2)),
                                                     [[0, 0, 0]])
        unbuilt = ChebyshevSpline(abs_kink, 1, [[-1, 1]], [7], [[0.0]],
                                  device="cpu")
        with pytest.raises(RuntimeError, match="build"):
            unbuilt.vectorized_eval_batch_multi(np.zeros((1, 1)), [[0]])
        assert spline_2d[1].vectorized_eval_batch_multi(
            np.zeros((3, 2)), []).shape == (3, 0)

    def test_alias(self, spline_2d):
        port = spline_2d[1]
        assert port.eval_batch_multi == port.vectorized_eval_batch_multi


class TestSpecialPointsDeeper:
    def test_matches_direct_spline(self):
        via = ChebyshevApproximation(abs_kink, 1, [[-1, 1]],
                                     n_nodes=[[11, 11]],
                                     special_points=[[0.0]], device="cpu")
        direct = ChebyshevSpline(abs_kink, 1, [[-1, 1]], [[11, 11]],
                                 [[0.0]], device="cpu")
        via.build(verbose=False)
        direct.build(verbose=False)
        for x in (-0.9, -0.01, 0.01, 0.5):
            assert via.eval([x], [0]) == direct.eval([x], [0])

    def test_multi_dim_kinks(self):
        f = lambda x, _: abs(x[0]) + abs(x[1] - 0.5)
        kw = dict(n_nodes=[[8, 8], [8, 8]], special_points=[[0.0], [0.5]])
        obj = ChebyshevApproximation(f, 2, [[-1, 1], [-1, 1]], device="cpu",
                                     **kw)
        ref = JaxApprox(f, 2, [[-1, 1], [-1, 1]], **kw)
        assert isinstance(obj, ChebyshevSpline)
        obj.build(verbose=False)
        ref.build(verbose=False)
        assert len(obj._pieces) == 4
        assert abs(obj.eval([0.4, 0.9], [0, 0]) - 0.8) < 1e-10
        pts = _box([[-1, 1], [-1, 1]], 100, 9)
        assert _dev(obj.eval_batch(pts, [0, 0]),
                    ref.eval_batch(pts, [0, 0])) <= F64_TOL

    def test_dispatched_object_pickles(self):
        obj = ChebyshevApproximation(abs_kink, 1, [[-1, 1]],
                                     n_nodes=[[9, 9]],
                                     special_points=[[0.0]], device="cpu")
        obj.build(verbose=False)
        back = pickle.loads(pickle.dumps(obj))
        assert isinstance(back, ChebyshevSpline)
        assert back.eval([0.3], [0]) == obj.eval([0.3], [0])

    def test_dispatched_binary_rejected_nested(self, tmp_path):
        obj = ChebyshevApproximation(abs_kink, 1, [[-1, 1]],
                                     n_nodes=[[9, 9]],
                                     special_points=[[0.0]], device="cpu")
        obj.build(verbose=False)
        with pytest.raises(NotImplementedError, match="n_nodes"):
            obj.save(str(tmp_path / "d.pcb"), format="binary")


class TestAutoNResolutionAndHeterogeneousPieces:
    def test_homogeneous_auto_n_resolves_flat_n_nodes(self):
        ref, port = _pair(lambda x, _: abs(x[0]) ** 3, 1, [[-1, 1]], None,
                          [[0.0]], error_threshold=1e-8)
        assert all(isinstance(n, int) for n in port.n_nodes)
        assert port.n_nodes == ref.n_nodes
        doubled = port + port
        assert doubled.eval([0.4], [0]) == pytest.approx(
            2 * port.eval([0.4], [0]), abs=1e-12)
        assert port.get_used_ns() == port.n_nodes

    def test_heterogeneous_auto_n_pieces_stay_off_the_stack(self):
        def lopsided(x, _):
            return x[0] if x[0] < 0 else math.sin(25 * x[0])

        ref, port = _pair(lopsided, 1, [[-1, 1]], None, [[0.0]],
                          error_threshold=1e-8)
        assert len({tuple(p.n_nodes) for p in port._pieces}) > 1
        assert not port._pieces_stackable()
        pts = np.linspace(-0.9, 0.9, 50).reshape(-1, 1)
        out = port.eval_batch(pts, [0])
        np.testing.assert_allclose(
            out, [lopsided(p, None) for p in pts], atol=1e-7)
        assert _dev(out, ref.eval_batch(pts, [0])) <= F64_TOL
        multi = port.vectorized_eval_batch_multi(pts, [[0], [1]])
        assert _dev(multi, ref.vectorized_eval_batch_multi(
            pts, [[0], [1]])) <= F64_TOL

    def test_ctor_rejects_duplicate_knots(self):
        with pytest.raises(ValueError, match="duplicates"):
            ChebyshevSpline(lambda x, _: abs(x[0]), 1, [[-1, 1]], [7],
                            knots=[[0.5, 0.5]], device="cpu")

    def test_deferred_fill_seeds_the_host_cache(self):
        layout = ChebyshevSpline.nodes(1, [[-1, 1]], [9], [[0.0]])
        vals = [np.abs(np.asarray(p["full_grid"])[:, 0]).reshape(
            p["shape"]) for p in layout["pieces"]]
        sp = ChebyshevSpline(None, 1, [[-1, 1]], [9], [[0.0]],
                             defer_build=True, device="cpu")
        sp.set_original_function_values(vals)
        for piece in sp._pieces:
            assert "_host_cache" in piece.__dict__
        assert sp.eval([0.4], [0]) == pytest.approx(0.4, abs=1e-12)


class TestSurface:
    def test_getters_and_printing(self, spline_2d):
        ref, port = spline_2d
        assert port.num_pieces == ref.num_pieces == 2
        assert port.total_build_evals == ref.total_build_evals
        assert port.get_num_evaluation_points() == (
            ref.get_num_evaluation_points())
        np.testing.assert_array_equal(port.get_evaluation_points(),
                                      ref.get_evaluation_points())
        assert port.get_special_points() == [[1.0], []]
        assert port.get_constructor_type() == "ChebyshevSpline"
        assert abs(port.error_estimate() - ref.error_estimate()) <= 1e-15
        assert "ChebyshevSpline (2D, built)" in str(port)
        assert "device=cpu" in repr(port)
        before = port.eval([1.5, 0.5], [0, 0])
        clone = port.clone()
        clone._pieces[1].tensor_values.mul_(0.0)
        assert clone.eval([1.5, 0.5], [0, 0]) == 0.0
        assert port.eval([1.5, 0.5], [0, 0]) == before

    @pytest.mark.parametrize("name", ["integrate", "roots", "minimize",
                                      "sobol_indices", "extrude", "compose",
                                      "hadamard", "plot_1d"])
    def test_unported_methods_name_the_roadmap(self, spline_abs, name):
        ref, port = spline_abs
        # every name is ported now (minimize bare: the global form)
        _bare_call_as_reference(ref, port, name)
        _bare_call_as_reference(ref, port, "fit")
        want, got = ref.critical_points(), port.critical_points()
        assert [c.kind for c in got] == [c.kind for c in want]
        np.testing.assert_allclose(_flat([c.point for c in got]),
                                   _flat([c.point for c in want]),
                                   rtol=0, atol=1e-10)

    def test_auto_knots(self):
        f = lambda x, _: abs(x[0] - 0.3) + x[1] ** 2
        spl = ChebyshevSpline.auto_knots(f, 2, [[-1, 1], [-1, 1]],
                                         n_nodes_per_piece=8, device="cpu")
        ref = JaxSpline.auto_knots(f, 2, [[-1, 1], [-1, 1]],
                                   n_nodes_per_piece=8)
        assert spl.knots == ref.knots
        assert abs(spl.eval([0.5, 0.2], [0, 0])
                   - ref.eval([0.5, 0.2], [0, 0])) <= 1e-14


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
    np.testing.assert_allclose(_flat(getattr(port, name)()), _flat(want),
                               rtol=1e-12, atol=1e-10)


def _flat(result):
    """A bare call's result as a flat list of floats: dict values in key
    order, nested lists in order, a plot's line data; nothing for
    None."""
    if result is None:
        return []
    if isinstance(result, dict):
        return [v for k in sorted(result) for v in _flat(result[k])]
    if isinstance(result, (list, tuple)):
        return [v for item in result for v in _flat(item)]
    if hasattr(result, "get_lines"):
        import matplotlib.pyplot as plt
        data = [v for line in result.get_lines()
                for v in np.ravel(line.get_xydata())]
        plt.close(result.figure)
        return data
    return np.ravel(np.asarray(result, float)).tolist()

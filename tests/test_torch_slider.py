"""The port's ChebyshevSlider against the JAX package's, on the CPU.

Same functions, partitions, pivots and points go to both packages.
Tolerances (scale-normalized max deviation): batched f64 paths <= 1e-12
of the JAX package, single-point ``eval``/``eval_multi`` values
<= 1e-14, ``to_tt`` cores within 1e-14 of the reference's.
"""

import math
import pickle

import numpy as np
import pytest

from pychebyshev_tpu import ChebyshevSlider as JaxSlider
from pychebyshev_tpu_torch import ChebyshevSlider, ChebyshevTT
from pychebyshev_tpu_torch.utils.convert import slider_from_jax_state

F64_TOL = 1e-12
HOST_TOL = 1e-14
D = 6
W = np.linspace(0.5, 1.5, D)
PARTITION = [[0], [1, 2], [3], [4, 5]]


def additive_3d(x, _):
    return math.sin(x[0]) + x[1] ** 2 + math.exp(0.5 * x[2])


def grouped_6d(points, _=None):
    p = np.asarray(points, dtype=np.float64)
    return (np.sum(W * np.sin(p), axis=1) + 0.25 * np.sum(p ** 2, axis=1)
            + p[:, 1] * p[:, 2] + np.cos(p[:, 4] - p[:, 5]))


def _dev(a, ref):
    a = np.asarray(a, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert a.shape == ref.shape
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-300)


def _pair(fn, dim, n_nodes, partition, pivot, vectorized=False):
    kw = dict(vectorized=vectorized)
    ref = JaxSlider(fn, dim, [[-1, 1]] * dim, n_nodes, partition, pivot,
                    **kw)
    ref.build(verbose=False)
    port = ChebyshevSlider(fn, dim, [[-1, 1]] * dim, n_nodes, partition,
                           pivot, device="cpu", **kw)
    port.build(verbose=False)
    return ref, port


@pytest.fixture(scope="module")
def slider_3d():
    return _pair(additive_3d, 3, [9] * 3, [[0], [1], [2]], [0.0] * 3)


@pytest.fixture(scope="module")
def slider_6d():
    return _pair(grouped_6d, D, [7, 8, 7, 9, 7, 6], PARTITION,
                 [0.1, -0.2, 0.0, 0.3, 0.0, 0.1], vectorized=True)


@pytest.fixture(scope="module")
def pts():
    return np.random.default_rng(5).uniform(-0.95, 0.95, (400, D))


class TestAccuracy:
    def test_additive_exact(self, slider_3d):
        ref, port = slider_3d
        for p in ([0.3, -0.5, 0.8], [-0.9, 0.1, 0.0]):
            got = port.eval(p, [0, 0, 0])
            assert abs(got - additive_3d(p, None)) < 1e-8    # 9 nodes
            assert abs(got - ref.eval(p, [0, 0, 0])) <= HOST_TOL

    def test_grouped_matches_jax_and_the_function(self, slider_6d, pts):
        ref, port = slider_6d
        got = port.eval_batch(pts)
        assert isinstance(got, np.ndarray)
        assert _dev(got, ref.eval_batch(pts)) <= F64_TOL
        assert _dev(got, grouped_6d(pts)) < 1e-4   # 6-9 nodes a dim

    @pytest.mark.parametrize("orders", [[1, 0, 0, 0, 0, 0],
                                        [0, 1, 1, 0, 0, 0],
                                        [0, 0, 2, 0, 0, 0],
                                        [1, 1, 0, 0, 0, 0]],
                             ids=["owning", "in-group", "second", "cross"])
    def test_derivatives_route_like_jax(self, slider_6d, pts, orders):
        ref, port = slider_6d
        got = port.eval_batch(pts, orders)
        want = ref.eval_batch(pts, orders)
        if orders == [1, 1, 0, 0, 0, 0]:
            assert not np.any(got) and not np.any(want)
            assert port.eval(pts[0], orders) == 0.0
        else:
            assert _dev(got, want) <= F64_TOL
            host = [port.eval(list(p), orders) for p in pts[:8]]
            assert _dev(host, [ref.eval(list(p), orders)
                               for p in pts[:8]]) <= 1e-13

    def test_eval_batch_matches_single(self, slider_6d, pts):
        port = slider_6d[1]
        batch = port.eval_batch(pts[:30], [0] * D)
        singles = [port.eval(list(p), [0] * D) for p in pts[:30]]
        np.testing.assert_allclose(batch, singles, atol=1e-13)

    def test_eval_multi(self, slider_3d):
        ref, port = slider_3d
        p = [0.2, 0.4, -0.1]
        specs = [[0, 0, 0], [1, 0, 0], [0, 0, 2]]
        got = port.eval_multi(p, specs)
        want = ref.eval_multi(p, specs)
        assert abs(got[0] - want[0]) <= HOST_TOL * abs(want[0])
        np.testing.assert_allclose(got, want, rtol=1e-13)

    def test_derivative_id(self, slider_3d):
        port = slider_3d[1]
        did = port.get_derivative_id([0, 1, 0])
        assert (port.eval([0.1, 0.5, 0.2], derivative_id=did)
                == port.eval([0.1, 0.5, 0.2], [0, 1, 0]))

    def test_partition_validation(self):
        with pytest.raises(ValueError, match="cover all"):
            ChebyshevSlider(additive_3d, 3, [[-1, 1]] * 3, [5] * 3,
                            [[0], [1]], [0.0] * 3, device="cpu")
        with pytest.raises(ValueError, match="non-empty"):
            ChebyshevSlider(additive_3d, 3, [[-1, 1]] * 3, [5] * 3,
                            [[0], [], [1, 2]], [0.0] * 3, device="cpu")


class TestBatchMulti:
    SPECS = [[0] * D, [1, 0, 0, 0, 0, 0], [0, 1, 1, 0, 0, 0],
             [0, 0, 0, 2, 0, 0], [1, 0, 0, 1, 0, 0]]

    def test_matches_jax_and_per_spec(self, slider_6d, pts):
        ref, port = slider_6d
        out = port.vectorized_eval_batch_multi(pts, self.SPECS)
        assert out.shape == (len(pts), len(self.SPECS))
        want = ref.vectorized_eval_batch_multi(pts, self.SPECS)
        for j, spec in enumerate(self.SPECS[:4]):
            assert _dev(out[:, j], want[:, j]) <= F64_TOL
            np.testing.assert_allclose(out[:, j],
                                       port.eval_batch(pts, spec),
                                       atol=1e-12)
        assert not np.any(out[:, 4])               # cross-group: exact 0

    def test_matches_eval_multi_single_point(self, slider_3d):
        port = slider_3d[1]
        p = [0.3, -0.2, 0.6]
        specs = [[0, 0, 0], [1, 0, 0], [0, 1, 0]]
        np.testing.assert_allclose(
            port.vectorized_eval_batch_multi([p], specs)[0],
            port.eval_multi(p, specs), atol=1e-12)

    def test_validation(self, slider_3d):
        port = slider_3d[1]
        with pytest.raises(ValueError, match="does not match"):
            port.vectorized_eval_batch_multi(np.zeros((2, 3)), [[0, 0]])
        assert port.vectorized_eval_batch_multi(np.zeros((2, 3)),
                                                []).shape == (2, 0)
        unbuilt = ChebyshevSlider(additive_3d, 3, [[-1, 1]] * 3, [5] * 3,
                                  [[0], [1], [2]], [0.0] * 3, device="cpu")
        with pytest.raises(RuntimeError, match="build"):
            unbuilt.vectorized_eval_batch_multi(np.zeros((1, 3)), [[0] * 3])

    def test_alias(self, slider_3d):
        port = slider_3d[1]
        assert port.eval_batch_multi == port.vectorized_eval_batch_multi


class TestErrorEstimate:
    def test_sum_over_slides(self, slider_6d):
        ref, port = slider_6d
        assert port.error_estimate() == pytest.approx(
            sum(s.error_estimate() for s in port.slides), rel=1e-14)
        assert abs(port.error_estimate() - ref.error_estimate()) <= 1e-15
        assert abs(port.error_estimate(tail=2)
                   - ref.error_estimate(tail=2)) <= 1e-15

    def test_unbuilt(self):
        sl = ChebyshevSlider(additive_3d, 3, [[-1, 1]] * 3, [5] * 3,
                             [[0], [1], [2]], [0.0] * 3, device="cpu")
        for call in (lambda: sl.error_estimate(),
                     lambda: sl.eval([0, 0, 0], [0, 0, 0]),
                     lambda: sl.eval_batch(np.zeros((1, 3)))):
            with pytest.raises(RuntimeError, match="build"):
                call()


class TestAlgebra:
    def test_add_scalar(self, slider_6d, pts):
        ref, port = slider_6d
        for op in (lambda s: s + s, lambda s: s - 0.5 * s,
                   lambda s: s * 3.0, lambda s: -s, lambda s: s / 4.0):
            got, want = op(port), op(ref)
            assert isinstance(got, ChebyshevSlider)
            assert got.pivot_value == pytest.approx(want.pivot_value,
                                                    rel=1e-15)
            assert _dev(got.eval_batch(pts), want.eval_batch(pts)) <= F64_TOL

    def test_inplace(self):
        _, port = _pair(additive_3d, 3, [7] * 3, [[0], [1], [2]],
                        [0.0] * 3)
        before = port.eval([0.3, 0.2, 0.1], [0, 0, 0])
        tensor = port.slides[0].tensor_values
        port *= 2.0
        assert port.slides[0].tensor_values is not tensor
        assert port.eval([0.3, 0.2, 0.1], [0, 0, 0]) == pytest.approx(
            2 * before, abs=1e-13)
        port += port.clone()
        port -= 0.5 * port
        port /= 2.0
        assert port.eval([0.3, 0.2, 0.1], [0, 0, 0]) == pytest.approx(
            before, abs=1e-13)

    def test_partition_mismatch(self, slider_3d):
        other = ChebyshevSlider(additive_3d, 3, [[-1, 1]] * 3, [9] * 3,
                                [[0, 1], [2]], [0.0] * 3, device="cpu")
        other.build(verbose=False)
        with pytest.raises(ValueError, match="Partition mismatch"):
            _ = slider_3d[1] + other

    @pytest.mark.parametrize("orders", [[0] * D, [0, 1, 0, 0, 0, 0],
                                        [1, 0, 0, 0, 0, 1]],
                             ids=["none", "one-group", "cross"])
    def test_differentiate(self, slider_6d, pts, orders):
        ref, port = slider_6d
        got = port.differentiate(orders)
        want = ref.differentiate(orders)
        assert got.pivot_value == want.pivot_value
        a, b = got.eval_batch(pts), want.eval_batch(pts)
        if not np.any(b):
            assert not np.any(a)
        else:
            assert _dev(a, b) <= F64_TOL


class TestSerialization:
    def test_pickle_roundtrip(self, slider_6d, pts, tmp_path):
        port = slider_6d[1]
        p = tmp_path / "sl.pkl"
        port.save(p)
        loaded = ChebyshevSlider.load(p, device="cpu")
        np.testing.assert_array_equal(loaded.eval_batch(pts),
                                      port.eval_batch(pts))
        assert loaded.function is None

    def test_load_wrong_type(self, tmp_path):
        p = tmp_path / "x.pkl"
        p.write_bytes(pickle.dumps({"not": "a slider"}))
        with pytest.raises(TypeError, match="ChebyshevSlider"):
            ChebyshevSlider.load(p, device="cpu")

    def test_unbuilt_save_and_npz(self, slider_3d, tmp_path):
        sl = ChebyshevSlider(additive_3d, 3, [[-1, 1]] * 3, [5] * 3,
                             [[0], [1], [2]], [0.0] * 3, device="cpu")
        with pytest.raises(RuntimeError, match="unbuilt"):
            sl.save(tmp_path / "x.pkl")
        path = tmp_path / "x.npz"
        slider_3d[1].save(path, format="npz")
        loaded = ChebyshevSlider.load(path, device="cpu")
        point = [0.3, 0.2, 0.1]
        assert (loaded.eval(point, [0, 0, 0])
                == slider_3d[1].eval(point, [0, 0, 0]))

    def test_clone(self, slider_3d):
        port = slider_3d[1]
        before = port.eval([0.3, 0.2, 0.1], [0, 0, 0])
        c = port.clone()
        c.slides[0].tensor_values.mul_(0.0)
        assert port.eval([0.3, 0.2, 0.1], [0, 0, 0]) == before

    def test_from_jax_state(self, slider_6d, pts):
        ref, _ = slider_6d
        state = {
            "domain": ref.domain, "n_nodes": ref.n_nodes,
            "partition": ref.partition, "pivot_point": ref.pivot_point,
            "pivot_value": ref.pivot_value,
            "max_derivative_order": ref.max_derivative_order,
            "slides": [{
                "tensor_values": np.asarray(s.tensor_values),
                "domain": s.domain, "n_nodes": s.n_nodes,
                "nodes": [np.asarray(a) for a in s.nodes],
                "weights": [np.asarray(a) for a in s.weights],
                "diff_matrices": [np.asarray(a) for a in s.diff_matrices],
                "max_derivative_order": s.max_derivative_order,
            } for s in ref.slides]}
        moved = slider_from_jax_state(state, device="cpu")
        assert _dev(moved.eval_batch(pts), ref.eval_batch(pts)) <= F64_TOL
        state["partition"] = [[0], [1, 2], [3], [4, 4]]
        with pytest.raises(ValueError, match="exactly once"):
            slider_from_jax_state(state, device="cpu")


class TestSurface:
    def test_getters(self, slider_6d):
        ref, port = slider_6d
        assert port.total_build_evals == ref.total_build_evals
        assert port.get_num_evaluation_points() == (
            ref.get_num_evaluation_points())
        np.testing.assert_array_equal(port.get_evaluation_points(),
                                      ref.get_evaluation_points())
        assert port.get_special_points() is None
        assert port.get_error_threshold() is None
        assert port.get_used_ns() == [7, 8, 7, 9, 7, 6]
        assert "ChebyshevSlider (6D, 4 slides, built)" in str(port)
        assert "device=cpu" in repr(port)

    @pytest.mark.parametrize("name", ["integrate", "roots", "minimize",
                                      "extrude", "slice", "sobol_indices",
                                      "plot_1d"])
    def test_unported_methods_name_the_roadmap(self, slider_3d, name):
        ref, port = slider_3d
        # every name is ported now (minimize bare: the global form)
        _bare_call_as_reference(ref, port, name)
        _bare_call_as_reference(ref, port, "fit")
        want, got = ref.critical_points(), port.critical_points()
        assert [c.kind for c in got] == [c.kind for c in want]
        np.testing.assert_allclose(_flat([c.point for c in got]),
                                   _flat([c.point for c in want]),
                                   rtol=0, atol=1e-10)


class TestBatchValidation:
    def test_eval_batch_rejects_wrong_length_specs(self, slider_3d):
        port = slider_3d[1]
        with pytest.raises(ValueError, match="does not match"):
            port.eval_batch(np.zeros((2, 3)), [1, 0])
        with pytest.raises(ValueError, match=r"shape \(N, 3\)"):
            port.eval_batch(np.zeros((2, 4)))

    def test_eval_batch_accepts_derivative_id(self, slider_3d):
        port = slider_3d[1]
        d_id = port.get_derivative_id([1, 0, 0])
        pts = np.random.default_rng(0).uniform(-0.9, 0.9, (10, 3))
        np.testing.assert_array_equal(
            port.eval_batch(pts, derivative_id=d_id),
            port.eval_batch(pts, [1, 0, 0]))


class TestSliderToTT:
    def test_cores_equal_the_reference(self, slider_6d, pts):
        ref, port = slider_6d
        tt, want = port.to_tt(), ref.to_tt()
        assert isinstance(tt, ChebyshevTT)
        assert tt.tt_ranks == want.tt_ranks
        assert tt.dim_order == want.dim_order
        for a, b in zip(tt._coeff_cores, want._coeff_cores):
            assert a.shape == np.shape(b)
            assert np.abs(a - np.asarray(b)).max() <= 1e-14
        got = tt.eval_batch(pts).numpy()
        assert np.abs(got - port.eval_batch(pts)).max() < 1e-12
        # inter-group bonds are the 2-channel accumulator
        assert tt.tt_ranks[1] == 2

    def test_noncontiguous_partition_dim_order(self):
        def f(x, _):
            return math.sin(x[0]) * math.cos(x[2]) + x[1] * x[3] ** 2

        ref, port = _pair(f, 4, [7] * 4, [[0, 2], [1, 3]], [0.0] * 4)
        tt = port.to_tt()
        assert tt.dim_order == ref.to_tt().dim_order == [0, 2, 1, 3]
        p = np.random.default_rng(13).uniform(-0.9, 0.9, (64, 4))
        assert np.abs(tt.eval_batch(p).numpy()
                      - port.eval_batch(p)).max() < 1e-12

    def test_pivot_value_round_trip(self, slider_3d):
        port = slider_3d[1]
        z = port.pivot_point
        assert port.to_tt().eval(z) == pytest.approx(
            port.eval(z, [0, 0, 0]), abs=1e-13)

    def test_single_group_and_metadata(self):
        def f(x, _):
            return math.sin(x[0]) + x[1] ** 2

        s = ChebyshevSlider(f, 2, [[-1, 1]] * 2, [7] * 2,
                            partition=[[0, 1]], pivot_point=[0.0, 0.0],
                            device="cpu")
        s.build(verbose=False)
        s.set_descriptor("one-group")
        tt = s.to_tt()
        assert tt.get_descriptor() == "one-group"
        assert tt.is_construction_finished()
        assert tt.device == s.device
        assert tt.eval([0.4, -0.3]) == pytest.approx(
            s.eval([0.4, -0.3], [0, 0]), abs=1e-12)

    def test_unbuilt_raises(self):
        s = ChebyshevSlider(additive_3d, 3, [[-1, 1]] * 3, [9] * 3,
                            partition=[[0], [1], [2]],
                            pivot_point=[0.0] * 3, device="cpu")
        with pytest.raises(RuntimeError, match="build"):
            s.to_tt()


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

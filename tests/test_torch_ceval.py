"""The port's C single-point host path (``utils.ceval`` over the
repository's ``cpp/hosteval.c``) against the JAX package's.

Both packages compile the same C source with the same flags, so with the
C path on the values are held BITWISE equal; with it off
(``PYCHEBYSHEV_TPU_NO_CEVAL`` semantics, here by dropping the pack) the
NumPy paths agree to 1e-15 relative.  The C path against the NumPy path
inside the port: values <= 1e-13 relative, derivatives <= 1e-10.
"""

import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from pychebyshev_tpu import ChebyshevApproximation as JaxApprox
from pychebyshev_tpu import ChebyshevTT as JaxTT
from pychebyshev_tpu.utils import ceval as jax_ceval
from pychebyshev_tpu_torch import ChebyshevApproximation, ChebyshevTT
from pychebyshev_tpu_torch.ops import _build
from pychebyshev_tpu_torch.utils import ceval

REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).parent / "fixtures"

requires_clib = pytest.mark.skipif(
    not ceval.available() or jax_ceval._get_lib() is None,
    reason="no host C compiler: the C hosteval library is unavailable")

SPECS5 = [[0] * 5, [1, 0, 0, 0, 0], [0, 0, 1, 0, 0], [0, 0, 0, 0, 2],
          [1, 1, 0, 0, 0], [0, 2, 0, 1, 0]]


def _f(p, data=None):
    p = np.asarray(p, dtype=np.float64)
    if p.ndim == 1:
        p = p[None, :]
    return np.exp(-0.1 * p[:, 0]) * np.sin(p).sum(axis=1) + np.cos(
        p.prod(axis=1))


def _without_pack(model):
    """Context: the dense model's NumPy path, whatever the library."""
    class _Ctx:
        def __enter__(self):
            self.h = model._host_arrays()
            self.saved = self.h.get("cpack", "absent")
            self.h["cpack"] = None

        def __exit__(self, *exc):
            if self.saved == "absent":
                self.h.pop("cpack", None)
            else:
                self.h["cpack"] = self.saved
    return _Ctx()


@pytest.fixture(scope="module")
def pair5():
    ref = JaxApprox(_f, 5, [[0.0, 1.0]] * 5, [7] * 5,
                    max_derivative_order=3, vectorized=True)
    ref.build(verbose=False)
    port = ChebyshevApproximation(_f, 5, [[0.0, 1.0]] * 5, [7] * 5,
                                  max_derivative_order=3, vectorized=True,
                                  device="cpu")
    port.build(verbose=False)
    return ref, port


@pytest.fixture(scope="module")
def ragged3():
    dom = [[-1.0, 2.0], [0.5, 3.0], [0.0, 1.0]]
    ref = JaxApprox(_f, 3, dom, [7, 12, 5], vectorized=True)
    ref.build(verbose=False)
    port = ChebyshevApproximation(_f, 3, dom, [7, 12, 5], vectorized=True,
                                  device="cpu")
    port.build(verbose=False)
    return ref, port


@pytest.fixture(scope="module")
def tt_pair():
    dom = [[0.0, 1.0], [-1.0, 1.0], [0.5, 2.0], [0.0, 1.0]]
    ref = JaxTT(_f, 4, dom, [7, 6, 8, 5], max_rank=5, vectorized=True)
    ref.build(verbose=False, seed=3)
    port = ChebyshevTT(_f, 4, dom, [7, 6, 8, 5], max_rank=5,
                       vectorized=True, device="cpu")
    port.build(verbose=False, seed=3)
    return ref, port


def _points(domain, n, seed):
    rng = np.random.default_rng(seed)
    dom = np.asarray(domain, dtype=np.float64)
    return dom[:, 0] + (dom[:, 1] - dom[:, 0]) * rng.uniform(
        size=(n, len(dom)))


@requires_clib
class TestDenseBitwise:
    def test_library_is_built_under_the_package(self):
        assert ceval.available()
        libs = list((REPO / "pychebyshev_tpu_torch" / "_build").glob(
            "libpchosteval-*.so"))
        assert libs, "the C library was not built into _build/"
        assert ceval.MAX_SPECS == 64 and ceval.MAX_ORDER == 16

    @pytest.mark.parametrize("orders", SPECS5)
    def test_single_point_bitwise(self, pair5, orders):
        ref, port = pair5
        for p in _points(ref.domain, 40, 1):
            assert port.vectorized_eval(p, orders) == \
                ref.vectorized_eval(p, orders)

    def test_ragged_grid_bitwise(self, ragged3):
        ref, port = ragged3
        for p in _points(ref.domain, 40, 2):
            for orders in ([0, 0, 0], [1, 0, 0], [0, 2, 0], [1, 0, 1]):
                assert port.eval(p, orders) == ref.eval(p, orders)

    def test_exact_node_and_knife_edge_bitwise(self, pair5):
        ref, port = pair5
        nodes = port._nodes_np()
        on_node = [float(nodes[d][2 + d % 3]) for d in range(5)]
        near = list(on_node)
        near[0] += 3e-15           # inside the 1e-14 coincidence window
        off = list(on_node)
        off[1] += 5e-14            # just outside it
        for p in (on_node, near, off):
            assert port.eval(p, [0] * 5) == ref.eval(p, [0] * 5)
        assert port.eval(on_node, [0] * 5) == float(
            port.tensor_values[2, 3, 4, 2, 3])

    def test_multi_bitwise(self, pair5):
        ref, port = pair5
        for p in _points(ref.domain, 20, 3):
            assert port.vectorized_eval_multi(p, SPECS5) == \
                ref.vectorized_eval_multi(p, SPECS5)

    def test_batch_host_bitwise(self, pair5):
        ref, port = pair5
        pts = _points(ref.domain, 257, 4)
        for orders in ([0] * 5, [1, 0, 0, 0, 0]):
            got = port.eval_batch_host(pts, orders)
            np.testing.assert_array_equal(got,
                                          ref.eval_batch_host(pts, orders))
            single = [port.eval(p, orders) for p in pts[:8]]
            np.testing.assert_array_equal(got[:8], single)

    @pytest.mark.parametrize("name", ["approx_2d_simple", "approx_5d_bs"])
    def test_fixture_bitwise(self, name):
        ref = JaxApprox.load(FIXTURES / f"{name}.pcb")
        port = ChebyshevApproximation.load(FIXTURES / f"{name}.pcb",
                                           device="cpu")
        rows = np.loadtxt(FIXTURES / f"{name}.expected", ndmin=2)
        d = ref.num_dimensions
        first = [1] + [0] * (d - 1)
        for row in rows:
            p = row[:d]
            assert port.eval(p, [0] * d) == ref.eval(p, [0] * d)
            assert port.eval(p, first) == ref.eval(p, first)
        got = port.eval_batch_host(rows[:, :d], [0] * d)
        np.testing.assert_array_equal(
            got, ref.eval_batch_host(rows[:, :d], [0] * d))
        assert np.abs(got - rows[:, -1]).max() <= 1e-12 * np.abs(
            rows[:, -1]).max()


class TestDenseNumpyPath:
    """With the C path off: the two NumPy paths to 1e-15 relative."""

    @pytest.mark.parametrize("name", ["approx_2d_simple", "approx_5d_bs"])
    def test_fixture_numpy_path(self, name):
        ref = JaxApprox.load(FIXTURES / f"{name}.pcb")
        port = ChebyshevApproximation.load(FIXTURES / f"{name}.pcb",
                                           device="cpu")
        rows = np.loadtxt(FIXTURES / f"{name}.expected", ndmin=2)
        d = ref.num_dimensions
        h = ref._host_arrays()
        h["cpack"] = None
        with _without_pack(port):
            for row in rows:
                a = port.eval(row[:d], [0] * d)
                b = ref.eval(row[:d], [0] * d)
                assert abs(a - b) <= 1e-15 * max(1.0, abs(b))
        h.pop("cpack")

    def test_c_path_against_numpy_path(self, pair5):
        """Values <= 1e-13; derivative specs <= 1e-10 (the D^k folds
        amplify the two paths' summation orders, as the reference's own
        C-path test allows)."""
        _, port = pair5
        pts = _points(port.domain, 30, 5)
        zero = [0] * 5
        c_vals = np.array([[port.eval(p, o) for o in SPECS5] for p in pts])
        c_multi = np.array([port.vectorized_eval_multi(p, SPECS5)
                            for p in pts])
        c_batch = port.eval_batch_host(pts, zero)
        c_batch_d = port.eval_batch_host(pts, [0, 1, 0, 0, 0])
        with _without_pack(port):
            np_vals = np.array([[port.eval(p, o) for o in SPECS5]
                                for p in pts])
            np_multi = np.array([port.vectorized_eval_multi(p, SPECS5)
                                 for p in pts])
            np_batch = port.eval_batch_host(pts, zero)
            np_batch_d = port.eval_batch_host(pts, [0, 1, 0, 0, 0])
        scale = np.abs(np_vals[:, 0]).max()
        assert np.abs(c_vals[:, 0] - np_vals[:, 0]).max() <= 1e-13 * scale
        assert np.abs(c_multi[:, 0] - np_multi[:, 0]).max() <= 1e-13 * scale
        assert np.abs(c_batch - np_batch).max() <= 1e-13 * scale
        np.testing.assert_allclose(c_vals, np_vals, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(c_multi, np_multi, rtol=1e-10,
                                   atol=1e-10)
        np.testing.assert_allclose(c_batch_d, np_batch_d, rtol=1e-10,
                                   atol=1e-10)

    def test_multi_numpy_path_matches_reference(self, pair5):
        ref, port = pair5
        h = ref._host_arrays()
        h["cpack"] = None
        with _without_pack(port):
            for p in _points(ref.domain, 10, 6):
                a = port.vectorized_eval_multi(p, SPECS5)
                b = ref.vectorized_eval_multi(p, SPECS5)
                assert np.abs(np.array(a) - b).max() <= 1e-15 * max(
                    1.0, np.abs(b).max())
        h.pop("cpack")

    def test_multi_declines_ragged_specs_to_numpy(self, pair5):
        """The C multi kernel declines a spec list that is not a small
        rectangular int matrix; the NumPy path then decides."""
        _, port = pair5
        pack = port._host_cpack(port._host_arrays())
        if pack is not None:
            pt = np.ascontiguousarray(_points(port.domain, 1, 7)[0])
            assert ceval.eval_multi(pack, pt, [[0] * 5, [1, 0]]) is None
            assert ceval.eval_multi(pack, pt, [[17, 0, 0, 0, 0]]) is None
            assert ceval.eval_multi(pack, pt, [[0] * 5] * 65) is None
        p = _points(port.domain, 1, 7)[0]
        many = [[0] * 5] * 65
        np.testing.assert_allclose(port.vectorized_eval_multi(p, many),
                                   [port.eval(p, [0] * 5)] * 65,
                                   rtol=1e-14)

    def test_odd_point_shapes(self, pair5):
        _, port = pair5
        p = _points(port.domain, 1, 8)[0]
        want = port.eval(p, [0] * 5)
        assert port.eval(list(p), [0] * 5) == want
        assert port.eval(p[:, None], [0] * 5) == want

    def test_host_batch_shapes_and_errors(self, pair5):
        _, port = pair5
        assert port.eval_batch_host(np.zeros((0, 5)), [0] * 5).shape == (0,)
        with pytest.raises(ValueError, match=r"shape \(N, 5\)"):
            port.eval_batch_host(np.zeros((3, 4)), [0] * 5)
        fresh = ChebyshevApproximation(_f, 2, [[0, 1]] * 2, [5, 5],
                                       device="cpu")
        with pytest.raises(RuntimeError, match="build"):
            fresh.eval_batch_host(np.zeros((1, 2)), [0, 0])
        pts = _points(port.domain, 9, 9)
        np.testing.assert_array_equal(
            port.eval_batch_host(torch.tensor(pts), [0] * 5),
            port.eval_batch_host(pts, [0] * 5))


class TestLifecycle:
    def test_in_place_edit_rebuilds_the_pack(self, ragged3):
        """The pack lives in the host cache, keyed on the tensor's
        identity and version: an in-place edit of ``tensor_values`` must
        reach the C path."""
        _, base = ragged3
        port = pickle.loads(pickle.dumps(base))
        p = _points(port.domain, 1, 10)[0]
        before = port.eval(p, [0, 0, 0])
        pack = port._host_arrays().get("cpack")
        port.tensor_values.mul_(2.0)
        after = port.eval(p, [0, 0, 0])
        assert after == pytest.approx(2.0 * before, rel=1e-14)
        if ceval.available():
            assert port._host_arrays()["cpack"] is not pack
        # a rebind as well
        port.tensor_values = port.tensor_values / 2.0
        assert port.eval(p, [0, 0, 0]) == pytest.approx(before, rel=1e-14)
        np.testing.assert_allclose(
            port.eval_batch_host(p[None, :], [0, 0, 0]), [before],
            rtol=1e-14)

    def test_pickle_carries_no_ctypes_state(self, pair5):
        _, port = pair5
        p = _points(port.domain, 1, 11)[0]
        want = port.eval(p, [0] * 5)
        clone = pickle.loads(pickle.dumps(port))
        assert "_host_cache" not in clone.__dict__
        assert clone.eval(p, [0] * 5) == want

    @requires_clib
    def test_two_threads_inside_the_c_call(self, pair5):
        """The C calls release the GIL; scratch is per thread."""
        _, port = pair5
        pts = _points(port.domain, 200, 12)
        want = [port.eval(p, [1, 0, 0, 0, 0]) for p in pts]
        want_multi = [port.vectorized_eval_multi(p, SPECS5) for p in pts]
        errors = []

        def work():
            try:
                for _ in range(3):
                    got = [port.eval(p, [1, 0, 0, 0, 0]) for p in pts]
                    assert got == want
                    gm = [port.vectorized_eval_multi(p, SPECS5)
                          for p in pts]
                    assert gm == want_multi
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors

    def test_env_switch_disables_the_c_path(self):
        code = (
            "import numpy as np\n"
            "from pychebyshev_tpu_torch.utils import ceval\n"
            "from pychebyshev_tpu_torch import ChebyshevApproximation\n"
            "assert not ceval.available()\n"
            "c = ChebyshevApproximation(lambda p, _: np.sin(p).sum(axis=1),"
            " 2, [[0, 1]] * 2, [5, 6], vectorized=True, device='cpu')\n"
            "c.build(verbose=False)\n"
            "print(repr(c.eval([0.3, 0.4], [0, 0])))\n")
        env = dict(os.environ, PYCHEBYSHEV_TPU_NO_CEVAL="1")
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, proc.stderr
        c = ChebyshevApproximation(lambda p, _: np.sin(p).sum(axis=1), 2,
                                   [[0, 1]] * 2, [5, 6], vectorized=True,
                                   device="cpu")
        c.build(verbose=False)
        assert float(proc.stdout) == pytest.approx(
            c.eval([0.3, 0.4], [0, 0]), rel=1e-15)

    def test_no_compiler_degrades_to_none(self, monkeypatch, tmp_path):
        monkeypatch.setattr(_build, "_HOST_COMPILERS", ("no-such-cc",))
        monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
        src = REPO / "cpp" / "hosteval.c"
        assert _build.load_host_library(src, "pchosteval") is None
        assert _build.load_host_library(tmp_path / "absent.c", "x") is None

    @requires_clib
    def test_build_is_atomic_and_hash_named(self, monkeypatch, tmp_path):
        monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
        lib = _build.load_host_library(REPO / "cpp" / "hosteval.c",
                                       "pchosteval")
        assert lib is not None
        names = [p.name for p in tmp_path.iterdir()]
        assert len(names) == 1 and names[0].startswith("libpchosteval-")
        assert names[0].endswith(".so")      # no temporary file left


@requires_clib
class TestTTKernel:
    def test_values_bitwise_against_reference(self, tt_pair):
        ref, port = tt_pair
        for p in _points(ref.domain, 60, 13):
            assert port.eval(p) == ref.eval(p)

    def test_values_match_numpy_chain(self, tt_pair):
        _, port = tt_pair
        pts = _points(port.domain, 60, 14)
        c_vals = [port.eval(p) for p in pts]
        port.__dict__["_host_cpack_cache"] = (tuple(port._coeff_cores),
                                              None)
        np_vals = [port.eval(p) for p in pts]
        port.__dict__.pop("_host_cpack_cache")
        assert np.abs(np.array(c_vals) - np_vals).max() <= \
            1e-14 * np.abs(np_vals).max()

    def test_fd_derivatives_ride_the_kernel(self, tt_pair):
        ref, port = tt_pair
        specs = [[0, 0, 0, 0], [1, 0, 0, 0], [0, 2, 0, 0], [1, 0, 1, 0]]
        for p in _points(ref.domain, 10, 15):
            assert port.eval_multi(p, specs) == ref.eval_multi(p, specs)

    def test_reordered_frame_and_algebra_invalidate_the_pack(self, tt_pair):
        ref, port = tt_pair
        p = _points(ref.domain, 1, 16)[0]
        r_ref, r_port = ref.reorder([2, 0, 3, 1]), port.reorder([2, 0, 3, 1])
        assert r_port.eval(p) == r_ref.eval(p)
        doubled = port * 2.0
        assert doubled.eval(p) == pytest.approx(2.0 * port.eval(p),
                                                rel=1e-14)
        tt = pickle.loads(pickle.dumps(port))
        v0 = tt.eval(p)
        pack0 = tt._host_cpack()
        tt.orth_left(2)             # replaces core ndarrays
        assert tt._host_cpack() is not pack0
        assert tt.eval(p) == pytest.approx(v0, rel=1e-12)

    def test_pack_rejects_a_broken_bond_chain(self):
        cores = [np.ones((1, 4, 3)), np.ones((2, 4, 1))]
        assert ceval.make_tt_pack(cores, [[0, 1], [0, 1]]) is None

    def test_two_threads_inside_the_tt_kernel(self, tt_pair):
        _, port = tt_pair
        pts = _points(port.domain, 300, 17)
        want = [port.eval(p) for p in pts]
        errors = []

        def work():
            try:
                for _ in range(3):
                    assert [port.eval(p) for p in pts] == want
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors

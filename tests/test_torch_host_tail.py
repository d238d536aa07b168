"""The port's host tail against the JAX package's, on the CPU:
``hadamard``/``compose``, the Sobol family, the pickle-free ``.npz``
format, books (``build_book``, ``save_book``/``load_book``) and the
plots.

Same seeded interpolants and points go to both packages; results are
held to 1e-12 of the reference's (scale-normalized), files cross between
the packages with bitwise evaluations, and a book's tensors are bitwise
the reference's.  Each family is built once per package, through
module-scoped fixtures.
"""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402

import pychebyshev_tpu as jx  # noqa: E402
from pychebyshev_tpu import serving as jax_serving  # noqa: E402
from pychebyshev_tpu_torch import (  # noqa: E402
    ChebyshevApproximation,
    ChebyshevSlider,
    ChebyshevSpline,
    ChebyshevTT,
    MultiModelEvaluator,
    serving,
)

TOL = 1e-12
DOM3 = [[-1.0, 1.0], [0.0, 2.0], [-1.0, 1.0]]
NS3 = [7, 6, 5]
DOM_SP = [[0.0, 2.0], [0.0, 1.0]]
KNOTS = [[1.0], []]
DOM4 = [[-1.0, 1.0]] * 4
PARTITION = [[0], [1, 2], [3]]
PIVOT = [0.1, 0.2, -0.1, 0.0]
FAMILIES = ["dense", "spline", "slider", "tt"]


def _dev(a, ref):
    a = np.asarray(a, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert a.shape == ref.shape
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-300)


def smooth3(p, _=None):
    return np.sin(p[0]) * np.exp(0.3 * p[1]) + p[2] ** 2 + 0.2 * p[0] * p[2]


def other3(p, _=None):
    return np.cos(0.5 * p[0]) + 0.1 * p[1] * p[2]


def payoff2(p, _=None):
    return max(p[0] - 1.0, 0.0) * np.exp(-0.5 * p[1]) + 0.1 * p[1]


def payoff2b(p, _=None):
    return abs(p[0] - 1.0) + p[1] ** 2


def grouped4(p, _=None):
    return np.sin(p[0]) + p[1] * p[2] + np.exp(0.3 * p[3]) + np.cos(p[1])


def tt4(p, _=None):
    return np.exp(-p[0] * p[1]) + np.sin(p[2] + 0.5 * p[3]) + 0.3 * p[0]


def tt4b(p, _=None):
    return np.cos(p[0] + p[3]) + 0.2 * p[1] * p[2]


def _build(family, pkg, f=None):
    kw = {} if pkg is jx else {"device": "cpu"}
    if family == "dense":
        obj = pkg.ChebyshevApproximation(f or smooth3, 3, DOM3, NS3, **kw)
    elif family == "spline":
        obj = pkg.ChebyshevSpline(f or payoff2, 2, DOM_SP, [6, 5], KNOTS,
                                  **kw)
    elif family == "slider":
        obj = pkg.ChebyshevSlider(grouped4, 4, DOM4, [6, 5, 5, 7],
                                  PARTITION, PIVOT, **kw)
    else:
        obj = pkg.ChebyshevTT(f or tt4, 4, DOM4, [6, 5, 6, 5], max_rank=4,
                              tolerance=1e-10, **kw)
        obj.build(verbose=False, seed=3)
        return obj
    obj.build(verbose=False)
    return obj


@pytest.fixture(scope="module")
def models():
    """family -> (reference, port)."""
    return {fam: (_build(fam, jx), _build(fam, _port_pkg()))
            for fam in FAMILIES}


def _port_pkg():
    import pychebyshev_tpu_torch
    return pychebyshev_tpu_torch


def _points(family, n=64, seed=0):
    rng = np.random.default_rng(seed)
    dom = {"dense": DOM3, "spline": DOM_SP, "slider": DOM4,
           "tt": DOM4}[family]
    return np.column_stack([rng.uniform(lo, hi, n) for lo, hi in dom])


def _values(obj, pts):
    return np.asarray(obj.vectorized_eval_batch(pts, [0] * pts.shape[1]),
                      dtype=np.float64)


# ----------------------------------------------------------------------
# hadamard and compose
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def second_models():
    """A second operand per family that has ``hadamard``."""
    return {
        "dense": (_build("dense", jx, other3),
                  _build("dense", _port_pkg(), other3)),
        "spline": (_build("spline", jx, payoff2b),
                   _build("spline", _port_pkg(), payoff2b)),
        "tt": (_build("tt", jx, tt4b), _build("tt", _port_pkg(), tt4b)),
    }


@pytest.mark.parametrize("family", ["dense", "spline", "tt"])
def test_hadamard_against_the_reference(models, second_models, family):
    ref, port = models[family]
    ref2, port2 = second_models[family]
    pts = _points(family)
    want = ref.hadamard(ref2)
    got = port.hadamard(port2)
    assert type(got) is type(port)
    assert _dev(_values(got, pts), _values(want, pts)) <= TOL
    with pytest.raises(TypeError) as exc_want:
        ref.hadamard(3.0)
    with pytest.raises(TypeError) as exc_got:
        port.hadamard(3.0)
    assert str(exc_got.value) == str(exc_want.value)


@pytest.mark.parametrize("family", ["dense", "spline", "tt"])
def test_compose_against_the_reference(models, family):
    ref, port = models[family]
    pts = _points(family)
    if family == "tt":
        want = ref.compose(np.exp, degree=12)
        got = port.compose(np.exp, degree=12)
    else:
        want = ref.compose(lambda v: v * v + 1.0)
        got = port.compose(lambda v: v * v + 1.0)
        # a g that returns NumPy works as well as one on tensors
        also = port.compose(lambda v: np.asarray(v) * np.asarray(v) + 1.0)
        assert _dev(_values(also, pts), _values(want, pts)) <= TOL
    assert type(got) is type(port)
    assert _dev(_values(got, pts), _values(want, pts)) <= TOL


def test_compose_and_hadamard_keep_the_operands(models, second_models):
    ref, port = models["dense"]
    before = port.tensor_values.clone()
    prod = port.hadamard(second_models["dense"][1])
    prod.tensor_values.mul_(0.0)
    assert torch.equal(port.tensor_values, before)
    with pytest.raises(ValueError, match="elementwise"):
        port.compose(lambda v: v.sum())
    ref_other = jx.ChebyshevApproximation(smooth3, 3, DOM3, [5, 5, 5])
    ref_other.build(verbose=False)
    with pytest.raises(ValueError) as want:
        ref.hadamard(ref_other)
    other = ChebyshevApproximation(smooth3, 3, DOM3, [5, 5, 5],
                                   device="cpu")
    other.build(verbose=False)
    with pytest.raises(ValueError) as got:
        port.hadamard(other)
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------------------
# Sensitivity
# ----------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_sobol_indices_against_the_reference(models, family):
    ref, port = models[family]
    want = ref.sobol_indices()
    got = port.sobol_indices()
    assert set(got) == set(want)
    assert abs(got["variance"] - want["variance"]) <= TOL * want["variance"]
    for key in ("first_order", "total_order"):
        assert list(got[key]) == list(want[key])
        np.testing.assert_allclose(list(got[key].values()),
                                   list(want[key].values()), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_interaction_matrix_against_the_reference(models, family):
    ref, port = models[family]
    want = np.asarray(ref.interaction_matrix())
    got = port.interaction_matrix()
    assert isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("threshold", [1e-8, 1e-2])
def test_suggest_partition_against_the_reference(models, family,
                                                 threshold):
    ref, port = models[family]
    assert (port.suggest_partition(threshold)
            == ref.suggest_partition(threshold))


def test_coefficient_tensor_runs_in_torch():
    from pychebyshev_tpu.utils import sensitivity as jax_sens
    from pychebyshev_tpu_torch.utils import sensitivity
    vals = np.random.default_rng(1).standard_normal((5, 4, 6))
    got = sensitivity.chebyshev_coefficient_tensor(torch.tensor(vals))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    want = np.asarray(jax_sens.chebyshev_coefficient_tensor(vals))
    assert _dev(got.numpy(), want) <= TOL
    with pytest.raises(ValueError, match="NaN or Inf"):
        sensitivity.sobol_from_coeffs(np.full((3, 3), np.nan), 2)


# ----------------------------------------------------------------------
# .npz files, both ways
# ----------------------------------------------------------------------

def _npz_arrays(path):
    with np.load(path, allow_pickle=False) as data:
        return {k: np.asarray(data[k]) for k in data.files}


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_npz_files_cross_between_the_packages(models, family, direction,
                                              tmp_path):
    """A file one package writes loads in the other, which writes it
    back array for array; the round trip evaluates bitwise as the
    original, and the other package within 1e-12 of it."""
    ref, port = models[family]
    first, second = tmp_path / "first.npz", tmp_path / "second.npz"
    pts = _points(family, seed=5)
    if direction == "port_to_jax":
        port.save(first, format="npz")
        other = type(ref).load(first)
        other.save(second, format="npz")
        back = type(port).load(second, device="cpu")
        assert back.device == torch.device("cpu")
        original = port
    else:
        ref.save(first, format="npz")
        other = type(port).load(first, device="cpu")
        other.save(second, format="npz")
        back = type(ref).load(second)
        original = ref
    a, b = _npz_arrays(first), _npz_arrays(second)
    assert sorted(a) == sorted(b)
    for key in a:
        assert np.array_equal(a[key], b[key]), key
    assert np.array_equal(_values(back, pts), _values(original, pts))
    assert _dev(_values(other, pts), _values(original, pts)) <= TOL


def test_npz_refusals_are_the_reference_s(models, tmp_path):
    _, port = models["dense"]
    path = tmp_path / "dense.npz"
    port.save(path, format="npz")
    with pytest.raises(TypeError, match="Expected a ChebyshevTT checkpoint"):
        ChebyshevTT.load(path, device="cpu")
    with pytest.raises(ValueError, match="'pickle', 'binary', or 'npz'"):
        port.save(path, format="hdf5")
    nested = ChebyshevSpline(payoff2, 2, DOM_SP, [[5, 6], [5]], KNOTS,
                             device="cpu")
    nested.build(verbose=False)
    with pytest.raises(NotImplementedError, match="flat n_nodes"):
        nested.save(tmp_path / "nested.npz", format="npz")


# ----------------------------------------------------------------------
# Books
# ----------------------------------------------------------------------

def _book_fn(points, _):
    p = np.asarray(points)
    return np.column_stack([np.sin(p[:, 0] * (m + 1)) * np.exp(0.2 * p[:, 1])
                            + m * p[:, 2] ** 2 for m in range(4)])


@pytest.fixture(scope="module")
def books():
    ref = jax_serving.build_book(_book_fn, 3, DOM3, NS3, num_models=4)
    port = serving.build_book(_book_fn, 3, DOM3, NS3, num_models=4,
                              device="cpu")
    return ref, port


def test_build_book_is_bitwise_the_reference(books):
    ref, port = books
    assert len(port) == len(ref) == 4
    for m_ref, m_port in zip(ref, port):
        assert np.array_equal(m_port.tensor_values.numpy(),
                              np.asarray(m_ref.tensor_values))
        assert m_port.n_evaluations == m_ref.n_evaluations == 210
    # the models share one set of grid tensors, not copies
    for key in ("nodes", "weights", "diff_matrices"):
        for a, b in zip(getattr(port[0], key), getattr(port[3], key)):
            assert a is b
    # and each owns its value tensor
    assert port[0].tensor_values.data_ptr() != port[1].tensor_values.data_ptr()
    pts = _points("dense")
    engine = MultiModelEvaluator(port, dtype=torch.float64, device="cpu")
    want = jax_serving.MultiModelEvaluator(ref, dtype=jnp.float64)(pts)
    assert _dev(engine(pts).numpy(), np.asarray(want)) <= TOL


def test_build_book_takes_a_torch_result():
    def fn(points, _):
        return torch.as_tensor(_book_fn(points, None))
    book = serving.build_book(fn, 3, DOM3, NS3, device="cpu")
    ref = jax_serving.build_book(_book_fn, 3, DOM3, NS3)
    for m_ref, m_port in zip(ref, book):
        assert np.array_equal(m_port.tensor_values.numpy(),
                              np.asarray(m_ref.tensor_values))


def test_build_book_errors_are_the_reference_s():
    def nan_fn(points, _):
        out = _book_fn(points, None)
        out[3, 1] = np.nan
        return out
    cases = [
        ((_book_fn, 3, DOM3, [7, None, 5]), {}),
        ((_book_fn, 3, DOM3, NS3), {"num_models": 0}),
        ((_book_fn, 3, DOM3, NS3), {"num_models": 3}),
        ((lambda p, _: np.zeros(len(p)), 3, DOM3, NS3), {}),
        ((nan_fn, 3, DOM3, NS3), {}),
    ]
    for args, kw in cases:
        with pytest.raises(ValueError) as want:
            jax_serving.build_book(*args, **kw)
        with pytest.raises(ValueError) as got:
            serving.build_book(*args, **kw, device="cpu")
        assert str(got.value) == str(want.value)
    from pychebyshev_tpu_torch.parallel.sharding import make_mesh
    from pychebyshev_tpu_torch.parallel.world import local_world
    with local_world():
        # A NumPy oracle under a mesh: the reference's refusal.
        with pytest.raises(ValueError,
                           match=r"build_book\(mesh=\.\.\.\) requires a "
                                 r"vectorized book function.*drop mesh= "
                                 r"for host/NumPy oracles"):
            serving.build_book(_book_fn, 3, DOM3, NS3,
                               mesh=make_mesh(device_type="cpu"),
                               device="cpu")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_book_files_cross_between_the_packages(books, writer, tmp_path):
    """A book file one package writes loads in the other with the same
    tensors; loaded back where it was written, it evaluates bitwise as
    the book it came from."""
    ref, port = books
    path = tmp_path / "book.npz"
    pts = _points("dense", seed=7)
    if writer == "port":
        serving.save_book(path, port)
        other = jax_serving.load_book(path)
        back = serving.load_book(path, device="cpu")
        original = port
    else:
        jax_serving.save_book(path, ref)
        other = serving.load_book(path, device="cpu")
        back = jax_serving.load_book(path)
        original = ref
    for a, b in zip(other, original):
        assert np.array_equal(np.asarray(host(a.tensor_values)),
                              np.asarray(host(b.tensor_values)))
    for a, b in zip(back, original):
        assert np.array_equal(_values(a, pts), _values(b, pts))
    port_side = back if writer == "port" else other
    for a, b in zip(port_side[0].nodes, port_side[2].nodes):
        assert a is b
    port[0].save(tmp_path / "one.npz", format="npz")
    with pytest.raises(ValueError, match="not a book checkpoint"):
        serving.load_book(tmp_path / "one.npz", device="cpu")


def host(values):
    return values.numpy() if isinstance(values, torch.Tensor) else values


# ----------------------------------------------------------------------
# Plots
# ----------------------------------------------------------------------

def _line_data(ax):
    return np.asarray(ax.lines[0].get_xydata())


def _surface_data(ax):
    return np.asarray(ax.collections[0].get_array(), dtype=np.float64)


@pytest.mark.parametrize("family", FAMILIES)
def test_plots_draw_the_reference_s_data(models, family):
    ref, port = models[family]
    d = port.num_dimensions
    fixed1 = {k: 0.3 for k in range(1, d)}
    fixed2 = {k: 0.3 for k in range(2, d)}
    try:
        want = _line_data(ref.plot_1d(n_points=40, fixed=fixed1))
        got = _line_data(port.plot_1d(n_points=40, fixed=fixed1))
        assert _dev(got, want) <= TOL
        want = _surface_data(ref.plot_2d_contour(n_points=12,
                                                 fixed=fixed2))
        got = _surface_data(port.plot_2d_contour(n_points=12,
                                                 fixed=fixed2))
        assert _dev(got, want) <= TOL
        ax = port.plot_2d_surface(n_points=8, fixed=fixed2)
        zs = np.asarray(ax.collections[0].get_array(), dtype=np.float64)
        assert zs.size and np.isfinite(zs).all()
        with pytest.raises(ValueError, match="free dimension"):
            port.plot_1d()
    finally:
        plt.close("all")


def test_plot_convergence_against_the_reference():
    def f(x, _):
        return np.exp(x[0]) * np.cos(x[1])
    ref = jx.ChebyshevApproximation(f, 2, [[-1, 1], [-1, 1]], [5, 5])
    port = ChebyshevApproximation(f, 2, [[-1, 1], [-1, 1]], [5, 5],
                                  device="cpu")
    try:
        want = _line_data(ref.plot_convergence(max_n=10, target_error=1e-6))
        got = _line_data(port.plot_convergence(max_n=10, target_error=1e-6))
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-15)
    finally:
        plt.close("all")
    fitted = ChebyshevApproximation.from_values(np.zeros((3, 3)), 2,
                                                [[-1, 1], [-1, 1]], [3, 3],
                                                device="cpu")
    with pytest.raises(RuntimeError, match="function-bound"):
        fitted.plot_convergence()

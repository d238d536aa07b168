"""The port's ``ChebyshevTT.fit`` (TT-ALS from scattered samples) and
``run_completion`` against the JAX package's, on the CPU.

Same seeded NumPy samples go to both packages (d = 4, rank <= 3).  The
host engine is the reference's NumPy loop and is held to 1e-12 of it;
a rank-2 separable target that the grid represents exactly is
recovered to rms <= 1e-6 by the host engine and to the f32 ceiling by
the device engine (IEEE f32 rows, interfaces and Grams; the port on CPU
tensors); ``run_completion`` is held to 1e-12 of the reference's,
scale-normalized.
"""

import warnings

import numpy as np
import pytest

import pychebyshev_tpu as jx
from pychebyshev_tpu.utils import fitting as jax_fitting
from pychebyshev_tpu_torch import ChebyshevTT
from pychebyshev_tpu_torch.utils import fitting

DOM = [[0.0, 1.0]] * 4
NS = [5, 5, 5, 5]
KW = dict(max_rank=3, l2=1e-8, sweeps=3, seed=1)


def _dev(a, ref):
    a = np.asarray(a, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert a.shape == ref.shape
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-300)


def _samples(n=3000, noise=1e-4, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.0, 1.0, (n, 4))
    vals = (np.prod(np.cos(2 * pts), axis=1) + 0.1 * pts.sum(1)
            + rng.normal(0.0, noise, n))
    return pts, vals


def _rank2(pts):
    """Rank 2 in TT form, degree 1 per dim: exact on 3 nodes."""
    return np.prod(1.0 + 0.5 * pts, axis=1) + np.prod(pts - 0.5, axis=1)


def _grad(pts):
    """d/dx0 of the ``_samples`` target."""
    return (-2.0 * np.sin(2 * pts[:, 0])
            * np.prod(np.cos(2 * pts[:, 1:]), axis=1) + 0.1)


CASES = {
    "plain": {},
    "weighted": {"sample_weight": np.r_[np.zeros(50),
                                       np.full(2950, 1.5)]},
    "gradient": {"derivative_data": "grad"},
}


def _case_kw(case):
    kw = dict(CASES[case])
    if kw.get("derivative_data") == "grad":
        gp = _samples(300, seed=5)[0]
        kw["derivative_data"] = [(gp, (1, 0, 0, 0), _grad(gp), 0.2)]
    return kw


@pytest.fixture(scope="module")
def host_fits():
    """case -> (reference (cores, diag), port (cores, diag))."""
    pts, vals = _samples()
    out = {}
    for case in CASES:
        kw = _case_kw(case)
        out[case] = (
            jax_fitting.fit_tt_cores(pts, vals, DOM, NS, **KW, **kw),
            fitting.fit_tt_cores(pts, vals, DOM, NS, **KW, **kw))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_host_engine_against_the_reference(host_fits, case):
    (want, want_diag), (got, diag) = host_fits[case]
    for c_got, c_want in zip(got, want):
        assert _dev(c_got, c_want) <= 1e-12
    assert diag["tt_ranks"] == want_diag["tt_ranks"]
    assert len(diag["sweep_rms"]) == len(want_diag["sweep_rms"])
    np.testing.assert_allclose(diag["sweep_rms"], want_diag["sweep_rms"],
                               rtol=1e-12)
    assert abs(diag["rms"] - want_diag["rms"]) <= 1e-12 * want_diag["rms"]
    if case == "gradient":
        assert diag["derivative_blocks"][0]["orders"] == [1, 0, 0, 0]
        assert abs(diag["objective_sse"] - want_diag["objective_sse"]) \
            <= 1e-10 * want_diag["objective_sse"]


@pytest.mark.parametrize("engine", ["host", "device"])
def test_engines_recover_a_rank2_target(engine):
    """The host engine recovers the target to rms <= 1e-6; the device
    engine to the f32 ceiling (2e-4 of the values' scale): its IEEE f32
    Gram, whose entries round at ~1e-7, floors the rms at 1e-6..1e-4
    after the host solve amplifies that by the Gram's condition."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(0.0, 1.0, (4000, 4))
    vals = _rank2(pts)
    cores, diag = fitting.fit_tt_cores(
        pts, vals, DOM, [3] * 4, max_rank=2, l2=0.0, sweeps=10, seed=2,
        engine=engine, device="cpu")
    bound = 1e-6 if engine == "host" else 2e-4 * np.abs(vals).max()
    assert diag["rms"] <= bound
    assert diag["tt_ranks"] == [1, 2, 2, 2, 1]
    assert [c.shape for c in cores] == [(1, 3, 2), (2, 3, 2), (2, 3, 2),
                                        (2, 3, 1)]


def test_device_engine_against_the_reference_at_noise_scale():
    pts, vals = _samples(noise=1e-4)
    kw = dict(KW, sample_weight=CASES["weighted"]["sample_weight"])
    _, want = jax_fitting.fit_tt_cores(pts, vals, DOM, NS, engine="device",
                                       **kw)
    _, host = fitting.fit_tt_cores(pts, vals, DOM, NS, **kw)
    _, got = fitting.fit_tt_cores(pts, vals, DOM, NS, engine="device",
                                  device="cpu", **kw)
    assert abs(got["rms"] - want["rms"]) <= 1e-5
    assert abs(got["rms"] - host["rms"]) <= 1e-5


def test_class_fit_against_the_reference():
    pts, vals = _samples()
    ref = jx.ChebyshevTT.fit(pts, vals, 4, DOM, NS, **KW,
                             additional_data="book", descriptor="fitted")
    port = ChebyshevTT.fit(pts, vals, 4, DOM, NS, **KW,
                           additional_data="book", descriptor="fitted",
                           device="cpu")
    assert port.method == "als" and port.tolerance == 1e-12
    assert port.additional_data == "book"
    assert port.get_descriptor() == "fitted"
    assert port.tt_ranks == ref.tt_ranks
    q = _samples(64, seed=9)[0]
    assert _dev(port.vectorized_eval_batch(q),
                np.asarray(ref.vectorized_eval_batch(q))) <= 1e-12
    assert port.fit_diagnostics["sweep_rms"] == pytest.approx(
        ref.fit_diagnostics["sweep_rms"], rel=1e-12)


def test_errors_and_warnings_are_the_reference_s():
    pts, vals = _samples(400)
    cases = [
        ((pts, vals, DOM, NS), {"engine": "device-dd"}),
        ((pts, vals, DOM, NS), {"engine": "host", "mesh": object()}),
        ((pts[:, :1], vals, DOM[:1], NS[:1]), {}),
        ((pts, vals, DOM, NS), {"max_rank": 0}),
        ((pts, vals, DOM, NS), {"sweeps": 0}),
        ((pts[:20], vals[:20], DOM, NS), {"l2": 0.0}),
        ((pts, vals, DOM, NS), {"sample_weight": np.zeros(len(vals))}),
    ]
    for args, kw in cases:
        with pytest.raises(ValueError) as want:
            jax_fitting.fit_tt_cores(*args, **kw)
        with pytest.raises(ValueError) as got:
            fitting.fit_tt_cores(*args, **kw)
        assert str(got.value) == str(want.value)
    with pytest.warns(RuntimeWarning, match="f32"):
        fitting.fit_tt_cores(pts, vals, DOM, NS, max_rank=2, sweeps=1,
                             l2=0.0, engine="device", device="cpu")
    with pytest.raises(ValueError, match="explicit device="):
        fitting.fit_tt_cores(pts, vals, DOM, NS, engine="device")
    from pychebyshev_tpu_torch.parallel.sharding import make_mesh
    from pychebyshev_tpu_torch.parallel.world import local_world
    with local_world():
        with pytest.raises(ValueError, match="contradicts the mesh"):
            ChebyshevTT.fit(pts, vals, 4, DOM, NS, engine="device",
                            mesh=make_mesh(device_type="cpu"),
                            device="meta")


# ----------------------------------------------------------------------
# run_completion
# ----------------------------------------------------------------------

def _target(x, _):
    return (np.exp(-x[0] * x[1]) + np.sin(x[2] + 0.5 * x[3])
            + 0.3 * x[0] * x[3])


@pytest.fixture(scope="module")
def completed():
    """A rank-3 TT-ALS build of ``_target``, then ``run_completion``,
    in both packages."""
    out = []
    for cls, kw in ((jx.ChebyshevTT, {}), (ChebyshevTT, {"device": "cpu"})):
        tt = cls(_target, 4, DOM, NS, max_rank=3, tolerance=1e-8, **kw)
        tt.build(verbose=False, method="als", seed=2)
        before = [np.array(c) for c in tt._coeff_cores]
        tt.run_completion(tolerance=1e-10, max_iter=5)
        out.append((tt, before))
    return out


def test_run_completion_against_the_reference(completed):
    (ref, ref_before), (port, port_before) = completed
    for a, b in zip(port_before, ref_before):
        assert _dev(a, b) <= 1e-12
    for a, b in zip(port._coeff_cores, ref._coeff_cores):
        assert _dev(a, b) <= 1e-12
    assert port._cached_error_estimate is None
    q = _samples(64, seed=4)[0]
    assert _dev(port.vectorized_eval_batch(q),
                np.asarray(ref.vectorized_eval_batch(q))) <= 1e-12


def test_run_completion_refusals(completed, tmp_path):
    """A scalar oracle under a mesh is the reference's refusal."""
    from pychebyshev_tpu.parallel.sharding import make_mesh as jax_mesh
    from pychebyshev_tpu_torch.parallel.sharding import make_mesh
    from pychebyshev_tpu_torch.parallel.world import local_world

    (ref, _), (port, _) = completed
    with pytest.raises(ValueError) as want:
        ref.run_completion(mesh=jax_mesh(1))
    with local_world():
        with pytest.raises(ValueError, match="requires vectorized=True") \
                as got:
            port.run_completion(mesh=make_mesh(device_type="cpu"))
    assert str(got.value).replace(
        "a vectorized function of an (N, d) tensor",
        "a JAX-traceable batched oracle") == str(want.value)
    path = tmp_path / "tt.pkl"
    port.save(path)
    loaded = ChebyshevTT.load(path, device="cpu")
    with pytest.raises(RuntimeError, match="requires self.function"):
        loaded.run_completion()
    unbuilt = ChebyshevTT(_target, 4, DOM, NS, device="cpu")
    with pytest.raises(RuntimeError, match="build"):
        unbuilt.run_completion()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert port.method == "als"

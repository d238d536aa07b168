"""``mesh=`` on the PyTorch port's engines, books, TT builds and fits, on
a 4-rank gloo world: every rank gets the full result, held to the port's
single-device result (bitwise where the sharding is exact) and to the
JAX package's mesh result (on 4 of its 8 virtual CPU devices) at the
ceilings of the single-device tests (f32 2e-4, f64 1e-12, dd 1e-10).
Then the refusals the port keeps, with the reference's texts, in a world
of one rank inside this process.

The ranks import this module, so it imports only NumPy, torch and the
port at its top; JAX is imported inside the tests.
"""

import numpy as np
import pytest
import torch

from pychebyshev_tpu_torch import (
    BatchedEvaluator,
    ChebyshevApproximation,
    ChebyshevSlider,
    ChebyshevSpline,
    ChebyshevTT,
    MultiModelEvaluator,
    MultiSpecEvaluator,
)
from pychebyshev_tpu_torch.models.tt_algorithms import GridOracle
from pychebyshev_tpu_torch.parallel import sharding as sh
from pychebyshev_tpu_torch.parallel.world import (
    check_replicated,
    local_world,
    start_world,
)
from pychebyshev_tpu_torch.serving import build_book
from pychebyshev_tpu_torch.utils import fitting

P = 4
BUCKETS = (16, 64)                  # each divides by the data axis
DOMAIN = [[-1.0, 1.0], [0.0, 2.0], [-3.0, 1.0]]
GREEKS = [(0, 0, 0), (1, 0, 0), (2, 0, 0), (0, 1, 0), (0, 0, 1)]
TIERS = {"f32": torch.float32, "f64": torch.float64, "dd": "dd"}
SLIDER_DOMAIN = [[-1.0, 1.0]] * 4
SLIDER_PARTITION = [[0], [1, 2], [3]]
SLIDER_PIVOT = [0.1, 0.2, -0.1, 0.0]
SLIDER_SPECS = [(0, 0, 0, 0), (0, 1, 0, 0), (1, 0, 0, 1)]
TT_DOMAIN = [[0.0, 1.0]] * 4
SPLINE_DOMAIN = [[0.0, 2.0], [-1.0, 1.0]]
N_REF = 64                          # the JAX engines' requests: one bucket
CEILING = {"f32": 2e-4, "f64": 1e-12, "dd": 1e-10}


def f_vec(p, _=None):
    """Arithmetic only: the same bits on NumPy arrays and on tensors."""
    return (p[:, 0] * p[:, 0] * p[:, 1] + p[:, 2] / (2.0 + p[:, 0])
            + 0.5 * p[:, 1] * p[:, 2])


def slider_fn(p, _=None):
    p = np.asarray(p, dtype=np.float64)
    return np.sin(p[:, 0]) + p[:, 1] * p[:, 2] + (p[:, 3] ** 3)


def tt_fn(p, _=None):
    """A rank-few target, arithmetic only (tensors under a mesh)."""
    return (p[:, 0] * p[:, 1] + p[:, 2] * p[:, 2] * p[:, 3]
            + 1.0 / (2.0 + p[:, 1] + p[:, 3]))


def book_columns(p):
    """Four models, products and sums only: the same bits on NumPy
    arrays and on tensors."""
    return [p[:, 0] * (m + 1) + p[:, 1] * p[:, 2] * (0.5 * m)
            + p[:, 2] * p[:, 2] for m in range(4)]


def book_fn(p, _=None):
    if isinstance(p, torch.Tensor):
        return torch.stack(book_columns(p), dim=1)
    return np.stack(book_columns(p), axis=1)


def dense(n_nodes=(9, 8, 8), fn=f_vec, domain=DOMAIN):
    cheb = ChebyshevApproximation(fn, len(domain), domain, list(n_nodes),
                                  vectorized=True, device="cpu")
    cheb.build(verbose=False)
    return cheb


def slider():
    sl = ChebyshevSlider(slider_fn, 4, SLIDER_DOMAIN, [7] * 4,
                         SLIDER_PARTITION, SLIDER_PIVOT, vectorized=True,
                         device="cpu")
    sl.build(verbose=False)
    return sl


def tensor_train(**build):
    tt = ChebyshevTT(tt_fn, 4, TT_DOMAIN, [7, 6, 7, 5], max_rank=4,
                     vectorized=True, device="cpu")
    tt.build(verbose=False, seed=0, **build)
    return tt


def points(n, seed, domain=DOMAIN):
    rng = np.random.default_rng(seed)
    lo = np.array([b[0] for b in domain])
    hi = np.array([b[1] for b in domain])
    return lo + (hi - lo) * rng.uniform(0.02, 0.98, (n, len(domain)))


def fit_samples(n, seed, domain, fn):
    pts = points(n, seed, domain)
    noise = np.random.default_rng(seed + 100).normal(0.0, 1e-3, n)
    return pts, np.asarray(fn(pts)) + noise


def fit_fn3(p):
    return np.sin(2 * p[:, 0]) * np.cos(p[:, 1]) + p[:, 2] ** 3


def fit_fn4(p):
    return np.cos(p[:, 0]) + p[:, 1] * p[:, 2] + 0.3 * p[:, 3] ** 2


def fits(mesh):
    """Every family's fit through its device engines; ``mesh`` or not.
    The dd chunk is cut to 512 rows, so the dense fit spans 6 chunks."""
    out = {}
    pts, vals = fit_samples(3000, 1, DOMAIN, fit_fn3)
    for engine in ("device-dd", "device"):
        model = ChebyshevApproximation.fit(
            pts, vals, 3, DOMAIN, [5, 5, 5], l2=1e-10, engine=engine,
            mesh=mesh, device="cpu")
        out[f"fit_dense_{engine}"] = model.tensor_values
    sp_pts, sp_vals = fit_samples(2000, 2, SPLINE_DOMAIN,
                                  lambda p: np.abs(p[:, 0] - 1.0) + p[:, 1])
    spline = ChebyshevSpline.fit(sp_pts, sp_vals, 2, SPLINE_DOMAIN, [4, 4],
                                 [[1.0], []], l2=1e-8, engine="device-dd",
                                 mesh=mesh, device="cpu")
    out["fit_spline"] = torch.stack([p.tensor_values
                                     for p in spline._pieces])
    sl_pts, sl_vals = fit_samples(2000, 3, SLIDER_DOMAIN, fit_fn4)
    sl = ChebyshevSlider.fit(sl_pts, sl_vals, 4, SLIDER_DOMAIN, [5] * 4,
                             SLIDER_PARTITION, SLIDER_PIVOT, l2=1e-8,
                             engine="device-dd", mesh=mesh, device="cpu")
    out["fit_slider"] = torch.cat([s.tensor_values.reshape(-1)
                                   for s in sl.slides])
    tt_pts, tt_vals = fit_samples(2000, 4, TT_DOMAIN, fit_fn4)
    tt = ChebyshevTT.fit(tt_pts, tt_vals, 4, TT_DOMAIN, [5] * 4,
                         max_rank=3, l2=1e-8, sweeps=3, seed=1,
                         engine="device", mesh=mesh, device="cpu")
    out["fit_tt_rms"] = torch.tensor(tt.fit_diagnostics["rms"])
    return out


def served(mesh):
    """Every engine of the module on ``mesh`` (or on one device)."""
    kw = {"bucket_sizes": BUCKETS, "mesh": mesh, "device": "cpu"}
    res = {}
    cheb = dense()
    pts = points(130, 1)
    for tier, dtype in TIERS.items():
        res[f"value_{tier}"] = BatchedEvaluator(cheb, dtype=dtype, **kw)(pts)
    res["delta_f64"] = BatchedEvaluator(cheb, dtype=torch.float64,
                                        derivative_order=(1, 0, 0),
                                        **kw)(pts)
    for tier in ("f64", "dd"):
        res[f"greeks_{tier}"] = MultiSpecEvaluator(
            cheb, GREEKS, dtype=TIERS[tier], **kw)(pts)
    outside = pts.copy()
    outside[0, 0] = 1.5                          # the f64 sibling serves it
    res["dd_outside"] = BatchedEvaluator(cheb, dtype="dd", **kw)(outside)

    sl = slider()
    s_pts = points(70, 2, SLIDER_DOMAIN)
    res["slider_f64"] = BatchedEvaluator(sl, dtype=torch.float64,
                                         **kw)(s_pts)
    res["slider_greeks_dd"] = MultiSpecEvaluator(
        sl, SLIDER_SPECS, dtype="dd", **kw)(s_pts)
    res["slider_tt"] = BatchedEvaluator(sl.to_tt(), dtype=torch.float64,
                                        **kw)(s_pts)

    tt = tensor_train()
    book = [tt, tt.differentiate([1, 0, 0, 0]), tt.differentiate([0, 0, 1, 0])]
    t_pts = points(90, 3, TT_DOMAIN)
    for tier in ("f64", "dd"):
        res[f"tt_book_{tier}"] = MultiModelEvaluator(
            book, dtype=TIERS[tier], **kw)(t_pts)

    models = build_book(book_fn, 3, DOMAIN, [7, 6, 5], mesh=mesh,
                        device="cpu")
    res["book"] = torch.stack([m.tensor_values for m in models])
    res["book_engine"] = MultiModelEvaluator(models, dtype=torch.float64,
                                             **kw)(pts)

    built = tensor_train(mesh=mesh)
    for k, core in enumerate(built._coeff_cores):
        res[f"tt_build_{k}"] = torch.as_tensor(core)
    built.run_completion(max_iter=2, mesh=mesh)
    for k, core in enumerate(built._coeff_cores):
        res[f"tt_completed_{k}"] = torch.as_tensor(core)
    return res


def dd_tp_engine(mesh):
    """A dd engine the (1, 4) mesh serves tensor-parallel.  A grid really
    beyond ``supports_dd`` has ~16,400 nodes in a dim, whose 2 GB
    differentiation matrix a test cannot build (``parallel.sharding``'s
    tests run such a grid from raw operands), so the single-device dd
    budget is cut below (9, 8, 8) for this engine."""
    from pychebyshev_tpu_torch.ops import eval_dd
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(eval_dd, "supports_dd", lambda shape, max_right=0: False)
        engine = BatchedEvaluator(dense(), dtype="dd", mesh=mesh,
                                  device="cpu")
    assert engine._dd_tp
    return engine(points(50, 6))


def _rank(rank, out):
    res = served(sh.make_mesh(device_type="cpu"))
    fitting._DD_MAX_CHUNK = 512
    res.update(fits(sh.make_mesh(device_type="cpu")))
    res["dd_tp_engine"] = dd_tp_engine(sh.make_mesh(
        axis_names=("dp", "tp"), shape=(1, 4), device_type="cpu"))
    check_replicated(res)
    texts = {}
    try:
        BatchedEvaluator(dense(), dtype=torch.float64,
                         bucket_sizes=(16, 1026),
                         mesh=sh.make_mesh(device_type="cpu"), device="cpu")
    except ValueError as exc:
        texts["bucket"] = str(exc)
    if rank == 0:
        np.savez(out, **{k: v.cpu().numpy() for k, v in res.items()},
                 **{f"text_{k}": np.array(v) for k, v in texts.items()})


@pytest.fixture(scope="module")
def world(tmp_path_factory, request):
    out = tmp_path_factory.mktemp("mesh_serving") / "results.npz"
    ranks = start_world(_rank, P, (str(out),), deadline_s=120)
    try:
        # The references are computed while the ranks run.
        request.getfixturevalue("reference")
        request.getfixturevalue("single")
    finally:
        ranks.wait()
    with np.load(out) as f:
        return dict(f)


@pytest.fixture(scope="module")
def single():
    """The same calls on one device of the port, on one thread like each
    rank: a CPU GEMM's summation order, and with it the last bits of a
    dd fit's Gram, depends on the thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {k: v.numpy() for k, v in served(None).items()}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fitting, "_DD_MAX_CHUNK", 512)
            out.update({k: v.numpy() for k, v in fits(None).items()})
    finally:
        torch.set_num_threads(threads)
    out["dd_tp_engine"] = BatchedEvaluator(
        dense(), dtype=torch.float64, device="cpu")(points(50, 6)).numpy()
    return out


@pytest.fixture(scope="module")
def reference():
    """The JAX package's engines, book and dd fit on a 4-device mesh."""
    import jax.numpy as jnp
    from pychebyshev_tpu import ChebyshevApproximation as JaxApprox
    from pychebyshev_tpu.parallel import sharding as jsh
    from pychebyshev_tpu.serving import BatchedEvaluator as JaxBatched
    from pychebyshev_tpu.serving import MultiSpecEvaluator as JaxMulti
    from pychebyshev_tpu.serving import build_book as jax_build_book

    mesh = jsh.make_mesh(P)
    kw = {"bucket_sizes": BUCKETS, "mesh": mesh}
    cheb = JaxApprox(f_vec, 3, DOMAIN, [9, 8, 8], vectorized=True)
    cheb.build(verbose=False)
    pts = points(130, 1)[:N_REF]
    out = {}
    for tier, dtype in (("f32", jnp.float32), ("f64", jnp.float64),
                        ("dd", "dd")):
        out[f"value_{tier}"] = np.asarray(JaxBatched(cheb, dtype=dtype,
                                                     **kw)(pts))
        if tier != "f32":
            out[f"greeks_{tier}"] = np.asarray(JaxMulti(
                cheb, GREEKS, dtype=dtype, **kw)(pts))
    out["book"] = np.stack([np.asarray(m.tensor_values) for m in
                            jax_build_book(
                                lambda p, _: jnp.stack(book_columns(p),
                                                       axis=1),
                                3, DOMAIN, [7, 6, 5], mesh=mesh)])
    try:
        JaxBatched(cheb, dtype=jnp.float64, bucket_sizes=(16, 1026),
                   mesh=mesh)
    except ValueError as exc:
        out["text_bucket"] = str(exc)
    return out


def _dev(a, ref):
    a, ref = np.asarray(a, dtype=np.float64), np.asarray(ref, np.float64)
    assert a.shape == ref.shape
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-300))


# ----------------------------------------------------------------------
# Engines and books under a mesh
# ----------------------------------------------------------------------

@pytest.mark.parametrize("tier", list(TIERS))
def test_dense_engine(world, single, reference, tier):
    got = world[f"value_{tier}"]
    assert got.shape == (130,)
    assert _dev(got, single[f"value_{tier}"]) <= CEILING[tier]
    assert _dev(got[:N_REF], reference[f"value_{tier}"]) <= CEILING[tier]


def test_dense_derivative_and_outside_the_domain(world, single):
    assert _dev(world["delta_f64"], single["delta_f64"]) <= 1e-12
    assert _dev(world["dd_outside"], single["dd_outside"]) <= 1e-12


@pytest.mark.parametrize("tier", ["f64", "dd"])
def test_greek_report(world, single, reference, tier):
    got = world[f"greeks_{tier}"]
    assert got.shape == (130, len(GREEKS))
    assert _dev(got, single[f"greeks_{tier}"]) <= CEILING[tier]
    assert _dev(got[:N_REF], reference[f"greeks_{tier}"]) <= CEILING[tier]


@pytest.mark.parametrize("run", ["slider_f64", "slider_greeks_dd",
                                 "slider_tt"])
def test_slider_engines(world, single, run):
    assert _dev(world[run], single[run]) <= 1e-12


@pytest.mark.parametrize("tier", ["f64", "dd"])
def test_tt_book(world, single, tier):
    got = world[f"tt_book_{tier}"]
    assert got.shape == (3, 90)
    assert _dev(got, single[f"tt_book_{tier}"]) <= 1e-12


def test_build_book_and_its_engine(world, single, reference):
    assert np.array_equal(world["book"], single["book"])
    assert _dev(world["book"], reference["book"]) <= 1e-14
    assert _dev(world["book_engine"], single["book_engine"]) <= 1e-12


def test_dd_engine_tensor_parallel_beyond_the_budget(world, single):
    assert _dev(world["dd_tp_engine"], single["dd_tp_engine"]) <= 1e-11


# ----------------------------------------------------------------------
# TT builds and fits under a mesh
# ----------------------------------------------------------------------

@pytest.mark.parametrize("stage", ["build", "completed"])
def test_tt_build_and_completion_are_bitwise(world, single, stage):
    ks = [k for k in single if k.startswith(f"tt_{stage}_")]
    assert len(ks) == 4
    for k in ks:
        assert np.array_equal(world[k], single[k]), k


@pytest.mark.parametrize("run", ["fit_dense_device-dd", "fit_spline",
                                 "fit_slider"])
def test_device_dd_fits_are_bitwise(world, single, run):
    assert np.array_equal(world[run], single[run])


def test_dense_device_fit_within_the_f32_tier(world, single):
    assert _dev(world["fit_dense_device"],
                single["fit_dense_device"]) <= 1e-4


def test_tt_device_fit_within_the_f32_tier(world, single):
    """Held as the single-device TT device fit is held to the JAX
    package's (``test_torch_tt_fit.py``): its rms.  The f32 Grams sum
    in another order under the mesh, and the ALS solves amplify that in
    the model's values (2.0e-4 of their scale on this data)."""
    assert abs(float(world["fit_tt_rms"])
               - float(single["fit_tt_rms"])) <= 1e-5
    assert float(world["fit_tt_rms"]) <= 2e-3


# ----------------------------------------------------------------------
# The refusals the port keeps, and the meshed API on one rank
# ----------------------------------------------------------------------

def test_bucket_refusal_is_the_reference_s(world, reference):
    assert str(world["text_bucket"]) == reference["text_bucket"]


@pytest.fixture(scope="module")
def one_rank():
    with local_world():
        yield {"dp": sh.make_mesh(device_type="cpu"),
               "dp_tp": sh.make_mesh(axis_names=("dp", "tp"), shape=(1, 1),
                                     device_type="cpu")}


def _texts(port_call, jax_call):
    with pytest.raises(ValueError) as got:
        port_call()
    with pytest.raises(ValueError) as want:
        jax_call()
    return (str(got.value).replace("torch.float64", "jnp.float64"),
            str(want.value))


@pytest.mark.parametrize("case", ["no_mesh", "tp_refuses", "spline_tp"])
def test_dd_budget_refusals_are_the_reference_s(one_rank, case):
    """A grid beyond ``supports_dd``: (3,)*7 splits into a right group
    of four dims, which the tp plan refuses too."""
    from pychebyshev_tpu import ChebyshevApproximation as JaxApprox
    from pychebyshev_tpu import ChebyshevSpline as JaxSpline
    from pychebyshev_tpu.parallel import sharding as jsh
    from pychebyshev_tpu.serving import BatchedEvaluator as JaxBatched

    dom = [[-1.0, 1.0]] * 7

    def fn(p, _=None):
        return p[:, 0] + p[:, 6] * p[:, 3]

    if case == "spline_tp":
        knots = [[0.0]] + [[]] * 6
        port = ChebyshevSpline(fn, 7, dom, [3] * 7, knots, vectorized=True,
                               device="cpu")
        ref = JaxSpline(fn, 7, dom, [3] * 7, knots, vectorized=True)
    else:
        port = ChebyshevApproximation(fn, 7, dom, [3] * 7, vectorized=True,
                                      device="cpu")
        ref = JaxApprox(fn, 7, dom, [3] * 7, vectorized=True)
    port.build(verbose=False)
    ref.build(verbose=False)
    mesh, jmesh = None, None
    if case != "no_mesh":
        mesh = one_rank["dp_tp"]
        jmesh = jsh.make_mesh(1, ("dp", "tp"), (1, 1))
    got, want = _texts(
        lambda: BatchedEvaluator(port, dtype="dd", mesh=mesh, device="cpu"),
        lambda: JaxBatched(ref, dtype="dd", mesh=jmesh))
    assert got == want


def test_a_scalar_oracle_under_a_mesh_is_refused(one_rank):
    from pychebyshev_tpu.models.tt_algorithms import GridOracle as JaxOracle
    from pychebyshev_tpu.parallel import sharding as jsh

    grids = [np.linspace(0, 1, n) for n in (3, 4)]
    got, want = _texts(
        lambda: GridOracle(lambda x, _: x[0], grids, mesh=one_rank["dp"]),
        lambda: JaxOracle(lambda x, _: x[0], grids,
                          mesh=jsh.make_mesh(1)))
    assert got.replace("a vectorized function of an (N, d) tensor",
                       "a JAX-traceable batched oracle") == want
    tt = ChebyshevTT(lambda x, _: x[0] * x[1], 2, [[0, 1]] * 2, [3, 4],
                     device="cpu")
    with pytest.raises(ValueError, match="requires vectorized=True"):
        tt.build(verbose=False, mesh=one_rank["dp"])


def test_a_numpy_book_function_under_a_mesh_is_refused(one_rank):
    def numpy_book(p, _=None):
        return np.stack([np.sin(np.asarray(p)[:, 0])] * 2, axis=1)

    with pytest.raises(ValueError,
                       match=r"build_book\(mesh=\.\.\.\) requires a "
                             r"vectorized book function.*drop mesh= for "
                             r"host/NumPy oracles"):
        build_book(numpy_book, 3, DOMAIN, [3, 3, 3], mesh=one_rank["dp"],
                   device="cpu")


def test_a_host_fit_engine_under_a_mesh_is_refused(one_rank):
    pts, vals = fit_samples(300, 7, DOMAIN, fit_fn3)
    with pytest.raises(ValueError, match="mesh= requires a device engine"):
        ChebyshevApproximation.fit(pts, vals, 3, DOMAIN, [3, 3, 3],
                                   mesh=one_rank["dp"], device="cpu")


def test_a_device_the_mesh_contradicts_is_refused(one_rank):
    mesh = one_rank["dp"]
    cheb = dense((4, 4, 4))
    pts, vals = fit_samples(300, 7, DOMAIN, fit_fn3)
    calls = [
        lambda: BatchedEvaluator(cheb, mesh=mesh, device="meta"),
        lambda: MultiSpecEvaluator(cheb, GREEKS, mesh=mesh, device="meta"),
        lambda: MultiModelEvaluator([cheb], mesh=mesh, device="meta"),
        lambda: build_book(book_fn, 3, DOMAIN, [3, 3, 3], mesh=mesh,
                           device="meta"),
        lambda: ChebyshevApproximation.fit(
            pts, vals, 3, DOMAIN, [3, 3, 3], l2=1e-8, engine="device-dd",
            mesh=mesh, device="meta"),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="contradicts the mesh"):
            call()


def test_a_cuda_tensor_under_gloo_is_refused(one_rank):
    """A tensor that says it is on a card never goes through gloo, nor
    is it staged through the host."""
    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    cheb = dense((4, 4, 4))
    nodes, weights, diffs = cheb._grid_tuples()
    tensor = cheb.tensor_values.as_subclass(OnCard)
    with pytest.raises(ValueError, match="never staged through the host"):
        sh.eval_batch_dp(tensor, nodes, weights, diffs, points(8, 8),
                         one_rank["dp"], (0, 0, 0))
    with pytest.raises(ValueError, match="never staged through the host"):
        sh._all_reduce(torch.ones(2).as_subclass(OnCard),
                       one_rank["dp"].get_group("dp"))


def test_a_cuda_mesh_needs_a_card(one_rank, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        sh.make_mesh(device_type="cuda")


def test_make_mesh_spans_the_world(one_rank, monkeypatch):
    with pytest.raises(ValueError, match="must equal the world size"):
        sh.make_mesh(2, device_type="cpu")
    with pytest.raises(ValueError, match="holds 2 devices"):
        sh.make_mesh(axis_names=("dp", "tp"), shape=(1, 2),
                     device_type="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="runs over NCCL"):
        sh.make_mesh(device_type="cuda")
    assert sh.axis_size(one_rank["dp_tp"], "tp") == 1
    with pytest.raises(ValueError, match="has no axis 'pp'"):
        sh.axis_size(one_rank["dp"], "pp")


@pytest.mark.parametrize("family", ["dense", "tt"])
def test_one_rank_mesh_is_the_single_device_call(one_rank, family):
    mesh = one_rank["dp"]
    if family == "dense":
        cheb = dense((5, 4, 6))
        pts = points(37, 9)
        for dtype in (torch.float64, "dd"):
            assert torch.equal(
                BatchedEvaluator(cheb, dtype=dtype, mesh=mesh,
                                 device="cpu")(pts),
                BatchedEvaluator(cheb, dtype=dtype, device="cpu")(pts))
    else:
        a, b = tensor_train(mesh=mesh), tensor_train(mesh=None)
        for ca, cb in zip(a._coeff_cores, b._coeff_cores):
            assert np.array_equal(ca, cb)

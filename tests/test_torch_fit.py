"""The port's scattered-data fits (dense, spline, slider) against the JAX
package's, on the CPU.

Same seeded NumPy samples go to both packages.  The ``host`` engine is
a copy of the reference's NumPy loops and must give the same bits.  The
``device`` engine (the port on the CPU tensors, IEEE f32) holds its Gram
to 1e-4 of the host f64 Gram (the reference's own bound for its f32
tier) and its tensor to 1e-4 of the JAX ``device`` engine's; the
``device-dd`` engine (native f64 here) holds its Gram to 1e-13 of the
host's and its tensor to 1e-10 of the JAX ``device-dd`` engine's, all
scale-normalized.  Each JAX entry point runs once, through
module-scoped results.
"""

import warnings

import numpy as np
import pytest
import torch

import pychebyshev_tpu as jx
from pychebyshev_tpu.utils import fitting as jax_fitting
from pychebyshev_tpu_torch import (
    ChebyshevApproximation,
    ChebyshevSlider,
    ChebyshevSpline,
)
from pychebyshev_tpu_torch.utils import fitting

DOM3 = [[0.0, 2.0], [-1.0, 1.0], [0.0, 1.0]]
NS3 = [5, 5, 5]
N = 2048
ENGINES = ["host", "device", "device-dd"]
DOM_SP = [[0.0, 2.0], [0.0, 1.0]]
KNOTS = [[1.0], []]
NS_SP = [7, 7]
DOM_SL = [[-1.0, 1.0]] * 4
NS_SL = [5, 5, 5, 5]
PARTITION = [[0], [1, 2], [3]]
PIVOT = [0.1, 0.2, -0.1, 0.0]


def _dev(a, ref):
    a = np.asarray(a, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert a.shape == ref.shape
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-300)


def _samples3(n=N, seed=0):
    rng = np.random.default_rng(seed)
    pts = np.column_stack([rng.uniform(lo, hi, n) for lo, hi in DOM3])
    vals = (np.sin(2 * pts[:, 0]) * np.cos(pts[:, 1]) + pts[:, 2] ** 3
            + rng.normal(0.0, 1e-3, n))
    return pts, vals


def _grad_block(n=256, seed=1):
    """d/dx0 of the dense target, weight 0.5."""
    rng = np.random.default_rng(seed)
    pts = np.column_stack([rng.uniform(lo, hi, n) for lo, hi in DOM3])
    vals = 2 * np.cos(2 * pts[:, 0]) * np.cos(pts[:, 1])
    return [(pts, (1, 0, 0), vals, 0.5)]


def _weights(n=N, seed=2):
    w = np.random.default_rng(seed).uniform(0.5, 2.0, n)
    w[:17] = 0.0
    return w


# name -> kwargs of one dense fit; the samples are _samples3().
DENSE_CASES = {
    "plain": dict(l2=1e-8),
    "weighted": dict(l2=1e-8, sample_weight=_weights()),
    "gradient": dict(l2=1e-8, derivative_data=_grad_block()),
    "exact": dict(l2=0.0),
}


def _kink(p):
    return np.maximum(p[:, 0] - 1.0, 0.0) * np.exp(-0.5 * p[:, 1])


def _additive(p):
    return np.sin(p[:, 0]) + p[:, 1] * p[:, 2] + np.exp(0.3 * p[:, 3])


def _spline_samples(n=N, seed=3):
    rng = np.random.default_rng(seed)
    pts = np.column_stack([rng.uniform(lo, hi, n) for lo, hi in DOM_SP])
    pts[:8, 0] = 1.0                      # on the knot: the right piece
    return pts, _kink(pts)


def _slider_samples(n=N, seed=4):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.0, 1.0, (n, 4))
    return pts, _additive(pts) + rng.normal(0.0, 1e-4, n)


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


@pytest.fixture(scope="module")
def jax_dense():
    """(case, engine) -> (tensor, diagnostics) of the JAX package."""
    pts, vals = _samples3()
    out = {}
    for case, kw in DENSE_CASES.items():
        for engine in ENGINES:
            if case == "exact" and engine != "host":
                continue
            out[case, engine] = _quiet(jax_fitting.fit_dense_tensor, pts,
                                       vals, DOM3, NS3, engine=engine, **kw)
    return out


@pytest.fixture(scope="module")
def port_dense():
    pts, vals = _samples3()
    out = {}
    for case, kw in DENSE_CASES.items():
        for engine in ENGINES:
            if case == "exact" and engine != "host":
                continue
            out[case, engine] = _quiet(fitting.fit_dense_tensor, pts, vals,
                                       DOM3, NS3, engine=engine,
                                       device="cpu", **kw)
    return out


def _host_gram(blocks, nodes, weights, dim_design):
    ata = 0.0
    aty = 0.0
    for pts, orders, vals, sw in blocks:
        rows = fitting._khatri_rao([dim_design.rows(pts[:, k], k, orders[k])
                                    for k in range(len(nodes))])
        rows = rows * sw[:, None]
        ata = ata + rows.T @ rows
        aty = aty + rows.T @ (vals * sw)
    return ata, aty


@pytest.fixture(scope="module")
def gram_inputs():
    pts, vals = _samples3()
    nodes = [fitting.nodes_for_dim_np(lo, hi, n)
             for (lo, hi), n in zip(DOM3, NS3)]
    weights = [fitting.barycentric_weights_np(nd) for nd in nodes]
    dim_design = fitting._DimDesign(nodes, weights)
    (gp, go, gv, gw), = _grad_block()
    blocks = [(pts, (0, 0, 0), vals, np.sqrt(_weights())),
              (gp, go, gv, np.full(len(gp), np.sqrt(gw)))]
    return blocks, nodes, weights, dim_design


# ----------------------------------------------------------------------
# The dense fit
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_host_engine_is_bitwise_the_reference(jax_dense, port_dense, case):
    want, want_diag = jax_dense[case, "host"]
    got, got_diag = port_dense[case, "host"]
    assert np.array_equal(got, want)
    assert got_diag == want_diag


@pytest.mark.parametrize("case", ["plain", "weighted", "gradient"])
def test_device_engine_against_the_reference(jax_dense, port_dense, case):
    got, diag = port_dense[case, "device"]
    want, want_diag = jax_dense[case, "device"]
    assert _dev(got, want) <= 1e-4
    assert diag["engine"] == "device"
    assert abs(diag["rms"] - want_diag["rms"]) <= 1e-6


@pytest.mark.parametrize("case", ["plain", "weighted", "gradient"])
def test_device_dd_engine_against_the_reference(jax_dense, port_dense,
                                                case):
    got, diag = port_dense[case, "device-dd"]
    want, want_diag = jax_dense[case, "device-dd"]
    assert _dev(got, want) <= 1e-10
    # and against the host engine, which sees the same normal equations
    assert _dev(got, port_dense[case, "host"][0]) <= 1e-10
    assert abs(diag["rms"] - want_diag["rms"]) <= 1e-12


def test_f32_gram_against_host(gram_inputs):
    blocks, nodes, weights, dim_design = gram_inputs
    want_a, want_b = _host_gram(blocks, nodes, weights, dim_design)
    ata, aty = fitting._device_normal_accumulation(
        blocks, nodes, weights, dim_design, 125, device="cpu")
    assert ata.dtype == np.float64
    assert _dev(ata, want_a) <= 1e-4
    assert _dev(aty, want_b) <= 1e-4


def test_dd_gram_against_host(gram_inputs):
    blocks, nodes, weights, dim_design = gram_inputs
    want_a, want_b = _host_gram(blocks, nodes, weights, dim_design)
    ata, aty = fitting._device_normal_accumulation_dd(
        blocks, nodes, weights, dim_design, 125, device="cpu")
    assert _dev(ata, want_a) <= 1e-13
    assert _dev(aty, want_b) <= 1e-13


def test_dd_gram_is_the_in_order_sum_of_chunk_partials(gram_inputs,
                                                       monkeypatch):
    """The sharding contract: per block, the chunk partials added in
    chunk order from zero; the blocks summed in f64 after."""
    blocks, nodes, weights, dim_design = gram_inputs
    # A cap below the value block's rows, so it spans several chunks.
    monkeypatch.setattr(fitting, "_DD_MAX_CHUNK", 500)
    ata, aty = fitting._device_normal_accumulation_dd(
        blocks, nodes, weights, dim_design, 125, device="cpu")
    chunk = fitting._fit_chunk_size(125, blocks, cap=fitting._DD_MAX_CHUNK)
    assert chunk == 500
    want_a = np.zeros((125, 125))
    want_b = np.zeros(125)
    n_chunks = 0
    for block in blocks:
        b_a = torch.zeros((125, 125), dtype=torch.float64)
        b_b = torch.zeros(125, dtype=torch.float64)
        for d_a, d_b in fitting._chunk_partials(
                block, ("dense",), nodes, weights, dim_design, chunk,
                device="cpu", dtype=torch.float64):
            b_a = b_a + d_a
            b_b = b_b + d_b
            n_chunks += 1
        want_a += b_a.numpy()
        want_b += b_b.numpy()
    assert n_chunks > len(blocks)
    assert np.array_equal(ata, want_a)
    assert np.array_equal(aty, want_b)


def test_chunk_sizes_are_the_reference_s(gram_inputs):
    blocks = gram_inputs[0]
    for g in (125, 729, 4096):
        for cap in (None, fitting._DD_MAX_CHUNK):
            assert (fitting._fit_chunk_size(g, blocks, cap=cap)
                    == jax_fitting._fit_chunk_size(g, blocks, cap=cap))


def test_host_helpers_are_bitwise_the_reference():
    rng = np.random.default_rng(5)
    nodes = fitting.nodes_for_dim_np(-1.0, 2.0, 6)
    weights = fitting.barycentric_weights_np(nodes)
    x = np.concatenate([rng.uniform(-1.0, 2.0, 40), nodes[:2]])
    assert np.array_equal(fitting.barycentric_rows_np(x, nodes, weights),
                          jax_fitting.barycentric_rows_np(x, nodes,
                                                          weights))
    dd_port = fitting._DimDesign([nodes], [weights])
    dd_ref = jax_fitting._DimDesign([nodes], [weights])
    for order in (0, 1, 3):
        assert np.array_equal(dd_port.rows(x, 0, order),
                              dd_ref.rows(x, 0, order))
    blocks = fitting.normalize_derivative_data(_grad_block(), 3, DOM3, NS3)
    assert (fitting._capped_block_rows(blocks, NS3)
            == jax_fitting._capped_block_rows(blocks, NS3))
    assert fitting._MAX_GRID_POINTS == jax_fitting._MAX_GRID_POINTS


def test_class_fit_matches_the_reference(jax_dense):
    pts, vals = _samples3()
    kw = DENSE_CASES["gradient"]
    ref = jx.ChebyshevApproximation.fit(pts, vals, 3, DOM3, NS3, **kw,
                                        additional_data={"k": 1})
    port = ChebyshevApproximation.fit(pts, vals, 3, DOM3, NS3, **kw,
                                      additional_data={"k": 1},
                                      device="cpu")
    assert port.fit_diagnostics == ref.fit_diagnostics
    assert port.n_evaluations == ref.n_evaluations == N
    assert port.additional_data == {"k": 1}
    assert port.device == torch.device("cpu")
    assert np.array_equal(port.tensor_values.numpy(),
                          np.asarray(ref.tensor_values))
    q = _samples3(64, seed=9)[0]
    assert _dev(port.vectorized_eval_batch(q, [0, 0, 0]),
                ref.vectorized_eval_batch(q, [0, 0, 0])) <= 1e-12


@pytest.mark.parametrize("engine", ["device", "device-dd"])
def test_class_fit_runs_each_device_engine(engine):
    pts, vals = _samples3(512, seed=6)
    port = _quiet(ChebyshevApproximation.fit, pts, vals, 3, DOM3, [4, 4, 4],
                  l2=1e-10, engine=engine, device="cpu")
    host = ChebyshevApproximation.fit(pts, vals, 3, DOM3, [4, 4, 4],
                                      l2=1e-10, device="cpu")
    assert port.fit_diagnostics["engine"] == engine
    assert abs(port.fit_diagnostics["rms"]
               - host.fit_diagnostics["rms"]) <= 1e-6


# ----------------------------------------------------------------------
# Errors and warnings: the reference's texts
# ----------------------------------------------------------------------

def _bad_calls():
    pts, vals = _samples3(300, seed=7)
    out_pts = pts.copy()
    out_pts[0, 1] = 1.5
    nan_vals = vals.copy()
    nan_vals[3] = np.nan
    grad = _grad_block(20)
    (gp, _, gv, _), = grad
    return {
        "domain_len": ((pts, vals, DOM3[:2], NS3), {}),
        "points_shape": ((pts[:, :2], vals, DOM3, NS3), {}),
        "values_shape": ((pts, vals[:-1], DOM3, NS3), {}),
        "empty": ((pts[:0], vals[:0], DOM3, NS3), {}),
        "nan_values": ((pts, nan_vals, DOM3, NS3), {}),
        "negative_l2": ((pts, vals, DOM3, NS3), {"l2": -1.0}),
        "engine": ((pts, vals, DOM3, NS3), {"engine": "gpu"}),
        "host_mesh": ((pts, vals, DOM3, NS3), {"mesh": object()}),
        "n_nodes": ((pts, vals, DOM3, [5, 0, 5]), {"l2": 1e-8}),
        "grid_cap": ((pts, vals, DOM3, [17, 17, 17]), {"l2": 1e-8}),
        "outside": ((out_pts, vals, DOM3, NS3), {"l2": 1e-8}),
        "weight_shape": ((pts, vals, DOM3, NS3),
                         {"l2": 1e-8, "sample_weight": np.ones(3)}),
        "weight_negative": ((pts, vals, DOM3, NS3),
                            {"l2": 1e-8,
                             "sample_weight": -np.ones(len(vals))}),
        "weight_zero": ((pts, vals, DOM3, NS3),
                        {"l2": 1e-8, "sample_weight": np.zeros(len(vals))}),
        "underdetermined": ((pts[:100], vals[:100], DOM3, NS3), {}),
        "block_len": ((pts, vals, DOM3, NS3),
                      {"l2": 1e-8, "derivative_data": [(gp, (1, 0))]}),
        "block_orders": ((pts, vals, DOM3, NS3),
                         {"l2": 1e-8,
                          "derivative_data": [(gp, (1, 0), gv)]}),
        "block_order_high": ((pts, vals, DOM3, NS3),
                             {"l2": 1e-8,
                              "derivative_data": [(gp, (5, 0, 0), gv)]}),
        "block_weight": ((pts, vals, DOM3, NS3),
                         {"l2": 1e-8,
                          "derivative_data": [(gp, (1, 0, 0), gv, 0.0)]}),
    }


@pytest.mark.parametrize("name", list(_bad_calls()))
def test_dense_errors_are_the_reference_s(name):
    args, kw = _bad_calls()[name]
    with pytest.raises(ValueError) as want:
        jax_fitting.fit_dense_tensor(*args, **kw)
    with pytest.raises(ValueError) as got:
        fitting.fit_dense_tensor(*args, **kw)
    assert str(got.value) == str(want.value)


def test_device_engine_warns_on_l2_zero():
    pts, vals = _samples3(400, seed=8)
    with pytest.warns(UserWarning, match="engine='host'"):
        fitting.fit_dense_tensor(pts, vals, DOM3, [4, 4, 4], l2=0.0,
                                 engine="device", device="cpu")


def test_rank_deficiency_warns_as_the_reference():
    pts, vals = _samples3(70, seed=10)
    pts = np.concatenate([pts, pts])
    vals = np.concatenate([vals, vals])
    with pytest.warns(UserWarning, match="rank-deficient") as want:
        _, ref = jax_fitting.fit_dense_tensor(pts, vals, DOM3, [4, 4, 5])
    with pytest.warns(UserWarning, match="rank-deficient") as got:
        _, diag = fitting.fit_dense_tensor(pts, vals, DOM3, [4, 4, 5])
    assert str(got[0].message) == str(want[0].message)
    assert diag["min_norm"] and diag == ref


def test_device_engines_need_a_device():
    pts, vals = _samples3(300, seed=7)
    for engine in ("device", "device-dd"):
        with pytest.raises(ValueError, match="explicit device="):
            fitting.fit_dense_tensor(pts, vals, DOM3, NS3, l2=1e-8,
                                     engine=engine)


def test_tf32_precision_is_refused_on_cuda(monkeypatch):
    monkeypatch.setattr(torch, "get_float32_matmul_precision",
                        lambda: "high")
    with pytest.raises(ValueError, match="TF32"):
        fitting._require_ieee_f32(torch.device("cuda"))
    fitting._require_ieee_f32(torch.device("cpu"))


@pytest.fixture(scope="module")
def one_rank_mesh():
    """A ("dp",) mesh over this process as a world of one rank."""
    from pychebyshev_tpu_torch.parallel.sharding import make_mesh
    from pychebyshev_tpu_torch.parallel.world import local_world
    with local_world():
        yield make_mesh(device_type="cpu")


def _arrays(result):
    """The fitted numbers of a fitter's ``(tensor(s), diagnostics)`` or of
    a fitted model, as NumPy arrays."""
    if isinstance(result, tuple):
        out = result[0]
        return [np.asarray(a) for a in (out if isinstance(out, (list, tuple))
                                        else [out])]
    if isinstance(result, ChebyshevSpline):
        return [p.tensor_values.numpy() for p in result._pieces]
    if isinstance(result, ChebyshevSlider):
        return [s.tensor_values.numpy() for s in result.slides]
    return [result.tensor_values.numpy()]


@pytest.mark.parametrize("call", ["dense", "additive", "tt", "spline",
                                  "slider", "class"])
def test_mesh_is_refused_by_name(call, one_rank_mesh):
    """Every fitter takes ``mesh=`` by name: on a mesh of one rank it is
    bitwise the call without one (the f32 and dd accumulations alike)."""
    pts, vals = _samples3(300, seed=7)
    p4 = np.column_stack([pts, pts[:, 2]])
    calls = {
        "dense": lambda mesh: fitting.fit_dense_tensor(
            pts, vals, DOM3, NS3, engine="device", mesh=mesh,
            device="cpu"),
        "additive": lambda mesh: fitting.fit_additive_tensors(
            pts, vals, DOM3, NS3, [[0], [1, 2]], engine="device-dd",
            mesh=mesh, device="cpu"),
        "tt": lambda mesh: fitting.fit_tt_cores(
            pts, vals, DOM3, NS3, engine="device", mesh=mesh,
            device="cpu"),
        "spline": lambda mesh: ChebyshevSpline.fit(
            pts[:, :2], vals, 2, [[0.0, 2.0], [-1.0, 1.0]], [4, 4],
            [[1.0], []], l2=1e-8, engine="device", mesh=mesh,
            device="cpu"),
        "slider": lambda mesh: ChebyshevSlider.fit(
            np.clip(p4, -1, 1), vals, 4, DOM_SL, NS_SL, PARTITION, PIVOT,
            l2=1e-8, engine="device", mesh=mesh, device="cpu"),
        "class": lambda mesh: ChebyshevApproximation.fit(
            pts, vals, 3, DOM3, NS3, l2=1e-8, engine="device-dd",
            mesh=mesh, device="cpu"),
    }
    got = _arrays(_quiet(calls[call], one_rank_mesh))
    want = _arrays(_quiet(calls[call], None))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


# ----------------------------------------------------------------------
# Spline and slider fits
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def spline_fits():
    pts, vals = _spline_samples()
    grad = [(pts[:128], (1, 0),
             (pts[:128, 0] > 1.0) * np.exp(-0.5 * pts[:128, 1]), 0.1)]
    out = {}
    for engine in ENGINES:
        kw = dict(l2=1e-10, engine=engine, derivative_data=grad)
        ref = _quiet(jx.ChebyshevSpline.fit, pts, vals, 2, DOM_SP, NS_SP,
                     KNOTS, **kw)
        port = _quiet(ChebyshevSpline.fit, pts, vals, 2, DOM_SP, NS_SP,
                      KNOTS, device="cpu", **kw)
        out[engine] = ref, port
    return out


@pytest.mark.parametrize("engine", ENGINES)
def test_spline_fit_against_the_reference(spline_fits, engine):
    ref, port = spline_fits[engine]
    tol = {"host": 0.0, "device": 1e-4, "device-dd": 1e-10}[engine]
    for pr, pp in zip(ref._pieces, port._pieces):
        want = np.asarray(pr.tensor_values)
        got = pp.tensor_values.numpy()
        if engine == "host":
            assert np.array_equal(got, want)
        else:
            assert _dev(got, want) <= tol
    if engine == "host":
        assert port.fit_diagnostics == ref.fit_diagnostics
    assert port.fit_diagnostics["n_derivative_rows"] == 128
    q = _spline_samples(64, seed=11)[0]
    assert _dev(port.eval_batch(q, [0, 0]),
                np.asarray(ref.eval_batch(q, [0, 0]))) <= max(
        tol, 1e-12)


def test_spline_fit_errors_are_the_reference_s():
    pts, vals = _spline_samples(300)
    left = pts[:, 0] < 1.0
    cases = [
        ((pts[left], vals[left], 2, DOM_SP, [4, 4], KNOTS), {"l2": 1e-8}),
        ((pts, vals[:-1], 2, DOM_SP, [4, 4], KNOTS), {}),
        ((pts[:20], vals[:20], 2, DOM_SP, [5, 5], KNOTS), {}),
        ((pts, vals, 2, DOM_SP, [4, 4], KNOTS),
         {"sample_weight": np.ones(4)}),
    ]
    for args, kw in cases:
        with pytest.raises(ValueError) as want:
            jx.ChebyshevSpline.fit(*args, **kw)
        with pytest.raises(ValueError) as got:
            ChebyshevSpline.fit(*args, **kw, device="cpu")
        assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="flat n_nodes"):
        ChebyshevSpline.fit(pts, vals, 2, DOM_SP, [[4, 5], 4], KNOTS,
                            device="cpu")


@pytest.fixture(scope="module")
def slider_fits():
    pts, vals = _slider_samples()
    grad = [(pts[:200], (0, 0, 0, 1), 0.3 * np.exp(0.3 * pts[:200, 3]))]
    out = {}
    for engine in ENGINES:
        kw = dict(l2=1e-9, engine=engine, derivative_data=grad)
        ref = _quiet(jx.ChebyshevSlider.fit, pts, vals, 4, DOM_SL, NS_SL,
                     PARTITION, PIVOT, **kw)
        port = _quiet(ChebyshevSlider.fit, pts, vals, 4, DOM_SL, NS_SL,
                      PARTITION, PIVOT, device="cpu", **kw)
        out[engine] = ref, port
    return out


@pytest.mark.parametrize("engine", ENGINES)
def test_slider_fit_against_the_reference(slider_fits, engine):
    ref, port = slider_fits[engine]
    q = np.random.default_rng(12).uniform(-1.0, 1.0, (64, 4))
    got = port.eval_batch(q)
    want = np.asarray(ref.eval_batch(q))
    if engine == "host":
        for sr, sp in zip(ref.slides, port.slides):
            assert np.array_equal(sp.tensor_values.numpy(),
                                  np.asarray(sr.tensor_values))
        assert port.pivot_value == ref.pivot_value
        assert port.fit_diagnostics == ref.fit_diagnostics
        assert _dev(got, want) <= 1e-12
    else:
        # The additive design's constant redundancies are weakly pinned
        # by l2, so the engines agree on predictions, not on the gauge.
        assert _dev(got, want) <= (1e-4 if engine == "device" else 1e-10)
    assert port.fit_diagnostics["columns"] == 1 + 5 + 25 + 5
    assert abs(port.eval(PIVOT, [0] * 4) - port.pivot_value) <= 1e-12


def test_additive_errors_are_the_reference_s():
    pts, vals = _slider_samples(300)
    (gp, _, gv), = [(pts[:10], None, vals[:10])]
    cases = [
        ((pts, vals, DOM_SL, NS_SL, [[0], [1, 2]]), {}),
        ((pts, vals, DOM_SL, NS_SL, [[0], [], [1, 2, 3]]), {}),
        ((pts, vals, DOM_SL, [30, 30, 30, 30], [[0, 1, 2], [3]]), {}),
        ((pts, vals, DOM_SL, NS_SL, PARTITION),
         {"derivative_data": [(gp, (1, 1, 0, 0), gv)]}),
        ((pts[:6], vals[:6], DOM_SL, NS_SL, PARTITION), {}),
        ((pts, vals, DOM_SL, NS_SL, PARTITION), {"engine": "gpu"}),
    ]
    for args, kw in cases:
        with pytest.raises(ValueError) as want:
            jax_fitting.fit_additive_tensors(*args, **kw)
        with pytest.raises(ValueError) as got:
            fitting.fit_additive_tensors(*args, **kw)
        assert str(got.value) == str(want.value)
    for bad in (dict(partition=[[0], [1, 2]]), dict(pivot_point=[0.0])):
        kw = dict(partition=PARTITION, pivot_point=PIVOT)
        kw.update(bad)
        with pytest.raises(ValueError) as want:
            jx.ChebyshevSlider.fit(pts, vals, 4, DOM_SL, NS_SL, **kw)
        with pytest.raises(ValueError) as got:
            ChebyshevSlider.fit(pts, vals, 4, DOM_SL, NS_SL, **kw,
                                device="cpu")
        assert str(got.value) == str(want.value)

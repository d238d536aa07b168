"""``bench_torch.py``, the port's benchmark, on the CPU.

(a) Its rehearsal, ``main(device="cpu", small=True)``: every row, every
key, every ceiling, and the last line.  (b) The CPU accuracy gate of
``scripts/perf_gate.py --cpu`` (``gate_cpu``) on the port, at the gate's
own inputs and ceilings.  (c) The same inputs through the JAX package:
the calls the rows make, held to the JAX package's f64 calls (its dd
paths are not the yardstick; ROADMAP.md queue 3), the rank-15 cross's
ranks and evaluation count, and config 5's TT-ALS builds (bitwise the
JAX package's).  The host rows' C and NumPy single-point values are
bitwise the JAX package's (the same C source, the same NumPy steps), as
are the host fits, the TT search and the zero isolators (host NumPy
copies); the global searches agree within 1e-12 of each model's scale.
(d) No card: ``main`` and the command line refuse, naming the cause.
(e) ``--rows``: a prefix runs exactly its rows.
"""

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from pychebyshev_tpu import ChebyshevApproximation as JaxApproximation
from pychebyshev_tpu import ChebyshevSlider as JaxSlider
from pychebyshev_tpu import ChebyshevSpline as JaxSpline
from pychebyshev_tpu import ChebyshevTT as JaxTT
from pychebyshev_tpu import solve_system as jax_solve_system
from pychebyshev_tpu.ops import eval as jax_eval
from pychebyshev_tpu.ops import integrate as jax_integrate
from pychebyshev_tpu.ops import subdivision as jax_subdivision
from pychebyshev_tpu.ops import tt_eval_dd as jax_tt_eval_dd
from pychebyshev_tpu.ops.tt_eval import tt_eval_batch as jax_tt_eval_batch
from pychebyshev_tpu.serving import integrate_book as jax_integrate_book
from pychebyshev_tpu.utils import fitting as jax_fitting
from pychebyshev_tpu_torch import (
    BatchedEvaluator,
    ChebyshevApproximation,
    ChebyshevSlider,
    ChebyshevSpline,
    ChebyshevTT,
)
from pychebyshev_tpu_torch.ops import eval as eval_ops
from pychebyshev_tpu_torch.ops import (
    eval_dd,
    fused_eval,
    integrate,
    slider_eval,
    subdivision,
    tt_eval,
    tt_eval_dd,
)
from pychebyshev_tpu_torch.ops.chebyshev import (
    barycentric_weights_np,
    nodes_for_dim_np,
)
from pychebyshev_tpu_torch.utils import fitting, globalcalc

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("bench_torch",
                                               REPO / "bench_torch.py")
bench = sys.modules.setdefault("bench_torch",
                               importlib.util.module_from_spec(_spec))
if not hasattr(bench, "main"):
    _spec.loader.exec_module(bench)

KEYS = {"metric", "value", "unit", "n", "median_ms", "p75_ms", "samples",
        "deviation", "ceiling", "against", "device", "ok"}
BASES = [base for base, _ in bench.ROWS]
#: The rows of bench.py, then the baseline table's and the calculus ones.
NEW_BASES = [
    "bs5d_11n_host_query_us", "bs5d_11n_host_price_greeks_us",
    "bs5d_11n_to_tt_host_query_us", "bs5d_tt_r15_host_query_us",
    "spline2d_17n_build_s", "spline2d_17n_f64_queries_per_sec",
    "spline2d_17n_f32_queries_per_sec", "slider10d_9n_build_s",
    "slider10d_9n_f32_queries_per_sec", "slider10d_9n_dd_queries_per_sec",
    "slider10d_9n_f64_queries_per_sec", "portfolio4d_tt_als_build_s",
    "portfolio4d_run_completion_s", "bs5d_11n_f64_box_integrals_per_sec",
    "bs5d_11n_f32_box_integrals_per_sec",
    "bs5d_11n_dd_box_integrals_per_sec",
    "bs5d_tt11_r15_f64_box_integrals_per_sec",
    "bs5d_11n_f64_cond_exp_scenarios_per_sec",
    "bs5d_tt11_r15_dd_cond_exp_scenarios_per_sec",
    "bs5d_11n_integrate_book_boxes_per_sec",
    "bs5d_11n_scenario_roots_per_sec", "bs5d_11n_scenario_minima_per_sec",
    # the rest of scripts/: the fits, global calculus, the TT search,
    # zero isolation, the grouped TT chains
    "fit3d_9n_host_samples_per_sec", "fit3d_9n_f32_samples_per_sec",
    "fit3d_9n_dd_samples_per_sec",
    "ttfit5d_7n_r5_device_sample_sweeps_per_sec",
    "ttfit5d_7n_r5_host_sample_sweeps_per_sec",
    "global_waves2d_21n_min_s", "global_bowl3d_9n_min_s",
    "global_osc5d_21n_min_s", "global_spline2d_kink_min_s",
    "global_slider10d_9n_min_s", "global_tt3d_r8_min_s",
    "global_bowl3d_9n_critical_points_s", "global_tt3d_r8_critical_points_s",
    "global_circle_line_solve_system_s", "ttmin10d_7n_r8_certified_min_s",
    "zeros_31n_3d_isolation_s", "zeros_25n_4d_isolation_s",
    "bs5d_to_tt_dd_book6_perdim_sets_per_sec",
    "bs5d_to_tt_dd_book6_grouped_sets_per_sec",
    "bs5d_11n_to_tt_perdim_dd_queries_per_sec",
    "bs5d_11n_to_tt_g221_dd_queries_per_sec",
    "bs5d_11n_to_tt_g122_dd_queries_per_sec",
    "bs5d_11n_to_tt_trim_perdim_dd_queries_per_sec",
    "bs5d_11n_to_tt_trim_grouped_dd_queries_per_sec",
    "bs5d_11n_to_tt_perdim_f32_queries_per_sec",
    "bs5d_11n_to_tt_grouped_f32_queries_per_sec",
    "highd_slider10d_9n_to_tt_dd_perdim_queries_per_sec",
    "highd_slider10d_9n_to_tt_dd_auto_queries_per_sec",
    "highd_slider14d_9n_to_tt_dd_perdim_queries_per_sec",
    "highd_slider14d_9n_to_tt_dd_auto_queries_per_sec",
    "highd_tt14d_7n_r8_dd_perdim_queries_per_sec",
    "highd_tt14d_7n_r8_dd_auto_queries_per_sec"]
#: The rows that run only host NumPy: host clock, the CPU named.
HOST_NUMPY = ["fit3d_9n_host_samples_per_sec",
              "ttfit5d_7n_r5_host_sample_sweeps_per_sec",
              "ttmin10d_7n_r8_certified_min_s", "zeros_31n_3d_isolation_s",
              "zeros_25n_4d_isolation_s"]


def dev(a, ref, floor=0.0) -> float:
    return bench.dev(np.asarray(a, dtype=np.float64), np.asarray(
        ref, dtype=np.float64), floor)


@contextlib.contextmanager
def one_thread():
    """PyTorch's and the BLAS pools at one thread: under six xdist
    workers a thread per core oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(threads)


# --- (a) the rehearsal -------------------------------------------------------


@pytest.fixture(scope="module")
def rehearsal():
    buf = io.StringIO()
    with one_thread(), contextlib.redirect_stdout(buf):
        rows = bench.main(device="cpu", small=True, reps=3)
    return rows, [json.loads(line) for line in buf.getvalue().splitlines()]


def test_every_row_is_there_with_every_key(rehearsal):
    rows, lines = rehearsal
    assert [r["metric"] for r in rows] == [f"rehearsal.{b}" for b in BASES]
    assert [line for line in lines if "metric" in line] == rows
    for row in rows:
        assert KEYS <= row.keys(), (row["metric"], KEYS - row.keys())
        assert row["device"] == "cpu"
        assert row["samples"] >= 1 and row["p75_ms"] >= row["median_ms"] > 0
    for base in bench.KERNEL_ROWS:
        row = rows[BASES.index(base)]
        # a CPU tensor runs the kernel's plain version: nothing launches
        assert row["launches"] == 0 and row["kernel_ms"] == "not measured"
    headline = rows[BASES.index("bs5d_11n_f32_batched_queries_per_sec")]
    assert headline["vs_baseline"] == pytest.approx(
        headline["value"] * bench.BASELINE_SINGLE_QUERY_S)
    assert "CPU" in headline["baseline"]
    assert BASES[:19] + NEW_BASES == BASES and len(BASES) == 73


def test_host_rows_time_the_host_and_name_its_cpu(rehearsal):
    rows, lines = rehearsal
    assert bench.HOST_ROWS == {b for b in NEW_BASES if b.endswith("_us")}
    setup = [line for line in lines if "setup" in line]
    assert [line["ok"] for line in setup] == [True]
    assert "hosteval.c" in setup[0]["setup"]
    for base in bench.HOST_ROWS:
        row = rows[BASES.index(base)]
        assert row["unit"] == "us" and row["n"] == 1
        assert row["calls"] >= bench.HOST_CALLS
        assert row["host_cpu"] == lines[0]["host_cpu"] == bench.host_cpu()
        assert row["value"] == pytest.approx(row["median_ms"] * 1e3)
    query = rows[BASES.index("bs5d_11n_host_query_us")]
    assert query["point"] == bench.QUERY_POINT
    assert {"price_err_mean_pct", "price_err_max_pct", "delta_err_max_pct",
            "gamma_err_max_pct", "vega_err_max_pct", "rho_err_max_pct",
            "theta_err_max_pct"} <= query.keys()
    tt = rows[BASES.index("bs5d_tt_r15_host_query_us")]
    assert tt["fd_points"] == 25
    assert tt["fd_delta_err_avg_pct"] < 1.0 and tt["fd_gamma_err_avg_pct"] < 5


def test_config_and_calculus_rows_report_their_fields(rehearsal):
    rows = dict(zip(BASES, rehearsal[0]))
    spline = rows["spline2d_17n_build_s"]
    assert spline["dispatch"] == "ChebyshevSpline" and spline["pieces"] == 2
    # the kink costs the global 17^2 tensor ~1e-2; the spline is exact
    assert spline["spline_max_abs"] <= 1e-12 < 1e-3 < spline["global_max_abs"]
    # two pieces, within MASKED_MAX_PIECES: the f32 engine masks
    assert rows["spline2d_17n_f32_queries_per_sec"]["route"] == "masked"
    slider = rows["slider10d_9n_build_s"]
    assert slider["n"] == 90 and slider["optimal_n1"] == 24
    assert slider["integral_rel_err"] <= 1e-12
    portfolio = rows["portfolio4d_tt_als_build_s"]
    assert portfolio["checks"]["orth_sweep_drift_rel"][1] == bench.F64
    assert rows["portfolio4d_run_completion_s"]["core0_moved"] >= 0.0
    assert rows["bs5d_11n_f64_box_integrals_per_sec"][
        "per_call_boxes_per_sec"] > 0
    assert rows["bs5d_11n_integrate_book_boxes_per_sec"]["models"] == 6
    assert rows["bs5d_11n_scenario_roots_per_sec"]["roots_found"] > 0
    assert rows["bs5d_11n_scenario_minima_per_sec"]["checks"][
        "value_vs_single"][0] <= bench.F64
    cpu = bench.host_cpu()
    for base in HOST_NUMPY:
        assert rows[base]["host_cpu"] == cpu
    for base in BASES:
        if base not in HOST_NUMPY and base not in bench.HOST_ROWS:
            assert "host_cpu" not in rows[base], base
    for base, limit in (("fit3d_9n_f32_samples_per_sec", bench.FIT_GRAM_F32),
                        ("fit3d_9n_dd_samples_per_sec", bench.FIT_GRAM_DD)):
        gram = rows[base]["checks"]["gram_vs_host_f64"]
        assert gram[1] == limit and gram[0] <= limit
    assert rows["fit3d_9n_host_samples_per_sec"]["ceiling"] == 2e-3
    tt_host = rows["ttfit5d_7n_r5_host_sample_sweeps_per_sec"]
    # one call on the host clock, as the builds are
    assert tt_host["samples"] == 1 and tt_host["sweeps"] == 1
    assert tt_host["rms"] == rows[
        "ttfit5d_7n_r5_device_sample_sweeps_per_sec"]["rms"]
    for base in NEW_BASES:
        if base.startswith("global_"):
            row = rows[base]
            assert {"certified", "gap", "boxes", "searches",
                    "device_box_stats"} <= row.keys(), base
            # the median seconds a call, the optimum beside it
            assert row["value"] == pytest.approx(row["median_ms"] / 1e3)
    for base in ("global_bowl3d_9n_min_s", "global_osc5d_21n_min_s",
                 "ttmin10d_7n_r8_certified_min_s"):
        assert np.isfinite(rows[base]["optimum"])
    assert rows["global_bowl3d_9n_min_s"]["certified"] is True
    assert rows["global_bowl3d_9n_min_s"]["searches"] == 1
    assert rows["global_slider10d_9n_min_s"]["searches"] == 0   # exact
    assert len(rows["global_circle_line_solve_system_s"]["roots"]) == 2
    assert rows["global_tt3d_r8_critical_points_s"]["kinds"] == [
        "minimum", "minimum", "saddle"]
    assert "witness" in rows["global_osc5d_21n_min_s"]
    tt_min = rows["ttmin10d_7n_r8_certified_min_s"]
    assert {"certified", "gap", "boxes", "witness", "ranks"} <= tt_min.keys()
    assert tt_min["boxes"] == tt_min["n"] > 0
    for base in ("zeros_31n_3d_isolation_s", "zeros_25n_4d_isolation_s"):
        row = rows[base]
        assert row["boxes"] >= row["critical_points"] > 0
        assert row["checks"]["critical_points_missed"] == [0, 0]
    for base in ("bs5d_to_tt_dd_book6_perdim_sets_per_sec",
                 "bs5d_to_tt_dd_book6_grouped_sets_per_sec"):
        assert rows[base]["models"] == 6
        assert rows[base]["checks"]["grouped_vs_perdim"][1] == bench.TO_TT
    assert rows["bs5d_11n_to_tt_g221_dd_queries_per_sec"]["groups"] == [
        2, 2, 1]
    trim = rows["bs5d_11n_to_tt_trim_perdim_dd_queries_per_sec"]
    assert trim["ranks"][1:-1] == trim["compression_diagnostics"][
        "bond_ranks"]
    assert trim["compression_diagnostics"]["grid_sup_dev"] <= trim[
        "sup_target"]
    for base in NEW_BASES:
        if base.startswith("highd_"):
            assert rows[base]["groups"] in (None, "auto")
            assert sum(rows[base]["auto_groups"]) in (10, 14)


@pytest.mark.parametrize("base", BASES)
def test_every_row_holds_its_ceiling(rehearsal, base):
    row = rehearsal[0][BASES.index(base)]
    assert row["ok"] is True, row
    assert 0.0 <= row["deviation"] <= row["ceiling"]


def test_header_busy_lines_and_last_line(rehearsal):
    rows, lines = rehearsal
    header, last = lines[0], lines[-1]
    assert header["card"] == "cpu" and header["seed"] == 0
    assert header["allow_tf32"] is False
    assert header["float32_matmul_precision"] == "highest"
    assert not any("busy_share" in line for line in lines)
    assert last == {"ok": True, "rows": len(BASES), "failed": []}
    assert bench.passed(rows)


def test_a_failing_row_fails_the_run_and_the_rest_still_print(monkeypatch):
    def broken(b, s):
        raise RuntimeError("broken row")

    monkeypatch.setattr(bench, "ROWS", (("first_row", broken),
                                        bench.ROWS[0]))
    buf = io.StringIO()
    with one_thread(), contextlib.redirect_stdout(buf):
        rows = bench.main(device="cpu", small=True, reps=1)
    assert [r["ok"] for r in rows] == [False, True]
    assert "broken row" in rows[0]["error"]
    last = json.loads(buf.getvalue().splitlines()[-1])
    assert last == {"ok": False, "rows": 2,
                    "failed": ["rehearsal.first_row"]}
    assert not bench.passed(rows)


def test_batches_are_bench_py_inputs_and_outgrow_the_l2():
    b = bench.Bench("cpu", False, 1, 0, "cpu")
    host = b.batches(1, lambda rng: bench.sample_points(1 << 20, rng=rng),
                     (1 << 20) * 5 * 4)
    assert len(host) == 3
    assert len(host) * (1 << 20) * 5 * 4 > bench.L2_BYTES
    np.testing.assert_array_equal(host[0], bench.sample_points(1 << 20, 1))
    assert not np.array_equal(host[0], host[1])
    boxes = b.batches(21, lambda rng: rng.uniform(size=(1 << 17, 7)),
                      (1 << 17) * 56)
    assert len(boxes) * (1 << 17) * 56 > bench.L2_BYTES
    # --seed S shifts every stream
    shifted = bench.Bench("cpu", False, 1, 3, "cpu").batches(
        1, lambda rng: bench.sample_points(8, rng=rng), 1 << 30)
    np.testing.assert_array_equal(shifted[0], bench.sample_points(8, 4))


# --- (b) scripts/perf_gate.py --cpu on the port ------------------------------

GATE_DOMAIN = [[80.0, 120.0], [90.0, 110.0], [0.25, 2.0], [0.1, 0.5],
               [0.01, 0.05]]
GATE = {"dense_dd_dev": 1e-10, "compression_grouped_dev": 1e-12,
        "compression_perdim_dev": 1e-12, "f32_dev": 2e-4,
        "tt_dd_integrate_dev": 1e-10, "dense_dd_partial_dev": 1e-10,
        "tt_dd_partial_dev": 1e-10}


@pytest.fixture(scope="module")
def inputs():
    """The gate's inputs (perf_gate.py:148-192): the 11^5 call, 8,192
    points from seed 7, 512 boxes and conditional points from seed
    11."""
    lo = np.array([b[0] for b in GATE_DOMAIN])
    hi = np.array([b[1] for b in GATE_DOMAIN])
    pts = lo + (hi - lo) * np.random.default_rng(7).uniform(
        0.02, 0.98, (8192, 5))
    brng = np.random.default_rng(11)
    blo = brng.uniform(lo, hi, (512, 5))
    bhi = brng.uniform(blo, hi[None, :], (512, 5))
    bxs = np.stack([blo, bhi], axis=-1)
    ppts = brng.uniform(lo[[1, 3, 4]], hi[[1, 3, 4]], (512, 3))
    return pts, bxs, bxs[:, [0, 2], :], ppts


@pytest.fixture(scope="module")
def port(inputs):
    pts, bxs, sub, ppts = inputs
    with one_thread():
        cheb = ChebyshevApproximation(bench.bs_price_np, 5, GATE_DOMAIN,
                                      [11] * 5, vectorized=True,
                                      device="cpu")
        cheb.build(verbose=False)
        tt = cheb.to_tt(tolerance=1e-13)
        ref = cheb.eval_batch(pts, derivative_order=[0] * 5)
        ib = tt.integrate_batch(bxs)
        p_ref = cheb.partial_integrate_batch([0, 2], sub, ppts)
        p_scale = np.abs(p_ref).max()
        got = {
            "dense_dd_dev": dev(cheb.eval_batch_dd(pts), ref),
            "compression_grouped_dev": dev(
                tt.eval_batch_dd(pts, groups="auto"), ref),
            "compression_perdim_dev": dev(
                tt.eval_batch_dd(pts, groups=None), ref),
            "f32_dev": dev(cheb.eval_batch_f32(pts), ref),
            "tt_dd_integrate_dev": dev(
                tt.integrate_batch(bxs, dtype="dd"), ib,
                np.abs(cheb.integrate_batch(bxs)).max()),
            "dense_dd_partial_dev": dev(
                cheb.partial_integrate_batch([0, 2], sub, ppts, dtype="dd"),
                p_ref),
            "tt_dd_partial_dev": dev(
                tt.partial_integrate_batch([0, 2], sub, ppts, dtype="dd"),
                tt.partial_integrate_batch([0, 2], sub, ppts), p_scale),
        }
    return cheb, tt, got


@pytest.mark.parametrize("name", sorted(GATE))
def test_perf_gate_invariants_on_the_port(port, name):
    assert port[2][name] <= GATE[name], (name, port[2][name])


# --- (c) the rows' calls against the JAX package ----------------------------


@pytest.fixture(scope="module")
def jax_models():
    with one_thread():
        return _jax_models()


def _jax_models():
    cheb = JaxApproximation(bench.bs_price_np, 5, GATE_DOMAIN, [11] * 5,
                            vectorized=True)
    cheb.build(verbose=False)
    tt = JaxTT(bench.bs_div_np, 5, bench.TT_DOMAIN, [11] * 5, max_rank=15,
               max_sweeps=10, tolerance=1e-6, vectorized=True)
    tt.build(verbose=False, seed=42)
    slider = JaxSlider(bench.basket_np, bench.SLIDER_D,
                       [[-1.0, 1.0]] * bench.SLIDER_D, [9] * bench.SLIDER_D,
                       [[i] for i in range(bench.SLIDER_D)],
                       [0.0] * bench.SLIDER_D, vectorized=True)
    slider.build(verbose=False)
    return cheb, tt, slider


@pytest.fixture(scope="module")
def port_models(port):
    with one_thread():
        tt = ChebyshevTT(bench.bs_div_np, 5, bench.TT_DOMAIN, [11] * 5,
                         max_rank=15, max_sweeps=10, tolerance=1e-6,
                         vectorized=True, device="cpu")
        tt.build(verbose=False, seed=42)
        slider = ChebyshevSlider(
            bench.basket_np, bench.SLIDER_D, [[-1.0, 1.0]] * bench.SLIDER_D,
            [9] * bench.SLIDER_D, [[i] for i in range(bench.SLIDER_D)],
            [0.0] * bench.SLIDER_D, vectorized=True, device="cpu")
        slider.build(verbose=False)
    return port[0], port[1], tt, slider


def test_tt_cross_matches_the_jax_package(jax_models, port_models):
    """bench.py's TT configuration (seed 42): the same ranks and unique
    evaluations, [1, 11, 11, 11, 7, 1] and 7,204."""
    jtt, tt = jax_models[1], port_models[2]
    assert tt.tt_ranks == jtt.tt_ranks == [1, 11, 11, 11, 7, 1]
    assert tt.total_build_evals == jtt.total_build_evals == 7204


def _rows(inputs, jax_models, port_models):
    """name -> (the port's call as a row makes it, the JAX package's f64
    call, ceiling), lazily."""
    pts, bxs, sub, ppts = inputs
    jcheb, jtt, jslider = jax_models
    cheb, comp, tt, slider = port_models
    grid = cheb._grid_tuples()
    jgrid = jcheb._grid_tuples()
    tpts = bench.sample_points(8192, 7, bench.TT_DOMAIN)
    dom = np.asarray(GATE_DOMAIN)
    tdom = np.asarray(bench.TT_DOMAIN)
    p = torch.from_numpy(pts)
    greeks = bench.GREEKS
    book = [1.0 + 0.1 * i for i in range(bench.BOOK)]
    jcomp = jcheb.to_tt(tolerance=1e-13)._cores_on_device(np.float64)
    comp64 = comp._cores_on_device(torch.float64)
    jdelta = jtt.differentiate([1, 0, 0, 0, 0])
    delta = tt.differentiate([1, 0, 0, 0, 0])
    spts = np.random.default_rng(11).uniform(-1, 1, (2048, bench.SLIDER_D))

    def j_dense(orders=(0,) * 5):
        return jax_eval.eval_batch(jcheb.tensor_values, *jgrid,
                                   jnp.asarray(pts), orders)

    return {
        "f32 plain": (lambda: eval_ops.eval_batch(
            cheb.tensor_values.float(), *(tuple(a.float() for a in g)
                                          for g in grid), p.float(),
            (0,) * 5), j_dense, bench.F32),
        "f32 K1 route": (lambda: fused_eval.fused_eval_batch(
            cheb.tensor_values, *grid, p.float()), j_dense, bench.F32),
        "f64": (lambda: eval_ops.eval_batch(cheb.tensor_values, *grid, p,
                                            (0,) * 5), j_dense, bench.F64),
        "f64 Delta": (lambda: eval_ops.eval_batch(
            cheb.tensor_values, *grid, p, (1, 0, 0, 0, 0)),
            lambda: j_dense((1, 0, 0, 0, 0)), bench.F64),
        "f64 price + 5 Greeks": (
            lambda: eval_ops.eval_batch_multi(cheb.tensor_values, *grid, p,
                                              greeks),
            lambda: jax_eval.eval_batch_multi(jcheb.tensor_values, *jgrid,
                                              jnp.asarray(pts), greeks),
            bench.F64),
        "f64 8-model book": (
            lambda: eval_ops.eval_batch_models(
                tuple(cheb.tensor_values * c for c in book), *grid, p,
                (0,) * 5),
            lambda: jax_eval.eval_batch_models(
                tuple(jcheb.tensor_values * c for c in book), *jgrid,
                jnp.asarray(pts), (0,) * 5), bench.F64),
        "dd (K3 route)": (lambda: eval_dd.eval_batch_dd(
            cheb.tensor_values, *grid, p, (0,) * 5), j_dense, bench.DD),
        "to_tt(1e-13) dd chain": (lambda: tt_eval_dd.tt_eval_batch_dd(
            comp64, dom, p, groups="auto"), j_dense, bench.TO_TT),
        "TT f64 chain": (
            lambda: tt_eval.tt_eval_batch(tt._cores_on_device(torch.float64),
                                          tdom, tpts),
            lambda: jax_tt_eval_batch(tuple(map(jnp.asarray,
                                                jtt._coeff_cores)),
                                      tdom, jnp.asarray(tpts)), bench.F64),
        "TT f64 Delta": (
            lambda: tt_eval.tt_eval_batch(
                delta._cores_on_device(torch.float64), tdom, tpts),
            lambda: jax_tt_eval_batch(tuple(map(jnp.asarray,
                                                jdelta._coeff_cores)),
                                      tdom, jnp.asarray(tpts)), bench.F64),
        "TT dd chain": (
            lambda: tt_eval_dd.tt_eval_batch_dd(
                tt._cores_on_device(torch.float64), tdom, tpts),
            lambda: jax_tt_eval_batch(tuple(map(jnp.asarray,
                                                jtt._coeff_cores)),
                                      tdom, jnp.asarray(tpts)), bench.DD),
        "TT dd bucket masses": (
            lambda: integrate.tt_integrate_box_batch_dd(comp64, dom, bxs,
                                                        groups="auto"),
            lambda: jax_integrate.tt_integrate_box_batch(
                jcomp, dom, jnp.asarray(bxs)), bench.DD),
        "dense dd conditional expectations": (
            lambda: integrate.partial_integrate_eval_batch_dd(
                cheb.tensor_values, dom, *grid, (0, 2), sub, ppts),
            lambda: jax_integrate.partial_integrate_eval_batch(
                jcheb.tensor_values, dom, *jgrid, (0, 2),
                jnp.asarray(sub), jnp.asarray(ppts)), bench.DD),
        "slider dd Greek report": (
            lambda: slider_eval.slider_multi_batch_dd(
                slider._slide_data(), slider.pivot_value, slider._groups(),
                bench.SLIDER_SPECS, spts).T,
            lambda: np.stack([jslider.eval_batch(spts, list(s))
                              for s in bench.SLIDER_SPECS]), bench.DD),
    }


@contextlib.contextmanager
def numpy_host_path(model):
    """A dense model's NumPy single-point path, in either package: its C
    pack set aside for the block."""
    h = model._host_arrays()
    pack = h.get("cpack", "absent")
    h["cpack"] = None
    try:
        yield
    finally:
        if pack == "absent":
            h.pop("cpack", None)
        else:
            h["cpack"] = pack


@pytest.fixture(scope="module")
def baseline_models():
    """Both packages' models of the new rows at rehearsal widths (the
    baseline table's config 1 at 9^5, config 3's spline, config 5's
    instruments, A again after ``run_completion``, and
    bench_integrate_batch.py's rank-capped cross at 9^5), as (JAX
    package's, port's) pairs."""
    w = bench.SMALL

    def instrument(fn, seed, complete=False):
        def build(m):
            m.build(verbose=False, method="als", seed=seed)
            if complete:
                m.run_completion(tolerance=1e-10, max_iter=5)

        return _pair(lambda cls, **kw: cls(
            fn, 4, bench.PORTFOLIO_DOMAIN, [9] * 4, max_rank=8,
            tolerance=1e-8, vectorized=True, **kw), build, JaxTT,
            ChebyshevTT)

    with one_thread():
        return {
            "div": _pair(lambda cls, **kw: cls(
                bench.bs_div_np, 5, bench.TT_DOMAIN, [w.nodes] * 5,
                vectorized=True, **kw), lambda m: m.build(verbose=False)),
            "spline": _pair(lambda cls, **kw: cls(
                bench.payoff_np, 2, bench.SPLINE_DOMAIN, bench.SPLINE_NODES,
                bench.SPLINE_KNOTS, vectorized=True, **kw),
                lambda m: m.build(verbose=False), JaxSpline, ChebyshevSpline),
            "tta": instrument(bench.instrument_a_np, 0),
            "ttb": instrument(bench.instrument_b_np, 1),
            "tta_completed": instrument(bench.instrument_a_np, 0, True),
            "script_tt": _pair(lambda cls, **kw: cls(
                bench.bs_price_np, 5, bench.DOMAIN, [w.nodes] * 5,
                max_rank=w.tt_rank, vectorized=True, **kw),
                lambda m: m.build(verbose=False, seed=42), JaxTT,
                ChebyshevTT),
        }


def _pair(make, build, jax_cls=JaxApproximation,
          port_cls=ChebyshevApproximation):
    ref, port = make(jax_cls), make(port_cls, device="cpu")
    build(ref)
    build(port)
    return ref, port


def _new_rows(inputs, jax_models, port_models, models):
    """name -> (the port's call as a new row makes it, the JAX package's
    call, ceiling[, absolute]), lazily.  Relative (scale-normalized) by
    default; absolute where a row holds an absolute error."""
    pts, bxs, sub, ppts = inputs
    jcheb, jtt, jslider = jax_models
    cheb, _, tt, slider = port_models
    jdiv, div = models["div"]
    jspline, spline = models["spline"]
    jstt, stt = models["script_tt"]
    query = np.vstack([bench.QUERY_POINT, bench.protocol_points(42)])
    dom = np.asarray(GATE_DOMAIN)
    few = bxs[:8]
    sp_pts = bench.sample_points(2048, 5, bench.SPLINE_DOMAIN,
                                 margin=bench.SPLINE_MARGIN)
    sl_pts = bench.sample_points(2048, 5, bench.SLIDER_DOMAIN)
    book = [cheb] + [cheb.differentiate(list(g)) for g in bench.GREEKS[1:]]
    jbook = [jcheb] + [jcheb.differentiate(list(g))
                       for g in bench.GREEKS[1:]]
    scen = bench.sample_points(bench.SMALL.scenarios, 72)
    fixed = {d: scen[:, d] for d in range(1, 5)}
    half = ChebyshevApproximation.from_values(
        cheb.differentiate([1, 0, 0, 0, 0]).tensor_values.numpy() - 0.5, 5,
        GATE_DOMAIN, [11] * 5, device="cpu")
    jhalf = JaxApproximation.from_values(
        np.asarray(jcheb.differentiate([1, 0, 0, 0, 0]).tensor_values)
        - 0.5, 5, GATE_DOMAIN, [11] * 5)
    gamma = cheb.differentiate([2, 0, 0, 0, 0])
    jgamma = jcheb.differentiate([2, 0, 0, 0, 0])
    g_scale = float(gamma.tensor_values.abs().max())

    def on(models, fn):
        return [fn(m, p) for m in models for p in query]

    def host_numpy(model, method, *args):
        with numpy_host_path(model):
            return [getattr(model, method)(p, *args) for p in query]

    def tt_fd(model):
        return [model.eval_multi(list(p), [s])[0] for p in query[:25]
                for s in ([1, 0, 0, 0, 0], [2, 0, 0, 0, 0])]

    def portfolio(a, k):
        """2A + B at config 5's 500 points, A from pair ``a``."""
        return (models[a][k] * 2.0 + models["ttb"][k]).eval_batch(
            bench.sample_points(500, 2, bench.PORTFOLIO_DOMAIN, margin=0.05))

    def minima(model, part):
        return model.minimize_batch(dim=0, fixed=fixed)[part]

    return {
        "host C query": (
            lambda: on([div], lambda m, p: m.vectorized_eval(p, [0] * 5)),
            lambda: on([jdiv], lambda m, p: m.vectorized_eval(p, [0] * 5)),
            0.0),
        "host NumPy query": (
            lambda: host_numpy(div, "vectorized_eval", [0] * 5),
            lambda: host_numpy(jdiv, "vectorized_eval", [0] * 5), 0.0),
        "host C price + 5 Greeks": (
            lambda: on([div], lambda m, p: m.vectorized_eval_multi(
                p, bench.GREEKS)),
            lambda: on([jdiv], lambda m, p: m.vectorized_eval_multi(
                p, bench.GREEKS)), 0.0),
        "host NumPy price + 5 Greeks": (
            lambda: host_numpy(div, "vectorized_eval_multi", bench.GREEKS),
            lambda: host_numpy(jdiv, "vectorized_eval_multi",
                               bench.GREEKS), 0.0),
        "host C to_tt(1e-13) query": (
            lambda: on([div.to_tt(tolerance=1e-13)],
                       lambda m, p: m.eval(p)),
            lambda: on([jdiv.to_tt(tolerance=1e-13)],
                       lambda m, p: m.eval(p)), 0.0),
        "host C TT query": (lambda: on([tt], lambda m, p: m.eval(p)),
                            lambda: on([jtt], lambda m, p: m.eval(p)), 0.0),
        "TT finite-difference Greeks": (lambda: tt_fd(tt),
                                        lambda: tt_fd(jtt), 0.0),
        "spline f64 class path": (
            lambda: spline.eval_batch(sp_pts, [0, 0]),
            lambda: jspline.eval_batch(sp_pts, [0, 0]), bench.F64),
        "spline f32 engine": (
            lambda: BatchedEvaluator(spline, dtype=torch.float32,
                                     device="cpu")(sp_pts),
            lambda: jspline.eval_batch(sp_pts, [0, 0]), bench.F32),
        "slider f32 engine": (
            lambda: BatchedEvaluator(slider, dtype=torch.float32,
                                     device="cpu")(sl_pts),
            lambda: jslider.eval_batch(sl_pts), bench.F32),
        "slider dd (native f64)": (
            lambda: slider_eval.slider_batch_dd(
                slider._slide_data(), slider.pivot_value, slider._groups(),
                sl_pts), lambda: jslider.eval_batch(sl_pts), bench.F64),
        "slider f64 engine": (
            lambda: BatchedEvaluator(slider, dtype=torch.float64,
                                     device="cpu")(sl_pts),
            lambda: jslider.eval_batch(sl_pts), bench.F64),
        "slider integrate()": (lambda: [slider.integrate()],
                               lambda: [jslider.integrate()], bench.F64),
        "get_optimal_n1": (
            lambda: [ChebyshevApproximation.get_optimal_n1(
                bench.auto_n_np, (-1.0, 1.0), 1e-10, device="cpu")],
            lambda: [JaxApproximation.get_optimal_n1(
                bench.auto_n_np, (-1.0, 1.0), 1e-10)], 0.0),
        "portfolio 2A + B": (lambda: portfolio("tta", 1),
                             lambda: portfolio("tta", 0), bench.F64),
        "portfolio after run_completion": (
            lambda: portfolio("tta_completed", 1),
            lambda: portfolio("tta_completed", 0), bench.F64),
        "dense f64 box integrals": (
            lambda: integrate.integrate_box_batch(cheb.tensor_values, dom,
                                                  bxs),
            lambda: jax_integrate.integrate_box_batch(
                jcheb.tensor_values, dom, jnp.asarray(bxs)), bench.F64),
        "dense f32 box integrals": (
            lambda: integrate.integrate_box_batch(
                cheb.tensor_values, dom, torch.from_numpy(bxs).float(),
                dtype=torch.float32),
            lambda: jax_integrate.integrate_box_batch(
                jcheb.tensor_values, dom, jnp.asarray(bxs)), bench.F32),
        "dense dd box integrals (native f64)": (
            lambda: integrate.integrate_box_batch_dd(cheb.tensor_values,
                                                     dom, bxs),
            lambda: jax_integrate.integrate_box_batch(
                jcheb.tensor_values, dom, jnp.asarray(bxs)), bench.DD),
        "per-call integrate(bounds=...)": (
            lambda: bench.per_call_integrals(cheb, few),
            lambda: jax_integrate.integrate_box_batch(
                jcheb.tensor_values, dom, jnp.asarray(few)), bench.F64),
        "TT f64 box integrals": (
            lambda: integrate.tt_integrate_box_batch(
                stt._cores_on_device(torch.float64), dom, bxs),
            lambda: jax_integrate.tt_integrate_box_batch(
                jstt._cores_on_device(np.float64), dom, jnp.asarray(bxs)),
            bench.F64),
        "dense f64 conditional expectations": (
            lambda: integrate.partial_integrate_eval_batch(
                cheb.tensor_values, dom, *cheb._grid_tuples(), (0, 2), sub,
                ppts),
            lambda: jax_integrate.partial_integrate_eval_batch(
                jcheb.tensor_values, dom, *jcheb._grid_tuples(), (0, 2),
                jnp.asarray(sub), jnp.asarray(ppts)), bench.F64),
        "TT dd conditional expectations (native f64)": (
            lambda: integrate.tt_partial_integrate_eval_batch_dd(
                stt._cores_on_device(torch.float64), dom, (0, 2), sub, ppts,
                groups="auto"),
            lambda: jax_integrate.tt_partial_integrate_eval_batch(
                jstt._cores_on_device(np.float64), dom, (0, 2),
                jnp.asarray(sub), jnp.asarray(ppts)), bench.DD),
        "integrate_book, price + 5 Greeks": (
            lambda: bench.integrate_book(book, bxs),
            lambda: jax_integrate_book(jbook, bxs), bench.F64),
        "scenario roots along S": (
            lambda: np.concatenate(half.roots_batch(dim=0, fixed=fixed)),
            lambda: np.concatenate(jhalf.roots_batch(dim=0, fixed=fixed)),
            bench.ROOTS_VS_SINGLE, True),
        "scenario minima along S, locations": (
            lambda: minima(gamma, 1), lambda: minima(jgamma, 1),
            bench.LOCATION_VS_SINGLE, True),
        # values over Gamma's max |value| on the grid, as the row holds
        # them (chip_smoke.py phase 31's bound)
        "scenario minima along S, values": (
            lambda: minima(gamma, 0) / g_scale,
            lambda: minima(jgamma, 0) / g_scale, bench.F64, True),
    }


@pytest.fixture(scope="module")
def script_models():
    """Both packages' models of the rest of scripts/ at rehearsal widths,
    as (JAX package's, port's) pairs: bench_global_calculus.py's, the
    10-D TT search's chain, the zero-isolation interpolants, the
    trimmed compression of the 9^5 call, the 10-D and 14-D basket
    sliders (full width: 9 nodes a dim)."""
    w = bench.SMALL
    k = w.search_nodes
    nodes, rank, _ = w.tt_search
    pairs = {
        "waves": (lambda cls, **kw: cls(
            bench.waves_np, 2, [[-1.5, 1.5], [-1, 2]], [k, k],
            vectorized=True, **kw), None),
        "bowl3": (lambda cls, **kw: cls(
            bench.bowl3_np, 3, [[-1, 1]] * 3, [9] * 3, vectorized=True,
            **kw), None),
        "osc5": (lambda cls, **kw: cls(
            bench.osc5_np, 5, [[-1, 1]] * 5, [k] * 5, vectorized=True,
            **kw), None),
        "spline": (lambda cls, **kw: cls(
            bench.kinked_np, 2, [[-1, 1], [-1, 1]], [[9, 9], [9]],
            knots=[[0.0], []], vectorized=True, **kw), "spline"),
        "slider": (lambda cls, **kw: cls(
            bench.bowl10_np, 10, [[-1, 1]] * 10, [9] * 10,
            partition=[[i] for i in range(10)], pivot_point=[0.0] * 10,
            vectorized=True, **kw), "slider"),
        "circle": (lambda cls, **kw: cls(
            bench.circle_np, 2, [[-1, 1]] * 2, [7, 7], vectorized=True,
            **kw), None),
        "line": (lambda cls, **kw: cls(
            bench.line_np, 2, [[-1, 1]] * 2, [7, 7], vectorized=True,
            **kw), None),
        "tt": (lambda cls, **kw: cls(
            bench.q3_np, 3, [[-1, 1]] * 3, [9] * 3, tolerance=1e-12,
            max_rank=8, vectorized=True, **kw), "tt"),
        "chain": (lambda cls, **kw: cls(
            bench.surrogate_np, 10, [[-1.0, 1.0]] * 10, [nodes] * 10,
            max_rank=rank, tolerance=1e-12, vectorized=True, **kw), "tt"),
        "basket14": (lambda cls, **kw: cls(
            bench.basket_np, 14, [[-1.0, 1.0]] * 14, [9] * 14,
            [[i] for i in range(14)], [0.0] * 14, vectorized=True, **kw),
            "slider"),
    }
    classes = {None: (JaxApproximation, ChebyshevApproximation),
               "spline": (JaxSpline, ChebyshevSpline),
               "slider": (JaxSlider, ChebyshevSlider),
               "tt": (JaxTT, ChebyshevTT)}
    with one_thread():
        out = {name: _pair(make, lambda m: m.build(verbose=False),
                           *classes[family])
               for name, (make, family) in pairs.items()}
        for case, (n, d, freq, _, _) in enumerate(w.zeros):
            out[f"zeros{case}"] = _pair(lambda cls, **kw: cls(
                bench.oscillating_np(freq), d, [[-1.0, 1.0]] * d, [n] * d,
                vectorized=True, **kw), lambda m: m.build(verbose=False))
    return out


def _grad_coeffs(model, d):
    return [globalcalc.dense_coeff_tensor(
        model.differentiate(spec).tensor_values)
        for spec in globalcalc._grad_specs(d)]


def _jax_host_gram(pts):
    """The dense fit's f64 Gram from the JAX package's design rows."""
    nodes = [nodes_for_dim_np(lo, hi, n)
             for (lo, hi), n in zip(bench.FIT_DOMAIN, bench.FIT_NODES)]
    design = jax_fitting._DimDesign(
        nodes, [barycentric_weights_np(x) for x in nodes])
    rows = np.asarray(jax_eval._khatri_rao(
        [design.rows(pts[:, k], k) for k in range(len(nodes))]))
    return rows.T @ rows


def _script_rows(inputs, jax_models, port_models, script):
    """name -> (the port's call as a row of the rest of scripts/ makes
    it, the JAX package's, ceiling[, absolute]), lazily."""
    w = bench.SMALL
    cheb, comp = port_models[0], port_models[1]
    jcheb = jax_models[0]
    fit = bench.fit_samples(bench.Bench("cpu", True, 1, 0, "cpu"), {})
    pts, y = fit["host"]
    sub_pts, sub_y = (a[:w.fit_subset] for a in fit["device"])
    tt_pts, tt_y = bench.tt_fit_samples(bench.Bench("cpu", True, 1, 0,
                                                    "cpu"), {})
    fit_kw = dict(l2=bench.FIT_L2, engine="host")
    tt_kw = dict(max_rank=5, sweeps=w.tt_fit_sweeps, l2=1e-8,
                 engine="host")
    block = [(sub_pts, (0, 0, 0), sub_y, np.ones(len(sub_y)))]
    nodes = [nodes_for_dim_np(lo, hi, n)
             for (lo, hi), n in zip(bench.FIT_DOMAIN, bench.FIT_NODES)]
    weights = [barycentric_weights_np(x) for x in nodes]
    design = fitting._DimDesign(nodes, weights)

    def gram(accumulate):
        return accumulate(block, nodes, weights, design, 729,
                          device="cpu")[0]

    def search(name, method="minimize", **kw):
        """The call on each package's model: the optimum, or the count of
        critical points and their values, over the port model's scale
        (bench.value_scale)."""
        jm, pm = script[name]
        scale = bench.value_scale(pm)

        def on(m):
            out = getattr(m, method)(**kw)
            if method == "minimize":
                return [out[0] / scale]
            return [len(out)] + [c.value / scale for c in out]
        return lambda: on(pm), lambda: on(jm), bench.GLOBAL_VS_CPU, True

    def tt_search(m):
        res = m([np.asarray(c, dtype=np.float64)
                 for c in script["chain"][1]._coeff_cores], tol=1e-9,
                max_boxes=w.tt_search[2])
        return [res.value, float(res.certified), res.boxes]

    def isolate(m, case):
        _, d, _, delta, max_boxes = w.zeros[case]
        return m(_grad_coeffs(script[f"zeros{case}"][1], d), delta=delta,
                 max_boxes=max_boxes)

    specs = [list(spec) for spec in bench.FIRST_ORDER]
    book = [comp] + [comp.differentiate(spec) for spec in specs]
    cores = [tuple(m._cores_on_device(torch.float64)) for m in book]
    dom = np.asarray(GATE_DOMAIN)
    bpts = bench.sample_points(512, 3)

    jbook = []

    def jax_book():
        """The JAX package's dd book (grouped "auto"), one compile for
        both of the port's routes."""
        if not jbook:
            jcomp = jcheb.to_tt(tolerance=1e-13)
            jbook.append(np.asarray(jax_tt_eval_dd.tt_eval_batch_dd_models(
                [tuple(m._cores_on_device(np.float64)) for m in [jcomp] + [
                    jcomp.differentiate(spec) for spec in specs]], dom,
                bpts, groups="auto")))
        return jbook[0]

    trims = {}

    def trimmed(m):
        if id(m) not in trims:
            trims[id(m)] = m.to_tt(tolerance=1e-13, sup_target=w.sup_target)
        return trims[id(m)]

    def chain_values(tt, n_dims):
        p = np.random.default_rng(11).uniform(-1, 1, (2048, n_dims))
        return tt.eval_batch(p)

    def slider10(pkg):
        return (jax_models[2], port_models[3])[pkg]

    def shapes(cores_):
        return [tuple(int(x) for x in c.shape) for c in cores_]

    return {
        "dense fit, host engine": (
            lambda: fitting.fit_dense_tensor(pts, y, bench.FIT_DOMAIN,
                                             bench.FIT_NODES, **fit_kw)[0],
            lambda: jax_fitting.fit_dense_tensor(
                pts, y, bench.FIT_DOMAIN, bench.FIT_NODES, **fit_kw)[0],
            0.0, True),
        "dense fit, f32 Gram": (
            lambda: gram(fitting._device_normal_accumulation),
            lambda: _jax_host_gram(sub_pts), bench.FIT_GRAM_F32),
        "dense fit, dd Gram": (
            lambda: gram(fitting._device_normal_accumulation_dd),
            lambda: _jax_host_gram(sub_pts), bench.FIT_GRAM_DD),
        "TT fit, host engine": (
            lambda: np.concatenate([c.ravel() for c in fitting.fit_tt_cores(
                tt_pts, tt_y, [[0.0, 1.0]] * 5, [7] * 5, **tt_kw)[0]]),
            lambda: np.concatenate([np.asarray(c).ravel() for c in
                                    jax_fitting.fit_tt_cores(
                tt_pts, tt_y, [[0.0, 1.0]] * 5, [7] * 5, **tt_kw)[0]]),
            0.0, True),
        "global waves minimize": search("waves", tol=1e-9),
        "global bowl3 minimize": search("bowl3", tol=1e-9),
        "global osc5 minimize": search("osc5", tol=1e-7,
                                       max_boxes=w.osc_boxes),
        "global spline minimize": search("spline", tol=1e-9),
        "global slider minimize": search("slider", tol=1e-9),
        "global TT minimize": search("tt", tol=1e-9),
        "global bowl3 critical_points": search("bowl3", "critical_points"),
        "global TT critical_points": search("tt", "critical_points"),
        "global solve_system": (
            lambda: bench.solve_system([script["circle"][1],
                                        script["line"][1]]),
            lambda: jax_solve_system([script["circle"][0],
                                      script["line"][0]]),
            bench.GLOBAL_VS_CPU, True),
        "minimize_tt_cores, 10-D chain": (
            lambda: tt_search(subdivision.minimize_tt_cores),
            lambda: tt_search(jax_subdivision.minimize_tt_cores), 0.0, True),
        "isolate_common_zeros, 3-D case": (
            lambda: isolate(subdivision.isolate_common_zeros, 0),
            lambda: isolate(jax_subdivision.isolate_common_zeros, 0), 0.0,
            True),
        "isolate_common_zeros, 4-D case": (
            lambda: isolate(subdivision.isolate_common_zeros, 1),
            lambda: isolate(jax_subdivision.isolate_common_zeros, 1), 0.0,
            True),
        "TT dd book, per-dim": (
            lambda: tt_eval_dd.tt_dd_book_runner(cores, dom,
                                                 groups=None)(bpts),
            jax_book, bench.DD),
        "TT dd book, grouped": (
            lambda: tt_eval_dd.tt_dd_book_runner(cores, dom,
                                                 groups="auto")(bpts),
            jax_book, bench.DD),
        "to_tt(sup_target) ranks": (
            lambda: trimmed(cheb).tt_ranks, lambda: trimmed(jcheb).tt_ranks,
            0.0, True),
        "to_tt(sup_target) values": (
            lambda: trimmed(cheb).eval_batch(inputs[0]),
            lambda: np.asarray(trimmed(jcheb).eval_batch(inputs[0])),
            bench.TO_TT),
        "10-D slider to_tt chain": (
            lambda: chain_values(slider10(1).to_tt(), 10),
            lambda: np.asarray(chain_values(slider10(0).to_tt(), 10)),
            bench.DD),
        "14-D slider to_tt chain": (
            lambda: chain_values(script["basket14"][1].to_tt(), 14),
            lambda: np.asarray(chain_values(script["basket14"][0].to_tt(),
                                            14)), bench.DD),
        "tt_dd_auto_groups, 10-D slider": (
            lambda: tt_eval_dd.tt_dd_auto_groups(shapes(
                slider10(1).to_tt()._coeff_cores)),
            lambda: jax_tt_eval_dd.tt_dd_auto_groups(tuple(shapes(
                slider10(0).to_tt()._coeff_cores))), 0.0, True),
        "tt_dd_auto_groups, 14-D slider": (
            lambda: tt_eval_dd.tt_dd_auto_groups(shapes(
                script["basket14"][1].to_tt()._coeff_cores)),
            lambda: jax_tt_eval_dd.tt_dd_auto_groups(tuple(shapes(
                script["basket14"][0].to_tt()._coeff_cores))), 0.0, True),
    }


SCRIPT_CALLS = [
    "dense fit, host engine", "dense fit, f32 Gram", "dense fit, dd Gram",
    "TT fit, host engine", "global waves minimize", "global bowl3 minimize",
    "global osc5 minimize", "global spline minimize",
    "global slider minimize", "global TT minimize",
    "global bowl3 critical_points", "global TT critical_points",
    "global solve_system", "minimize_tt_cores, 10-D chain",
    "isolate_common_zeros, 3-D case", "isolate_common_zeros, 4-D case",
    "TT dd book, per-dim", "TT dd book, grouped", "to_tt(sup_target) ranks",
    "to_tt(sup_target) values", "10-D slider to_tt chain",
    "14-D slider to_tt chain", "tt_dd_auto_groups, 10-D slider",
    "tt_dd_auto_groups, 14-D slider"]


ROW_CALLS = ["f32 plain", "f32 K1 route", "f64", "f64 Delta",
             "f64 price + 5 Greeks", "f64 8-model book", "dd (K3 route)",
             "to_tt(1e-13) dd chain", "TT f64 chain", "TT f64 Delta",
             "TT dd chain", "TT dd bucket masses",
             "dense dd conditional expectations", "slider dd Greek report",
             "host C query", "host NumPy query", "host C price + 5 Greeks",
             "host NumPy price + 5 Greeks", "host C to_tt(1e-13) query",
             "host C TT query", "TT finite-difference Greeks",
             "spline f64 class path", "spline f32 engine",
             "slider f32 engine", "slider dd (native f64)",
             "slider f64 engine", "slider integrate()", "get_optimal_n1",
             "portfolio 2A + B", "portfolio after run_completion",
             "dense f64 box integrals", "dense f32 box integrals",
             "dense dd box integrals (native f64)",
             "per-call integrate(bounds=...)", "TT f64 box integrals",
             "dense f64 conditional expectations",
             "TT dd conditional expectations (native f64)",
             "integrate_book, price + 5 Greeks", "scenario roots along S",
             "scenario minima along S, locations",
             "scenario minima along S, values"] + SCRIPT_CALLS


@pytest.fixture(scope="module")
def row_calls(inputs, jax_models, port_models, baseline_models,
              script_models):
    with one_thread():
        return {**_rows(inputs, jax_models, port_models),
                **_new_rows(inputs, jax_models, port_models,
                            baseline_models),
                **_script_rows(inputs, jax_models, port_models,
                               script_models)}


@pytest.mark.parametrize("name", ROW_CALLS)
def test_row_calls_match_the_jax_package(row_calls, name):
    port_fn, jax_fn, ceiling, *absolute = row_calls[name]
    with one_thread():
        got = np.asarray(port_fn(), dtype=np.float64)
        want = np.asarray(jax_fn(), dtype=np.float64)
    assert got.shape == want.shape
    if absolute:
        d = float(np.abs(got - want).max())
    else:
        # each row of a multi-output call on its own scale
        got, want = got.reshape(-1, got.shape[-1]), want.reshape(
            -1, want.shape[-1])
        d = max(dev(g, w, 1e-3) for g, w in zip(got, want))
    assert d <= ceiling, (name, d)


def test_auto_groups_of_the_14d_rank8_chain():
    """bench_highd_grouping.py's 14-D rank-8 chain at full shape: the
    packages plan "auto" by different rules.  The JAX package's DP
    scores the TPU's matrix unit and pairs the cores; the port picks
    the grouping that moves the fewest intermediate elements a point
    (``ops.tt_eval_dd._elements_moved``), which is the per-dim chain
    here, as its 12-core enumeration cap would give anyway."""
    shapes = tuple((1 if k == 0 else 8, 7, 1 if k == 13 else 8)
                   for k in range(14))
    jax_groups = jax_tt_eval_dd.tt_dd_auto_groups(shapes)
    assert jax_groups == (2,) * 7
    assert tt_eval_dd.tt_dd_auto_groups(shapes) == (1,) * 14
    assert tt_eval_dd._elements_moved(shapes, (1,) * 14) < \
        tt_eval_dd._elements_moved(shapes, jax_groups)


def test_portfolio_als_builds_are_bitwise_the_jax_packages(baseline_models):
    """Config 5's rank-adaptive TT-ALS: the port's ALS is a copy of the
    JAX package's host NumPy, so each instrument's ranks and cores are
    bitwise equal, and so are 2A + B's errors against its closed
    form."""
    for name in ("tta", "ttb"):
        ref, port = baseline_models[name]
        assert port.tt_ranks == ref.tt_ranks
        for a, c in zip(port._coeff_cores, ref._coeff_cores):
            np.testing.assert_array_equal(a, np.asarray(c))
    pts = bench.sample_points(500, 2, bench.PORTFOLIO_DOMAIN, margin=0.05)
    exact = 2.0 * bench.instrument_a_np(pts) + bench.instrument_b_np(pts)
    errs = [dev(np.asarray((a * 2.0 + b).eval_batch(pts)), exact)
            for a, b in zip(baseline_models["tta"], baseline_models["ttb"])]
    assert errs[0] == errs[1] <= bench.PORTFOLIO_ERR


# --- (d) no card -------------------------------------------------------------


@pytest.mark.parametrize("entry", ["main", "command line"])
def test_refuses_without_a_card(monkeypatch, capsys, entry):
    """Decided by ``torch.cuda.is_available()`` at the call, never at
    import; a message as the exit code is exit status 1."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        if entry == "main":
            bench.main(device="cuda")
        else:
            bench.cli([])
    assert "no CUDA card" in str(exc.value.code)
    assert capsys.readouterr().out == ""


# --- (e) --rows --------------------------------------------------------------


def test_rows_runs_exactly_the_rows_a_prefix_names(capsys):
    """A prefix selects its rows in ``ROWS`` order, each runs without the
    rows before it (the shared models are built on demand), and the
    last line counts the rows selected."""
    with one_thread():
        rows = bench.main(device="cpu", small=True, reps=1,
                          rows=["spline2d_"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["metric"] for r in rows] == [
        "rehearsal.spline2d_17n_build_s",
        "rehearsal.spline2d_17n_f64_queries_per_sec",
        "rehearsal.spline2d_17n_f32_queries_per_sec"]
    assert lines[-1] == {"ok": True, "rows": 3, "failed": []}
    assert bench.passed(rows, 3) and not bench.passed(rows)
    assert [base for base, _ in bench.select(["bs5d_11n_scenario_"])] == [
        "bs5d_11n_scenario_roots_per_sec", "bs5d_11n_scenario_minima_per_sec"]
    # the new prefixes select their own rows and no older prefix grows
    assert [base for base, _ in bench.select(["highd_"])] == [
        b for b in NEW_BASES if b.startswith("highd_")] and len(
            bench.select(["highd_"])) == 6
    assert [base for base, _ in bench.select(["slider10d_9n_"])] == [
        "slider10d_9n_dd_greek_report_sets_per_sec", "slider10d_9n_build_s",
        "slider10d_9n_f32_queries_per_sec", "slider10d_9n_dd_queries_per_sec",
        "slider10d_9n_f64_queries_per_sec"]
    for prefix, count in (("fit3d_", 3), ("ttfit5d_", 2), ("global_", 9),
                          ("ttmin10d_", 1), ("zeros_", 2),
                          ("bs5d_to_tt_dd_book6_", 2),
                          ("bs5d_11n_to_tt_", 9)):
        assert len(bench.select([prefix])) == count, prefix
    assert bench.select(None) is bench.ROWS
    with pytest.raises(SystemExit, match="names no row"):
        bench.select(["bs5d_11n_f32_plain", "no_such_row"])
    with one_thread():
        assert bench.cli(["--device", "cpu", "--small", "--reps", "1",
                          "--rows", "bs5d_11n_f64_box,slider10d_9n_dd_q"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [line["metric"] for line in lines if "metric" in line] == [
        "rehearsal.slider10d_9n_dd_queries_per_sec",
        "rehearsal.bs5d_11n_f64_box_integrals_per_sec"]
    assert lines[-1] == {"ok": True, "rows": 2, "failed": []}

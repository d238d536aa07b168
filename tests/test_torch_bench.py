"""``bench_torch.py``, the port's benchmark, on the CPU.

(a) Its rehearsal, ``main(device="cpu", small=True)``: every row, every
key, every ceiling, and the last line.  (b) The CPU accuracy gate of
``scripts/perf_gate.py --cpu`` (``gate_cpu``) on the port, at the gate's
own inputs and ceilings.  (c) The same inputs through the JAX package:
the calls the rows make, held to the JAX package's f64 calls (its dd
paths are not the yardstick; ROADMAP.md queue 3), and the rank-15
cross's ranks and evaluation count.  (d) No card: ``main`` and the
command line refuse, naming the cause.
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
from pychebyshev_tpu import ChebyshevTT as JaxTT
from pychebyshev_tpu.ops import eval as jax_eval
from pychebyshev_tpu.ops import integrate as jax_integrate
from pychebyshev_tpu.ops.tt_eval import tt_eval_batch as jax_tt_eval_batch
from pychebyshev_tpu_torch import (
    ChebyshevApproximation,
    ChebyshevSlider,
    ChebyshevTT,
)
from pychebyshev_tpu_torch.ops import eval as eval_ops
from pychebyshev_tpu_torch.ops import (
    eval_dd,
    fused_eval,
    integrate,
    slider_eval,
    tt_eval,
    tt_eval_dd,
)

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
    busy = [line for line in lines if "busy_share" in line]
    timed = [r["metric"] for r in rows if not r["metric"].endswith("_s")]
    kernel_rows = [f"rehearsal.{base}" for base in bench.KERNEL_ROWS]
    # the kernel rows are traced first, then the rest in the rows' order
    assert [line["of"] for line in busy] == kernel_rows + [
        m for m in timed if m not in kernel_rows]
    assert all(line["busy_share"] == "not measured" for line in busy)
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


ROW_CALLS = ["f32 plain", "f32 K1 route", "f64", "f64 Delta",
             "f64 price + 5 Greeks", "f64 8-model book", "dd (K3 route)",
             "to_tt(1e-13) dd chain", "TT f64 chain", "TT f64 Delta",
             "TT dd chain", "TT dd bucket masses",
             "dense dd conditional expectations", "slider dd Greek report"]


@pytest.fixture(scope="module")
def row_calls(inputs, jax_models, port_models):
    with one_thread():
        return _rows(inputs, jax_models, port_models)


@pytest.mark.parametrize("name", ROW_CALLS)
def test_row_calls_match_the_jax_package(row_calls, name):
    port_fn, jax_fn, ceiling = row_calls[name]
    with one_thread():
        got = np.asarray(port_fn(), dtype=np.float64)
        want = np.asarray(jax_fn(), dtype=np.float64)
    assert got.shape == want.shape
    # each row of a multi-output call on its own scale
    got, want = got.reshape(-1, got.shape[-1]), want.reshape(
        -1, want.shape[-1])
    d = max(dev(g, w, 1e-3) for g, w in zip(got, want))
    assert d <= ceiling, (name, d)


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

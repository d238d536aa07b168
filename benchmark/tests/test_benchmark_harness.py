"""The harness: the cells resolve from their files, BENCHMARK.json keeps
the contract's shape, a rehearsal run prints its line, a run without a
card prints nothing, the work counts follow from the shapes, nothing
imports JAX or the JAX package, and a run whose timed path is broken
reads ``correct`` false."""

import ast
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import cells, roofline

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
ONE_CARD = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
# Cells that PERF.md's open questions hold back, whose files (traffic,
# configuration, limits) the benchmark keeps: the tests run them as the
# cells they would be, with the metrics of the dense one-card cell.
KEPT = [{"name": "bs5d_11n.greeks6_2p17_f32", "config": "bs5d_11n",
         "traffic": "greeks6_2p17_f32", "chips": 1,
         "why": "the sensitivities report on the plain multi-model route"},
        {"name": "bs5d_11n_dp4.risk_2p22_f32", "config": "bs5d_11n_dp4",
         "traffic": "risk_2p22_f32", "chips": 4,
         "why": "the dp shard, K1 on each card and the all_gather"}]
KEPT_ONE_CARD = [k["name"] for k in KEPT if k["chips"] == 1]
MULTI_CARD = [k["name"] for k in KEPT if k["chips"] > 1]


@pytest.fixture
def with_kept_cells(monkeypatch):
    bench = json.loads(json.dumps(BENCH))
    for kept in KEPT:
        bench["workloads"].append(kept)
        bench["configs"].append({"name": kept["config"],
                                 "file": f"benchmark/configs/"
                                         f"{kept['config']}.json"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "bs5d_11n.risk_2p20_f32" in m["workloads"]:
            m["workloads"] += [k["name"] for k in KEPT]
    real = cells.resolve
    monkeypatch.setattr(cells, "resolve",
                        lambda name, bench_=None: real(name, bench))


def run_cli(*args, env=None, timeout=240):
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, env=env)


def last_line(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


# --- BENCHMARK.json and the cells' files --------------------------------


def test_benchmark_json_has_the_contracts_keys_and_limits():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert (runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
            <= 43200)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = set()
    for c in BENCH["configs"]:
        assert list(c) == ["name", "source", "file", "reduced", "why"]
        assert c["file"].startswith("benchmark/")
        assert c["source"].startswith("https://")
    for w in BENCH["workloads"]:
        assert list(w) == ["name", "config", "traffic", "chips", "why"]
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in BENCH["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    e2e = {e["name"] for e in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for p in BENCH["per_layer"]:
        assert p["moves"] in e2e
        assert p["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in p.get("workloads", CELLS):
            reporting = next(e for e in BENCH["end_to_end"]
                             if e["name"] == p["moves"])
            assert w in reporting.get("workloads", CELLS)
    for entry in (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
                  + BENCH["per_layer"]):
        assert NAME.match(entry["name"]), entry["name"]
        assert entry["name"] not in names
        names.add(entry["name"])
        for key in ("why", "layer", "source"):
            text = entry.get(key, "x")
            assert 1 <= len(text) <= 200, text
            assert "\n" not in text and "\t" not in text, text
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_resolves_from_its_files(workload):
    cell = cells.resolve(workload)
    entry = next(w for w in BENCH["workloads"] if w["name"] == workload)
    config = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert cell.config["name"] == config["name"]
    assert cell.config["reduced"] == config["reduced"]
    assert cell.chips == entry["chips"] == cell.config["chips"]
    assert set(cell.checks) == {f"dev.{n}"
                                for n in cell.traffic["spec_names"]}
    assert len(cell.traffic["specs"]) == len(cell.traffic["spec_names"])
    names = {m.name for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    from benchmark import run
    assert names <= set(run.MEASURED)
    assert cell.per_layer and all(callable(m.reader) for m in cell.per_layer)
    cells.function(cell.config["function"])
    for b in cell.traffic["bucket_sizes"]:
        assert b % cell.chips == 0
    assert cell.traffic["points_per_request"] <= cell.traffic[
        "bucket_sizes"][-1]


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.resolve("no_such.cell")


def test_every_file_under_the_benchmark_is_named_from_name_letters():
    for path in HERE.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


# --- work counts --------------------------------------------------------


def hand_counts(config, tests=HERE / "tests"):
    """The work a configuration's file should state, counted by hand:
    a dense grid's values, a tensor train core by core (a ``ranks``
    key), a book (``models`` and ``member``) as M times its member with
    M outputs a point.  Any other kind is counted by the ``hand_counts``
    of ``tests/test_counts_<kind>.py``, a test file of its own; where
    there is none, the count fails and names the file."""
    n = config["n_nodes"]
    rep = config["representation"]
    if "member" in rep:
        member = hand_counts(dict(config, representation=rep["member"]),
                             tests)
        models = rep["models"]
        return {"flop_per_point": models * member["flop_per_point"],
                "coefficients": models * member["coefficients"],
                "outputs_per_point": models
                * member.get("outputs_per_point", 1)}
    if rep["kind"] == "dense":
        size = 1
        for k in n:
            size *= k
        return {"flop_per_point": 2 * size, "coefficients": size}
    if "ranks" in rep:
        r = rep["ranks"]
        flop = coef = 0
        for k in range(len(n)):
            flop += 2 * r[k] * n[k] * r[k + 1]
            coef += r[k] * n[k] * r[k + 1]
        return {"flop_per_point": flop, "coefficients": coef}
    path = tests / f"test_counts_{rep['kind']}.py"
    if not path.is_file():
        pytest.fail(f"no hand count of the kind {rep['kind']!r}: add "
                    f"benchmark/tests/{path.name} with hand_counts(config) "
                    f"and tests of its own", pytrace=False)
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"benchmark.tests._counts_{rep['kind']}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.hand_counts(config)


@pytest.mark.parametrize("workload", CELLS)
def test_work_counts_follow_from_the_shapes_and_ranks(workload):
    config = cells.resolve(workload).config
    assert config["work"] == hand_counts(config)
    assert roofline.work_counts(config) == config["work"]


def test_a_kind_counted_by_no_hand_names_the_file_it_needs(tmp_path):
    config = cells.load_json(HERE / "configs" / "bs5d_11n.json")
    config["representation"] = {"kind": "spline"}
    with pytest.raises(pytest.fail.Exception,
                       match=r"benchmark/tests/test_counts_spline\.py"):
        hand_counts(config, tmp_path)
    # and a book of such a kind asks for its member's file
    config["representation"] = {"kind": "book", "models": 4,
                                "member": {"kind": "slider"}}
    with pytest.raises(pytest.fail.Exception,
                       match=r"test_counts_slider\.py"):
        hand_counts(config, tmp_path)


def test_the_count_defers_to_the_kind_s_own_test_file(tmp_path):
    (tmp_path / "test_counts_spline.py").write_text(
        "def hand_counts(config):\n"
        "    return {'flop_per_point': 7, 'coefficients': 3}\n")
    config = cells.load_json(HERE / "configs" / "bs5d_11n.json")
    config["representation"] = {"kind": "spline"}
    assert hand_counts(config, tmp_path) == {"flop_per_point": 7,
                                             "coefficients": 3}
    config["representation"] = {"kind": "book", "models": 5,
                                "member": {"kind": "spline"}}
    assert hand_counts(config, tmp_path) == {
        "flop_per_point": 35, "coefficients": 15, "outputs_per_point": 5}


@pytest.mark.parametrize("path", sorted(
    p.name for p in (HERE / "configs").glob("*.json")))
def test_each_representation_file_counts_its_configurations_work(path):
    """Every configuration the benchmark keeps, in a cell or not: its
    representation's file gives the work its file states."""
    config = cells.load_json(HERE / "configs" / path)
    rep = cells.representation(config)
    assert rep.work_counts(config) == config["work"]
    assert callable(rep.build) and callable(rep.reference)


def test_dense_work_is_the_first_contraction_and_tt_is_its_chain():
    dense = cells.resolve("bs5d_11n.risk_2p20_f32").config
    tt = cells.resolve("bs5d_11n_to_tt.risk_2p20_f32").config
    assert dense["work"]["flop_per_point"] == 2 * 11 ** 5 == 322102
    assert tt["work"]["flop_per_point"] == 2 * (
        1 * 11 * 11 + 11 * 11 * 25 + 25 * 11 * 54 + 54 * 11 * 9 + 9 * 11)


def test_least_time_of_the_dense_cell_is_compute_bound():
    cell = cells.resolve("bs5d_11n.risk_2p20_f32")
    n = cell.traffic["points_per_request"]
    least = roofline.least_seconds(cell.config, cell.traffic, n, 1,
                                   "NVIDIA H100 80GB HBM3")
    assert least == pytest.approx(322102 * n / 495e12)
    assert roofline.least_seconds(cell.config, cell.traffic, n, 1,
                                  "cpu") is None


def book3(config):
    """``config`` as a book of three of its products."""
    book = dict(config, representation={
        "kind": "book", "models": 3, "member": config["representation"]})
    book["work"] = hand_counts(book)
    return book


def test_a_book_of_three_writes_three_outputs_a_point(monkeypatch):
    cell = cells.resolve("bs5d_11n.risk_2p20_f32")
    book = book3(cell.config)
    assert book["work"] == {"flop_per_point": 3 * 322102,
                            "coefficients": 3 * 161051,
                            "outputs_per_point": 3}
    n, requests = 1 << 20, 2
    moved = roofline.bytes_moved(book, cell.traffic, n, requests)
    assert moved == 4 * (n * (5 + 3) + requests * 3 * 161051)
    assert moved - roofline.bytes_moved(
        dict(book, work=dict(book["work"], outputs_per_point=1)),
        cell.traffic, n, requests) == 4 * n * 2
    # bound by its FLOP at this size, by its bytes where the peak FLOP/s
    # were far higher
    h100 = "NVIDIA H100 80GB HBM3"
    assert roofline.least_seconds(book, cell.traffic, n, requests,
                                  h100) == 3 * 322102 * n / 495e12
    fast = {"flop_per_s": {"float32": 1e30}, "bytes_per_s": 3.35e12}
    monkeypatch.setattr(roofline, "peaks", lambda kind: fast)
    assert roofline.least_seconds(book, cell.traffic, n, requests,
                                  h100) == moved / 3.35e12


# The parent's formulas, before a point could have several outputs.
def _parent_least_seconds(config, traffic, points, requests, peak):
    specs = len(traffic["specs"])
    itemsize = cells.tier(traffic)["itemsize"]
    flop = config["work"]["flop_per_point"] * specs * points
    flop_s = flop / peak["flop_per_s"][cells.tier(traffic)["peak"]]
    moved = itemsize * (points * (config["dims"] + specs)
                        + requests * specs * config["work"]["coefficients"])
    return max(flop_s, moved / peak["bytes_per_s"]), flop_s


# The cells whose points have one output a spec: every cell before books.
ONE_OUTPUT = [w["name"] for w in BENCH["workloads"] + KEPT
              if "outputs_per_point" not in cells.load_json(
                  HERE / "configs" / f"{w['config']}.json")["work"]]


@pytest.mark.parametrize("workload", ONE_OUTPUT)
def test_the_existing_cells_read_as_the_parent_s_formulas(
        with_kept_cells, workload):
    """Work, least time, the readers of both, and the comparison of a
    one-model output: the same numbers, number for number."""
    from benchmark import correctness, tracing
    from benchmark.reference.interpolant import Interpolant, deviation
    cell = cells.resolve(workload)
    h100 = "NVIDIA H100 80GB HBM3"
    peak = roofline.peaks(h100)
    for points, requests in ((1 << 20, 1), (1 << 22, 24), (4096, 3)):
        least, flop_s = _parent_least_seconds(cell.config, cell.traffic,
                                              points, requests, peak)
        assert roofline.least_seconds(cell.config, cell.traffic, points,
                                      requests, h100) == least
        assert roofline.flop_seconds(cell.config, cell.traffic, points,
                                     h100) == flop_s
    record = tracing.Record(
        requests=24, points_per_request=cell.traffic["points_per_request"],
        window_us=2.5e5, busy_us=2.2e5, engine_busy_us=2.1e5,
        engine_ops=48, device_ops=50, counted_in_trace=24,
        counted_by_program=24, device_kind=h100)
    least, flop_s = _parent_least_seconds(
        cell.config, cell.traffic, 24 * record.points_per_request, 24, peak)
    assert cells.reader("eval_roofline")(record, cell) == (
        100.0 * least / (record.engine_busy_us * 1e-6))
    assert cells.reader("step_mfu")(record, cell) == (
        100.0 * flop_s / (record.window_us * 1e-6))
    # a one-model output is judged as before: max |got - ref| / max |ref|
    ref = Interpolant(lambda p: (np.exp(p[:, 0]) * (1 + p[:, 1])
                                 + p[:, 2] * p[:, 3] + p[:, 4] * p[:, 0]),
                      [(0.5, 1.5)] * 5, [3] * 5, device="cpu")
    traffic = dict(cell.traffic, **cell.traffic["rehearsal"])
    gen = torch.Generator().manual_seed(3)
    points = 0.5 + torch.rand((64, 5), generator=gen, dtype=torch.float64)
    exact = {tuple(s): ref.evaluate(points, s) for s in traffic["specs"]}
    noisy = torch.stack([v * (1 + 1e-5 * torch.randn(
        v.shape, generator=gen, dtype=torch.float64))
        for v in exact.values()], dim=-1).to(torch.float32)
    output = noisy[:, 0] if len(exact) == 1 else noisy
    numbers = correctness.deviations(ref, traffic, [(0, points, output)])
    columns = [output] if len(exact) == 1 else [
        output[:, m] for m in range(len(exact))]
    assert numbers == {
        f"dev.{name}": deviation(col.reshape(-1), e)
        for name, col, e in zip(traffic["spec_names"], columns,
                                exact.values())}
    assert all(0 < v < 1e-4 for v in numbers.values())


@pytest.mark.parametrize("metric,want", [
    ("device_idle_share", 0.2), ("launches_per_request", 2.5),
    ("eval_roofline", 100 * 322102 * 4096 * 2 / 495e12 / 4e-3),
    ("step_mfu", 100 * 322102 * 4096 * 2 / 495e12 / 5e-3),
    ("serve_host_us", 140.0), ("route_host_us", 190.0),
    ("port_idle_share", 0.15), ("host_syncs_per_request", 0.0)])
def test_each_reader_reads_its_record(metric, want):
    from benchmark import tracing
    cell = cells.resolve("bs5d_11n.risk_2p20_f32")
    record = tracing.Record(
        requests=2, points_per_request=4096, window_us=5000.0,
        busy_us=4000.0, engine_busy_us=4000.0, engine_ops=5, device_ops=5,
        counted_in_trace=2, counted_by_program=2,
        device_kind="NVIDIA H100 80GB HBM3", serve_host_us=140.0,
        route_host_us=190.0, port_idle_share=0.15,
        host_syncs_per_request=0.0)
    assert cells.reader(metric)(record, cell) == pytest.approx(want)
    record.device_kind = "cpu"
    if metric in ("eval_roofline", "step_mfu"):
        assert cells.reader(metric)(record, cell) is None
    # a record without the port's spans reads nothing of them
    bare = tracing.Record(
        requests=2, points_per_request=4096, window_us=5000.0,
        busy_us=4000.0, engine_busy_us=4000.0, engine_ops=5, device_ops=5,
        counted_in_trace=2, counted_by_program=2)
    if metric in ("serve_host_us", "route_host_us", "port_idle_share",
                  "host_syncs_per_request"):
        assert cells.reader(metric)(bare, cell) is None


def _trace(kernels, name="k", launches=(0, 1)):
    """Two requests' spans, a launch in each call whose correlation id is
    in ``launches``, and the device operations, named ``name``, of the
    launches whose correlation ids are in ``kernels``."""
    ev = []
    for i, t in enumerate((0.0, 100.0)):
        ev += [{"ph": "X", "cat": "user_annotation", "name": "engine.call",
                "ts": t, "dur": 10.0},
               {"ph": "X", "cat": "user_annotation", "name": "sync",
                "ts": t + 10.0, "dur": 40.0}]
        if i in launches:
            ev.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": t + 5.0, "dur": 1.0,
                       "args": {"correlation": i}})
        if i in kernels:
            ev.append({"ph": "X", "cat": "kernel", "name": name,
                       "ts": t + 8.0, "dur": 30.0,
                       "args": {"correlation": i}})
    return {"traceEvents": ev}


K4 = "void (anonymous namespace)::fused_tt_kernel<5>(float const*)"


@pytest.mark.parametrize("kernels,unmatched,name,counted,launches", [
    ((0, 1), 0, "k", 0, (0, 1)), ((0,), 1, "k", 0, (0, 1)),
    ((0, 1), 0, K4, 2, (0, 1)), ((0,), 1, K4, 2, (0, 1)),
    ((0,), 0, K4, 2, (0,))],
    ids=["complete", "an_operation_lost", "K4_complete",
         "a_K4_operation_lost", "a_K4_launch_lost_whole"])
def test_a_trace_that_lost_an_operation_is_incomplete(kernels, unmatched,
                                                      name, counted,
                                                      launches):
    """The port counted ``counted`` launches of its kernels; a K4
    (``fused_tt_kernel``) operation that the trace lost, with its launch
    or without, leaves the record incomplete."""
    from benchmark import tracing
    record = tracing.reduce(_trace(kernels, name, launches), counted, 2,
                            4096, True)
    assert record.unmatched == unmatched
    assert record.counted_in_trace == (len(kernels) if counted else 0)
    assert record.complete is (len(kernels) == 2)
    assert record.engine_ops == len(kernels)


@pytest.mark.parametrize("lost_tries", [1, 3])
def test_a_lost_trace_is_traced_again_then_refused(monkeypatch, capsys,
                                                  lost_tries):
    from benchmark import run, tracing
    real, calls = tracing.reduce, []

    def losing(*a, **k):
        calls.append(1)
        record = real(*a, **k)
        if len(calls) <= lost_tries:
            record.unmatched = 1
        return record
    monkeypatch.setattr(tracing, "reduce", losing)
    argv = ["--workload", CELLS[0], "--seed", "5", "--seconds", "0.2",
            "--trace", "1", "--rehearsal"]
    if lost_tries < run.TRACE_TRIES:
        assert run.main(argv) == 0
        assert last_line(capsys.readouterr().out)["correct"] is True
        assert len(calls) == lost_tries + 1
    else:
        with pytest.raises(run.Refused):
            run.main(argv)
        assert capsys.readouterr().out.strip() == ""
        assert len(calls) == run.TRACE_TRIES


# --- no JAX, and the reference apart ------------------------------------


def imported_top_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], a.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0], node.module


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix() for p in HERE.rglob("*.py")))
def test_no_file_imports_jax_or_the_jax_package(path):
    """Top-level names compared whole: ``pychebyshev_tpu_torch`` is the
    port, ``pychebyshev_tpu`` the JAX package."""
    for top, name in imported_top_names(ROOT / path):
        assert top not in ("jax", "jaxlib", "flax", "pychebyshev_tpu"), name
    text = (ROOT / path).read_text()
    assert "import_module(\"jax" not in text


def test_only_the_program_module_imports_the_port():
    """The tests plant faults in the port; only ``program.py``, ``run.py``
    and the representations' and engines' files may import it, and the
    reference none of it."""
    users = {p.relative_to(ROOT).as_posix() for p in HERE.rglob("*.py")
             if "tests" not in p.relative_to(HERE).parts
             and any(top == "pychebyshev_tpu_torch"
                     for top, _ in imported_top_names(p))}
    allowed = {"benchmark/program.py", "benchmark/run.py"} | {
        p.relative_to(ROOT).as_posix()
        for folder in ("representations", "engines")
        for p in (HERE / folder).glob("*.py")}
    assert "benchmark/program.py" in users
    assert users <= allowed, users - allowed
    assert not any(u.startswith("benchmark/reference/") for u in users)


# --- runs ---------------------------------------------------------------


@pytest.mark.parametrize("trace", (0, 1))
@pytest.mark.parametrize("workload", ONE_CARD)
def test_a_rehearsal_prints_one_result_line(workload, trace):
    proc = run_cli("--workload", workload, "--seed", str(2 ** 31 + 7),
                   "--seconds", "0.5", "--trace", str(trace), "--rehearsal")
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = last_line(proc.stdout)
    keys = list(line)
    want = LINE_KEYS + (["breakdown", "record"] if trace else [])
    assert sorted(keys[:-1]) == sorted(want) and keys[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    cell = cells.resolve(workload)
    metrics = cell.per_layer if trace else cell.end_to_end
    assert set(line["metrics"]) <= {m.name + ".rehearsal" for m in metrics}
    assert all(k.endswith(".rehearsal") for k in line["metrics"])
    if not trace:
        assert set(line["metrics"]) == {m.name + ".rehearsal"
                                        for m in metrics}
    device = line["device"]
    assert device["platform"] == "cpu" and device["count"] == cell.chips
    if trace:
        assert device["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert 0 < len(line["breakdown"]["device_ops"]) <= 10
        # the port's spans, but no host syncs off the card
        assert {m + ".rehearsal" for m in (
            "serve_host_us", "route_host_us", "port_idle_share")} <= set(
                line["metrics"])
        assert "host_syncs_per_request.rehearsal" not in line["metrics"]
        assert any(g[0].startswith(("serve", "route"))
                   for g in line["breakdown"]["idle_gaps"])
        # the record's span times by name, and the port's counters
        record = line["record"]
        assert record["self_by_span"]["serve"] > 0
        assert record["idle_by_span"] and all(
            v >= 0 for v in record["idle_by_span"].values())
        assert set(record["counters"]) == set(cells.counters())
    # the numbers compared, each beside its limit, end standard error
    tail = proc.stderr.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check dev.") and "limit" in t for t in tail)


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = run_cli("--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0", env=env, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_a_directory_without_the_program_fails(tmp_path):
    """Only BENCHMARK.json and the benchmark's files: no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0", "--rehearsal"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0 and proc.stdout.strip() == ""


# --- a broken timed path reads correct = false --------------------------


def _run_in_process(capsys, workload, entry=None, trace=0):
    from benchmark import run
    argv = ["--workload", workload, "--seed", "5", "--seconds", "0.3",
            "--trace", str(trace), "--rehearsal"]
    assert (run.main(argv) if entry is None
            else run.main(argv, entry=entry)) == 0
    return last_line(capsys.readouterr().out)


def _engine_classes():
    """Every engine of the port's serving layer with a route of its own
    (``_run``), so that a cell on any of them gets the fault."""
    from pychebyshev_tpu_torch import serving
    return [c for c in vars(serving).values()
            if isinstance(c, type) and "_run" in vars(c)]


def _half_left_out(out):
    """The second half of the batch left out, the mean of the rest in
    its place."""
    out = out.clone()
    half = out.shape[-1] // 2
    out[..., half:] = out[..., :half].mean(dim=-1, keepdim=True)
    return out


def _one_answer_altered(out):
    """One answer of each request moved by a thousandth of the largest
    answer: ten times the limits, and far below what a glance would
    catch."""
    out = out.clone()
    out.view(-1)[out.numel() // 3] += 1e-3 * out.abs().max()
    return out


@pytest.mark.parametrize("fault", [_half_left_out, _one_answer_altered],
                         ids=["half_of_the_batch_left_out",
                              "an_answer_altered"])
@pytest.mark.parametrize("workload", ONE_CARD + KEPT_ONE_CARD)
def test_a_broken_route_reads_not_correct(monkeypatch, capsys, with_kept_cells,
                                          workload, fault):
    """The fault is planted where the answers are produced: in the
    route each engine runs (``_run``), under the slicing and intake."""
    for cls in _engine_classes():
        original = cls._run
        monkeypatch.setattr(
            cls, "_run", lambda self, p, _o=original: fault(_o(self, p)))
    line = _run_in_process(capsys, workload)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def _local_gather(x, group, size):
    """The exchange between ranks left out: each rank's own block where
    the others' should be."""
    return torch.cat([x] * size, dim=0)


def gatherless_rank(argd, cell, rank, world, store):
    from benchmark import run
    from pychebyshev_tpu_torch.parallel import sharding
    sharding._all_gather_rows = _local_gather
    run._rank_entry(argd, cell, rank, world, store)


@pytest.mark.parametrize("workload", MULTI_CARD)
def test_the_exchange_left_out_reads_not_correct(monkeypatch, capsys,
                                                 with_kept_cells, workload):
    from pychebyshev_tpu_torch.parallel import sharding
    monkeypatch.setattr(sharding, "_all_gather_rows", _local_gather)
    line = _run_in_process(capsys, workload, entry=gatherless_rank)
    assert line["correct"] is False
    assert line["checks"]["dev.price"]["value"] > line["checks"][
        "dev.price"]["limit"]


@pytest.mark.parametrize("trace", (0, 1))
@pytest.mark.parametrize("workload", MULTI_CARD)
def test_the_multi_rank_rehearsal_is_correct_in_process(capsys,
                                                        with_kept_cells,
                                                        workload, trace):
    """Rank 0 here, ranks 1-3 spawned over gloo, one line from rank 0."""
    line = _run_in_process(capsys, workload, trace=trace)
    cell = cells.resolve(workload)
    assert line["correct"] is True
    assert line["device"]["count"] == cell.chips
    assert ("breakdown" in line) == bool(trace)
    metrics = cell.per_layer if trace else cell.end_to_end
    assert set(line["metrics"]) <= {m.name + ".rehearsal" for m in metrics}
    if not trace:
        assert set(line["metrics"]) == {m.name + ".rehearsal"
                                        for m in metrics}


# --- on the card ---------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("workload", ONE_CARD)
def test_a_short_traced_run_on_the_card(card, workload):
    proc = run_cli("--workload", workload, "--seed", "2147483700",
                   "--seconds", "2", "--trace", "1", timeout=360)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = last_line(proc.stdout)
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    assert math.isfinite(line["metrics"]["device_idle_share"]["value"])
    # every traced request's launch of the cell's kernel (K1 or K4) is in
    # the trace, and the port's spans are on the line
    requests = cells.resolve(workload).traffic["trace_requests"]
    assert (f"[bench] trace: {requests} launches of the counted kernels, "
            f"the port counted {requests}; 0 unmatched") in proc.stderr
    for name in ("serve_host_us", "route_host_us", "port_idle_share",
                 "host_syncs_per_request"):
        assert math.isfinite(line["metrics"][name]["value"]), name


@pytest.mark.parametrize("workload", KEPT_ONE_CARD)
def test_the_kept_report_mix_runs_correct_in_rehearsal(capsys, with_kept_cells,
                                                       workload):
    line = _run_in_process(capsys, workload)
    assert line["correct"] is True
    assert set(line["checks"]) == {
        f"dev.{n}" for n in cells.resolve(workload).traffic["spec_names"]}

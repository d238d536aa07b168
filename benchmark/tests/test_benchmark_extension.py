"""A new deployment joins the benchmark as new files and entries only: in
a copy of the benchmark, a representation, an engine, a precision tier
and a counted kernel are added as files of their own, with a
configuration, a mix, limits and ``BENCHMARK.json`` entries, and the
copy resolves and runs its new cell with no file that was there
changed.

A book of models joins so too: a representation that builds it through
``serving.build_book`` and counts M outputs a point, the
``MultiModelEvaluator`` engine, a counter and two readers of the
record's span times and counters; the copy's own contract tests pass
with the book among its cells, its rehearsal is ``correct``, and a
fault in one small-valued model reads ``correct`` false.

``add_book`` also makes the real-sized book of the card probe
(``PERF.md``): ``python3 -c "from benchmark.tests.test_benchmark_extension
import make_book_copy; make_book_copy('<dir>', 100, trace_requests=2)"``.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"
CELL = "bs5d_probe.risk_probe_f32"

REPRESENTATION = '''\
"""dense_probe: the dense interpolant, built under a phase of its own."""

import contextlib

from benchmark.representations import dense


def build(config, device, phase=contextlib.nullcontext):
    with phase("probe_build"):
        return dense.build(config, device, phase)


work_counts = dense.work_counts
reference = dense.reference
'''

ENGINE = '''\
"""ProbeEvaluator: a BatchedEvaluator that says it was made."""

import sys

from benchmark import program


def make(model, traffic, config, device, mesh):
    from pychebyshev_tpu_torch import serving

    print("[probe] engine made", file=sys.stderr, flush=True)
    return serving.BatchedEvaluator(
        model, derivative_order=program.specs(traffic)[0],
        **program.engine_kwargs(traffic, config, device, mesh))
'''


BOOK_REPRESENTATION = '''\
"""book_probe: a book of products of the configuration's function on one
grid, built in one call through ``serving.build_book``.  Product m is the
function at the points shifted by ``shifts[m]``, times
``quantities[m]``; its work is ``models`` times its ``member``'s, with
``models`` outputs a point."""

import contextlib

import numpy as np

from benchmark import cells
from benchmark.reference.book import Book


def _products(config):
    rep = config["representation"]
    shifts = rep["shifts"]
    quantities = rep.get("quantities", [1.0] * len(shifts))
    if not len(shifts) == len(quantities) == rep["models"]:
        raise ValueError("a book states a shift and a quantity a model")
    return shifts, quantities


def build(config, device, phase=contextlib.nullcontext):
    from pychebyshev_tpu_torch import serving

    values = cells.function(config["function"])
    shifts, quantities = _products(config)
    offsets = np.asarray(shifts, dtype=np.float64)

    def book(points, _data=None):
        points = np.asarray(points, dtype=np.float64)
        return np.column_stack([q * values(points + s)
                                for s, q in zip(offsets, quantities)])
    with phase("build_book"):
        return serving.build_book(book, config["dims"], config["domain"],
                                  config["n_nodes"], num_models=len(shifts),
                                  device=device)


def work_counts(config):
    rep = config["representation"]
    member = dict(config, representation=rep["member"])
    work = cells.representation(member).work_counts(member)
    return {"flop_per_point": rep["models"] * work["flop_per_point"],
            "coefficients": rep["models"] * work["coefficients"],
            "outputs_per_point": rep["models"]}


def reference(config, device):
    shifts, quantities = _products(config)
    return Book(cells.function(config["function"]), config["domain"],
                config["n_nodes"], shifts, quantities, device=device)
'''

BOOK_ENGINE = '''\
"""MultiModelEvaluator: the port's engine for a book of models on one
grid, one derivative spec, (M, N) answers a request."""

from benchmark import program


def make(model, traffic, config, device, mesh):
    from pychebyshev_tpu_torch import serving

    specs = program.specs(traffic)
    if len(specs) != 1:
        raise ValueError("a MultiModelEvaluator serves one spec")
    return serving.MultiModelEvaluator(
        model, derivative_order=specs[0],
        **program.engine_kwargs(traffic, config, device, mesh))
'''

# Two readers: one of a span's host time by its name, one of a counter.
SPAN_READER = '''\
"""eval_models_host_us: host time a traced request spends in the port's
``route.eval_models`` span outside the spans inside it."""


def read(record, cell):
    return record.self_by_span.get("route.eval_models")
'''

COUNTER_READER = '''\
"""probe_launches_per_request: the probe counter's change a traced
request (``counters/probe_launches.json``)."""


def read(record, cell):
    return record.counters.get("probe_launches")
'''

BOOK_CELL = "bs5d_book3.book_probe_f32"
BOOK_METRICS = [
    {"name": "eval_models_host_us", "unit": "us", "better": "lower",
     "source": "program_span", "layer": "route", "moves": "queries_per_s"},
    {"name": "probe_launches_per_request", "unit": "launches/req",
     "better": "lower", "source": "program_counter", "layer": "serving",
     "moves": "queries_per_s"}]
STRIKES = [[0.0, -5.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0],
           [0.0, 5.0, 0.0, 0.0, 0.0]]


def _digests(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in sorted(root.rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts}


def _copy(tmp: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(HERE, tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp / "benchmark"


def _add_deployment(tmp: Path) -> None:
    """The new files, and entries in BENCHMARK.json."""
    bench = tmp / "benchmark"
    (bench / "representations" / "dense_probe.py").write_text(REPRESENTATION)
    (bench / "engines" / "ProbeEvaluator.py").write_text(ENGINE)
    tier = json.loads((bench / "tiers" / "float32.json").read_text())
    (bench / "tiers" / "float32_probe.json").write_text(json.dumps(
        dict(tier, what="a copy of float32 under its own name")))
    (bench / "kernels" / "probe_kernel.json").write_text(json.dumps(
        {"what": "a kernel the probe counts",
         "counters": ["ops.fused_eval:launches"]}))
    config = json.loads((bench / "configs" / "bs5d_11n.json").read_text())
    config.update(name="bs5d_probe", representation={"kind": "dense_probe"})
    (bench / "configs" / "bs5d_probe.json").write_text(json.dumps(config))
    traffic = json.loads(
        (bench / "traffic" / "risk_2p20_f32.json").read_text())
    traffic.update(engine="ProbeEvaluator", dtype="float32_probe")
    (bench / "traffic" / "risk_probe_f32.json").write_text(
        json.dumps(traffic))
    shutil.copy(bench / "checks" / "bs5d_11n.risk_2p20_f32.json",
                bench / "checks" / f"{CELL}.json")
    b = json.loads((tmp / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "bs5d_probe", "source": "https://x.org",
                         "file": "benchmark/configs/bs5d_probe.json",
                         "reduced": [], "why": "a probe"})
    b["workloads"].append({"name": CELL, "config": "bs5d_probe",
                           "traffic": "risk_probe_f32", "chips": 1,
                           "why": "a probe"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    (tmp / "BENCHMARK.json").write_text(json.dumps(b, indent=2))


def test_a_new_deployment_joins_as_new_files(tmp_path):
    before = _digests(_copy(tmp_path))
    _add_deployment(tmp_path)
    after = _digests(tmp_path / "benchmark")
    assert {k: after[k] for k in before} == before
    assert len(after) == len(before) + 7

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         str(2 ** 31 + 11), "--seconds", "0.3", "--trace", "1",
         "--rehearsal"], cwd=tmp_path, capture_output=True, text=True,
        timeout=240, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert "[bench] setup probe_build" in proc.stderr
    assert "[probe] engine made" in proc.stderr
    assert "eval_roofline.rehearsal" not in line["metrics"]   # no peaks

    # the copy's readers take the new tier and kernel from their files
    probe = textwrap.dedent(f"""
        import json
        from benchmark import cells, program, roofline, tracing
        from pychebyshev_tpu_torch.ops import fused_eval
        cell = cells.resolve({CELL!r})
        fused_eval.launches = 3
        ev = [{{"ph": "X", "cat": "user_annotation", "name": n, "ts": t,
               "dur": 10.0}} for n, t in (("engine.call", 0.0),
                                          ("sync", 10.0))]
        ev.append({{"ph": "X", "cat": "cpu_op", "name": "probe_kernel",
                   "ts": 2.0, "dur": 1.0}})
        record = tracing.reduce({{"traceEvents": ev}}, 0, 1, 8, False)
        print(json.dumps({{
            "launches": program.kernel_launches(),
            "in_trace": record.counted_in_trace,
            "dtype": str(program.points_dtype(cell.traffic)),
            "least": roofline.least_seconds(
                cell.config, cell.traffic, 1 << 20, 1,
                "NVIDIA H100 80GB HBM3")}}))
        """)
    proc = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    # fused_eval_kernel's two counters and the probe's one, fused_tt's 0
    assert got["launches"] == 6
    assert got["in_trace"] == 1
    assert got["dtype"] == "torch.float32"
    assert got["least"] == 322102 * (1 << 20) / 495e12


def add_book(tmp: Path, shifts, quantities=None, name="bs5d_book3",
             traffic_name="book_probe_f32", traffic=None) -> str:
    """A book of ``len(shifts)`` products of ``bs_call`` on the 11^5
    grid, as new files and ``BENCHMARK.json`` entries of the copy at
    ``tmp``; returns its cell's name."""
    bench = tmp / "benchmark"
    cell = f"{name}.{traffic_name}"
    files = {
        bench / "representations" / "book_probe.py": BOOK_REPRESENTATION,
        bench / "engines" / "MultiModelEvaluator.py": BOOK_ENGINE,
        bench / "metrics" / "eval_models_host_us.py": SPAN_READER,
        bench / "metrics" / "probe_launches_per_request.py": COUNTER_READER}
    for path, text in files.items():
        path.write_text(text)
    (bench / "counters" / "probe_launches.json").write_text(json.dumps(
        {"what": "a counter the probe reads",
         "counter": "ops.fused_eval:launches"}))
    config = json.loads((bench / "configs" / "bs5d_11n.json").read_text())
    rep = {"kind": "book_probe", "models": len(shifts),
           "member": {"kind": "dense"}, "shifts": shifts}
    if quantities is not None:
        rep["quantities"] = quantities
    config.update(name=name, representation=rep, work={
        "flop_per_point": len(shifts) * 322102,
        "coefficients": len(shifts) * 161051,
        "outputs_per_point": len(shifts)})
    (bench / "configs" / f"{name}.json").write_text(json.dumps(config))
    mix = json.loads((bench / "traffic" / "risk_2p20_f32.json").read_text())
    mix.update(what="a book's revaluation: 2^18 points a request, every "
                    "product's price", engine="MultiModelEvaluator",
               points_per_request=1 << 18, bucket_sizes=[1024, 1 << 18],
               warmup_requests=2, trace_requests=2, sample_requests=2,
               rehearsal={"points_per_request": 2048,
                          "bucket_sizes": [1024, 2048],
                          "warmup_requests": 1, "trace_requests": 2,
                          "sample_requests": 2})
    mix.update(traffic or {})
    (bench / "traffic" / f"{traffic_name}.json").write_text(json.dumps(mix))
    checks = json.loads((bench / "checks" /
                         "bs5d_11n.risk_2p20_f32.json").read_text())
    checks["what"] = ("the dense cell's limit, for a probe: each model's "
                      "deviation on its own scale")
    (bench / "checks" / f"{cell}.json").write_text(json.dumps(checks))
    b = json.loads((tmp / "BENCHMARK.json").read_text())
    b["configs"].append({"name": name, "source": "https://x.org",
                         "file": f"benchmark/configs/{name}.json",
                         "reduced": [], "why": "a book probe"})
    b["workloads"].append({"name": cell, "config": name,
                           "traffic": traffic_name, "chips": 1,
                           "why": "a book probe"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    b["per_layer"] += [dict(m, workloads=[cell]) for m in BOOK_METRICS]
    (tmp / "BENCHMARK.json").write_text(json.dumps(b, indent=2))
    return cell


def make_book_copy(dest, products: int, **traffic) -> str:
    """The card probe's copy at ``dest``: a book of ``products`` products,
    ten strike shifts by ``products // 10`` maturity shifts, on the
    2^18-point mix with ``traffic``'s changes; returns its cell."""
    import numpy as np

    dest = Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    _copy(dest)
    strikes = np.linspace(-5.0, 5.0, 10)
    maturities = 0.1 * np.arange(products // 10)
    shifts = [[0.0, float(k), float(t), 0.0, 0.0]
              for t in maturities for k in strikes]
    return add_book(dest, shifts, name=f"bs5d_11n_book{products}",
                    traffic_name="book_2p18_f32", traffic=traffic)


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT),
                PYTHONDONTWRITEBYTECODE="1")


@pytest.fixture(scope="module")
def book_copy(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("book")
    before = _digests(_copy(tmp))
    bench_before = json.loads((tmp / "BENCHMARK.json").read_text())
    cell = add_book(tmp, STRIKES)
    return tmp, before, bench_before, cell


def _same_entries(before: dict, after: dict, cell: str) -> bool:
    """``after`` is ``before`` with entries added and the new cell added
    to metrics' lists: nothing that was there changed."""
    for key in before:
        if key in ("configs", "workloads", "end_to_end", "per_layer"):
            old = before[key]
            new = after[key][:len(old)]
            for o, n in zip(old, new):
                if "workloads" in o:
                    n = dict(n, workloads=[w for w in n["workloads"]
                                           if w != cell])
                if o != n:
                    return False
        elif before[key] != after[key]:
            return False
    return True


def test_a_book_joins_as_new_files_and_its_contract_tests_pass(book_copy):
    tmp, before, bench_before, cell = book_copy
    after = _digests(tmp / "benchmark")
    assert {k: after[k] for k in before} == before
    assert len(after) == len(before) + 8
    assert _same_entries(bench_before,
                         json.loads((tmp / "BENCHMARK.json").read_text()),
                         cell)

    # the copy's own contract tests, with the book among its cells
    proc = subprocess.run(
        [sys.executable, "-m", "pytest",
         "benchmark/tests/test_benchmark_harness.py", "-q", "-rA",
         "-p", "no:cacheprovider", "-p", "no:randomly", "-p", "xdist",
         "-n", "3"],
        cwd=tmp, capture_output=True, text=True, timeout=900, env=_env())
    assert proc.returncode == 0, proc.stdout[-4000:]
    for test in ("test_work_counts_follow_from_the_shapes_and_ranks",
                 "test_every_cell_resolves_from_its_files",
                 "test_a_rehearsal_prints_one_result_line",
                 "test_a_broken_route_reads_not_correct"):
        assert f"PASSED benchmark/tests/test_benchmark_harness.py::" \
               f"{test}[" in proc.stdout
        assert cell in "".join(
            line for line in proc.stdout.splitlines() if test in line)

    # its rehearsal is correct, and reads a span and a counter by name
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 29), "--seconds", "0.3", "--trace", "1",
         "--rehearsal"], cwd=tmp, capture_output=True, text=True,
        timeout=240, env=_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert "[bench] setup build_book" in proc.stderr
    assert line["metrics"]["eval_models_host_us.rehearsal"]["value"] > 0
    assert line["metrics"]["probe_launches_per_request.rehearsal"][
        "value"] == 0.0             # no K1 on a book's route, nor the CPU
    assert line["record"]["counters"]["probe_launches"] == 0.0
    assert 0 < line["checks"]["dev.price"]["value"] < 1e-5

    # the copy's roofline counts three outputs a point
    probe = textwrap.dedent(f"""
        import json
        from benchmark import cells, program, roofline
        cell = cells.resolve({cell!r})
        print(json.dumps({{
            "work": roofline.work_counts(cell.config),
            "bytes": roofline.bytes_moved(cell.config, cell.traffic,
                                          1 << 18, 1),
            "counters": sorted(program.counters())}}))
        """)
    proc = subprocess.run([sys.executable, "-c", probe], cwd=tmp,
                          capture_output=True, text=True, timeout=120,
                          env=_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["work"] == {"flop_per_point": 3 * 322102,
                           "coefficients": 3 * 161051,
                           "outputs_per_point": 3}
    assert got["bytes"] == 4 * ((1 << 18) * (5 + 3) + 3 * 161051)
    assert "probe_launches" in got["counters"]
    assert {k: v for k, v in _digests(tmp / "benchmark").items()
            if k in before} == before


PLANT = """
import sys
from benchmark import run
from pychebyshev_tpu_torch import serving

original = serving.MultiModelEvaluator._run


def small_model_off(self, points):
    # the third model's answers, each moved by a thousandth of its own
    # largest answer
    out = original(self, points).clone()
    out[2] += 1e-3 * out[2].abs().max()
    return out


serving.MultiModelEvaluator._run = small_model_off
sys.exit(run.main(sys.argv[1:]))
"""


def test_a_small_model_s_fault_reads_not_correct(tmp_path):
    """The third of three products is a hundredth of a call; its answers
    are off by a thousandth of its own scale, ten times the limit.  Each
    model on its own scale reads it; one book-wide scale, the largest
    model's, would hide it under the limit."""
    from benchmark import cells, correctness
    from benchmark.reference.book import Book
    from benchmark.reference.interpolant import deviation

    _copy(tmp_path)
    quantities = [1.0, 1.0, 0.01]
    cell = add_book(tmp_path, STRIKES, quantities)
    proc = subprocess.run(
        [sys.executable, "-c", PLANT, "--workload", cell, "--seed",
         str(2 ** 31 + 31), "--seconds", "0.3", "--trace", "0",
         "--rehearsal"], cwd=tmp_path, capture_output=True, text=True,
        timeout=240, env=_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    limit = line["checks"]["dev.price"]["limit"]
    assert line["correct"] is False
    assert line["checks"]["dev.price"]["value"] == pytest.approx(1e-3,
                                                                 rel=0.01)

    # the same fault against the reference itself, judged both ways
    config = json.loads((tmp_path / "benchmark" / "configs" /
                         "bs5d_book3.json").read_text())
    ref = Book(cells.function("bs_call"), config["domain"],
               config["n_nodes"], STRIKES, quantities, device="cpu")
    gen = torch.Generator().manual_seed(7)
    lo = torch.tensor([b[0] for b in config["domain"]], dtype=torch.float64)
    hi = torch.tensor([b[1] for b in config["domain"]], dtype=torch.float64)
    points = lo + (hi - lo) * (0.02 + 0.96 * torch.rand(
        (512, 5), generator=gen, dtype=torch.float64))
    exact = ref.evaluate(points, (0, 0, 0, 0, 0))
    faulty = exact.clone()
    faulty[2] += 1e-3 * faulty[2].abs().max()
    per_model = correctness.model_deviation(faulty, exact, 3)
    book_wide = deviation(faulty.reshape(-1), exact.reshape(-1))
    assert per_model == pytest.approx(1e-3) and per_model > limit
    assert book_wide < limit
    assert correctness.model_deviation(exact, exact, 3) == 0.0
    assert correctness.model_deviation(exact[:2], exact, 3) == float("inf")

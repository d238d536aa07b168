"""A new deployment joins the benchmark as new files and entries only: in
a copy of the benchmark, a representation, an engine, a precision tier
and a counted kernel are added as files of their own, with a
configuration, a mix, limits and ``BENCHMARK.json`` entries, and the
copy resolves and runs its new cell with no file that was there
changed."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

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


def _digests(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in sorted(root.rglob("*")) if p.is_file()}


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

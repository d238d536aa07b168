"""Where a served request's time goes by the port's own spans, on one CUDA
card, and what the spans cost.

For each one-card cell of ``BENCHMARK.json``, builds the cell's model and serving engine through ``benchmark.program``
as ``benchmark/run.py`` does, warms them up, and then:

1. serves the traffic's ``trace_requests`` requests untraced, as many
   under ``torch.profiler`` (``benchmark.tracing.traced_requests``, CPU
   and CUDA activities), and as many untraced again, each request
   drawn and synchronised first, as in the benchmark's closed loop; an
   untraced request is timed on the host clock from the call into the
   port to its synchronised end, which is how the trace's window counts
   a traced one;
2. reduces the trace twice: ``tracing.reduce`` (the benchmark's
   per-layer metrics) and ``port_spans.reduce`` (host time of the
   serving and route layers, the device's idle inside ``serve``, host
   syncs, the idle gaps named by the innermost span, idle and host time
   by span);
3. prints one JSON line for the cell: both readings, the traced and the
   untraced request's mean time (tracing's cost when on), and the port's
   spans a request.

A dd engine over the dense configuration (the f64 kernel and the
engine's per-request domain read) is traced the same way, for the host
syncs.  A last line gives tracing's cost when off: one ``span`` with no
profiler recording (``pychebyshev_tpu_torch/utils/tracing.py``), timed
on this host, and that times each cell's spans a request.  Every line
also goes to ``chiprun_out/chip_spans.jsonl``.

Run from the repository root, with one CUDA card:

    python3 chip_spans.py [--seed 2147483701]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_spans.jsonl"
SPAN_CALLS = 200_000


def _card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0) + ", power limit not read"


def _emit(line: dict) -> None:
    text = json.dumps(line)
    print(text, flush=True)
    with OUT.open("a") as f:
        f.write(text + "\n")


def _untraced(engine, draw, count: int, sync) -> list:
    """Seconds of ``count`` requests, each from the call into the port to
    its synchronised end."""
    times = []
    for _ in range(count):
        points = draw()
        sync()
        t0 = time.perf_counter()
        engine(points)
        sync()
        times.append(time.perf_counter() - t0)
    return times


def measure(name: str, cell, traffic: dict, engine, seed: int,
            device) -> dict:
    """One cell's line: the engine's requests untraced, traced, and
    untraced again, and both reductions of the trace."""
    from benchmark import port_spans, program, tracing
    from benchmark import traffic as traffic_mod

    dtype = program.DTYPES[traffic["dtype"]]
    client = traffic_mod.Client(traffic, cell.config["domain"], seed,
                                device, dtype)
    on_card = device.type == "cuda"
    requests = traffic["trace_requests"]

    def sync():
        if on_card:
            torch.cuda.synchronize(device)
    for _ in range(traffic["warmup_requests"]):
        engine(client.draw())
    sync()
    before = _untraced(engine, client.draw, requests, sync)
    trace, counted = tracing.traced_requests(
        engine, client.draw, requests, sync, lambda: None,
        program.kernel_launches, on_card)
    after = _untraced(engine, client.draw, requests, sync)
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    record = tracing.reduce(trace, counted, requests,
                            traffic["points_per_request"], on_card, kind)
    spans = port_spans.reduce(trace, on_card)
    ours = [e for e in trace["traceEvents"] if port_spans._ours(e)]
    readers = {m.name: m.reader(record, cell) for m in cell.per_layer}
    untraced_ms = 1e3 * (sum(before) + sum(after)) / (2 * requests)
    traced_ms = 1e-3 * record.window_us / requests
    calls = [e["dur"] for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation"
             and e.get("name") == "engine.call"]
    return {
        "cell": name, "requests": requests, "complete": record.complete,
        "untraced_request_ms": untraced_ms,
        "untraced_blocks_ms": [1e3 * sum(b) / requests
                               for b in (before, after)],
        "traced_request_ms": traced_ms,
        "tracing_on_cost": traced_ms / untraced_ms - 1.0,
        "engine_call_us": sum(calls) / len(calls),
        "port_spans_per_request": len(ours) / requests,
        "existing": readers,
        "port": None if spans is None else spans.metrics(),
        "idle_gaps": None if spans is None else spans.idle_gaps,
        "benchmark_idle_gaps": record.idle_gaps,
        "idle_by_span_us": None if spans is None else spans.idle_by_span,
        "host_by_span_us": None if spans is None else spans.self_by_span,
        "top_ops": record.top_ops}


def off_cost() -> float:
    """Microseconds of one ``span`` with no profiler recording."""
    from pychebyshev_tpu_torch.utils.tracing import span

    for _ in range(1000):
        with span("serve"):
            pass
    t0 = time.perf_counter()
    for _ in range(SPAN_CALLS):
        with span("serve"):
            pass
    return (time.perf_counter() - t0) / SPAN_CALLS * 1e6


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=2147483701)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_spans.py needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from benchmark import cells, program

    OUT.parent.mkdir(exist_ok=True)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [w["name"] for w in bench["workloads"] if w["chips"] == 1]
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = _card()
    lines = []
    for name in names:
        cell = cells.resolve(name)
        traffic = dict(cell.traffic)
        model = program.build(cell.config, device, torch.cuda.synchronize)
        engine = program.engine(model, traffic, cell.config, device, None)
        engine.warmup()
        lines.append(dict(measure(name, cell, traffic, engine, args.seed,
                                  device), device=card))
        _emit(lines[-1])
        if cell.config["representation"]["kind"] == "dense":
            dd = dict(traffic, dtype="float64")
            from pychebyshev_tpu_torch import serving
            engine = serving.BatchedEvaluator(
                model, dtype="dd", bucket_sizes=traffic["bucket_sizes"],
                device=device)
            engine.warmup()
            _emit(dict(measure(f"{name}+dd_engine", cell, dd, engine,
                               args.seed, device), device=card))
        del engine, model
        torch.cuda.empty_cache()
    per_span = off_cost()
    _emit({"tracing_off_us_per_span": per_span,
           "off_us_per_request": {
               line["cell"]: per_span * line["port_spans_per_request"]
               for line in lines},
           "device": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) is resolved from its files (``cells.py``).  A run:

1. refuses to run without as many CUDA cards as the cell asks for;
2. sets up: builds the configuration's model through the port, its
   serving engine, under a mesh in a four-card cell, and warms up the
   cell's shapes, each phase timed on standard error;
3. offers the traffic's closed loop for ``--seconds`` (``traffic.py``),
   with Python's collector paused and, on a card, the driving thread on
   one CPU: ``queries_per_s`` (points answered over the window's
   seconds) and ``request_p95_ms`` come from it, on the host clock;
4. with ``--trace 1``, serves the traffic's ``trace_requests`` more
   under ``torch.profiler`` (``tracing.py``) and reads the per-layer
   metrics (``metrics/<name>.py``);
5. reads the peak device memory, frees the program, and holds a sample
   of the window's requests, drawn from the seed, against the plain
   reference (``correctness.py``);
6. fails if JAX or the JAX package was loaded, and prints each number
   compared beside its limit on standard error, then one JSON line on
   standard output: ``correct``, ``attempted``, ``failed``, ``metrics``,
   ``device`` (with ``--trace 1`` also ``breakdown``, and ``record``:
   rank 0's ``self_by_span`` and ``idle_by_span`` in microseconds a
   request and its ``counters`` a request), and ``checks``.

A four-card cell runs one process a card: this process is rank 0, and
spawns ranks 1-3 itself, over NCCL with a file store in a temporary
directory (``$TMPDIR``).  Only rank 0 prints.

``--rehearsal`` runs the same on the CPU at the traffic's rehearsal size
(gloo ranks under a mesh), with metric names ending in ``.rehearsal``:
it is for the CPU tests, and its numbers are not the card's.
"""

from __future__ import annotations

import time

_WALL0 = time.time()   # set-up runs from the start of the process

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# Run as a script, this file's own directory heads sys.path, where a
# module of the harness could shadow one of Python's; the harness is
# imported as the package ``benchmark`` from the checkout's root.
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Few host threads, so that the load comes from one process; and every
# cache a library might write kept at fixed paths inside the checkout.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"
_CACHE = ROOT / ".bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["USE_FLAX"] = "0"
# The bytecode of every module the run imports, torch's among them, kept
# inside the checkout: where the environment writes none
# (PYTHONDONTWRITEBYTECODE), each run would compile torch's sources
# again, seconds of set-up that vary from run to run.
sys.dont_write_bytecode = False
sys.pycache_prefix = str(_CACHE / "pycache")

import torch  # noqa: E402

from benchmark import cells, correctness, program, tracing  # noqa: E402
from benchmark import traffic as traffic_mod  # noqa: E402

_IMPORTED = time.time()

FORBIDDEN = ("jax", "jaxlib", "flax", "pychebyshev_tpu")
# The end-to-end metrics a run measures; a cell reports those of them
# that BENCHMARK.json gives it.
MEASURED = ("queries_per_s", "request_p95_ms", "setup_s")
# Under a mesh, the requests between two agreements on whether to go on.
STOP_EVERY = 16
# Traced segments a run serves before it gives up on a complete trace.
TRACE_TRIES = 3
RANK_TIMEOUT_S = 300


class Refused(SystemExit):
    """Ends the run with a message and no result line."""


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearsal", action="store_true",
                   help="run on the CPU at the rehearsal size (tests only)")
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark must not
    load, compared whole (``pychebyshev_tpu_torch`` is not
    ``pychebyshev_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _traffic(cell: cells.Cell, rehearsal: bool) -> dict:
    traffic = dict(cell.traffic)
    if rehearsal:
        traffic.update(traffic["rehearsal"])
    return traffic


class Phases:
    """Set-up's phases on the host clock, each printed on standard error
    as it ends (``[bench] setup <phase> <seconds>``), so that a run whose
    set-up reads far off shows which phase took the time."""

    def __init__(self, loud: bool):
        self.loud = loud
        self.note("imports", _IMPORTED - _WALL0)
        self.note("resolve", time.time() - _IMPORTED)

    def note(self, name: str, seconds: float) -> None:
        if self.loud:
            print(f"[bench] setup {name} {seconds:.4f}", file=sys.stderr,
                  flush=True)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time()
        yield
        self.note(name, time.time() - t0)


class _Rank:
    """One rank's view of the world: its device and the collectives a
    run needs."""

    def __init__(self, rank: int, world: int, rehearsal: bool):
        self.rank, self.world = rank, world
        self._asked = 0
        self.on_card = not rehearsal
        self.device = (torch.device("cuda", rank) if self.on_card
                       else torch.device("cpu"))
        if self.on_card:
            torch.cuda.set_device(self.device)
            torch.zeros(1, device=self.device)    # the context, now
            self.sync()

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def pin(self) -> None:
        """On a card, keep this thread, which drives the card's requests,
        on one CPU of those the process may use, a CPU of its own under
        a mesh: a thread that moves between CPUs reads its host time
        differently from run to run (PERF.md, section 2)."""
        if self.on_card:
            cpus = sorted(os.sched_getaffinity(0))
            os.sched_setaffinity(0, {cpus[-1 - self.rank % len(cpus)]})

    def barrier(self) -> None:
        """Waits until every rank is here (an all-reduce)."""
        if self.world > 1:
            self._all_reduce_max(0)

    def proceed(self, go: bool) -> bool:
        """Whether to send the next request: ``go`` on one card.  Under a
        mesh rank 0's ``go``, agreed by an all-reduce every
        ``STOP_EVERY`` requests and True in between, so that every rank
        sends the same requests and the harness adds no collective to
        most of them."""
        if self.world == 1:
            return go
        self._asked += 1
        if self._asked % STOP_EVERY:
            return True
        return bool(self._all_reduce_max(int(go and self.rank == 0)))

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` holds on some rank."""
        if self.world == 1:
            return flag
        return bool(self._all_reduce_max(int(flag)))

    def _all_reduce_max(self, value: int) -> int:
        import torch.distributed as dist
        flag = torch.tensor([value], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return int(flag.item())

    def gather(self, obj) -> list:
        if self.world == 1:
            return [obj]
        import torch.distributed as dist
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out


def run_rank(cell: cells.Cell, args: argparse.Namespace, rank: int = 0,
             world: int = 1, store: str = None):
    """One rank of a run; rank 0 returns the result (a dict), the others
    None."""
    phase = Phases(loud=rank == 0)
    with phase("cuda_context"):
        me = _Rank(rank, world, args.rehearsal)
    traffic = _traffic(cell, args.rehearsal)
    config = cell.config
    dtype = program.points_dtype(traffic)
    if world > 1:
        import datetime
        import torch.distributed as dist
        with phase("process_group"):
            dist.init_process_group(
                "nccl" if me.on_card else "gloo",
                init_method=f"file://{store}", world_size=world, rank=rank,
                timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    with phase("port_import"):
        program.import_port()
    mesh = program.mesh(config, me.device.type)

    model = program.build(config, me.device, me.sync, phase)
    with phase("engine"):
        engine = program.engine(model, traffic, config, me.device, mesh)
    with phase("kernel_library_and_first_bucket"):
        engine.warmup()
    with phase("warmup_requests"):
        warm = traffic_mod.Client.warmup(traffic, config["domain"],
                                         args.seed, me.device, dtype)
        for _ in range(traffic["warmup_requests"]):
            engine(warm.draw())
        me.sync()
    with phase("barrier"):
        me.barrier()          # every rank set up before the window opens
    setup_s = time.time() - _WALL0
    phase.note("total", setup_s)

    client = traffic_mod.Client(traffic, config["domain"], args.seed,
                                me.device, dtype)
    reservoir = (traffic_mod.Reservoir(traffic["sample_requests"], args.seed)
                 if rank == 0 else None)
    me.pin()
    with _collector_paused():
        window = traffic_mod.closed_loop(engine, client, args.seconds,
                                         me.sync, me.proceed, reservoir)
    metrics = dict(queries_per_s=window.points / window.seconds,
                   request_p95_ms=1e3 * _p95(window.latencies),
                   setup_s=setup_s)
    if rank == 0:
        _describe(window)

    record = None
    for _ in range(TRACE_TRIES if args.trace else 0):
        before = program.counters()
        trace, counted = tracing.traced_requests(
            engine, client.draw, traffic["trace_requests"], me.sync,
            me.barrier, program.kernel_launches, me.on_card)
        moved = {k: v - before[k] for k, v in program.counters().items()}
        record = tracing.reduce(
            trace, counted, traffic["trace_requests"],
            traffic["points_per_request"] // world, me.on_card,
            device_kind=_kind(me), counters=moved)
        del trace
        if rank == 0:
            print(f"[bench] trace: {record.counted_in_trace} launches of "
                  f"the counted kernels, the port counted "
                  f"{record.counted_by_program}; {record.unmatched} "
                  f"unmatched", file=sys.stderr, flush=True)
        if not me.any(not record.complete):
            break
    peak = (torch.cuda.max_memory_allocated(me.device) if me.on_card else 0)
    records = me.gather(record)
    peaks = me.gather(peak)
    if world > 1:
        import torch.distributed as dist
        dist.destroy_process_group()
    sample = window.sample
    attempted, failed = window.attempted, window.failed
    del engine, model, client, warm, window
    gc.collect()
    if me.on_card:
        torch.cuda.empty_cache()
    if rank != 0:
        return None

    ref = correctness.reference(config, me.device)
    numbers = correctness.deviations(ref, traffic, sample)
    return dict(metrics=metrics, records=records, peak=max(peaks),
                numbers=numbers, kind=_kind(me), world=world,
                attempted=attempted, failed=failed)


@contextlib.contextmanager
def _collector_paused():
    """Python's cyclic collector frozen and off while the window runs, so
    that no collection of set-up's objects lands inside it."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()


def _p95(values) -> float:
    """The 95th percentile of ``values`` (``statistics.quantiles``,
    inclusive method)."""
    if len(values) < 2:
        return values[0] if values else float("nan")
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def _describe(window) -> None:
    """The window's shape on standard error: where its time went, so that
    a run whose rate reads far off shows whether a few stalls or every
    request made it so; and the latency median of each quarter of the
    requests, in order, so that it shows whether the pace moved inside
    the window or held for the whole process."""
    lat = sorted(window.latencies)
    if not lat:
        return
    med = statistics.median(lat)
    served = sum(lat)
    q = max(1, len(lat) // 4)
    quarters = " ".join(
        f"{1e3 * statistics.median(window.latencies[i:i + q]):.4f}"
        for i in range(0, q * (len(lat) // q), q))
    print(f"[bench] window {window.seconds:.4f} s, {window.attempted} "
          f"requests, latency median {1e3 * med:.4f} ms, mean "
          f"{1e3 * served / len(lat):.4f} ms, max {1e3 * lat[-1]:.4f} ms, "
          f"{sum(x > 2 * med for x in lat)} over twice the median "
          f"({sum(x for x in lat if x > 2 * med):.4f} s), outside the "
          f"requests {window.seconds - served:.4f} s; quarters' medians "
          f"{quarters} ms", file=sys.stderr, flush=True)


def _kind(me: _Rank) -> str:
    return torch.cuda.get_device_name(me.device) if me.on_card else "cpu"


def _power_limit(index: int):
    """The card's power limit in watts, as ``nvidia-smi`` reads it, or
    None."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20)
        return float(proc.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _mean(values):
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None


def result(cell: cells.Cell, args, out: dict):
    """The result line and the check lines for standard error."""
    suffix = ".rehearsal" if args.rehearsal else ""
    line = {"correct": False, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": {}}
    records = out["records"]
    if args.trace:
        for r in records:
            if not r.complete:
                raise Refused(
                    f"every trace lost launches: the last holds "
                    f"{r.counted_in_trace} of the port's kernel, the port "
                    f"counted {r.counted_by_program}, and {r.unmatched} "
                    f"launches or device operations lack their other half; "
                    f"device time would under-read")
        for m in cell.per_layer:
            value = _mean([m.reader(r, cell) for r in records])
            if value is not None:
                line["metrics"][m.name + suffix] = {"value": value,
                                                    "unit": m.unit}
    else:
        for m in cell.end_to_end:
            line["metrics"][m.name + suffix] = {
                "value": out["metrics"][m.name], "unit": m.unit}
    device = {"platform": "cpu" if args.rehearsal else "gpu",
              "kind": out["kind"], "count": out["world"],
              "memory_peak_bytes": int(out["peak"])}
    if not args.rehearsal:
        device["power_limit_w"] = _power_limit(0)
    if args.trace:
        device["busy_s"] = _mean([r.busy_us * 1e-6 for r in records])
        device["window_s"] = _mean([r.window_us * 1e-6 for r in records])
        line["breakdown"] = {"device_ops": [list(x) for x in records[0].top_ops],
                             "idle_gaps": [list(x) for x in records[0].idle_gaps]}
    line["device"] = device
    if args.trace:
        line["record"] = {k: getattr(records[0], k) for k in
                          ("self_by_span", "idle_by_span", "counters")}
    checks = correctness.judge(out["numbers"], cell.checks)
    line["correct"] = bool(out["attempted"] > 0 and out["failed"] == 0
                           and checks
                           and all(c["ok"] for c in checks.values()))
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                      for k, c in checks.items()}
    notes = [f"check {k} {c['value']!r} limit {c['limit']!r} "
             f"{'ok' if c['ok'] else 'FAILED'}" for k, c in checks.items()]
    return line, notes


def _rank_entry(argd: dict, cell: cells.Cell, rank: int, world: int,
                store: str) -> None:
    """A spawned rank of a multi-card run, on rank 0's cell."""
    run_rank(cell, argparse.Namespace(**argd), rank, world, store)


def launch(cell: cells.Cell, args, entry=_rank_entry) -> dict:
    """Rank 0 of a ``cell.chips``-rank run in this process, ranks 1.. in
    spawned processes, all waited for."""
    import multiprocessing

    world = cell.chips
    # The other ranks read no metric, so they get the cell without its
    # readers, which a spawned process could not unpickle.
    bare = dataclasses.replace(cell, per_layer=[], end_to_end=[
        dataclasses.replace(m, reader=None) for m in cell.end_to_end])
    tmp = tempfile.mkdtemp(prefix="bench-store-")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=entry,
                         args=(vars(args), bare, r, world,
                               os.path.join(tmp, "store")))
             for r in range(1, world)]
    for p in procs:
        p.start()
    ok = False
    try:
        out = run_rank(cell, args, 0, world, os.path.join(tmp, "store"))
        ok = True
    finally:
        for p in procs:
            p.join(RANK_TIMEOUT_S if ok else 10)
            if p.is_alive():
                p.terminate()
                p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise Refused(f"ranks 1-{world - 1} ended with exit codes {codes}")
    return out


def main(argv=None, entry=_rank_entry) -> int:
    args = parse(argv)
    try:
        cell = cells.resolve(args.workload)
    except KeyError as exc:
        raise Refused(str(exc))
    if not args.rehearsal and (not torch.cuda.is_available()
                               or torch.cuda.device_count() < cell.chips):
        raise Refused(
            f"{cell.name} needs {cell.chips} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count() is {torch.cuda.device_count()}")
    if cell.chips > 1:
        out = launch(cell, args, entry)
    else:
        out = run_rank(cell, args)
    found = forbidden_modules()
    if found:
        raise Refused(f"the run loaded {found}")
    line, notes = result(cell, args, out)
    for note in notes:
        print(note, file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

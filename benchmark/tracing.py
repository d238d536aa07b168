"""The traced segment of a run and the reduction of its trace.

After the measured window, ``traced_requests`` serves a fixed number of
requests (``trace_requests`` in the traffic file) under
``torch.profiler``, each in three host spans of the benchmark's own:
``client.draw`` (the draw, synchronised), ``engine.call`` (the call into
the port) and ``sync`` (waiting for its result).  ``reduce`` turns the
exported trace into a ``Record``:

- the traced window: the requests' serving time, each request from the
  start of its ``engine.call`` to the end of its ``sync``;
- every device operation in it (kernels, copies, sets), and those that
  the host launched inside an ``engine.call`` span;
- the union of their intervals (busy time: overlapping operations count
  once), the idle gaps between them, each named by the host span it
  began in, and the time by operation name;
- what the trace lost: the launches of the port's hand-written kernels
  that it holds (every device operation whose name holds the fragment of
  a counted kernel, ``benchmark/kernels/``), beside those the port's
  counters saw, and the launches and device operations in the traced
  window that lack their other half (matched by correlation id).  A
  trace that lost some under-reads device time: the run traces again,
  and fails if every try lost some;
- the port's own spans (``port_spans.py``): the four numbers of
  ``PortSpans.metrics()``, the idle gaps named by the innermost span,
  the port's or the benchmark's, in which the host launched the
  operation that ends each gap, and ``self_by_span`` and
  ``idle_by_span``: host time and device idle time put down to the
  innermost span open at each instant, by span name, in microseconds a
  request.  A program without spans leaves the four numbers None and
  the two maps empty, and names the gaps by the benchmark's spans;
- ``counters``: by name, how far each of the port's counters
  (``benchmark/counters/<name>.json``) moved over the traced requests,
  a request; the run reads them before and after the segment
  (``program.counters``).

A run with no card (the rehearsal) traces the CPU, and its "device
operations" are the CPU operations.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from benchmark import cells

SPANS = ("client.draw", "engine.call", "sync")
GPU_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
# Host calls that put an operation on the device (cudaLaunchKernel,
# cuLaunchKernel, cudaMemcpyAsync, cudaMemsetAsync, ...).
DEVICE_WORK_CALLS = ("LaunchKernel", "Memcpy", "Memset")
TOP = 10


@dataclass
class Record:
    """One rank's traced segment, reduced."""
    requests: int
    points_per_request: int       # points this rank evaluated a request
    window_us: float
    busy_us: float
    engine_busy_us: float
    engine_ops: int
    device_ops: int
    counted_in_trace: int
    counted_by_program: int
    top_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    device_kind: str = ""
    unmatched: int = 0            # launches or device ops without the other
    # The port's spans (port_spans.PortSpans.metrics()); None without.
    serve_host_us: Optional[float] = None
    route_host_us: Optional[float] = None
    port_idle_share: Optional[float] = None
    host_syncs_per_request: Optional[float] = None
    # Span name -> microseconds a request (port_spans.PortSpans); empty
    # without the port's spans.
    self_by_span: Dict[str, float] = field(default_factory=dict)
    idle_by_span: Dict[str, float] = field(default_factory=dict)
    # Counter name -> its change over the traced requests, a request.
    counters: Dict[str, float] = field(default_factory=dict)

    @property
    def complete(self) -> bool:
        return (self.unmatched == 0
                and self.counted_in_trace == self.counted_by_program)


def traced_requests(call: Callable, draw: Callable, count: int,
                    sync: Callable[[], None], align: Callable[[], None],
                    launches: Callable[[], int],
                    on_card: bool) -> Tuple[dict, int]:
    """Serve ``count`` requests under the profiler, each drawn and
    ``align``ed across ranks inside its ``client.draw`` span, so that no
    rank's wait for a late one reads as device time or idle; returns the exported trace and the port's
    kernel launches counted meanwhile."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    before = launches()
    with profile(activities=activities) as prof:
        for _ in range(count):
            with record_function("client.draw"):
                points = draw()
                sync()
                align()
            with record_function("engine.call"):
                out = call(points)
            with record_function("sync"):
                sync()
            del points, out
    counted = launches() - before
    fd, path = tempfile.mkstemp(prefix="bench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    return trace, counted


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def _short(name: str) -> str:
    """A kernel's name without its trailing argument list, at most 120
    letters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.strip()[:120]


def _clip(s: float, e: float, spans) -> List[Tuple[float, float]]:
    """The parts of [s, e] inside the (sorted, disjoint) ``spans``."""
    return [(max(s, a), min(e, b)) for a, b in spans
            if min(e, b) > max(s, a)]


def _inside(t: float, spans) -> bool:
    return any(a <= t <= b for a, b in spans)


def reduce(trace: dict, counted: int, requests: int, points: int,
           on_card: bool, device_kind: str = "",
           counters: Optional[Dict[str, int]] = None) -> Record:
    """The record of a traced segment.  Its window is the requests'
    serving time: each request from the start of its ``engine.call`` to
    the end of its ``sync``, so that the client's draws, which are the
    benchmark's and not the port's, do not read as the device idling.
    ``counters`` are how far the port's counters moved over the
    segment's ``requests``."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "ts" in e]
    spans: Dict[str, List[Tuple[float, float]]] = {s: [] for s in SPANS}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in spans:
            spans[e["name"]].append((float(e["ts"]),
                                     float(e["ts"]) + float(e["dur"])))
    calls, syncs = sorted(spans["engine.call"]), sorted(spans["sync"])
    if not calls or len(calls) != len(syncs):
        raise RuntimeError(
            f"the trace holds {len(calls)} engine.call and {len(syncs)} "
            f"sync spans of the benchmark's; a traced request has one each")
    served = [(c[0], z[1]) for c, z in zip(calls, syncs)]

    unmatched = 0
    if on_card:
        launch_at = {e["args"]["correlation"]: float(e["ts"]) for e in events
                     if e.get("cat") in LAUNCH_CATEGORIES
                     and "correlation" in e.get("args", {})}
        ops = [e for e in events if e.get("cat") in GPU_CATEGORIES]
        done = {e.get("args", {}).get("correlation") for e in ops}
        unmatched = sum(
            1 for e in events if e.get("cat") in LAUNCH_CATEGORIES
            and any(w in e.get("name", "") for w in DEVICE_WORK_CALLS)
            and _inside(float(e["ts"]), served)
            and e.get("args", {}).get("correlation") not in done)
        unmatched += sum(
            1 for e in ops
            if e.get("args", {}).get("correlation") not in launch_at
            and _inside(float(e["ts"]), served))
    else:
        launch_at = {}
        ops = [e for e in events if e.get("cat") == "cpu_op"]

    fragments = [k["fragment"] for k in cells.counted_kernels()]

    def launched(e) -> Optional[float]:
        if not on_card:
            return float(e["ts"])
        return launch_at.get(e.get("args", {}).get("correlation"))

    timeline, engine_timeline, by_name = [], [], {}
    engine_ops = device_ops = counted_in_trace = 0
    for e in ops:
        s = float(e["ts"])
        t = s + float(e["dur"])
        if any(f in e.get("name", "") for f in fragments):
            counted_in_trace += 1
        parts = _clip(s, t, served)
        if not parts:
            continue
        device_ops += 1
        timeline += parts
        name = _short(e.get("name", "?"))
        by_name[name] = by_name.get(name, 0.0) + _length(parts)
        at = launched(e)
        if at is not None and any(a <= at <= b for a, b in calls):
            engine_ops += 1
            engine_timeline += parts

    busy = _union(timeline)
    named = []
    for a, b in served:
        cursor = a
        for s, e in [iv for iv in busy if iv[1] > a and iv[0] < b] + [(b, b)]:
            if s > cursor:
                where = next((n for n in SPANS for x, y in spans[n]
                              if x <= cursor < y), "between")
                named.append((where, (s - cursor) * 1e-6))
            cursor = max(cursor, e)
    named.sort(key=lambda g: -g[1])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    record = Record(
        requests=requests, points_per_request=points,
        window_us=_length(served), busy_us=_length(busy),
        engine_busy_us=_length(_union(engine_timeline)),
        engine_ops=engine_ops, device_ops=device_ops,
        counted_in_trace=counted_in_trace, counted_by_program=counted,
        top_ops=[(n, v * 1e-6) for n, v in top], idle_gaps=named[:TOP],
        device_kind=device_kind, unmatched=unmatched,
        counters={k: v / requests for k, v in (counters or {}).items()})
    from benchmark import port_spans     # it reads this module's helpers

    spans = port_spans.reduce(trace, on_card)
    if spans is not None:
        record = dataclasses.replace(
            record, idle_gaps=spans.idle_gaps,
            self_by_span=dict(spans.self_by_span),
            idle_by_span=dict(spans.idle_by_span), **spans.metrics())
    return record

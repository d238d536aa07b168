"""The port's own spans in a traced segment, reduced.

While a profiler records, the port leaves host spans in the trace
(``pychebyshev_tpu_torch/utils/tracing.py``): ``serve`` and ``serve.*``
(the serving layer) and ``route.*`` (the route layer).  This module reads
them from the Chrome trace that ``tracing.traced_requests`` exports, by
the first dotted part of their names, and imports nothing of the port.
Within the served window of ``tracing.reduce`` (each request from the
start of its ``engine.call`` to the end of its ``sync``), ``reduce``
gives:

- ``serve_host_us``: host time inside ``serve`` spans that no
  ``route.*`` span covers, per request;
- ``route_host_us``: the length of the union of ``route.*`` spans, per
  request;
- ``port_idle_share``: device idle time inside a ``serve`` span over the
  window, the base of ``device_idle_share``, which it cannot exceed;
- ``host_syncs_per_request``: runtime calls that block the host on the
  device and begin inside a ``serve`` span, per request: the stream,
  device, event and context synchronizes, and a memcpy whose device
  operation is a device-to-host copy.  The synchronize that a scalar
  read (``.item()``) issues right after its copy is the same wait, and
  counts once.  None off the card, whose trace has no runtime calls;
- ``idle_gaps``: the gaps of ``tracing.reduce``, in its order and at its
  lengths, each named by the innermost span, the port's or the
  benchmark's, in which the host launched the operation that ends the
  gap: the host code the device waited for.  A request's window opens
  at its ``engine.call`` with the device idle, so naming a gap by the
  span open at its start would name the first gap of every request
  ``engine.call``.  The launch time is held inside the gap: the device's
  clock in the trace can read some microseconds ahead of the host's, so
  an operation can seem to start before its launch.  A gap that no
  operation ends (a request's last) is named by the innermost span at
  its start;
- ``idle_by_span`` and ``self_by_span``: device idle time, and host time,
  put down to the innermost span open on the host at each instant, per
  request.

A trace that holds no span of the port's (a program without them)
reduces to None.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from benchmark import tracing

LAYERS = ("serve", "route")
SYNC_CALLS = ("StreamSynchronize", "DeviceSynchronize", "EventSynchronize",
              "CtxSynchronize")

Span = Tuple[str, float, float]


@dataclass
class PortSpans:
    """The port's spans in one rank's traced segment, reduced; times in
    microseconds over the whole segment."""
    requests: int
    window_us: float
    serve_host_us: float
    route_host_us: float
    port_idle_us: float
    host_syncs: Optional[int]
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    idle_by_span: List[Tuple[str, float]] = field(default_factory=list)
    self_by_span: List[Tuple[str, float]] = field(default_factory=list)

    def metrics(self) -> Dict[str, Optional[float]]:
        """The four per-layer numbers, None where the trace has none."""
        n = self.requests
        return {
            "serve_host_us": self.serve_host_us / n,
            "route_host_us": self.route_host_us / n,
            "port_idle_share": (self.port_idle_us / self.window_us
                                if self.window_us > 0 else None),
            "host_syncs_per_request": (None if self.host_syncs is None
                                       else self.host_syncs / n)}


def _ours(e: dict) -> bool:
    return (e.get("cat") == "user_annotation"
            and e.get("name", "").split(".")[0] in LAYERS)


def _spans(events, pick) -> List[Span]:
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if pick(e)]


def _intersect(a, b) -> List[Tuple[float, float]]:
    """The intersection of two sorted, disjoint interval lists."""
    out = []
    for s, e in a:
        out += tracing._clip(s, e, b)
    return out


def _innermost(t: float, spans: List[Span]) -> str:
    best = None
    for span in spans:
        if span[1] <= t <= span[2] and (
                best is None or (span[1], -span[2]) > (best[1], -best[2])):
            best = span
    return best[0] if best else "between"


def _by_innermost(intervals, spans: List[Span]) -> Dict[str, float]:
    """The length of ``intervals`` put down to the innermost span open
    at each instant."""
    cuts = sorted({t for s in spans for t in s[1:]})
    out: Dict[str, float] = {}
    for s, e in intervals:
        edges = [s] + [t for t in cuts if s < t < e] + [e]
        for a, b in zip(edges, edges[1:]):
            name = _innermost(0.5 * (a + b), spans)
            out[name] = out.get(name, 0.0) + (b - a)
    return out


def _syncs(events, serve, ops_by_corr) -> int:
    """Blocking runtime calls that begin inside ``serve``."""
    calls = sorted((e for e in events
                    if e.get("cat") in tracing.LAUNCH_CATEGORIES),
                   key=lambda e: (e.get("tid"), float(e["ts"])))
    count, previous = 0, None
    for e in calls:
        name = e.get("name", "")
        op = ops_by_corr.get(e.get("args", {}).get("correlation"))
        copy_out = ("Memcpy" in name and op is not None
                    and "DtoH" in op.get("name", ""))
        blocks = copy_out or any(k in name for k in SYNC_CALLS)
        repeat = (not copy_out and previous is not None
                  and previous[0] == e.get("tid") and previous[1])
        if blocks and not repeat and tracing._inside(float(e["ts"]), serve):
            count += 1
        previous = (e.get("tid"), copy_out and blocks)
    return count


def reduce(trace: dict, on_card: bool) -> Optional[PortSpans]:
    """The port's spans of a traced segment, or None if it has none."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "ts" in e]
    bench = _spans(events, lambda e: e.get("cat") == "user_annotation"
                   and e.get("name") in tracing.SPANS)
    calls = sorted(s[1:] for s in bench if s[0] == "engine.call")
    syncs = sorted(s[1:] for s in bench if s[0] == "sync")
    if not calls or len(calls) != len(syncs):
        return None
    served = [(c[0], z[1]) for c, z in zip(calls, syncs)]
    port = [s for s in _spans(events, _ours)
            if tracing._clip(s[1], s[2], served)]
    if not port:
        return None
    serve = tracing._union(_intersect(tracing._union(
        [s[1:] for s in port if s[0].split(".")[0] == "serve"]), served))
    route = tracing._union(_intersect(tracing._union(
        [s[1:] for s in port if s[0].split(".")[0] == "route"]), served))

    if on_card:
        ops = [e for e in events if e.get("cat") in tracing.GPU_CATEGORIES]
        launch_at = {e["args"]["correlation"]: float(e["ts"])
                     for e in events
                     if e.get("cat") in tracing.LAUNCH_CATEGORIES
                     and "correlation" in e.get("args", {})}
    else:
        ops = [e for e in events if e.get("cat") == "cpu_op"]
        launch_at = {}
    parts, ends_at = [], {}
    for e in ops:
        s = float(e["ts"])
        for part in tracing._clip(s, s + float(e["dur"]), served):
            parts.append(part)
            at = (launch_at.get(e.get("args", {}).get("correlation"))
                  if on_card else s)
            if at is not None:
                ends_at[part[0]] = min(at, ends_at.get(part[0], at))
    busy = tracing._union(parts)
    idle = []
    for a, b in served:
        cursor = a
        for s, e in [iv for iv in busy if iv[1] > a and iv[0] < b] + [(b, b)]:
            if s > cursor:
                idle.append((cursor, s))
            cursor = max(cursor, e)

    spans = bench + port
    gaps = []
    for s, e in idle:
        at = ends_at.get(e)
        gaps.append((_innermost(s if at is None else min(max(s, at), e),
                                spans), (e - s) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    host = _by_innermost(served, spans)
    idle_at = _by_innermost(idle, spans)
    n = len(served)

    ops_by_corr = {e.get("args", {}).get("correlation"): e for e in ops}
    return PortSpans(
        requests=n, window_us=tracing._length(served),
        serve_host_us=(tracing._length(serve)
                       - tracing._length(_intersect(serve, route))),
        route_host_us=tracing._length(route),
        port_idle_us=tracing._length(_intersect(serve, idle)),
        host_syncs=_syncs(events, serve, ops_by_corr) if on_card else None,
        idle_gaps=gaps[:tracing.TOP],
        idle_by_span=sorted(((k, v / n) for k, v in idle_at.items()),
                            key=lambda kv: -kv[1]),
        self_by_span=sorted(((k, v / n) for k, v in host.items()),
                            key=lambda kv: -kv[1]))

"""The reduction of the port's spans (``port_spans.py``): its exact numbers
on a planted trace, the existing reduction and readers untouched by the
port's spans, gaps named by the innermost span, a scalar read's copy and
synchronize counted as one wait, and a CPU rehearsal's traced segment
through the port."""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from benchmark import cells, port_spans, program, tracing

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
ONE_CARD = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]
EXISTING = [m["name"] for m in BENCH["per_layer"]]


def _x(cat, name, ts, dur, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


def _trace(port=True, syncs=True):
    """Two requests, each: ``engine.call`` [0, 10] holding the port's
    ``serve`` [1, 9] (``serve.intake``, then ``route.fused_eval`` with
    ``route.operands`` and ``route.kernel_launch``, whose launch at 5
    starts a kernel at 8 that runs to 46), ``sync`` [10, 50], and a
    ``cudaStreamSynchronize`` at 8.5 inside ``serve``."""
    ev = []
    for i, t in enumerate((0.0, 100.0)):
        ev += [_x("user_annotation", "engine.call", t, 10.0),
               _x("user_annotation", "sync", t + 10.0, 40.0),
               _x("cuda_runtime", "cudaLaunchKernel", t + 5.0, 1.0,
                  correlation=i),
               _x("kernel", "k", t + 8.0, 38.0, correlation=i)]
        if port:
            ev += [_x("user_annotation", "serve", t + 1.0, 8.0),
                   _x("user_annotation", "serve.intake", t + 1.5, 1.0),
                   _x("user_annotation", "route.fused_eval", t + 3.0, 5.0),
                   _x("user_annotation", "route.operands", t + 3.2, 1.0),
                   _x("user_annotation", "route.kernel_launch", t + 4.5,
                      2.0)]
        if syncs:
            ev.append(_x("cuda_runtime", "cudaStreamSynchronize", t + 8.5,
                         0.3, correlation=100 + i))
    return {"traceEvents": ev}


def test_each_number_reads_its_planted_value():
    got = port_spans.reduce(_trace(), on_card=True)
    assert got.requests == 2 and got.window_us == 100.0
    m = got.metrics()
    assert m["serve_host_us"] == pytest.approx(3.0)     # 8 - 5 a request
    assert m["route_host_us"] == pytest.approx(5.0)
    assert m["port_idle_share"] == pytest.approx(0.14)  # [1, 8] of [0, 50]
    assert m["host_syncs_per_request"] == 1.0


def test_port_idle_is_part_of_the_device_idle():
    cell = cells.resolve(ONE_CARD[0])
    record = tracing.reduce(_trace(), 2, 2, 4096, True)
    device_idle = cells.reader("device_idle_share")(record, cell)
    assert device_idle == pytest.approx(0.24)
    share = port_spans.reduce(_trace(), True).metrics()["port_idle_share"]
    assert share <= device_idle


@pytest.mark.parametrize("metric", EXISTING)
def test_the_existing_readers_read_the_same_with_the_port_s_spans(metric):
    cell = cells.resolve(ONE_CARD[0])
    bare = tracing.reduce(_trace(port=False), 2, 2, 4096, True)
    spanned = tracing.reduce(_trace(port=True), 2, 2, 4096, True)
    port = ("serve_host_us", "route_host_us", "port_idle_share",
            "host_syncs_per_request")
    maps = ("self_by_span", "idle_by_span")
    assert all(getattr(bare, k) is None for k in port)
    assert all(getattr(spanned, k) is not None for k in port)
    assert all(getattr(bare, k) == {} for k in maps)
    assert all(getattr(spanned, k) for k in maps)
    # beside the port's four numbers, its two maps and the gaps' names,
    # nothing moves
    assert dataclasses.replace(
        spanned, idle_gaps=[g[1] for g in spanned.idle_gaps],
        **{k: None for k in port}, **{k: {} for k in maps}
    ) == dataclasses.replace(
        bare, idle_gaps=[g[1] for g in bare.idle_gaps])
    reader = cells.reader(metric)
    if metric not in port:
        assert reader(spanned, cell) == reader(bare, cell)


def test_gaps_keep_the_existing_order_and_lengths_named_innermost():
    got = port_spans.reduce(_trace(), True)
    bare = tracing.reduce(_trace(port=False), 2, 2, 4096, True)
    assert [g[1] for g in got.idle_gaps] == [g[1] for g in bare.idle_gaps]
    assert [g[0] for g in bare.idle_gaps] == ["engine.call"] * 2 + [
        "sync"] * 2
    # the record of a trace with the port's spans names its gaps so
    record = tracing.reduce(_trace(), 2, 2, 4096, True)
    assert record.idle_gaps == got.idle_gaps
    assert record.serve_host_us == got.metrics()["serve_host_us"]
    # the device waited for the launch in route.kernel_launch
    assert [g[0] for g in got.idle_gaps] == ["route.kernel_launch"] * 2 + [
        "sync"] * 2
    assert got.idle_gaps[0][1] == pytest.approx(8e-6)


def test_a_launch_the_device_clock_puts_after_the_gap_names_its_end():
    """The device's clock reads ahead: the kernel seems to start at 8,
    its launch at 9.5, after ``route.fused_eval`` [3, 8] ended; the gap
    [0, 8] is put down to the span open at its end."""
    trace = _trace()
    for e in trace["traceEvents"]:
        if e["name"] == "cudaLaunchKernel":
            e["ts"] += 4.5
    got = port_spans.reduce(trace, True)
    assert [g[0] for g in got.idle_gaps][:2] == ["route.fused_eval"] * 2


def test_idle_and_host_time_by_innermost_span():
    """A request's idle [0, 8] and [46, 50], and its host time [0, 50],
    put down to the innermost span at each instant."""
    got = port_spans.reduce(_trace(), True)
    assert dict(got.idle_by_span) == pytest.approx({
        "engine.call": 1.0, "serve": 1.0, "serve.intake": 1.0,
        "route.fused_eval": 2.0, "route.operands": 1.0,
        "route.kernel_launch": 2.0, "sync": 4.0})
    assert dict(got.self_by_span) == pytest.approx({
        "engine.call": 2.0, "serve": 2.0, "serve.intake": 1.0,
        "route.fused_eval": 2.0, "route.operands": 1.0,
        "route.kernel_launch": 2.0, "sync": 40.0})


def test_the_record_carries_span_times_and_counters():
    """The record of the planted trace: host and idle time by innermost
    span, by name, microseconds a request, as ``PortSpans`` reads them;
    and each counter's change over the two requests, a request."""
    record = tracing.reduce(_trace(), 2, 2, 4096, True,
                            counters={"k1_launches": 2, "cache_misses": 0,
                                      "bytes_packed": 5})
    assert record.self_by_span == pytest.approx({
        "engine.call": 2.0, "serve": 2.0, "serve.intake": 1.0,
        "route.fused_eval": 2.0, "route.operands": 1.0,
        "route.kernel_launch": 2.0, "sync": 40.0})
    assert record.idle_by_span == pytest.approx({
        "engine.call": 1.0, "serve": 1.0, "serve.intake": 1.0,
        "route.fused_eval": 2.0, "route.operands": 1.0,
        "route.kernel_launch": 2.0, "sync": 4.0})
    # each request's 50 us of host time, 8 + 4 of them idle
    assert sum(record.self_by_span.values()) == pytest.approx(50.0)
    assert sum(record.idle_by_span.values()) == pytest.approx(12.0)
    assert record.counters == {"k1_launches": 1.0, "cache_misses": 0.0,
                               "bytes_packed": 2.5}
    # a reader reads a span by name and a counter by name
    assert record.self_by_span["route.kernel_launch"] == pytest.approx(2.0)
    bare = tracing.reduce(_trace(port=False), 2, 2, 4096, True)
    assert bare.self_by_span == bare.idle_by_span == bare.counters == {}


def test_a_scalar_read_is_one_wait():
    trace = _trace(syncs=False)
    for i, t in enumerate((0.0, 100.0)):
        trace["traceEvents"] += [
            _x("cuda_runtime", "cudaMemcpyAsync", t + 8.2, 0.2,
               correlation=200 + i),
            _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", t + 46.0,
               0.5, correlation=200 + i),
            _x("cuda_runtime", "cudaStreamSynchronize", t + 8.5, 0.3,
               correlation=300 + i)]
    got = port_spans.reduce(trace, True)
    assert got.metrics()["host_syncs_per_request"] == 1.0
    # a copy to the device does not block
    trace = _trace(syncs=False)
    trace["traceEvents"] += [
        _x("cuda_runtime", "cudaMemcpyAsync", 2.0, 0.2, correlation=7),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 7.0, 0.1,
           correlation=7)]
    assert port_spans.reduce(trace, True).host_syncs == 0


def test_a_trace_without_the_port_s_spans_reads_nothing():
    assert port_spans.reduce(_trace(port=False), True) is None
    assert port_spans.reduce({"traceEvents": []}, True) is None


@pytest.mark.parametrize("workload,route", [
    (ONE_CARD[0], "route.eval"), (ONE_CARD[1], "route.tt_eval")])
def test_a_rehearsal_segment_reads_the_port_s_spans(workload, route):
    """``chip_spans.measure`` on the CPU at the rehearsal size: the
    traced requests through the port, both reductions of their trace."""
    import chip_spans

    cell = cells.resolve(workload)
    traffic = dict(cell.traffic, **cell.traffic["rehearsal"])
    cpu = torch.device("cpu")
    model = program.build(cell.config, cpu, lambda: None)
    engine = program.engine(model, traffic, cell.config, cpu, None)
    engine.warmup()
    line = chip_spans.measure(workload, cell, traffic, engine, 11, cpu)
    m = line["port"]
    assert line["requests"] == traffic["trace_requests"] and line["complete"]
    assert m["host_syncs_per_request"] is None
    assert m["serve_host_us"] > 0 and m["route_host_us"] > 0
    assert m["port_idle_share"] <= line["existing"]["device_idle_share"]
    assert m["serve_host_us"] + m["route_host_us"] <= line["engine_call_us"]
    names = {n for n, _ in line["host_by_span_us"]}
    assert {"serve", "serve.intake", route} <= names
    if route == "route.tt_eval":
        assert "route.tt_prepare" in names
    assert line["port_spans_per_request"] >= 4

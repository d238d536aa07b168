"""The port's spans (``utils.tracing``) on the CPU.

With no profiler recording, a served request makes no
``record_function`` call and answers bitwise as the engine's route does
when called directly.  Under ``torch.profiler`` each call leaves one
``serve`` span holding ``serve.intake`` and one ``route.<route>`` span a
slice, named by the route the engine chose; a dd engine's domain read is
``serve.dd_check``, and an out-of-domain call nests its f64 sibling's
``serve``; a mesh's ``all_gather`` is ``serve.gather``, outside the
route.  ``torch.func`` through the TT chain differentiates bitwise as
before while a profiler records.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pychebyshev_tpu_torch import (
    BatchedEvaluator,
    ChebyshevApproximation,
    ChebyshevSlider,
    ChebyshevSpline,
    MultiModelEvaluator,
    MultiSpecEvaluator,
)
from pychebyshev_tpu_torch.ops import eval as eval_ops
from pychebyshev_tpu_torch.ops import tt_eval
from pychebyshev_tpu_torch.parallel import sharding
from pychebyshev_tpu_torch.parallel.world import local_world
from pychebyshev_tpu_torch.utils import tracing

DOMAIN = [[-1.0, 1.0], [0.0, 2.0], [-3.0, 1.0]]
BUCKETS = (16, 32)              # 50 points are two slices
LAYERS = ("serve", "route")


def f_vec(p, _=None):
    return (np.sin(p[:, 0]) * p[:, 1] + p[:, 2] / (4.0 + p[:, 0])
            + 0.5 * p[:, 1] * p[:, 2])


@pytest.fixture(scope="module")
def dense():
    cheb = ChebyshevApproximation(f_vec, 3, DOMAIN, [7, 6, 5],
                                  vectorized=True, device="cpu")
    cheb.build(verbose=False)
    return cheb


@pytest.fixture(scope="module")
def tt(dense):
    return dense.to_tt(tolerance=1e-12)


@pytest.fixture(scope="module")
def spline():
    spl = ChebyshevSpline(lambda x, _: abs(x[0]) + x[1], 2,
                          [[-1.0, 1.0], [0.0, 1.0]], [7, 5], [[0.0], []],
                          device="cpu")
    spl.build(verbose=False)
    return spl


@pytest.fixture(scope="module")
def slider():
    sl = ChebyshevSlider(lambda p, _=None: np.sin(p[:, 0]) + p[:, 1] * p[:, 2],
                         3, [[-1.0, 1.0]] * 3, [7] * 3, [[0], [1, 2]],
                         [0.1] * 3, vectorized=True, device="cpu")
    sl.build(verbose=False)
    return sl


def points(n, dtype=torch.float32, domain=DOMAIN, scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    lo = np.array([b[0] for b in domain])
    hi = np.array([b[1] for b in domain])
    mid, half = (lo + hi) / 2, (hi - lo) / 2
    p = mid + scale * half * rng.uniform(-0.95, 0.95, (n, len(domain)))
    return torch.tensor(p, dtype=dtype)


def spans(prof):
    """The port's spans in a profile: (name, start, end), by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.name.split(".")[0] in LAYERS),
                  key=lambda s: (s[1], -s[2]))


def inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def traced(engine, pts):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = engine(pts)
    return out, spans(prof)


def _engine(kind, dense, tt, spline, slider):
    """(engine, points, the route it must take)."""
    if kind == "dense":
        return (BatchedEvaluator(dense, dtype=torch.float32,
                                 bucket_sizes=BUCKETS, device="cpu"),
                points(20), "route.eval")
    if kind == "fused":
        return (BatchedEvaluator(dense, dtype=torch.float32, use_fused=True,
                                 bucket_sizes=BUCKETS, device="cpu"),
                points(20), "route.fused_eval")
    if kind == "tt":
        return (BatchedEvaluator(tt, dtype=torch.float32,
                                 bucket_sizes=BUCKETS, device="cpu"),
                points(20), "route.tt_eval")
    if kind == "fused_tt":
        return (BatchedEvaluator(tt, dtype=torch.float32, use_fused=True,
                                 bucket_sizes=BUCKETS, device="cpu"),
                points(20), "route.fused_tt_eval")
    if kind == "dd":
        return (BatchedEvaluator(dense, dtype="dd", bucket_sizes=BUCKETS,
                                 device="cpu"),
                points(20, torch.float64), "route.eval_dd")
    if kind == "specs":
        return (MultiSpecEvaluator(dense, [(0, 0, 0), (1, 0, 0)],
                                   dtype=torch.float32,
                                   bucket_sizes=BUCKETS, device="cpu"),
                points(20), "route.eval_models")
    if kind == "book":
        return (MultiModelEvaluator([dense, dense], dtype=torch.float64,
                                    bucket_sizes=BUCKETS, device="cpu"),
                points(20, torch.float64), "route.eval_models")
    if kind == "tt_book":
        return (MultiModelEvaluator([tt, tt], dtype=torch.float32,
                                    bucket_sizes=BUCKETS, device="cpu"),
                points(20), "route.tt_eval")
    if kind == "spline":
        return (BatchedEvaluator(spline, dtype=torch.float64,
                                 bucket_sizes=BUCKETS, device="cpu"),
                points(20, torch.float64, spline.domain), "route.spline")
    assert kind == "slider"
    return (BatchedEvaluator(slider, dtype=torch.float64,
                             bucket_sizes=BUCKETS, device="cpu"),
            points(20, torch.float64, slider.domain), "route.slider")


KINDS = ["dense", "fused", "tt", "fused_tt", "dd", "specs", "book",
         "tt_book", "spline", "slider"]


@pytest.fixture
def counted(monkeypatch):
    """Counts the calls of ``record_function`` the spans make."""
    calls = []
    real = tracing.record_function

    def counting(name):
        calls.append(name)
        return real(name)
    monkeypatch.setattr(tracing, "record_function", counting)
    return calls


def _direct(kind, engine, pts):
    """The route the engine chose, called without the engine, over the
    same slices."""
    step = BUCKETS[-1]
    parts = []
    for i in range(0, pts.shape[0], step):
        p = pts[i:i + step]
        if kind == "dense":
            parts.append(eval_ops.eval_batch(
                engine._tensor, engine._nodes, engine._weights,
                engine._diffs, p, engine._orders))
        elif kind == "tt":
            parts.append(tt_eval.tt_eval_batch(engine._cores,
                                               engine._tt_domain, p))
        else:
            parts.append(engine._dd_runner(p)[0])
    return torch.cat(parts, dim=-1)


@pytest.mark.parametrize("kind", ["dense", "tt", "dd"])
def test_no_profiler_no_record_function_and_the_same_bits(
        kind, counted, dense, tt, spline, slider):
    engine, _, _ = _engine(kind, dense, tt, spline, slider)
    pts = points(50, engine.dtype)               # two slices
    out = engine(pts)
    assert counted == []
    torch.testing.assert_close(out, _direct(kind, engine, pts),
                               rtol=0, atol=0)
    with profile(activities=[ProfilerActivity.CPU]):
        again = engine(pts)
    assert counted and counted[0] == "serve"
    torch.testing.assert_close(again, out, rtol=0, atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_one_serve_span_holds_intake_and_its_route(kind, dense, tt, spline,
                                                   slider):
    engine, pts, route = _engine(kind, dense, tt, spline, slider)
    _, got = traced(engine, pts)
    serve = [s for s in got if s[0] == "serve"]
    assert len(serve) == 1
    assert all(inside(s, serve[0]) for s in got)
    assert [s[0] for s in got if s[0] == "serve.intake"] == ["serve.intake"]
    routes = [s for s in got
              if s[0].startswith("route.") and s[0] not in (
                  "route.operands", "route.kernel_launch",
                  "route.tt_prepare")]
    assert [s[0] for s in routes] == [route]
    intake = next(s for s in got if s[0] == "serve.intake")
    assert intake[2] <= routes[0][1]
    if kind in ("tt", "fused_tt"):   # fused_tt: the CPU runs the chain
        prepare = [s for s in got if s[0] == "route.tt_prepare"]
        assert len(prepare) == 1 and inside(prepare[0], routes[0])
    if kind == "fused":     # the CPU runs the plain contraction: no launch
        operands = [s for s in got if s[0] == "route.operands"]
        assert len(operands) == 1 and inside(operands[0], routes[0])
    if kind in ("fused", "fused_tt"):
        assert "route.kernel_launch" not in [s[0] for s in got]
    join = [s for s in got if s[0] == "serve.join"]
    assert len(join) == 1 and routes[0][2] <= join[0][1]


def test_each_slice_runs_in_its_route_span_and_join_follows(dense):
    engine = BatchedEvaluator(dense, dtype=torch.float32,
                              bucket_sizes=BUCKETS, device="cpu")
    _, got = traced(engine, points(70))              # slices 32, 32, 6
    names = [s[0] for s in got]
    assert names == ["serve", "serve.intake", "route.eval", "route.eval",
                     "route.eval", "serve.join"]
    last_route = [s for s in got if s[0] == "route.eval"][-1]
    join = got[-1]
    assert last_route[2] <= join[1] and inside(join, got[0])


def test_dd_out_of_domain_nests_the_sibling_serve(dense):
    engine = BatchedEvaluator(dense, dtype="dd", bucket_sizes=BUCKETS,
                              device="cpu")
    inside_pts = points(20, torch.float64)
    _, got = traced(engine, inside_pts)
    assert [s[0] for s in got] == ["serve", "serve.intake",
                                   "serve.dd_check", "route.eval_dd",
                                   "serve.join"]
    outside_pts = points(20, torch.float64, scale=1.5)
    out, got = traced(engine, outside_pts)
    names = [s[0] for s in got]
    assert names == ["serve", "serve.intake", "serve.dd_check", "serve",
                     "serve.intake", "route.eval", "serve.join"]
    outer, check, sibling = got[0], got[2], got[3]
    assert inside(sibling, outer) and check[2] <= sibling[1]
    torch.testing.assert_close(out, engine._dd_fallback(outside_pts),
                               rtol=0, atol=0)


def test_the_mesh_gather_is_outside_the_route(dense):
    with local_world():
        mesh = sharding.make_mesh(device_type="cpu")
        engine = BatchedEvaluator(dense, dtype=torch.float32,
                                  bucket_sizes=BUCKETS, mesh=mesh,
                                  device="cpu")
        out, got = traced(engine, points(20))
        plain = BatchedEvaluator(dense, dtype=torch.float32,
                                 bucket_sizes=BUCKETS, device="cpu")
        torch.testing.assert_close(out, plain(points(20)), rtol=0, atol=0)
    names = [s[0] for s in got]
    assert names == ["serve", "serve.intake", "route.eval", "serve.gather",
                     "serve.join"]
    route, gather = got[2], got[3]
    assert route[2] <= gather[1] and inside(gather, got[0])


def test_torch_func_through_the_tt_chain_while_a_profiler_records(tt):
    cores = tuple(torch.as_tensor(c) for c in tt._coeff_cores)
    pts = points(4, torch.float64)

    def value(p):
        return tt_eval.tt_eval_batch(cores, DOMAIN, p[None, :])[0]

    def grads():
        return (torch.func.vmap(torch.func.grad(value))(pts),
                torch.func.jacrev(
                    lambda q: tt_eval.tt_eval_batch(cores, DOMAIN, q))(pts))

    plain = grads()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        under = grads()
    assert any(s[0] == "route.tt_prepare" for s in spans(prof))
    for a, b in zip(plain, under):
        torch.testing.assert_close(b, a, rtol=0, atol=0)

"""Benchmark of the PyTorch port on one CUDA card: every row of bench.py.

The same workloads as ``bench.py`` (the JAX package's TPU bench, which
stays as it is): the 5-D Black-Scholes call on an 11^5 Chebyshev grid
queried at N = 2^20 points (f32 plain and through the fused kernel K1,
Delta, price plus five Greeks, an 8-model book, the dd tier through K3,
f64), the reference's rank-15 TT-Cross configuration (f32, Delta, dd,
f64) and the masked-ALS hard configuration, ``to_tt(1e-13)`` of the
11^5 interpolant served by the grouped dd chain, dd bucket masses and
dd conditional expectations over 2^17 boxes, and the 10-D slider's dd
Greek report at 2^18 points.  Every row is held to its accuracy ceiling
(scale-normalized max deviation, max|a - ref| / max|ref|).

Run from the repository root, on one card:

    python3 bench_torch.py [--reps 40] [--seed 0]

and its CPU rehearsal (small widths, the same code path; its metric
names carry the prefix ``rehearsal.``):

    python3 bench_torch.py --device cpu --small

Without a card it exits non-zero and names the cause; it never falls
back to the CPU.  Standard output, one JSON object a line, each flushed
when written: the run's header (card, power limit, versions, seed,
precision settings); the kernels' build as set-up time; one line per
metric as soon as it is measured (``metric``, ``value``, ``unit``,
``n``, ``median_ms``, ``p75_ms``, ``samples``, ``deviation``,
``ceiling``, ``against``, ``device``, ``ok``; ``launches`` and
``kernel_ms`` on the K1 and K3 rows); then one ``busy_share`` line per
timed row from a separate ``torch.profiler`` pass; last
``{"ok": ..., "rows": ..., "failed": [...]}``.  Diagnostics go to
standard error.  The exit code is non-zero if any row breaks its
ceiling, raises, or is missing; a row that fails does not stop the
rows after it.

Timing: CUDA events around each call, 3 warm-ups then ``--reps`` timed
calls, each row rotating over at least three input batches whose total
exceeds the card's 50 MB L2 (a server's next request arrives cold);
the median and the 75th percentile with the sample count.  Builds are
timed on the host clock around a build that ends in
``torch.cuda.synchronize()``.  ``--seed S`` is added to each of
bench.py's seeds (1, 7, 9, 11, 21, 42), so ``--seed 0`` draws
bench.py's inputs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass

import numpy as np
import torch
from scipy.stats import norm

from pychebyshev_tpu_torch import (
    ChebyshevApproximation,
    ChebyshevSlider,
    ChebyshevTT,
)
from pychebyshev_tpu_torch.ops import eval as eval_ops
from pychebyshev_tpu_torch.ops import (
    eval_dd,
    fused_dd,
    fused_eval,
    integrate,
    slider_eval,
    tt_eval,
    tt_eval_dd,
)

#: The upstream reference's single-query ``vectorized_eval`` on a CPU,
#: ~0.065 ms a query (BASELINE.md); the headline's ``vs_baseline`` base.
BASELINE_SINGLE_QUERY_S = 0.065e-3
L2_BYTES = 50 * 2 ** 20
WARMUP = 3
BUSY_CALLS = 5

# Accuracy ceilings (ROADMAP.md, scripts/perf_gate.py:168-209).
F32 = 2e-4
F64 = 1e-12
DD = 1e-10
TO_TT = 1e-12
#: 11^5 price against the analytic call, max relative error where
#: |price| > 1 (tests/test_approximation.py:42).
ANALYTIC = 5e-4
#: Rank-15 cross, max relative price error over the 50 test points.
TT_PRICE = 1e-3
#: Fewer nodes and a lower rank interpolate worse: the rehearsal holds
#: the two analytic rows to this multiple of their ceilings.
SMALL_ANALYTIC_FACTOR = 10.0

DOMAIN = [[80.0, 120.0], [90.0, 110.0], [0.25, 2.0], [0.1, 0.5],
          [0.01, 0.05]]
# The reference's TT configuration (compare_tensor_train.py): a
# narrower domain and a 2 % dividend yield.
TT_DOMAIN = [[80.0, 120.0], [90.0, 110.0], [0.25, 1.0], [0.15, 0.35],
             [0.01, 0.08]]
TT_Q = 0.02
GREEKS = ((0, 0, 0, 0, 0), (1, 0, 0, 0, 0), (2, 0, 0, 0, 0),
          (0, 0, 1, 0, 0), (0, 0, 0, 1, 0), (0, 0, 0, 0, 1))
BOOK = 8
SLIDER_D = 10
SLIDER_W = np.linspace(0.5, 1.5, SLIDER_D)
SLIDER_SPECS = ((0,) * SLIDER_D,) + tuple(
    tuple(1 if j == k else 0 for j in range(SLIDER_D)) for k in (0, 2, 4, 6))


def bs_price_np(points, _data=None):
    """Analytic Black-Scholes call price (host, float64)."""
    points = np.asarray(points, dtype=np.float64)
    s, k, t, sigma, r = (points[:, i] for i in range(5))
    sqrt_t = np.sqrt(t)
    d1 = (np.log(s / k) + (r + 0.5 * sigma ** 2) * t) / (sigma * sqrt_t)
    d2 = d1 - sigma * sqrt_t
    return s * norm.cdf(d1) - k * np.exp(-r * t) * norm.cdf(d2)


def bs_div_np(points, _data=None):
    """The call with dividend yield ``TT_Q``."""
    points = np.asarray(points, dtype=np.float64)
    s, k, t, sigma, r = (points[:, i] for i in range(5))
    sqrt_t = np.sqrt(t)
    d1 = (np.log(s / k) + (r - TT_Q + 0.5 * sigma ** 2) * t) \
        / (sigma * sqrt_t)
    d2 = d1 - sigma * sqrt_t
    return (s * np.exp(-TT_Q * t) * norm.cdf(d1)
            - k * np.exp(-r * t) * norm.cdf(d2))


def basket_np(points, _data=None):
    """Config 4's additive basket on [-1, 1]^10."""
    p = np.asarray(points, dtype=np.float64)
    return np.sum(SLIDER_W * np.sin(p), axis=1) + 0.25 * np.sum(p ** 2,
                                                               axis=1)


def sample_points(n, seed=0, domain=DOMAIN, rng=None):
    """n points uniform in [2 %, 98 %] of each range.  Drawn from
    ``rng`` when given (later batches of one stream), else from
    ``seed``."""
    rng = np.random.default_rng(seed) if rng is None else rng
    lo = np.array([b[0] for b in domain])
    hi = np.array([b[1] for b in domain])
    return lo + (hi - lo) * rng.uniform(0.02, 0.98, size=(n, len(domain)))


@dataclass(frozen=True)
class Widths:
    nodes: int      # nodes a dim, dense and TT
    n: int          # points a call
    boxes: int      # boxes and scenarios a call
    tt_rank: int
    check: int      # points of the host-path checks
    analytic: float  # factor on the two analytic ceilings


FULL = Widths(11, 1 << 20, 1 << 17, 15, 4096, 1.0)
SMALL = Widths(9, 4096, 512, 8, 512, SMALL_ANALYTIC_FACTOR)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def dev(a, ref, floor=0.0) -> float:
    """max|a - ref| / max(max|ref|, floor)."""
    a, ref = _host(a), _host(ref)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), floor))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Bench:
    """The run's clock, inputs and printed lines."""

    def __init__(self, device, small, reps, seed, card):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.small = small
        self.w = SMALL if small else FULL
        self.reps = reps
        self.seed = seed
        self.card = card
        self.rows = []
        self.timed = []   # (base name, fn, batches) for the busy shares

    def name(self, base: str) -> str:
        """Full-width card numbers keep the metric's name; any other
        run's are rehearsal numbers and say so."""
        return base if self.cuda and not self.small else f"rehearsal.{base}"

    def emit(self, line: dict) -> None:
        print(json.dumps(line), flush=True)

    def batches(self, seed, draw, nbytes):
        """Batches drawn one after another from ``seed``'s stream (the
        first is bench.py's input), enough that together they exceed
        the L2 cache: at least three."""
        count = 3 if self.small else max(3, L2_BYTES // nbytes + 1)
        rng = np.random.default_rng(seed + self.seed)
        return [draw(rng) for _ in range(count)]

    def on(self, array):
        return torch.tensor(array, dtype=torch.float64, device=self.device)

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def samples(self, fn, batches) -> list:
        """Milliseconds of ``reps`` calls after ``WARMUP``, rotating over
        ``batches``: CUDA events on a card, the host clock on the CPU."""
        for i in range(WARMUP):
            fn(batches[i % len(batches)])
        self.sync()
        times = []
        for i in range(self.reps):
            b = batches[i % len(batches)]
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(b)
                stop.record()
                stop.synchronize()
                times.append(start.elapsed_time(stop))
            else:
                t0 = time.perf_counter()
                fn(b)
                times.append((time.perf_counter() - t0) * 1e3)
        return times

    def build_s(self, build) -> float:
        t0 = time.perf_counter()
        build()
        self.sync()
        return time.perf_counter() - t0

    def rate(self, base, fn, batches, n, unit, per_call=1, **check):
        """A throughput row: ``per_call * n`` results a call."""
        ms = self.samples(fn, batches)
        self.timed.append((base, fn, batches))
        return timing(ms, value=per_call * n / (np.median(ms) / 1e3),
                      unit=unit, n=n, **check)

    def busy_shares(self) -> None:
        """device time over wall time across ``BUSY_CALLS`` calls of each
        timed row, under ``torch.profiler``; after the timed pass, so
        tracing never touches a timed number.  The kernel rows go first:
        on the card, once traces have recorded many kernels, later
        traces miss launches of the kernels this repository builds,
        more of them each time, down to none (torch's own kernels are
        still recorded)."""
        for base, fn, batches in sorted(
                self.timed, key=lambda row: row[0] not in KERNEL_ROWS):
            line = {"busy_share": "not measured", "of": self.name(base),
                    "calls": BUSY_CALLS, "device": self.card}
            t0 = time.perf_counter()
            if self.cuda:
                try:
                    line.update(_profiled(fn, batches, base in KERNEL_ROWS))
                except Exception as e:   # the one line allowed to miss
                    log(f"busy share of {base}: {type(e).__name__}: {e}")
            self.emit(dict(line, trace_s=time.perf_counter() - t0))


def _profiled(fn, batches, kernel_row) -> dict:
    """The device time ``torch.profiler`` records over ``BUSY_CALLS``
    calls, and the wall time.  A kernel row whose trace lacks any of its
    launches is not measured (see ``Bench.busy_shares``)."""
    from torch.profiler import ProfilerActivity, profile
    fn(batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(BUSY_CALLS):
            fn(batches[i % len(batches)])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device_ms = sum(e.device_time_total for e in events) / 1e3
    seen = sum(e.count for e in events if "fused_eval_kernel" in e.key)
    out = {"device_ms": device_ms, "wall_ms": wall_ms}
    if kernel_row:
        out["kernel_launches_traced"] = seen
    if device_ms > 0 and (seen == BUSY_CALLS or not kernel_row):
        out["busy_share"] = device_ms / wall_ms
    return out


def timing(ms, **fields) -> dict:
    return dict(fields, median_ms=float(np.median(ms)),
                p75_ms=float(np.percentile(ms, 75)), samples=len(ms))


def one_sample(seconds, **fields) -> dict:
    return timing([seconds * 1e3], value=seconds, unit="s", **fields)


# --- the rows, in bench.py's order -------------------------------------------
#
# Each takes the run (``b``) and the state the rows share (``s``), and
# returns its line's fields.  A row that needs what an earlier row
# failed to make raises, and only that row fails.


def dense_points(b, s):
    """The dense rows' inputs: bench.py's seed-1 points, f64 and f32."""
    if "pts64" not in s:
        w = b.w
        host = b.batches(1, lambda rng: sample_points(w.n, rng=rng),
                         w.n * 5 * 4)
        s["pts64"] = [b.on(h) for h in host]
        s["pts32"] = [p.float() for p in s["pts64"]]
    return s["pts64"], s["pts32"]


def dense_f64(s, orders=(0,) * 5):
    """The f64 path on the first dense batch, the dense rows' yardstick."""
    key = ("ref64", orders)
    if key not in s:
        s[key] = eval_ops.eval_batch(s["cheb"].tensor_values, *s["grid"],
                                     s["pts64"][0], orders)
    return s[key]


def analytic(b, cheb) -> dict:
    """The interpolant against the analytic call at bench.py's seed-7
    check points: max relative error where |price| > 1 (the row's
    deviation), and max abs over the price scale."""
    w = b.w
    pts = sample_points(w.check, 7 + b.seed)
    exact = bs_price_np(pts)
    approx = _host(eval_ops.eval_batch(cheb.tensor_values,
                                       *cheb._grid_tuples(), b.on(pts),
                                       (0,) * 5))
    liquid = np.abs(exact) > 1.0
    rel = np.abs(approx - exact)[liquid] / np.abs(exact)[liquid]
    return dict(n=w.nodes ** 5, deviation=float(rel.max()),
                ceiling=ANALYTIC * w.analytic,
                against=f"analytic call price at {w.check:,} points "
                        f"(seed 7), max relative error where |price| > 1",
                max_abs_over_scale=dev(approx, exact))


def new_dense(b):
    return ChebyshevApproximation(bs_price_np, 5, DOMAIN, [b.w.nodes] * 5,
                                  vectorized=True, device=b.device)


def build_cold(b, s):
    cheb = new_dense(b)
    seconds = b.build_s(lambda: cheb.build(verbose=False))
    s["cheb"] = cheb
    s["grid"] = cheb._grid_tuples()
    s["grid32"] = tuple(tuple(a.float() for a in g) for g in s["grid"])
    s["tensor32"] = cheb.tensor_values.float()
    return one_sample(seconds, **analytic(b, cheb))


def build_warm(b, s):
    ms = []
    for _ in range(b.reps):
        cheb = new_dense(b)
        ms.append(b.build_s(lambda: cheb.build(verbose=False)) * 1e3)
    return timing(ms, value=float(np.median(ms)) / 1e3, unit="s",
                  **analytic(b, cheb))


def f32_plain(b, s):
    pts64, pts32 = dense_points(b, s)
    t32, g32 = s["tensor32"], s["grid32"]

    def run(p):
        return eval_ops.eval_batch(t32, *g32, p, (0,) * 5)

    return b.rate("bs5d_11n_f32_plain_queries_per_sec", run, pts32, b.w.n,
                  "queries/s", deviation=dev(run(pts32[0]), dense_f64(s)),
                  ceiling=F32, against="f64 ops.eval.eval_batch on the "
                                       "first batch")


def f32_fused(b, s):
    """The headline: K1 through ``ops.fused_eval.fused_eval_batch``."""
    pts64, pts32 = dense_points(b, s)
    cheb, grid = s["cheb"], s["grid"]
    shape = tuple(cheb.tensor_values.shape)

    def run(p):
        return fused_eval.fused_eval_batch(cheb.tensor_values, *grid, p,
                                           (0,) * 5)

    before = fused_eval.launches
    d = dev(run(pts32[0]), dense_f64(s))
    row = b.rate("bs5d_11n_f32_batched_queries_per_sec", run, pts32,
                 b.w.n, "queries/s", deviation=d, ceiling=F32,
                 against="f64 ops.eval.eval_batch on the first batch")
    row["launches"] = fused_eval.launches - before
    row["kernel_ms"] = kernel_ms(b, fused_eval._pack(
        cheb.tensor_values, *grid, (0,) * 5, shape, torch.float32),
        shape, pts32)
    row["vs_baseline"] = row["value"] * BASELINE_SINGLE_QUERY_S
    row["baseline"] = ("the upstream reference's single-query "
                       "vectorized_eval on a CPU, 0.065 ms a query "
                       "(BASELINE.md)")
    return row


def kernel_ms(b, packed, shape, batches):
    """Median ms of the kernel alone (``_launch`` on packed operands),
    or "not measured" off the card."""
    if not b.cuda:
        return "not measured"
    return float(np.median(b.samples(
        lambda p: fused_eval._launch(*packed, shape, p), batches)))


def f32_delta(b, s):
    pts64, pts32 = dense_points(b, s)
    orders = (1, 0, 0, 0, 0)

    def run(p):
        return eval_ops.eval_batch(s["tensor32"], *s["grid32"], p, orders)

    return b.rate("bs5d_11n_f32_delta_queries_per_sec", run, pts32, b.w.n,
                  "queries/s",
                  deviation=dev(run(pts32[0]), dense_f64(s, orders)),
                  ceiling=F32, against="f64 Delta (ops.eval.eval_batch, "
                                       "orders (1,0,0,0,0)), first batch")


def f32_greeks(b, s):
    pts64, pts32 = dense_points(b, s)
    cheb = s["cheb"]

    def run(p):
        return eval_ops.eval_batch_multi(s["tensor32"], *s["grid32"], p,
                                         GREEKS)

    got = run(pts32[0])
    ref = eval_ops.eval_batch_multi(cheb.tensor_values, *s["grid"],
                                    pts64[0], GREEKS)
    d = max(dev(got[k], ref[k]) for k in range(len(GREEKS)))
    return b.rate("bs5d_11n_f32_price_greeks_sets_per_sec", run, pts32,
                  b.w.n, "Greek-sets/s", deviation=d, ceiling=F32,
                  against="f64 ops.eval.eval_batch_multi, each of the 6 "
                          "specs on its own scale, first batch")


def tt_points(b, s):
    """The TT chains' inputs: seed 1 on the TT's own domain (bench.py
    timed them on the dense domain, part of which lies outside the
    TT's, where no ceiling holds)."""
    if "tt64" not in s:
        w = b.w
        host = b.batches(1, lambda rng: sample_points(w.n, domain=TT_DOMAIN,
                                                      rng=rng),
                         w.n * 5 * 4)
        s["tt64"] = [b.on(h) for h in host]
        s["tt32"] = [p.float() for p in s["tt64"]]
    return s["tt64"], s["tt32"]


def tt_build(b, s):
    w = b.w

    def build():
        s["tt"] = ChebyshevTT(bs_div_np, 5, TT_DOMAIN, [w.nodes] * 5,
                              max_rank=w.tt_rank, max_sweeps=10,
                              tolerance=1e-6, vectorized=True,
                              device=b.device)
        s["tt"].build(verbose=False, seed=42 + b.seed)

    seconds = b.build_s(build)
    tt = s["tt"]
    rng = np.random.default_rng(42 + b.seed)
    pts = np.stack([rng.uniform(lo, hi, 50) for lo, hi in TT_DOMAIN], axis=1)
    exact = bs_div_np(pts)
    keep = np.abs(exact) >= 0.50
    err = np.abs((_host(tt.eval_batch(pts)) - exact) / exact)[keep]
    return one_sample(
        seconds, n=tt.total_build_evals, deviation=float(err.max()),
        ceiling=TT_PRICE * w.analytic,
        against=f"analytic price (q = {TT_Q}) at {int(keep.sum())} of 50 "
                f"points (seed 42) with |price| >= 0.50, max relative",
        ranks=tt.tt_ranks, build_evals=tt.total_build_evals,
        price_err_mean_pct=float(err.mean() * 100),
        price_err_max_pct=float(err.max() * 100))


def tt_f64_chain(s, cores_key="tt"):
    key = ("tt_ref64", cores_key)
    if key not in s:
        tt = s[cores_key]
        s[key] = tt_eval.tt_eval_batch(tt._cores_on_device(torch.float64),
                                       np.asarray(tt.domain), s["tt64"][0])
    return s[key]


def tt_f32(b, s):
    tt64, tt32 = tt_points(b, s)
    tt = s["tt"]
    cores32 = tt._cores_on_device(torch.float32)
    dom = np.asarray(tt.domain)

    def run(p):
        return tt_eval.tt_eval_batch(cores32, dom, p)

    return b.rate("bs5d_tt_r15_f32_queries_per_sec", run, tt32, b.w.n,
                  "queries/s", deviation=dev(run(tt32[0]), tt_f64_chain(s)),
                  ceiling=F32, against="the TT f64 chain on the first "
                                       "batch", ranks=tt.tt_ranks)


def tt_hard(b, s):
    """The masked-ALS refinement on the wide domain without dividend,
    where the raw cross degrades: refined against raw."""
    w = b.w
    pts = sample_points(w.check, 7 + b.seed)
    exact = bs_price_np(pts)
    liquid = np.abs(exact) > 1.0
    out = {}
    for label, kw in (("raw", {}),
                      ("refined", {"refine_sweeps": 4,
                                   "refine_samples": 8000})):
        tt = ChebyshevTT(bs_price_np, 5, DOMAIN, [w.nodes] * 5,
                         max_rank=w.tt_rank, vectorized=True,
                         device=b.device)
        out[f"{label}_build_s"] = b.build_s(
            lambda: tt.build(verbose=False, seed=42 + b.seed, **kw))
        got = _host(tt.eval_batch(pts))
        out[f"{label}_max_rel"] = float(
            (np.abs(got - exact)[liquid] / np.abs(exact)[liquid]).max())
        out[f"{label}_evals"] = tt.total_build_evals
    return one_sample(
        out["refined_build_s"], n=out["refined_evals"],
        deviation=out["refined_max_rel"], ceiling=out["raw_max_rel"],
        against=f"analytic price at {w.check:,} points (seed 7), max "
                f"relative where |price| > 1; held to the raw cross's",
        **out)


def tt_delta(b, s):
    tt64, tt32 = tt_points(b, s)
    s["tt_delta"] = s["tt"].differentiate([1, 0, 0, 0, 0])
    cores32 = s["tt_delta"]._cores_on_device(torch.float32)
    dom = np.asarray(s["tt_delta"].domain)

    def run(p):
        return tt_eval.tt_eval_batch(cores32, dom, p)

    return b.rate("bs5d_tt_r15_f32_delta_queries_per_sec", run, tt32,
                  b.w.n, "queries/s",
                  deviation=dev(run(tt32[0]), tt_f64_chain(s, "tt_delta")),
                  ceiling=F32, against="the f64 chain of the "
                                       "differentiate()d TT, first batch")


def f32_book(b, s):
    pts64, pts32 = dense_points(b, s)
    book = tuple(s["tensor32"] * (1.0 + 0.1 * i) for i in range(BOOK))

    def run(p):
        return eval_ops.eval_batch_models(book, *s["grid32"], p, (0,) * 5)

    got = run(pts32[0])
    ref = dense_f64(s)
    d = max(dev(got[i], (1.0 + 0.1 * i) * ref) for i in range(BOOK))
    return b.rate("bs5d_11n_f32_book8_model_evals_per_sec", run, pts32,
                  b.w.n, "model-evals/s", per_call=BOOK, deviation=d,
                  ceiling=F32, against="each model's f64 values on the "
                                       "first batch, on its own scale")


def dd(b, s):
    """K3 through ``ops.eval_dd.eval_batch_dd``."""
    pts64, _ = dense_points(b, s)
    cheb, grid = s["cheb"], s["grid"]
    shape = tuple(cheb.tensor_values.shape)

    def run(p):
        return eval_dd.eval_batch_dd(cheb.tensor_values, *grid, p, (0,) * 5)

    before = fused_dd.launches
    d = dev(run(pts64[0]), dense_f64(s))
    row = b.rate("bs5d_11n_dd_queries_per_sec", run, pts64, b.w.n,
                 "queries/s", deviation=d, ceiling=DD,
                 against="f64 ops.eval.eval_batch on the first batch")
    row["launches"] = fused_dd.launches - before
    row["kernel_ms"] = kernel_ms(
        b, fused_dd._pack(cheb.tensor_values, *grid, (0,) * 5, shape),
        shape, pts64)
    return row


def to_tt_dd(b, s):
    pts64, _ = dense_points(b, s)
    comp = s["cheb"].to_tt(tolerance=1e-13)
    s["comp"] = comp
    cores = comp._cores_on_device(torch.float64)
    dom = np.asarray(comp.domain, dtype=np.float64)

    def run(p):
        return tt_eval_dd.tt_eval_batch_dd(cores, dom, p, groups="auto")

    return b.rate("bs5d_11n_to_tt_dd_queries_per_sec", run, pts64, b.w.n,
                  "queries/s", deviation=dev(run(pts64[0]), dense_f64(s)),
                  ceiling=TO_TT,
                  against="the dense f64 path on the first batch",
                  ranks=comp.tt_ranks,
                  groups=list(tt_eval_dd.tt_dd_auto_groups(
                      tt_eval.core_shapes(cores))))


def box_batches(b, s):
    """bench.py's seed-21 stream: 5-D boxes, then the conditional
    points of (K, sigma, r), batch after batch."""
    if "boxes" not in s:
        nb = b.w.boxes
        lo, hi = np.asarray(DOMAIN)[:, 0], np.asarray(DOMAIN)[:, 1]
        keep = [1, 3, 4]

        def draw(rng):
            b_lo = rng.uniform(lo, hi, (nb, 5))
            b_hi = rng.uniform(b_lo, hi[None, :])
            cond = rng.uniform(lo[keep], hi[keep], (nb, 3))
            return np.stack([b_lo, b_hi], axis=-1), cond

        # enough batches for the smaller working set, (S, T) boxes plus
        # points: 56 bytes a scenario
        host = b.batches(21, draw, nb * 56)
        s["boxes"] = [b.on(bx) for bx, _ in host]
        s["cond"] = [(b.on(bx[:, [0, 2], :]), b.on(c)) for bx, c in host]
    return s["boxes"], s["cond"]


def tt_dd_masses(b, s):
    boxes, _ = box_batches(b, s)
    cores = s["comp"]._cores_on_device(torch.float64)
    dom = np.asarray(s["comp"].domain, dtype=np.float64)

    def run(bx):
        return integrate.tt_integrate_box_batch_dd(cores, dom, bx,
                                                   groups="auto")

    ref = integrate.tt_integrate_box_batch(cores, dom, boxes[0])
    return b.rate("bs5d_to_tt_dd_bucket_masses_boxes_per_sec", run, boxes,
                  b.w.boxes, "boxes/s",
                  deviation=dev(run(boxes[0]), ref, 1e-300), ceiling=DD,
                  against="the f64 TT box integrals "
                          "(ops.integrate.tt_integrate_box_batch) of the "
                          "to_tt(1e-13) cores, first batch")


def dd_cond(b, s):
    _, cond = box_batches(b, s)
    cheb, grid = s["cheb"], s["grid"]
    dom = np.asarray(DOMAIN, dtype=np.float64)

    def run(c):
        return integrate.partial_integrate_eval_batch_dd(
            cheb.tensor_values, dom, *grid, (0, 2), c[0], c[1])

    ref = integrate.partial_integrate_eval_batch(
        cheb.tensor_values, dom, *grid, (0, 2), cond[0][0], cond[0][1])
    return b.rate("bs5d_11n_dd_cond_exp_scenarios_per_sec", run, cond,
                  b.w.boxes, "scenarios/s",
                  deviation=dev(run(cond[0]), ref, 1e-300), ceiling=DD,
                  against="f64 ops.integrate.partial_integrate_eval_batch "
                          "over (S, T) on the first batch")


def tt_dd(b, s):
    w = b.w
    tt = s["tt"]
    host = b.batches(9, lambda rng: np.stack(
        [rng.uniform(lo, hi, w.n) for lo, hi in TT_DOMAIN], axis=1),
        w.n * 5 * 8)
    pts = [b.on(h) for h in host]
    cores = tt._cores_on_device(torch.float64)
    dom = np.asarray(tt.domain)

    def run(p):
        return tt_eval_dd.tt_eval_batch_dd(cores, dom, p)

    ref = tt_eval.tt_eval_batch(cores, dom, pts[0])
    return b.rate("bs5d_tt_r15_dd_queries_per_sec", run, pts, w.n,
                  "queries/s", deviation=dev(run(pts[0]), ref), ceiling=DD,
                  against="the TT f64 chain on the first batch (seed 9)")


def slider_dd_report(b, s):
    w = b.w
    ns = w.n // 4
    slider = ChebyshevSlider(basket_np, SLIDER_D, [[-1.0, 1.0]] * SLIDER_D,
                             [9] * SLIDER_D, [[i] for i in range(SLIDER_D)],
                             [0.0] * SLIDER_D, vectorized=True,
                             device=b.device)
    slider.build(verbose=False)
    data, groups = slider._slide_data(), slider._groups()
    host = b.batches(11, lambda rng: rng.uniform(-1, 1, (ns, SLIDER_D)),
                     ns * SLIDER_D * 8)
    pts = [b.on(h) for h in host]

    def run(p):
        return slider_eval.slider_multi_batch_dd(data, slider.pivot_value,
                                                 groups, SLIDER_SPECS, p)

    got = _host(run(pts[0][:w.check]))
    d = max(dev(got[:, m], slider.eval_batch(host[0][:w.check], list(spec)),
                1e-3) for m, spec in enumerate(SLIDER_SPECS))
    return b.rate("slider10d_9n_dd_greek_report_sets_per_sec", run, pts, ns,
                  "report-sets/s", deviation=d, ceiling=DD,
                  against=f"the class path (ChebyshevSlider.eval_batch) "
                          f"per spec on {w.check:,} points, scale at "
                          f"least 1e-3", specs=len(SLIDER_SPECS))


def f64_dense(b, s):
    pts64, _ = dense_points(b, s)
    cheb, grid = s["cheb"], s["grid"]

    def run(p):
        return eval_ops.eval_batch(cheb.tensor_values, *grid, p, (0,) * 5)

    sub = pts64[0][:b.w.check]
    return b.rate("bs5d_11n_f64_queries_per_sec", run, pts64, b.w.n,
                  "queries/s",
                  deviation=dev(run(sub), cheb.eval_batch_host(sub, [0] * 5)),
                  ceiling=F64, against=f"the host path (eval_batch_host) "
                                       f"on {b.w.check:,} points")


def tt_f64(b, s):
    tt64, _ = tt_points(b, s)
    tt = s["tt"]
    cores = tt._cores_on_device(torch.float64)
    dom = np.asarray(tt.domain)

    def run(p):
        return tt_eval.tt_eval_batch(cores, dom, p)

    sub = tt64[0][:b.w.check]
    host = [tt.eval(p) for p in _host(sub)]
    return b.rate("bs5d_tt_r15_f64_queries_per_sec", run, tt64, b.w.n,
                  "queries/s", deviation=dev(run(sub), host), ceiling=F64,
                  against=f"the host chain (ChebyshevTT.eval) on "
                          f"{b.w.check:,} points")


ROWS = (
    ("bs5d_11n_build_cold_s", build_cold),
    ("bs5d_11n_build_warm_s", build_warm),
    ("bs5d_11n_f32_plain_queries_per_sec", f32_plain),
    ("bs5d_11n_f32_batched_queries_per_sec", f32_fused),
    ("bs5d_11n_f32_delta_queries_per_sec", f32_delta),
    ("bs5d_11n_f32_price_greeks_sets_per_sec", f32_greeks),
    ("bs5d_tt_r15_build_s", tt_build),
    ("bs5d_tt_r15_f32_queries_per_sec", tt_f32),
    ("bs5d_tt_hard_refined_build_s", tt_hard),
    ("bs5d_tt_r15_f32_delta_queries_per_sec", tt_delta),
    ("bs5d_11n_f32_book8_model_evals_per_sec", f32_book),
    ("bs5d_11n_dd_queries_per_sec", dd),
    ("bs5d_11n_to_tt_dd_queries_per_sec", to_tt_dd),
    ("bs5d_to_tt_dd_bucket_masses_boxes_per_sec", tt_dd_masses),
    ("bs5d_11n_dd_cond_exp_scenarios_per_sec", dd_cond),
    ("bs5d_tt_r15_dd_queries_per_sec", tt_dd),
    ("slider10d_9n_dd_greek_report_sets_per_sec", slider_dd_report),
    ("bs5d_11n_f64_queries_per_sec", f64_dense),
    ("bs5d_tt_r15_f64_queries_per_sec", tt_f64),
)
KERNEL_ROWS = {"bs5d_11n_f32_batched_queries_per_sec": "K1",
               "bs5d_11n_dd_queries_per_sec": "K3"}


def _card(device: str) -> str:
    if device == "cpu":
        return "cpu"
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise SystemExit(
            "bench_torch: no CUDA card (torch.cuda.is_available() is "
            "False); this benchmark measures the card and never falls "
            "back to the CPU.  For the CPU rehearsal pass --device cpu "
            "--small")
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def passed(rows) -> bool:
    return (len(rows) == len(ROWS)
            and all(r.get("ok") is True for r in rows))


def main(device="cuda", small=False, reps=40, seed=0) -> list[dict]:
    """Run every row; print the lines; return the metric lines."""
    card = _card(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    b = Bench(device, small, reps, seed, card)
    b.emit({
        "bench": "bench_torch", "card": card,
        "device_name": (torch.cuda.get_device_name(0) if b.cuda
                        else "cpu"),
        "device_count": torch.cuda.device_count() if b.cuda else 0,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "seed": seed, "reps": reps, "small": small,
        "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision()})
    if b.cuda:
        # K1 and K3 share one source; its nvcc build is set-up time.
        line = {"setup": "nvcc build of csrc/fused_eval.cu (K1, K3)",
                "ok": True}
        t0 = time.perf_counter()
        try:
            fused_eval._library()
        except Exception as e:   # the K1 and K3 rows then fail
            line.update(ok=False, error=f"{type(e).__name__}: {e}")
        b.emit(dict(line, seconds=time.perf_counter() - t0))
    s = {}
    for base, row_fn in ROWS:
        metric = b.name(base)
        t0 = time.perf_counter()
        try:
            row = row_fn(b, s)
            # the row's whole wall time: inputs, checks, timed calls
            row = {"metric": metric, **row, "device": card,
                   "row_s": time.perf_counter() - t0}
            row["ok"] = bool(row["deviation"] <= row["ceiling"])
            if b.cuda and base in KERNEL_ROWS and not row["launches"] > 0:
                row["ok"] = False
                row["error"] = f"{KERNEL_ROWS[base]} was never launched"
        except Exception as e:
            log(f"{metric}:\n{traceback.format_exc()}")
            row = {"metric": metric, "device": card, "ok": False,
                   "error": f"{type(e).__name__}: {e}"}
        b.rows.append(row)
        b.emit(row)
        if not row["ok"]:
            log(f"{metric}: FAILED "
                + (row.get("error") or f"deviation {row['deviation']:.3e} "
                                       f"> {row['ceiling']:g}"))
    b.busy_shares()
    b.emit({"ok": passed(b.rows), "rows": len(b.rows),
            "failed": [r["metric"] for r in b.rows if not r["ok"]]})
    return b.rows


def cli(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--small", action="store_true",
                        help="the rehearsal widths (9 nodes, 4,096 points)")
    parser.add_argument("--reps", type=int, default=40)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    rows = main(args.device, args.small, args.reps, args.seed)
    return 0 if passed(rows) else 1


if __name__ == "__main__":
    sys.exit(cli())

"""Benchmark of the PyTorch port on one CUDA card: every row of bench.py,
the baseline table's five configurations, the calculus workloads and
the rest of scripts/' measurements.

The same workloads as ``bench.py`` (the JAX package's TPU bench, which
stays as it is): the 5-D Black-Scholes call on an 11^5 Chebyshev grid
queried at N = 2^20 points (f32 plain and through the fused kernel K1,
Delta, price plus five Greeks, an 8-model book, the dd tier through K3,
f64), the reference's rank-15 TT-Cross configuration (f32, Delta, dd,
f64) and the masked-ALS hard configuration, ``to_tt(1e-13)`` of the
11^5 interpolant served by the grouped dd chain, dd bucket masses and
dd conditional expectations over 2^17 boxes, and the 10-D slider's dd
Greek report at 2^18 points.  Then the rows of
``scripts/run_baseline_table.py`` that bench.py lacks (BASELINE.json's
configurations 1-5: the single-query host path through the C kernels,
the 2-D kinked spline, the 10-D slider's engines, the 4-D portfolio's
TT-ALS builds and completion) and of ``scripts/bench_integrate_batch.py``
(dense and TT box integrals, conditional expectations, a six-model
book's integrals, roots and minima over 4,096 scenarios).  Then the
rest of ``scripts/``: the dense and TT scattered-data fits
(``bench_fit.py``, ``bench_tt_fit.py``), the certified global searches
of ``bench_global_calculus.py``, the 10-D TT search of
``bench_tt_minimize.py``, the zero isolations of
``bench_zero_isolation.py``, and the grouped TT chains of
``bench_tt_book_grouped.py``, ``bench_tt_grouped.py`` and
``bench_highd_grouping.py``.  Every row is held to its accuracy ceiling
(scale-normalized max deviation, max|a - ref| / max|ref|, unless its
``against`` says otherwise).

Run from the repository root, on one card:

    python3 bench_torch.py [--reps 40] [--seed 0] [--rows NAME[,NAME...]]

``--rows`` runs the rows whose names start with one of the given names
(``--rows spline2d_`` runs configuration 3's three rows); without it,
every row runs.

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
``kernel_ms`` on the K1 and K3 rows; ``host_cpu`` on the host rows);
last ``{"ok": ..., "rows": ..., "failed": [...]}``, counting the rows
selected.  Diagnostics go to
standard error.  The exit code is non-zero if any row breaks its
ceiling, raises, or is missing; a row that fails does not stop the
rows after it.

Timing: CUDA events around each call, 3 warm-ups then ``--reps`` timed
calls, each row rotating over at least three input batches whose total
exceeds the card's 50 MB L2 (a server's next request arrives cold);
the median and the 75th percentile with the sample count (a call over
a second takes one warm-up and at most 5 timed calls;
a call over 20 s is its own one sample).  Builds are timed on the host
clock around a build that ends in ``torch.cuda.synchronize()``; so are
the rows that run host NumPy only (the host fits, the TT search, the
isolations), which name the host's CPU and are not traced.
The host rows (``*_host_*_us``) time the host, not the card: 10 warm
calls, then at least 300 in blocks, the median over the blocks in
microseconds a call; the line names the host's CPU.  ``--seed S`` is
added to each seed of the scripts (bench.py's 1, 7, 9, 11, 21, 42; the
baseline table's 0, 1, 2, 5, 42; 72 for the scenarios; the rest of
scripts/' 0, 3, 7, 11, the witnesses' 41 and 100), so ``--seed 0``
draws their inputs.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import platform
import subprocess
import sys
import time
import traceback
import warnings
from dataclasses import dataclass

import numpy as np
import torch
from scipy.stats import norm

from pychebyshev_tpu_torch import (
    BatchedEvaluator,
    ChebyshevApproximation,
    ChebyshevSlider,
    ChebyshevSpline,
    ChebyshevTT,
    solve_system,
)
from pychebyshev_tpu_torch.ops import eval as eval_ops
from pychebyshev_tpu_torch.ops import (
    eval_dd,
    fused_dd,
    fused_eval,
    integrate,
    slider_eval,
    subdivision,
    tt_eval,
    tt_eval_dd,
)
from pychebyshev_tpu_torch.ops.chebyshev import (
    barycentric_weights_np,
    nodes_for_dim_np,
)
from pychebyshev_tpu_torch.ops.quadrature import sub_interval_weights
from pychebyshev_tpu_torch.serving import integrate_book
from pychebyshev_tpu_torch.utils import ceval, fitting, globalcalc

#: The upstream reference's single-query ``vectorized_eval`` on a CPU,
#: ~0.065 ms a query (BASELINE.md); the headline's ``vs_baseline`` base.
BASELINE_SINGLE_QUERY_S = 0.065e-3
L2_BYTES = 50 * 2 ** 20
WARMUP = 3
#: A row whose warm call takes longer takes one warm call and at most
#: ``LONG_REPS`` samples.
LONG_CALL_S = 1.0
LONG_REPS = 5
#: A warm call longer than this is the row's one sample, as a build's
#: is: at that length a second call costs more than the noise it
#: removes (the 10-D TT search, the zero isolations, the host TT fit).
ONE_CALL_S = 20.0
#: The host rows: warm calls, then at least this many timed calls.
HOST_WARM = 10
HOST_CALLS = 300

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
#: The C host path against the NumPy host path (chip_smoke.py phase 16).
HOST_C_VS_NUMPY = 1e-14
#: ... on derivative specs, of each spec's scale: the C kernel folds the
#: differentiation matrices in another order (ROADMAP.md queue 3).
HOST_C_VS_NUMPY_SPECS = 1e-10
#: Config 5's portfolio against its closed form (chip_smoke.py phase 37).
PORTFOLIO_ERR = 1e-4
#: Batched roots along S against single ``roots`` calls, absolute in S:
#: where the slice's last coefficient is rounding noise they differ by
#: up to 1.26e-10 (ROADMAP.md queue 3).
ROOTS_VS_SINGLE = 1e-9
#: Batched minima against single ``minimize`` calls: locations absolute
#: in S, values of the scale (chip_smoke.py phase 31).
LOCATION_VS_SINGLE = 1e-10
# The fits (scripts/bench_fit.py:37-50, bench_tt_fit.py:36-47): the
# dense 9^3 fit's domain, noise and penalty, the device Grams' ceilings
# against the host's f64 Gram (chip_smoke.py:239-240), the TT fit's
# noise and its device rms against the host's (chip_smoke.py:243).
FIT_DOMAIN = [[0.0, 2.0], [-1.0, 1.0], [0.0, 1.0]]
FIT_NODES = [9, 9, 9]
FIT_NOISE = 1e-3
FIT_L2 = 1e-8
FIT_GRAM_F32 = 1e-4
FIT_GRAM_DD = 1e-11
TT_FIT_D = 5
TT_FIT_NOISE = 1e-4
TT_FIT_RMS_REL = 0.1
# Global calculus (chip_smoke.py:262-264): a search's value against the
# same call on a CPU build, of the model's scale; a witness's slack.
GLOBAL_VS_CPU = 1e-12
WITNESS_EPS = 1e-10
#: |gradient| at a critical point over its max on the grid.
GRAD_AT_CRITICAL = 1e-10
#: The 10-D TT search's witness points (uniform in [-1, 1]^10).
TT_SEARCH_WITNESS_SEED = 100
# The grouped TT chains: the first-order specs of the six-model book
# (bench_tt_book_grouped.py:62-63), the points each chain is checked on
# (:79-80; bench_highd_grouping.py:67) and bench_tt_grouped.py's probe
# (:71).
FIRST_ORDER = tuple(tuple(1 if i == k else 0 for i in range(5))
                    for k in range(5))
CHAIN_CHECK = 16384
TO_TT_PROBE = 65536
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
SLIDER_SPECS = ((0,) * SLIDER_D,) + tuple(
    tuple(1 if j == k else 0 for j in range(SLIDER_D)) for k in (0, 2, 4, 6))
SLIDER_DOMAIN = [[-1.0, 1.0]] * SLIDER_D
# The baseline table's configurations (scripts/run_baseline_table.py):
# config 1's single query point (:195) and the reference's protocol
# (:60-104), config 3's kinked spline (:403-447), config 5's portfolio
# (:555-611).
QUERY_POINT = [100.0, 100.0, 0.8, 0.2, 0.03]
PROTOCOL_POINTS = 200
PROTOCOL_SPECS = {"delta": [1, 0, 0, 0, 0], "gamma": [2, 0, 0, 0, 0],
                  "vega": [0, 0, 0, 1, 0], "rho": [0, 0, 0, 0, 1],
                  "theta": [0, 0, 1, 0, 0]}
SPLINE_DOMAIN = [[0.0, 2.0], [0.0, 1.0]]
SPLINE_NODES = [17, 17]
SPLINE_KNOTS = [[1.0], []]
SPLINE_MARGIN = 0.001
PORTFOLIO_DOMAIN = [[80.0, 120.0], [0.25, 2.0], [0.1, 0.5], [0.01, 0.05]]
PORTFOLIO_AT = [100.0, 1.0, 0.3, 0.03]


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


def bs_div_greeks_np(points):
    """The analytic Greeks of ``bs_div_np`` (run_baseline_table.py:76-95;
    theta is -dV/dT plus the dividend term)."""
    points = np.asarray(points, dtype=np.float64)
    s, k, t, sigma, r = (points[:, i] for i in range(5))
    sqrt_t = np.sqrt(t)
    d1 = (np.log(s / k) + (r - TT_Q + 0.5 * sigma ** 2) * t) \
        / (sigma * sqrt_t)
    d2 = d1 - sigma * sqrt_t
    pdf, dq, dr = norm.pdf(d1), np.exp(-TT_Q * t), np.exp(-r * t)
    return {
        "delta": dq * norm.cdf(d1),
        "gamma": dq * pdf / (s * sigma * sqrt_t),
        "vega": s * dq * pdf * sqrt_t,
        "rho": k * t * dr * norm.cdf(d2),
        "theta": (-s * dq * pdf * sigma / (2 * sqrt_t)
                  - r * k * dr * norm.cdf(d2)
                  + TT_Q * s * dq * norm.cdf(d1)),
    }


def basket_np(points, _data=None):
    """Config 4's additive basket on [-1, 1]^10, and on [-1, 1]^d with
    weights ``linspace(0.5, 1.5, d)`` (bench_highd_grouping.py:50-54)."""
    p = np.asarray(points, dtype=np.float64)
    w = np.linspace(0.5, 1.5, p.shape[1])
    return np.sum(w * np.sin(p), axis=1) + 0.25 * np.sum(p ** 2, axis=1)


def payoff_np(points, _data=None):
    """Config 3's kinked payoff, max(x0 - 1, 0) e^(-0.1 x1)."""
    p = np.asarray(points, dtype=np.float64)
    return np.maximum(p[:, 0] - 1.0, 0.0) * np.exp(-0.1 * p[:, 1])


def instrument_a_np(points, _data=None):
    """Config 5's first instrument, a softplus call on (S, T, sigma, r)."""
    p = np.asarray(points, dtype=np.float64)
    s, t, sigma, r = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    return (5.0 * np.log1p(np.exp((s - 100.0) / 5.0)) * np.exp(-r * t)
            * (1 + 0.5 * sigma))


def instrument_b_np(points, _data=None):
    """Config 5's second instrument, a bond plus a volatility term."""
    p = np.asarray(points, dtype=np.float64)
    s, t, sigma, r = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    return 100.0 * np.exp(-r * t) + 0.1 * s * sigma * np.sqrt(t)


def auto_n_np(x, _data=None):
    """The auto-N function of run_baseline_table.py:545-550."""
    return float(np.sin(3 * x[0]) + np.exp(x[0]))


def sample_points(n, seed=0, domain=DOMAIN, rng=None, margin=0.02):
    """n points uniform in [margin, 1 - margin] of each range (2 % by
    default).  Drawn from ``rng`` when given (later batches of one
    stream), else from ``seed``."""
    rng = np.random.default_rng(seed) if rng is None else rng
    lo = np.array([b[0] for b in domain])
    hi = np.array([b[1] for b in domain])
    return lo + (hi - lo) * rng.uniform(margin, 1 - margin,
                                        size=(n, len(domain)))


def protocol_points(seed):
    """The reference's protocol points (run_baseline_table.py:98-103):
    200 uniform on the TT domain, one dim after another."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(lo, hi, PROTOCOL_POINTS)
                     for lo, hi in TT_DOMAIN], axis=1)


def additive_interpolant_np(points, n_nodes):
    """Config 4's slider computed independently on the host: each dim's
    1-D barycentric interpolant of the basket's slice through the pivot
    0 (NumPy, f64), summed (the pivot value is 0)."""
    total = np.zeros(len(points))
    for d in range(SLIDER_D):
        x = nodes_for_dim_np(-1.0, 1.0, n_nodes)
        w = barycentric_weights_np(x)
        grid = np.zeros((n_nodes, SLIDER_D))
        grid[:, d] = x
        v = basket_np(grid)
        diff = points[:, d, None] - x[None, :]
        hit = np.abs(diff) < 1e-14
        with np.errstate(divide="ignore", invalid="ignore"):
            r = w / diff
            row = r / r.sum(axis=1, keepdims=True)
        row[hit.any(axis=1)] = hit[hit.any(axis=1)].astype(float)
        total += row @ v
    return total


def quad_row_np(n, a, c, lo, hi):
    """The host sub-interval Fejer row of one dim, scaled by its
    half-width (zero for a zero-measure interval)."""
    if lo == hi:
        return np.zeros(n)
    return sub_interval_weights(n, 2.0 * (lo - a) / (c - a) - 1.0,
                                2.0 * (hi - a) / (c - a) - 1.0) * (c - a) / 2


def bary_row_np(x, nodes):
    """The host barycentric row of coordinate ``x`` (one-hot at a node)."""
    hit = np.abs(x - nodes) < 1e-14
    if hit.any():
        return hit.astype(float)
    r = barycentric_weights_np(nodes) / (x - nodes)
    return r / r.sum()


def contract_np(tensor, rows) -> float:
    """The host tensor contracted with one row per dim, last dim first."""
    t = tensor
    for row in reversed(rows):
        t = np.tensordot(t, row, axes=([t.ndim - 1], [0]))
    return float(t)


def host_cpu() -> str:
    """The host's CPU model, for the host rows: ``/proc/cpuinfo``'s model
    name, or where a container's kernel hides it ("unknown"), the
    vendor, family, model number and clock it does give."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break   # the end of the first processor's block
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        return platform.machine() or "unknown"
    if info.get("model name", "unknown") != "unknown":
        return info["model name"]
    return (f"{info.get('vendor_id', '?')} family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')}, "
            f"{info.get('cpu MHz', '?')} MHz, {os.cpu_count()} CPUs")


@dataclass(frozen=True)
class Widths:
    nodes: int      # nodes a dim, dense and TT
    n: int          # points a call
    boxes: int      # boxes and scenarios a call
    tt_rank: int
    check: int      # points of the host-path checks
    analytic: float  # factor on the two analytic ceilings
    scenarios: int  # scenarios of the roots and minima
    fit_samples: tuple  # (engine, samples) of the dense fits, in order
    fit_subset: int     # the device Grams' shared subset
    tt_fit_samples: int
    tt_fit_sweeps: int
    search_nodes: int   # nodes a dim of the 2-D waves and the 5-D osc5
    osc_boxes: int      # max_boxes of the osc5 search
    tt_search: tuple    # (nodes, max_rank, max_boxes) of the 10-D TT search
    zeros: tuple        # (nodes, d, freq, delta, max_boxes) per isolation
    sup_target: float   # to_tt's trimming target (bench_tt_grouped.py:64)


FULL = Widths(
    11, 1 << 20, 1 << 17, 15, 4096, 1.0, 4096,
    fit_samples=(("host", 1 << 15), ("device", 1 << 20),
                 ("device-dd", 1 << 19)),
    fit_subset=1 << 15, tt_fit_samples=1_000_000, tt_fit_sweeps=3,
    search_nodes=21, osc_boxes=5000, tt_search=(7, 8, 400_000),
    zeros=((31, 3, 6.0, 1e-3, 200_000), (25, 4, 3.0, 1e-2, 400_000)),
    sup_target=3e-12)
# The rehearsal's 9^5 grid trimmed to 3e-12 on the grid reads 1.05e-12
# off it, past the 1e-12 ceiling (11^5: 7.5e-13), so it trims to 1e-12.
SMALL = Widths(
    9, 4096, 512, 8, 512, SMALL_ANALYTIC_FACTOR, 256,
    fit_samples=(("host", 1 << 12), ("device", 1 << 12),
                 ("device-dd", 1 << 12)),
    fit_subset=1 << 11, tt_fit_samples=1 << 13, tt_fit_sweeps=1,
    search_nodes=7, osc_boxes=200, tt_search=(5, 3, 2000),
    zeros=((11, 2, 6.0, 1e-3, 200_000), (9, 3, 3.0, 1e-2, 400_000)),
    sup_target=1e-12)
#: Scenarios the batched roots and minima are checked on, one call each.
SINGLE_CHECKS = 64


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
        self.cpu = host_cpu()
        self.rows = []

    def name(self, base: str) -> str:
        """Full-width card numbers keep the metric's name; any other
        run's are rehearsal numbers and say so."""
        return base if self.cuda and not self.small else f"rehearsal.{base}"

    def emit(self, line: dict) -> None:
        print(json.dumps(line), flush=True)

    def batches(self, seed, draw, nbytes, rng=None):
        """Batches drawn one after another from ``seed``'s stream (the
        first is bench.py's input), or from ``rng`` where a script draws
        them after other inputs, enough that together they exceed the
        L2 cache: at least three."""
        count = 3 if self.small else max(3, L2_BYTES // nbytes + 1)
        if rng is None:
            rng = np.random.default_rng(seed + self.seed)
        return [draw(rng) for _ in range(count)]

    def on(self, array):
        return torch.tensor(array, dtype=torch.float64, device=self.device)

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def samples(self, fn, batches, host=False) -> list:
        """Milliseconds of ``reps`` calls after ``WARMUP``, rotating over
        ``batches``: CUDA events on a card, the host clock on the CPU or
        with ``host`` (a row that runs host NumPy only).  A warm call
        longer than ``LONG_CALL_S`` ends the warm-up and the call takes
        at most ``LONG_REPS``; one longer than ``ONE_CALL_S`` is itself
        the one sample."""
        for i in range(WARMUP):
            t0 = time.perf_counter()
            fn(batches[i % len(batches)])
            self.sync()
            warm_s = time.perf_counter() - t0
            if warm_s > ONE_CALL_S:
                return [warm_s * 1e3]
            if warm_s > LONG_CALL_S:
                break
        reps = (min(self.reps, LONG_REPS) if warm_s > LONG_CALL_S
                else self.reps)
        times = []
        for i in range(reps):
            b = batches[i % len(batches)]
            if self.cuda and not host:
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
                self.sync()
                times.append((time.perf_counter() - t0) * 1e3)
        return times

    def build_s(self, build) -> float:
        t0 = time.perf_counter()
        build()
        self.sync()
        return time.perf_counter() - t0

    def rate(self, fn, batches, n, unit, per_call=1, host=False,
             **check):
        """A throughput row: ``per_call * n`` results a call; a ``host``
        row names the host's CPU."""
        ms = self.samples(fn, batches, host)
        row = timing(ms, value=per_call * n / (np.median(ms) / 1e3),
                     unit=unit, n=n, **check)
        return dict(row, host_cpu=self.cpu) if host else row

    def seconds(self, fn, n, host=False, **check):
        """A row of seconds a call of ``fn()``: the median."""
        ms = self.samples(lambda _: fn(), [None], host)
        row = timing(ms, value=float(np.median(ms)) / 1e3, unit="s", n=n,
                     **check)
        return dict(row, host_cpu=self.cpu) if host else row

    def host_row(self, fn) -> dict:
        """A host row, microseconds a call: ``HOST_WARM`` warm calls,
        then at least ``HOST_CALLS`` in ``reps`` blocks on the host
        clock; the median and p75 over the blocks."""
        for _ in range(HOST_WARM):
            fn()
        per_block = -(-HOST_CALLS // self.reps)
        ms = []
        for _ in range(self.reps):
            t0 = time.perf_counter()
            for _ in range(per_block):
                fn()
            ms.append((time.perf_counter() - t0) * 1e3 / per_block)
        return timing(ms, value=float(np.median(ms)) * 1e3, unit="us", n=1,
                      calls=per_block * self.reps, host_cpu=self.cpu)


def timing(ms, **fields) -> dict:
    return dict(fields, median_ms=float(np.median(ms)),
                p75_ms=float(np.percentile(ms, 75)), samples=len(ms))


def one_sample(seconds, **fields) -> dict:
    return timing([seconds * 1e3], value=seconds, unit="s", **fields)


# --- the rows, in bench.py's order -------------------------------------------
#
# Each takes the run (``b``) and the state the rows share (``s``), and
# returns its line's fields.  A model the rows share is built by the
# row that times its build; a row that needs it and runs without that
# row (``--rows``) builds it untimed.  A row that needs what an earlier
# row failed to make raises, and only that row fails.  A row's
# ``checks`` ({name: [value, limit]}) must hold as its deviation must.


def dense_points(b, s):
    """The dense rows' inputs: bench.py's seed-1 points, f64 and f32."""
    dense(b, s)
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


def keep_dense(s, cheb):
    s["cheb"] = cheb
    s["grid"] = cheb._grid_tuples()
    s["grid32"] = tuple(tuple(a.float() for a in g) for g in s["grid"])
    s["tensor32"] = cheb.tensor_values.float()


def dense(b, s):
    """bench.py's 11^5 interpolant, the dense and calculus rows' model."""
    if "cheb" not in s:
        cheb = new_dense(b)
        cheb.build(verbose=False)
        keep_dense(s, cheb)
    return s["cheb"]


def build_cold(b, s):
    cheb = new_dense(b)
    seconds = b.build_s(lambda: cheb.build(verbose=False))
    keep_dense(s, cheb)
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

    return b.rate(run, pts32, b.w.n,
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
    row = b.rate(run, pts32,
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

    return b.rate(run, pts32, b.w.n,
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
    return b.rate(run, pts32,
                  b.w.n, "Greek-sets/s", deviation=d, ceiling=F32,
                  against="f64 ops.eval.eval_batch_multi, each of the 6 "
                          "specs on its own scale, first batch")


def tt_points(b, s):
    """The TT chains' inputs: seed 1 on the TT's own domain (bench.py
    timed them on the dense domain, part of which lies outside the
    TT's, where no ceiling holds)."""
    tt_cross(b, s)
    if "tt64" not in s:
        w = b.w
        host = b.batches(1, lambda rng: sample_points(w.n, domain=TT_DOMAIN,
                                                      rng=rng),
                         w.n * 5 * 4)
        s["tt64"] = [b.on(h) for h in host]
        s["tt32"] = [p.float() for p in s["tt64"]]
    return s["tt64"], s["tt32"]


def make_tt_cross(b, s):
    w = b.w
    s["tt"] = ChebyshevTT(bs_div_np, 5, TT_DOMAIN, [w.nodes] * 5,
                          max_rank=w.tt_rank, max_sweeps=10,
                          tolerance=1e-6, vectorized=True, device=b.device)
    s["tt"].build(verbose=False, seed=42 + b.seed)


def tt_cross(b, s):
    """The reference's rank-15 TT-Cross (q = 2 %), the TT rows' model."""
    if "tt" not in s:
        make_tt_cross(b, s)
    return s["tt"]


def tt_build(b, s):
    w = b.w
    seconds = b.build_s(lambda: make_tt_cross(b, s))
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

    return b.rate(run, tt32, b.w.n,
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

    return b.rate(run, tt32,
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
    return b.rate(run, pts32,
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
    row = b.rate(run, pts64, b.w.n,
                 "queries/s", deviation=d, ceiling=DD,
                 against="f64 ops.eval.eval_batch on the first batch")
    row["launches"] = fused_dd.launches - before
    row["kernel_ms"] = kernel_ms(
        b, fused_dd._pack(cheb.tensor_values, *grid, (0,) * 5, shape),
        shape, pts64)
    return row


def compressed(b, s):
    """``to_tt(1e-13)`` of the 11^5 interpolant."""
    if "comp" not in s:
        s["comp"] = dense(b, s).to_tt(tolerance=1e-13)
    return s["comp"]


def to_tt_dd(b, s):
    pts64, _ = dense_points(b, s)
    comp = compressed(b, s)
    cores = comp._cores_on_device(torch.float64)
    dom = np.asarray(comp.domain, dtype=np.float64)

    def run(p):
        return tt_eval_dd.tt_eval_batch_dd(cores, dom, p, groups="auto")

    return b.rate(run, pts64, b.w.n,
                  "queries/s", deviation=dev(run(pts64[0]), dense_f64(s)),
                  ceiling=TO_TT,
                  against="the dense f64 path on the first batch",
                  ranks=comp.tt_ranks,
                  groups=list(tt_eval_dd.tt_dd_auto_groups(
                      tt_eval.core_shapes(cores))))


def box_batches(b, s):
    """bench.py's seed-21 stream: 5-D boxes, then the conditional
    points of (K, sigma, r), batch after batch; the boxes also on the
    host (``s["boxes_np"]``) for the calls that take host bounds."""
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
        s["boxes_np"] = [bx for bx, _ in host]
        s["boxes"] = [b.on(bx) for bx, _ in host]
        s["cond"] = [(b.on(bx[:, [0, 2], :]), b.on(c)) for bx, c in host]
    return s["boxes"], s["cond"]


def tt_dd_masses(b, s):
    boxes, _ = box_batches(b, s)
    comp = compressed(b, s)
    cores = comp._cores_on_device(torch.float64)
    dom = np.asarray(comp.domain, dtype=np.float64)

    def run(bx):
        return integrate.tt_integrate_box_batch_dd(cores, dom, bx,
                                                   groups="auto")

    ref = integrate.tt_integrate_box_batch(cores, dom, boxes[0])
    return b.rate(run, boxes,
                  b.w.boxes, "boxes/s",
                  deviation=dev(run(boxes[0]), ref, 1e-300), ceiling=DD,
                  against="the f64 TT box integrals "
                          "(ops.integrate.tt_integrate_box_batch) of the "
                          "to_tt(1e-13) cores, first batch")


def dd_cond(b, s):
    _, cond = box_batches(b, s)
    cheb, grid = dense(b, s), s["grid"]
    dom = np.asarray(DOMAIN, dtype=np.float64)

    def run(c):
        return integrate.partial_integrate_eval_batch_dd(
            cheb.tensor_values, dom, *grid, (0, 2), c[0], c[1])

    ref = integrate.partial_integrate_eval_batch(
        cheb.tensor_values, dom, *grid, (0, 2), cond[0][0], cond[0][1])
    return b.rate(run, cond,
                  b.w.boxes, "scenarios/s",
                  deviation=dev(run(cond[0]), ref, 1e-300), ceiling=DD,
                  against="f64 ops.integrate.partial_integrate_eval_batch "
                          "over (S, T) on the first batch")


def tt_dd(b, s):
    w = b.w
    tt = tt_cross(b, s)
    host = b.batches(9, lambda rng: np.stack(
        [rng.uniform(lo, hi, w.n) for lo, hi in TT_DOMAIN], axis=1),
        w.n * 5 * 8)
    pts = [b.on(h) for h in host]
    cores = tt._cores_on_device(torch.float64)
    dom = np.asarray(tt.domain)

    def run(p):
        return tt_eval_dd.tt_eval_batch_dd(cores, dom, p)

    ref = tt_eval.tt_eval_batch(cores, dom, pts[0])
    return b.rate(run, pts, w.n,
                  "queries/s", deviation=dev(run(pts[0]), ref), ceiling=DD,
                  against="the TT f64 chain on the first batch (seed 9)")


def new_slider(b):
    """Config 4: ten singleton slides of 9 nodes, pivot 0."""
    return ChebyshevSlider(basket_np, SLIDER_D, SLIDER_DOMAIN,
                           [9] * SLIDER_D, [[i] for i in range(SLIDER_D)],
                           [0.0] * SLIDER_D, vectorized=True,
                           device=b.device)


def slider_dd_report(b, s):
    w = b.w
    ns = w.n // 4
    slider = new_slider(b)
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
    return b.rate(run, pts, ns,
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
    return b.rate(run, pts64, b.w.n,
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
    return b.rate(run, tt64, b.w.n,
                  "queries/s", deviation=dev(run(sub), host), ceiling=F64,
                  against=f"the host chain (ChebyshevTT.eval) on "
                          f"{b.w.check:,} points")


# --- BASELINE.json configs 1-5 (scripts/run_baseline_table.py) --------------


def div_dense(b, s):
    """Config 1 as the baseline table builds it (:60-73, 148-152): the
    11^5 call with a 2 % dividend on the reference's narrow domain.
    Its single points go through the C kernels (``utils.ceval``)."""
    if "div" not in s:
        cheb = ChebyshevApproximation(bs_div_np, 5, TT_DOMAIN,
                                      [b.w.nodes] * 5, vectorized=True,
                                      device=b.device)
        cheb.build(verbose=False)
        if cheb._host_cpack(cheb._host_arrays()) is None:
            raise RuntimeError("the C host library (cpp/hosteval.c) did "
                               "not build or load")
        s["div"] = cheb
    return s["div"]


@contextlib.contextmanager
def numpy_host_path(cheb):
    """The dense model's NumPy single-point path: its C pack set aside
    for the block."""
    h = cheb._host_arrays()
    pack = cheb._host_cpack(h)
    h["cpack"] = None
    try:
        yield
    finally:
        h["cpack"] = pack


def reference_protocol(cheb, pts) -> dict:
    """The reference's published protocol (run_baseline_table.py:
    165-193): the price and each Greek against the analytic ones,
    relative, in percent; theta is -dV/dT."""
    exact = bs_div_np(pts)
    greeks = bs_div_greeks_np(pts)
    rel = np.abs(cheb.vectorized_eval_batch(pts, [0] * 5) - exact) \
        / np.abs(exact)
    out = {"price_err_mean_pct": float(rel.mean() * 100),
           "price_err_max_pct": float(rel.max() * 100)}
    for name, orders in PROTOCOL_SPECS.items():
        got = cheb.vectorized_eval_batch(pts, orders)
        if name == "theta":
            got = -got
        out[f"{name}_err_max_pct"] = float(
            (np.abs(got - greeks[name]) / np.abs(greeks[name])).max() * 100)
    return out


def query_points(b):
    """The query point, then the protocol's 200 points (seed 42)."""
    return np.vstack([QUERY_POINT, protocol_points(42 + b.seed)])


def host_query(b, s):
    """Config 1's single query through the C kernel."""
    cheb = div_dense(b, s)
    pts = query_points(b)
    got = np.array([cheb.vectorized_eval(p, [0] * 5) for p in pts])
    with numpy_host_path(cheb):
        ref = np.array([cheb.vectorized_eval(p, [0] * 5) for p in pts])
    row = b.host_row(lambda: cheb.vectorized_eval(QUERY_POINT, [0] * 5))
    return dict(row, deviation=dev(got, ref), ceiling=HOST_C_VS_NUMPY,
                against=f"the NumPy host path at the point and the "
                        f"{PROTOCOL_POINTS} protocol points (seed 42)",
                point=QUERY_POINT, value_at_point=float(got[0]),
                **reference_protocol(cheb, pts[1:]))


def host_price_greeks(b, s):
    """Config 1's price and five Greeks at one point, one C call."""
    cheb = div_dense(b, s)
    pts = query_points(b)
    got = np.array([cheb.vectorized_eval_multi(p, GREEKS) for p in pts])
    with numpy_host_path(cheb):
        ref = np.array([cheb.vectorized_eval_multi(p, GREEKS)
                        for p in pts])
    check = b.on(sample_points(b.w.check, 7 + b.seed, TT_DOMAIN))
    scale = np.abs(_host(eval_ops.eval_batch_multi(
        cheb.tensor_values, *cheb._grid_tuples(), check, GREEKS))).max(
            axis=1)
    row = b.host_row(lambda: cheb.vectorized_eval_multi(QUERY_POINT,
                                                        GREEKS))
    return dict(row, deviation=float((np.abs(got - ref) / scale).max()),
                ceiling=HOST_C_VS_NUMPY_SPECS,
                against=f"the NumPy host path at the point and the "
                        f"{PROTOCOL_POINTS} protocol points, each of the 6 "
                        f"specs over its max |value| at {b.w.check:,} "
                        f"points (seed 7)", specs=len(GREEKS))


def to_tt_host_query(b, s):
    """Config 1's single query on ``to_tt(1e-13)``, the C TT kernel."""
    cheb = div_dense(b, s)
    comp = cheb.to_tt(tolerance=1e-13)
    if comp._host_cpack() is None:
        raise RuntimeError("the C TT kernel declined the cores")
    pts = query_points(b)
    got = np.array([comp.eval(p) for p in pts])
    ref = np.array([cheb.vectorized_eval(p, [0] * 5) for p in pts])
    row = b.host_row(lambda: comp.eval(QUERY_POINT))
    return dict(row, deviation=dev(got, ref), ceiling=TO_TT,
                against="the dense C path (bs5d_11n_host_query_us) at the "
                        "point and the protocol points",
                ranks=comp.tt_ranks,
                core_bytes=int(sum(c.nbytes for c in comp._coeff_cores)))


def tt_host_query(b, s):
    """Config 2's single query on the rank-15 cross, the C TT kernel,
    and its finite-difference Greeks (run_baseline_table.py:375-388)."""
    tt = tt_cross(b, s)
    if tt._host_cpack() is None:
        raise RuntimeError("the C TT kernel declined the cores")
    pts = query_points(b)
    got = np.array([tt.eval(p) for p in pts])
    chain = tt_eval.tt_eval_batch(tt._cores_on_device(torch.float64),
                                  np.asarray(tt.domain), b.on(pts))
    row = b.host_row(lambda: tt.eval(QUERY_POINT))
    rng = np.random.default_rng(42 + b.seed)
    pts50 = np.stack([rng.uniform(lo, hi, 50) for lo, hi in TT_DOMAIN],
                     axis=1)
    sub = pts50[np.abs(bs_div_np(pts50)) >= 0.50][:25]
    greeks = bs_div_greeks_np(sub)
    fd = {}
    for name, spec in (("delta", [1, 0, 0, 0, 0]),
                       ("gamma", [2, 0, 0, 0, 0])):
        got_fd = np.array([tt.eval_multi(list(p), [spec])[0] for p in sub])
        fd[f"fd_{name}_err_avg_pct"] = float(
            (np.abs(got_fd - greeks[name]) / np.abs(greeks[name])).mean()
            * 100)
    return dict(row, deviation=dev(got, chain), ceiling=F64,
                against="the f64 chain on the device at the point and the "
                        "protocol points", fd_points=len(sub), **fd)


def spline_model(b, s):
    """Config 3: two pieces of 17^2 split at the kink x0 = 1."""
    if "spline" not in s:
        spline = ChebyshevSpline(payoff_np, 2, SPLINE_DOMAIN, SPLINE_NODES,
                                 SPLINE_KNOTS, vectorized=True,
                                 device=b.device)
        spline.build(verbose=False)
        s["spline"] = spline
    return s["spline"]


def spline_build(b, s):
    seconds = b.build_s(lambda: spline_model(b, s))
    spline = s["spline"]
    pts = sample_points(4000, 0 + b.seed, SPLINE_DOMAIN,
                        margin=SPLINE_MARGIN)
    exact = payoff_np(pts)
    plain = ChebyshevApproximation(payoff_np, 2, SPLINE_DOMAIN, SPLINE_NODES,
                                   vectorized=True, device=b.device)
    plain.build(verbose=False)
    err_plain = float(np.abs(plain.vectorized_eval_batch(pts, [0, 0])
                             - exact).max())
    err_spline = float(np.abs(spline.eval_batch(pts, [0, 0]) - exact).max())
    via = ChebyshevApproximation(payoff_np, 2, SPLINE_DOMAIN,
                                 [SPLINE_NODES, SPLINE_NODES[:1]],
                                 special_points=SPLINE_KNOTS,
                                 vectorized=True, device=b.device)
    if type(via) is not ChebyshevSpline:
        raise TypeError(f"special_points dispatch gave {type(via).__name__}")
    return one_sample(
        seconds, n=spline.total_build_evals, deviation=err_spline,
        ceiling=err_plain,
        against="the exact payoff at 4,000 points (seed 0, margin 0.001), "
                "max abs; held to the global 17^2 tensor's",
        spline_max_abs=err_spline, global_max_abs=err_plain,
        pieces=spline.num_pieces, dispatch=type(via).__name__)


def spline_points(b, s):
    """Config 3's queries: seed 5, margin 0.001 (:440)."""
    if "sp64" not in s:
        w = b.w
        host = b.batches(5, lambda rng: sample_points(
            w.n, domain=SPLINE_DOMAIN, rng=rng, margin=SPLINE_MARGIN),
            w.n * 2 * 8)
        s["sp64"] = [b.on(h) for h in host]
    return s["sp64"]


def spline_f64(b, s):
    spline = spline_model(b, s)
    pts = spline_points(b, s)

    def run(p):
        return spline.eval_batch(p, [0, 0])

    sub = pts[0][:b.w.check]
    host = [spline.eval(p, [0, 0]) for p in _host(sub)]
    return b.rate(run, pts, b.w.n,
                  "queries/s", deviation=dev(run(sub), host), ceiling=F64,
                  against=f"the class host path (ChebyshevSpline.eval) at "
                          f"{b.w.check:,} points")


def spline_f32(b, s):
    spline = spline_model(b, s)
    pts = spline_points(b, s)
    engine = BatchedEvaluator(spline, dtype=torch.float32, device=b.device)
    ref = spline.eval_batch_device(pts[0], [0, 0])
    return b.rate(engine, pts, b.w.n,
                  "queries/s", deviation=dev(engine(pts[0]), ref),
                  ceiling=F32, against="the f64 class path "
                                       "(eval_batch_device), first batch",
                  route="masked" if engine._specs_run.masked else "routed",
                  pieces=spline.num_pieces)


def slider_model(b, s):
    if "slider" not in s:
        slider = new_slider(b)
        slider.build(verbose=False)
        s["slider"] = slider
    return s["slider"]


def slider_build(b, s):
    seconds = b.build_s(lambda: slider_model(b, s))
    slider = s["slider"]
    pts = np.random.default_rng(0 + b.seed).uniform(-1, 1, (5000, SLIDER_D))
    got = slider.eval_batch(pts)
    exact_integral = 0.25 * SLIDER_D * (2.0 / 3.0) * 2.0 ** (SLIDER_D - 1)
    n1 = ChebyshevApproximation.get_optimal_n1(auto_n_np, (-1.0, 1.0),
                                               1e-10, device=b.device)
    return one_sample(
        seconds, n=slider.total_build_evals,
        deviation=dev(got, additive_interpolant_np(pts, 9)), ceiling=F64,
        against="the slides' additive interpolant computed on the host at "
                "5,000 points (seed 0)",
        max_abs_vs_basket=float(np.abs(got - basket_np(pts)).max()),
        integral_rel_err=abs(slider.integrate() - exact_integral)
        / exact_integral, optimal_n1=n1)


def slider_points(b, s):
    """Config 4's queries: seed 5, 2 % margin (:507)."""
    if "sl64" not in s:
        w = b.w
        host = b.batches(5, lambda rng: sample_points(
            w.n, domain=SLIDER_DOMAIN, rng=rng), w.n * SLIDER_D * 8)
        s["sl64"] = [b.on(h) for h in host]
    return s["sl64"]


def slider_f32(b, s):
    slider = slider_model(b, s)
    pts64 = slider_points(b, s)
    pts32 = [p.float() for p in pts64]
    engine = BatchedEvaluator(slider, dtype=torch.float32, device=b.device)
    return b.rate(engine, pts32, b.w.n,
                  "queries/s", deviation=dev(engine(pts32[0]),
                                             slider.eval_batch_device(
                                                 pts64[0])),
                  ceiling=F32, against="the f64 class path "
                                       "(eval_batch_device), first batch")


def slider_dd(b, s):
    slider = slider_model(b, s)
    pts = slider_points(b, s)
    data, groups = slider._slide_data(), slider._groups()

    def run(p):
        return slider_eval.slider_batch_dd(data, slider.pivot_value, groups,
                                           p)

    sub = pts[0][:b.w.check]
    return b.rate(run, pts, b.w.n,
                  "queries/s",
                  deviation=dev(run(sub), slider.eval_batch(sub)),
                  ceiling=DD, against=f"the f64 class path "
                                      f"(ChebyshevSlider.eval_batch) at "
                                      f"{b.w.check:,} points")


def slider_f64(b, s):
    slider = slider_model(b, s)
    pts = slider_points(b, s)
    engine = BatchedEvaluator(slider, dtype=torch.float64, device=b.device)
    sub = pts[0][:b.w.check]
    return b.rate(engine, pts, b.w.n,
                  "queries/s",
                  deviation=dev(engine(sub), slider.eval_batch(sub)),
                  ceiling=F64, against=f"the class path "
                                       f"(ChebyshevSlider.eval_batch) at "
                                       f"{b.w.check:,} points")


def new_instrument(b, fn, seed):
    """One of config 5's instruments by rank-adaptive TT-ALS."""
    tt = ChebyshevTT(fn, 4, PORTFOLIO_DOMAIN, [9] * 4, max_rank=8,
                     tolerance=1e-8, vectorized=True, device=b.device)
    tt.build(verbose=False, method="als", seed=seed + b.seed)
    return tt


def instruments(b, s):
    if "tta" not in s:
        s["tta"] = new_instrument(b, instrument_a_np, 0)
        s["ttb"] = new_instrument(b, instrument_b_np, 1)
    return s["tta"], s["ttb"]


def portfolio_check(b, tta, ttb):
    """2A + B as one TT, its points (seed 2, margin 0.05) and its
    deviation from the closed form there."""
    portfolio = tta * 2.0 + ttb
    pts = sample_points(500, 2 + b.seed, PORTFOLIO_DOMAIN, margin=0.05)
    exact = 2.0 * instrument_a_np(pts) + instrument_b_np(pts)
    return portfolio, pts, dev(portfolio.eval_batch(pts), exact)


def portfolio_build(b, s):
    seconds = b.build_s(lambda: instruments(b, s))
    tta, ttb = s["tta"], s["ttb"]
    portfolio, pts, err = portfolio_check(b, tta, ttb)
    before = portfolio.eval(PORTFOLIO_AT)
    portfolio.orth_left(3)
    portfolio.orth_right(0)
    drift = abs(portfolio.eval(PORTFOLIO_AT) - before) / abs(before)
    sliced = portfolio.slice((3, 0.03))
    full3 = np.column_stack([pts[:100, :3], np.full(100, 0.03)])
    err3 = dev(sliced.eval_batch(full3[:, :3]),
               2.0 * instrument_a_np(full3) + instrument_b_np(full3))
    return one_sample(
        seconds, n=tta.total_build_evals + ttb.total_build_evals,
        deviation=err, ceiling=PORTFOLIO_ERR,
        against="2A + B against its closed form at 500 points (seed 2, "
                "margin 0.05)",
        ranks=[tta.tt_ranks, ttb.tt_ranks],
        inner_product=tta.inner_product(ttb),
        checks={"orth_sweep_drift_rel": [drift, F64],
                "slice_r3pct_err": [err3, PORTFOLIO_ERR]})


def portfolio_completion(b, s):
    _, ttb = instruments(b, s)
    tta = new_instrument(b, instrument_a_np, 0)
    before = tta._coeff_cores[0].copy()
    seconds = b.build_s(lambda: tta.run_completion(tolerance=1e-10,
                                                   max_iter=5))
    _, _, err = portfolio_check(b, tta, ttb)
    return one_sample(
        seconds, n=5, deviation=err, ceiling=PORTFOLIO_ERR,
        against="2A + B against its closed form at 500 points after "
                "run_completion(1e-10, 5 iterations) of a fresh A",
        core0_moved=float(np.abs(tta._coeff_cores[0] - before).max()))


# --- calculus (scripts/bench_integrate_batch.py, chip_smoke.py 25-31) -------


def script_tt(b, s):
    """bench_integrate_batch.py's TT (:117-128): the call without
    dividend on the dense domain, a rank-capped cross, seed 42."""
    if "tt_int" not in s:
        tt = ChebyshevTT(bs_price_np, 5, DOMAIN, [b.w.nodes] * 5,
                         max_rank=b.w.tt_rank, vectorized=True,
                         device=b.device)
        tt.build(verbose=False, seed=42 + b.seed)
        s["tt_int"] = tt
    return s["tt_int"]


def per_call_integrals(model, boxes) -> np.ndarray:
    """``integrate(bounds=...)`` one box at a time."""
    return np.array([model.integrate(bounds=[tuple(k) for k in box])
                     for box in _host(boxes)])


def box_f64(b, s):
    cheb = dense(b, s)
    boxes, _ = box_batches(b, s)
    dom = np.asarray(DOMAIN)

    def run(bx):
        return integrate.integrate_box_batch(cheb.tensor_values, dom, bx)

    d = dev(run(boxes[0][:8]), per_call_integrals(cheb, boxes[0][:8]))
    row = b.rate(run, boxes,
                 b.w.boxes, "boxes/s", deviation=d, ceiling=F64,
                 against="cheb.integrate(bounds=...) one call a box, 8 "
                         "boxes of the first batch")
    # The per-call loop a user would otherwise write (:110-116): 50
    # calls on the host clock.
    one = [tuple(k) for k in _host(boxes[0][0])]
    for _ in range(WARMUP):
        cheb.integrate(bounds=one)
    t0 = time.perf_counter()
    for _ in range(50):
        cheb.integrate(bounds=one)
    row["per_call_boxes_per_sec"] = 50 / (time.perf_counter() - t0)
    return row


def box_f32(b, s):
    cheb = dense(b, s)
    boxes, _ = box_batches(b, s)
    boxes32 = [bx.float() for bx in boxes]
    dom = np.asarray(DOMAIN)

    def run(bx):
        return integrate.integrate_box_batch(cheb.tensor_values, dom, bx,
                                             dtype=torch.float32)

    ref = integrate.integrate_box_batch(cheb.tensor_values, dom, boxes[0])
    return b.rate(run, boxes32,
                  b.w.boxes, "boxes/s", deviation=dev(run(boxes32[0]), ref),
                  ceiling=F32, against="the f64 box integrals, first batch")


def box_dd(b, s):
    cheb = dense(b, s)
    boxes, _ = box_batches(b, s)
    dom = np.asarray(DOMAIN)

    def run(bx):
        return integrate.integrate_box_batch_dd(cheb.tensor_values, dom, bx)

    ref = integrate.integrate_box_batch(cheb.tensor_values, dom, boxes[0])
    return b.rate(run, boxes,
                  b.w.boxes, "boxes/s", deviation=dev(run(boxes[0]), ref),
                  ceiling=DD, against="the f64 box integrals, first batch")


def tt_box_f64(b, s):
    tt = script_tt(b, s)
    boxes, _ = box_batches(b, s)
    cores = tt._cores_on_device(torch.float64)
    dom = np.asarray(tt.domain)

    def run(bx):
        return integrate.tt_integrate_box_batch(cores, dom, bx)

    got = _host(run(boxes[0][:8]))
    dense_per_call = per_call_integrals(dense(b, s), boxes[0][:8])
    return b.rate(run, boxes,
                  b.w.boxes, "boxes/s",
                  deviation=dev(got, per_call_integrals(tt, boxes[0][:8])),
                  ceiling=F64, against="the same TT's integrate(bounds=...) "
                                       "one call a box, 8 boxes",
                  ranks=tt.tt_ranks,
                  vs_dense_per_call=float(
                      np.abs(got - dense_per_call).max()
                      / max(1.0, np.abs(dense_per_call).max())))


def cond_f64(b, s):
    _, cond = box_batches(b, s)
    cheb, grid = dense(b, s), s["grid"]
    dom = np.asarray(DOMAIN, dtype=np.float64)

    def run(c):
        return integrate.partial_integrate_eval_batch(
            cheb.tensor_values, dom, *grid, (0, 2), c[0], c[1])

    host_t = _host(cheb.tensor_values)
    nodes = [_host(x) for x in cheb.nodes]
    sub, pts = (c[:SINGLE_CHECKS] for c in cond[0])
    bx, px = _host(sub), _host(pts)
    n = b.w.nodes
    ref = [contract_np(host_t, [quad_row_np(n, *DOMAIN[0], *bx[i, 0]),
                                bary_row_np(px[i, 0], nodes[1]),
                                quad_row_np(n, *DOMAIN[2], *bx[i, 1]),
                                bary_row_np(px[i, 1], nodes[3]),
                                bary_row_np(px[i, 2], nodes[4])])
           for i in range(len(bx))]
    return b.rate(run, cond,
                  b.w.boxes, "scenarios/s",
                  deviation=dev(run((sub, pts)), ref), ceiling=F64,
                  against=f"NumPy quadrature and barycentric rows "
                          f"contracted on the host, {SINGLE_CHECKS} "
                          f"scenarios of the first batch")


def tt_cond_dd(b, s):
    tt = script_tt(b, s)
    _, cond = box_batches(b, s)
    cores = tt._cores_on_device(torch.float64)
    dom = np.asarray(tt.domain)

    def run(c):
        return integrate.tt_partial_integrate_eval_batch_dd(
            cores, dom, (0, 2), c[0], c[1], groups="auto")

    ref = integrate.tt_partial_integrate_eval_batch(cores, dom, (0, 2),
                                                    *cond[0])
    return b.rate(run, cond,
                  b.w.boxes, "scenarios/s", deviation=dev(run(cond[0]), ref),
                  ceiling=DD, against="the TT f64 conditional expectations "
                                      "(tt_partial_integrate_eval_batch), "
                                      "first batch", ranks=tt.tt_ranks)


def book_integrals(b, s):
    cheb = dense(b, s)
    box_batches(b, s)
    boxes = s["boxes_np"]
    book = [cheb] + [cheb.differentiate(list(g)) for g in GREEKS[1:]]

    def run(bx):
        return integrate_book(book, bx)

    got = run(boxes[0])
    d = max(dev(got[k], m.integrate_batch(boxes[0]))
            for k, m in enumerate(book))
    return b.rate(run, boxes,
                  b.w.boxes, "boxes/s", deviation=d, ceiling=F64,
                  against="each model's integrate_batch on the first batch, "
                          "on its own scale", models=len(book))


def scenario_batches(b, s):
    """(K, T, sigma, r) scenarios along S (chip_smoke.py phase 31,
    seed 72), as the host columns ``fixed`` takes."""
    if "scen" not in s:
        ns = b.w.scenarios
        host = b.batches(72, lambda rng: sample_points(ns, rng=rng),
                         ns * 4 * 8)
        s["scen"] = [{d: np.ascontiguousarray(h[:, d]) for d in range(1, 5)}
                     for h in host]
    return s["scen"]


def pinned(fixed, i) -> dict:
    return {d: float(col[i]) for d, col in fixed.items()}


def scenario_roots(b, s):
    """Breakevens of Delta = 0.5 along S."""
    cheb = dense(b, s)
    scen = scenario_batches(b, s)
    delta = cheb.differentiate([1, 0, 0, 0, 0])
    half = ChebyshevApproximation.from_values(
        _host(delta.tensor_values) - 0.5, 5, DOMAIN, [b.w.nodes] * 5,
        device=b.device)

    def run(fixed):
        return half.roots_batch(dim=0, fixed=fixed)

    roots = run(scen[0])
    worst = 0.0
    for i in range(SINGLE_CHECKS):
        single = half.roots(dim=0, fixed=pinned(scen[0], i))
        if single.shape != roots[i].shape:
            raise ValueError(f"scenario {i}: {roots[i].size} batched roots "
                             f"against {single.size} single ones")
        if single.size:
            worst = max(worst, float(np.abs(single - roots[i]).max()))
    return b.rate(run, scen,
                  b.w.scenarios, "scenarios/s", deviation=worst,
                  ceiling=ROOTS_VS_SINGLE,
                  against=f"single roots(dim=0) on {SINGLE_CHECKS} "
                          f"scenarios, absolute in S, equal counts",
                  roots_found=int(sum(r.size for r in roots)))


def scenario_minima(b, s):
    """Gamma's minimum along S."""
    gamma = dense(b, s).differentiate([2, 0, 0, 0, 0])
    scen = scenario_batches(b, s)

    def run(fixed):
        return gamma.minimize_batch(dim=0, fixed=fixed)

    values, locations = run(scen[0])
    scale = float(gamma.tensor_values.abs().max())
    loc_err = val_err = 0.0
    for i in range(SINGLE_CHECKS):
        val, loc = gamma.minimize(dim=0, fixed=pinned(scen[0], i))
        loc_err = max(loc_err, abs(loc - locations[i]))
        val_err = max(val_err, abs(val - values[i]) / scale)
    return b.rate(run, scen,
                  b.w.scenarios, "scenarios/s", deviation=float(loc_err),
                  ceiling=LOCATION_VS_SINGLE,
                  against=f"single minimize(dim=0) on {SINGLE_CHECKS} "
                          f"scenarios: locations absolute in S; values "
                          f"over Gamma's max |value| on the grid (checks)",
                  checks={"value_vs_single": [float(val_err), F64]})


# --- fits (scripts/bench_fit.py, bench_tt_fit.py; chip_smoke.py 32, 36) ----


def fit_target_np(p):
    """bench_fit.py's target (:41-43), sin(2 x0) cos(x1) + x2^3."""
    return np.sin(2 * p[:, 0]) * np.cos(p[:, 1]) + p[:, 2] ** 3


def fit_samples(b, s):
    """bench_fit.py's samples (:45-48): one seed-0 stream drawn engine
    after engine, noise N(0, 1e-3)."""
    if "fit" not in s:
        rng = np.random.default_rng(0 + b.seed)
        s["fit"] = {}
        for engine, n in b.w.fit_samples:
            pts = np.stack([rng.uniform(lo, hi, n) for lo, hi in FIT_DOMAIN],
                           axis=1)
            s["fit"][engine] = pts, (fit_target_np(pts)
                                     + rng.normal(0, FIT_NOISE, n))
    return s["fit"]


def gram_vs_host(b, engine, pts, y) -> float:
    """The device engine's Gram of ``pts`` against the host's f64 one."""
    nodes = [nodes_for_dim_np(lo, hi, n)
             for (lo, hi), n in zip(FIT_DOMAIN, FIT_NODES)]
    weights = [barycentric_weights_np(x) for x in nodes]
    design = fitting._DimDesign(nodes, weights)
    rows = fitting._khatri_rao([design.rows(pts[:, k], k)
                                for k in range(len(nodes))])
    accumulate = (fitting._device_normal_accumulation if engine == "device"
                  else fitting._device_normal_accumulation_dd)
    gram, _ = accumulate([(pts, (0,) * len(nodes), y, np.ones(len(y)))],
                         nodes, weights, design, rows.shape[1],
                         device=b.device)
    return dev(gram, rows.T @ rows)


def dense_fit(b, s, engine):
    pts, y = fit_samples(b, s)[engine]
    fitted = {}

    def run(_):
        fitted["model"] = ChebyshevApproximation.fit(
            pts, y, len(FIT_NODES), FIT_DOMAIN, FIT_NODES, l2=FIT_L2,
            engine=engine, device=b.device)

    host = engine == "host"
    row = b.rate(run, [None], len(y), "samples/s", host=host)
    rms = fitted["model"].fit_diagnostics["rms"]
    row.update(deviation=rms, ceiling=2 * FIT_NOISE,
               against=f"the fit's rms residual over its samples, held to "
                       f"twice the noise's sigma ({FIT_NOISE:g})",
               engine=engine, grid_points=int(np.prod(FIT_NODES)))
    if not host:
        sub_pts, sub_y = (a[:b.w.fit_subset]
                          for a in fit_samples(b, s)["device"])
        row["checks"] = {"gram_vs_host_f64": [
            gram_vs_host(b, engine, sub_pts, sub_y),
            FIT_GRAM_F32 if engine == "device" else FIT_GRAM_DD]}
        row["gram_points"] = len(sub_y)
    return row


def fit_host(b, s):
    return dense_fit(b, s, "host")


def fit_f32(b, s):
    return dense_fit(b, s, "device")


def fit_dd(b, s):
    return dense_fit(b, s, "device-dd")


def tt_fit_samples(b, s):
    """bench_tt_fit.py's samples (:41-44): seed 0, prod(cos 2x) +
    0.1 sum x + N(0, 1e-4) on [0, 1]^5."""
    if "ttfit" not in s:
        n = b.w.tt_fit_samples
        rng = np.random.default_rng(0 + b.seed)
        pts = rng.uniform(0.0, 1.0, (n, TT_FIT_D))
        s["ttfit"] = pts, (np.prod(np.cos(2 * pts), axis=1)
                           + 0.1 * pts.sum(1)
                           + rng.normal(0.0, TT_FIT_NOISE, n))
    return s["ttfit"]


def tt_fit(b, s, engine):
    pts, y = tt_fit_samples(b, s)
    return ChebyshevTT.fit(pts, y, TT_FIT_D, [[0.0, 1.0]] * TT_FIT_D,
                           [7] * TT_FIT_D, max_rank=5,
                           sweeps=b.w.tt_fit_sweeps, l2=1e-8, engine=engine,
                           device=b.device)


def tt_fit_host_run(b, s):
    """The host TT fit, run once and timed on the host clock: the host
    row's one sample and the device row's yardstick."""
    if "ttfit_host" not in s:
        def run():
            s["ttfit_host"] = tt_fit(b, s, "host")
        s["ttfit_host_s"] = b.build_s(run)
    return s["ttfit_host"], s["ttfit_host_s"]


def sweeps_of(model) -> int:
    return len(model.fit_diagnostics["sweep_rms"])


def rms_apart(b, s) -> dict:
    """The two engines' rms on the same samples, the device's relative
    to the host's: both TT fit rows are held to it."""
    rms = {engine: s[f"ttfit_{engine}"].fit_diagnostics["rms"]
           for engine in ("device", "host")}
    return dict(deviation=abs(rms["device"] - rms["host"]) / rms["host"],
                ceiling=TT_FIT_RMS_REL,
                against="the device engine's rms against the host "
                        "engine's on the same samples, relative",
                rms=rms)


def tt_fit_device(b, s):
    tt_fit_host_run(b, s)
    fitted = {}

    def run(_):
        fitted["model"] = tt_fit(b, s, "device")

    ms = b.samples(run, [None])
    model, n = fitted["model"], b.w.tt_fit_samples
    s["ttfit_device"] = model
    return timing(ms, value=n * sweeps_of(model) / (np.median(ms) / 1e3),
                  unit="sample-sweeps/s", n=n, sweeps=sweeps_of(model),
                  **rms_apart(b, s))


def tt_fit_host(b, s):
    model, seconds = tt_fit_host_run(b, s)
    if "ttfit_device" not in s:
        s["ttfit_device"] = tt_fit(b, s, "device")
    n = b.w.tt_fit_samples
    return timing([seconds * 1e3], value=n * sweeps_of(model) / seconds,
                  unit="sample-sweeps/s", n=n, sweeps=sweeps_of(model),
                  timed="one call on the host clock, as the builds are",
                  host_cpu=b.cpu, **rms_apart(b, s))


# --- global calculus (scripts/bench_global_calculus.py, bench_tt_minimize.py,
# bench_zero_isolation.py; chip_smoke.py 41) -------------------------------


def waves_np(p, _data=None):
    """bench_global_calculus.py's 2-D "waves" (:50-53)."""
    p = np.atleast_2d(np.asarray(p, dtype=np.float64))
    return (np.sin(3 * p[:, 0]) + np.cos(4 * p[:, 1])
            + 0.5 * p[:, 0] * p[:, 1])


def bowl3_np(p, _data=None):
    """Its 3-D "bowl3" (:71-74): minima at x0 = +-1/sqrt(2)."""
    p = np.atleast_2d(np.asarray(p, dtype=np.float64))
    return ((p[:, 0] ** 2 - 0.5) ** 2 + (p[:, 1] - 0.2) ** 2
            + np.exp(0.5 * p[:, 2]) * 0.1)


def osc5_np(p, _data=None):
    """Its oscillatory 5-D row (:83-89)."""
    p = np.atleast_2d(np.asarray(p, dtype=np.float64))
    return (np.sin(3 * p[:, 0]) * np.cos(2 * p[:, 1])
            + np.sin(2 * p[:, 2] + p[:, 3]) + 0.5 * np.cos(4 * p[:, 4])
            + 0.2 * np.sin(p[:, 0] * p[:, 4] * 2)
            + 0.1 * np.cos(p[:, 1] + p[:, 2] * p[:, 3]))


def kinked_np(p, _data=None):
    """Its 2-piece spline (:102-104): a kink minimum on the knot."""
    p = np.asarray(p, dtype=np.float64)
    return np.abs(p[:, 0]) + (p[:, 1] - 0.2) ** 2


def bowl10_np(p, _data=None):
    """Its 10-D additive slider (:113-115)."""
    p = np.atleast_2d(np.asarray(p, dtype=np.float64))
    return sum((p[:, i] - 0.05 * i) ** 2 for i in range(10))


def q3_np(p, _data=None):
    """Its 3-D TT (:126-129)."""
    p = np.asarray(p, dtype=np.float64)
    return ((p[:, 0] ** 2 - 0.25) ** 2 + (p[:, 1] - 0.3) ** 2
            + (p[:, 2] + 0.4) ** 2)


def circle_np(p, _data=None):
    return p[:, 0] ** 2 + p[:, 1] ** 2 - 0.64


def line_np(p, _data=None):
    return p[:, 0] - p[:, 1]


def surrogate_np(points, _data=None):
    """bench_tt_minimize.py's 10-D basket surrogate (:52-58)."""
    x = np.asarray(points, dtype=np.float64)
    d = x.shape[1]
    s = x @ (0.6 + 0.4 * np.cos(np.arange(d)))
    return np.exp(-0.5 * np.sum(x * x, axis=-1) / d) * np.cos(1.7 * s) \
        + 0.1 * s


def oscillating_np(freq):
    """bench_zero_isolation.py's interpolated function (:59-64): a
    product of cosines of ``freq`` plus a small tilt."""
    def f(points, _data=None):
        x = np.asarray(points, dtype=np.float64)
        out = np.ones(x.shape[0])
        for k in range(x.shape[1]):
            out = out * np.cos(freq * x[:, k] + 0.3 * k)
        return out + 0.05 * np.sum(x, axis=-1)
    return f


def global_models(b, s, device):
    """bench_global_calculus.py's models on ``device``: the card's, and
    a CPU build of each that the card's calls are held to."""
    key = ("global", str(torch.device(device)))
    if key not in s:
        k = b.w.search_nodes
        built = {
            "waves": ChebyshevApproximation(
                waves_np, 2, [[-1.5, 1.5], [-1, 2]], [k, k],
                vectorized=True, device=device),
            "bowl3": ChebyshevApproximation(
                bowl3_np, 3, [[-1, 1]] * 3, [9, 9, 9], vectorized=True,
                device=device),
            "osc5": ChebyshevApproximation(
                osc5_np, 5, [[-1, 1]] * 5, [k] * 5, vectorized=True,
                device=device),
            "spline": ChebyshevSpline(
                kinked_np, 2, [[-1, 1], [-1, 1]], [[9, 9], [9]],
                knots=[[0.0], []], vectorized=True, device=device),
            "slider": ChebyshevSlider(
                bowl10_np, 10, [[-1, 1]] * 10, [9] * 10,
                partition=[[i] for i in range(10)], pivot_point=[0.0] * 10,
                vectorized=True, device=device),
            "circle": ChebyshevApproximation(
                circle_np, 2, [[-1, 1]] * 2, [7, 7], vectorized=True,
                device=device),
            "line": ChebyshevApproximation(
                line_np, 2, [[-1, 1]] * 2, [7, 7], vectorized=True,
                device=device),
            "tt": ChebyshevTT(q3_np, 3, [[-1, 1]] * 3, [9, 9, 9],
                              tolerance=1e-12, max_rank=8, vectorized=True,
                              device=device),
        }
        for name, model in built.items():
            if name == "tt":
                model.build(verbose=False, seed=0 + b.seed)
            else:
                model.build(verbose=False)
        s[key] = built
    return s[key]


@contextlib.contextmanager
def searches():
    """Records the ``GlobalResult`` of every optimum search run in the
    block (``utils.globalcalc``'s two search entry points) and the boxes
    whose statistics ran through PyTorch on the model's device
    (``ops.subdivision._device_raw_stats``); an uncertified search's
    RuntimeWarning is held back (the line says ``certified``)."""
    rec = {"results": [], "device_boxes": 0}
    saved = {name: getattr(globalcalc, name)
             for name in ("minimize_coeff_tensor", "minimize_tt_cores")}
    raw = subdivision._device_raw_stats

    def kept(search):
        def run(*args, **kwargs):
            out = search(*args, **kwargs)
            rec["results"].append(out)
            return out
        return run

    def counted(coeffs, boxes, *args):
        rec["device_boxes"] += boxes.shape[0]
        return raw(coeffs, boxes, *args)

    for name, search in saved.items():
        setattr(globalcalc, name, kept(search))
    subdivision._device_raw_stats = counted
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            yield rec
    finally:
        for name, search in saved.items():
            setattr(globalcalc, name, search)
        subdivision._device_raw_stats = raw


def value_scale(model) -> float:
    """A bound on |f| over the model's box from its node values: the
    scale of the values-within ceilings (chip_smoke.py phase 41)."""
    if isinstance(model, ChebyshevTT):
        return float(np.abs(model.to_dense()).max())
    if isinstance(model, ChebyshevSpline):
        return max(value_scale(p) for p in model._pieces)
    if isinstance(model, ChebyshevSlider):
        pivot = float(model.pivot_value)
        return abs(pivot) + sum(value_scale(sl) + abs(pivot)
                                for sl in model.slides)
    return float(model.tensor_values.abs().max())


def search_fields(rec) -> dict:
    """A line's account of the searches one call ran."""
    res = rec["results"]
    return {"certified": all(r.certified for r in res),
            "gap": max((float(r.gap) for r in res), default=0.0),
            "boxes": int(sum(r.boxes for r in res)), "searches": len(res),
            "device_box_stats": rec["device_boxes"]}


def global_row(b, s, key, call):
    """One of bench_global_calculus.py's calls on the card's model,
    timed, held to the same call on a CPU build of the same model: a
    value within 1e-12 x the model's scale and the same certificate;
    equal counts of points and roots."""
    models = global_models(b, s, b.device)
    last = {}

    def run():
        with searches() as rec:
            last["out"] = call(models)
        last["rec"] = rec

    row = b.seconds(run, n=0)
    with searches() as want_rec:
        want = call(global_models(b, s, "cpu"))
    got, rec = last["out"], last["rec"]
    scale = value_scale(models[key])
    fields = dict(against="the same call on a CPU build of the same model",
                  scale=scale, **search_fields(rec))
    if isinstance(got, tuple):   # (value, point) of an optimum
        fields.update(
            n=fields["boxes"], deviation=abs(got[0] - want[0]) / scale,
            ceiling=GLOBAL_VS_CPU, optimum=float(got[0]),
            point=[float(x) for x in got[1]],
            checks={"certified_differs": [
                int(fields["certified"]
                    != search_fields(want_rec)["certified"]), 0]})
    elif isinstance(got, list):   # CriticalPoints
        fields.update(
            n=len(got), ceiling=GLOBAL_VS_CPU,
            deviation=max((abs(a.value - c.value) / scale
                           for a, c in zip(got, want)), default=0.0),
            points=len(got), kinds=[c.kind for c in got],
            checks={"count_differs": [abs(len(got) - len(want)), 0],
                    "kinds_differ": [int([c.kind for c in got]
                                         != [c.kind for c in want]), 0]})
    else:   # the roots of a system, (K, d)
        fields.update(
            n=int(got.shape[0]), ceiling=GLOBAL_VS_CPU,
            deviation=(float(np.abs(got - want).max())
                       if got.shape == want.shape and got.size else 0.0),
            roots=got.tolist(),
            checks={"count_differs": [abs(got.shape[0] - want.shape[0]),
                                      0]})
    return dict(row, **fields)


def global_min(b, s, key):
    return global_row(b, s, key, lambda m: m[key].minimize(tol=1e-9))


def global_waves(b, s):
    return global_min(b, s, "waves")


def global_bowl3(b, s):
    return global_min(b, s, "bowl3")


def global_spline(b, s):
    return global_min(b, s, "spline")


def global_slider(b, s):
    return global_min(b, s, "slider")


def global_tt(b, s):
    return global_min(b, s, "tt")


def global_bowl3_critical(b, s):
    return global_row(b, s, "bowl3",
                      lambda m: m["bowl3"].critical_points())


def global_tt_critical(b, s):
    return global_row(b, s, "tt",
                      lambda m: m["tt"].critical_points())


def global_solve(b, s):
    return global_row(b, s, "circle",
                      lambda m: solve_system([m["circle"], m["line"]]))


def global_osc5(b, s):
    """The 21^5 oscillatory search (tol 1e-7, 5,000 boxes), held to a
    witness: the min of the model's f64 path over 2^20 points must not
    beat the certified bound value - gap (check_witness's inequality;
    for a minimum its two forms are one)."""
    osc = global_models(b, s, b.device)["osc5"]
    last = {}

    def run():
        with searches() as rec:
            last["out"] = osc.minimize(tol=1e-7, max_boxes=b.w.osc_boxes)
        last["rec"] = rec

    row = b.seconds(run, n=0)
    (value, point), fields = last["out"], search_fields(last["rec"])
    gap = 1e-7 if fields["certified"] else fields["gap"]
    pts = b.on(sample_points(b.w.n, 41 + b.seed, [[-1.0, 1.0]] * 5))
    witness = float(osc.eval_batch_device(pts).min())
    scale = float(osc.tensor_values.abs().max())
    at_point = float(osc.eval_batch_host(point[None], [0] * 5)[0])
    return dict(row, **fields, n=fields["boxes"],
                deviation=max(0.0, value - gap - witness) / scale,
                ceiling=WITNESS_EPS,
                against=f"the min of the f64 path over {b.w.n:,} points "
                        f"(seed 41): value - gap within 1e-10 x scale of "
                        f"it or below",
                optimum=float(value), point=[float(x) for x in point],
                witness=witness, scale=scale,
                checks={"value_vs_eval_at_point": [
                    abs(at_point - value) / scale, GLOBAL_VS_CPU]})


def tt_search_chain(b, s):
    """bench_tt_minimize.py's chain (:47-71): the 10-D surrogate by
    TT-Cross, 7 nodes, max_rank 8, tolerance 1e-12."""
    if "ttmin" not in s:
        nodes, rank, _ = b.w.tt_search
        tt = ChebyshevTT(surrogate_np, 10, [[-1.0, 1.0]] * 10, [nodes] * 10,
                         max_rank=rank, tolerance=1e-12, vectorized=True,
                         device=b.device)
        tt.build(verbose=False, seed=0 + b.seed)
        s["ttmin"] = tt
    return s["ttmin"]


def tt_search(b, s):
    """``minimize_tt_cores`` of the chain (host NumPy), held to a
    witness of 2^20 uniform points through the f64 chain on the card."""
    tt = tt_search_chain(b, s)
    cores = [np.asarray(c, dtype=np.float64) for c in tt._coeff_cores]
    max_boxes = b.w.tt_search[2]
    last = {}

    def run():
        last["res"] = subdivision.minimize_tt_cores(cores, tol=1e-9,
                                                    max_boxes=max_boxes)

    row = b.seconds(run, n=0, host=True)
    res = last["res"]
    chain = tt._cores_on_device(torch.float64)
    dom = np.asarray(tt.domain)
    pts = np.random.default_rng(TT_SEARCH_WITNESS_SEED + b.seed).uniform(
        -1.0, 1.0, (b.w.n, 10))
    vals = tt_eval.tt_eval_batch(chain, dom, b.on(pts))
    witness, scale = float(vals.min()), float(vals.abs().max())
    at_loc = float(tt_eval.tt_eval_batch(chain, dom,
                                         b.on(res.location[None]))[0])
    return dict(row, n=int(res.boxes),
                deviation=max(0.0, res.value - res.gap - witness) / scale,
                ceiling=WITNESS_EPS,
                against=f"the min of the f64 chain over {b.w.n:,} uniform "
                        f"points (seed {TT_SEARCH_WITNESS_SEED}): value - gap "
                        f"within 1e-10 x scale of it or below",
                optimum=float(res.value), gap=float(res.gap),
                certified=bool(res.certified), boxes=int(res.boxes),
                max_boxes=max_boxes, witness=witness, scale=scale,
                ranks=tt.tt_ranks,
                checks={"value_vs_chain_at_location": [
                    abs(at_loc - res.value) / scale, GLOBAL_VS_CPU]})


def zero_isolation(b, s, case):
    """``isolate_common_zeros`` of an interpolant's gradient system (host
    NumPy), timed where ``critical_points()`` of the same interpolant
    calls it on the same tensors with the script's delta and
    ``max_boxes``, so one call gives the row and its check: each
    critical point within delta of a surviving centre, its gradient
    zero."""
    n, d, freq, delta, max_boxes = b.w.zeros[case]
    interp = ChebyshevApproximation(oscillating_np(freq), d, [[-1.0, 1.0]] * d,
                                    [n] * d, vectorized=True, device=b.device)
    interp.build(verbose=False)
    isolate = globalcalc.isolate_common_zeros
    isolations, last = [], {}

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        last["centres"] = isolate(*args, **kwargs)
        isolations.append((time.perf_counter() - t0) * 1e3)
        return last["centres"]

    def run():
        globalcalc.isolate_common_zeros = timed
        try:
            last["found"] = interp.critical_points(delta=delta,
                                                   max_boxes=max_boxes)
        finally:
            globalcalc.isolate_common_zeros = isolate

    calls = b.samples(lambda _: run(), [None], host=True)
    ms = isolations[-len(calls):]   # the timed calls' (warm-ups first)
    centres = last["centres"]
    specs = globalcalc._grad_specs(d)
    pts = np.array([c.point for c in last["found"]]).reshape(-1, d)
    missed = sum(1 for p in pts
                 if np.abs(centres - p).max(axis=1).min() > delta)
    grads = (np.abs(interp.vectorized_eval_batch_multi(pts, specs))
             if len(pts) else np.zeros((0, d)))
    grad_scale = max(float(interp.differentiate(spec).tensor_values
                           .abs().max()) for spec in specs)
    return timing(ms, value=float(np.median(ms)) / 1e3, unit="s",
                  n=int(centres.shape[0]),
                  deviation=float(grads.max(initial=0.0)) / grad_scale,
                  ceiling=GRAD_AT_CRITICAL,
                  against="the points critical_points() returns from "
                          "these boxes: max |gradient| there over its max "
                          "on the grid; each within delta of a surviving "
                          "centre (checks)",
                  critical_points_ms=float(np.median(calls)),
                  boxes=int(centres.shape[0]), critical_points=len(pts),
                  delta=delta, max_boxes=max_boxes, host_cpu=b.cpu,
                  checks={"critical_points_missed": [missed, 0]})


def zeros_3d(b, s):
    return zero_isolation(b, s, 0)


def zeros_4d(b, s):
    return zero_isolation(b, s, 1)


# --- grouped TT chains (scripts/bench_tt_book_grouped.py, bench_tt_grouped.py,
# bench_highd_grouping.py) --------------------------------------------------


def tt_book(b, s):
    """bench_tt_book_grouped.py's book (:60-66): price and the five
    first-order ``differentiate()`` specs of ``to_tt(1e-13)``."""
    if "tt_book" not in s:
        comp = compressed(b, s)
        models = [comp] + [comp.differentiate(list(spec))
                           for spec in FIRST_ORDER]
        s["tt_book"] = [tuple(m._cores_on_device(torch.float64))
                        for m in models]
    return s["tt_book"]


def tt_book_row(b, s, groups):
    cores = tt_book(b, s)
    n = b.w.n // 2
    pts = [b.on(h) for h in b.batches(
        3, lambda rng: sample_points(n, rng=rng), n * 5 * 8)]
    dom = np.asarray(DOMAIN)
    run = tt_eval_dd.tt_dd_book_runner(cores, dom, groups=groups)
    sub = pts[0][:CHAIN_CHECK]
    got = run(sub)
    other = tt_eval_dd.tt_dd_book_runner(
        cores, dom, groups=None if groups else "auto")(sub)
    d_f64 = max(dev(got[m], tt_eval.tt_eval_batch(c, dom, sub))
                for m, c in enumerate(cores))
    d_groups = max(dev(got[m], other[m]) for m in range(len(cores)))
    return b.rate(run, pts, n, "sets/s", deviation=d_f64, ceiling=DD,
                  against=f"each model's f64 chain (ops.tt_eval."
                          f"tt_eval_batch) on {len(sub):,} points of the "
                          f"first batch (seed 3), on its own scale",
                  models=len(cores), groups=groups,
                  checks={"grouped_vs_perdim": [d_groups, TO_TT]})


def book_perdim(b, s):
    return tt_book_row(b, s, None)


def book_grouped(b, s):
    return tt_book_row(b, s, "auto")


def trimmed(b, s):
    """bench_tt_grouped.py's compression C (:64): trimmed per bond to a
    measured sup deviation of 3e-12 on the grid."""
    if "trim" not in s:
        s["trim"] = dense(b, s).to_tt(tolerance=1e-13,
                                      sup_target=b.w.sup_target)
    return s["trim"]


def to_tt_points(b, s):
    """bench_tt_grouped.py's points (seed 7) and the dense f64 path on
    its probe, the first 65,536 (:70-71, 124-126)."""
    cheb = dense(b, s)
    if "tg64" not in s:
        host = b.batches(7, lambda rng: sample_points(b.w.n, rng=rng),
                         b.w.n * 5 * 8)
        s["tg64"] = [b.on(h) for h in host]
        s["tg_ref"] = eval_ops.eval_batch(
            cheb.tensor_values, *s["grid"], s["tg64"][0][:TO_TT_PROBE],
            (0,) * 5)
    return s["tg64"], s["tg_ref"]


def to_tt_row(b, s, comp, groups, dtype=torch.float64):
    """One configuration of bench_tt_grouped.py: dd (native f64) or
    f32 per-dim, explicitly grouped or ``"auto"``."""
    pts, ref = to_tt_points(b, s)
    cores = comp._cores_on_device(dtype)
    dom = np.asarray(comp.domain, dtype=np.float64)
    if dtype == torch.float64:
        def run(p):
            return tt_eval_dd.tt_eval_batch_dd(cores, dom, p, groups=groups)
        ceiling, what = TO_TT, "dd"
    else:
        pts = [p.float() for p in pts]

        def run(p):
            return tt_eval.tt_eval_batch(cores, dom, p, groups=groups)
        ceiling, what = F32, "f32"
    shown = (list(tt_eval_dd.tt_dd_auto_groups(tt_eval.core_shapes(cores)))
             if groups == "auto" else groups)
    return b.rate(run, pts, b.w.n, "queries/s",
                  deviation=dev(run(pts[0][:len(ref)]), ref),
                  ceiling=ceiling,
                  against=f"the dense f64 path on the first {len(ref):,} "
                          f"points (seed 7)",
                  ranks=comp.tt_ranks, groups=shown, tier=what)


def trim_fields(b, s) -> dict:
    diag = trimmed(b, s).compression_diagnostics
    return {"sup_target": b.w.sup_target, "compression_diagnostics": {
        k: [int(x) for x in v] if isinstance(v, list) else float(v)
        for k, v in diag.items()}}


def perdim_dd(b, s):
    return to_tt_row(b, s, compressed(b, s), None)


def g221_dd(b, s):
    return to_tt_row(b, s, compressed(b, s), [2, 2, 1])


def g122_dd(b, s):
    return to_tt_row(b, s, compressed(b, s), [1, 2, 2])


def trim_perdim_dd(b, s):
    return dict(to_tt_row(b, s, trimmed(b, s), None), **trim_fields(b, s))


def trim_grouped_dd(b, s):
    return dict(to_tt_row(b, s, trimmed(b, s), "auto"), **trim_fields(b, s))


def perdim_f32(b, s):
    return to_tt_row(b, s, compressed(b, s), None, torch.float32)


def grouped_f32(b, s):
    return to_tt_row(b, s, compressed(b, s), "auto", torch.float32)


def highd_slider_chain(b, s, d):
    """bench_highd_grouping.py's d-D basket slider (:47-57; at d = 10,
    config 4's), converted with ``to_tt()``: f64 cores and points of
    seed 11 in [-1, 1]^d."""
    key = ("highd", d)
    if key not in s:
        slider = ChebyshevSlider(basket_np, d, [[-1.0, 1.0]] * d, [9] * d,
                                 [[i] for i in range(d)], [0.0] * d,
                                 vectorized=True, device=b.device)
        slider.build(verbose=False)
        tt = slider.to_tt()
        n = b.w.n
        pts = b.batches(11, lambda rng: rng.uniform(-1, 1, (n, d)), n * d * 8)
        s[key] = (tt._cores_on_device(torch.float64), tt.tt_ranks,
                  [b.on(p) for p in pts])
    return s[key]


def synthetic_chain(b, s):
    """The script's 14-D rank-8 chain (:77-90): 7 nodes, decayed random
    cores, then the points, from one seed-3 stream."""
    if "synthetic" not in s:
        d, nn, r = 14, 7, 8
        rng = np.random.default_rng(3 + b.seed)
        raw = []
        for k in range(d):
            c = rng.normal(size=(1 if k == 0 else r, nn,
                                 1 if k == d - 1 else r))
            c[:, 2:, :] *= np.exp(-1.2 * np.arange(nn - 2))[None, :, None]
            raw.append(c / (1.1 * np.abs(c).sum(axis=1).max()))
        n = b.w.n
        pts = b.batches(None, lambda g: g.uniform(-1, 1, (n, d)), n * d * 8,
                        rng=rng)
        s["synthetic"] = (tuple(b.on(c) for c in raw),
                          [1] + [c.shape[2] for c in raw],
                          [b.on(p) for p in pts])
    return s["synthetic"]


def highd_row(b, chain, groups):
    cores, ranks, pts = chain
    dom = np.asarray([[-1.0, 1.0]] * len(cores))

    def run(p):
        return tt_eval_dd.tt_eval_batch_dd(cores, dom, p, groups=groups)

    sub = pts[0][:CHAIN_CHECK]
    return b.rate(run, pts, b.w.n, "queries/s",
                  deviation=dev(run(sub), tt_eval.tt_eval_batch(cores, dom,
                                                                sub)),
                  ceiling=DD,
                  against=f"the per-dim f64 chain of the same cores on "
                          f"{len(sub):,} points of the first batch",
                  ranks=ranks, groups=groups, auto_groups=list(
                      tt_eval_dd.tt_dd_auto_groups(
                          tt_eval.core_shapes(cores))))


def highd10_perdim(b, s):
    return highd_row(b, highd_slider_chain(b, s, 10), None)


def highd10_auto(b, s):
    return highd_row(b, highd_slider_chain(b, s, 10), "auto")


def highd14_perdim(b, s):
    return highd_row(b, highd_slider_chain(b, s, 14), None)


def highd14_auto(b, s):
    return highd_row(b, highd_slider_chain(b, s, 14), "auto")


def synthetic_perdim(b, s):
    return highd_row(b, synthetic_chain(b, s), None)


def synthetic_auto(b, s):
    return highd_row(b, synthetic_chain(b, s), "auto")


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
    ("bs5d_11n_host_query_us", host_query),
    ("bs5d_11n_host_price_greeks_us", host_price_greeks),
    ("bs5d_11n_to_tt_host_query_us", to_tt_host_query),
    ("bs5d_tt_r15_host_query_us", tt_host_query),
    ("spline2d_17n_build_s", spline_build),
    ("spline2d_17n_f64_queries_per_sec", spline_f64),
    ("spline2d_17n_f32_queries_per_sec", spline_f32),
    ("slider10d_9n_build_s", slider_build),
    ("slider10d_9n_f32_queries_per_sec", slider_f32),
    ("slider10d_9n_dd_queries_per_sec", slider_dd),
    ("slider10d_9n_f64_queries_per_sec", slider_f64),
    ("portfolio4d_tt_als_build_s", portfolio_build),
    ("portfolio4d_run_completion_s", portfolio_completion),
    ("bs5d_11n_f64_box_integrals_per_sec", box_f64),
    ("bs5d_11n_f32_box_integrals_per_sec", box_f32),
    ("bs5d_11n_dd_box_integrals_per_sec", box_dd),
    ("bs5d_tt11_r15_f64_box_integrals_per_sec", tt_box_f64),
    ("bs5d_11n_f64_cond_exp_scenarios_per_sec", cond_f64),
    ("bs5d_tt11_r15_dd_cond_exp_scenarios_per_sec", tt_cond_dd),
    ("bs5d_11n_integrate_book_boxes_per_sec", book_integrals),
    ("bs5d_11n_scenario_roots_per_sec", scenario_roots),
    ("bs5d_11n_scenario_minima_per_sec", scenario_minima),
    ("fit3d_9n_host_samples_per_sec", fit_host),
    ("fit3d_9n_f32_samples_per_sec", fit_f32),
    ("fit3d_9n_dd_samples_per_sec", fit_dd),
    ("ttfit5d_7n_r5_device_sample_sweeps_per_sec", tt_fit_device),
    ("ttfit5d_7n_r5_host_sample_sweeps_per_sec", tt_fit_host),
    ("global_waves2d_21n_min_s", global_waves),
    ("global_bowl3d_9n_min_s", global_bowl3),
    ("global_osc5d_21n_min_s", global_osc5),
    ("global_spline2d_kink_min_s", global_spline),
    ("global_slider10d_9n_min_s", global_slider),
    ("global_tt3d_r8_min_s", global_tt),
    ("global_bowl3d_9n_critical_points_s", global_bowl3_critical),
    ("global_tt3d_r8_critical_points_s", global_tt_critical),
    ("global_circle_line_solve_system_s", global_solve),
    ("ttmin10d_7n_r8_certified_min_s", tt_search),
    ("zeros_31n_3d_isolation_s", zeros_3d),
    ("zeros_25n_4d_isolation_s", zeros_4d),
    ("bs5d_to_tt_dd_book6_perdim_sets_per_sec", book_perdim),
    ("bs5d_to_tt_dd_book6_grouped_sets_per_sec", book_grouped),
    ("bs5d_11n_to_tt_perdim_dd_queries_per_sec", perdim_dd),
    ("bs5d_11n_to_tt_g221_dd_queries_per_sec", g221_dd),
    ("bs5d_11n_to_tt_g122_dd_queries_per_sec", g122_dd),
    ("bs5d_11n_to_tt_trim_perdim_dd_queries_per_sec", trim_perdim_dd),
    ("bs5d_11n_to_tt_trim_grouped_dd_queries_per_sec", trim_grouped_dd),
    ("bs5d_11n_to_tt_perdim_f32_queries_per_sec", perdim_f32),
    ("bs5d_11n_to_tt_grouped_f32_queries_per_sec", grouped_f32),
    ("highd_slider10d_9n_to_tt_dd_perdim_queries_per_sec", highd10_perdim),
    ("highd_slider10d_9n_to_tt_dd_auto_queries_per_sec", highd10_auto),
    ("highd_slider14d_9n_to_tt_dd_perdim_queries_per_sec", highd14_perdim),
    ("highd_slider14d_9n_to_tt_dd_auto_queries_per_sec", highd14_auto),
    ("highd_tt14d_7n_r8_dd_perdim_queries_per_sec", synthetic_perdim),
    ("highd_tt14d_7n_r8_dd_auto_queries_per_sec", synthetic_auto),
)
#: Rows that time the host through the C kernels (``utils.ceval``).
HOST_ROWS = {base for base, _ in ROWS if base.endswith("_us")}
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


def select(names=None) -> tuple:
    """The rows whose names start with one of ``names`` (every row when
    None), in ``ROWS`` order; a name that selects nothing is refused."""
    if names is None:
        return ROWS
    unknown = [n for n in names
               if not any(base.startswith(n) for base, _ in ROWS)]
    if unknown or not names:
        raise SystemExit(f"bench_torch: --rows {','.join(unknown)!r} names "
                         f"no row")
    return tuple((base, fn) for base, fn in ROWS
                 if any(base.startswith(n) for n in names))


def passed(rows, count=len(ROWS)) -> bool:
    return (len(rows) == count
            and all(r.get("ok") is True for r in rows))


def held(row) -> bool:
    """The row's deviation within its ceiling, and each of its checks
    within its limit."""
    return bool(row["deviation"] <= row["ceiling"]
                and all(v <= lim for v, lim in row.get("checks",
                                                       {}).values()))


def main(device="cuda", small=False, reps=40, seed=0,
         rows=None) -> list[dict]:
    """Run the rows ``rows`` selects (``select``; every row by
    default); print the lines; return the metric lines."""
    selected = select(rows)
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
        "seed": seed, "reps": reps, "small": small, "host_cpu": b.cpu,
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
    if any(base in HOST_ROWS for base, _ in selected):
        # The host rows' C library compiles at first use: set-up time.
        t0 = time.perf_counter()
        b.emit({"setup": "host C compiler build of cpp/hosteval.c "
                         "(utils.ceval)", "ok": ceval.available(),
                "seconds": time.perf_counter() - t0})
    s = {}
    for base, row_fn in selected:
        metric = b.name(base)
        t0 = time.perf_counter()
        try:
            row = row_fn(b, s)
            # the row's whole wall time: inputs, checks, timed calls
            row = {"metric": metric, **row, "device": card,
                   "row_s": time.perf_counter() - t0}
            row["ok"] = held(row)
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
                                       f"(ceiling {row['ceiling']:g}), "
                                       f"checks {row.get('checks', {})}"))
    b.emit({"ok": passed(b.rows, len(selected)), "rows": len(b.rows),
            "failed": [r["metric"] for r in b.rows if not r["ok"]]})
    return b.rows


def cli(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--small", action="store_true",
                        help="the rehearsal widths (9 nodes, 4,096 points)")
    parser.add_argument("--reps", type=int, default=40)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--rows", type=lambda v: v.split(","),
                        metavar="NAME[,NAME...]",
                        help="run only the rows whose names start with one "
                             "of these (default: every row)")
    args = parser.parse_args(argv)
    rows = main(args.device, args.small, args.reps, args.seed, args.rows)
    return 0 if passed(rows, len(select(args.rows))) else 1


if __name__ == "__main__":
    sys.exit(cli())

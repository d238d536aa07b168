"""Chip check of the PyTorch port on one CUDA card.

Drives the port's main paths through their public entry points: the
dense 5-D Black-Scholes interpolant on an 11^5 Chebyshev grid (161,051
nodes), built from one vectorized host oracle call and queried in
batches of 2^20 points

- in f32, through the hand-written CUDA evaluator (K1), and in f64,
  served by ``BatchedEvaluator`` and ``MultiSpecEvaluator``;
- in the near-f64 "dd" tier (``eval_batch_dd`` and the dd engines),
  through the same evaluator's f64 instance (K3);

and a 19^5 interpolant (2,476,099 nodes), a grid the TPU served with
its stream kernel K2, through the f32 evaluator (and the f64 one).  It
builds the kernels from this checkout's sources, reports each
instance's registers, spills and tensor-core instructions, holds each
to its plain PyTorch version, checks every path against the
repository's accuracy ceilings, and times the paths, the plain versions
and a cuBLAS GEMM yardstick with CUDA events.

Then the tensor-train family (plain PyTorch chains, no kernel of their
own): a rank-15 TT-Cross build of the 5-D Black-Scholes price with
dividend yield on 11 nodes per dim; the C single-point host path
(``cpp/hosteval.c``, built here with the host compiler) under the dense
and TT classes; the f32, f64 and grouped chains against the host chain;
exact-compression serving (``to_tt(1e-13)`` of the 11^5 interpolant
through ``eval_batch_dd``); the TT engines, a six-model book of price
plus ``differentiate()``d Greeks, and the finite-difference report; and
their times at 2^20 points.

Then the spline and slider families (plain PyTorch, K3 under the dd
spline route): the repository's configuration 3, the payoff
max(x0 - 1, 0) e^(-0.1 x1) on [0, 2] x [0, 1] with a knot at 1.0 and
17^2 nodes per piece, through the ``special_points`` dispatch, the class
path, the f32/f64/dd engines and the multi-spec report at 2^20 points;
the masked-against-routed sweep that sets ``ops.spline_eval``'s
crossover constants (P = 2, 16, 64 pieces of 12^2 nodes); a 3-D spline
served at ``dtype="dd"`` through K3; and configuration 4, the 10-D
additive basket on [-1, 1]^10 with 9 nodes a dim and singleton slides,
through its engines, the dd Greek report and ``to_tt``.

Then calculus and scenario batches (plain PyTorch, no kernel), on the
same models: box integrals of the 11^5 interpolant over 2^17 boxes at
f64, f32 and dd, conditional expectations over (S, T) boxes at the
other three coordinates, ``integrate_book`` over price plus five
``differentiate()``d Greeks, the TT family's box integrals (the rank-15
cross at f64 and f32, ``to_tt(1e-13)`` at dd) and ``to_slider``, config
3's spline and config 4's slider against closed forms and host
integrals, and roots and 1-D optima along S over 4,096 scenarios,
against the single-scenario calls.

Then fits from scattered samples, TT completion, books and files: the
dense least-squares fit of ``scripts/bench_fit.py`` (9^3 nodes; the
host engine at 2^15 samples, the f32 device engine at 2^20 and the
native-f64 device-dd engine at 2^19) with its Grams held to the host's,
the fitted model served through K1 and K3, a gradient-enhanced fit,
config 3's spline and config 4's slider fitted at 2^20 samples, the
TT-ALS fit of ``scripts/bench_tt_fit.py`` (10^6 samples), config 5's
portfolio with ``run_completion``, and a six-model ``build_book`` with
its ``.npz`` files and Sobol indices.

Then global calculus (a host branch-and-bound whose dense box
statistics run as f64 GEMMs on the card; no kernel of its own): the
statistics held to the NumPy route and swept against it across sizes
(on the card and in PyTorch on the host), the certified minimum and
maximum of the 11^5 interpolant over its box and with K pinned, each
witnessed by 2^20 points through K3 and each certified one held to the
same search on the NumPy route, the rows of
``scripts/bench_global_calculus.py`` (2-D to 5-D dense, a kinked spline,
a 10-D slider, a TT, critical points, ``solve_system``) against the same
calls on CPU builds of the same models, at the card's threshold and with
every box statistic forced onto the card, and the main path's two
busiest searches end to end at several card thresholds.

Then the multi-device checklist of the JAX package's
``dryrun_multichip`` (``parallel/``, ``mesh=``): on a one-rank NCCL
world on the card (the machine holds one card), the 11^5 engines at 2^20
on a ``("dp",)`` mesh (f32 through K1, f64, dd through K3, the f64 and
dd price + 5 Greeks), a 19^5 f32 engine through K2, each bitwise the
engine without a mesh and timed beside it; tp of 11^5 with d/dS, dp box
integrals and grouped-dd TT bucket masses at 2^17, a sharded six-model
``build_book`` and its engine, config 4's slider as a TT served dp, the
dense fits (device-dd at 2^19, device at 2^20), a TT build and
``run_completion`` with sharded oracle batches, a one-stage pipeline;
then a 4-rank gloo world on the host's CPU (dp, tp (2, 2), dd tp of a
(9, 16400) grid over tp = 4, a four-stage pipeline, a sharded book, TT
build and device-dd fit) held to the port's single-device results.

Then autodiff and the examples: ``torch.autograd`` and ``torch.func``
through the f64 evaluator of the 11^5 interpolant (gradients at 2^16
points and Hessians against the spectral derivative specs, the tensor
gradient against the CPU's, forward against forward plus backward at
2^20); K1, K2 and K3 refusing a tensor that requires grad; and every
example of ``examples_torch/`` run on the card, whose K1 and K3
launches join the kernels line.

Then the benchmark and the JAX package's on-chip tests: every row of
``bench_torch.py`` at full widths with a few timed calls a row but the
host searches too long for this script's time (``BENCH_ALONE``), each
line parsed and held to its ceiling (its K1 and K3 launches join the
kernels line); and the checks of ``tests/test_tpu_hardware.py`` that no
phase above holds (the 21^5 grid, the kernels' operand caches under an
in-place edit, the TT core cache, the TT dd fast mode, a slider dd
report with a two-dim slide).

Run from the repository root, with one CUDA card:

    python3 chip_smoke.py

Each phase prints one line; any failure exits non-zero before the last
line, which is ``{"ok": true, "device": {...}}``.  Without CUDA (or
without the package beside this file) it exits non-zero.
"""

from __future__ import annotations

import cProfile
import json
import pstats
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
from scipy.stats import norm

from pychebyshev_tpu_torch import (
    BatchedEvaluator,
    ChebyshevApproximation,
    ChebyshevSlider,
    ChebyshevSpline,
    ChebyshevTT,
    MultiModelEvaluator,
    MultiSpecEvaluator,
    solve_system,
)
from pychebyshev_tpu_torch.ops import (
    _build,
    fused_dd,
    fused_eval,
    spline_eval,
    subdivision,
    tt_eval,
    tt_eval_dd,
)
from pychebyshev_tpu_torch.ops.chebyshev import (
    barycentric_weights_np,
    differentiation_matrix_np,
    nodes_for_dim_np,
)
from pychebyshev_tpu_torch.ops import eval as eval_ops
from pychebyshev_tpu_torch.ops import eval_dd
from pychebyshev_tpu_torch.ops import integrate as integrate_ops
from pychebyshev_tpu_torch.ops.quadrature import (
    fejer1_weights,
    sub_interval_weights,
)
from pychebyshev_tpu_torch.parallel import sharding
from pychebyshev_tpu_torch.parallel.tt_pipeline import tt_eval_batch_pp
from pychebyshev_tpu_torch.parallel.world import (
    check_replicated,
    local_world,
    run_world,
)
from pychebyshev_tpu_torch.serving import (
    build_book,
    integrate_book,
    load_book,
    save_book,
)
from pychebyshev_tpu_torch.utils import ceval
from pychebyshev_tpu_torch.utils import fitting as fit_ops
from pychebyshev_tpu_torch.utils import globalcalc
from pychebyshev_tpu_torch.utils.calculus import normalize_bounds_batch

from bench_torch import (  # the benchmark's workloads, shared
    bowl3_np,
    bowl10_np,
    circle_np,
    fit_target_np,
    kinked_np,
    line_np,
    osc5_np,
    q3_np,
    value_scale,
    waves_np,
)

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
SEED = 0
N = 1 << 20
NB = 1 << 17        # boxes and conditional scenarios (bench.py:468)
NS = 4096           # scenarios of the batched roots and optima
DOMAIN = [[80.0, 120.0], [90.0, 110.0], [0.25, 2.0], [0.1, 0.5],
          [0.01, 0.05]]
GREEKS = [(0, 0, 0, 0, 0), (1, 0, 0, 0, 0), (2, 0, 0, 0, 0),
          (0, 0, 1, 0, 0), (0, 0, 0, 1, 0), (0, 0, 0, 0, 1)]
# The TT build's configuration: a narrower domain and a 2 % dividend
# yield, 11 nodes per dim, rank 15, tolerance 1e-6, 10 sweeps, seed 42.
TT_DOMAIN = [[80.0, 120.0], [90.0, 110.0], [0.25, 1.0], [0.15, 0.35],
             [0.01, 0.08]]
TT_Q = 0.02
# Scale-normalized max deviations: max|a - ref| / max|ref|.
K1_VS_PLAIN = 5e-5
F32_CEILING = 2e-4
F64_CEILING = 1e-12
K3_VS_PLAIN = 1e-12   # both f64: summation order only
DD_CEILING = 1e-10
HOST_C_VS_NUMPY = 1e-14         # C host path vs NumPy path, values
HOST_C_VS_NUMPY_DERIV = 1e-10   # ... derivative specs (D^k folds amplify)
TT_PRICE_ERR_MAX_PCT = 0.1      # rank-15 cross, 50 test points
TT_CROSS_VALUE = 1e-3           # rank-15 cross vs the dense interpolant
TT_CROSS_DELTA = 1e-2
FD_REPORT = 1e-6                # batched FD stencil vs the per-point one
# Configuration 3 (scripts/run_baseline_table.py:400-475): the payoff
# kink at 1.0, 17^2 nodes per piece.  Configuration 4 (:482-540,
# bench.py:531-570): the 10-D additive basket, 9 nodes a dim.
SPLINE_DOMAIN = [[0.0, 2.0], [0.0, 1.0]]
SPLINE_SPECS = [(0, 0), (1, 0), (2, 0), (0, 1)]
SLIDER_D = 10
SLIDER_W = np.linspace(0.5, 1.5, SLIDER_D)
SLIDER_GREEKS = [(0,) * SLIDER_D] + [
    tuple(1 if j == k else 0 for j in range(SLIDER_D)) for k in (0, 2, 4, 6)]
SLIDER_VS_FUNCTION = 1e-6       # 9 nodes a dim (the reference read 8.1e-8)
SWEEP_PIECES = (2, 16, 64)      # scripts/sweep_spline_crossover.py:24-31
# Batched against single roots, absolute on S.  Optimum locations are
# held to 1e-10.  Roots get 1e-9, the reference's own batch-vs-single
# bound (tests/test_calculus_batch.py:52): where the slice's last
# Chebyshev coefficient is rounding noise (|c_10| / max|c| ~ 4e-16 for
# some of these scenarios), the colleague matrix moves a root by up to
# ~1.3e-10 between two f64 summation orders of the same slice values.
ROOTS_VS_SINGLE = 1e-9
LOCATION_VS_SINGLE = 1e-10
# The dense fit of scripts/bench_fit.py:37-60: d = 3 on 9^3 nodes.
FIT_DOMAIN = [[0.0, 2.0], [-1.0, 1.0], [0.0, 1.0]]
FIT_NODES = [9, 9, 9]
FIT_NOISE = 1e-3
FIT_SAMPLES = (("host", 1 << 15), ("device", 1 << 20),
               ("device-dd", 1 << 19))
FIT_SUBSET = 1 << 15            # the shared subset the engines meet on
TT_FIT_SAMPLES = 1_000_000      # scripts/bench_tt_fit.py's default n
TT_FIT_HOST_CUT = 1 << 17
# Gram against the host f64 Gram, scale-normalized: the f32 tier's and
# the dd tier's bounds of the reference (tests/test_fit_device.py:69-70,
# 98).  A fitted model's values, dd against host on the same samples.
FIT_GRAM_F32 = 1e-4
FIT_GRAM_DD = 1e-11
FIT_DD_VS_HOST = 1e-10
# The TT fit's device rms against the host engine's, relative.
TT_FIT_RMS_REL = 0.1
# Config 5's portfolio 2A + B (9 nodes, rank 8) against its closed form.
PORTFOLIO_ERR = 1e-4
# Phase 38's book: six dividend yields of the 5-D Black-Scholes price.
BOOK_YIELDS = np.array([0.0, 0.01, 0.02, 0.03, 0.04, 0.05])
# Global calculus (phases 39-42): the box stats' routes agree per
# quantity within 1e-13 of the box's |c| mass; phase 39 sweeps these
# sizes at 16 and 512 boxes.  The main path's searches run at tol =
# 1e-9 x the price scale; a witness may undercut a certified bound by
# 1e-10 x scale of f64 roundoff; the value at the returned point, the
# same search on the NumPy route and a CPU build of the same model agree
# within 1e-12 x scale.  Phase 42 runs the main path's two busiest
# searches at each card threshold of STATS_THRESHOLDS, in the order
# A B C D D C B A, and a CPU build's K-pinned search at each
# CPU_STATS_THRESHOLDS, A B B A.
STATS_VS_NUMPY = 1e-13
STATS_BOXES = 512
STATS_SWEEP = ((9, 3), (7, 4), (9, 4), (11, 4), (13, 4), (21, 4), (11, 5))
GLOBAL_TOL = 1e-9
WITNESS_EPS = 1e-10
GLOBAL_VS_HOST = 1e-12
GLOBAL_VS_CPU = 1e-12
STATS_THRESHOLDS = (729, 2401, 6561, 20000)
CPU_STATS_THRESHOLDS = (2401, 20000)
# Published H100 SXM peaks (NVIDIA data sheet, 700 W, dense): the pipes
# each instance runs on (TF32 tensor cores, three passes for f32; f64
# tensor cores), the SIMT pipes printed beside them, and device memory.
TF32_PEAK = 495e12
F64_TC_PEAK = 67e12
F32_SIMT_PEAK = 67e12
F64_SIMT_PEAK = 34e12
HBM_BYTES_PER_S = 3.35e12


def bs_price_np(points, _data=None):
    """Analytic Black-Scholes call price (host, float64)."""
    points = np.asarray(points, dtype=np.float64)
    s, k, t, sigma, r = (points[:, i] for i in range(5))
    sqrt_t = np.sqrt(t)
    d1 = (np.log(s / k) + (r + 0.5 * sigma ** 2) * t) / (sigma * sqrt_t)
    d2 = d1 - sigma * sqrt_t
    return s * norm.cdf(d1) - k * np.exp(-r * t) * norm.cdf(d2)


def book_np(points, _data=None):
    """Phase 38's book: the Black-Scholes call price at each dividend
    yield of ``BOOK_YIELDS``, one column each, in one vectorized call
    (host, float64)."""
    points = np.asarray(points, dtype=np.float64)
    s, k, t, sigma, r = (points[:, i:i + 1] for i in range(5))
    q = BOOK_YIELDS[None, :]
    sqrt_t = np.sqrt(t)
    d1 = (np.log(s / k) + (r - q + 0.5 * sigma ** 2) * t) \
        / (sigma * sqrt_t)
    d2 = d1 - sigma * sqrt_t
    return (s * np.exp(-q * t) * norm.cdf(d1)
            - k * np.exp(-r * t) * norm.cdf(d2))


def bs_div_np(points, _data=None):
    """Black-Scholes call price with dividend yield TT_Q (host, f64)."""
    points = np.asarray(points, dtype=np.float64)
    s, k, t, sigma, r = (points[:, i] for i in range(5))
    sqrt_t = np.sqrt(t)
    d1 = (np.log(s / k) + (r - TT_Q + 0.5 * sigma ** 2) * t) \
        / (sigma * sqrt_t)
    d2 = d1 - sigma * sqrt_t
    return (s * np.exp(-TT_Q * t) * norm.cdf(d1)
            - k * np.exp(-r * t) * norm.cdf(d2))


def payoff_np(points, _data=None):
    """Configuration 3's payoff, max(x0 - 1, 0) e^(-0.1 x1) (host f64)."""
    p = np.asarray(points, dtype=np.float64)
    return np.maximum(p[:, 0] - 1.0, 0.0) * np.exp(-0.1 * p[:, 1])


def basket_np(points, _data=None):
    """Configuration 4's basket, sum w sin(x) + 0.25 sum x^2 (host f64)."""
    p = np.asarray(points, dtype=np.float64)
    return np.sum(SLIDER_W * np.sin(p), axis=1) + 0.25 * np.sum(p ** 2,
                                                                axis=1)


def additive_interpolant_np(points, n_nodes):
    """The basket's slider computed independently on the host: each
    dim's 1-D barycentric interpolant of its slice through the pivot 0
    (NumPy, f64), summed, minus 9 pivots (the pivot value is 0)."""
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


def sample_points(n, seed, domain=DOMAIN):
    rng = np.random.default_rng(seed)
    lo = np.array([b[0] for b in domain])
    hi = np.array([b[1] for b in domain])
    return lo + (hi - lo) * rng.uniform(0.02, 0.98, size=(n, len(domain)))


def with_node_hits(pts, nodes):
    """Rows 0-63 sit on a node in every dim; rows 64-127 in one dim."""
    pts = pts.copy()
    d = len(nodes)
    for i in range(64):
        pts[i] = [nodes[k][(i + k) % len(nodes[k])] for k in range(d)]
        pts[64 + i, i % d] = nodes[i % d][i % len(nodes[i % d])]
    return pts


def _host_f64(x) -> np.ndarray:
    # Not torch.as_tensor: a list of Python floats would become float32.
    if isinstance(x, torch.Tensor):
        return x.detach().double().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def dev(a, ref) -> float:
    a, ref = _host_f64(a), _host_f64(ref)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def checked(out, shape, what):
    check(tuple(out.shape) == tuple(shape),
          f"{what}: shape {tuple(out.shape)} != {tuple(shape)}")
    check(bool(torch.isfinite(out).all()), f"{what}: non-finite values")
    return out


def random_operands(shape, rng):
    """(tensor, nodes, weights, diffs) of a random tensor on a [-1, 1]
    Chebyshev grid, on the card, and the host nodes."""
    grid = [nodes_for_dim_np(-1.0, 1.0, n) for n in shape]
    wts = [barycentric_weights_np(x) for x in grid]
    dmats = [differentiation_matrix_np(x, w) for x, w in zip(grid, wts)]

    def on_card(arrays):
        return tuple(torch.tensor(a, device=DEVICE) for a in arrays)

    return (torch.tensor(rng.standard_normal(shape), device=DEVICE),
            on_card(grid), on_card(wts), on_card(dmats)), grid


def bound(shape, n, itemsize, peak, passes=1):
    """(ms, what bounds it): the contraction's 2*prod(shape) FLOP per
    point, ``passes`` times, over ``peak``, or the bytes moved (points
    in, values out, the tensor once) over the memory rate, whichever is
    larger."""
    nodes = int(np.prod(shape))
    flop_ms = passes * 2.0 * nodes * n / peak * 1e3
    byte_ms = itemsize * (n * (len(shape) + 1) + nodes) \
        / HBM_BYTES_PER_S * 1e3
    return max(flop_ms, byte_ms), ("operations" if flop_ms >= byte_ms
                                   else "bytes")


def build_report(lib) -> str:
    """Registers and spills of each kernel instance from the build's
    ``ptxas -v`` report, and the tensor-core instructions in its SASS
    where ``cuobjdump`` exists.  Fails on a spill or a missing MMA."""
    instances = {"fused_eval_kernelIfE": ("f32", "HMMA"),
                 "fused_eval_kernelIdE": ("f64", "DMMA")}
    regs, spills, func = {}, {}, None
    for line in _build.build_log(lib._name).read_text().splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\S+?)'?"
                      r"(?: for|$)", line)
        if m:
            func = next((v[0] for k, v in instances.items()
                         if k in m.group(1)), None)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and func:
            spills[func] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and func:
            regs[func] = int(m.group(1))
    parts = []
    for name, mma in instances.values():
        check(name in regs and name in spills,
              f"no ptxas report of the {name} instance")
        check(spills[name] == 0, f"{name} instance spills "
                                 f"{spills[name]} bytes")
        dtype = torch.float32 if name == "f32" else torch.float64
        parts.append(f"{name}: {regs[name]} registers, 0 spills, "
                     f"{fused_eval._smem_bytes((11,) * 5, dtype):,} / "
                     f"{fused_eval._smem_bytes((19,) * 5, dtype):,} bytes "
                     f"of dynamic shared memory at 11^5 / 19^5")
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(_build.find_nvcc()).parent / "cuobjdump")
    if not Path(cuobjdump).is_file():
        return "; ".join(parts) + "; cuobjdump not found, SASS not read"
    sass = subprocess.run([cuobjdump, "-sass", lib._name],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, func = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = next((v for k, v in instances.items()
                         if k in m.group(1)), None)
        elif func and re.search(rf"\b{func[1]}\.", line):
            counts[func] = counts.get(func, 0) + 1
    for name, mma in instances.values():
        n = counts.get((name, mma), 0)
        check(n > 0, f"no {mma} instruction in the {name} instance's SASS")
        parts.append(f"{mma} in {name}: {n}")
    return "; ".join(parts)


def cuda_ms(fn, reps=15, warmup=3) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event timings."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def host_us(fn, calls=300) -> float:
    """Microseconds per call of a host function (after 10 warm calls)."""
    for _ in range(10):
        fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def device_busy_ms(fn) -> float:
    """Milliseconds the card's kernels ran during one call of ``fn``
    (the sum of the kernel durations ``torch.profiler`` records)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / 1e3


def spline_and_slider(card: str, ms: dict):
    """Phases 21-24: the spline and slider families on the card.  Adds
    their times to ``ms`` and returns K3's launches under the dd spline
    route (phase 23's main-path run), config 3's spline and config 4's
    slider."""
    # 21. Spline, configuration 3: the special_points dispatch, the
    # error against the function, the class path, the engines, the
    # report, the host path and the knot guard.
    t0 = time.perf_counter()
    via = ChebyshevApproximation(payoff_np, 2, SPLINE_DOMAIN,
                                 [[17, 17], [17]],
                                 special_points=[[1.0], []],
                                 vectorized=True, device=DEVICE)
    check(type(via) is ChebyshevSpline, f"special_points dispatch gave "
                                        f"{type(via).__name__}")
    via.build(verbose=False)
    spline = ChebyshevSpline(payoff_np, 2, SPLINE_DOMAIN, [17, 17],
                             [[1.0], []], vectorized=True, device=DEVICE)
    spline.build(verbose=False)
    torch.cuda.synchronize()
    spline_build = time.perf_counter() - t0
    plain = ChebyshevApproximation(payoff_np, 2, SPLINE_DOMAIN, [17, 17],
                                   vectorized=True, device=DEVICE)
    plain.build(verbose=False)
    err_pts = sample_points(4000, 0, [(0.0 + 0.002, 2.0 - 0.002),
                                      (0.0 + 0.001, 1.0 - 0.001)])
    exact = payoff_np(err_pts)
    err_spline = float(np.abs(spline.eval_batch(err_pts, [0, 0])
                              - exact).max())
    err_plain = float(np.abs(plain.vectorized_eval_batch(err_pts, [0, 0])
                             - exact).max())
    d_via = dev(via.eval_batch(err_pts, [0, 0]),
                spline.eval_batch(err_pts, [0, 0]))
    check(err_spline <= 1e-12 and err_spline * 1e6 <= err_plain,
          f"spline error {err_spline:.3e} not far below the global grid's "
          f"{err_plain:.3e}")
    check(d_via <= F64_CEILING, f"dispatched vs direct spline {d_via:.3e}")
    sp_pts64 = torch.tensor(sample_points(N, SEED + 60, SPLINE_DOMAIN),
                            device=DEVICE)
    sp_f64 = checked(spline.eval_batch_device(sp_pts64, [0, 0]), (N,),
                     "spline eval_batch_device")
    sp_engines = {tier: BatchedEvaluator(spline, dtype=dtype, device=DEVICE)
                  for tier, dtype in (("f32", torch.float32),
                                      ("f64", torch.float64), ("dd", "dd"))}
    sp_reports = {tier: MultiSpecEvaluator(spline, SPLINE_SPECS,
                                           dtype=dtype, device=DEVICE)
                  for tier, dtype in (("f32", torch.float32),
                                      ("f64", torch.float64), ("dd", "dd"))}
    report_ref = torch.tensor(spline.vectorized_eval_batch_multi(
        sp_pts64, SPLINE_SPECS), device=DEVICE)
    sp_dev = {}
    for tier in ("f32", "f64", "dd"):
        sp_engines[tier].warmup()
        sp_reports[tier].warmup()
        v = checked(sp_engines[tier](sp_pts64), (N,), f"spline {tier} engine")
        r = checked(sp_reports[tier](sp_pts64), (N, len(SPLINE_SPECS)),
                    f"spline {tier} report")
        sp_dev[f"{tier} engine"] = dev(v, sp_f64)
        sp_dev[f"{tier} report"] = dev(r, report_ref)
        ceiling = F32_CEILING if tier == "f32" else F64_CEILING
        check(sp_dev[f"{tier} engine"] <= ceiling
              and sp_dev[f"{tier} report"] <= ceiling,
              f"spline {tier}: engine {sp_dev[f'{tier} engine']:.3e}, "
              f"report {sp_dev[f'{tier} report']:.3e} > {ceiling:g}")
    host_pts = sp_pts64[:256].cpu().numpy()
    sp_host = np.array([spline.eval(p, [0, 0]) for p in host_pts])
    d_host = dev(sp_f64[:256], sp_host)
    check(d_host <= F64_CEILING, f"spline host path {d_host:.3e}")
    us_spline = host_us(lambda: spline.eval(host_pts[0], [0, 0]))
    on_knot = sample_points(1000, SEED + 61, SPLINE_DOMAIN)
    on_knot[500, 0] = 1.0
    refused = []
    for engine in (BatchedEvaluator(spline, dtype=torch.float32,
                                    derivative_order=[1, 0], device=DEVICE),
                   sp_reports["dd"]):
        try:
            engine(on_knot)
        except ValueError as err:
            refused.append("not defined at knot" in str(err))
    check(refused == [True, True], "a derivative request on the knot was "
                                   "not refused")
    sp_runs = {
        "spline class path f64 (eval_batch_device)":
            lambda: spline.eval_batch_device(sp_pts64, [0, 0]),
        "spline engine f32 (BatchedEvaluator)":
            lambda: sp_engines["f32"](sp_pts64),
        "spline engine f64": lambda: sp_engines["f64"](sp_pts64),
        "spline engine dd": lambda: sp_engines["dd"](sp_pts64),
        "spline report f32, 4 specs (MultiSpecEvaluator)":
            lambda: sp_reports["f32"](sp_pts64),
        "spline report f64, 4 specs": lambda: sp_reports["f64"](sp_pts64),
        "spline report dd, 4 specs": lambda: sp_reports["dd"](sp_pts64),
    }
    for name, fn in sp_runs.items():
        ms[name] = cuda_ms(fn)
    print(f"[21 spline, config 3] dispatch -> ChebyshevSpline, 2 pieces of "
          f"17^2 built in {spline_build:.3f} s; max abs error on 4,000 "
          f"points: spline {err_spline:.3e}, global 17^2 grid "
          f"{err_plain:.3e}; dispatched vs direct {d_via:.3e}; at N=2^20 "
          f"vs the class path: "
          + ", ".join(f"{k} {v:.3e}" for k, v in sp_dev.items())
          + f"; host path on 256 points {d_host:.3e} ({us_spline:.1f} us a "
          f"point); derivative requests on the knot refused; times: "
          + "; ".join(f"{k} {ms[k]:.4f} ms" for k in sp_runs)
          + f" | {card}", flush=True)

    # 22. The masked-against-routed sweep: P pieces of 12^2 nodes, one
    # knot grid along dim 0, at N = 2^20, routing included in both.
    sweep_pts = torch.tensor(np.random.default_rng(3).uniform(
        -0.999, 0.999, size=(N, 2)), device=DEVICE)
    sweep = []
    for n_pieces in SWEEP_PIECES:
        knots = [list(np.linspace(-1.0, 1.0, n_pieces + 1)[1:-1]), []]
        spl = ChebyshevSpline(
            lambda p, _: np.abs(np.sin(3 * p[:, 0])) + p[:, 1] ** 2, 2,
            [[-1, 1], [-1, 1]], [12, 12], knots, vectorized=True,
            device=DEVICE)
        spl.build(verbose=False)
        strides = spline_eval.piece_strides([len(k) for k in knots])
        row = {"pieces": n_pieces}
        outs = {}
        for label, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            stacked = spline_eval.stack_pieces(spl._pieces, dtype)
            arrays = [tuple(a.to(dtype) if isinstance(a, torch.Tensor)
                            else tuple(x.to(dtype) for x in a)
                            for a in (p.tensor_values,) + p._grid_tuples())
                      for p in spl._pieces]

            def masked(stacked=stacked):
                flat = spline_eval.route_piece_indices(knots, strides,
                                                       sweep_pts)
                return spline_eval.masked_eval_batch(*stacked, flat,
                                                     sweep_pts, (0, 0))

            def routed(arrays=arrays):
                flat = spline_eval.route_piece_indices(knots, strides,
                                                       sweep_pts)
                return spline_eval.routed_eval_batch(arrays, flat,
                                                     sweep_pts, (0, 0))

            outs[label] = (masked(), routed())
            row[f"masked_{label}_ms"] = cuda_ms(masked)
            row[f"routed_{label}_ms"] = cuda_ms(routed)
        d_routes = dev(outs["f64"][0], outs["f64"][1])
        d_f32 = max(dev(o, outs["f64"][0]) for o in outs["f32"])
        check(d_routes <= F64_CEILING and d_f32 <= F32_CEILING,
              f"P={n_pieces}: masked vs routed {d_routes:.3e}, f32 vs f64 "
              f"{d_f32:.3e}")
        sweep.append(row)
        print(f"[22 sweep] P={n_pieces}: masked f32 "
              f"{row['masked_f32_ms']:.4f} ms, routed f32 "
              f"{row['routed_f32_ms']:.4f} ms, masked f64 "
              f"{row['masked_f64_ms']:.4f} ms, routed f64 "
              f"{row['routed_f64_ms']:.4f} ms; masked vs routed (f64) "
              f"{d_routes:.3e}, f32 vs f64 {d_f32:.3e} | {card}", flush=True)
    crossover = {
        label: max([r["pieces"] for r in sweep
                    if r[f"masked_{label}_ms"] <= r[f"routed_{label}_ms"]],
                   default=1)
        for label in ("f32", "f64")}
    print(f"[22 sweep] largest P at which the masked route is as fast: f32 "
          f"{crossover['f32']}, f64 {crossover['f64']}; the port's constants: "
          f"MASKED_MAX_PIECES={spline_eval.MASKED_MAX_PIECES} (f32 engines; "
          f"f64 always routes)", flush=True)

    # 23. K3 under a spline: a 3-D flat spline, 2 pieces of 11^3, at
    # dtype="dd"; its main-path run with the K3 count from zero.
    spline3 = ChebyshevSpline(
        lambda p, _: (np.abs(p[:, 0]) * np.cos(p[:, 1])
                      + p[:, 2] ** 2 * p[:, 1]),
        3, [[-1, 1]] * 3, [11, 11, 11], [[0.0], [], []], vectorized=True,
        device=DEVICE)
    spline3.build(verbose=False)
    pts3 = torch.tensor(sample_points(N, SEED + 62, [(-1.0, 1.0)] * 3),
                        device=DEVICE)
    dd3 = BatchedEvaluator(spline3, dtype="dd", device=DEVICE)
    dd3_report = MultiSpecEvaluator(spline3, [(0, 0, 0), (0, 1, 0)],
                                    dtype="dd", device=DEVICE)
    fused_dd.launches = 0
    v3 = checked(dd3(pts3), (N,), "3-D spline dd engine")
    r3 = checked(dd3_report(pts3), (N, 2), "3-D spline dd report")
    c3 = checked(spline3.eval_batch_dd(pts3, [0, 0, 0]), (N,),
                 "3-D spline eval_batch_dd")
    torch.cuda.synchronize()
    k3_spline_launches = fused_dd.launches
    check(k3_spline_launches > 0, "the dd spline route never launched K3")
    f64_3 = spline3.eval_batch_device(pts3, [0, 0, 0])
    d3 = {"dd engine": dev(v3, f64_3),
          "dd report": dev(r3, torch.stack(
              [f64_3, spline3.eval_batch_device(pts3, [0, 1, 0])], dim=1)),
          "eval_batch_dd": dev(c3, f64_3)}
    check(max(d3.values()) <= K3_VS_PLAIN,
          f"dd spline vs plain f64: {d3}")
    k3_piece_worst = 0.0
    flat3 = spline_eval.route_piece_indices(
        spline3.knots, spline_eval.piece_strides([1, 0, 0]), pts3)
    for i, piece in enumerate(spline3._pieces):
        sub = pts3[flat3 == i]
        operands = (piece.tensor_values,) + piece._grid_tuples()
        got = fused_dd.fused_eval_batch_dd(*operands, sub, (0, 0, 0))
        k3_piece_worst = max(k3_piece_worst, dev(
            got, fused_dd.fused_eval_batch_dd_reference(*operands, sub,
                                                        (0, 0, 0))))
    check(k3_piece_worst <= K3_VS_PLAIN, f"K3 on a spline piece vs plain "
                                         f"{k3_piece_worst:.3e}")
    f64_3_engine = BatchedEvaluator(spline3, dtype=torch.float64,
                                    device=DEVICE)
    ms["3-D spline engine dd (K3 route)"] = cuda_ms(lambda: dd3(pts3))
    ms["3-D spline engine f64 (plain)"] = cuda_ms(lambda: f64_3_engine(pts3))
    print(f"[23 K3 under a spline] 3-D spline, 2 pieces of 11^3, at "
          f"N=2^20: K3 launches {k3_spline_launches} (engine, 2-spec report "
          f"and eval_batch_dd); vs the plain f64 path: "
          + ", ".join(f"{k} {v:.3e}" for k, v in d3.items())
          + f"; K3 vs plain on each piece's points {k3_piece_worst:.3e}; all "
          f"<= {K3_VS_PLAIN:g}; dd engine "
          f"{ms['3-D spline engine dd (K3 route)']:.4f} ms, f64 engine "
          f"{ms['3-D spline engine f64 (plain)']:.4f} ms | {card}",
          flush=True)

    # 24. Slider, configuration 4: the 10-D basket, its engines, the dd
    # Greek report and to_tt.
    t0 = time.perf_counter()
    slider = ChebyshevSlider(basket_np, SLIDER_D, [[-1.0, 1.0]] * SLIDER_D,
                             [9] * SLIDER_D, [[i] for i in range(SLIDER_D)],
                             [0.0] * SLIDER_D, vectorized=True,
                             device=DEVICE)
    slider.build(verbose=False)
    torch.cuda.synchronize()
    slider_build = time.perf_counter() - t0
    sl_err_pts = np.random.default_rng(0).uniform(-1, 1, (5000, SLIDER_D))
    sl_err = float(np.abs(slider.eval_batch(sl_err_pts)
                          - basket_np(sl_err_pts)).max())
    check(sl_err <= SLIDER_VS_FUNCTION, f"slider vs the basket {sl_err:.3e}")
    sl_pts64 = torch.tensor(np.random.default_rng(5).uniform(
        -1, 1, (N, SLIDER_D)), device=DEVICE)
    sl_f64 = checked(slider.eval_batch_device(sl_pts64), (N,),
                     "slider eval_batch_device")
    additive = additive_interpolant_np(sl_pts64[:5000].cpu().numpy(), 9)
    d_additive = dev(sl_f64[:5000], additive)
    check(d_additive <= F64_CEILING,
          f"slider vs the host additive interpolant {d_additive:.3e}")
    sl_engines = {tier: BatchedEvaluator(slider, dtype=dtype, device=DEVICE)
                  for tier, dtype in (("f32", torch.float32),
                                      ("f64", torch.float64), ("dd", "dd"))}
    sl_dev = {}
    for tier, engine in sl_engines.items():
        engine.warmup()
        sl_dev[tier] = dev(checked(engine(sl_pts64), (N,),
                                   f"slider {tier} engine"), sl_f64)
        check(sl_dev[tier] <= (F32_CEILING if tier == "f32"
                               else F64_CEILING),
              f"slider {tier} engine {sl_dev[tier]:.3e}")
    greek_pts = sl_pts64[:1 << 18]
    greek_dd = MultiSpecEvaluator(slider, SLIDER_GREEKS, dtype="dd",
                                  device=DEVICE)
    greek_dd.warmup()
    g_dd = checked(greek_dd(greek_pts), (1 << 18, len(SLIDER_GREEKS)),
                   "slider dd Greek report")
    g_ref = torch.tensor(slider.vectorized_eval_batch_multi(
        greek_pts, SLIDER_GREEKS), device=DEVICE)
    d_greeks = dev(g_dd, g_ref)
    check(d_greeks <= DD_CEILING, f"slider dd Greeks vs f64 {d_greeks:.3e}")
    greek_f64 = MultiSpecEvaluator(slider, SLIDER_GREEKS,
                                   dtype=torch.float64, device=DEVICE)
    greek_f64.warmup()
    d_greeks_f64 = dev(checked(greek_f64(greek_pts),
                               (1 << 18, len(SLIDER_GREEKS)),
                               "slider f64 Greek report"), g_ref)
    check(d_greeks_f64 <= F64_CEILING,
          f"slider f64 Greeks vs the class path {d_greeks_f64:.3e}")
    t0 = time.perf_counter()
    sl_tt = slider.to_tt()
    to_tt_sl = time.perf_counter() - t0
    check(sl_tt.tt_ranks == [1] + [2] * (SLIDER_D - 1) + [1],
          f"slider to_tt ranks {sl_tt.tt_ranks}")
    tt_engine = BatchedEvaluator(sl_tt, dtype=torch.float64, device=DEVICE)
    d_tt = dev(checked(tt_engine(sl_pts64), (N,), "slider to_tt engine"),
               sl_f64)
    check(d_tt <= F64_CEILING, f"slider to_tt engine vs slider {d_tt:.3e}")
    sl_runs = {
        "slider engine f32 (BatchedEvaluator)":
            lambda: sl_engines["f32"](sl_pts64),
        "slider engine f64": lambda: sl_engines["f64"](sl_pts64),
        "slider engine dd": lambda: sl_engines["dd"](sl_pts64),
        "slider dd Greek report, 5 specs, 2^18 points":
            lambda: greek_dd(greek_pts),
        "slider f64 Greek report, 5 specs, 2^18 points":
            lambda: greek_f64(greek_pts),
        "slider to_tt engine f64": lambda: tt_engine(sl_pts64),
    }
    for name, fn in sl_runs.items():
        ms[name] = cuda_ms(fn)
    print(f"[24 slider, config 4] 10 slides of 9 nodes built in "
          f"{slider_build:.3f} s ({slider.total_build_evals} evaluations); "
          f"max abs error vs the basket on 5,000 points {sl_err:.3e} <= "
          f"{SLIDER_VS_FUNCTION:g} (9 nodes a dim); vs the additive "
          f"interpolant computed on the host {d_additive:.3e}; engines vs "
          f"the class path at N=2^20: "
          + ", ".join(f"{k} {v:.3e}" for k, v in sl_dev.items())
          + f"; dd Greek report (value + d0, d2, d4, d6) at 2^18 vs f64 "
          f"{d_greeks:.3e} <= {DD_CEILING:g}, the f64 engine's "
          f"{d_greeks_f64:.3e}; to_tt ({to_tt_sl:.3f} s, ranks "
          f"{sl_tt.tt_ranks}) through the TT engine {d_tt:.3e}; times: "
          + "; ".join(f"{k} {ms[k]:.4f} ms" for k in sl_runs)
          + f" | {card}", flush=True)
    return k3_spline_launches, spline, slider


def random_boxes(n, seed, domain):
    """(n, d, 2) boxes drawn as ``bench.py:469-474`` draws them: lo
    uniform in the domain, hi uniform in [lo, the domain's top]."""
    rng = np.random.default_rng(seed)
    dom = np.asarray(domain, dtype=np.float64)
    lo = rng.uniform(dom[:, 0], dom[:, 1], (n, len(domain)))
    hi = rng.uniform(lo, dom[None, :, 1])
    return np.stack([lo, hi], axis=-1)


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


def calculus(card: str, ms: dict, cheb, tt, comp, spline, slider) -> None:
    """Phases 25-31: calculus and scenario batches (plain PyTorch, no
    kernel) on bench.py's models, uncut: box integrals and conditional
    expectations of the 11^5 interpolant, the six-model book, the TT
    family, config 3's spline and config 4's slider, and roots and 1-D
    optima over scenario batches.  Adds their times to ``ms``."""
    host_t = cheb.tensor_values.cpu().numpy()
    host_nodes = cheb._nodes_np()

    def dense_box_np(box):
        return contract_np(host_t, [quad_row_np(11, *DOMAIN[d], *box[d])
                                    for d in range(5)])

    # 25. Dense box integrals at f64, f32 and dd on 2^17 boxes.
    boxes = random_boxes(NB, 21, DOMAIN)
    boxes[:64:8, 2, 1] = boxes[:64:8, 2, 0]        # zero measure in T
    ib = {tier: checked(torch.from_numpy(cheb.integrate_batch(
        boxes, dtype=dtype)), (NB,), f"integrate_batch {tier}")
        for tier, dtype in (("f64", None), ("f32", torch.float32),
                            ("dd", "dd"))}
    ref = np.array([dense_box_np(b) for b in boxes[:64]])
    d_ib = {"f64 vs host": dev(ib["f64"][:64], ref),
            "f32 vs f64": dev(ib["f32"], ib["f64"]),
            "dd vs f64": dev(ib["dd"], ib["f64"])}
    check(d_ib["f64 vs host"] <= F64_CEILING
          and d_ib["dd vs f64"] <= DD_CEILING
          and d_ib["f32 vs f64"] <= F32_CEILING,
          f"dense box integrals: {d_ib}")
    zeros = {t: ib[t][:64:8] for t in ib}
    check(all(bool((z == 0).all()) for z in zeros.values()),
          f"zero-measure boxes did not integrate to 0: {zeros}")
    full = cheb.integrate()
    full_ref = contract_np(host_t, [fejer1_weights(11) * (c - a) / 2
                                    for a, c in DOMAIN])
    part = cheb.integrate(dims=[0])
    part_pt = sample_points(1, SEED + 70)[0]
    part_ref = contract_np(host_t, [fejer1_weights(11) * 20.0] + [
        bary_row_np(part_pt[d], host_nodes[d]) for d in range(1, 5)])
    d_full = abs(full - full_ref) / abs(full_ref)
    d_part = abs(part.eval(part_pt[1:], [0] * 4) - part_ref) / abs(part_ref)
    check(d_full <= F64_CEILING and d_part <= F64_CEILING,
          f"integrate(): full {d_full:.3e}, partial {d_part:.3e}")
    runs = {
        "dense integrate_batch f64, 2^17 boxes":
            lambda: cheb.integrate_batch(boxes),
        "dense integrate_batch f32, 2^17 boxes":
            lambda: cheb.integrate_batch(boxes, dtype=torch.float32),
        "dense integrate_batch dd, 2^17 boxes":
            lambda: cheb.integrate_batch(boxes, dtype="dd"),
        "dense integrate() full": lambda: cheb.integrate(),
        "dense integrate(dims=[0]) partial":
            lambda: cheb.integrate(dims=[0]),
    }
    for name, fn in runs.items():
        ms[name] = cuda_ms(fn)
    # Where the f64 call's time goes: the host validation of the bounds,
    # the device path on bounds already on the card, and the share of
    # the call the card's kernels were running.
    validate_ms = host_us(lambda: normalize_bounds_batch(boxes, DOMAIN),
                          calls=10) / 1e3
    boxes_dev = torch.tensor(boxes, device=DEVICE)
    dom_np = np.asarray(DOMAIN)
    ms["dense integrate_box_batch f64 (ops, bounds on the card)"] = cuda_ms(
        lambda: integrate_ops.integrate_box_batch(cheb.tensor_values,
                                                  dom_np, boxes_dev))
    busy = device_busy_ms(lambda: cheb.integrate_batch(boxes))
    ops_ms = ms["dense integrate_box_batch f64 (ops, bounds on the card)"]
    call_ms = ms["dense integrate_batch f64, 2^17 boxes"]
    split = (f"host validation {validate_ms:.4f} ms, ops path on the card "
             f"{ops_ms:.4f} ms, kernels busy {busy:.4f} ms = "
             f"{100.0 * busy / call_ms:.1f}% of the f64 call")
    print(f"[25 dense box integrals] 11^5 at 2^17 boxes (seed 21, 8 of "
          f"them zero-measure in T): "
          + ", ".join(f"{k} {v:.3e}" for k, v in d_ib.items())
          + f" (host on 64 boxes; f64 <= {F64_CEILING:g}, dd <= "
          f"{DD_CEILING:g}, f32 <= {F32_CEILING:g}); zero-measure boxes "
          f"exactly 0 at every tier; integrate() {full:.12g} vs host "
          f"{d_full:.3e}, integrate(dims=[0]) at a point {d_part:.3e}; "
          + "; ".join(f"{k} {ms[k]:.4f} ms"
                      + (f" = {NB / ms[k] * 1e3:,.0f} boxes/s"
                         if "2^17" in k else "") for k in runs)
          + f"; {split} | {card}", flush=True)

    # 26. Conditional expectations over dims (0, 2), 3 coordinates.
    cond_pts = np.random.default_rng(22).uniform(
        dom_np[[1, 3, 4], 0], dom_np[[1, 3, 4], 1], (NB, 3))
    sub = np.ascontiguousarray(boxes[:, [0, 2], :])
    ce = {tier: checked(torch.from_numpy(cheb.partial_integrate_batch(
        [0, 2], sub, cond_pts, dtype=dtype)), (NB,), f"conditional {tier}")
        for tier, dtype in (("f64", None), ("dd", "dd"))}

    def cond_np(i):
        rows = [quad_row_np(11, *DOMAIN[0], *sub[i, 0]),
                bary_row_np(cond_pts[i, 0], host_nodes[1]),
                quad_row_np(11, *DOMAIN[2], *sub[i, 1]),
                bary_row_np(cond_pts[i, 1], host_nodes[3]),
                bary_row_np(cond_pts[i, 2], host_nodes[4])]
        return contract_np(host_t, rows)

    d_ce = {"f64 vs host": dev(ce["f64"][:64],
                               np.array([cond_np(i) for i in range(64)])),
            "dd vs f64": dev(ce["dd"], ce["f64"])}
    check(d_ce["f64 vs host"] <= F64_CEILING
          and d_ce["dd vs f64"] <= DD_CEILING,
          f"conditional expectations: {d_ce}")
    check(bool((ce["f64"][:64:8] == 0).all() and (ce["dd"][:64:8] == 0)
               .all()), "zero-measure conditional boxes did not read 0")
    runs = {
        f"dense partial_integrate_batch {t}, dims (0, 2), 2^17 scenarios":
            (lambda t=t: cheb.partial_integrate_batch(
                [0, 2], sub, cond_pts, dtype=None if t == "f64" else t))
        for t in ("f64", "dd")}
    for name, fn in runs.items():
        ms[name] = cuda_ms(fn)
    print(f"[26 conditional expectations] integrate S and T, evaluate at "
          f"(K, sigma, r): " + ", ".join(f"{k} {v:.3e}"
                                         for k, v in d_ce.items())
          + "; zero-measure boxes exactly 0; "
          + "; ".join(f"{k} {ms[k]:.4f} ms = {NB / ms[k] * 1e3:,.0f} "
                      f"scenarios/s" for k in runs) + f" | {card}",
          flush=True)

    # 27. The six-model book: price plus five differentiate()d Greeks.
    book = [cheb] + [cheb.differentiate(list(g)) for g in GREEKS[1:]]
    d_book = {}
    for tier, dtype in (("f64", None), ("f32", torch.float32),
                        ("dd", "dd")):
        out = checked(torch.from_numpy(integrate_book(book, boxes,
                                                      dtype=dtype)),
                      (len(book), NB), f"integrate_book {tier}")
        d_book[tier] = max(
            dev(out[k], m.integrate_batch(boxes, dtype=dtype))
            for k, m in enumerate(book))
        check(d_book[tier] <= (F32_CEILING if tier == "f32"
                               else F64_CEILING),
              f"integrate_book {tier} vs integrate_batch {d_book[tier]:.3e}")
        name = f"integrate_book {tier}, 6 models, 2^17 boxes"
        ms[name] = cuda_ms(lambda dtype=dtype: integrate_book(
            book, boxes, dtype=dtype))
    print(f"[27 book integrals] price + 5 Greeks, each row vs its model's "
          f"integrate_batch: " + ", ".join(f"{k} {v:.3e}"
                                           for k, v in d_book.items())
          + "; " + "; ".join(
              f"{k} {ms[k]:.4f} ms = {6 * NB / ms[k] * 1e3:,.0f} box "
              f"integrals/s" for k in ms if k.startswith("integrate_book"))
          + f" | {card}", flush=True)

    # 28. The TT family: the rank-15 cross at f64 and f32, to_tt(1e-13)
    # at dd against the dense f64 integrals, and to_slider.
    tt_boxes = random_boxes(NB, 23, TT_DOMAIN)
    tt_boxes[:64:8, 1, 1] = tt_boxes[:64:8, 1, 0]
    tt_ib = {tier: checked(torch.from_numpy(tt.integrate_batch(
        tt_boxes, dtype=dtype)), (NB,), f"TT integrate_batch {tier}")
        for tier, dtype in (("f64", None), ("f32", torch.float32))}
    tt_host = np.array([tt.integrate(bounds=[tuple(b) for b in box])
                        for box in tt_boxes[:64]])
    comp_ib = checked(torch.from_numpy(comp.integrate_batch(
        boxes, dtype="dd")), (NB,), "to_tt integrate_batch dd")
    d_tt = {"rank-15 f64 vs host integrate(bounds)":
            dev(tt_ib["f64"][:64], tt_host),
            "rank-15 f32 vs f64": dev(tt_ib["f32"], tt_ib["f64"]),
            "to_tt dd vs dense f64": dev(comp_ib, ib["f64"])}
    check(d_tt["rank-15 f64 vs host integrate(bounds)"] <= F64_CEILING
          and d_tt["rank-15 f32 vs f64"] <= F32_CEILING
          and d_tt["to_tt dd vs dense f64"] <= F64_CEILING,
          f"TT box integrals: {d_tt}")
    check(bool((tt_ib["f64"][:64:8] == 0).all()
               and (tt_ib["f32"][:64:8] == 0).all()
               and (comp_ib[:64:8] == 0).all()),
          "zero-measure TT boxes did not read 0")
    centre = [0.5 * (a + c) for a, c in TT_DOMAIN]
    t0 = time.perf_counter()
    tt_slider = tt.to_slider([[d] for d in range(5)], centre)
    to_slider_s = time.perf_counter() - t0
    d_pivot = abs(tt_slider.eval(centre, [0] * 5) - tt.eval(centre)) / abs(
        tt.eval(centre))
    lines = np.tile(np.asarray(centre), (64, 1))
    lines[np.arange(64), np.arange(64) % 5] = sample_points(
        64, SEED + 71, TT_DOMAIN)[np.arange(64), np.arange(64) % 5]
    d_lines = dev(tt_slider.eval_batch(lines), tt.eval_batch(lines))
    check(d_pivot <= F64_CEILING and d_lines <= F64_CEILING,
          f"to_slider at the pivot {d_pivot:.3e}, along its lines "
          f"{d_lines:.3e}")
    runs = {
        "TT rank-15 integrate_batch f64, 2^17 boxes":
            lambda: tt.integrate_batch(tt_boxes),
        "TT rank-15 integrate_batch f32, 2^17 boxes":
            lambda: tt.integrate_batch(tt_boxes, dtype=torch.float32),
        "to_tt integrate_batch dd, 2^17 boxes":
            lambda: comp.integrate_batch(boxes, dtype="dd"),
    }
    for name, fn in runs.items():
        ms[name] = cuda_ms(fn)
    busy_tt = device_busy_ms(lambda: tt.integrate_batch(tt_boxes))
    print(f"[28 TT integrals] " + ", ".join(f"{k} {v:.3e}"
                                            for k, v in d_tt.items())
          + f"; zero-measure boxes exactly 0; to_slider (singleton "
          f"partition, pivot at the centre) in {to_slider_s:.3f} s: at "
          f"the pivot {d_pivot:.3e}, on 64 points of the lines through "
          f"it {d_lines:.3e}; "
          + "; ".join(f"{k} {ms[k]:.4f} ms = {NB / ms[k] * 1e3:,.0f} "
                      f"boxes/s" for k in runs)
          + f"; kernels busy {busy_tt:.4f} ms of the rank-15 f64 call"
          + f" | {card}", flush=True)

    # 29. Config 3's spline against its closed form, boxes that straddle
    # the knot.
    rng = np.random.default_rng(24)
    sp_boxes = np.stack([
        np.stack([rng.uniform(0.0, 1.0, NB), rng.uniform(1.0, 2.0, NB)], -1),
        np.sort(rng.uniform(0.0, 1.0, (NB, 2)), axis=1)], axis=1)
    sp_boxes[:64:8, 1, 1] = sp_boxes[:64:8, 1, 0]

    def payoff_box(b):
        x0 = np.maximum(b[:, 0], 1.0) - 1.0
        return (0.5 * (x0[:, 1] ** 2 - x0[:, 0] ** 2)
                * (np.exp(-0.1 * b[:, 1, 0]) - np.exp(-0.1 * b[:, 1, 1]))
                / 0.1)

    sp_total = spline.integrate()
    closed = 0.5 * (1.0 - np.exp(-0.1)) / 0.1
    d_sp_total = abs(sp_total - closed) / closed
    sp_ib = checked(torch.from_numpy(spline.integrate_batch(sp_boxes)),
                    (NB,), "spline integrate_batch")
    d_sp = dev(sp_ib, payoff_box(sp_boxes))
    check(d_sp_total <= F64_CEILING and d_sp <= F64_CEILING
          and bool((sp_ib[:64:8] == 0).all()),
          f"spline integrals: integrate() {d_sp_total:.3e}, boxes {d_sp:.3e}")
    sp_ms = ms["spline integrate_batch f64, 2^17 boxes"] = cuda_ms(
        lambda: spline.integrate_batch(sp_boxes))
    ms["spline integrate() full"] = cuda_ms(lambda: spline.integrate())
    print(f"[29 spline integrals, config 3] integrate() {sp_total:.15g} vs "
          f"0.5(1 - e^-0.1)/0.1 {d_sp_total:.3e}; 2^17 boxes straddling "
          f"the knot vs max(x0 - 1, 0) e^(-0.1 x1) integrated in closed "
          f"form {d_sp:.3e}; zero-measure boxes exactly 0; "
          f"integrate_batch {sp_ms:.4f} ms = {NB / sp_ms * 1e3:,.0f} "
          f"boxes/s; integrate() {ms['spline integrate() full']:.4f} ms"
          f" | {card}", flush=True)

    # 30. Config 4's slider against its slides' additive interpolant
    # integrated per box on the host.
    sl_boxes = random_boxes(NB, 25, [[-1.0, 1.0]] * SLIDER_D)
    sl_boxes[:64:8, 3, 1] = sl_boxes[:64:8, 3, 0]
    sl_ib = checked(torch.from_numpy(slider.integrate_batch(sl_boxes)),
                    (NB,), "slider integrate_batch")
    x9 = nodes_for_dim_np(-1.0, 1.0, 9)
    slide_vals = []
    for d in range(SLIDER_D):
        grid = np.zeros((9, SLIDER_D))
        grid[:, d] = x9
        slide_vals.append(basket_np(grid))

    def slider_box_np(box):
        widths = box[:, 1] - box[:, 0]
        return sum(np.prod(np.delete(widths, d))
                   * quad_row_np(9, -1.0, 1.0, *box[d]) @ slide_vals[d]
                   for d in range(SLIDER_D))

    d_sl = dev(sl_ib[:64], np.array([slider_box_np(b)
                                     for b in sl_boxes[:64]]))
    check(d_sl <= F64_CEILING and bool((sl_ib[:64:8] == 0).all()),
          f"slider box integrals vs the host {d_sl:.3e}")
    sl_ms = ms["slider integrate_batch f64, 2^17 boxes"] = cuda_ms(
        lambda: slider.integrate_batch(sl_boxes))
    print(f"[30 slider integrals, config 4] 2^17 boxes vs the additive "
          f"interpolant integrated on the host (64 boxes) {d_sl:.3e}; "
          f"zero-measure boxes exactly 0; integrate_batch {sl_ms:.4f} ms = "
          f"{NB / sl_ms * 1e3:,.0f} boxes/s | {card}", flush=True)

    # 31. Scenario batches along S for 4,096 (K, T, sigma, r) scenarios:
    # breakevens where Delta = 0.5 and Gamma's extrema.
    delta = cheb.differentiate([1, 0, 0, 0, 0])
    delta_half = ChebyshevApproximation.from_values(
        delta.tensor_values.cpu().numpy() - 0.5, 5, DOMAIN, [11] * 5,
        device=DEVICE)
    gamma = cheb.differentiate([2, 0, 0, 0, 0])
    scen = sample_points(NS, SEED + 72)
    fixed = {d: scen[:, d] for d in range(1, 5)}
    roots = delta_half.roots_batch(dim=0, fixed=fixed)
    lo_g = gamma.minimize_batch(dim=0, fixed=fixed)
    hi_g = gamma.maximize_batch(dim=0, fixed=fixed)
    check(len(roots) == NS and all(r.shape[0] <= 10 for r in roots)
          and all(a.shape == (NS,) and np.isfinite(a).all()
                  for a in (*lo_g, *hi_g)), "scenario batch shapes")
    worst = {"roots": 0.0, "min location": 0.0, "max location": 0.0,
             "min value": 0.0, "max value": 0.0}
    for i in range(64):
        pin = {d: float(scen[i, d]) for d in range(1, 5)}
        single = delta_half.roots(dim=0, fixed=pin)
        check(single.shape == roots[i].shape,
              f"scenario {i}: {roots[i].size} batched roots against "
              f"{single.size}")
        if single.size:
            worst["roots"] = max(worst["roots"],
                                 float(np.abs(single - roots[i]).max()))
        for mode, batched in (("min", lo_g), ("max", hi_g)):
            val, loc = (gamma.minimize if mode == "min"
                        else gamma.maximize)(dim=0, fixed=pin)
            worst[f"{mode} location"] = max(worst[f"{mode} location"],
                                            abs(loc - batched[1][i]))
            worst[f"{mode} value"] = max(worst[f"{mode} value"],
                                         abs(val - batched[0][i]))
    g_scale = float(np.abs(hi_g[0]).max())
    check(worst["roots"] <= ROOTS_VS_SINGLE
          and worst["min location"] <= LOCATION_VS_SINGLE
          and worst["max location"] <= LOCATION_VS_SINGLE
          and worst["min value"] <= F64_CEILING * g_scale
          and worst["max value"] <= F64_CEILING * g_scale,
          f"scenario batches vs single calls: {worst}")
    n_roots = sum(r.size for r in roots)
    runs = {
        "roots_batch (Delta = 0.5 along S), 4,096 scenarios":
            lambda: delta_half.roots_batch(dim=0, fixed=fixed),
        "minimize_batch (Gamma along S), 4,096 scenarios":
            lambda: gamma.minimize_batch(dim=0, fixed=fixed),
        "maximize_batch (Gamma along S), 4,096 scenarios":
            lambda: gamma.maximize_batch(dim=0, fixed=fixed),
    }
    for name, fn in runs.items():
        ms[name] = cuda_ms(fn)
    cols = {d: np.ascontiguousarray(scen[:, d]) for d in range(1, 5)}
    resample_ms = ms["scenario resampling on the card (4,096 x 11, f64)"] = \
        cuda_ms(lambda: gamma._scenario_slice_values(0, cols, NS))
    single_ms = host_us(lambda: gamma.maximize(
        dim=0, fixed={d: float(scen[0, d]) for d in range(1, 5)}),
        calls=20) / 1e3
    print(f"[31 scenario batches] 11^5 along S: {n_roots} breakevens "
          f"(Delta = 0.5) over {NS:,} scenarios, Gamma min and max; "
          f"against single roots/minimize/maximize on 64 scenarios: "
          f"root counts equal, "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" (absolute on S: roots <= {ROOTS_VS_SINGLE:g}, locations <= "
          f"{LOCATION_VS_SINGLE:g}; values <= {F64_CEILING:g} of max Gamma "
          f"{g_scale:.4g}); "
          + "; ".join(f"{k} {ms[k]:.4f} ms = {NS / ms[k] * 1e3:,.0f} "
                      f"scenarios/s" for k in runs)
          + f"; of which the resampling on the card {resample_ms:.4f} ms; "
          f"one maximize() call {single_ms:.4f} ms | {card}",
          flush=True)


def fit_df0(p):
    """Its derivative along x0, the gradient-enhanced block's values."""
    return 2 * np.cos(2 * p[:, 0]) * np.cos(p[:, 1])


def host_gram(pts, counts, domain):
    """The f64 normal equations of the dense fit's design, on the host."""
    nodes = [nodes_for_dim_np(lo, hi, n) for (lo, hi), n in zip(domain,
                                                                 counts)]
    weights = [barycentric_weights_np(nd) for nd in nodes]
    design = fit_ops._DimDesign(nodes, weights)
    rows = fit_ops._khatri_rao([design.rows(pts[:, k], k)
                                for k in range(len(counts))])
    return rows.T @ rows, nodes, weights, design


def timed_s(fn):
    """(result, seconds) of one call of ``fn``, synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fitting(card: str, ms: dict):
    """Phases 32-38: scattered-data fits, TT completion, books and files
    (the fits' Grams are plain f32/f64 products on the card; the fitted
    dense model is served through K1 and K3).  Adds their times to ``ms``
    and returns the K1 and K3 launches of phase 33's main-path run."""
    import warnings

    # 32. The dense fit of scripts/bench_fit.py:37-60, uncut: d = 3 on
    # 9^3 nodes, noise N(0, 1e-3), seed 0, l2 = 1e-8; host at 2^15
    # samples, device at 2^20, device-dd at 2^19.
    counts, dom = FIT_NODES, FIT_DOMAIN
    rng = np.random.default_rng(0)
    samples = {}
    for engine, n in FIT_SAMPLES:
        pts = np.stack([rng.uniform(a, b, n) for a, b in dom], axis=1)
        samples[engine] = pts, fit_target_np(pts) + rng.normal(0, FIT_NOISE, n)
    fits, fit_s, busy = {}, {}, {}
    for engine, (pts, y) in samples.items():
        kw = dict(l2=1e-8, engine=engine, device=DEVICE)
        ChebyshevApproximation.fit(pts[:4096], y[:4096], 3, dom, counts,
                                   **kw)
        fits[engine], fit_s[engine] = timed_s(
            lambda: ChebyshevApproximation.fit(pts, y, 3, dom, counts, **kw))
        if engine != "host":
            busy[engine] = device_busy_ms(
                lambda: ChebyshevApproximation.fit(pts, y, 3, dom, counts,
                                                   **kw))
        rms = fits[engine].fit_diagnostics["rms"]
        check(rms <= 2 * FIT_NOISE,
              f"dense fit {engine}: rms {rms:.3e} > 2x the noise")
        ms[f"dense fit {engine}, {len(y):,} samples"] = fit_s[engine] * 1e3
    # The Grams on a shared 2^15 subset, against the host's f64 Gram;
    # the dd accumulation twice on the same input, bitwise.
    sub_pts, sub_y = (a[:FIT_SUBSET] for a in samples["device"])
    want, nodes, weights, design = host_gram(sub_pts, counts, dom)
    block = [(sub_pts, (0, 0, 0), sub_y, np.ones(len(sub_y)))]
    g32, _ = fit_ops._device_normal_accumulation(
        block, nodes, weights, design, 729, device=DEVICE)
    g64, _ = fit_ops._device_normal_accumulation_dd(
        block, nodes, weights, design, 729, device=DEVICE)
    d32, d64 = dev(g32, want), dev(g64, want)
    check(d32 <= FIT_GRAM_F32, f"f32 Gram vs host {d32:.3e}")
    check(d64 <= FIT_GRAM_DD, f"dd Gram vs host {d64:.3e}")
    dd_pts, dd_y = samples["device-dd"]
    dd_block = [(dd_pts, (0, 0, 0), dd_y, np.ones(len(dd_y)))]
    first = fit_ops._device_normal_accumulation_dd(
        dd_block, nodes, weights, design, 729, device=DEVICE)
    second = fit_ops._device_normal_accumulation_dd(
        dd_block, nodes, weights, design, 729, device=DEVICE)
    check(all(np.array_equal(a, b) for a, b in zip(first, second)),
          "two dd accumulations of the same 2^19 samples differ")
    print("[32 dense fit] 9^3 (G = 729), bench_fit.py's target + N(0, "
          "1e-3), l2 = 1e-8: " + "; ".join(
              f"{e} {len(samples[e][1]):,} samples {fit_s[e]:.3f} s = "
              f"{len(samples[e][1]) / fit_s[e]:,.0f} samples/s, rms "
              f"{fits[e].fit_diagnostics['rms']:.4e}"
              + (f", card busy {busy[e]:.1f} ms = "
                 f"{100.0 * busy[e] / (fit_s[e] * 1e3):.1f}%"
                 if e in busy else "")
              for e in fits)
          + f"; Gram vs host f64 on 2^15: f32 {d32:.3e} <= {FIT_GRAM_F32:g}, "
          f"dd {d64:.3e} <= {FIT_GRAM_DD:g}; two dd accumulations of 2^19 "
          f"bitwise equal | {card}", flush=True)

    # 33. The fitted model served through the kernels: f32 through K1,
    # dd through K3, counted from zero.
    model = fits["device-dd"]
    shape = tuple(model.n_nodes)
    check(fused_eval.supports_fused(shape, torch.float32)
          and fused_dd.supports_fused_dd(shape),
          f"the fused kernels do not cover the fitted {shape} grid")
    q = torch.tensor(sample_points(N, SEED + 60, dom), device=DEVICE)
    q32 = q.float()
    f64 = model.eval_batch_device(q, [0, 0, 0])
    fused_eval.launches = 0
    fused_dd.launches = 0
    out32 = checked(model.eval_batch_f32(q32, [0, 0, 0]), (N,),
                    "fitted f32")
    out_dd = checked(model.eval_batch_dd(q, [0, 0, 0]), (N,), "fitted dd")
    torch.cuda.synchronize()
    k1_fit, k3_fit = fused_eval.launches, fused_dd.launches
    check(k1_fit > 0, "the fitted model's eval_batch_f32 never launched K1")
    check(k3_fit > 0, "the fitted model's eval_batch_dd never launched K3")
    e32, edd = dev(out32, f64), dev(out_dd, f64)
    check(e32 <= F32_CEILING, f"fitted f32 vs f64 {e32:.3e}")
    check(edd <= DD_CEILING, f"fitted dd vs f64 {edd:.3e}")
    truth = fit_target_np(q.cpu().numpy())
    err_fn = dev(f64, truth)
    ms["fitted 9^3 f32 (eval_batch_f32, K1)"] = cuda_ms(
        lambda: model.eval_batch_f32(q32, [0, 0, 0]))
    ms["fitted 9^3 dd (eval_batch_dd, K3)"] = cuda_ms(
        lambda: model.eval_batch_dd(q, [0, 0, 0]))
    print(f"[33 fitted model served] 9^3 device-dd fit at 2^20: K1 "
          f"launches {k1_fit}, f32 vs f64 {e32:.3e} <= {F32_CEILING:g}, "
          f"{ms['fitted 9^3 f32 (eval_batch_f32, K1)']:.4f} ms; K3 launches "
          f"{k3_fit}, dd vs f64 {edd:.3e} <= {DD_CEILING:g}, "
          f"{ms['fitted 9^3 dd (eval_batch_dd, K3)']:.4f} ms; f64 vs the "
          f"noise-free target {err_fn:.3e} | {card}", flush=True)

    # 34. A gradient-enhanced fit: phase 32's dd fit plus a block of
    # d/dx0 observations, and device-dd against host on 2^15 + 2^12.
    g_pts = np.stack([rng.uniform(a, b, FIT_SUBSET) for a, b in dom],
                     axis=1)
    grad = [(g_pts, (1, 0, 0), fit_df0(g_pts), 0.25)]
    gfit, g_s = timed_s(lambda: ChebyshevApproximation.fit(
        dd_pts, dd_y, 3, dom, counts, l2=1e-8, derivative_data=grad,
        engine="device-dd", device=DEVICE))
    n_small = FIT_SUBSET // 8
    small = [(g_pts[:n_small], (1, 0, 0), fit_df0(g_pts[:n_small]), 0.25)]
    sub = {engine: ChebyshevApproximation.fit(
        sub_pts, sub_y, 3, dom, counts, l2=1e-8, derivative_data=small,
        engine=engine, device=DEVICE) for engine in ("host", "device-dd")}
    test = torch.tensor(sub_pts[:4096], device=DEVICE)
    dg = dev(sub["device-dd"].eval_batch_device(test, [0, 0, 0]),
             sub["host"].eval_batch_device(test, [0, 0, 0]))
    dt = dev(sub["device-dd"].tensor_values, sub["host"].tensor_values)
    check(dg <= FIT_DD_VS_HOST, f"gradient-enhanced dd vs host {dg:.3e}")
    blk = gfit.fit_diagnostics["derivative_blocks"][0]
    check(gfit.fit_diagnostics["rms"] <= 2 * FIT_NOISE,
          "gradient-enhanced fit: rms > 2x the noise")
    ms["dense fit device-dd + gradient block"] = g_s * 1e3
    print(f"[34 gradient-enhanced fit] device-dd, 2^19 values + 2^15 "
          f"d/dx0 rows (weight 0.25): {g_s:.3f} s, value rms "
          f"{gfit.fit_diagnostics['rms']:.4e}, block rms {blk['rms']:.4e}; "
          f"device-dd vs host on 2^15 + 2^12 rows: values {dg:.3e} <= "
          f"{FIT_DD_VS_HOST:g} (tensors {dt:.3e}) | {card}", flush=True)

    # 35. Spline and slider fits: config 3's payoff (knot at 1.0, 17^2
    # nodes a piece) and config 4's 10-D basket (singleton groups, 9
    # nodes), at device and device-dd on 2^20 samples; each engine
    # against host on a 2^15 subset of them.
    sp_pts = np.stack([rng.uniform(a, b, N) for a, b in SPLINE_DOMAIN],
                      axis=1)
    sl_pts = rng.uniform(-1.0, 1.0, (N, SLIDER_D))
    cases = {
        "spline": (lambda pts, engine: ChebyshevSpline.fit(
            pts, payoff_np(pts), 2, SPLINE_DOMAIN, [17, 17], [[1.0], []],
            l2=1e-12, engine=engine, device=DEVICE), sp_pts),
        "slider": (lambda pts, engine: ChebyshevSlider.fit(
            pts, basket_np(pts), SLIDER_D, [[-1.0, 1.0]] * SLIDER_D,
            [9] * SLIDER_D, [[i] for i in range(SLIDER_D)],
            [0.0] * SLIDER_D, l2=1e-12, engine=engine, device=DEVICE),
            sl_pts),
    }
    parts = []
    for family, (fit_fn, pts) in cases.items():
        test = pts[:4096]
        want = fit_fn(pts[:FIT_SUBSET], "host").eval_batch(test,
                                                        [0] * pts.shape[1])
        for engine in ("device", "device-dd"):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                fit_fn(pts[:4096], engine)
                obj, secs = timed_s(lambda: fit_fn(pts, engine))
                on_sub = fit_fn(pts[:FIT_SUBSET], engine)
            got = on_sub.eval_batch(test, [0] * pts.shape[1])
            d = dev(got, want)
            bound_dev = F32_CEILING if engine == "device" else FIT_DD_VS_HOST
            check(d <= bound_dev, f"{family} fit {engine} vs host {d:.3e}")
            ms[f"{family} fit {engine}, 2^20 samples"] = secs * 1e3
            parts.append(f"{family} {engine} {secs:.3f} s = "
                         f"{N / secs:,.0f} samples/s, rms "
                         f"{obj.fit_diagnostics['rms']:.3e}, vs host on 2^15 "
                         f"{d:.3e} <= {bound_dev:g}")
    print("[35 spline and slider fits] " + "; ".join(parts) + f" | {card}",
          flush=True)

    # 36. The TT fit of scripts/bench_tt_fit.py:36-50, uncut: d = 5 on
    # [0, 1]^5, 7 nodes, rank 5, l2 = 1e-8, 3 sweeps, 10^6 samples.
    tt_rng = np.random.default_rng(0)
    n_tt = TT_FIT_SAMPLES
    t_pts = tt_rng.uniform(0.0, 1.0, (n_tt, 5))
    t_y = (np.prod(np.cos(2 * t_pts), axis=1) + 0.1 * t_pts.sum(1)
           + tt_rng.normal(0.0, 1e-4, n_tt))
    tt_kw = dict(max_rank=5, sweeps=3, l2=1e-8)

    def tt_fit(n, engine):
        return ChebyshevTT.fit(t_pts[:n], t_y[:n], 5, [[0.0, 1.0]] * 5,
                               [7] * 5, engine=engine, device=DEVICE,
                               **tt_kw)

    runs = {}
    for tag in ("device cold", "device warm"):
        runs[tag] = (n_tt,) + timed_s(lambda: tt_fit(n_tt, "device"))
    n_cut = TT_FIT_HOST_CUT
    runs["host"] = (n_cut,) + timed_s(lambda: tt_fit(n_cut, "host"))
    predicted = runs["host"][2] * n_tt / n_cut
    host_note = (f"host on 2^17 samples (a cut: 10^6 would take "
                 f"~{predicted:.0f} s at this rate, past 60 s)")
    if predicted <= 60.0:
        runs["host"] = (n_tt,) + timed_s(lambda: tt_fit(n_tt, "host"))
        host_note = "host on the same 10^6 samples"
    parts = []
    for tag, (n, obj, secs) in runs.items():
        sweeps = len(obj.fit_diagnostics["sweep_rms"])
        rate = n * sweeps / secs
        ms[f"TT fit {tag}"] = secs * 1e3
        parts.append(f"{tag} {secs:.3f} s, {sweeps} sweeps = {rate:,.0f} "
                     f"sample-sweeps/s, rms "
                     f"{obj.fit_diagnostics['rms']:.4e}")
    r_dev = runs["device warm"][1].fit_diagnostics["rms"]
    r_host = runs["host"][1].fit_diagnostics["rms"]
    check(abs(r_dev - r_host) <= TT_FIT_RMS_REL * r_host,
          f"TT fit device rms {r_dev:.4e} vs host {r_host:.4e}")
    print(f"[36 TT fit] d=5, 7 nodes, rank 5, 3 sweeps, noise 1e-4; "
          f"{host_note}: " + "; ".join(parts)
          + f"; device rms within {TT_FIT_RMS_REL:g} of host's | {card}",
          flush=True)

    # 37. Config 5, the portfolio (scripts/run_baseline_table.py:560-611):
    # two TT-ALS builds, run_completion, 2A + B against its closed form,
    # the orth drift, the inner product and the slice.
    p_dom = [[80.0, 120.0], [0.25, 2.0], [0.1, 0.5], [0.01, 0.05]]

    def inst_a(points, _=None):
        p = np.asarray(points, dtype=np.float64)
        s, t, sg, r = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
        return (5.0 * np.log1p(np.exp((s - 100.0) / 5.0))
                * np.exp(-r * t) * (1 + 0.5 * sg))

    def inst_b(points, _=None):
        p = np.asarray(points, dtype=np.float64)
        s, t, sg, r = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
        return 100.0 * np.exp(-r * t) + 0.1 * s * sg * np.sqrt(t)

    t0 = time.perf_counter()
    tta = ChebyshevTT(inst_a, 4, p_dom, [9] * 4, max_rank=8,
                      tolerance=1e-8, vectorized=True, device=DEVICE)
    tta.build(verbose=False, method="als", seed=0)
    ttb = ChebyshevTT(inst_b, 4, p_dom, [9] * 4, max_rank=8,
                      tolerance=1e-8, vectorized=True, device=DEVICE)
    ttb.build(verbose=False, method="als", seed=1)
    builds_s = time.perf_counter() - t0
    before = tta._coeff_cores[0].copy()
    _, comp_s = timed_s(lambda: tta.run_completion(tolerance=1e-10,
                                                   max_iter=5))
    portfolio = tta * 2.0 + ttb
    box = np.random.default_rng(2).uniform(0.05, 0.95, (500, 4))
    lo = np.array([b[0] for b in p_dom])
    hi = np.array([b[1] for b in p_dom])
    p_pts = lo + (hi - lo) * box
    exact = 2.0 * inst_a(p_pts) + inst_b(p_pts)
    err = dev(portfolio.eval_batch(p_pts), exact)
    check(err <= PORTFOLIO_ERR, f"portfolio 2A + B vs closed form {err:.3e}")
    at = [100.0, 1.0, 0.3, 0.03]
    v0 = portfolio.eval(at)
    portfolio.orth_left(3)
    portfolio.orth_right(0)
    drift = abs(portfolio.eval(at) - v0)
    check(drift <= 1e-12 * abs(v0), f"orth drift {drift:.3e}")
    ip = tta.inner_product(ttb)
    sliced = portfolio.slice((3, 0.03))
    pts3 = p_pts[:100, :3]
    full3 = np.column_stack([pts3, np.full(100, 0.03)])
    err3 = dev(sliced.eval_batch(pts3), 2.0 * inst_a(full3) + inst_b(full3))
    check(err3 <= PORTFOLIO_ERR, f"sliced portfolio {err3:.3e}")
    moved = float(np.abs(tta._coeff_cores[0] - before).max())
    print(f"[37 config 5 portfolio] two TT-ALS builds {builds_s:.3f} s "
          f"(ranks {tta.tt_ranks} / {ttb.tt_ranks}); run_completion "
          f"(1e-10, 5 iters) {comp_s:.3f} s, moved core 0 by {moved:.3e}; "
          f"2A + B vs closed form {err:.3e} <= {PORTFOLIO_ERR:g}; orth "
          f"drift {drift:.3e}; <A,B> {ip:.6f}; slice(r=3%) {err3:.3e} | "
          f"{card}",
          flush=True)

    # 38. Books and files: six columns of the 5-D Black-Scholes price
    # from one vectorized call over the 11^5 grid, each bitwise the
    # tensor of its single build; served by MultiModelEvaluator; a
    # save_book/load_book and an .npz round trip; Sobol indices on the
    # card against a CPU copy.
    book, book_s = timed_s(lambda: build_book(
        book_np, 5, DOMAIN, [11] * 5, num_models=len(BOOK_YIELDS),
        device=DEVICE))
    for m, model_m in enumerate(book):
        single = ChebyshevApproximation(
            lambda p, _, m=m: book_np(p)[:, m], 5, DOMAIN, [11] * 5,
            vectorized=True, device=DEVICE)
        single.build(verbose=False)
        check(torch.equal(model_m.tensor_values, single.tensor_values),
              f"book column {m} is not its single build's tensor")
    check(all(a is b for a, b in zip(book[0].nodes, book[-1].nodes)),
          "the book's models do not share one grid")
    b_pts = torch.tensor(sample_points(N, SEED + 61), device=DEVICE)
    engine = MultiModelEvaluator(book, dtype=torch.float64, device=DEVICE)
    served = checked(engine(b_pts), (len(book), N), "book engine")
    worst_book = max(dev(served[m], book[m].eval_batch_device(
        b_pts, [0] * 5)) for m in range(len(book)))
    check(worst_book <= F64_CEILING, f"book engine vs single {worst_book:.3e}")
    ms["6-model built book f64 (MultiModelEvaluator)"] = cuda_ms(
        lambda: engine(b_pts))
    with tempfile.TemporaryDirectory() as scratch:
        scratch = Path(scratch)
        save_book(scratch / "book.npz", book)
        loaded = load_book(scratch / "book.npz", device=DEVICE)
        check(all(torch.equal(a.eval_batch_device(b_pts, [0] * 5),
                              b.eval_batch_device(b_pts, [0] * 5))
                  for a, b in zip(loaded, book)),
              "save_book/load_book round trip is not bitwise")
        model.save(scratch / "fit.npz", format="npz")
        back = ChebyshevApproximation.load(scratch / "fit.npz",
                                           device=DEVICE)
        check(torch.equal(back.eval_batch_device(q, [0, 0, 0]), f64),
              ".npz round trip of the fitted model is not bitwise")
    sob_card = book[0].sobol_indices()
    cpu_copy = ChebyshevApproximation.from_values(
        book[0].tensor_values.cpu(), 5, DOMAIN, [11] * 5, device="cpu")
    sob_cpu = cpu_copy.sobol_indices()
    d_sob = max(abs(sob_card[k][d] - sob_cpu[k][d])
                for k in ("first_order", "total_order") for d in range(5))
    check(d_sob <= F64_CEILING, f"Sobol indices card vs CPU {d_sob:.3e}")
    print(f"[38 books and files] build_book of {len(book)} Black-Scholes "
          f"columns over 11^5 in {book_s:.3f} s, each bitwise its single "
          f"build, one shared grid; MultiModelEvaluator f64 at 2^20 "
          f"{ms['6-model built book f64 (MultiModelEvaluator)']:.4f} ms, vs "
          f"single models {worst_book:.3e}; save_book/load_book and the "
          f"fitted model's .npz evaluate bitwise the same; Sobol indices "
          f"card vs CPU {d_sob:.3e} <= {F64_CEILING:g} (first order "
          + ", ".join(f"{sob_card['first_order'][d]:.4f}" for d in range(5))
          + f") | {card}", flush=True)
    return k1_fit, k3_fit


def dyadic_boxes(n, d, seed):
    """``n`` sub-boxes of [-1, 1]^d shaped as a search makes them: per
    dim a dyadic interval of depth 0-6, one dim in eight collapsed to a
    face (a monotonicity pin)."""
    rng = np.random.default_rng(seed)
    level = rng.integers(0, 7, (n, d))
    j = np.floor(rng.random((n, d)) * 2.0 ** level)
    lo = -1.0 + 2.0 * j / 2.0 ** level
    hi = np.where(rng.random((n, d)) < 0.125, lo, lo + 2.0 / 2.0 ** level)
    return np.stack([lo, hi], axis=-1)


def decaying_tensor(shape, rng):
    """A random coefficient tensor whose |c_k| decays like 0.7^|k|: the
    profile of a smooth interpolant's coefficients."""
    k = sum(np.ix_(*[np.arange(n) for n in shape]))
    return rng.standard_normal(shape) * 0.7 ** k


def wall_ms(fn, reps):
    """Median wall milliseconds of ``fn`` (a call that ends on the host)
    over ``reps`` calls, after one warm call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def recorded(fn, profiled=False):
    """Run ``fn`` once: (result, seconds, the ``GlobalResult`` of every
    search it ran, the text of its RuntimeWarnings, boxes whose stats
    ran on the device route, card busy ms or None).  The searches are
    read through ``utils.globalcalc``'s two search entry points."""
    from torch.profiler import ProfilerActivity, profile

    results, device_boxes = [], [0]
    saved = {name: getattr(globalcalc, name)
             for name in ("minimize_coeff_tensor", "minimize_tt_cores")}
    raw = subdivision._device_raw_stats

    def keep(search):
        def run(*args, **kwargs):
            out = search(*args, **kwargs)
            results.append(out)
            return out
        return run

    def counted(coeffs, boxes, *args):
        device_boxes[0] += boxes.shape[0]
        return raw(coeffs, boxes, *args)

    for name, search in saved.items():
        setattr(globalcalc, name, keep(search))
    subdivision._device_raw_stats = counted
    busy = None
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always", RuntimeWarning)
            t0 = time.perf_counter()
            if profiled:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    out = fn()
                    torch.cuda.synchronize()
                busy = sum(e.device_time_total
                           for e in prof.key_averages()) / 1e3
            else:
                out = fn()
            seconds = time.perf_counter() - t0
    finally:
        for name, search in saved.items():
            setattr(globalcalc, name, search)
        subdivision._device_raw_stats = raw
    texts = [str(w.message) for w in caught
             if issubclass(w.category, RuntimeWarning)]
    return out, seconds, results, texts, device_boxes[0], busy


def check_witness(what, value, gap, witness, mode, slack):
    """The certificate against a sampled witness ``witness`` (the min,
    or for ``mode == "max"`` the max, over many points): both
    inequalities, mirrored for a maximum."""
    sign = 1.0 if mode == "min" else -1.0
    v, s = sign * value, sign * witness
    check(s >= v - gap - slack,
          f"{what}: witness {witness!r} beats the certified bound "
          f"{value!r} by more than gap {gap:.3e} + {slack:.1e}")
    check(v <= s + gap + slack,
          f"{what}: value {value!r} is worse than the witness {witness!r} "
          f"by more than gap {gap:.3e} + {slack:.1e}")


def from_on(sweep, route):
    """The smallest swept size from which ``route`` ("card" or "cpu")
    beats NumPy at both batch sizes at that size and every larger one,
    or None."""
    sizes = sorted({size for size, _ in sweep})
    wins = [all(t[route] < t["numpy"] for (s, _), t in sweep.items()
                if s == size) for size in sizes]
    for i, size in enumerate(sizes):
        if all(wins[i:]):
            return size
    return None


def global_calculus(card: str, ms: dict, cheb) -> int:
    """Phases 39-42: certified global calculus (host branch-and-bound
    with the box statistics of large dense tensors in f64 on the card).
    Returns K3's launches in phase 40's witness run."""
    # 39. The box-stats route: the card's against the NumPy route on
    # the host, on the main path's 11^5 coefficient tensor and a 21^4
    # one (both routes forced, at every size), then the sweep of the
    # card, NumPy and PyTorch on the host that bears on
    # ops/subdivision.py's two thresholds.
    rng = np.random.default_rng(SEED + 39)
    main_coeffs = globalcalc.dense_coeff_tensor(cheb.tensor_values)
    thresholds = (subdivision._DEVICE_STATS_MIN_SIZE,
                  subdivision._CPU_STATS_MIN_SIZE)
    subdivision._DEVICE_STATS_MIN_SIZE = 1
    subdivision._CPU_STATS_MIN_SIZE = 1
    try:
        agree = []
        for name, coeffs in (("11^5 main path", main_coeffs),
                             ("21^4", decaying_tensor((21,) * 4, rng))):
            boxes = dyadic_boxes(STATS_BOXES, coeffs.ndim, SEED + 390)
            host = subdivision._make_full_stats(coeffs).raw_stats(boxes)
            on_card = subdivision._make_full_stats(
                coeffs, DEVICE).raw_stats(boxes)
            total = host[1]
            worst = max(
                float(np.max(np.abs(a - b) / total.reshape(
                    (-1,) + (1,) * (np.ndim(a) - 1))))
                for a, b in zip(host[:4] + tuple(host[4]) + tuple(host[5]),
                                on_card[:4] + tuple(on_card[4])
                                + tuple(on_card[5])))
            check(worst <= STATS_VS_NUMPY,
                  f"box stats {name}: card vs NumPy {worst:.3e} of the "
                  f"box's |c| mass > {STATS_VS_NUMPY:g}")
            agree.append(f"{name} {worst:.3e}")
        sweep = {}
        for n, d in STATS_SWEEP:
            coeffs = decaying_tensor((n,) * d, rng)
            routes = {"numpy": subdivision._make_full_stats(coeffs),
                      "card": subdivision._make_full_stats(coeffs, DEVICE),
                      "cpu": subdivision._make_full_stats(coeffs, "cpu")}
            for bsz in (16, STATS_BOXES):
                boxes = dyadic_boxes(bsz, d, SEED + 391)
                reps = 1 if coeffs.size * bsz > 2e7 else 5
                t = {route: wall_ms(lambda fs=fs: fs.raw_stats(boxes),
                                    5 if route == "card" else reps)
                     for route, fs in routes.items()}
                sweep[n ** d, bsz] = t
                for route, ms_call in t.items():
                    ms[f"box stats {n}^{d} x{bsz} {route}"] = ms_call
                print(f"[39 box stats sweep] {n}^{d} = {n ** d:,} "
                      f"coefficients, {bsz} boxes: NumPy {t['numpy']:.3f} "
                      f"ms, card {t['card']:.3f} ms "
                      f"({t['numpy'] / t['card']:.2f}x), PyTorch on the "
                      f"host {t['cpu']:.3f} ms "
                      f"({t['numpy'] / t['cpu']:.2f}x) | {card}",
                      flush=True)
    finally:
        (subdivision._DEVICE_STATS_MIN_SIZE,
         subdivision._CPU_STATS_MIN_SIZE) = thresholds
    print(f"[39 box stats] card vs NumPy route, {STATS_BOXES} dyadic "
          f"boxes, max deviation per quantity over the box's |c| mass: "
          + ", ".join(agree) + f" <= {STATS_VS_NUMPY:g}; of the sizes "
          f"swept, faster than NumPy at both batch sizes from "
          f"{from_on(sweep, 'card')} coefficients on: the card; from "
          f"{from_on(sweep, 'cpu')} on: PyTorch on the host; the module's "
          f"_DEVICE_STATS_MIN_SIZE = {thresholds[0]:,} and "
          f"_CPU_STATS_MIN_SIZE = {thresholds[1]:,} (both chosen with "
          f"phase 42's end-to-end searches) | {card}",
          flush=True)

    # 40. The main path: certified optima of the 11^5 Black-Scholes
    # interpolant over its box, and with K pinned, each witnessed by
    # 2^20 points through K3 (eval_batch_dd); each certified one is
    # also run with every box statistic on the NumPy route (the
    # reference's) and held to it.
    scale = float(cheb.tensor_values.abs().max())
    tol = GLOBAL_TOL * scale
    slack = WITNESS_EPS * scale
    k3_launches = 0
    main_values = {}
    for fixed in (None, {1: 100.0}):
        for mode in ("min", "max"):
            what = f"{mode}imize(fixed={fixed})"

            def search():
                return getattr(cheb, f"{mode}imize")(fixed=fixed, tol=tol)

            (value, point), secs, res, texts, on_card, _ = recorded(search)
            *_, busy = recorded(search, profiled=True)
            certified = all(r.certified for r in res)
            check(certified == (not texts),
                  f"{what}: the RuntimeWarning does not match the "
                  f"certificate ({texts})")
            gap = tol if certified else max(r.gap for r in res)
            main_values[mode, bool(fixed)] = (value, gap, certified)
            pts = sample_points(N, SEED + 40)
            if fixed:
                pts[:, 1] = fixed[1]
            pts = torch.tensor(pts, device=DEVICE)
            fused_dd.launches = 0
            vals = checked(cheb.eval_batch_dd(pts), (N,), f"{what} witness")
            k3_launches += fused_dd.launches
            check(fused_dd.launches > 0, f"{what}: the witness never "
                                         f"launched K3")
            witness = float(vals.min() if mode == "min" else vals.max())
            check_witness(what, value, gap, witness, mode, slack)
            host_v = float(cheb.eval_batch_host(point[None], [0] * 5)[0])
            check(abs(host_v - value) <= GLOBAL_VS_HOST * scale,
                  f"{what}: value {value!r} vs eval_batch_host at its "
                  f"point {host_v!r}")
            if certified:
                subdivision._DEVICE_STATS_MIN_SIZE = sys.maxsize
                try:
                    (np_value, _), np_secs, np_res, _, np_card, _ = (
                        recorded(search))
                finally:
                    subdivision._DEVICE_STATS_MIN_SIZE = thresholds[0]
                d_np = abs(np_value - value)
                check(np_card == 0 and all(r.certified for r in np_res)
                      and d_np <= GLOBAL_VS_CPU * scale,
                      f"{what}: NumPy route {np_value!r} ({np_card} box "
                      f"stats on the card, certified "
                      f"{[r.certified for r in np_res]}) vs card {value!r}")
                numpy_route = (f"the NumPy route: {np_value!r} (certified, "
                               f"{np_secs:.3f} s), {d_np:.3e} <= "
                               f"{GLOBAL_VS_CPU:g} x scale")
            else:
                numpy_route = ("not run on the NumPy route (uncertified: "
                               "only the witness holds it)")
            ms[f"global {what} 11^5"] = secs * 1e3
            print(f"[40 global {mode}] 11^5 Black-Scholes, fixed={fixed}, "
                  f"tol {tol:.3e} (1e-9 x scale {scale:.4f}): value "
                  f"{value!r} at {np.array2string(point, precision=6)}; "
                  f"{'certified' if certified else 'NOT certified'}, gap "
                  f"{max(r.gap for r in res):.3e}, {sum(r.boxes for r in res)}"
                  f" boxes ({on_card} box stats on the card), {secs:.3f} s, "
                  f"card busy {busy:.1f} ms = "
                  f"{100.0 * busy / (secs * 1e3):.2f}% of the unprofiled "
                  f"time; K3 witness over 2^20 points {witness!r} "
                  f"({fused_dd.launches} launches), both inequalities hold "
                  f"within {slack:.1e}; eval_batch_host at the point "
                  f"{abs(host_v - value):.3e}; {numpy_route} | {card}",
                  flush=True)
            if texts:
                print(f"[40 global {mode}] warning: {texts[0]}", flush=True)

    # 41. scripts/bench_global_calculus.py's rows, uncut, each against
    # the same call on a CPU build of the same model; the rows that
    # search a dense tensor once more with every box statistic forced
    # onto the card.
    def models(device):
        built = {
            "waves": ChebyshevApproximation(
                waves_np, 2, [[-1.5, 1.5], [-1, 2]], [21, 21],
                vectorized=True, device=device),
            "bowl3": ChebyshevApproximation(
                bowl3_np, 3, [[-1, 1]] * 3, [9, 9, 9], vectorized=True,
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
        }
        for model in built.values():
            model.build(verbose=False)
        built["tt"] = ChebyshevTT(q3_np, 3, [[-1, 1]] * 3, [9, 9, 9],
                                  tolerance=1e-12, max_rank=8,
                                  vectorized=True, device=device)
        built["tt"].build(verbose=False, seed=42)
        return built

    def held(name, got, res, want, want_res, scale):
        """``got`` against the CPU build's ``want``; the result's text."""
        if isinstance(got, tuple):
            d_val = abs(got[0] - want[0])
            check(d_val <= GLOBAL_VS_CPU * scale,
                  f"{name}: card {got[0]!r} vs CPU {want[0]!r}")
            certified = all(r.certified for r in res)
            check(certified == all(r.certified for r in want_res),
                  f"{name}: certified on the card {certified}, on the CPU "
                  f"{not certified}")
            return (f"value {got[0]!r} at "
                    f"{np.array2string(np.asarray(got[1]), precision=6)}"
                    f", vs CPU {d_val:.3e}")
        if isinstance(got, list):
            check(len(got) == len(want) and [c.kind for c in got]
                  == [c.kind for c in want],
                  f"{name}: card {[c.kind for c in got]} vs CPU "
                  f"{[c.kind for c in want]}")
            d_pt = max((float(np.abs(a.point - b.point).max())
                        for a, b in zip(got, want)), default=0.0)
            return (f"{len(got)} points (" + ", ".join(c.kind for c in got)
                    + f"), points vs CPU {d_pt:.3e}")
        check(got.shape == want.shape,
              f"{name}: {got.shape[0]} roots on the card, "
              f"{want.shape[0]} on the CPU")
        return (f"{got.shape[0]} roots {np.array2string(got, precision=6)}"
                f", vs CPU {float(np.abs(got - want).max()):.3e}")

    def forced(call, anchored):
        """``call`` on the card with every box statistic forced onto it
        and, with ``anchored``, every tensor anchored (the CPU build's
        search too): (result, seconds, its searches, box stats on the
        card, of them in per-box batches, the CPU build's result and
        searches)."""
        saved = (subdivision._DEVICE_STATS_MIN_SIZE,
                 subdivision._ANCHOR_MIN_SIZE, subdivision._device_raw_stats)
        batched_boxes = [0]

        def count(coeffs, boxes, shape, batched):
            batched_boxes[0] += boxes.shape[0] if batched else 0
            return saved[2](coeffs, boxes, shape, batched)

        if anchored:
            subdivision._ANCHOR_MIN_SIZE = 1
        try:
            subdivision._DEVICE_STATS_MIN_SIZE = 1
            subdivision._device_raw_stats = count
            got, secs, res, _, boxes, _ = recorded(lambda: call(on_card))
            subdivision._DEVICE_STATS_MIN_SIZE = saved[0]
            subdivision._device_raw_stats = saved[2]
            want, _, want_res, _, _, _ = recorded(lambda: call(on_cpu))
        finally:
            (subdivision._DEVICE_STATS_MIN_SIZE,
             subdivision._ANCHOR_MIN_SIZE,
             subdivision._device_raw_stats) = saved
        return got, secs, res, boxes, batched_boxes[0], want, want_res

    on_card, on_cpu = models(DEVICE), models("cpu")
    rows = [
        ("dense 2-D 21^2 waves, tol 1e-9", "waves",
         lambda m: m["waves"].minimize(tol=1e-9)),
        ("dense 3-D 9^3 bowl3, tol 1e-9", "bowl3",
         lambda m: m["bowl3"].minimize(tol=1e-9)),
        ("spline 2 pieces (kink minimum on the knot), tol 1e-9", "spline",
         lambda m: m["spline"].minimize(tol=1e-9)),
        ("slider 10-D (10 groups), exact", "slider",
         lambda m: m["slider"].minimize(tol=1e-9)),
        ("TT 3-D rank <= 8, tol 1e-9", "tt",
         lambda m: m["tt"].minimize(tol=1e-9)),
        ("critical_points dense 3-D 9^3", "bowl3",
         lambda m: m["bowl3"].critical_points()),
        ("critical_points TT 3-D", "tt",
         lambda m: m["tt"].critical_points()),
        ("solve_system 2x2 (circle x line)", "circle",
         lambda m: solve_system([m["circle"], m["line"]])),
    ]
    for name, key, call in rows:
        got, secs, res, texts, stats_boxes, _ = recorded(
            lambda: call(on_card))
        want, _, want_res, _, _, _ = recorded(lambda: call(on_cpu))
        scale = value_scale(on_card[key])
        result = held(name, got, res, want, want_res, scale)
        ms[f"global row {name}"] = secs * 1e3
        state = ("certified" if all(r.certified for r in res)
                 else "NOT certified")
        searched = (f"{sum(r.boxes for r in res)} boxes in {len(res)} "
                    f"searches ({stats_boxes} box stats on the card), "
                    f"{state}" if res
                    else "no optimum search (zero isolation)")
        # The spline's 9^2 pieces make no per-box batches even when
        # anchored; the two dense rows do.
        anchorings = {"waves": (False, True), "bowl3": (False, True),
                      "spline": (False,)}.get(key, ()) if res else ()
        for anchored in anchorings:
            got, f_secs, f_res, boxes, batched, want, want_res = (
                forced(call, anchored))
            how = (" and every tensor anchored (on the CPU build too)"
                   if anchored else "")
            check(boxes > 0 and (batched > 0 or not anchored),
                  f"{name}: every box statistic forced onto the card"
                  f"{how}, yet {boxes} ran there, {batched} of them in "
                  f"per-box batches")
            result += (f"; every box statistic forced onto the card"
                       f"{how}: {f_secs * 1e3:.1f} ms, {boxes} box "
                       f"stats on the card ({batched} in per-box "
                       f"batches), "
                       + held(name + " (forced)", got, f_res, want,
                              want_res, scale))
        print(f"[41 global rows] {name}: {secs * 1e3:.1f} ms, {searched}; "
              f"{result} | {card}", flush=True)

    # The 21^5 oscillatory row, once, witnessed by 2^20 points through
    # the model's f64 batched path.
    osc = ChebyshevApproximation(osc5_np, 5, [[-1, 1]] * 5, [21] * 5,
                                 vectorized=True, device=DEVICE)
    osc.build(verbose=False)
    (value, point), secs, res, texts, stats_boxes, busy = recorded(
        lambda: osc.minimize(tol=1e-7, max_boxes=5000), profiled=True)
    scale = float(osc.tensor_values.abs().max())
    certified = all(r.certified for r in res)
    gap = 1e-7 if certified else max(r.gap for r in res)
    pts = torch.tensor(sample_points(N, SEED + 41, [[-1.0, 1.0]] * 5),
                       device=DEVICE)
    vals = checked(osc.eval_batch_device(pts), (N,), "21^5 witness")
    witness = float(vals.min())
    check_witness("21^5 osc5 minimize", value, gap, witness, "min",
                  WITNESS_EPS * scale)
    host_v = float(osc.eval_batch_host(point[None], [0] * 5)[0])
    check(abs(host_v - value) <= GLOBAL_VS_HOST * scale,
          f"21^5 minimize: value {value!r} vs eval_batch_host {host_v!r}")
    ms["global row dense 5-D 21^5 osc5"] = secs * 1e3
    print(f"[41 global rows] dense 5-D 21^5 oscillatory, tol 1e-7, 5,000 "
          f"boxes (once, under the profiler): {secs:.3f} s, "
          f"{sum(r.boxes for r in res)} boxes ({stats_boxes} box stats on "
          f"the card), card busy {busy:.1f} ms = "
          f"{100.0 * busy / (secs * 1e3):.2f}%; "
          f"{'certified' if certified else 'NOT certified'}, gap "
          f"{max(r.gap for r in res):.3e}; value {value!r} at "
          f"{np.array2string(point, precision=6)}; f64 witness over 2^20 "
          f"points {witness!r}, both inequalities hold | {card}",
          flush=True)

    # 42. The card's threshold end to end: phase 40's two searches that
    # call the box statistics most (the whole-box minimum and the
    # K-pinned one) at each _DEVICE_STATS_MIN_SIZE of STATS_THRESHOLDS,
    # in the order A B C D D C B A, each held to its phase-40 value.
    scale = float(cheb.tensor_values.abs().max())
    runs = {t: [] for t in STATS_THRESHOLDS}
    try:
        for t in STATS_THRESHOLDS + STATS_THRESHOLDS[::-1]:
            subdivision._DEVICE_STATS_MIN_SIZE = t
            parts, total = [], 0.0
            for fixed in (None, {1: 100.0}):
                (value, _), secs, res, _, stats_boxes, _ = recorded(
                    lambda: cheb.minimize(fixed=fixed, tol=tol))
                ref, ref_gap, ref_certified = main_values["min", bool(fixed)]
                certified = all(r.certified for r in res)
                gap = tol if certified else max(r.gap for r in res)
                # Two certified values agree to roundoff; otherwise each
                # lies within its own gap of the true minimum.
                bound = (GLOBAL_VS_CPU * scale
                         if certified and ref_certified
                         else gap + ref_gap + slack)
                check(abs(value - ref) <= bound,
                      f"threshold {t:,}, minimize(fixed={fixed}): value "
                      f"{value!r} vs phase 40's {ref!r} (bound {bound:.3e})")
                total += secs
                state = ("certified" if certified
                         else f"NOT certified, gap {gap:.3e}")
                parts.append(f"fixed={fixed} {secs:.3f} s, value {value!r}"
                             f" ({state}; {stats_boxes} box stats on the "
                             f"card)")
            runs[t].append(total)
            print(f"[42 threshold] _DEVICE_STATS_MIN_SIZE = {t:,}: "
                  + "; ".join(parts) + f"; together {total:.3f} s "
                  f"| {card}", flush=True)
    finally:
        subdivision._DEVICE_STATS_MIN_SIZE = thresholds[0]
    medians = {t: float(np.median(v)) for t, v in runs.items()}
    for t, secs in medians.items():
        ms[f"global min + pinned min at threshold {t}"] = secs * 1e3
    # Where the whole-box minimum's time goes, at the module's threshold:
    # ops/subdivision.py's functions by cumulative time under cProfile.
    prof = cProfile.Profile()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        t0 = time.perf_counter()
        prof.enable()
        value, _ = cheb.minimize(tol=tol)
        prof.disable()
        secs = time.perf_counter() - t0
    ref, ref_gap, _ = main_values["min", False]
    check(abs(value - ref) <= 2.0 * ref_gap + slack,
          f"whole-box minimum under cProfile {value!r} vs phase 40's "
          f"{ref!r}")
    parts = ("_promote", "restrict_box_coeffs", "truncate_coeff_tensor",
             "_device_raw_stats", "_box_stats_torch", "_restriction_mats",
             "_sub_raw_stats", "_assemble_bounds", "_best_exact_in_box")
    top = sorted(((ct, nc, func) for (path, _, func), (_, nc, _, ct, _)
                  in pstats.Stats(prof).stats.items()
                  if path.endswith("subdivision.py") and func in parts),
                 reverse=True)
    print(f"[42 profile] whole-box minimum under cProfile at "
          f"_DEVICE_STATS_MIN_SIZE = {thresholds[0]:,}: {secs:.3f} s, value "
          f"{value!r} ({abs(value - ref):.3e} from phase 40's); "
          f"ops/subdivision.py's parts by cumulative time (they nest): "
          + ", ".join(f"{func} {ct:.3f} s ({nc} calls)"
                      for ct, nc, func in top) + f" | {card}", flush=True)
    print("[42 threshold] the two searches together, median of 2 runs: "
          + ", ".join(f"{t:,} {medians[t]:.3f} s ("
                      + " / ".join(f"{x:.3f}" for x in runs[t]) + ")"
                      for t in STATS_THRESHOLDS)
          + f"; fastest {min(medians, key=medians.get):,}; the module's "
          f"_DEVICE_STATS_MIN_SIZE = {thresholds[0]:,} | {card}",
          flush=True)

    # The same question for a search on the CPU: a CPU build's K-pinned
    # minimum (an 11^4 tensor, between the thresholds) at each
    # _CPU_STATS_MIN_SIZE of CPU_STATS_THRESHOLDS, in the order A B B A.
    host = ChebyshevApproximation(bs_price_np, 5, DOMAIN, [11] * 5,
                                  vectorized=True, device="cpu")
    host.build(verbose=False)
    ref = main_values["min", True][0]
    runs = {t: [] for t in CPU_STATS_THRESHOLDS}
    try:
        for t in CPU_STATS_THRESHOLDS + CPU_STATS_THRESHOLDS[::-1]:
            subdivision._CPU_STATS_MIN_SIZE = t
            (value, _), secs, res, _, stats_boxes, _ = recorded(
                lambda: host.minimize(fixed={1: 100.0}, tol=tol))
            check(all(r.certified for r in res)
                  and abs(value - ref) <= GLOBAL_VS_CPU * scale,
                  f"CPU build, _CPU_STATS_MIN_SIZE = {t:,}: value "
                  f"{value!r} (certified {[r.certified for r in res]}) vs "
                  f"phase 40's {ref!r}")
            runs[t].append(secs)
            print(f"[42 threshold] CPU build, _CPU_STATS_MIN_SIZE = {t:,}:"
                  f" minimize(fixed={{1: 100.0}}) {secs:.3f} s, value "
                  f"{value!r} (certified; {stats_boxes} box stats through "
                  f"PyTorch on the host) | {card}", flush=True)
    finally:
        subdivision._CPU_STATS_MIN_SIZE = thresholds[1]
    for t, secs in runs.items():
        ms[f"CPU build pinned min at threshold {t}"] = (
            float(np.median(secs)) * 1e3)
    print("[42 threshold] the CPU build's K-pinned minimum, median of 2 "
          "runs: " + ", ".join(
              f"{t:,} {float(np.median(v)):.3f} s ("
              + " / ".join(f"{x:.3f}" for x in v) + ")"
              for t, v in runs.items())
          + f"; the module's _CPU_STATS_MIN_SIZE = {thresholds[1]:,} "
          f"| {card}", flush=True)
    return k3_launches


# ---------------------------------------------------------------------------
# 43-53. Multi-device: every meshed path on a one-rank NCCL world on the
# card (the machine holds one card, and NCCL takes one rank per card), then
# a 4-rank gloo world on the host's CPU for sharding with P > 1.
# ---------------------------------------------------------------------------

GLOO_RANKS = 4
GLOO_DOMAIN = [[-1.0, 1.0], [0.0, 2.0], [-3.0, 1.0]]
MESH_FITS = (("device-dd", 1 << 19), ("device", 1 << 20))
MESH_TT_NODES = [11, 9, 10]
WIDE = (9, 16400)          # beyond supports_dd; tp = 4 serves it
DD_TP_VS_F64 = 1e-11       # the reference's bound for this grid


def arith_np(p, _data=None):
    """Products and sums only: the same bits on NumPy arrays and on
    tensors, on the host and on the card (the meshed builds' target)."""
    return (p[:, 0] * p[:, 0] * p[:, 1] + 0.25 * p[:, 2] * p[:, 2] * p[:, 0]
            + 0.5 * p[:, 1] * p[:, 2])


def book_torch(points, _data=None):
    """``book_np`` in PyTorch, where ``points`` are: a tensor on the card
    under a mesh, host NumPy without one."""
    p = torch.as_tensor(points, dtype=torch.float64)
    s, k, t, sigma, r = (p[:, i:i + 1] for i in range(5))
    q = torch.as_tensor(BOOK_YIELDS, dtype=torch.float64,
                        device=p.device)[None, :]
    sqrt_t = torch.sqrt(t)
    d1 = (torch.log(s / k) + (r - q + 0.5 * sigma ** 2) * t) \
        / (sigma * sqrt_t)
    d2 = d1 - sigma * sqrt_t
    return (s * torch.exp(-q * t) * torch.special.ndtr(d1)
            - k * torch.exp(-r * t) * torch.special.ndtr(d2))


def wide_operands(device):
    """The reference's (9, 16400) beyond-budget grid (closed-form
    Chebyshev-1 barycentric weights), on ``device``."""
    def cheb1(n):
        k = np.arange(n)
        x = np.cos((2 * k + 1) * np.pi / (2 * n))
        w = ((-1.0) ** k) * np.sin((2 * k + 1) * np.pi / (2 * n))
        order = np.argsort(x)
        return x[order], w[order]
    xs, ws = zip(*(cheb1(n) for n in WIDE))
    gx, gy = np.meshgrid(xs[0], xs[1], indexing="ij")
    tensor = np.sin(3 * gx) * np.cos(2 * gy) + 0.5 * gx * gy

    def on(a):
        return torch.tensor(a, dtype=torch.float64, device=device)
    return on(tensor), tuple(map(on, xs)), tuple(map(on, ws))


def gloo_results(mesh_fn):
    """The small meshed checks of phase 53 on ``mesh_fn(axes, shape)``'s
    meshes, or on one device of the CPU when it returns None."""
    res = {}
    cheb = ChebyshevApproximation(arith_np, 3, GLOO_DOMAIN, [9, 8, 8],
                                  vectorized=True, device="cpu")
    cheb.build(verbose=False)
    grid = cheb._grid_tuples()
    pts = sample_points(130, SEED + 90, GLOO_DOMAIN)
    pts[:5, 0] = grid[0][0][[0, 2, 3, 5, 8]].numpy()
    dp = mesh_fn(("dp",), (GLOO_RANKS,))
    tp = mesh_fn(("dp", "tp"), (2, 2))
    tp4 = mesh_fn(("dp", "tp"), (1, GLOO_RANKS))
    pp = mesh_fn(("pp",), (GLOO_RANKS,))
    tensor, xs, ws = wide_operands("cpu")
    wide_pts = sample_points(256, SEED + 92, [(-0.97, 0.97)] * 2)
    if dp is None:
        res["dp"] = eval_ops.eval_batch(cheb.tensor_values, *grid,
                                        torch.tensor(pts), (0, 0, 0))
        res["tp"] = eval_ops.eval_batch(cheb.tensor_values, *grid,
                                        torch.tensor(pts), (1, 0, 1))
        res["dd_tp"] = eval_ops.eval_batch(tensor, xs, ws, (None, None),
                                           torch.tensor(wide_pts), (0, 0))
    else:
        res["dp"] = sharding.eval_batch_dp(cheb.tensor_values, *grid, pts,
                                           dp, (0, 0, 0))
        res["tp"] = sharding.eval_batch_tp(cheb.tensor_values, *grid, pts,
                                           tp, orders=(1, 0, 1))
        res["dd_tp"] = sharding.eval_batch_dd_tp(tensor, xs, ws, ((), ()),
                                                 wide_pts, tp4)
    tt = ChebyshevTT(arith_np, 3, GLOO_DOMAIN, MESH_TT_NODES, max_rank=5,
                     vectorized=True, device="cpu")
    tt.build(verbose=False, seed=0, mesh=dp)
    for k, core in enumerate(tt._coeff_cores):
        res[f"tt_core_{k}"] = torch.as_tensor(core)
    res["pp"] = (tt_eval.tt_eval_batch(
        [torch.tensor(c) for c in tt._coeff_cores], GLOO_DOMAIN, pts)
        if pp is None else tt_eval_batch_pp(tt._coeff_cores, GLOO_DOMAIN,
                                            pts, pp))
    book = build_book(lambda p, _: torch.stack(
        [torch.as_tensor(arith_np(p)) * (m + 1) for m in range(3)], dim=1),
        3, GLOO_DOMAIN, [5, 6, 7], mesh=dp, device="cpu")
    res["book"] = torch.stack([m.tensor_values for m in book])
    rng = np.random.default_rng(SEED + 91)
    fit_pts = np.stack([rng.uniform(a, b, 5000) for a, b in FIT_DOMAIN],
                       axis=1)
    fit_y = fit_target_np(fit_pts) + rng.normal(0, FIT_NOISE, 5000)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        saved = fit_ops._DD_MAX_CHUNK
        fit_ops._DD_MAX_CHUNK = 512          # ten chunks over four ranks
        try:
            res["fit_dd"] = ChebyshevApproximation.fit(
                fit_pts, fit_y, 3, FIT_DOMAIN, [5, 5, 5], l2=1e-8,
                engine="device-dd", mesh=dp, device="cpu").tensor_values
        finally:
            fit_ops._DD_MAX_CHUNK = saved
    return res


def gloo_rank(rank, out, cuda_check=True):
    """One rank of phase 53's world: the checks on its meshes, every rank
    holding rank 0's results; rank 0 also checks that a CUDA tensor is
    refused by the gloo group (``cuda_check``), and saves the results."""
    meshes = {}

    def mesh_fn(axes, shape):
        meshes[axes] = sharding.make_mesh(axis_names=axes, shape=shape,
                                          device_type="cpu")
        return meshes[axes]
    res = gloo_results(mesh_fn)
    check_replicated(res)
    if rank == 0 and cuda_check:
        on_card = torch.zeros(3, dtype=torch.float64, device="cuda")
        try:
            sharding.eval_batch_dp(on_card, (on_card,), (on_card,),
                                   (None,), np.zeros((4, 1)),
                                   meshes[("dp",)], (0,))
            refused = 0
        except ValueError as exc:
            refused = int("never staged through the host" in str(exc))
        res["cuda_under_gloo_refused"] = torch.tensor(refused)
    if rank == 0:
        np.savez(out, **{k: v.cpu().numpy() for k, v in res.items()})


def multi_device(card: str, ms: dict, cheb, cheb19, slider, tt):
    """Phases 43-53: the reference's multi-device checklist
    (``dryrun_multichip``) on the port.  A one-rank NCCL world on the
    card drives every meshed path at the main path's widths, each held
    to the same call without a mesh; a 4-rank gloo world on the CPU
    shards with P > 1.  Returns the K1, K2 and K3 launches of the meshed
    main-path runs (each counted from zero)."""

    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    with local_world("nccl", device_id=torch.device("cuda", 0)):
        dp = sharding.make_mesh(device_type="cuda")
        meshes = {"dp": dp, "dp_tp": sharding.make_mesh(
            axis_names=("dp", "tp"), shape=(1, 1), device_type="cuda"),
            "pp": sharding.make_mesh(axis_names=("pp",),
                                     device_type="cuda")}
        print(f"[43 NCCL world] one rank, backend "
              f"{torch.distributed.get_backend()}, meshes "
              + ", ".join(f"{k} {tuple(m.mesh_dim_names)}"
                          f"={tuple(m.mesh.shape)}"
                          for k, m in meshes.items())
              + f" on {sharding.mesh_device(dp)} in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        launches = mesh_engines(card, ms, dp, cheb, cheb19)
        mesh_paths(card, ms, meshes, cheb, slider, tt)
        mesh_fits_and_builds(card, ms, meshes)
    gloo_world(card)
    return launches


def mesh_engines(card: str, ms: dict, dp, cheb, cheb19):
    """Phases 44-45: the dp engines at 2^20 through K1, K3 and K2 (the
    launches counted from zero), bitwise the engines without a mesh, and
    what the mesh adds to each."""
    t0 = time.perf_counter()
    pts64 = torch.tensor(sample_points(N, SEED + 80), device=DEVICE)
    pts32 = pts64.float()
    engines = {}
    for tier, dtype in (("f32", torch.float32), ("f64", torch.float64),
                        ("dd", "dd")):
        for meshed in (False, True):
            engines[f"{tier} value", meshed] = BatchedEvaluator(
                cheb, dtype=dtype, mesh=dp if meshed else None,
                device=DEVICE)
    for tier, dtype in (("f64", torch.float64), ("dd", "dd")):
        for meshed in (False, True):
            engines[f"{tier} price+5 Greeks", meshed] = MultiSpecEvaluator(
                cheb, GREEKS, dtype=dtype, mesh=dp if meshed else None,
                device=DEVICE)
    plain = {name: engines[name, False](pts32 if name.startswith("f32")
                                        else pts64)
             for name, meshed in engines if not meshed}
    torch.cuda.synchronize()
    fused_eval.launches = 0
    fused_dd.launches = 0
    got = {name: checked(engines[name, True](
        pts32 if name.startswith("f32") else pts64), plain[name].shape,
        f"meshed {name}") for name in plain}
    torch.cuda.synchronize()
    k1, k3 = fused_eval.launches, fused_dd.launches
    check(k1 > 0, "the meshed f32 engine never launched K1")
    check(k3 > 0, "the meshed dd engines never launched K3")
    for name in plain:
        check(torch.equal(got[name], plain[name]),
              f"meshed {name} is not bitwise the engine without a mesh")
    added = {}
    for name in plain:
        pts = pts32 if name.startswith("f32") else pts64
        ms[f"dp mesh {name}, one rank"] = cuda_ms(
            lambda e=engines[name, True]: e(pts))
        ms[f"no mesh {name}"] = cuda_ms(lambda e=engines[name, False]: e(pts))
        added[name] = (ms[f"dp mesh {name}, one rank"]
                       - ms[f"no mesh {name}"])
    gather = torch.empty(N, dtype=torch.float64, device=DEVICE)
    ms["NCCL all_gather of 2^20 f64, one rank"] = cuda_ms(
        lambda: sharding._all_gather_rows(gather, dp.get_group("dp"), 1))
    print(f"[44 dp engines] 11^5 at N=2^20 on a ('dp',) mesh of one rank: "
          f"f32 (K1), f64, dd (K3), price+5 Greeks f64 and dd, each "
          f"bitwise the engine without a mesh; K1 launches {k1}, K3 "
          f"launches {k3}; mesh vs no mesh (CUDA events, median of 15): "
          + "; ".join(f"{name} {ms[f'dp mesh {name}, one rank']:.4f} vs "
                      f"{ms[f'no mesh {name}']:.4f} ms (adds "
                      f"{added[name]:+.4f} ms)" for name in plain)
          + f"; NCCL all_gather of 2^20 f64 alone "
          f"{ms['NCCL all_gather of 2^20 f64, one rank']:.4f} ms; "
          f"{time.perf_counter() - t0:.1f} s | {card}", flush=True)

    t0 = time.perf_counter()
    e19 = BatchedEvaluator(cheb19, dtype=torch.float32, device=DEVICE)
    e19m = BatchedEvaluator(cheb19, dtype=torch.float32, mesh=dp,
                            device=DEVICE)
    want19 = e19(pts32)
    torch.cuda.synchronize()
    fused_eval.launches = 0
    got19 = checked(e19m(pts32), (N,), "meshed 19^5 f32")
    torch.cuda.synchronize()
    k2 = fused_eval.launches
    check(k2 > 0, "the meshed 19^5 f32 engine never launched K2")
    check(torch.equal(got19, want19),
          "meshed 19^5 f32 is not bitwise the engine without a mesh")
    ms["dp mesh f32 value 19^5, one rank"] = cuda_ms(lambda: e19m(pts32))
    ms["no mesh f32 value 19^5"] = cuda_ms(lambda: e19(pts32))
    print(f"[45 dp K2] 19^5 f32 engine at N=2^20 on the mesh: bitwise the "
          f"engine without one; K2 launches {k2}; "
          f"{ms['dp mesh f32 value 19^5, one rank']:.4f} vs "
          f"{ms['no mesh f32 value 19^5']:.4f} ms; "
          f"{time.perf_counter() - t0:.1f} s | {card}", flush=True)
    return k1, k2, k3


def mesh_paths(card: str, ms: dict, meshes, cheb, slider, tt):
    """Phases 46-49: tp (and dd tp beyond the single-device budget), dp
    box integrals and grouped-dd TT bucket masses, the sharded book,
    the slider's TT served dp."""
    dp = meshes["dp"]
    t0 = time.perf_counter()
    nodes, weights, diffs = cheb._grid_tuples()
    pts64 = torch.tensor(with_node_hits(sample_points(N, SEED + 81),
                                        cheb._nodes_np()), device=DEVICE)
    delta = (1, 0, 0, 0, 0)
    tp = checked(sharding.eval_batch_tp(
        cheb.tensor_values, nodes, weights, diffs, pts64, meshes["dp_tp"],
        orders=delta), (N,), "tp d/dS")
    d_tp = dev(tp, cheb.eval_batch_device(pts64, delta))
    check(d_tp <= F64_CEILING, f"tp d/dS vs eval_batch_device {d_tp:.3e}")
    check(not eval_dd.supports_dd(WIDE)
          and not sharding.dd_tp_plan(WIDE, 1)["ok"]
          and sharding.dd_tp_plan(WIDE, 4)["ok"],
          "the (9, 16400) grid's dd plans are not the reference's")
    tensor, xs, ws = wide_operands(DEVICE)
    try:
        sharding.eval_batch_dd_tp(tensor, xs, ws, ((), ()), pts64[:64, :2],
                                  meshes["dp_tp"])
        refused = False
    except ValueError as exc:
        refused = "outside the tp digit-GEMM budget on 1 devices" in str(exc)
    check(refused, "dd tp of (9, 16400) at tp = 1 was not refused")
    print(f"[46 tp] 11^5 d/dS at N=2^20 with node hits on a ('dp', 'tp') "
          f"(1, 1) mesh vs eval_batch_device {d_tp:.3e} <= "
          f"{F64_CEILING:g}; dd tp of (9, 16400), outside supports_dd: "
          f"refused at tp = 1 as the reference refuses it (its tp = 4 run "
          f"is phase 53's); {time.perf_counter() - t0:.1f} s | {card}",
          flush=True)

    t0 = time.perf_counter()
    boxes = random_boxes(NB, SEED + 83, DOMAIN)
    ib = checked(sharding.integrate_box_batch_dp(
        cheb.tensor_values, DOMAIN, boxes, dp), (NB,), "dp box integrals")
    want_ib = integrate_ops.integrate_box_batch(cheb.tensor_values, DOMAIN,
                                                boxes)
    check(torch.equal(ib, want_ib),
          "dp box integrals are not bitwise the call without a mesh")
    tt_boxes = random_boxes(NB, SEED + 84, TT_DOMAIN)
    shapes = tt_eval.core_shapes(tt._coeff_cores)
    groups = tt_eval_dd.tt_dd_auto_groups(shapes)
    if groups is None or set(groups) == {1}:
        groups = (2,) + (1,) * (len(shapes) - 2)
    masses = checked(sharding.tt_integrate_box_batch_dd_dp(
        tt._coeff_cores, TT_DOMAIN, tt_boxes, dp, groups=groups), (NB,),
        "dp TT bucket masses")
    want_masses = integrate_ops.tt_integrate_box_batch_dd(
        [torch.tensor(c, device=DEVICE) for c in tt._coeff_cores],
        TT_DOMAIN, tt_boxes, groups=groups)
    check(torch.equal(masses, want_masses),
          "dp TT bucket masses are not bitwise the call without a mesh")
    ms["dp mesh box integrals 2^17, one rank"] = cuda_ms(
        lambda: sharding.integrate_box_batch_dp(cheb.tensor_values, DOMAIN,
                                                boxes, dp))
    print(f"[47 dp integrals] 11^5 box integrals over 2^17 boxes bitwise "
          f"the call without a mesh "
          f"({ms['dp mesh box integrals 2^17, one rank']:.4f} ms); rank-15 "
          f"TT dd bucket masses (groups {groups}) over 2^17 boxes bitwise; "
          f"{time.perf_counter() - t0:.1f} s | {card}", flush=True)

    t0 = time.perf_counter()
    book = build_book(book_torch, 5, DOMAIN, [11] * 5,
                      num_models=len(BOOK_YIELDS), mesh=dp, device=DEVICE)
    plain_book = build_book(book_torch, 5, DOMAIN, [11] * 5,
                            num_models=len(BOOK_YIELDS), device=DEVICE)
    d_book = max(dev(a.tensor_values, b.tensor_values)
                 for a, b in zip(book, plain_book))
    check(d_book <= F64_CEILING, f"sharded book vs host book {d_book:.3e}")
    b_pts = pts64[:1 << 17]
    served = checked(MultiModelEvaluator(book, dtype=torch.float64, mesh=dp,
                                         device=DEVICE)(b_pts),
                     (len(book), b_pts.shape[0]), "meshed book engine")
    check(torch.equal(served, MultiModelEvaluator(
        book, dtype=torch.float64, device=DEVICE)(b_pts)),
        "the meshed book engine is not bitwise the one without a mesh")
    slider_tt = slider.to_tt()
    s_pts = torch.tensor(sample_points(1 << 17, SEED + 85,
                                       [(-1.0, 1.0)] * SLIDER_D),
                         device=DEVICE)
    s_mesh = checked(BatchedEvaluator(slider_tt, dtype=torch.float64,
                                      mesh=dp, device=DEVICE)(s_pts),
                     (1 << 17,), "slider -> TT on the mesh")
    check(torch.equal(s_mesh, BatchedEvaluator(
        slider_tt, dtype=torch.float64, device=DEVICE)(s_pts)),
        "the slider's TT on the mesh is not bitwise without it")
    print(f"[48 book] six-model build_book of book_torch over 11^5, grid "
          f"rows sharded on the card, vs the host oracle's book "
          f"{d_book:.3e} <= {F64_CEILING:g}; its MultiModelEvaluator on the "
          f"mesh at 2^17 bitwise without one; {time.perf_counter() - t0:.1f}"
          f" s | {card}", flush=True)
    print(f"[49 slider -> TT dp] config 4's slider to_tt served f64 on the "
          f"mesh at 2^17, bitwise without one | {card}", flush=True)


def mesh_fits_and_builds(card: str, ms: dict, meshes):
    """Phases 50-52: the dense fits at the main path's sizes, the TT
    build and completion, the one-stage pipeline."""
    dp = meshes["dp"]
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    lines = []
    for engine, n in MESH_FITS:
        pts = np.stack([rng.uniform(a, b, n) for a, b in FIT_DOMAIN], axis=1)
        y = fit_target_np(pts) + rng.normal(0, FIT_NOISE, n)
        kw = dict(l2=1e-8, engine=engine, device=DEVICE)
        plain, plain_s = timed_s(lambda: ChebyshevApproximation.fit(
            pts, y, 3, FIT_DOMAIN, FIT_NODES, **kw))
        meshed, mesh_s = timed_s(lambda: ChebyshevApproximation.fit(
            pts, y, 3, FIT_DOMAIN, FIT_NODES, mesh=dp, **kw))
        same = torch.equal(meshed.tensor_values, plain.tensor_values)
        d_fit = dev(meshed.tensor_values, plain.tensor_values)
        if engine == "device-dd":
            check(same, "the meshed device-dd fit is not bitwise")
        check(d_fit <= F32_CEILING, f"meshed {engine} fit {d_fit:.3e}")
        ms[f"dense fit {engine} on the mesh, {n:,} samples"] = mesh_s * 1e3
        lines.append(f"{engine} {n:,} samples: {mesh_s:.3f} s vs "
                     f"{plain_s:.3f} s without a mesh, "
                     f"{'bitwise' if same else f'{d_fit:.3e}'}")
    print(f"[50 fits] 9^3 dense fit on the mesh: " + "; ".join(lines)
          + f"; {time.perf_counter() - t0:.1f} s | {card}", flush=True)

    t0 = time.perf_counter()
    builds = {}
    for meshed in (False, True):
        tt = ChebyshevTT(arith_np, 3, GLOO_DOMAIN, MESH_TT_NODES, max_rank=5,
                         vectorized=True, device=DEVICE)
        tt.build(verbose=False, seed=0, mesh=dp if meshed else None)
        built = [np.array(c) for c in tt._coeff_cores]
        tt.run_completion(max_iter=3, mesh=dp if meshed else None)
        builds[meshed] = built, tt
    same_build = all(np.array_equal(a, b)
                     for a, b in zip(builds[True][0], builds[False][0]))
    same_completion = all(np.array_equal(a, b) for a, b in zip(
        builds[True][1]._coeff_cores, builds[False][1]._coeff_cores))
    check(same_build and same_completion,
          "the TT build or completion on the mesh is not bitwise")
    tt = builds[True][1]
    pts = torch.tensor(sample_points(1 << 16, SEED + 86, GLOO_DOMAIN),
                       device=DEVICE)
    cores = [torch.tensor(c, device=DEVICE) for c in tt._coeff_cores]
    pp = checked(tt_eval_batch_pp(cores, GLOO_DOMAIN, pts, meshes["pp"]),
                 (1 << 16,), "one-stage pipeline")
    d_pp = dev(pp, tt_eval.tt_eval_batch(cores, GLOO_DOMAIN, pts))
    check(d_pp <= F64_CEILING, f"one-stage pipeline vs chain {d_pp:.3e}")
    print(f"[51 TT build] cross on {MESH_TT_NODES} nodes with the oracle's "
          f"batches on the mesh, and run_completion on it: bitwise the "
          f"builds without one (ranks {tt.tt_ranks}) | {card}", flush=True)
    print(f"[52 pipeline] tt_eval_batch_pp, one stage, 2^16 points vs "
          f"tt_eval_batch {d_pp:.3e} <= {F64_CEILING:g}; "
          f"{time.perf_counter() - t0:.1f} s | {card}", flush=True)


def gloo_world(card: str, cuda_check: bool = True) -> None:
    """Phase 53: a 4-rank gloo world on the host's CPU: dp, tp (2, 2),
    a four-stage pipeline, a sharded book, a sharded TT build and a
    device-dd fit over ten chunks, held to the port's single-device
    results on the CPU."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as scratch:
        out = Path(scratch) / "gloo.npz"
        run_world(gloo_rank, GLOO_RANKS, (str(out), cuda_check),
                  deadline_s=300)
        with np.load(out) as f:
            got = dict(f)
    world_s = time.perf_counter() - t0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # as each rank: the GEMMs' order
    try:
        want = {k: v.numpy() for k, v in gloo_results(lambda *_: None)
                .items()}
    finally:
        torch.set_num_threads(threads)
    if cuda_check:
        check(int(got.pop("cuda_under_gloo_refused")) == 1,
              "a CUDA tensor under the gloo group was not refused")
    check(set(got) == set(want), "the gloo world returned other results")
    devs = {k: dev(got[k], want[k]) for k in ("dp", "tp", "pp", "dd_tp")}
    check(max(devs["dp"], devs["tp"], devs["pp"]) <= F64_CEILING
          and devs["dd_tp"] <= DD_TP_VS_F64, f"gloo world {devs}")
    exact = [k for k in want if k.startswith(("tt_core", "book", "fit"))]
    for k in exact:
        check(np.array_equal(got[k], want[k]),
              f"gloo world {k} is not bitwise one device's")
    print(f"[53 gloo world] {GLOO_RANKS} ranks on the CPU in {world_s:.1f} "
          f"s: dp {devs['dp']:.3e}, tp (2, 2) of d2/dx0dx2 {devs['tp']:.3e}, "
          f"4-stage pipeline {devs['pp']:.3e} (<= {F64_CEILING:g}), dd tp "
          f"of (9, 16400) over tp = 4 vs f64 {devs['dd_tp']:.3e} (<= "
          f"{DD_TP_VS_F64:g}); "
          f"{', '.join(exact)} bitwise one device's"
          + ("; a CUDA tensor under the gloo group refused"
             if cuda_check else "") + f" | {card}", flush=True)


# ---------------------------------------------------------------------------
# 54-56. Autodiff through the plain f64 path, the kernel routes' refusal of
# a gradient, and every example of examples_torch/ on the card.
# ---------------------------------------------------------------------------

AD_VS_SPECTRAL = 1e-9          # autograd vs the spectral derivative specs
AD_TENSOR_VS_CPU = 1e-12       # the tensor gradient, card vs CPU
AD_POINTS = 1 << 16
EXAMPLES = ("black_scholes_5d", "spline_kink_2d", "tensor_train_5d",
            "slider_10d", "portfolio_proxy", "calibration_autodiff",
            "serving_engine", "greek_report", "near_f64_tiers",
            "interconversion", "scenario_calculus", "global_calculus",
            "fit_scattered", "multi_chip", "fdm_baseline",
            "compressed_serving")


def autodiff(card: str, ms: dict, cheb) -> None:
    """Phase 54: ``torch.autograd`` and ``torch.func`` through
    ``ops.eval.eval_batch`` (f64) on the 11^5 interpolant, held to its
    spectral derivative specs, the tensor gradient to the CPU's; forward
    alone against forward plus backward at 2^20."""
    nodes, weights, diffs = cheb._grid_tuples()
    tensor = cheb.tensor_values
    zero = (0,) * 5

    def value(pts, t=tensor):
        return eval_ops.eval_batch(t, nodes, weights, diffs, pts, zero)

    pts = torch.tensor(sample_points(AD_POINTS, SEED + 54), device=DEVICE,
                       requires_grad=True)
    (grad,) = torch.autograd.grad(value(pts).sum(), pts)
    checked(grad, (AD_POINTS, 5), "autograd gradient")
    firsts = [tuple(int(i == d) for i in range(5)) for d in range(5)]
    d_grad = max(dev(grad[:, d], cheb.eval_batch_device(pts.detach(), o))
                 for d, o in enumerate(firsts))
    check(d_grad <= AD_VS_SPECTRAL, f"gradient vs spectral {d_grad:.3e}")
    few = pts.detach()[:4]
    d_hess = 0.0
    for p in few:
        hess = torch.func.hessian(lambda x: value(x[None, :])[0])(p)
        spec = torch.stack([torch.stack([cheb.eval_batch_device(
            p[None, :], [int(i == a) + int(i == b) for i in range(5)])[0]
            for b in range(5)]) for a in range(5)])
        d_hess = max(d_hess, dev(hess, spec))
    check(d_hess <= AD_VS_SPECTRAL, f"Hessian vs spectral {d_hess:.3e}")
    vm = torch.func.vmap(torch.func.grad(lambda x: value(x[None, :])[0]))(
        pts.detach()[:4096])
    d_vmap = dev(vm, grad[:4096])
    check(d_vmap <= AD_TENSOR_VS_CPU, f"vmap(grad) vs autograd {d_vmap:.3e}")
    sub = pts.detach()[:4096]
    # A target of half the values keeps the residuals at the values'
    # scale: a residual far smaller than the values would amplify the
    # two devices' f64 rounding of the values themselves.
    target = 0.5 * cheb.eval_batch_device(sub)

    def tensor_grad(t, p, on):
        t = t.detach().clone().requires_grad_(True)
        grid = [tuple(a.to(on) for a in group)
                for group in (nodes, weights, diffs)]
        out = eval_ops.eval_batch(t, *grid, p.to(on), zero)
        return torch.autograd.grad(((out - target.to(on)) ** 2).sum(), t)[0]
    d_tensor = dev(tensor_grad(tensor, sub, DEVICE),
                   tensor_grad(tensor.cpu(), sub, "cpu"))
    check(d_tensor <= AD_TENSOR_VS_CPU, f"tensor gradient, card vs CPU "
                                        f"{d_tensor:.3e}")
    big = torch.tensor(sample_points(N, SEED + 55), device=DEVICE)

    def forward():
        with torch.no_grad():
            return value(big)

    def forward_backward():
        x = big.clone().requires_grad_(True)
        return torch.autograd.grad(value(x).sum(), x)[0]
    ms["f64 forward (eval_batch)"] = cuda_ms(forward)
    ms["f64 forward + backward (autograd.grad)"] = cuda_ms(forward_backward)
    ratio = (ms["f64 forward + backward (autograd.grad)"]
             / ms["f64 forward (eval_batch)"])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[54 autodiff] 11^5, f64 ops.eval.eval_batch: autograd gradient "
          f"at 2^16 points vs the five first-order specs {d_grad:.3e}, "
          f"Hessian at 4 points vs the second-order specs {d_hess:.3e} (<= "
          f"{AD_VS_SPECTRAL:g}); vmap(grad) vs autograd on 4,096 points "
          f"{d_vmap:.3e}, tensor gradient card vs CPU {d_tensor:.3e} (<= "
          f"{AD_TENSOR_VS_CPU:g}); at 2^20 forward "
          f"{ms['f64 forward (eval_batch)']:.3f} ms, forward + backward "
          f"{ms['f64 forward + backward (autograd.grad)']:.3f} ms "
          f"({ratio:.2f}x; peak allocated {peak:.1f} GiB) | {card}",
          flush=True)


def refusals(card: str, cheb, cheb19) -> None:
    """Phase 55: K1, K2 and K3 refuse a tensor that requires grad, with
    their launch counters still; under ``torch.no_grad()`` each serves
    its plain version's values as before."""
    cases = []
    for name, model, dtype, fn, ref, tol in (
            ("K1 11^5", cheb, torch.float32, fused_eval.fused_eval_batch,
             fused_eval.fused_eval_batch_reference, K1_VS_PLAIN),
            ("K2 19^5", cheb19, torch.float32, fused_eval.fused_eval_batch,
             fused_eval.fused_eval_batch_reference, K1_VS_PLAIN),
            ("K3 11^5", cheb, torch.float64, fused_dd.fused_eval_batch_dd,
             fused_dd.fused_eval_batch_dd_reference, K3_VS_PLAIN)):
        nodes, weights, diffs = model._grid_tuples()
        pts = torch.tensor(sample_points(65_536, SEED + 56), dtype=dtype,
                           device=DEVICE)
        for which in ("tensor", "points"):
            t = model.tensor_values.clone().requires_grad_(which == "tensor")
            p = pts.clone().requires_grad_(which == "points")
            before = (fused_eval.launches, fused_dd.launches)
            try:
                fn(t, nodes, weights, diffs, p)
                refused = False
            except RuntimeError as exc:
                refused = "has no gradient" in str(exc)
            check(refused, f"{name} served a {which} that requires grad")
            check((fused_eval.launches, fused_dd.launches) == before,
                  f"{name}: a refused call moved a launch counter")
        wanting = model.tensor_values.clone().requires_grad_(True)
        with torch.no_grad():
            out = checked(fn(wanting, nodes, weights, diffs, pts),
                          (pts.shape[0],), f"{name} under no_grad")
        plain = ref(model.tensor_values, nodes, weights, diffs, pts)
        d = dev(out, plain)
        check(d <= tol, f"{name} under no_grad vs plain {d:.3e}")
        cases.append(f"{name} {d:.3e} <= {tol:g}")
    print(f"[55 refusals] K1, K2 and K3 refuse a tensor or points that "
          f"require grad (RuntimeError, no launch); under no_grad vs plain "
          f"on 65,536 points: {'; '.join(cases)} | {card}", flush=True)


def load_example(name):
    """``examples_torch/<name>.py`` as the module ``examples_torch_<name>``
    (loaded by path: the JAX package's examples share the base names)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def examples(card: str):
    """Phase 56: every example's ``main(device="cuda")`` in turn, its
    printed lines kept aside (shown if it fails) and checked for NaN.
    Returns the K1 and K3 launches the examples made (from zero)."""
    import contextlib
    import io
    k1 = k3 = 0
    for name in EXAMPLES:
        buf = io.StringIO()
        fused_eval.launches = 0
        fused_dd.launches = 0
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                result = load_example(name).main(device=DEVICE)
            torch.cuda.synchronize()
        except Exception:
            print(buf.getvalue(), flush=True)
            raise
        seconds = time.perf_counter() - t0
        k1 += fused_eval.launches
        k3 += fused_dd.launches
        out = buf.getvalue()
        check(bool(out.strip()), f"example {name} printed nothing")
        check("nan" not in out.lower(), f"example {name} printed a NaN")
        check(all(np.isfinite(float(v)) for v in result.values()),
              f"example {name} returned a non-finite number")
        numbers = ", ".join(f"{k} {float(v):.4g}" for k, v in result.items())
        print(f"[56 example] {name}: {seconds:.2f} s, "
              f"{len(out.splitlines())} lines, K1 {fused_eval.launches} K3 "
              f"{fused_dd.launches} launches; {numbers} | {card}",
              flush=True)
    return k1, k3


BENCH_REPS = 5
#: Rows phase 57 leaves to ``python3 bench_torch.py`` alone: the host
#: NumPy searches, no card in their timed calls, one call of which took
#: 48-51 s (the 10-D TT search), 34-36 s (31^3) and 353-399 s (25^4) on
#: the card's hosts (H100 80GB HBM3 machines, 700 W).  Without the 25^4
#: isolation alone this script took 1,028 s of its 1,200.
BENCH_ALONE = ("ttmin10d_", "zeros_")
#: The rows of the scripts beyond bench.py, the baseline table and the
#: calculus benches: the fits, global calculus, the TT search, zero
#: isolation and the grouped TT chains.
SCRIPT_ROWS = ("fit3d_", "ttfit5d_", "global_", "ttmin10d_", "zeros_",
               "bs5d_to_tt_dd_book6_", "bs5d_11n_to_tt_perdim_",
               "bs5d_11n_to_tt_g", "bs5d_11n_to_tt_trim_", "highd_")


def bench_rows(card: str):
    """Phase 57: ``bench_torch.main(device="cuda")`` at full widths with
    ``BENCH_REPS`` timed calls a row, every row but ``BENCH_ALONE``'s,
    its standard output held aside: every line parses, every row is
    there and holds its ceiling, K1 and K3 launched on their rows.
    Returns the K1 and K3 launches of the run (from zero)."""
    import contextlib
    import io

    import bench_torch
    selected = [base for base, _ in bench_torch.ROWS
                if not base.startswith(BENCH_ALONE)]
    buf = io.StringIO()
    fused_eval.launches = 0
    fused_dd.launches = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            bench_torch.main(device=DEVICE, reps=BENCH_REPS, rows=selected)
    finally:
        k1, k3 = fused_eval.launches, fused_dd.launches
        for line in buf.getvalue().splitlines():
            print(f"[57 bench] {line}", flush=True)
    seconds = time.perf_counter() - t0
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    rows = [line for line in lines if "metric" in line]
    names = [row["metric"] for row in rows]
    check(names == selected, f"bench_torch rows {names}")
    for row in rows:
        check(row["ok"] and row["deviation"] <= row["ceiling"],
              f"bench_torch {row['metric']}: {row}")
    for base in bench_torch.KERNEL_ROWS:
        check(next(r for r in rows if r["metric"] == base)["launches"] > 0,
              f"bench_torch {base} never launched its kernel")
    check(lines[-1] == {"ok": True, "rows": len(selected), "failed": []},
          f"bench_torch last line {lines[-1]}")
    busy = sum(1 for line in lines if "busy_share" in line)
    hosts = {row["host_cpu"] for row in rows if "host_cpu" in row}
    scripts = [row for row in rows if row["metric"].startswith(SCRIPT_ROWS)]
    alone = len(bench_torch.ROWS) - len(selected)
    print(f"[57 bench_torch] {len(rows)} rows at full widths ({alone} left "
          f"to the benchmark alone: {', '.join(BENCH_ALONE)}), "
          f"{len(scripts)} of them from the rest of scripts/ "
          f"({sum(row['row_s'] for row in scripts):.1f} s), at most "
          f"{BENCH_REPS} timed calls each, every line parsed, every row "
          f"within its ceiling, {busy} busy-share lines; K1 {k1} K3 {k3} "
          f"launches; host rows on {', '.join(sorted(hosts))}; "
          f"{seconds:.1f} s | {card}", flush=True)
    return k1, k3


def hardware_counterparts(card: str, cheb) -> None:
    """Phase 58: the checks of the JAX package's on-chip tests
    (``tests/test_tpu_hardware.py``) that no other phase holds: the
    21-node grid's finiteness, the kernels' operand caches under an
    in-place edit, the TT core cache, the TT dd tier's fast mode, and a
    dd Greek report on a slider with a two-dim slide."""
    # The 21^5 grid (tests/test_tpu_hardware.py:156-174): values finite
    # on every route, f64 within 1e-6 of the analytic price.
    cheb21 = ChebyshevApproximation(bs_price_np, 5, DOMAIN, [21] * 5,
                                    vectorized=True, device=DEVICE)
    cheb21.build(verbose=False)
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(lo, hi, 512) for lo, hi in DOMAIN], axis=1)
    exact = bs_price_np(pts)
    keep = np.abs(exact) > 1.0
    f64 = checked(cheb21.eval_batch_device(pts), (512,), "21^5 f64")
    rel = float((np.abs(_host_f64(f64) - exact)[keep]
                 / np.abs(exact)[keep]).max())
    check(rel < 1e-6, f"21^5 f64 vs the analytic price {rel:.3e}")
    before = (fused_eval.launches, fused_dd.launches)
    f32 = checked(cheb21.eval_batch_f32(pts), (512,), "21^5 f32 (K1)")
    dd = checked(cheb21.eval_batch_dd(pts), (512,), "21^5 dd (K3)")
    check((fused_eval.launches, fused_dd.launches)
          == (before[0] + 1, before[1] + 1), "21^5 did not launch K1 and K3")
    d21 = (dev(f32, f64), dev(dd, f64))
    check(d21[0] <= F32_CEILING and d21[1] <= DD_CEILING,
          f"21^5 K1 / K3 vs f64 {d21}")

    # The operand caches under an in-place edit (test_tpu_hardware.py
    # :224-238): the same tensor object, edited, must not hit the cache.
    nodes, weights, diffs = cheb._grid_tuples()
    sub = torch.tensor(sample_points(512, SEED + 58), device=DEVICE)
    worst_cache = 0.0
    for fn, points, ceiling in (
            (fused_eval.fused_eval_batch, sub.float(), F32_CEILING),
            (fused_dd.fused_eval_batch_dd, sub, DD_CEILING)):
        t = cheb.tensor_values.clone()
        first = fn(t, nodes, weights, diffs, points)
        t += 5.0
        second = fn(t, nodes, weights, diffs, points)
        d = dev(second, first + 5.0)
        check(d <= ceiling, f"{fn.__name__} after an in-place edit {d:.3e}")
        worst_cache = max(worst_cache, d)

    # The TT core cache (test_tpu_hardware.py:240-250): a second batch is
    # served from the cached device cores, bitwise the first.
    tt = ChebyshevTT(lambda x, _: x[0] * x[1] + x[2], 3, [[-1, 1]] * 3,
                     [9, 9, 9], max_rank=4, device=DEVICE)
    tt.build(verbose=False)
    tpts = np.random.default_rng(3).uniform(-0.9, 0.9, (1024, 3))
    a, b = tt.eval_batch(tpts), tt.eval_batch(tpts)
    check(torch.equal(a, b), "TT eval_batch twice differs")
    check(tt._cores_on_device(torch.float64)
          is tt._cores_on_device(torch.float64), "TT core cache missed")
    d_tt = dev(a, tpts[:, 0] * tpts[:, 1] + tpts[:, 2])
    check(d_tt <= F64_CEILING, f"TT x0 x1 + x2 {d_tt:.3e}")

    # The TT dd tier's fast mode (test_tpu_hardware.py:275-285).
    tt4 = ChebyshevTT(lambda x, _: np.exp(-x[:, 0]) * np.sin(x.sum(axis=1)),
                      4, [[0, 1]] * 4, [9] * 4, max_rank=8, vectorized=True,
                      device=DEVICE)
    tt4.build(verbose=False, seed=2)
    fpts = np.random.default_rng(5).uniform(0.05, 0.95, (1024, 4))
    d_fast = dev(checked(tt4.eval_batch_dd(fpts, mode="fast"), (1024,),
                         "TT dd fast"), tt4.eval_batch(fpts))
    check(d_fast <= DD_CEILING, f"TT dd fast vs f64 {d_fast:.3e}")

    # A dd Greek report on a 6-D slider with a two-dim slide, with a
    # cross-slide spec (test_tpu_hardware.py:327-350).
    slider = ChebyshevSlider(
        lambda p, _: (np.sum(np.sin(p), axis=1) + 0.2 * np.sum(p ** 2,
                                                                axis=1)),
        6, [[-1.0, 1.0]] * 6, [9] * 6, [[0, 1]] + [[i] for i in range(2, 6)],
        [0.0] * 6, vectorized=True, device=DEVICE)
    slider.build(verbose=False)
    specs = [(0,) * 6, (1, 0, 0, 0, 0, 0), (0, 0, 1, 0, 0, 0),
             (0, 0, 1, 1, 0, 0)]
    spts = np.random.default_rng(17).uniform(-1, 1, (2048, 6))
    got = checked(MultiSpecEvaluator(slider, specs, dtype="dd",
                                     device=DEVICE)(spts),
                  (2048, len(specs)), "slider dd report")
    d_sl = 0.0
    for m, s in enumerate(specs):
        want = slider.eval_batch(spts, list(s))
        # the cross-slide spec is exactly zero in both
        d_sl = max(d_sl, dev(got[:, m], want) if np.abs(want).max() > 0
                   else float(got[:, m].abs().max()))
    check(d_sl <= DD_CEILING, f"slider dd report vs the class path "
                              f"{d_sl:.3e}")
    print(f"[58 on-chip tests] 21^5: f64 vs analytic {rel:.3e} < 1e-6, K1 "
          f"{d21[0]:.3e} and K3 {d21[1]:.3e} vs f64, all finite; K1 and K3 "
          f"after an in-place edit of their tensor {worst_cache:.3e}; TT "
          f"core cache bitwise, {d_tt:.3e}; TT dd fast {d_fast:.3e}; "
          f"slider dd report with a 2-D slide {d_sl:.3e} | {card}",
          flush=True)


def main() -> None:
    # 1. The device.
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"[1 device] {kind} x{torch.cuda.device_count()}; torch "
          f"{torch.__version__} CUDA {torch.version.cuda}; "
          f"allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"float32_matmul_precision="
          f"{torch.get_float32_matmul_precision()}", flush=True)
    print(card, flush=True)

    # 2. Build the kernels from this checkout's sources: one source,
    # csrc/fused_eval.cu, with the f32 (K1, K2) and f64 (K3) instances.
    t0 = time.perf_counter()
    lib = _build.load_library("fused_eval")
    print(f"[2 kernel build] {time.perf_counter() - t0:.3f} s -> "
          f"{Path(lib._name).relative_to(ROOT)} (fused_eval_f32, "
          f"fused_eval_f64); {build_report(lib)}", flush=True)

    # 3. Build the interpolant.
    t0 = time.perf_counter()
    cheb = ChebyshevApproximation(bs_price_np, 5, DOMAIN, [11] * 5,
                                  vectorized=True, device=DEVICE)
    cheb.build(verbose=False)
    torch.cuda.synchronize()
    print(f"[3 interpolant build] 11^5 = {cheb.n_evaluations:,} nodes in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    nodes, weights, diffs = cheb._grid_tuples()
    host_nodes = cheb._nodes_np()

    # 4. K1 against its plain version, on the card.
    max_abs = 0.0
    worst = 0.0
    cases = []
    for n, seed in ((N, SEED + 1), (1_000_003, SEED + 2)):
        pts = torch.tensor(with_node_hits(sample_points(n, seed), host_nodes),
                           dtype=torch.float32, device=DEVICE)
        for orders in ((0,) * 5, (1, 0, 0, 0, 0), (0, 0, 0, 0, 1)):
            cases.append((f"11^5 N={n} orders={orders}",
                          (cheb.tensor_values, nodes, weights, diffs),
                          pts, orders))
    rng = np.random.default_rng(SEED + 3)
    for shape in ((8, 9, 7), (3, 5, 7)):
        operands, grid = random_operands(shape, rng)
        pts = torch.tensor(
            with_node_hits(sample_points(100_003, SEED + 4,
                                         [(-1.0, 1.0)] * 3), grid),
            dtype=torch.float32, device=DEVICE)
        cases.append((f"{shape} N=100003 orders=(0, 1, 0)", operands, pts,
                      (0, 1, 0)))
    for name, operands, pts, orders in cases:
        before = fused_eval.launches
        out = checked(fused_eval.fused_eval_batch(*operands, pts, orders),
                      (pts.shape[0],), name)
        torch.cuda.synchronize()
        plain = fused_eval.fused_eval_batch_reference(*operands, pts, orders)
        check(fused_eval.launches == before + 1,
              f"{name}: the launch counter did not rise")
        d = dev(out, plain)
        check(d <= K1_VS_PLAIN, f"{name}: K1 vs plain {d:.3e} > "
                                f"{K1_VS_PLAIN:g}")
        worst = max(worst, d)
        max_abs = max(max_abs, float((out - plain).abs().max()))
    # The kernel's three TF32 passes, and one pass alone, emulated in
    # plain PyTorch on the card against the plain f32 version and f64.
    sub = cases[0][2][:65_536]
    packed = fused_eval._pack(cheb.tensor_values, nodes, weights, diffs,
                              (0,) * 5, (11,) * 5, torch.float32)
    ref64 = cheb.eval_batch_device(sub.double())
    emulated = {
        "3xTF32": fused_eval._matmul_3xtf32,
        "one-pass TF32": lambda a, b: (fused_eval._tf32_round(a)
                                       @ fused_eval._tf32_round(b))}
    emulation = "; ".join(
        f"{label} emulation vs plain {dev(got, plain):.3e}, vs f64 "
        f"{dev(got, ref64):.3e}"
        for label, matmul in emulated.items()
        for got, plain in [(fused_eval._contract_packed(
            *packed, (11,) * 5, sub, matmul=matmul),
            fused_eval._contract_packed(*packed, (11,) * 5, sub))])
    print(f"[4 K1 vs plain] {len(cases)} cases (11^5 at N=2^20 and "
          f"1,000,003 with node hits, orders value/d0/d4; (8,9,7), (3,5,7)): "
          f"max deviation {worst:.3e} <= {K1_VS_PLAIN:g}, max abs "
          f"{max_abs:.3e}; on 65,536 of those points: {emulation}",
          flush=True)

    # 5. f32 (K1 route) against f64, on the card.
    pts64 = torch.tensor(sample_points(N, SEED + 5), device=DEVICE)
    before = fused_eval.launches
    f32 = checked(cheb.eval_batch_f32(pts64), (N,), "eval_batch_f32")
    f64 = checked(cheb.eval_batch_device(pts64), (N,), "eval_batch_device")
    check(fused_eval.launches == before + 1,
          "eval_batch_f32 did not route through K1")
    d = dev(f32, f64)
    check(d <= F32_CEILING, f"f32 vs f64 {d:.3e} > {F32_CEILING:g}")
    print(f"[5 f32 vs f64] eval_batch_f32 (K1) vs eval_batch_device at "
          f"N=2^20: {d:.3e} <= {F32_CEILING:g}", flush=True)

    # 6. f64 on the card against the host single-point path.
    sub = pts64[:256]
    worst = 0.0
    for orders in ((0,) * 5, (1, 0, 0, 0, 0)):
        host = [cheb.vectorized_eval(p, list(orders))
                for p in sub.cpu().numpy()]
        worst = max(worst, dev(cheb.eval_batch_device(sub, orders), host))
    check(worst <= F64_CEILING, f"f64 vs host {worst:.3e}")
    print(f"[6 f64 vs host] 256 points, value and delta: {worst:.3e} <= "
          f"{F64_CEILING:g}", flush=True)

    # 7. The .pcb fixture, evaluated on the card.
    fixture = ChebyshevApproximation.load(
        ROOT / "tests" / "fixtures" / "approx_5d_bs.pcb", device=DEVICE)
    rows = np.loadtxt(ROOT / "tests" / "fixtures" / "approx_5d_bs.expected")
    got = fixture.eval_batch_device(rows[:, :-1])
    d = dev(got, rows[:, -1])
    check(d <= F64_CEILING, f".pcb fixture {d:.3e}")
    print(f"[7 .pcb fixture] {fixture.n_nodes} grid, {len(rows)} recorded "
          f"values: {d:.3e} <= {F64_CEILING:g}", flush=True)

    # 8. Serving: the main path's run, with the launch counts from zero.
    fused_eval.launches = 0
    e32 = BatchedEvaluator(cheb, dtype=torch.float32, device=DEVICE)
    e32.warmup()
    e64 = BatchedEvaluator(cheb, dtype=torch.float64, device=DEVICE)
    worst32 = worst64 = 0.0
    sizes = (1, 1000, 16387, N)
    for i, n in enumerate(sizes):
        req = sample_points(n, SEED + 10 + i)
        v32 = checked(e32(req), (n,), f"f32 engine N={n}")
        v64 = checked(e64(req), (n,), f"f64 engine N={n}")
        host = [cheb.vectorized_eval(p, [0] * 5) for p in req[:16]]
        worst64 = max(worst64, dev(v64[:16], host))
        worst32 = max(worst32, dev(v32, v64))
    greeks = MultiSpecEvaluator(cheb, GREEKS, dtype=torch.float64,
                                device=DEVICE)
    g = checked(greeks(pts64), (N, len(GREEKS)), "price + 5 Greeks")
    torch.cuda.synchronize()
    main_launches = fused_eval.launches
    worstg = max(dev(g[:16, k], [cheb.vectorized_eval(p, list(s))
                                 for p in pts64[:16].cpu().numpy()])
                 for k, s in enumerate(GREEKS))
    check(main_launches > 0, "BatchedEvaluator(f32) never launched K1")
    check(worst32 <= F32_CEILING, f"f32 engine vs f64 {worst32:.3e}")
    check(worst64 <= F64_CEILING, f"f64 engine vs host {worst64:.3e}")
    check(worstg <= F64_CEILING, f"Greeks engine vs host {worstg:.3e}")
    print(f"[8 serving] requests of {sizes}: f32 engine vs f64 engine "
          f"{worst32:.3e} <= {F32_CEILING:g}; f64 engine vs host "
          f"{worst64:.3e}; price+5 Greeks (f64, N=2^20) vs host "
          f"{worstg:.3e} <= {F64_CEILING:g}; K1 launches {main_launches}",
          flush=True)

    # 9. Timing at N = 2^20 (CUDA events, median of 15 after 3 warm-up).
    pts32 = pts64.float()
    greeks32 = MultiSpecEvaluator(cheb, GREEKS, dtype=torch.float32,
                                  device=DEVICE)
    runs = {
        "K1 f32 (fused_eval_batch)": lambda: fused_eval.fused_eval_batch(
            cheb.tensor_values, nodes, weights, diffs, pts32),
        "plain f32 (fused_eval_batch_reference)":
            lambda: fused_eval.fused_eval_batch_reference(
                cheb.tensor_values, nodes, weights, diffs, pts32),
        "f64 (eval_batch_device)": lambda: cheb.eval_batch_device(pts64),
        "price+5 Greeks f64 (MultiSpecEvaluator)": lambda: greeks(pts64),
        "price+5 Greeks f32 (MultiSpecEvaluator)": lambda: greeks32(pts32),
    }
    ms = {}
    for name, fn in runs.items():
        ms[name] = cuda_ms(fn)
        print(f"[9 timing] {name}: {ms[name]:.4f} ms per 2^20 points = "
              f"{N / ms[name] * 1e3:,.0f} /s | {card}", flush=True)

    # The 19^5 interpolant, for K3 (phase 10) and K2 (phase 13).
    t0 = time.perf_counter()
    cheb19 = ChebyshevApproximation(bs_price_np, 5, DOMAIN, [19] * 5,
                                    vectorized=True, device=DEVICE)
    cheb19.build(verbose=False)
    torch.cuda.synchronize()
    build19 = time.perf_counter() - t0
    nodes19, weights19, diffs19 = cheb19._grid_tuples()

    # 10. K3 against its plain version, on the card.
    k3_cases = []
    for n, seed in ((N, SEED + 1), (1_000_003, SEED + 2)):
        pts = torch.tensor(with_node_hits(sample_points(n, seed), host_nodes),
                           device=DEVICE)
        for orders in ((0,) * 5, (1, 0, 0, 0, 0), (0, 0, 0, 0, 1)):
            k3_cases.append((f"11^5 N={n} orders={orders}",
                             (cheb.tensor_values, nodes, weights, diffs),
                             pts, orders))
    rng = np.random.default_rng(SEED + 20)
    for shape, n, orders in (((8, 9, 7), 100_003, (0, 1, 0)),
                             ((3, 5, 7), 100_003, (0, 1, 0)),
                             ((17,) * 5, 65_537, (1, 0, 0, 0, 0))):
        operands, grid = random_operands(shape, rng)
        pts = torch.tensor(
            with_node_hits(sample_points(n, SEED + 21,
                                         [(-1.0, 1.0)] * len(shape)), grid),
            device=DEVICE)
        k3_cases.append((f"{shape} N={n} orders={orders}", operands, pts,
                         orders))
    k3_cases.append(("19^5 N=65536 orders=(0, 0, 0, 0, 0)",
                     (cheb19.tensor_values, nodes19, weights19, diffs19),
                     torch.tensor(with_node_hits(sample_points(65_536,
                                                               SEED + 22),
                                                 cheb19._nodes_np()),
                                  device=DEVICE), (0,) * 5))
    k3_worst = k3_abs = 0.0
    for name, operands, pts, orders in k3_cases:
        before = fused_dd.launches
        out = checked(fused_dd.fused_eval_batch_dd(*operands, pts, orders),
                      (pts.shape[0],), f"K3 {name}")
        torch.cuda.synchronize()
        plain = fused_dd.fused_eval_batch_dd_reference(*operands, pts, orders)
        check(out.dtype == torch.float64, f"K3 {name}: dtype {out.dtype}")
        check(fused_dd.launches == before + 1,
              f"K3 {name}: the launch counter did not rise")
        d = dev(out, plain)
        check(d <= K3_VS_PLAIN, f"K3 {name}: vs plain {d:.3e} > "
                                f"{K3_VS_PLAIN:g}")
        k3_worst = max(k3_worst, d)
        k3_abs = max(k3_abs, float((out - plain).abs().max()))
    print(f"[10 K3 vs plain] {len(k3_cases)} cases (11^5 at N=2^20 and "
          f"1,000,003 with node hits, orders value/d0/d4; (8,9,7), (3,5,7) "
          f"at 100,003; 17^5 at 65,537; 19^5 at 65,536 with node hits): "
          f"max deviation {k3_worst:.3e} <= "
          f"{K3_VS_PLAIN:g}, max abs {k3_abs:.3e} | {card}", flush=True)

    # 11. The dd tier against f64, on the card.
    worst_dd = worst_host = 0.0
    for mode in ("accurate", "fast"):
        before = fused_dd.launches
        dd = checked(cheb.eval_batch_dd(pts64, mode=mode), (N,),
                     f"eval_batch_dd {mode}")
        check(fused_dd.launches == before + 1,
              f"eval_batch_dd {mode} did not route through K3")
        worst_dd = max(worst_dd, dev(dd, f64))
        for orders in ((0,) * 5, (1, 0, 0, 0, 0)):
            host = [cheb.vectorized_eval(p, list(orders))
                    for p in sub.cpu().numpy()]
            worst_host = max(worst_host, dev(
                cheb.eval_batch_dd(sub, orders, mode=mode), host))
    check(worst_dd <= DD_CEILING, f"dd vs f64 {worst_dd:.3e}")
    check(worst_host <= F64_CEILING, f"dd vs host {worst_host:.3e}")
    ood = pts64[:4096].clone()
    ood[7, 0] = 130.0                      # S above its domain's 120
    before = fused_dd.launches
    got = checked(cheb.eval_batch_dd(ood), (4096,), "out-of-domain dd")
    check(fused_dd.launches == before,
          "an out-of-domain dd batch launched K3")
    check(dev(got, cheb.eval_batch_device(ood)) == 0.0,
          "an out-of-domain dd batch left the f64 path")
    print(f"[11 dd vs f64] eval_batch_dd (K3), modes accurate and fast: "
          f"vs eval_batch_device at N=2^20 {worst_dd:.3e} <= "
          f"{DD_CEILING:g}; vs host on 256 points, value and delta "
          f"{worst_host:.3e} <= {F64_CEILING:g}; out-of-domain batch on "
          f"the f64 path, K3 not launched | {card}", flush=True)

    # 12. dd serving: K3's main-path run, with its launch count from zero.
    fused_dd.launches = 0
    edd = BatchedEvaluator(cheb, dtype="dd", device=DEVICE)
    edd.warmup()
    worst_edd = 0.0
    for i, n in enumerate(sizes):
        req = sample_points(n, SEED + 10 + i)
        vdd = checked(edd(req), (n,), f"dd engine N={n}")
        worst_edd = max(worst_edd, dev(vdd, e64(req)))
    greeks_dd = MultiSpecEvaluator(cheb, GREEKS, dtype="dd", device=DEVICE)
    gdd = checked(greeks_dd(pts64), (N, len(GREEKS)), "dd price + 5 Greeks")
    torch.cuda.synchronize()
    k3_launches = fused_dd.launches
    worst_gdd = max(dev(gdd[:16, k], [cheb.vectorized_eval(p, list(s))
                                      for p in pts64[:16].cpu().numpy()])
                    for k, s in enumerate(GREEKS))
    check(k3_launches > 0, "the dd engines never launched K3")
    check(worst_edd <= DD_CEILING, f"dd engine vs f64 engine {worst_edd:.3e}")
    check(worst_gdd <= DD_CEILING, f"dd Greeks vs host {worst_gdd:.3e}")
    print(f"[12 dd serving] requests of {sizes}: dd engine vs f64 engine "
          f"{worst_edd:.3e}; price+5 Greeks (dd, N=2^20) vs host "
          f"{worst_gdd:.3e}; both <= {DD_CEILING:g}; K3 launches "
          f"{k3_launches} | {card}", flush=True)

    # 13. K2's grids through the f32 evaluator.
    fused_eval.launches = 0
    f32_19 = checked(cheb19.eval_batch_f32(pts64), (N,), "19^5 eval_batch_f32")
    torch.cuda.synchronize()
    k2_launches = fused_eval.launches
    check(k2_launches > 0, "19^5 eval_batch_f32 did not launch the kernel")
    sub19 = pts64[:65_536]
    plain19 = fused_eval.fused_eval_batch_reference(
        cheb19.tensor_values, nodes19, weights19, diffs19, sub19.float())
    k2_worst = dev(f32_19[:65_536], plain19)
    k2_abs = float((f32_19[:65_536] - plain19).abs().max())
    d19 = dev(f32_19[:65_536], cheb19.eval_batch_device(sub19))
    check(k2_worst <= K1_VS_PLAIN, f"19^5 vs plain {k2_worst:.3e}")
    check(d19 <= F32_CEILING, f"19^5 f32 vs f64 {d19:.3e}")
    rng = np.random.default_rng(SEED + 30)
    for shape in ((9,) * 6, (17,) * 5):
        operands, grid = random_operands(shape, rng)
        pts = torch.tensor(
            with_node_hits(sample_points(100_003, SEED + 31,
                                         [(-1.0, 1.0)] * len(shape)), grid),
            dtype=torch.float32, device=DEVICE)
        orders = (1,) + (0,) * (len(shape) - 1)
        before = fused_eval.launches
        out = checked(fused_eval.fused_eval_batch(*operands, pts, orders),
                      (pts.shape[0],), f"{shape}")
        torch.cuda.synchronize()
        check(fused_eval.launches == before + 1,
              f"{shape}: the launch counter did not rise")
        plain = fused_eval.fused_eval_batch_reference(*operands, pts, orders)
        d = dev(out, plain)
        check(d <= K1_VS_PLAIN, f"{shape} vs plain {d:.3e}")
        k2_worst = max(k2_worst, d)
        k2_abs = max(k2_abs, float((out - plain).abs().max()))
    print(f"[13 K2 grids] 19^5 = {cheb19.n_evaluations:,} nodes built in "
          f"{build19:.3f} s; eval_batch_f32 at N=2^20 launched the kernel "
          f"{k2_launches}x; vs plain on 65,536 points, and 9^6 / 17^5 at "
          f"100,003 (orders d0): max {k2_worst:.3e} <= {K1_VS_PLAIN:g}; "
          f"19^5 f32 vs f64 {d19:.3e} <= {F32_CEILING:g} | {card}",
          flush=True)

    # 14. Timing of the dd tier, K2's grid and the GEMM yardsticks at
    # N = 2^20 (CUDA events, median of 15 after 3 warm-up).  No PyTorch
    # call computes a kernel's whole function; each yardstick is the
    # contraction's GEMM alone, (N x k) @ (k x n_left), A formed before
    # the clock starts.  19^5's A (29 GB in f32) is timed at N = 2^18
    # and scaled by 4.
    pts19_32 = pts64.float()

    def gemm(n, k, m, dtype):
        g = torch.Generator(device=DEVICE).manual_seed(SEED)
        a = torch.rand((n, k), generator=g, dtype=dtype, device=DEVICE)
        b = torch.rand((k, m), generator=g, dtype=dtype, device=DEVICE)
        return lambda: torch.matmul(a, b)

    runs = {
        "K3 f64 (fused_eval_batch_dd)": lambda: fused_dd.fused_eval_batch_dd(
            cheb.tensor_values, nodes, weights, diffs, pts64),
        "plain f64 (fused_eval_batch_dd_reference)":
            lambda: fused_dd.fused_eval_batch_dd_reference(
                cheb.tensor_values, nodes, weights, diffs, pts64),
        "dd tier (eval_batch_dd)": lambda: cheb.eval_batch_dd(pts64),
        "price+5 Greeks dd (MultiSpecEvaluator)": lambda: greeks_dd(pts64),
        "K1 f32 at 19^5 (fused_eval_batch)":
            lambda: fused_eval.fused_eval_batch(
                cheb19.tensor_values, nodes19, weights19, diffs19, pts19_32),
        "K3 f64 at 19^5 (fused_eval_batch_dd)":
            lambda: fused_dd.fused_eval_batch_dd(
                cheb19.tensor_values, nodes19, weights19, diffs19, pts64),
        "plain f32 at 19^5 (fused_eval_batch_reference)":
            lambda: fused_eval.fused_eval_batch_reference(
                cheb19.tensor_values, nodes19, weights19, diffs19, pts19_32),
    }
    for name, fn in runs.items():
        ms[name] = cuda_ms(fn)
        print(f"[14 timing] {name}: {ms[name]:.4f} ms per 2^20 points = "
              f"{N / ms[name] * 1e3:,.0f} /s | {card}", flush=True)
    for name, (n, k, m, dtype, scale) in {
            "GEMM f32 11^5": (N, 1331, 121, torch.float32, 1),
            "GEMM f64 11^5": (N, 1331, 121, torch.float64, 1),
            "GEMM f32 19^5": (N // 4, 6859, 361, torch.float32, 4)}.items():
        ms[name] = scale * cuda_ms(gemm(n, k, m, dtype))
        torch.cuda.empty_cache()
        print(f"[14 timing] {name} (torch.matmul ({n} x {k}) @ ({k} x {m})"
              f"{' x 4' if scale > 1 else ''}): {ms[name]:.4f} ms = "
              f"{2 * N * k * m / ms[name] / 1e9:.2f} TFLOP/s | {card}",
              flush=True)

    # 15. TT build: rank-15 TT-Cross of the dividend-yield price.
    t0 = time.perf_counter()
    tt = ChebyshevTT(bs_div_np, 5, TT_DOMAIN, [11] * 5, max_rank=15,
                     tolerance=1e-6, max_sweeps=10, vectorized=True,
                     device=DEVICE)
    tt.build(verbose=False, seed=42)
    tt_build = time.perf_counter() - t0
    rng_tt = np.random.default_rng(42)
    tt_pts = np.stack([rng_tt.uniform(lo, hi, 50) for lo, hi in TT_DOMAIN],
                      axis=1)
    tt_exact = bs_div_np(tt_pts)
    keep = np.abs(tt_exact) >= 0.50
    tt_vals = checked(tt.eval_batch(tt_pts), (50,), "tt.eval_batch")
    tt_err = (np.abs((_host_f64(tt_vals) - tt_exact) / tt_exact)[keep]
              * 100.0)
    check(tt_err.max() <= TT_PRICE_ERR_MAX_PCT,
          f"TT price error {tt_err.max():.4f}% > {TT_PRICE_ERR_MAX_PCT}%")
    print(f"[15 TT build] 5-D price with q={TT_Q}, 11 nodes per dim, "
          f"max_rank=15, tolerance=1e-6, seed=42: ranks {tt.tt_ranks}, "
          f"{tt.total_build_evals:,} unique evaluations, {tt_build:.3f} s; "
          f"price error over {int(keep.sum())} of 50 seed-42 points "
          f"(|price| >= 0.50): mean {tt_err.mean():.4f}% max "
          f"{tt_err.max():.4f}% <= {TT_PRICE_ERR_MAX_PCT}%", flush=True)

    # 16. The C host path under both classes, against the NumPy paths.
    check(ceval.available(), "the C host library (cpp/hosteval.c) did not "
                             "build or load")
    host_pts = sample_points(64, SEED + 40)
    batch_pts = sample_points(1024, SEED + 41)
    harr = cheb._host_arrays()
    check(cheb._host_cpack(harr) is not None, "the dense class has no C "
                                              "pack")

    def dense_host():
        return (np.array([cheb.vectorized_eval(p, [0] * 5)
                          for p in host_pts]),
                np.array([cheb.vectorized_eval_multi(p, GREEKS)
                          for p in host_pts]),
                cheb.eval_batch_host(batch_pts, [0] * 5),
                cheb.eval_batch_host(batch_pts, [1, 0, 0, 0, 0]))

    c_single, c_multi, c_batch, c_batch_d = dense_host()
    us = {
        "dense eval (C)": host_us(
            lambda: cheb.vectorized_eval(host_pts[0], [0] * 5)),
        "dense eval_multi, 6 specs (C)": host_us(
            lambda: cheb.vectorized_eval_multi(host_pts[0], GREEKS)),
        "dense eval_batch_host per point (C)": host_us(
            lambda: cheb.eval_batch_host(batch_pts, [0] * 5),
            calls=5) / len(batch_pts),
        "TT eval (C)": host_us(lambda: tt.eval(tt_pts[0]), calls=2000),
    }
    pack = harr["cpack"]
    harr["cpack"] = None                    # the NumPy paths
    n_single, n_multi, n_batch, n_batch_d = dense_host()
    us["dense eval (NumPy)"] = host_us(
        lambda: cheb.vectorized_eval(host_pts[0], [0] * 5), calls=100)
    harr["cpack"] = pack
    value_cols = [k for k, spec in enumerate(GREEKS) if not any(spec)]
    deriv_cols = [k for k, spec in enumerate(GREEKS) if any(spec)]
    host_val = max(dev(c_single, n_single), dev(c_batch, n_batch),
                   dev(c_multi[:, value_cols], n_multi[:, value_cols]))
    host_der = max([dev(c_batch_d, n_batch_d)]
                   + [dev(c_multi[:, k], n_multi[:, k]) for k in deriv_cols])
    check(host_val <= HOST_C_VS_NUMPY,
          f"dense C path vs NumPy {host_val:.3e}")
    check(host_der <= HOST_C_VS_NUMPY_DERIV,
          f"dense C path vs NumPy, derivative specs {host_der:.3e}")
    check(tt._host_cpack() is not None, "the TT class has no C pack")
    tt_c = np.array([tt.eval(p) for p in tt_pts])
    tt_pack = tt.__dict__["_host_cpack_cache"]
    tt.__dict__["_host_cpack_cache"] = (tt_pack[0], None)   # NumPy chain
    tt_np = np.array([tt.eval(p) for p in tt_pts])
    us["TT eval (NumPy)"] = host_us(lambda: tt.eval(tt_pts[0]), calls=300)
    tt.__dict__["_host_cpack_cache"] = tt_pack
    host_tt = dev(tt_c, tt_np)
    check(host_tt <= HOST_C_VS_NUMPY, f"TT C path vs NumPy {host_tt:.3e}")
    print(f"[16 C host path] ceval.available(); 11^5 interpolant, 64 "
          f"points: eval, eval_multi (values) and eval_batch_host (1,024 "
          f"points) vs the NumPy path {host_val:.3e} <= "
          f"{HOST_C_VS_NUMPY:g}; derivative specs {host_der:.3e} <= "
          f"{HOST_C_VS_NUMPY_DERIV:g}; TT eval vs the NumPy chain "
          f"{host_tt:.3e} <= {HOST_C_VS_NUMPY:g}; microseconds per call: "
          + "; ".join(f"{k} {v:.1f}" for k, v in us.items()), flush=True)

    # 17. The TT chains on the card against the host chain.
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "allow_tf32 is on: the f32 chain's matmuls must be IEEE f32")
    tt_dom = np.asarray(tt.domain, dtype=np.float64)
    cores64 = tt._cores_on_device(torch.float64)
    cores32 = tt._cores_on_device(torch.float32)
    check(all(c.is_cuda for c in cores64 + cores32), "TT cores not on the "
                                                     "card")
    sub_tt = sample_points(4096, SEED + 42, TT_DOMAIN)
    host_chain = np.array([tt.eval(p) for p in sub_tt])
    d_f64 = dev(checked(tt.eval_batch(sub_tt), (4096,), "TT f64 chain"),
                host_chain)
    check(d_f64 <= F64_CEILING, f"TT f64 chain vs host {d_f64:.3e}")
    tt_pts64 = torch.tensor(sample_points(N, SEED + 43, TT_DOMAIN),
                            device=DEVICE)
    tt_pts32 = tt_pts64.float()
    chain64 = checked(tt_eval.tt_eval_batch(cores64, tt_dom, tt_pts64), (N,),
                      "TT f64 chain at 2^20")
    chain32 = checked(tt_eval.tt_eval_batch(cores32, tt_dom, tt_pts32), (N,),
                      "TT f32 chain at 2^20")
    check(chain32.dtype == torch.float32 and chain64.dtype == torch.float64,
          "TT chain dtypes")
    d_f32 = dev(chain32, chain64)
    check(d_f32 <= F32_CEILING, f"TT f32 chain vs f64 {d_f32:.3e}")
    mixed = tt_eval.tt_eval_batch(cores64, tt_dom, tt_pts32)
    check(mixed.dtype == torch.float64, "f32 points with f64 cores did not "
                                        "compute in f64")
    d_mixed = dev(mixed, tt_eval.tt_eval_batch(cores64, tt_dom,
                                               tt_pts32.double()))
    check(d_mixed <= F64_CEILING, f"f32 points, f64 cores {d_mixed:.3e}")
    d_grouped = max(
        dev(tt_eval.tt_eval_batch(cores64, tt_dom, tt_pts64, groups=g),
            chain64) for g in ((2, 2, 1), (1, 1, 1, 2), (5,)))
    check(d_grouped <= F64_CEILING, f"grouped vs per-dim {d_grouped:.3e}")
    lo_tt, hi_tt = tt_dom[:, 0], tt_dom[:, 1]
    ood_tt = lo_tt + (hi_tt - lo_tt) * np.random.default_rng(
        SEED + 44).uniform(-0.05, 1.05, size=(4096, 5))
    d_ood = dev(tt.eval_batch(ood_tt), [tt.eval(p) for p in ood_tt])
    check(d_ood <= F64_CEILING, f"out-of-domain chain vs host {d_ood:.3e}")
    print(f"[17 TT chains] rank-15 TT on the card: f64 eval_batch vs the "
          f"host chain on 4,096 points {d_f64:.3e} <= {F64_CEILING:g}; "
          f"f32 cores and points vs f64 at N=2^20 {d_f32:.3e} <= "
          f"{F32_CEILING:g} (allow_tf32 False); f32 points with f64 cores "
          f"compute in f64, {d_mixed:.3e}; grouped (2,2,1), (1,1,1,2), (5) "
          f"vs per-dim {d_grouped:.3e}; 4,096 points up to 5% outside the "
          f"domain vs the host chain {d_ood:.3e}; all <= {F64_CEILING:g} "
          f"| {card}", flush=True)

    # 18. Exact-compression serving: to_tt(1e-13) of the 11^5 interpolant.
    t0 = time.perf_counter()
    comp = cheb.to_tt(tolerance=1e-13)
    to_tt_s = time.perf_counter() - t0
    comp_shapes = tt_eval.core_shapes(comp._coeff_cores)
    auto_groups = tt_eval_dd.tt_dd_auto_groups(comp_shapes)
    comp_routes = {"auto": "auto", "per-dim": None, "(1,1,1,2)": (1, 1, 1, 2),
                   "(2,2,1)": (2, 2, 1)}
    d_comp = {}
    for label, groups in comp_routes.items():
        out = checked(comp.eval_batch_dd(pts64, groups=groups), (N,),
                      f"to_tt eval_batch_dd {label}")
        d_comp[label] = dev(out, f64)
        check(d_comp[label] <= F64_CEILING,
              f"to_tt chain {label} vs dense f64 {d_comp[label]:.3e}")
    got = checked(comp.eval_batch_dd(ood), (4096,), "to_tt out-of-domain")
    check(torch.equal(got, comp.eval_batch(ood)),
          "an out-of-domain to_tt dd batch left the f64 chain")
    d_comp_ood = dev(got, cheb.eval_batch_device(ood))
    print(f"[18 exact compression] to_tt(tolerance=1e-13) of the 11^5 "
          f"interpolant in {to_tt_s:.3f} s: ranks {comp.tt_ranks}; "
          f"eval_batch_dd at N=2^20 vs the dense f64 path: "
          + ", ".join(f"{k} {v:.3e}" for k, v in d_comp.items())
          + f"; all <= {F64_CEILING:g}; auto resolves to {auto_groups}; "
          f"out-of-domain batch on the f64 chain, {d_comp_ood:.3e} from "
          f"the dense f64 path | {card}", flush=True)

    # 19. TT serving: engines, the six-model book, the FD report.
    delta = [1, 0, 0, 0, 0]
    cheb_div = ChebyshevApproximation(bs_div_np, 5, TT_DOMAIN, [11] * 5,
                                      vectorized=True, device=DEVICE)
    cheb_div.build(verbose=False)
    tt_delta_host = tt.differentiate(delta)
    engines = {}
    worst_tt = {"f32 vs f64": 0.0, "f64 vs host": 0.0, "dd vs f64": 0.0,
                "delta vs differentiate on the host": 0.0}
    for spec_name, orders in (("value", None), ("delta", delta)):
        for tier, dtype in (("f32", torch.float32), ("f64", torch.float64),
                            ("dd", "dd")):
            engines[spec_name, tier] = BatchedEvaluator(
                tt, dtype=dtype, derivative_order=orders, device=DEVICE)
            engines[spec_name, tier].warmup()
        host_model = tt if orders is None else tt_delta_host
        for i, n in enumerate(sizes):
            req = sample_points(n, SEED + 50 + i, TT_DOMAIN)
            v = {tier: checked(engines[spec_name, tier](req), (n,),
                               f"TT {tier} engine {spec_name} N={n}")
                 for tier in ("f32", "f64", "dd")}
            host = [host_model.eval(p) for p in req[:16]]
            key = ("f64 vs host" if orders is None
                   else "delta vs differentiate on the host")
            worst_tt[key] = max(worst_tt[key], dev(v["f64"][:16], host))
            worst_tt["dd vs f64"] = max(worst_tt["dd vs f64"],
                                        dev(v["dd"], v["f64"]))
            if n >= 1000:
                worst_tt["f32 vs f64"] = max(worst_tt["f32 vs f64"],
                                             dev(v["f32"], v["f64"]))
    check(worst_tt["f32 vs f64"] <= F32_CEILING,
          f"TT f32 engine {worst_tt['f32 vs f64']:.3e}")
    for key in ("f64 vs host", "dd vs f64",
                "delta vs differentiate on the host"):
        check(worst_tt[key] <= F64_CEILING, f"TT engines, {key}: "
                                            f"{worst_tt[key]:.3e}")
    cross_value = dev(engines["value", "f64"](tt_pts64),
                      cheb_div.eval_batch_device(tt_pts64))
    cross_delta = dev(engines["delta", "f64"](tt_pts64),
                      cheb_div.eval_batch_device(tt_pts64, delta))
    check(cross_value <= TT_CROSS_VALUE, f"TT vs dense {cross_value:.3e}")
    check(cross_delta <= TT_CROSS_DELTA,
          f"TT delta vs the dense analytic delta {cross_delta:.3e}")
    ood_engine = engines["value", "dd"](ood_tt)
    check(torch.equal(ood_engine, engines["value", "f64"](ood_tt)),
          "an out-of-domain TT dd request left the f64 sibling")
    greek_models = [tt] + [tt.differentiate(list(s)) for s in GREEKS[1:]]
    books = {tier: MultiModelEvaluator(greek_models, dtype=dtype,
                                       device=DEVICE)
             for tier, dtype in (("f32", torch.float32),
                                 ("f64", torch.float64), ("dd", "dd"))}
    worst_book = {}
    for tier, book in books.items():
        book.warmup()
        out = checked(book(tt_pts64), (len(GREEKS), N), f"TT {tier} book")
        worst = 0.0
        for k, model in enumerate(greek_models):
            single = BatchedEvaluator(
                model, dtype=torch.float64, device=DEVICE)(tt_pts64)
            worst = max(worst, dev(out[k], single))
        worst_book[tier] = worst
        check(worst <= (F32_CEILING if tier == "f32" else F64_CEILING),
              f"TT {tier} book vs single engines {worst:.3e}")
    fd_pts = tt_pts64[:1 << 16]
    fd = checked(tt._eval_batch_multi_device(fd_pts, GREEKS),
                 (1 << 16, len(GREEKS)), "TT FD report")
    check(fd.is_cuda, "the FD report left the card")
    per_point = np.array([tt.eval_multi(p, GREEKS)
                          for p in fd_pts[:64].cpu().numpy()])
    d_fd = max(dev(fd[:64, k], per_point[:, k]) for k in range(len(GREEKS)))
    check(d_fd <= FD_REPORT, f"FD report vs eval_multi {d_fd:.3e}")
    print(f"[19 TT serving] BatchedEvaluator(tt) for value and delta, "
          f"requests of {sizes}: "
          + "; ".join(f"{k} {v:.3e}" for k, v in worst_tt.items())
          + f" (f32 <= {F32_CEILING:g}, the others <= {F64_CEILING:g}); "
          f"vs the dense 11^5 interpolant of the same function at N=2^20: "
          f"value {cross_value:.3e} <= {TT_CROSS_VALUE:g}, delta vs its "
          f"analytic delta {cross_delta:.3e} <= {TT_CROSS_DELTA:g} (the "
          f"cross build's accuracy); out-of-domain dd request on the f64 "
          f"sibling; book of price + 5 differentiate()d Greeks vs single "
          f"f64 engines: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst_book.items())
          + f"; FD report (vectorized_eval_batch_multi, 2^16 points, built "
          f"on the card) vs per-point eval_multi on 64 points {d_fd:.3e} "
          f"<= {FD_REPORT:g} | {card}", flush=True)

    # 20. Timing of the plain TT paths at N = 2^20 (CUDA events, median
    # of 15 after 3 warm-up), and the share of each chain's time that
    # the card's kernels were running.
    comp_cores = comp._cores_on_device(torch.float64)
    comp_dom = np.asarray(comp.domain, dtype=np.float64)
    tt_runs = {
        "TT rank-15 chain f32 (tt_eval_batch)":
            lambda: tt_eval.tt_eval_batch(cores32, tt_dom, tt_pts32),
        "TT rank-15 chain f64 (tt_eval_batch)":
            lambda: tt_eval.tt_eval_batch(cores64, tt_dom, tt_pts64),
        "TT rank-15 engine f32 (BatchedEvaluator)":
            lambda: engines["value", "f32"](tt_pts32),
        "TT rank-15 engine dd (BatchedEvaluator)":
            lambda: engines["value", "dd"](tt_pts64),
        "TT 6-model book f32 (MultiModelEvaluator)":
            lambda: books["f32"](tt_pts32),
        "TT 6-model book f64 (MultiModelEvaluator)":
            lambda: books["f64"](tt_pts64),
        "TT 6-model book dd (MultiModelEvaluator)":
            lambda: books["dd"](tt_pts64),
        "TT FD report, 6 specs, 2^16 points (vectorized_eval_batch_multi)":
            lambda: tt._eval_batch_multi_device(fd_pts, GREEKS),
        "to_tt chain per-dim (eval_batch_dd, groups=None)":
            lambda: comp.eval_batch_dd(pts64, groups=None),
        "to_tt chain auto (eval_batch_dd)":
            lambda: comp.eval_batch_dd(pts64),
    }
    route_groups = {"to_tt chain per-dim (eval_batch_dd, groups=None)":
                    (1,) * 5}
    for g in ((1, 1, 1, 2), (1, 1, 2, 1), (2, 1, 1, 1), (2, 2, 1),
              (1, 2, 2)):
        name = f"to_tt chain grouped {g} (tt_eval_batch_dd)"
        route_groups[name] = g
        tt_runs[name] = (
            lambda g=g: tt_eval_dd.tt_eval_batch_dd(comp_cores, comp_dom,
                                                    pts64, groups=g))
    for name, fn in tt_runs.items():
        ms[name] = cuda_ms(fn)
        n_pts = (1 << 16) if "2^16" in name else N
        extra = ""
        if "chain" in name:
            busy = device_busy_ms(fn)
            extra = (f"; kernels busy {busy:.4f} ms = "
                     f"{100.0 * busy / ms[name]:.1f}% of it")
        if name in route_groups:
            moved = tt_eval_dd._elements_moved(comp_shapes,
                                               route_groups[name])
            extra += f"; {moved:,} intermediate elements per point"
        print(f"[20 timing] {name}: {ms[name]:.4f} ms = "
              f"{n_pts / ms[name] * 1e3:,.0f} /s{extra} | {card}",
              flush=True)
    fastest = min((v, k) for k, v in ms.items() if k.startswith("to_tt"))[1]
    print(f"[20 timing] fastest to_tt route: {fastest}; the auto rule "
          f"(fewest intermediate elements per point) picks {auto_groups}",
          flush=True)

    # 21-24. The spline and slider families.
    k3_spline_launches, spline, slider = spline_and_slider(card, ms)

    # 25-31. Calculus and scenario batches on all four families.
    calculus(card, ms, cheb, tt, comp, spline, slider)

    # 32-38. Fits, TT completion, books and files; the fitted dense
    # model's run through K1 and K3 counts toward their launches.
    k1_fit_launches, k3_fit_launches = fitting(card, ms)

    # 39-41. Global calculus: the box-stats route, the main path's
    # certified optima witnessed through K3, the reference's rows.
    k3_global_launches = global_calculus(card, ms, cheb)

    # 43-53. Multi-device: the meshed main path through K1, K2 and K3 on
    # a one-rank NCCL world, then a 4-rank gloo world on the CPU.
    k1_mesh, k2_mesh, k3_mesh = multi_device(card, ms, cheb, cheb19,
                                             slider, tt)

    # 54. Autodiff through the plain f64 evaluator on the card.
    autodiff(card, ms, cheb)

    # 55. The kernel routes refuse a gradient; under no_grad they serve.
    refusals(card, cheb, cheb19)

    # 56. Every example on the card; their K1 and K3 launches count.
    k1_examples, k3_examples = examples(card)

    # 57. bench_torch.py at full widths but BENCH_ALONE's rows; its K1
    # and K3 launches count.
    k1_bench, k3_bench = bench_rows(card)

    # 58. The JAX package's on-chip tests that no phase above holds.
    hardware_counterparts(card, cheb)

    # Bounds on the pipes each instance runs on: f32 on the TF32 tensor
    # cores in three passes, f64 on the f64 tensor cores; the SIMT pipes'
    # bound beside each.
    rows = [
        ("K1 fused f32 dense evaluator", "pychebyshev_tpu/ops/pallas_eval.py:173",
         main_launches + k1_fit_launches + k1_mesh + k1_examples + k1_bench,
         max_abs,
         "K1 f32 (fused_eval_batch)",
         "plain f32 (fused_eval_batch_reference)", "GEMM f32 11^5",
         bound((11,) * 5, N, 4, TF32_PEAK, passes=3),
         bound((11,) * 5, N, 4, F32_SIMT_PEAK)[0]),
        ("K2 stream f32 dense evaluator (K1's kernel at 19^5)",
         "pychebyshev_tpu/ops/pallas_eval.py:319", k2_launches + k2_mesh,
         k2_abs,
         "K1 f32 at 19^5 (fused_eval_batch)",
         "plain f32 at 19^5 (fused_eval_batch_reference)", "GEMM f32 19^5",
         bound((19,) * 5, N, 4, TF32_PEAK, passes=3),
         bound((19,) * 5, N, 4, F32_SIMT_PEAK)[0]),
        ("K3 fused dd dense evaluator (f64)",
         "pychebyshev_tpu/ops/pallas_dd.py:155",
         k3_launches + k3_spline_launches + k3_fit_launches
         + k3_global_launches + k3_mesh + k3_examples + k3_bench, k3_abs,
         "K3 f64 (fused_eval_batch_dd)",
         "plain f64 (fused_eval_batch_dd_reference)", "GEMM f64 11^5",
         bound((11,) * 5, N, 8, F64_TC_PEAK),
         bound((11,) * 5, N, 8, F64_SIMT_PEAK)[0]),
    ]
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": "pychebyshev_tpu_torch/csrc/fused_eval.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "ms": ms[kernel],
        "plain_ms": ms[plain],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_simt_ms": bound_simt_ms,
        "library_ms": ms[library],
    } for name, replaces, launches, err, kernel, plain, library,
        (bound_ms, bound_by), bound_simt_ms in rows]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

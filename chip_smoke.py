"""Chip check of the PyTorch port on one CUDA card.

Drives the port's main path through its public entry points: the dense
5-D Black-Scholes interpolant on an 11^5 Chebyshev grid (161,051 nodes),
built from one vectorized host oracle call and queried in batches of
2^20 points in f32 (through the hand-written CUDA evaluator, K1) and in
f64, served by ``BatchedEvaluator`` and ``MultiSpecEvaluator``.  It
builds the kernel from this checkout's sources, holds it to its plain
PyTorch version, checks every path against the repository's accuracy
ceilings, and times the path with CUDA events.

Run from the repository root, with one CUDA card:

    python3 chip_smoke.py

Each phase prints one line; any failure exits non-zero before the last
line, which is ``{"ok": true, "device": {...}}``.  Without CUDA (or
without the package beside this file) it exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from scipy.stats import norm

from pychebyshev_tpu_torch import (
    BatchedEvaluator,
    ChebyshevApproximation,
    MultiSpecEvaluator,
)
from pychebyshev_tpu_torch.ops import _build, fused_eval
from pychebyshev_tpu_torch.ops.chebyshev import (
    barycentric_weights_np,
    differentiation_matrix_np,
    nodes_for_dim_np,
)

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
SEED = 0
N = 1 << 20
DOMAIN = [[80.0, 120.0], [90.0, 110.0], [0.25, 2.0], [0.1, 0.5],
          [0.01, 0.05]]
GREEKS = [(0, 0, 0, 0, 0), (1, 0, 0, 0, 0), (2, 0, 0, 0, 0),
          (0, 0, 1, 0, 0), (0, 0, 0, 1, 0), (0, 0, 0, 0, 1)]
# Scale-normalized max deviations: max|a - ref| / max|ref|.
K1_VS_PLAIN = 5e-5
F32_CEILING = 2e-4
F64_CEILING = 1e-12


def bs_price_np(points, _data=None):
    """Analytic Black-Scholes call price (host, float64)."""
    points = np.asarray(points, dtype=np.float64)
    s, k, t, sigma, r = (points[:, i] for i in range(5))
    sqrt_t = np.sqrt(t)
    d1 = (np.log(s / k) + (r + 0.5 * sigma ** 2) * t) / (sigma * sqrt_t)
    d2 = d1 - sigma * sqrt_t
    return s * norm.cdf(d1) - k * np.exp(-r * t) * norm.cdf(d2)


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

    # 2. Build the kernel from this checkout's sources.
    t0 = time.perf_counter()
    lib = _build.load_library("fused_eval")
    print(f"[2 kernel build] {time.perf_counter() - t0:.3f} s -> "
          f"{Path(lib._name).relative_to(ROOT)}", flush=True)

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
        grid = [nodes_for_dim_np(-1.0, 1.0, n) for n in shape]
        wts = [barycentric_weights_np(x) for x in grid]
        dmats = [differentiation_matrix_np(x, w) for x, w in zip(grid, wts)]

        def on_card(arrays):
            return tuple(torch.tensor(a, device=DEVICE) for a in arrays)

        operands = (torch.tensor(rng.standard_normal(shape), device=DEVICE),
                    on_card(grid), on_card(wts), on_card(dmats))
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
    print(f"[4 K1 vs plain] {len(cases)} cases (11^5 at N=2^20 and "
          f"1,000,003 with node hits, orders value/d0/d4; (8,9,7), (3,5,7)): "
          f"max deviation {worst:.3e} <= {K1_VS_PLAIN:g}, max abs "
          f"{max_abs:.3e}", flush=True)

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

    print(json.dumps({"kernels": [{
        "name": "K1 fused f32 dense evaluator",
        "route": "cuda",
        "source": "pychebyshev_tpu_torch/csrc/fused_eval.cu",
        "replaces": "pychebyshev_tpu/ops/pallas_eval.py:173",
        "launches": main_launches,
        "max_abs_err": max_abs,
        "ms": ms["K1 f32 (fused_eval_batch)"],
        "plain_ms": ms["plain f32 (fused_eval_batch_reference)"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

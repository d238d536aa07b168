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
its stream kernel K2, through the f32 evaluator.  It builds the kernels
from this checkout's sources, holds each to its plain PyTorch version,
checks every path against the repository's accuracy ceilings, and
times the paths, the plain versions and a cuBLAS GEMM yardstick with
CUDA events.

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
from pychebyshev_tpu_torch.ops import _build, fused_dd, fused_eval
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
K3_VS_PLAIN = 1e-12   # both f64: summation order only
DD_CEILING = 1e-10
# Published H100 SXM peaks (NVIDIA data sheet, 700 W): f32 outside the
# tensor cores, f64 on the tensor cores (34 TFLOP/s on the SIMT pipes),
# and device memory.
F32_PEAK = 67e12
F64_PEAK = 67e12
HBM_BYTES_PER_S = 3.35e12


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


def bound(shape, n, itemsize, peak):
    """(ms, what bounds it): the contraction's 2*prod(shape) FLOP per
    point over ``peak``, or the bytes moved (points in, values out, the
    tensor once) over the memory rate, whichever is larger."""
    nodes = int(np.prod(shape))
    flop_ms = 2.0 * nodes * n / peak * 1e3
    byte_ms = itemsize * (n * (len(shape) + 1) + nodes) \
        / HBM_BYTES_PER_S * 1e3
    return max(flop_ms, byte_ms), ("operations" if flop_ms >= byte_ms
                                   else "bytes")


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

    # 2. Build the kernels from this checkout's sources: one source,
    # csrc/fused_eval.cu, with the f32 (K1, K2) and f64 (K3) instances.
    t0 = time.perf_counter()
    lib = _build.load_library("fused_eval")
    print(f"[2 kernel build] {time.perf_counter() - t0:.3f} s -> "
          f"{Path(lib._name).relative_to(ROOT)} (fused_eval_f32, "
          f"fused_eval_f64)", flush=True)

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
          f"at 100,003; 17^5 at 65,537): max deviation {k3_worst:.3e} <= "
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
    t0 = time.perf_counter()
    cheb19 = ChebyshevApproximation(bs_price_np, 5, DOMAIN, [19] * 5,
                                    vectorized=True, device=DEVICE)
    cheb19.build(verbose=False)
    torch.cuda.synchronize()
    build19 = time.perf_counter() - t0
    fused_eval.launches = 0
    f32_19 = checked(cheb19.eval_batch_f32(pts64), (N,), "19^5 eval_batch_f32")
    torch.cuda.synchronize()
    k2_launches = fused_eval.launches
    check(k2_launches > 0, "19^5 eval_batch_f32 did not launch the kernel")
    sub19 = pts64[:65_536]
    nodes19, weights19, diffs19 = cheb19._grid_tuples()
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

    rows = [
        ("K1 fused f32 dense evaluator", "pychebyshev_tpu/ops/pallas_eval.py:173",
         main_launches, max_abs, "K1 f32 (fused_eval_batch)",
         "plain f32 (fused_eval_batch_reference)", "GEMM f32 11^5",
         bound((11,) * 5, N, 4, F32_PEAK)),
        ("K2 stream f32 dense evaluator (K1's kernel at 19^5)",
         "pychebyshev_tpu/ops/pallas_eval.py:319", k2_launches, k2_abs,
         "K1 f32 at 19^5 (fused_eval_batch)",
         "plain f32 at 19^5 (fused_eval_batch_reference)", "GEMM f32 19^5",
         bound((19,) * 5, N, 4, F32_PEAK)),
        ("K3 fused dd dense evaluator (f64)",
         "pychebyshev_tpu/ops/pallas_dd.py:155", k3_launches, k3_abs,
         "K3 f64 (fused_eval_batch_dd)",
         "plain f64 (fused_eval_batch_dd_reference)", "GEMM f64 11^5",
         bound((11,) * 5, N, 8, F64_PEAK)),
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
        "library_ms": ms[library],
    } for name, replaces, launches, err, kernel, plain, library,
        (bound_ms, bound_by) in rows]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

"""Where the fused evaluator's time goes, on one CUDA card.

Builds variants of ``pychebyshev_tpu_torch/csrc/fused_eval.cu``, each the
source with one part taken out or changed by a text substitution, and
times each against the kernel as committed, at N = 2^20 points on random
11^5 and 19^5 tensors, in f32 (K1, K2) and f64 (K3):

- ``no A formation``: the stage loop forms no A (the MMAs read stale A);
- ``no MMA``: no tensor-core work (rows, A, T copies and barriers only);
- ``no T copies``: the ring is never refilled (the MMAs read stale T);
- ``no T split``: the f32 MMAs take T unsplit, as if the pack held T's
  TF32 big and small planes (the upper bound of what pre-splitting T at
  pack time could save, before its doubled L2 traffic);
- ``4-stage ring``: the ring one stage deeper (one f32 block per SM
  then, by shared memory; a launch the cap refuses reads "refused" or
  nan);
- ``one f32 block per SM``: the f32 instance's registers not held to
  two blocks per SM;
- ``sums on the tensor cores``: f32 accumulates on the tensor cores
  across the whole contraction instead of per k8 step in IEEE f32;
- ``k8 steps unrolled``: the stage's two k8 steps unrolled into one
  block of MMAs (more registers live at once).

Variants that drop work compute wrong values by design; only the kernel
and the variants that keep its function are held to the plain version
(19^5, random tensor, first-dim derivative, 20,001 points).  Times are
CUDA-event means over 7 calls after a warm-up, in the order kernel,
variants, variants reversed, kernel, so each variant reads twice.

Run from the repository root, with one CUDA card:

    python3 chip_breakdown.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from pychebyshev_tpu_torch.ops import _build, fused_dd, fused_eval
from pychebyshev_tpu_torch.ops.chebyshev import (
    barycentric_weights_np,
    differentiation_matrix_np,
    nodes_for_dim_np,
)

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "pychebyshev_tpu_torch" / "csrc" / "fused_eval.cu"
OUT = ROOT / "pychebyshev_tpu_torch" / "_build" / "variants"
N = 1 << 20
SEED = 0

VARIANTS = {
    "no A formation": [(
        "    if (q + 1 < n_q) form_a(ks + 1 == n_k ? 0 : ks + 1, "
        "(q + 1) & 1);\n", "")],
    "no MMA": [("      mma_k8(acc, a_q + k8 * S, t_q + k8 * S, g8, q4);\n",
                "")],
    "no T copies": [("    copy_stage(q + kStages - 1);\n",
                     "    cp_async_commit();\n")],
    "no T split": [(
        "      bb[ni][h] = tf32(x);\n"
        "      bs[ni][h] = tf32(x - __uint_as_float(bb[ni][h]));\n",
        "      bb[ni][h] = __float_as_uint(x);\n"
        "      bs[ni][h] = bb[ni][h];\n")],
    "4-stage ring": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
    "one f32 block per SM": [("  static constexpr int kMinBlocks = 2;",
                              "  static constexpr int kMinBlocks = 1;")],
    "sums on the tensor cores": [(
        "      float sum[4];\n"
        "      mma0(sum, as, bb[ni][0], bb[ni][1]);\n"
        "      mma(sum, ab, bs[ni][0], bs[ni][1]);\n"
        "      mma(sum, ab, bb[ni][0], bb[ni][1]);\n"
        "#pragma unroll\n"
        "      for (int e = 0; e < 4; ++e) acc[mi][ni][e] += sum[e];\n",
        "      mma(acc[mi][ni], as, bb[ni][0], bb[ni][1]);\n"
        "      mma(acc[mi][ni], ab, bs[ni][0], bs[ni][1]);\n"
        "      mma(acc[mi][ni], ab, bb[ni][0], bb[ni][1]);\n")],
    "k8 steps unrolled": [("#pragma unroll 1\n    for (int k8 = 0;",
                           "#pragma unroll\n    for (int k8 = 0;")],
}
SAME_FUNCTION = ("kernel", "4-stage ring", "one f32 block per SM",
                 "sums on the tensor cores", "k8 steps unrolled")


def build(name: str, source: str) -> ctypes.CDLL:
    stem = name.replace(" ", "_").replace("-", "_")
    src = OUT / f"fused_eval_{stem}.cu"
    OUT.mkdir(parents=True, exist_ok=True)
    src.write_text(source)
    lib = OUT / f"libfused_eval_{stem}.so"
    _build._compile(src, lib)
    return fused_eval._bind(ctypes.CDLL(str(lib)))


def operands(shape, rng):
    grid = [nodes_for_dim_np(-1.0, 1.0, n) for n in shape]
    weights = [barycentric_weights_np(x) for x in grid]
    diffs = [differentiation_matrix_np(x, w) for x, w in zip(grid, weights)]
    return (torch.tensor(rng.standard_normal(shape), device="cuda"),
            *(tuple(torch.tensor(a, device="cuda") for a in arrays)
              for arrays in (grid, weights, diffs)))


def mean_ms(fn, reps=7) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_breakdown: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)
    base = SOURCE.read_text()
    libs = {"kernel": fused_eval._library()}
    for name, subs in VARIANTS.items():
        source = base
        for old, new in subs:
            if old not in source:
                raise SystemExit(f"chip_breakdown: {name}: {old!r} is no "
                                 f"longer in {SOURCE.name}")
            source = source.replace(old, new)
        libs[name] = build(name, source)
    log = _build.build_log
    for name, lib in libs.items():
        report = [line.strip() for line in
                  log(lib._name).read_text().splitlines()
                  if "Used " in line or "spill" in line]
        print(f"[build] {name} (f64, then f32): {' | '.join(report)}",
              flush=True)

    rng = np.random.default_rng(SEED)
    runs = {torch.float32: fused_eval.fused_eval_batch,
            torch.float64: fused_dd.fused_eval_batch_dd}
    plains = {torch.float32: fused_eval.fused_eval_batch_reference,
              torch.float64: fused_dd.fused_eval_batch_dd_reference}
    ops19 = operands((19,) * 5, rng)
    pts = rng.uniform(-0.98, 0.98, (20_001, 5))
    for dtype, run in runs.items():
        p = torch.tensor(pts, dtype=dtype, device="cuda")
        plain = plains[dtype](*ops19, p, (1, 0, 0, 0, 0)).double()
        line = []
        for name in SAME_FUNCTION:
            fused_eval._library = lambda lib=libs[name]: lib
            try:
                out = run(*ops19, p, (1, 0, 0, 0, 0)).double()
            except RuntimeError:   # refused: over the shared memory
                line.append(f"{name} refused")
                continue
            d = float((out - plain).abs().max() / plain.abs().max())
            line.append(f"{name} {d:.3e}")
        print(f"[accuracy] 19^5 {dtype} vs plain: {'; '.join(line)} | "
              f"{card}", flush=True)

    order = list(libs) + list(reversed(libs))
    for shape in ((11,) * 5, (19,) * 5):
        ops = operands(shape, rng)
        pts = rng.uniform(-0.98, 0.98, (N, len(shape)))
        for dtype, run in runs.items():
            p = torch.tensor(pts, dtype=dtype, device="cuda")
            times = {}
            for name in order:
                fused_eval._library = lambda lib=libs[name]: lib
                try:
                    t = mean_ms(lambda: run(*ops, p))
                except RuntimeError:   # refused: over the shared memory
                    t = float("nan")
                times.setdefault(name, []).append(t)
            print(f"[time] {shape[0]}^5 {dtype} at N=2^20, ms: " + "; ".join(
                f"{name} {a:.3f}/{b:.3f}" for name, (a, b) in times.items())
                + f" | {card}", flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())

"""Where the fused evaluators' time goes, on one CUDA card.

Builds variants of ``pychebyshev_tpu_torch/csrc/fused_eval.cu``, each the
source with one part taken out or changed by a text substitution, and
times each against the kernels as committed, at N = 2^20 points on random
11^5 and 19^5 tensors.

The f32 kernel (K1, K2: ``fused_eval_kernel_wgmma``, warp-specialised
3xTF32 ``wgmma``):

- ``no A formation``: the producer warpgroups form no A (the products
  read stale A);
- ``no MMA``: the consumer warpgroups issue no ``wgmma`` (rows, A, T
  copies and barriers only);
- ``no T copies``: no stage's T is copied (the products read stale T);
- ``copies only``: neither A nor products, only the T copies and the
  barriers' round trips;
- ``products only``: neither A nor T copies, only the products on
  stale operands and the barriers' round trips;
- ``2-stage ring``: every plan takes two ring stages, not three (the
  wrapper's plans, ``ops/fused_eval._WG_PLANS``, changed; the kernel as
  committed);
- ``lane table for two dims``: grids with two right-prime dims (11^5,
  19^5) form the right-prime product through the lane table, as every
  other grid does, instead of stepping it like an odometer;
- ``A small rounded``: A's small part is rounded to TF32 (as
  ``cvt.rna`` rounds), not left for the tensor cores to truncate;

The f64 kernel (K3, ``fused_eval_kernel<double>``, ``mma.sync`` DMMA):
``f64 no A formation``, ``f64 no MMA``, ``f64 no T copies`` and
``f64 4-stage ring`` (one stage deeper; a launch the shared-memory cap
refuses reads "refused" or nan).

The variants of the ``mma.sync`` f32 kernel that the ``wgmma`` one
replaced (no T split, one f32 block per SM, sums on the tensor cores, k8
steps unrolled) were retired with it: T is split at pack time now, and a
block takes an SM by design.  So were the ``wgmma`` kernel's chunked
sums (``whole-depth sums``, ``1-stage chunks``), once the sums became
one stage deep (``PERF.md`` §6).

Variants that drop work compute wrong values by design; only the kernels
and the variants that keep their function are held to the plain versions
(19^5, random tensor, first-dim derivative, 20,001 points).  Times are
CUDA-event means over 7 calls after a warm-up, in the order kernel,
variants, variants reversed, kernel, so each variant reads twice.

Run from the repository root, with one CUDA card (names or prefixes of
variants after the script select some; the kernels always run):

    python3 chip_breakdown.py [variant ...]
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

_NO_A = ("      for (int c4 = 0; c4 < kVals / 4; ++c4) {",
         "      for (int c4 = 0; c4 < 0; ++c4) {")
_NO_MMA = ("          for (int kk = 0; kk < 4; ++kk) {",
           "          for (int kk = 0; kk < 0; ++kk) {")
_NO_T = [("      mbar_arrive_expect_tx(&full[q], kCopyBytes);\n"
          "      bulk_copy(ring + q * P::kStageBytes,\n"
          "                pack + static_cast<size_t>(q) * (kCopyBytes / 4),\n"
          "                kCopyBytes, &full[q]);\n",
          "      mbar_arrive(&full[q]);\n"),
         ("        mbar_arrive_expect_tx(&full[slot], kCopyBytes);\n"
          "        bulk_copy(st, pack + static_cast<size_t>(q) * "
          "(kCopyBytes / 4),\n"
          "                  kCopyBytes, &full[slot]);\n",
          "        mbar_arrive(&full[slot]);\n")]

_SMALL = [(f"        s.{c} = v[{i}] - b.{c};",
           f"        s.{c} = tf32_big(v[{i}] - b.{c});")
          for i, c in enumerate("xyzw")]

# name -> (dtype timed, substitutions); no substitution: the kernel's
# own library, under the f32 plans of PLANS.
VARIANTS = {
    "no A formation": (torch.float32, [_NO_A]),
    "no MMA": (torch.float32, [_NO_MMA]),
    "no T copies": (torch.float32, _NO_T),
    "copies only": (torch.float32, [_NO_A, _NO_MMA]),
    "products only": (torch.float32, [_NO_A] + _NO_T),
    "2-stage ring": (torch.float32, []),
    "lane table for two dims": (torch.float32, [(
        "const bool two = d - s - 1 == 2;", "const bool two = false;")]),
    "A small rounded": (torch.float32, _SMALL),
    "f64 no A formation": (torch.float64, [(
        "    if (q + 1 < n_q) form_a(ks + 1 == n_k ? 0 : ks + 1, "
        "(q + 1) & 1);\n", "")]),
    "f64 no MMA": (torch.float64, [(
        "      mma_k8(acc, a_q + k8 * S, t_q + k8 * S, g8, q4);\n", "")]),
    "f64 no T copies": (torch.float64, [(
        "    copy_stage(q + kStages - 1);\n", "    cp_async_commit();\n")]),
    "f64 4-stage ring": (torch.float64, [(
        "constexpr int kStages = 3;", "constexpr int kStages = 4;")]),
}
PLANS = {"2-stage ring": ((2, 2), (1, 2))}
SAME_FUNCTION = ("kernel", "2-stage ring", "lane table for two dims",
                 "A small rounded", "f64 4-stage ring")


def use(libs, name) -> None:
    """Route the fused evaluators through variant ``name``'s library and
    f32 plans."""
    fused_eval._library = lambda lib=libs[name][1]: lib
    fused_eval._WG_PLANS = PLANS.get(name, _KERNEL_PLANS)


_KERNEL_PLANS = fused_eval._WG_PLANS


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


def main(selected=()) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_breakdown: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)
    base = SOURCE.read_text()
    libs = {"kernel": (None, fused_eval._library())}
    for name, (dtype, subs) in VARIANTS.items():
        if selected and not any(name.startswith(s) for s in selected):
            continue
        if not subs:
            libs[name] = (dtype, libs["kernel"][1])
            continue
        source = base
        for old, new in subs:
            if old not in source:
                raise SystemExit(f"chip_breakdown: {name}: {old!r} is no "
                                 f"longer in {SOURCE.name}")
            source = source.replace(old, new)
        libs[name] = (dtype, build(name, source))
    log = _build.build_log
    for name, (_, lib) in libs.items():
        if name in PLANS:
            continue
        report = [line.strip() for line in
                  log(lib._name).read_text().splitlines()
                  if "Used " in line or "spill" in line]
        print(f"[build] {name} (the f32 kernels, then f64): "
              f"{' | '.join(report)}", flush=True)

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
            if name not in libs or libs[name][0] not in (None, dtype):
                continue
            use(libs, name)
            try:
                out = run(*ops19, p, (1, 0, 0, 0, 0)).double()
            except RuntimeError:   # refused: over the shared memory
                line.append(f"{name} refused")
                continue
            d = float((out - plain).abs().max() / plain.abs().max())
            line.append(f"{name} {d:.3e}")
        print(f"[accuracy] 19^5 {dtype} vs plain: {'; '.join(line)} | "
              f"{card}", flush=True)

    for shape in ((11,) * 5, (19,) * 5):
        ops = operands(shape, rng)
        pts = rng.uniform(-0.98, 0.98, (N, len(shape)))
        for dtype, run in runs.items():
            names = [n for n, (t, _) in libs.items() if t in (None, dtype)]
            p = torch.tensor(pts, dtype=dtype, device="cuda")
            times = {}
            for name in names + names[::-1]:
                use(libs, name)
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
    sys.exit(main(sys.argv[1:]))

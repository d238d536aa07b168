"""Multi-card check of the PyTorch port's meshed paths: one process per
card, over NCCL.

    torchrun --nproc-per-node=4 chip_multicard.py           # 4 cards
    torchrun --nproc-per-node=4 chip_multicard.py --cpu     # a gloo
                                                            # rehearsal on
                                                            # the CPU

Every rank builds the same models from seeds on its own card, runs each
meshed path over the world's meshes and the same call without a mesh on
its own card, and checks that they agree: bitwise for dp queries, box
integrals, TT bucket masses, the sharded TT build and the device-dd
fit; within the f64 ceiling (1e-12) for tp and the pipeline; the f32
fit within 2e-4; dd tp of the reference's (9, 16400) grid within 1e-11
of f64.  The dp engines at 2^20 points (11^5 through K1 and K3, 19^5
through K2) are timed on the mesh beside one card (CUDA events, median
of 15 after 3 warm-ups), with each kernel's launches on this rank.
Rank 0 prints one line per phase with the card's name and power limit,
and last ``{"ok": true, ...}``; a failed check exits its rank non-zero
(torchrun then stops the others).  The sizes are ``chip_smoke.py``'s;
``--cpu`` cuts them for the rehearsal.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

import chip_smoke as cs
from pychebyshev_tpu_torch import (
    BatchedEvaluator,
    ChebyshevApproximation,
    ChebyshevTT,
    MultiSpecEvaluator,
)
from pychebyshev_tpu_torch.ops import fused_dd, fused_eval, tt_eval
from pychebyshev_tpu_torch.ops import eval as eval_ops
from pychebyshev_tpu_torch.ops import integrate as integrate_ops
from pychebyshev_tpu_torch.parallel import sharding
from pychebyshev_tpu_torch.parallel.tt_pipeline import tt_eval_batch_pp
from pychebyshev_tpu_torch.parallel.world import check_replicated
from pychebyshev_tpu_torch.serving import build_book

DD_TP_VS_F64 = 1e-11


def say(line: str) -> None:
    if dist.get_rank() == 0:
        print(line, flush=True)


def timed(fn) -> float:
    """``cs.cuda_ms`` on a card; on the CPU the median host ms of 3."""
    if cs.DEVICE != "cpu":
        return cs.cuda_ms(fn)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def agreement(got, want, what: str, ceiling: float) -> str:
    """"bitwise", or the scale-normalized deviation; fails above
    ``ceiling``."""
    if torch.equal(got, want):
        return "bitwise"
    d = cs.dev(got, want)
    cs.check(d <= ceiling, f"{what}: {d:.3e} > {ceiling:g}")
    return f"{d:.3e}"


def timed_s(fn):
    """(result, seconds) of one call of ``fn``, synchronized on a card."""
    if cs.DEVICE != "cpu":
        return cs.timed_s(fn)
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def engines(mesh, cheb, cheb19, n, card, p):
    """M2-M3: the dp engines, bitwise one card's, with their times."""
    t0 = time.perf_counter()
    pts64 = torch.tensor(cs.sample_points(n, cs.SEED + 80), device=cs.DEVICE)
    pts32 = pts64.float()
    made = {}
    grid, grid19 = f"{cheb.n_nodes[0]}^5", f"{cheb19.n_nodes[0]}^5"
    for name, model, dtype, specs in (
            (f"f32 value {grid}", cheb, torch.float32, None),
            (f"f64 value {grid}", cheb, torch.float64, None),
            (f"dd value {grid}", cheb, "dd", None),
            (f"f64 price+5 Greeks {grid}", cheb, torch.float64, cs.GREEKS),
            (f"dd price+5 Greeks {grid}", cheb, "dd", cs.GREEKS),
            (f"f32 value {grid19}", cheb19, torch.float32, None)):
        for meshed in (False, True):
            kw = {"dtype": dtype, "mesh": mesh if meshed else None,
                  "device": cs.DEVICE}
            made[name, meshed] = (
                BatchedEvaluator(model, **kw) if specs is None
                else MultiSpecEvaluator(model, specs, **kw))
    names = [k for k, meshed in made if not meshed]
    one = {k: made[k, False](pts32 if k.startswith("f32") else pts64)
           for k in names}
    fused_eval.launches = 0
    fused_dd.launches = 0
    got = {k: cs.checked(made[k, True](pts32 if k.startswith("f32")
                                       else pts64), one[k].shape,
                         f"meshed {k}") for k in names}
    launches = {"K1 and K2": fused_eval.launches, "K3": fused_dd.launches}
    agree = {k: agreement(got[k], one[k], f"meshed {k}",
                          cs.F32_CEILING if k.startswith("f32")
                          else cs.F64_CEILING) for k in names}
    ms = {}
    for k in names:
        pts = pts32 if k.startswith("f32") else pts64
        ms[k] = (timed(lambda e=made[k, True]: e(pts)),
                 timed(lambda e=made[k, False]: e(pts)))
    gather = torch.empty(n // p, dtype=torch.float64, device=cs.DEVICE)
    gather_ms = timed(lambda: sharding._all_gather_rows(
        gather, mesh.get_group("dp"), p))
    say(f"[M2 dp engines] 2^{int(np.log2(n))} points on {p} ranks vs one "
        f"card: " + ", ".join(f"{k} {v}" for k, v in agree.items())
        + "; launches on rank 0 during the meshed run: "
        + ", ".join(f"{k} {v}" for k, v in launches.items())
        + "; mesh vs one card (ms): "
        + "; ".join(f"{k} {a:.4f} vs {b:.4f} ({b / a:.2f}x)"
                    for k, (a, b) in ms.items())
        + f"; all_gather of {n:,} f64 results alone {gather_ms:.4f} ms; "
        f"{time.perf_counter() - t0:.1f} s | {card}")
    return launches


def parallel_paths(meshes, cheb, tt, n, nb, card, p):
    """M4-M6: tp, dd tp beyond the single-card budget, dp integrals and
    bucket masses, the P-stage pipeline."""
    t0 = time.perf_counter()
    nodes, weights, diffs = cheb._grid_tuples()
    pts = torch.tensor(cs.with_node_hits(cs.sample_points(n, cs.SEED + 81),
                                         cheb._nodes_np()), device=cs.DEVICE)
    delta = (1, 0, 0, 0, 0)
    one = cheb.eval_batch_device(pts, delta)
    line = []
    for name in ("dp_tp", "tp"):
        mesh = meshes[name]
        got = cs.checked(sharding.eval_batch_tp(
            cheb.tensor_values, nodes, weights, diffs, pts, mesh,
            orders=delta), (n,), f"tp {name}")
        d = cs.dev(got, one)
        cs.check(d <= cs.F64_CEILING, f"tp {name} d/dS {d:.3e}")
        ms = timed(lambda m=mesh: sharding.eval_batch_tp(
            cheb.tensor_values, nodes, weights, diffs, pts, m,
            orders=delta))
        line.append(f"{tuple(mesh.mesh.shape)} {d:.3e}, {ms:.4f} ms")
    one_ms = timed(lambda: cheb.eval_batch_device(pts, delta))
    tensor, xs, ws = cs.wide_operands(cs.DEVICE)
    wide_pts = torch.tensor(cs.sample_points(4096, cs.SEED + 82,
                                             [(-0.97, 0.97)] * 2),
                            device=cs.DEVICE)
    wide = cs.checked(sharding.eval_batch_dd_tp(
        tensor, xs, ws, ((), ()), wide_pts, meshes["tp"]), (4096,),
        "dd tp (9, 16400)")
    d_wide = cs.dev(wide, eval_ops.eval_batch(tensor, xs, ws, (None, None),
                                              wide_pts, (0, 0)))
    cs.check(d_wide <= DD_TP_VS_F64, f"dd tp (9, 16400) {d_wide:.3e}")
    say(f"[M4 tp] {cheb.n_nodes[0]}^5 d/dS at {n:,} points with node hits "
        f"vs one card's "
        f"f64 ({one_ms:.4f} ms): " + "; ".join(line)
        + f"; dd tp of (9, 16400) over tp = {p} on 4,096 points vs f64 "
        f"{d_wide:.3e} <= {DD_TP_VS_F64:g}; "
        f"{time.perf_counter() - t0:.1f} s | {card}")

    t0 = time.perf_counter()
    dp = meshes["dp"]
    boxes = cs.random_boxes(nb, cs.SEED + 83, cs.DOMAIN)
    ib = sharding.integrate_box_batch_dp(cheb.tensor_values, cs.DOMAIN,
                                         boxes, dp)
    agree_ib = agreement(ib, integrate_ops.integrate_box_batch(
        cheb.tensor_values, cs.DOMAIN, boxes), "dp box integrals",
        cs.F64_CEILING)
    tt_boxes = cs.random_boxes(nb, cs.SEED + 84, cs.TT_DOMAIN)
    cores = [torch.tensor(c, device=cs.DEVICE) for c in tt._coeff_cores]
    groups = (2,) + (1,) * (len(cores) - 2)
    masses = sharding.tt_integrate_box_batch_dd_dp(
        tt._coeff_cores, cs.TT_DOMAIN, tt_boxes, dp, groups=groups)
    agree_masses = agreement(masses, integrate_ops.tt_integrate_box_batch_dd(
        cores, cs.TT_DOMAIN, tt_boxes, groups=groups), "dp TT bucket masses",
        cs.F64_CEILING)
    ms_ib = (timed(lambda: sharding.integrate_box_batch_dp(
        cheb.tensor_values, cs.DOMAIN, boxes, dp)),
        timed(lambda: integrate_ops.integrate_box_batch(
            cheb.tensor_values, cs.DOMAIN, boxes)))
    tt_pts = torch.tensor(cs.sample_points(n, cs.SEED + 85, cs.TT_DOMAIN),
                          device=cs.DEVICE)
    chain = tt_eval.tt_eval_batch(cores, cs.TT_DOMAIN, tt_pts)
    piped = cs.checked(tt_eval_batch_pp(cores, cs.TT_DOMAIN, tt_pts,
                                        meshes["pp"]), (n,), "pipeline")
    d_pp = cs.dev(piped, chain)
    cs.check(d_pp <= cs.F64_CEILING, f"pipeline vs chain {d_pp:.3e}")
    ms_pp = (timed(lambda: tt_eval_batch_pp(cores, cs.TT_DOMAIN, tt_pts,
                                            meshes["pp"])),
             timed(lambda: tt_eval.tt_eval_batch(cores, cs.TT_DOMAIN,
                                                 tt_pts)))
    say(f"[M5 integrals] vs one card: {cheb.n_nodes[0]}^5 box integrals "
        f"over {nb:,} boxes {agree_ib}, the rank-15 TT's dd bucket masses "
        f"(groups {groups}) {agree_masses}; box integrals {ms_ib[0]:.4f} "
        f"vs {ms_ib[1]:.4f} ms | {card}")
    say(f"[M6 pipeline] the rank-15 TT over {p} stages at {n:,} points vs "
        f"the chain {d_pp:.3e} <= {cs.F64_CEILING:g}; {ms_pp[0]:.4f} vs "
        f"{ms_pp[1]:.4f} ms on one card; "
        f"{time.perf_counter() - t0:.1f} s | {card}")


def fits_and_builds(dp, card, fit_sizes):
    """M7-M8: the dense fits, a sharded book and TT build."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    lines = []
    for engine, n in fit_sizes:
        pts = np.stack([rng.uniform(a, b, n) for a, b in cs.FIT_DOMAIN],
                       axis=1)
        y = cs.fit_f(pts) + rng.normal(0, cs.FIT_NOISE, n)
        kw = dict(l2=1e-8, engine=engine, device=cs.DEVICE)
        one, one_s = timed_s(lambda: ChebyshevApproximation.fit(
            pts, y, 3, cs.FIT_DOMAIN, cs.FIT_NODES, **kw))
        meshed, mesh_s = timed_s(lambda: ChebyshevApproximation.fit(
            pts, y, 3, cs.FIT_DOMAIN, cs.FIT_NODES, mesh=dp, **kw))
        agree = agreement(meshed.tensor_values, one.tensor_values,
                          f"meshed {engine} fit", cs.F32_CEILING)
        lines.append(f"{engine} {n:,} samples {mesh_s:.3f} s vs "
                     f"{one_s:.3f} s on one card, {agree}")
    say("[M7 fits] 9^3 dense fit on the mesh: " + "; ".join(lines)
        + f"; {time.perf_counter() - t0:.1f} s | {card}")

    t0 = time.perf_counter()
    book = build_book(cs.book_torch, 5, cs.DOMAIN, [11] * 5, mesh=dp,
                      device=cs.DEVICE)
    host_book = build_book(cs.book_torch, 5, cs.DOMAIN, [11] * 5,
                           device=cs.DEVICE)
    d_book = max(cs.dev(a.tensor_values, b.tensor_values)
                 for a, b in zip(book, host_book))
    cs.check(d_book <= cs.F64_CEILING, f"sharded book {d_book:.3e}")
    built = []
    for mesh in (dp, None):
        tt = ChebyshevTT(cs.arith_np, 3, cs.GLOO_DOMAIN, cs.MESH_TT_NODES,
                         max_rank=5, vectorized=True, device=cs.DEVICE)
        tt.build(verbose=False, seed=0, mesh=mesh)
        tt.run_completion(max_iter=3, mesh=mesh)
        built.append(tt._coeff_cores)
    agree_tt = ("bitwise" if all(np.array_equal(a, b)
                                 for a, b in zip(*built))
                else max(cs.dev(a, b) for a, b in zip(*built)))
    say(f"[M8 builds] six-model book over 11^5 with the grid rows on the "
        f"mesh vs the host oracle's {d_book:.3e} <= {cs.F64_CEILING:g}; TT "
        f"cross and run_completion with sharded oracle batches vs one "
        f"card's: {agree_tt}; {time.perf_counter() - t0:.1f} s | {card}")
    return {"book": torch.stack([m.tensor_values for m in book]),
            **{f"tt_core_{k}": torch.as_tensor(c, device=cs.DEVICE)
               for k, c in enumerate(built[0])}}


def main() -> None:
    on_cpu = "--cpu" in sys.argv[1:]
    rank = int(os.environ["RANK"])
    local = int(os.environ["LOCAL_RANK"])
    p = int(os.environ["WORLD_SIZE"])
    timeout = timedelta(seconds=300)
    if on_cpu:
        cs.DEVICE = "cpu"
        n, nb, model_n, stream_n = 1 << 12, 1 << 10, 7, 9
        fit_sizes = (("device-dd", 6000), ("device", 8000))
        torch.set_num_threads(1)
        dist.init_process_group("gloo", timeout=timeout)
        card = "CPU rehearsal (no card)"
    else:
        if not torch.cuda.is_available():
            raise SystemExit("chip_multicard: no CUDA card; run with --cpu "
                             "for the CPU rehearsal")
        torch.cuda.set_device(local)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        cs.DEVICE = f"cuda:{local}"
        n, nb, model_n, stream_n = cs.N, cs.NB, 11, 19
        fit_sizes = (("device-dd", 1 << 19), ("device", 1 << 20))
        dist.init_process_group("nccl", timeout=timeout,
                                device_id=torch.device("cuda", local))
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().replace("\n", "; ")
    t_all = time.perf_counter()
    device_type = "cpu" if on_cpu else "cuda"
    meshes = {
        "dp": sharding.make_mesh(device_type=device_type),
        "dp_tp": sharding.make_mesh(axis_names=("dp", "tp"),
                                    shape=(2, p // 2),
                                    device_type=device_type),
        "tp": sharding.make_mesh(axis_names=("dp", "tp"), shape=(1, p),
                                 device_type=device_type),
        "pp": sharding.make_mesh(axis_names=("pp",),
                                 device_type=device_type)}
    say(f"[M1 world] {p} ranks over {dist.get_backend()}, rank {rank} on "
        f"{sharding.mesh_device(meshes['dp'])}; torch {torch.__version__} "
        f"| {card}")
    t0 = time.perf_counter()
    cheb = ChebyshevApproximation(cs.bs_price_np, 5, cs.DOMAIN,
                                  [model_n] * 5, vectorized=True,
                                  device=cs.DEVICE)
    cheb.build(verbose=False)
    cheb19 = ChebyshevApproximation(cs.bs_price_np, 5, cs.DOMAIN,
                                    [stream_n] * 5, vectorized=True,
                                    device=cs.DEVICE)
    cheb19.build(verbose=False)
    tt = ChebyshevTT(cs.bs_div_np, 5, cs.TT_DOMAIN, [model_n] * 5,
                     max_rank=15, tolerance=1e-6, max_sweeps=10,
                     vectorized=True, device=cs.DEVICE)
    tt.build(verbose=False, seed=42)
    say(f"[models] {model_n}^5 and {stream_n}^5 interpolants, rank-15 TT "
        f"in {time.perf_counter() - t0:.1f} s")
    launches = engines(meshes["dp"], cheb, cheb19, n, card, p)
    parallel_paths(meshes, cheb, tt, n, nb, card, p)
    replicated = fits_and_builds(meshes["dp"], card, fit_sizes)
    check_replicated(replicated)
    if not on_cpu:
        cs.check(launches["K1 and K2"] > 0 and launches["K3"] > 0,
                 f"a kernel did not launch on rank {rank}: {launches}")
    say(f"[M9 replicated] every rank holds rank 0's book and TT cores; "
        f"the whole check {time.perf_counter() - t_all:.1f} s")
    dist.destroy_process_group()
    if rank == 0:
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "cpu" if on_cpu else "gpu",
            "kind": "cpu" if on_cpu else torch.cuda.get_device_name(0),
            "count": p if on_cpu else torch.cuda.device_count()}}),
            flush=True)


if __name__ == "__main__":
    main()

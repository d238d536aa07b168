"""Multi-device patterns: dp / tp / pp serving over a device mesh.

The PyTorch port of ``examples/multi_chip.py``.  It runs one
``torch.distributed`` world (``parallel/world.py``, with a deadline
after which every rank is killed):

- ``--device cpu``: four spawned ranks over gloo on the CPU, so dp has
  4 ranks, dp x tp (2, 2) and pp 4 stages;
- on CUDA (the default): one NCCL rank per card.  With one card dp and
  pp have size 1, and tp, which needs two ranks, is skipped.

Every rank builds the same models and runs the same program; rank 0
saves what it measured, and this process prints it.

Run:  python examples_torch/multi_chip.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import tempfile

import numpy as np
import torch
from scipy.stats import norm

from pychebyshev_tpu_torch import ChebyshevApproximation, ChebyshevTT
from pychebyshev_tpu_torch.parallel import sharding as sh
from pychebyshev_tpu_torch.parallel.tt_pipeline import tt_eval_batch_pp
from pychebyshev_tpu_torch.parallel.world import FileFunction, run_world
from pychebyshev_tpu_torch.serving import BatchedEvaluator

DOMAIN = [[80.0, 120.0], [90.0, 110.0], [0.25, 2.0], [0.1, 0.5],
          [0.01, 0.05]]
CPU_RANKS = 4
DEADLINE_S = 300.0


def bs_price(points, _=None):
    points = np.asarray(points, dtype=np.float64)
    s, k, t, sigma, r = (points[:, i] for i in range(5))
    sqrt_t = np.sqrt(t)
    d1 = (np.log(s / k) + (r + 0.5 * sigma ** 2) * t) / (sigma * sqrt_t)
    d2 = d1 - sigma * sqrt_t
    return s * norm.cdf(d1) - k * np.exp(-r * t) * norm.cdf(d2)


def _np(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def rank_main(rank, device_type, out):
    """One rank: every meshed path on this rank's device; rank 0 saves
    the deviations to ``out``."""
    world = torch.distributed.get_world_size()
    device = (torch.device("cuda", torch.cuda.current_device())
              if device_type == "cuda" else torch.device("cpu"))
    cheb = ChebyshevApproximation(bs_price, 5, DOMAIN, [8] * 5,
                                  vectorized=True, device=device)
    cheb.build(verbose=False)
    rng = np.random.default_rng(0)
    lo = np.array([b[0] for b in DOMAIN])
    hi = np.array([b[1] for b in DOMAIN])
    pts = lo + (hi - lo) * rng.uniform(0.02, 0.98, (4096, 5))
    exact = bs_price(pts)
    nodes, weights, diffs = cheb._grid_tuples()
    res = {"world": world}

    # --- dp: the query batch sharded over the ranks --------------------
    mesh = sh.make_mesh(world, axis_names=("dp",), device_type=device_type)
    out_dp = _np(sh.eval_batch_dp(cheb.tensor_values, nodes, weights,
                                  diffs, pts, mesh, (0,) * 5))
    res["dp_vs_analytic"] = np.max(np.abs(out_dp - exact))
    f64_ref = cheb.vectorized_eval_batch(pts, [0] * 5)

    # --- tp: the value tensor itself sharded over the ranks ------------
    tp = world >= 2 and world % 2 == 0
    if tp:
        mesh2 = sh.make_mesh(world, axis_names=("dp", "tp"),
                             shape=(world // 2, 2), device_type=device_type)
        out_tp = _np(sh.eval_batch_tp(cheb.tensor_values, nodes, weights,
                                      diffs, pts, mesh2))
        res["tp_vs_dp"] = np.max(np.abs(out_tp - out_dp))

    # --- pp: the TT core chain staged over the ranks --------------------
    tt = ChebyshevTT(bs_price, 5, DOMAIN, [8] * 5, max_rank=8,
                     vectorized=True, device=device)
    tt.build(verbose=False, seed=0)
    pp_mesh = sh.make_mesh(world, axis_names=("pp",),
                           device_type=device_type)
    out_pp = _np(tt_eval_batch_pp(tt._coeff_cores, DOMAIN, pts, pp_mesh))
    res["pp_vs_serial"] = np.max(np.abs(out_pp - _np(tt.eval_batch(pts))))
    res["pp_stages"] = world

    # --- mesh-aware serving engine --------------------------------------
    engine = BatchedEvaluator(cheb, dtype=torch.float64,
                              bucket_sizes=(512, 4096), mesh=mesh,
                              device=device)
    engine.warmup()
    res["engine_vs_dp"] = np.max(np.abs(_np(engine(pts)) - out_dp))

    # --- near-f64 over the mesh ------------------------------------------
    out_dd = _np(sh.eval_batch_dd_dp(cheb.tensor_values, nodes, weights,
                                     diffs, pts, mesh, (0,) * 5))
    res["dd_dp_vs_f64"] = np.max(np.abs(out_dd - f64_ref))
    if tp:
        out_ddtp = _np(sh.eval_batch_dd_tp(cheb.tensor_values, nodes,
                                           weights, diffs, pts, mesh2))
        res["dd_tp_vs_f64"] = np.max(np.abs(out_ddtp - f64_ref))
    if rank == 0:
        np.savez(out, **{k: np.asarray(v, dtype=np.float64)
                         for k, v in res.items()})


def main(device="cuda"):
    device_type = torch.device(device).type
    if device_type == "cuda":
        world, backend = torch.cuda.device_count(), "nccl"
    else:
        world, backend = CPU_RANKS, "gloo"
    print(f"world: {world} {device_type} rank(s) over {backend}")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.npz")
        run_world(FileFunction(__file__, "rank_main"), world,
                  (device_type, out), deadline_s=DEADLINE_S,
                  backend=backend)
        with np.load(out) as f:
            res = {k: float(v) for k, v in f.items()}

    print(f"dp eval:   max |err| vs analytic {res['dp_vs_analytic']:.2e} "
          f"({world} ranks)")
    if "tp_vs_dp" in res:
        print(f"tp eval:   max |dp-tp| {res['tp_vs_dp']:.2e} "
              f"(dp x tp = {world // 2} x 2)")
    else:
        print(f"tp eval:   skipped: tp needs two ranks, this world has "
              f"{world}")
    print(f"pp TT:     max |pp-serial| {res['pp_vs_serial']:.2e} "
          f"({int(res['pp_stages'])} pipeline stages)")
    print(f"dp engine: max |engine-dp| {res['engine_vs_dp']:.2e} "
          f"(bucketed, sharded)")
    print(f"dd dp:     max |dd-f64| {res['dd_dp_vs_f64']:.2e} "
          f"(near-f64, sharded)")
    if "dd_tp_vs_f64" in res:
        print(f"dd tp:     max |ddtp-f64| {res['dd_tp_vs_f64']:.2e} "
              f"(contraction sharded over tp)")

    # 8^5 nodes: ~1e-2 absolute against the analytic price.
    assert res["dp_vs_analytic"] < 5e-2
    assert max(v for k, v in res.items()
               if k.endswith(("_vs_dp", "_vs_serial", "_vs_f64"))) < 1e-10
    return res


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)

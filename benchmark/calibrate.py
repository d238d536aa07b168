"""Readings that a cell's limits are set from (not part of a run).

    python3 benchmark/calibrate.py --workload <cell> \
        --program-seeds 1 2 ... --control-seeds 101 102 103

For each program seed, the cell's engine (set up once, as a run sets it
up) answers the first ``sample_requests`` requests of that seed's
stream, at the cell's own size, and each ``dev.<spec>`` is read as a
run reads it: the lower readings.  For each control seed, the plain
reference computed at the tier's ``control_precision`` (TF32, the
precision below the cells' float32) takes the program's place on the
same requests: the upper readings.
One JSON line per seed.  A cell on several cards reads only the control
here (its runs give the program's readings); ``--rehearsal`` runs on the
CPU at the rehearsal size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)

import torch  # noqa: E402

from benchmark import cells, correctness, program  # noqa: E402
from benchmark import traffic as traffic_mod  # noqa: E402


def _requests(traffic, config, seed, device, dtype):
    client = traffic_mod.Client(traffic, config["domain"], seed, device,
                                dtype)
    return [client.draw() for _ in range(traffic["sample_requests"])]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--rehearsal", action="store_true")
    args = p.parse_args(argv)
    cell = cells.resolve(args.workload)
    traffic = dict(cell.traffic)
    if args.rehearsal:
        traffic.update(traffic["rehearsal"])
    device = torch.device("cpu" if args.rehearsal else "cuda", 0)
    sync = (lambda: None) if args.rehearsal else torch.cuda.synchronize
    dtype = program.points_dtype(traffic)
    config = cell.config
    ref = correctness.reference(config, device)

    if args.program_seeds:
        if cell.chips > 1:
            raise SystemExit("a multi-card cell's program readings come "
                             "from its runs")
        model = program.build(config, device, sync)
        engine = program.engine(model, traffic, config, device, None)
        engine.warmup()
        for seed in args.program_seeds:
            t0 = time.perf_counter()
            sample = [(i, pts, engine(pts)) for i, pts in enumerate(
                _requests(traffic, config, seed, device, dtype))]
            sync()
            numbers = correctness.deviations(ref, traffic, sample)
            print(json.dumps({"cell": cell.name, "side": "program",
                              "seed": seed, "numbers": numbers,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
            del sample
        del engine, model
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        sample = [(i, pts, None) for i, pts in enumerate(
            _requests(traffic, config, seed, device, dtype))]
        numbers = correctness.deviations(
            ref, traffic, sample, cells.tier(traffic)["control_precision"])
        print(json.dumps({"cell": cell.name, "side": "control",
                          "seed": seed, "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

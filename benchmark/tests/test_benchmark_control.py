"""The control: the plain reference computed in TF32, the precision below
the float32 that every cell states, put in the program's place, fails
each cell's limits, and the program does not.

Here on the CPU at the traffic's rehearsal size (the TF32 rounding is
explicit, so it reads the same on any device); on the card at the
cell's own size (``-m card``), as ``calibrate.py`` reads it for the
limits in ``benchmark/checks/``.
"""

import json

import pytest
import torch

from benchmark import calibrate, cells, correctness, program
from benchmark import traffic as traffic_mod

BENCH = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
ONE_CARD = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]
SEEDS = (101, 102, 103)


def _traffic(cell, rehearsal):
    traffic = dict(cell.traffic)
    if rehearsal:
        traffic.update(traffic["rehearsal"])
    return traffic


def _sample(cell, traffic, seed, device, answer=None):
    dtype = program.points_dtype(traffic)
    client = traffic_mod.Client(traffic, cell.config["domain"], seed,
                                device, dtype)
    pts = [client.draw() for _ in range(traffic["sample_requests"])]
    return [(i, p, None if answer is None else answer(p))
            for i, p in enumerate(pts)]


def _fails(numbers, limits):
    return any(not v <= limits[k] for k, v in numbers.items())


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_fails_the_cells_limits(workload, seed):
    cell = cells.resolve(workload)
    traffic = _traffic(cell, rehearsal=True)
    ref = correctness.reference(cell.config, "cpu")
    numbers = correctness.deviations(
        ref, traffic, _sample(cell, traffic, seed, "cpu"),
        cells.tier(traffic)["control_precision"])
    assert _fails(numbers, cell.checks), numbers


@pytest.mark.parametrize("workload", ONE_CARD)
def test_the_programs_answers_pass_where_the_control_fails(workload):
    cell = cells.resolve(workload)
    traffic = _traffic(cell, rehearsal=True)
    model = program.build(cell.config, "cpu", lambda: None)
    engine = program.engine(model, traffic, cell.config, "cpu", None)
    ref = correctness.reference(cell.config, "cpu")
    numbers = correctness.deviations(
        ref, traffic, _sample(cell, traffic, SEEDS[0], "cpu", engine))
    assert not _fails(numbers, cell.checks), numbers


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_the_cells_own_size(card, capsys, workload):
    calibrate.main(["--workload", workload, "--control-seeds",
                    *map(str, SEEDS)])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    limits = cells.resolve(workload).checks
    assert len(lines) == len(SEEDS)
    assert all(_fails(x["numbers"], limits) for x in lines)
    torch.cuda.empty_cache()

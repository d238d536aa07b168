"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, the plain
reference (``benchmark/reference``) evaluates the configuration's
interpolant in float64 at the points of each sampled request, for each
spec of the traffic, and the program's answers to those requests are
held against it.  For each spec the number compared is the worst over
the sample of max |program - reference| / max |reference| (the name is
``dev.<spec name>``), and each has its limit in
``benchmark/checks/<cell>.json``, with the readings it was set from.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark import cells
from benchmark.reference.interpolant import (
    Interpolant,
    block_points_for,
    deviation,
)

# Bytes a reference block's intermediates may take on a card / the CPU.
BLOCK_BYTES = {"cuda": 8 << 30, "cpu": 256 << 20}


def reference(config: dict, device) -> Interpolant:
    return Interpolant(cells.function(config["function"]), config["domain"],
                       config["n_nodes"], device=device)


def _columns(output: torch.Tensor, specs: int) -> List[torch.Tensor]:
    """A request's answers split by spec: (N,) for one spec, else the
    columns of (N, M)."""
    if specs == 1:
        return [output.reshape(-1)]
    return [output[:, m] for m in range(specs)]


def deviations(ref: Interpolant, traffic: dict,
               sample: List[Tuple[int, torch.Tensor, torch.Tensor]],
               precision: str = "float64") -> Dict[str, float]:
    """``dev.<spec>`` over ``sample``.  At ``precision="tf32"`` the
    answers are the reference's own in TF32 (the control), and the
    sample's outputs are not read."""
    specs = [tuple(s) for s in traffic["specs"]]
    names = traffic["spec_names"]
    block = block_points_for(ref.n_nodes, BLOCK_BYTES[ref.device.type])
    worst = {f"dev.{n}": 0.0 for n in names}
    if not sample:
        return {k: math.inf for k in worst}
    for _, points, output in sample:
        cols = _columns(output, len(specs)) if output is not None else None
        for m, (spec, name) in enumerate(zip(specs, names)):
            exact = ref.evaluate(points, spec, "float64", block)
            if precision == "float64":
                got = cols[m]
            else:
                got = ref.evaluate(points, spec, precision, block)
            worst[f"dev.{name}"] = max(worst[f"dev.{name}"],
                                       deviation(got, exact))
    return worst


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """Each number beside its limit; a number that is not at or under
    its limit (NaN included), or that has no limit, fails."""
    out = {}
    for name, value in numbers.items():
        limit = limits.get(name)
        ok = limit is not None and value <= limit
        out[name] = {"value": value, "limit": limit, "ok": bool(ok)}
    return out

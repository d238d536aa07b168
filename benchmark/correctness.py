"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, the plain
reference (``benchmark/reference``, through the representation's file)
evaluates the configuration's interpolant at the tier's
``reference_precision`` (float64 for the float32 tier) at the points of
each sampled request, for each spec of the traffic, and the program's
answers to those requests are held against it.  For each spec the
number compared is the worst over the sample of max |program -
reference| / max |reference| (the name is ``dev.<spec name>``), and each
has its limit in ``benchmark/checks/<cell>.json``, with the readings it
was set from.

A reference of a book (``models``: M > 1) answers (M, N) a spec, and so
does the program: the number is then the worst over the M rows of each
row's own deviation, so that a model of small values is held to its own
scale and not to the largest model's.  The control (``calibrate.py``)
takes the same path.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from benchmark import cells
from benchmark.reference.interpolant import block_points_for, deviation

# Bytes a reference block's intermediates may take on a card / the CPU.
BLOCK_BYTES = {"cuda": 8 << 30, "cpu": 256 << 20}


def reference(config: dict, device):
    """The plain reference of the configuration's representation
    (``representations/<kind>.py``)."""
    return cells.representation(config).reference(config, device)


def _columns(output: torch.Tensor, specs: int) -> List[torch.Tensor]:
    """A request's answers split by spec: the whole output for one spec,
    else the slices of its last axis, a spec's column each."""
    if specs == 1:
        return [output]
    return [output[..., m] for m in range(specs)]


def model_deviation(values: torch.Tensor, reference: torch.Tensor,
                    models: int = 1) -> float:
    """``deviation`` of ``values`` against ``reference``; of a book
    (``models`` > 1), the worst over its rows of each row's own
    ``deviation``, infinite where the two hold different numbers of
    answers."""
    if models == 1:
        return deviation(values, reference)
    if values.numel() != reference.numel():
        return math.inf
    values = values.reshape(models, -1)
    reference = reference.reshape(models, -1)
    return max(deviation(values[i], reference[i]) for i in range(models))


def deviations(ref, traffic: dict,
               sample: List[Tuple[int, torch.Tensor, torch.Tensor]],
               precision: Optional[str] = None) -> Dict[str, float]:
    """``dev.<spec>`` over ``sample``: the program's answers, or, with a
    ``precision`` (the tier's ``control_precision`` for the control), the
    reference's own at that precision, the sample's outputs unread."""
    specs = [tuple(s) for s in traffic["specs"]]
    names = traffic["spec_names"]
    models = getattr(ref, "models", 1)
    exact_precision = cells.tier(traffic)["reference_precision"]
    block = block_points_for(ref.n_nodes, BLOCK_BYTES[ref.device.type])
    worst = {f"dev.{n}": 0.0 for n in names}
    if not sample:
        return {k: math.inf for k in worst}
    for _, points, output in sample:
        cols = _columns(output, len(specs)) if output is not None else None
        for m, (spec, name) in enumerate(zip(specs, names)):
            exact = ref.evaluate(points, spec, exact_precision, block)
            if precision is None:
                got = cols[m]
            else:
                got = ref.evaluate(points, spec, precision, block)
            worst[f"dev.{name}"] = max(
                worst[f"dev.{name}"], model_deviation(got, exact, models))
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

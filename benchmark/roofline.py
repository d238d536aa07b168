"""The work a configuration's evaluation needs, and the card's peaks.

A configuration's file states its work counts (``work``), which follow
from its shapes and ranks (``flop_per_point``, ``coefficients``):

- dense, n_1 x ... x n_d values: 2 * prod(n) FLOP a point, the first
  contraction every dense route must do, and prod(n) coefficients;
- tensor train of ranks r_0..r_d: sum_k 2 * r_{k-1} * n_k * r_k FLOP a
  point, and sum_k r_{k-1} * n_k * r_k coefficients.

The least time of a batch is max(FLOP / peak FLOP/s, bytes / peak
bytes/s), with bytes = the points read once + the outputs written once
+ the coefficients read once a request, against the published dense
peak of the unit that the dtype's accurate routes can use
(``peaks.json``).
"""

from __future__ import annotations

import math
from typing import Optional

from benchmark import cells

ITEMSIZE = {"float32": 4, "float64": 8}


def work_counts(config: dict) -> dict:
    """The work counts that ``config``'s shapes and ranks give."""
    n = [int(x) for x in config["n_nodes"]]
    rep = config["representation"]
    if rep["kind"] == "dense":
        return {"flop_per_point": 2 * math.prod(n),
                "coefficients": math.prod(n)}
    if rep["kind"] == "to_tt":
        r = [int(x) for x in rep["ranks"]]
        cores = [r[k] * n[k] * r[k + 1] for k in range(len(n))]
        return {"flop_per_point": 2 * sum(cores), "coefficients": sum(cores)}
    raise ValueError(f"unknown representation {rep['kind']!r}")


def peaks(device_kind: str) -> Optional[dict]:
    return cells.load_json(cells.HERE / "peaks.json")["devices"].get(
        device_kind)


def flop_seconds(config: dict, traffic: dict, points: int,
                 device_kind: str) -> Optional[float]:
    """The seconds the FLOP of ``points`` points of ``traffic`` take at
    the card's published peak; None for a card with no peaks here."""
    peak = peaks(device_kind)
    if peak is None:
        return None
    flop = config["work"]["flop_per_point"] * len(traffic["specs"]) * points
    return flop / peak["flop_per_s"][traffic["dtype"]]


def least_seconds(config: dict, traffic: dict, points: int, requests: int,
                  device_kind: str) -> Optional[float]:
    """The least seconds the card ``device_kind`` could take to answer
    ``points`` points over ``requests`` requests of ``traffic``; None for
    a card with no published peaks here."""
    peak = peaks(device_kind)
    if peak is None:
        return None
    specs = len(traffic["specs"])
    moved = ITEMSIZE[traffic["dtype"]] * (
        points * (config["dims"] + specs)
        + requests * specs * config["work"]["coefficients"])
    return max(flop_seconds(config, traffic, points, device_kind),
               moved / peak["bytes_per_s"])

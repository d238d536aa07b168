"""The work a configuration's evaluation needs, and the card's peaks.

A configuration's file states its work counts (``work``), which follow
from its shapes and ranks as its representation's file counts them
(``representations/<kind>.py``, ``work_counts``): ``flop_per_point`` and
``coefficients``, and ``outputs_per_point`` where a point has more than
one output a spec (a book of M models writes M), 1 where it is not
stated.

The least time of a batch is max(FLOP / peak FLOP/s, bytes / peak
bytes/s), with bytes = the points read once + the outputs written once
+ the coefficients read once a request, each of the tier's bytes an item
(``tiers/<dtype>.json``), against the published dense peak of the unit
that the tier's accurate routes can use (``peaks.json``, under the
tier's ``peak``).
"""

from __future__ import annotations

from typing import Optional

from benchmark import cells


def work_counts(config: dict) -> dict:
    """The work counts that ``config``'s shapes and ranks give."""
    return cells.representation(config).work_counts(config)


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
    return flop / peak["flop_per_s"][cells.tier(traffic)["peak"]]


def least_seconds(config: dict, traffic: dict, points: int, requests: int,
                  device_kind: str) -> Optional[float]:
    """The least seconds the card ``device_kind`` could take to answer
    ``points`` points over ``requests`` requests of ``traffic``; None for
    a card with no published peaks here."""
    peak = peaks(device_kind)
    if peak is None:
        return None
    return max(flop_seconds(config, traffic, points, device_kind),
               bytes_moved(config, traffic, points, requests)
               / peak["bytes_per_s"])


def bytes_moved(config: dict, traffic: dict, points: int,
                requests: int) -> int:
    """The bytes ``points`` points over ``requests`` requests of
    ``traffic`` move at the least: each point's coordinates read once,
    its ``outputs_per_point`` outputs a spec written once, and the
    coefficients of every spec read once a request."""
    work = config["work"]
    specs = len(traffic["specs"])
    outputs = specs * work.get("outputs_per_point", 1)
    return cells.tier(traffic)["itemsize"] * (
        points * (config["dims"] + outputs)
        + requests * specs * work["coefficients"])

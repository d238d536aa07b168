"""dense: the configuration's function on its Chebyshev grid, one value a
node (``ChebyshevApproximation``); n_1 x ... x n_d values.

Its work is the first contraction every dense route must do, 2 * prod(n)
FLOP a point, over prod(n) coefficients.
"""

from __future__ import annotations

import contextlib
import math

from benchmark import cells
from benchmark.reference.interpolant import Interpolant


def build(config: dict, device, phase=contextlib.nullcontext):
    from pychebyshev_tpu_torch import ChebyshevApproximation

    values = cells.function(config["function"])
    with phase("build"):
        model = ChebyshevApproximation(
            lambda points, _data=None: values(points), config["dims"],
            config["domain"], config["n_nodes"], vectorized=True,
            device=device)
        model.build(verbose=False)
    return model


def work_counts(config: dict) -> dict:
    n = [int(x) for x in config["n_nodes"]]
    return {"flop_per_point": 2 * math.prod(n), "coefficients": math.prod(n)}


def reference(config: dict, device) -> Interpolant:
    return Interpolant(cells.function(config["function"]), config["domain"],
                       config["n_nodes"], device=device)

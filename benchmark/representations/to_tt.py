"""to_tt: the dense interpolant compressed by TT-SVD of its value tensor
(``ChebyshevApproximation.to_tt`` at the configuration's ``tolerance``),
which must give the configuration's ``ranks``: its work counts follow
from them.

A tensor train of ranks r_0..r_d does sum_k 2 * r_{k-1} * n_k * r_k FLOP
a point over sum_k r_{k-1} * n_k * r_k coefficients.  It interpolates the
same values at the same nodes as the dense one to the tolerance, so the
reference is the dense interpolant's.
"""

from __future__ import annotations

import contextlib

from benchmark.representations import dense


def build(config: dict, device, phase=contextlib.nullcontext):
    model = dense.build(config, device, phase)
    rep = config["representation"]
    with phase("to_tt"):
        tt = model.to_tt(tolerance=rep["tolerance"])
    if list(tt.tt_ranks) != list(rep["ranks"]):
        raise RuntimeError(
            f"to_tt(tolerance={rep['tolerance']}) gave ranks "
            f"{list(tt.tt_ranks)}; the configuration states "
            f"{rep['ranks']}, and its work counts follow from them")
    return tt


def work_counts(config: dict) -> dict:
    n = [int(x) for x in config["n_nodes"]]
    r = [int(x) for x in config["representation"]["ranks"]]
    cores = [r[k] * n[k] * r[k + 1] for k in range(len(n))]
    return {"flop_per_point": 2 * sum(cores), "coefficients": sum(cores)}


reference = dense.reference

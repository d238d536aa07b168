"""Carry a built interpolant across from the JAX package.

The state travels as plain NumPy (no JAX import here): a dict with the
keys ``tensor_values``, ``domain``, ``n_nodes``, ``nodes``, ``weights``,
``diff_matrices`` and ``max_derivative_order``, as read off a JAX
``ChebyshevApproximation``.  The port recomputes its own grid metadata
and holds it bitwise to the state's, so the two packages are known to
evaluate on the same grid.  The ``.pcb`` route (``save(format="binary")``
there, ``load`` here) gives the same object.

``tt_from_jax_state`` does the same for a JAX ``ChebyshevTT``: its state
(what its ``__getstate__`` holds) as plain NumPy, with the coefficient
cores carried over bit for bit.

``spline_from_jax_state`` and ``slider_from_jax_state`` carry a JAX
``ChebyshevSpline`` or ``ChebyshevSlider`` across: the state's pieces or
slides are dense states as above (each checked the same way), beside
the family's own metadata.
"""

from __future__ import annotations

import numpy as np

__all__ = ["from_jax_state", "tt_from_jax_state", "spline_from_jax_state",
           "slider_from_jax_state"]

_KEYS = ("tensor_values", "domain", "n_nodes", "nodes", "weights",
         "diff_matrices", "max_derivative_order")
_SPLINE_KEYS = ("domain", "n_nodes", "knots", "max_derivative_order",
                "pieces")
_SLIDER_KEYS = ("domain", "n_nodes", "partition", "pivot_point",
                "pivot_value", "max_derivative_order", "slides")
_TT_KEYS = ("_coeff_cores", "domain", "n_nodes", "_dim_order", "max_rank",
            "tolerance", "max_sweeps", "max_derivative_order", "method",
            "_total_build_evals")


def _bitwise_equal(a, b) -> bool:
    a = np.ascontiguousarray(a, dtype=np.float64)
    b = np.ascontiguousarray(b, dtype=np.float64)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def from_jax_state(state: dict, *, device):
    """The port's built ``ChebyshevApproximation`` on ``device`` from a
    JAX interpolant's state.  Raises ValueError if a key is missing or
    the recomputed nodes, weights or differentiation matrices differ
    from the state's in any bit."""
    from pychebyshev_tpu_torch.models.approximation import (
        ChebyshevApproximation,
    )

    missing = [k for k in _KEYS if k not in state]
    if missing:
        raise ValueError(f"state lacks {missing}")
    n_nodes = [int(n) for n in state["n_nodes"]]
    obj = ChebyshevApproximation.from_values(
        np.asarray(state["tensor_values"], dtype=np.float64), len(n_nodes),
        [list(map(float, b)) for b in state["domain"]], n_nodes,
        max_derivative_order=int(state["max_derivative_order"]),
        device=device)
    host = obj._host_grid
    ours = {"nodes": host["nodes"], "weights": host["weights"],
            "diff_matrices": [m.T for m in host["diffs_t"]]}
    for key, arrays in ours.items():
        theirs = state[key]
        if len(theirs) != len(arrays):
            raise ValueError(f"{key}: {len(theirs)} dims in the state, "
                             f"{len(arrays)} recomputed")
        for d, (a, b) in enumerate(zip(arrays, theirs)):
            if not _bitwise_equal(a, b):
                raise ValueError(
                    f"{key}[{d}] recomputed by the port differs from the "
                    f"state's (not bitwise equal)")
    return obj


def tt_from_jax_state(state: dict, *, device):
    """The port's built ``ChebyshevTT`` on ``device`` from a JAX
    ``ChebyshevTT``'s state, cores bitwise equal (private copies).

    Raises ValueError if a key is missing, a core is not a 3-D array
    whose node count matches ``n_nodes``, the bond chain is inconsistent
    (unit outer bonds, each core's right bond equal to the next one's
    left), or ``_dim_order`` is not a permutation.
    """
    from pychebyshev_tpu_torch.models.tensor_train import ChebyshevTT

    missing = [k for k in _TT_KEYS if k not in state]
    if missing:
        raise ValueError(f"state lacks {missing}")
    n_nodes = [int(n) for n in state["n_nodes"]]
    d = len(n_nodes)
    cores = [np.array(c, dtype=np.float64, order="C")
             for c in state["_coeff_cores"]]
    if len(cores) != d or len(state["domain"]) != d:
        raise ValueError(
            f"{len(cores)} cores and {len(state['domain'])} domain rows "
            f"for {d} entries of n_nodes")
    for k, c in enumerate(cores):
        if c.ndim != 3 or c.shape[1] != n_nodes[k]:
            raise ValueError(
                f"_coeff_cores[{k}] has shape {c.shape}; expected "
                f"(r_left, {n_nodes[k]}, r_right)")
    bonds = [cores[0].shape[0]] + [c.shape[2] for c in cores]
    if bonds[0] != 1 or bonds[-1] != 1 or any(
            a.shape[2] != b.shape[0] for a, b in zip(cores, cores[1:])):
        raise ValueError(
            f"inconsistent TT bond chain: core shapes "
            f"{[c.shape for c in cores]}")
    dim_order = [int(k) for k in state["_dim_order"]]
    if sorted(dim_order) != list(range(d)):
        raise ValueError(f"_dim_order {dim_order} is not a permutation of "
                         f"range({d})")
    obj = ChebyshevTT._from_coeff_cores(
        cores, [list(map(float, b)) for b in state["domain"]], n_nodes,
        dim_order=dim_order, max_rank=int(state["max_rank"]),
        tolerance=state["tolerance"],
        max_derivative_order=int(state["max_derivative_order"]),
        additional_data=state.get("additional_data"),
        descriptor=state.get("descriptor", ""), method=state["method"],
        device=device)
    obj.max_sweeps = state["max_sweeps"]
    obj._total_build_evals = int(state["_total_build_evals"])
    return obj


def _check_keys(state: dict, keys) -> None:
    missing = [k for k in keys if k not in state]
    if missing:
        raise ValueError(f"state lacks {missing}")


def spline_from_jax_state(state: dict, *, device):
    """The port's built ``ChebyshevSpline`` on ``device`` from a JAX
    spline's state: ``domain``, ``n_nodes`` (flat or nested), ``knots``,
    ``max_derivative_order`` and ``pieces`` (one dense state per piece,
    C-order over the piece grid).  Raises ValueError if a key is missing,
    the piece count does not match the knots, or a piece's sub-domain is
    not its cell of the knot grid; each piece is checked as in
    :func:`from_jax_state`."""
    from pychebyshev_tpu_torch.models.spline import ChebyshevSpline

    _check_keys(state, _SPLINE_KEYS)
    knots = [[float(k) for k in kd] for kd in state["knots"]]
    domain = [list(map(float, b)) for b in state["domain"]]
    intervals = ChebyshevSpline._compute_intervals(len(domain), domain,
                                                   knots)
    cells = list(np.ndindex(*[len(iv) for iv in intervals]))
    if len(state["pieces"]) != len(cells):
        raise ValueError(f"{len(state['pieces'])} pieces in the state, "
                         f"{len(cells)} cells in its knot grid")
    pieces = []
    for i, (piece_state, cell) in enumerate(zip(state["pieces"], cells)):
        want = [list(intervals[d][cell[d]]) for d in range(len(domain))]
        if [list(map(float, b)) for b in piece_state["domain"]] != want:
            raise ValueError(f"piece {i} covers {piece_state['domain']}, "
                             f"not its cell {want}")
        pieces.append(from_jax_state(piece_state, device=device))
    n_nodes = [list(map(int, n)) if isinstance(n, (list, tuple))
               else (None if n is None else int(n))
               for n in state["n_nodes"]]
    return ChebyshevSpline._assemble(
        num_dimensions=len(domain), domain=domain, n_nodes=n_nodes,
        knots=knots, pieces=pieces,
        max_derivative_order=int(state["max_derivative_order"]),
        device=device)


def slider_from_jax_state(state: dict, *, device):
    """The port's built ``ChebyshevSlider`` on ``device`` from a JAX
    slider's state: ``domain``, ``n_nodes``, ``partition``,
    ``pivot_point``, ``pivot_value``, ``max_derivative_order`` and
    ``slides`` (one dense state per group).  Raises ValueError if a key
    is missing, the partition does not cover the dims once, or a slide's
    grid is not its group's; each slide is checked as in
    :func:`from_jax_state`."""
    from pychebyshev_tpu_torch.models.slider import ChebyshevSlider

    _check_keys(state, _SLIDER_KEYS)
    domain = [list(map(float, b)) for b in state["domain"]]
    n_nodes = [int(n) for n in state["n_nodes"]]
    partition = [[int(d) for d in g] for g in state["partition"]]
    if sorted(d for g in partition for d in g) != list(range(len(domain))):
        raise ValueError(f"partition {partition} does not cover "
                         f"range({len(domain)}) exactly once")
    if len(state["slides"]) != len(partition):
        raise ValueError(f"{len(state['slides'])} slides for "
                         f"{len(partition)} groups")
    slides = []
    for group, slide_state in zip(partition, state["slides"]):
        if ([int(n) for n in slide_state["n_nodes"]]
                != [n_nodes[d] for d in group]
                or [list(map(float, b)) for b in slide_state["domain"]]
                != [domain[d] for d in group]):
            raise ValueError(f"the slide of group {group} is not on the "
                             f"group's grid")
        slides.append(from_jax_state(slide_state, device=device))
    return ChebyshevSlider._assemble(
        num_dimensions=len(domain), domain=domain, n_nodes=n_nodes,
        partition=partition,
        pivot_point=[float(x) for x in state["pivot_point"]],
        slides=slides, pivot_value=float(state["pivot_value"]),
        max_derivative_order=int(state["max_derivative_order"]),
        device=device)

"""Carry a built interpolant across from the JAX package.

The state travels as plain NumPy (no JAX import here): a dict with the
keys ``tensor_values``, ``domain``, ``n_nodes``, ``nodes``, ``weights``,
``diff_matrices`` and ``max_derivative_order``, as read off a JAX
``ChebyshevApproximation``.  The port recomputes its own grid metadata
and holds it bitwise to the state's, so the two packages are known to
evaluate on the same grid.  The ``.pcb`` route (``save(format="binary")``
there, ``load`` here) gives the same object.
"""

from __future__ import annotations

import numpy as np

__all__ = ["from_jax_state"]

_KEYS = ("tensor_values", "domain", "n_nodes", "nodes", "weights",
         "diff_matrices", "max_derivative_order")


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

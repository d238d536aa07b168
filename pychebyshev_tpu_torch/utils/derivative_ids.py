"""Shared derivative-id registry (MoCaX ergonomics surface).

One implementation of the id registry and the orders-xor-id resolution
shared by ChebyshevApproximation, ChebyshevSpline, and ChebyshevSlider
(the logic was previously triplicated verbatim, which is exactly how
one surface grows validation its siblings lack).  Host objects expose
``num_dimensions``, ``max_derivative_order``,
``_derivative_id_registry`` (dict), and ``_derivative_id_to_orders``
(list).
"""

from __future__ import annotations

import numpy as np

__all__ = ["register_derivative_id", "resolve_derivative_args"]


def register_derivative_id(obj, derivative_order) -> int:
    """Stable session-local id for a derivative-orders tuple."""
    if len(derivative_order) != obj.num_dimensions:
        raise ValueError(
            f"derivative_order length {len(derivative_order)} does not "
            f"match num_dimensions {obj.num_dimensions}"
        )
    for d, o in enumerate(derivative_order):
        if not isinstance(o, (int, np.integer)):
            raise ValueError(
                f"derivative_order[{d}] must be int, got "
                f"{type(o).__name__}"
            )
        if o < 0 or o > obj.max_derivative_order:
            raise ValueError(
                f"derivative_order[{d}]={o} out of range "
                f"[0, {obj.max_derivative_order}]"
            )
    key = tuple(int(o) for o in derivative_order)
    if key in obj._derivative_id_registry:
        return obj._derivative_id_registry[key]
    new_id = len(obj._derivative_id_to_orders)
    obj._derivative_id_registry[key] = new_id
    obj._derivative_id_to_orders.append(key)
    return new_id


def resolve_derivative_args(obj, derivative_order, derivative_id):
    """Resolve orders xor id; raises on both/neither/unknown."""
    if derivative_order is not None and derivative_id is not None:
        raise ValueError(
            "provide exactly one of derivative_order or derivative_id, "
            "not both"
        )
    if derivative_order is None and derivative_id is None:
        raise ValueError("must provide derivative_order or derivative_id")
    if derivative_id is not None:
        if (derivative_id < 0
                or derivative_id >= len(obj._derivative_id_to_orders)):
            raise KeyError(
                f"unknown derivative_id {derivative_id}; "
                f"register via get_derivative_id() first"
            )
        return list(obj._derivative_id_to_orders[derivative_id])
    if len(derivative_order) != obj.num_dimensions:
        raise ValueError(
            f"derivative_order length {len(derivative_order)} does "
            f"not match num_dimensions {obj.num_dimensions}"
        )
    return derivative_order

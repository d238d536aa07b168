"""Compatibility checks for interpolant arithmetic.

A copy of ``pychebyshev_tpu.utils.algebra`` (framework-free): the scalar
predicate and the cross-object compatibility validation shared by the
dense, spline and slider operators.  The reference's name aliases for
the TT core algebra are left out (``models.tt_algorithms`` has it, and
nothing here calls them).
"""

from __future__ import annotations

import numpy as np

__all__ = ["is_scalar", "check_compatible"]


def is_scalar(value) -> bool:
    """True if *value* is a plain numeric scalar (int, float, numpy scalar)."""
    return isinstance(value, (int, float, np.integer, np.floating))


def check_compatible(a, b) -> None:
    """Validate that two interpolants can be combined arithmetically.

    Requires: same concrete type, both built, identical num_dimensions,
    n_nodes, domain (allclose) and max_derivative_order.
    """
    if type(a) is not type(b):
        raise TypeError(
            f"Cannot combine {type(a).__name__} with {type(b).__name__}; "
            f"operands must be the same type."
        )

    a_built = (getattr(a, "tensor_values", None) is not None) or getattr(a, "_built", False)
    b_built = (getattr(b, "tensor_values", None) is not None) or getattr(b, "_built", False)
    if not a_built:
        raise RuntimeError("Left operand is not built. Call build() first.")
    if not b_built:
        raise RuntimeError("Right operand is not built. Call build() first.")

    if a.num_dimensions != b.num_dimensions:
        raise ValueError(
            f"Dimension mismatch: {a.num_dimensions} vs {b.num_dimensions}"
        )
    if not np.array_equal(np.asarray(a.n_nodes, dtype=int),
                          np.asarray(b.n_nodes, dtype=int)):
        raise ValueError(f"Node count mismatch: {a.n_nodes} vs {b.n_nodes}")
    if not np.allclose(np.asarray(a.domain, dtype=float),
                       np.asarray(b.domain, dtype=float)):
        raise ValueError(f"Domain mismatch: {a.domain} vs {b.domain}")
    if a.max_derivative_order != b.max_derivative_order:
        raise ValueError(
            f"max_derivative_order mismatch: "
            f"{a.max_derivative_order} vs {b.max_derivative_order}"
        )


"""A book of products on one Chebyshev grid, evaluated plainly.

Product m of a book is its function at the points shifted by
``shifts[m]`` (one offset a dimension: a strike or a maturity moved),
times ``quantities[m]`` (1 where none is given).  ``Book`` interpolates
each product on the shared grid as its own ``Interpolant`` (the node
values worked out from the function, nothing from the program) and
evaluates all of them at a batch of points: (M, N) values, one row a
product, as a book engine answers.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from benchmark.reference.interpolant import Interpolant


def product(function: Callable, shift: Sequence[float],
            quantity: float = 1.0) -> Callable:
    """``quantity * function(points + shift)``, host float64."""
    offset = np.asarray(shift, dtype=np.float64)

    def values(points) -> np.ndarray:
        return quantity * np.asarray(
            function(np.asarray(points, dtype=np.float64) + offset),
            dtype=np.float64)
    return values


class Book:
    """The M products of ``function`` given by ``shifts`` and
    ``quantities``, each interpolated on the ``n_nodes`` grid of
    ``domain``, with their values on ``device``."""

    def __init__(self, function: Callable, domain, n_nodes,
                 shifts: Sequence[Sequence[float]],
                 quantities: Optional[Sequence[float]] = None, *, device):
        if quantities is None:
            quantities = [1.0] * len(shifts)
        if len(quantities) != len(shifts):
            raise ValueError(f"{len(shifts)} shifts and {len(quantities)} "
                             f"quantities; a product has one of each")
        self.members = [
            Interpolant(product(function, s, float(q)), domain, n_nodes,
                        device=device)
            for s, q in zip(shifts, quantities)]
        self.models = len(self.members)
        self.n_nodes = self.members[0].n_nodes
        self.device = self.members[0].device

    def evaluate(self, points: torch.Tensor, orders: Sequence[int],
                 precision: str = "float64",
                 block_points: int = 1 << 15) -> torch.Tensor:
        """(N, d) points -> (M, N) float64 values of every product's
        ``orders`` derivative, at ``precision`` (``Interpolant``)."""
        return torch.stack([m.evaluate(points, orders, precision,
                                       block_points)
                            for m in self.members])

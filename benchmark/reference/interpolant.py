"""The dense Chebyshev interpolant of a function, evaluated plainly.

``Interpolant`` computes the function's values at the tensor grid
(NumPy, float64), keeps them on a device as one float64 tensor, and
evaluates the interpolant or any of its partial derivatives at a batch
of points by the barycentric formula, one dimension at a time:

    p(x) = sum_{i_1..i_d} V[i_1, .., i_d] * prod_k c_k(x_k)[i_k],
    c_k(x)[i] = (w_i / (x - x_i)) / sum_j w_j / (x - x_j),

with c_k(x) the one-hot row when x is a node.  A derivative spec
applies each dimension's differentiation matrix to V as often as its
order says before the contraction.

``precision="float64"`` is the reference.  ``precision="tf32"`` is the
control: the same contraction with every product's operands rounded to
TF32 (10 stored mantissa bits, round to nearest even) and float32 sums,
which is what float32 matrix products on the tensor cores compute.  The
rounding is done explicitly, so the control reads the same on any
device.  Points are taken as given (the program's float32 points are
exact in float64).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

from benchmark.reference import chebyshev

PRECISIONS = ("float64", "tf32")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32, to nearest with ties to even."""
    bits = x.contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0x0FFF
    return ((bits + bias) & -0x2000).view(torch.float32)


class Interpolant:
    """The interpolant of ``function`` on the ``n_nodes`` Chebyshev grid
    of ``domain``, with its values on ``device``."""

    def __init__(self, function: Callable, domain, n_nodes, *, device):
        self.device = torch.device(device)
        self.domain = [(float(lo), float(hi)) for lo, hi in domain]
        self.n_nodes = [int(n) for n in n_nodes]
        self.nodes = [chebyshev.nodes(lo, hi, n)
                      for (lo, hi), n in zip(self.domain, self.n_nodes)]
        self.weights = [chebyshev.barycentric_weights(x) for x in self.nodes]
        self.diffs = [chebyshev.differentiation_matrix(x, w)
                      for x, w in zip(self.nodes, self.weights)]
        grid = chebyshev.grid_points(self.domain, self.n_nodes)
        values = np.asarray(function(grid), dtype=np.float64)
        self.values = torch.tensor(values.reshape(self.n_nodes),
                                   dtype=torch.float64, device=self.device)

    def spec_tensor(self, orders: Sequence[int]) -> torch.Tensor:
        """The values of the derivative ``orders`` at the grid, float64."""
        t = self.values
        for d, k in enumerate(orders):
            if k:
                dk = torch.tensor(np.linalg.matrix_power(self.diffs[d], k),
                                  dtype=torch.float64, device=self.device)
                t = torch.movedim(torch.tensordot(dk, t, dims=([1], [d])),
                                  0, d)
        return t.contiguous()

    def _rows(self, x: torch.Tensor, d: int) -> torch.Tensor:
        """(B, n_d) barycentric rows of the coordinates ``x`` in dim d,
        in ``x``'s dtype."""
        nodes = torch.tensor(self.nodes[d], dtype=x.dtype, device=x.device)
        weights = torch.tensor(self.weights[d], dtype=x.dtype,
                               device=x.device)
        gap = x[:, None] - nodes[None, :]
        hit = gap == 0
        q = weights[None, :] / torch.where(hit, torch.ones_like(gap), gap)
        rows = q / q.sum(dim=1, keepdim=True)
        return torch.where(hit.any(dim=1, keepdim=True), hit.to(x.dtype),
                           rows)

    def evaluate(self, points: torch.Tensor, orders: Sequence[int],
                 precision: str = "float64",
                 block_points: int = 1 << 15) -> torch.Tensor:
        """(N, d) points -> (N,) float64 values of the ``orders``
        derivative, computed at ``precision``, ``block_points`` at a
        time."""
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        low = precision == "tf32"
        dtype = torch.float32 if low else torch.float64
        tensor = self.spec_tensor(orders).to(dtype)
        if low:
            tensor = tf32(tensor)
        last = self.n_nodes[-1]
        flat = tensor.reshape(-1, last).T.contiguous()   # (n_d, rest)
        points = points.to(device=self.device)
        out = torch.empty(points.shape[0], dtype=torch.float64,
                          device=self.device)
        for start in range(0, points.shape[0], block_points):
            x = points[start:start + block_points].to(dtype)
            rows = [self._rows(x[:, d], d) for d in range(len(self.n_nodes))]
            if low:
                rows = [tf32(r) for r in rows]
            acc = rows[-1] @ flat                        # (B, rest)
            for d in range(len(self.n_nodes) - 2, -1, -1):
                if low:
                    acc = tf32(acc)
                acc = (acc.view(x.shape[0], -1, self.n_nodes[d])
                       * rows[d][:, None, :]).sum(dim=-1)
            out[start:start + x.shape[0]] = acc.reshape(-1).to(torch.float64)
        return out


def block_points_for(n_nodes: Sequence[int], budget_bytes: int) -> int:
    """Points a block may hold so that the widest intermediate of
    ``evaluate`` (two float64 arrays of prod(n_nodes[:-1]) a point)
    stays within ``budget_bytes``."""
    per_point = 2 * 8 * math.prod(n_nodes[:-1])
    return max(1, budget_bytes // per_point)


def deviation(values: torch.Tensor, reference: torch.Tensor) -> float:
    """max |values - reference| / max |reference|, in float64; infinite
    where ``values`` holds a non-finite number or differs in length."""
    values = values.reshape(-1).to(device=reference.device,
                                   dtype=torch.float64)
    if values.shape != reference.shape or not bool(
            torch.isfinite(values).all()):
        return math.inf
    scale = float(reference.abs().max())
    return float((values - reference).abs().max()) / scale

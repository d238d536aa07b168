"""The 5-D Black-Scholes call price V(S, K, T, sigma, r), host float64.

A frozen copy of the pricing function that the upstream PyChebyshev
benchmarks (docs/benchmarks.md: 5-D Black-Scholes, 11 nodes a dim).
The program under test builds its interpolant from this function, and
the plain reference computes its node values from it: both sides get
the same input, and neither takes the other's values.
"""

from __future__ import annotations

import numpy as np
from scipy.special import ndtr


def values(points) -> np.ndarray:
    """(N, 5) points (S, K, T, sigma, r) -> (N,) call prices, float64."""
    points = np.asarray(points, dtype=np.float64)
    s, k, t, sigma, r = (points[:, i] for i in range(5))
    sqrt_t = np.sqrt(t)
    d1 = (np.log(s / k) + (r + 0.5 * sigma ** 2) * t) / (sigma * sqrt_t)
    d2 = d1 - sigma * sqrt_t
    return s * ndtr(d1) - k * np.exp(-r * t) * ndtr(d2)

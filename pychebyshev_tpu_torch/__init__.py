"""pychebyshev_tpu_torch: the PyTorch / CUDA port of pychebyshev-tpu.

The dense slice of the library on PyTorch: full-tensor barycentric
interpolation with analytical derivatives, the portable ``.pcb`` format,
and the batched serving engines at f32, f64 and the near-f64 "dd" tier.
On a CUDA device the f32 batched path runs through a hand-written CUDA
evaluator (``ops.fused_eval``), and the dd tier through its f64
instance (``ops.fused_dd``).

Every constructor and engine takes an explicit ``device=``; nothing here
probes for a device or falls back to another one.

Example
-------
>>> import math
>>> from pychebyshev_tpu_torch import ChebyshevApproximation
>>> def f(x, _):
...     return math.sin(x[0]) + math.sin(x[1])
>>> cheb = ChebyshevApproximation(f, 2, [[-1, 1], [-1, 1]], [11, 11],
...                               device="cpu")
>>> cheb.build(verbose=False)
>>> round(cheb.vectorized_eval([0.5, 0.3], [0, 0]), 4)
0.7764
"""

from __future__ import annotations

from dataclasses import dataclass

from pychebyshev_tpu_torch._version import __version__


@dataclass(frozen=True)
class Domain:
    """Typed container for an interpolant's per-dimension bounds."""

    bounds: list


@dataclass(frozen=True)
class Ns:
    """Typed container for per-dimension node counts (``list[int]``)."""

    counts: list


from pychebyshev_tpu_torch.models.approximation import (  # noqa: E402
    ChebyshevApproximation,
)
from pychebyshev_tpu_torch.serving import (  # noqa: E402
    BatchedEvaluator,
    MultiSpecEvaluator,
)

__all__ = [
    "BatchedEvaluator",
    "ChebyshevApproximation",
    "Domain",
    "MultiSpecEvaluator",
    "Ns",
    "__version__",
]

"""pychebyshev_tpu_torch: the PyTorch / CUDA port of pychebyshev-tpu.

The dense, tensor-train, spline and slider slices of the library on
PyTorch:

- ``ChebyshevApproximation``: full-tensor barycentric interpolation with
  analytical derivatives and the portable ``.pcb`` format.  On a CUDA
  device the f32 batched path runs through a hand-written CUDA evaluator
  (``ops.fused_eval``), and the dd tier through its f64 instance
  (``ops.fused_dd``).
- ``ChebyshevTT``: tensor-train interpolation (TT-Cross, TT-SVD, ALS
  builds on the host; batched chains on the device), and
  ``ChebyshevApproximation.to_tt`` for exact-compression serving.
- ``ChebyshevSpline``: piecewise interpolation at knots (also what
  ``ChebyshevApproximation(..., special_points=...)`` returns), routed
  in f64 on the device.
- ``ChebyshevSlider``: the additive (sliding) decomposition over a
  partition of the dims, and its exact ``to_tt``.
- The serving engines at f32, f64 and the near-f64 "dd" tier:
  ``BatchedEvaluator``, ``MultiSpecEvaluator`` (dense, spline and
  slider) and ``MultiModelEvaluator`` (books of dense or TT models).
- Single points are answered on the host, through the C kernels of
  ``cpp/hosteval.c`` where a C compiler is present (``utils.ceval``).
- Calculus on all four families: ``integrate``, box integrals and
  conditional expectations in batches (f64, f32 and "dd";
  ``ops.integrate``), roots and 1-D optima per call or for a batch of
  scenarios, ``extrude``/``slice``, ``ChebyshevTT.to_slider``, and
  ``serving.integrate_book`` for a dense book.
- Fits from scattered samples on all four families (``fit``; host f64,
  or accumulated on the device in f32 or f64, ``utils.fitting``),
  ``ChebyshevTT.run_completion``, ``hadamard``/``compose``, the Sobol
  indices, the plots, the pickle-free ``.npz`` format, and dense books
  (``serving.build_book``, ``save_book``/``load_book``).
- Global calculus on all four families: the certified global
  ``minimize``/``maximize`` (``dim=None``), ``critical_points`` and
  ``solve_system`` (coefficient-space branch-and-bound,
  ``ops.subdivision``, with the box statistics of large dense tensors
  computed in f64 on the model's device; ``utils.globalcalc``).
- Multi-device execution over ``torch.distributed`` device meshes
  (``parallel.sharding``, ``parallel.tt_pipeline``): data-, tensor- and
  pipeline-parallel queries, sharded builds and box integrals, and
  ``mesh=`` on the engines, ``build_book``, the TT builds and every fit.

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


@dataclass(frozen=True)
class SpecialPoints:
    """Typed container for per-dimension kink/knot locations
    (``list[list[float]]``)."""

    knots_per_dim: list


from pychebyshev_tpu_torch.models.approximation import (  # noqa: E402
    ChebyshevApproximation,
)
from pychebyshev_tpu_torch.models.slider import (  # noqa: E402
    ChebyshevSlider,
)
from pychebyshev_tpu_torch.models.spline import (  # noqa: E402
    ChebyshevSpline,
)
from pychebyshev_tpu_torch.models.tensor_train import (  # noqa: E402
    ChebyshevTT,
)
from pychebyshev_tpu_torch.serving import (  # noqa: E402
    BatchedEvaluator,
    MultiModelEvaluator,
    MultiSpecEvaluator,
)
from pychebyshev_tpu_torch.utils.globalcalc import (  # noqa: E402
    CriticalPoint,
    solve_system,
)

__all__ = [
    "BatchedEvaluator",
    "ChebyshevApproximation",
    "ChebyshevSlider",
    "ChebyshevSpline",
    "ChebyshevTT",
    "CriticalPoint",
    "Domain",
    "MultiModelEvaluator",
    "MultiSpecEvaluator",
    "Ns",
    "SpecialPoints",
    "__version__",
    "solve_system",
]

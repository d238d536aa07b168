"""Host-side parallel evaluation of black-box build functions.

The fast build path is a single batched call of a vectorized function —
see ``models.approximation`` (``vectorized=True``).  This module covers
the *black-box* case: an
arbitrary Python callable ``f(point, data) -> float`` that cannot be
traced, where the only available parallelism is host processes
(reference ``_parallel.py``).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np

__all__ = ["normalize_n_workers", "evaluate_in_parallel"]


def normalize_n_workers(n_workers: Optional[int]) -> Optional[int]:
    """Normalize the ``n_workers`` constructor kwarg.

    ``None`` -> sequential; ``-1`` -> cpu_count; ``>= 1`` -> that many
    workers.  Raises ValueError for 0 or other negatives.
    """
    if n_workers is None:
        return None
    if isinstance(n_workers, bool) or not isinstance(
            n_workers, (int, np.integer)):
        raise ValueError(
            f"n_workers must be int or None, got {type(n_workers).__name__}"
        )
    if n_workers == -1:
        return os.cpu_count() or 1
    if n_workers < 1:
        raise ValueError(
            f"n_workers must be None, -1, or >= 1; got {n_workers}"
        )
    return int(n_workers)


class _Worker:
    """Picklable wrapper binding (function, data) for pool dispatch."""

    def __init__(self, function: Callable, data):
        self.function = function
        self.data = data

    def __call__(self, point):
        return float(self.function(point, self.data))


def evaluate_in_parallel(function: Callable, points: List[List[float]],
                         additional_data, n_workers: int) -> np.ndarray:
    """Evaluate ``function`` at every point using a process pool.

    Returns a flat float64 array in the order of ``points``.
    """
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    worker = _Worker(function, additional_data)
    # Default spawn (not fork): the parent process runs a multithreaded
    # torch runtime, and forking a threaded process can deadlock.  Set
    # PYCHEBYSHEV_MP_CONTEXT=fork for reference-compatible fork
    # semantics (children inherit module state; needed when the build
    # function's module is not importable from a fresh interpreter).
    method = os.environ.get("PYCHEBYSHEV_MP_CONTEXT", "spawn")
    ctx = multiprocessing.get_context(method)
    with ProcessPoolExecutor(max_workers=n_workers, mp_context=ctx) as pool:
        results = list(pool.map(worker, points, chunksize=max(
            1, len(points) // (n_workers * 4) if n_workers else 1)))
    return np.asarray(results, dtype=np.float64)

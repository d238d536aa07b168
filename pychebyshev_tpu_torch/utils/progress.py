"""Optional tqdm progress wrapper (active at verbose=2).

A copy of ``pychebyshev_tpu.utils.progress``: the host-loop builds of
the dense, spline and slider classes wrap their loops in it."""

from __future__ import annotations

import warnings

__all__ = ["progress_iter"]


def progress_iter(iterable, total=None, enabled=False, desc=None):
    """Wrap *iterable* in a tqdm bar when ``enabled`` and tqdm is present.

    Falls back to the raw iterable (with a one-time warning) when tqdm is
    unavailable.
    """
    if not enabled:
        return iterable
    try:
        from tqdm import tqdm
    except ImportError:
        warnings.warn(
            "verbose=2 requested a progress bar but tqdm is not installed; "
            "continuing without one",
            UserWarning,
            stacklevel=2,
        )
        return iterable
    return tqdm(iterable, total=total, desc=desc)

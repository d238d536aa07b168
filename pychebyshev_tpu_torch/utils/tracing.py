"""Spans at the boundaries of a request's path through the port.

``span(name)`` is a ``torch.profiler.record_function`` while a torch
profiler is recording, and a shared no-op context otherwise: tracing is
on exactly when someone profiles, and costs one check of the profiler's
state a span when no one does (an unchecked ``record_function`` costs
tens of times more).  The spans land in the profiler's Chrome trace as
``user_annotation`` events, on the clock of its device events, and nest
by time on the host thread.

A name's first dotted part is its layer:

- ``serve``: one request on the host, each engine's ``__call__``
  (``serving.py``); inside it ``serve.intake`` (points in, the shape
  check, the knot guard), ``serve.dd_check`` (a dd engine's domain read)
  and ``serve.join`` (joining the slices), and ``serve.gather`` (the
  data-parallel ``all_gather`` under a mesh, ``parallel/sharding.py``);
- ``route``: ``route.<route>`` around each slice's run of the route the
  engine chose at construction (``route.fused_eval``, ``route.eval``,
  ``route.eval_dd``, ``route.eval_dd_tp``, ``route.eval_models``,
  ``route.tt_eval``, ``route.fused_tt_eval``, ``route.tt_eval_dd``,
  ``route.spline``, ``route.slider``); inside it ``route.operands`` (the fused kernels'
  operand cache, packing on a miss), ``route.kernel_launch`` (a fused
  kernel's argument set-up and launch) and ``route.tt_prepare`` (the TT
  chain's per-call set-up).
"""

from __future__ import annotations

import contextlib

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

__all__ = ["span"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a span while a torch profiler
    records, and does nothing otherwise."""
    if _profiler_enabled():
        return record_function(name)
    return _OFF

"""The program under test, built from a cell's files through the port's
public entry points: the configuration's representation
(``representations/<kind>.py``), the traffic's serving engine
(``engines/<engine>.py``) at its precision tier (``tiers/<dtype>.json``),
and ``parallel.sharding.make_mesh``.

This module, ``run.py``, ``representations/`` and ``engines/`` are the
only ones that import the port; the reference imports none of it.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Callable, Dict, List, Tuple

import torch

from benchmark import cells

PORT = "pychebyshev_tpu_torch"


def import_port() -> None:
    """Import the port, so that its import time is set-up's own phase."""
    import pychebyshev_tpu_torch  # noqa: F401


def _dtype(name: str):
    """A torch dtype by its name (``float32``), else ``name`` as it is
    (the port's ``"dd"``)."""
    dtype = getattr(torch, name, None)
    return dtype if isinstance(dtype, torch.dtype) else name


def points_dtype(traffic: dict) -> torch.dtype:
    """The dtype a request's points are drawn in."""
    return _dtype(cells.tier(traffic)["points_dtype"])


# The points' dtype of every tier by the tier's name, for scripts outside
# the harness that look a mix's ``dtype`` up here (``chip_spans.py``).
DTYPES = {path.stem: _dtype(cells.load_json(path)["points_dtype"])
          for path in sorted((cells.HERE / "tiers").glob("*.json"))}


def specs(traffic: dict) -> List[Tuple[int, ...]]:
    return [tuple(s) for s in traffic["specs"]]


def build(config: dict, device, sync: Callable[[], None],
          phase=contextlib.nullcontext):
    """The configuration's model, built on ``device``; ``phase(name)``
    times each step of it."""
    model = cells.representation(config).build(config, device, phase)
    sync()
    return model


def mesh(config: dict, device_type: str):
    """The configuration's device mesh over the whole world, or None."""
    spec = config.get("mesh")
    if spec is None:
        return None
    from pychebyshev_tpu_torch.parallel import sharding

    return sharding.make_mesh(axis_names=tuple(spec["axis_names"]),
                              device_type=device_type)


def engine_kwargs(traffic: dict, config: dict, device, device_mesh) -> dict:
    """The arguments every engine takes: the tier's dtype, the traffic's
    buckets, the device, and the mesh with its data axis."""
    kw = dict(dtype=_dtype(cells.tier(traffic)["engine_dtype"]),
              bucket_sizes=tuple(traffic["bucket_sizes"]), device=device)
    if device_mesh is not None:
        kw.update(mesh=device_mesh, data_axis=config["mesh"]["data_axis"])
    return kw


def engine(model, traffic: dict, config: dict, device, device_mesh):
    """The traffic's serving engine over ``model``."""
    return cells.engine(traffic).make(model, traffic, config, device,
                                      device_mesh)


def _counter(counter: str) -> int:
    """The port's counter ``<module>:<attribute>``, now."""
    module, attribute = counter.split(":")
    return int(getattr(importlib.import_module(f"{PORT}.{module}"),
                       attribute))


def kernel_launches() -> int:
    """Launches of the port's hand-written kernels that its own counters
    have seen: every counter of every counted kernel
    (``benchmark/kernels/``)."""
    return sum(_counter(counter) for kernel in cells.counted_kernels()
               for counter in kernel["counters"])


def counters() -> Dict[str, int]:
    """Every counter of ``benchmark/counters/``, now, by its name."""
    return {name: _counter(counter)
            for name, counter in cells.counters().items()}

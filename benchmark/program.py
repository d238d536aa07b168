"""The program under test, built from a cell's files through the port's
public entry points: ``ChebyshevApproximation`` (and ``to_tt``), the
serving engines, and ``parallel.sharding.make_mesh``.

This module and ``run.py`` are the only ones that import the port; the
reference imports none of it.
"""

from __future__ import annotations

from typing import Callable

import torch

from benchmark import cells

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _build_once(config: dict, device):
    from pychebyshev_tpu_torch import ChebyshevApproximation

    values = cells.function(config["function"])
    model = ChebyshevApproximation(
        lambda points, _data=None: values(points), config["dims"],
        config["domain"], config["n_nodes"], vectorized=True, device=device)
    model.build(verbose=False)
    rep = config["representation"]
    if rep["kind"] == "dense":
        return model
    if rep["kind"] == "to_tt":
        tt = model.to_tt(tolerance=rep["tolerance"])
        if list(tt.tt_ranks) != list(rep["ranks"]):
            raise RuntimeError(
                f"to_tt(tolerance={rep['tolerance']}) gave ranks "
                f"{list(tt.tt_ranks)}; the configuration states "
                f"{rep['ranks']}, and its work counts follow from them")
        return tt
    raise ValueError(f"unknown representation {rep['kind']!r}")


def build(config: dict, device, sync: Callable[[], None]):
    """The configuration's model, built on ``device``."""
    model = _build_once(config, device)
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


def engine(model, traffic: dict, config: dict, device, device_mesh):
    """The traffic's serving engine over ``model``."""
    from pychebyshev_tpu_torch import serving

    kw = dict(dtype=DTYPES[traffic["dtype"]],
              bucket_sizes=tuple(traffic["bucket_sizes"]), device=device)
    if device_mesh is not None:
        kw.update(mesh=device_mesh, data_axis=config["mesh"]["data_axis"])
    specs = [tuple(s) for s in traffic["specs"]]
    if traffic["engine"] == "BatchedEvaluator":
        if len(specs) != 1:
            raise ValueError("a BatchedEvaluator serves one spec")
        return serving.BatchedEvaluator(model, derivative_order=specs[0],
                                        **kw)
    if traffic["engine"] == "MultiSpecEvaluator":
        return serving.MultiSpecEvaluator(model, specs, **kw)
    raise ValueError(f"unknown engine {traffic['engine']!r}")


def kernel_launches() -> int:
    """Launches of the port's hand-written kernels that its own counters
    have seen (``fused_eval.launches`` + ``fused_dd.launches``)."""
    from pychebyshev_tpu_torch.ops import fused_dd, fused_eval

    return int(fused_eval.launches) + int(fused_dd.launches)

"""BatchedEvaluator: the port's engine for one derivative spec a
request."""

from __future__ import annotations

from benchmark import program


def make(model, traffic: dict, config: dict, device, mesh):
    from pychebyshev_tpu_torch import serving

    specs = program.specs(traffic)
    if len(specs) != 1:
        raise ValueError("a BatchedEvaluator serves one spec")
    return serving.BatchedEvaluator(
        model, derivative_order=specs[0],
        **program.engine_kwargs(traffic, config, device, mesh))

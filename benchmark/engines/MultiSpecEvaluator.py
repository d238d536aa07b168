"""MultiSpecEvaluator: the port's engine for several derivative specs a
request, one column each."""

from __future__ import annotations

from benchmark import program


def make(model, traffic: dict, config: dict, device, mesh):
    from pychebyshev_tpu_torch import serving

    return serving.MultiSpecEvaluator(
        model, program.specs(traffic),
        **program.engine_kwargs(traffic, config, device, mesh))

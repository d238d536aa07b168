"""Serving engines: one file each, found by a traffic mix's ``engine``.

``benchmark/engines/<engine>.py`` has ``make(model, traffic, config,
device, mesh)``, which returns the port's engine over ``model`` for the
mix: a callable of a request's points with a ``warmup()``.  The
arguments every engine takes (dtype, buckets, device, mesh) come from
``program.engine_kwargs``.
"""

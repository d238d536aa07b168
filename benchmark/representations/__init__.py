"""Representations: one file each, found by a configuration's
``representation.kind``.

``benchmark/representations/<kind>.py`` has three functions:

- ``build(config, device, phase)``: the program's model, built through
  the port's public entry points; ``phase(name)`` is a context manager
  that times each step of set-up;
- ``work_counts(config)``: ``flop_per_point`` and ``coefficients``, which
  follow from the configuration's shapes and ranks and which its
  ``work`` states;
- ``reference(config, device)``: the plain reference (an object with
  ``n_nodes`` and ``evaluate(points, orders, precision, block_points)``,
  as ``benchmark.reference.interpolant.Interpolant``), which imports
  nothing of the port and takes nothing the program made.
"""

"""Representations: one file each, found by a configuration's
``representation.kind``.

``benchmark/representations/<kind>.py`` has three functions:

- ``build(config, device, phase)``: the program's model, built through
  the port's public entry points; ``phase(name)`` is a context manager
  that times each step of set-up;
- ``work_counts(config)``: ``flop_per_point`` and ``coefficients``, which
  follow from the configuration's shapes and ranks and which its
  ``work`` states, and ``outputs_per_point`` where a point has more than
  one output a spec (a book of M models: M);
- ``reference(config, device)``: the plain reference (an object with
  ``n_nodes`` and ``evaluate(points, orders, precision, block_points)``,
  as ``benchmark.reference.interpolant.Interpolant``; a book's has
  ``models``, M, and answers (M, N), as ``benchmark.reference.book.Book``),
  which imports nothing of the port and takes nothing the program made.

``benchmark/tests/test_benchmark_harness.py`` counts a dense grid, a
tensor train (a ``ranks`` key) and a book (``models`` and ``member``) by
hand; any other kind brings ``benchmark/tests/test_counts_<kind>.py``
with a ``hand_counts(config)`` of its own.
"""

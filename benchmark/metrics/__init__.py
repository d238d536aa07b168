"""Per-layer metrics: one reader each, found by the metric's name.

``read(record, cell)`` takes one rank's reduced trace
(``tracing.Record``) and the cell (``cells.Cell``) and returns the
metric's value in its unit, or None where the record holds nothing to
read; the harness then leaves the metric out of the line.  Under a mesh
the harness averages the ranks' values.

Besides its numbers, a record holds the port's spans by name
(``self_by_span`` and ``idle_by_span``, microseconds a request) and its
counters by the name of their file in ``benchmark/counters/``
(``counters``, a request): a reader of a span or a counter that a later
change adds reads it there, and imports nothing of the port.
"""

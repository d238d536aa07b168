"""Per-layer metrics: one reader each, found by the metric's name.

``read(record, cell)`` takes one rank's reduced trace
(``tracing.Record``) and the cell (``cells.Cell``) and returns the
metric's value in its unit, or None where the record holds nothing to
read; the harness then leaves the metric out of the line.  Under a mesh
the harness averages the ranks' values.
"""

"""eval_roofline: the least time the card could take for the traced
requests' evaluation work, as a percentage of the time the device was
busy with the operations the port's calls launched (their union).

The work is the configuration's, whatever implements it
(``roofline.least_seconds``): the FLOP of the first contraction every
route of the representation must do, and the points, outputs and
coefficients each moved once, against the card's published peaks.  A
card the table of peaks does not name reads nothing.
"""

from benchmark import roofline


def read(record, cell):
    if record.engine_busy_us <= 0:
        return None
    least = roofline.least_seconds(
        cell.config, cell.traffic,
        record.points_per_request * record.requests, record.requests,
        record.device_kind)
    if least is None:
        return None
    return 100.0 * least / (record.engine_busy_us * 1e-6)

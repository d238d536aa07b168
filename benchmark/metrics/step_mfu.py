"""step_mfu: the traced requests' FLOP (the configuration's, whatever
implements them, ``roofline.flop_seconds``) at the card's published peak,
as a percentage of the requests' whole serving time: the step's share of
the peak, which stays readable whatever kernel a route runs."""

from benchmark import roofline


def read(record, cell):
    if record.window_us <= 0:
        return None
    least = roofline.flop_seconds(
        cell.config, cell.traffic,
        record.points_per_request * record.requests, record.device_kind)
    if least is None:
        return None
    return 100.0 * least / (record.window_us * 1e-6)

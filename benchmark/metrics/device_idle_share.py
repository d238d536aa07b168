"""device_idle_share: the share of the traced requests' serving time
(each from its call into the port to the end of its result) in which no
operation ran on the device: 1 - busy / window, with busy the union of
the device operations' intervals, overlapping operations counted once."""


def read(record, cell):
    if record.window_us <= 0 or record.device_ops == 0:
        return None
    return 1.0 - record.busy_us / record.window_us

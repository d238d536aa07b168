"""port_idle_share: the share of the traced requests' serving time in
which the device idled inside a ``serve`` span of the port: the part of
``device_idle_share`` that the port's own host code holds the device
back (``port_spans.py``)."""


def read(record, cell):
    return record.port_idle_share

"""host_syncs_per_request: runtime calls that block the host on the
device and begin inside a ``serve`` span, per traced request: stream,
device, event and context synchronizes, and copies to the host, a scalar
read's copy and synchronize counted once (``port_spans.py``).  None off
the card."""


def read(record, cell):
    return record.host_syncs_per_request

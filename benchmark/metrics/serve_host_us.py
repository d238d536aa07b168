"""serve_host_us: host time a traced request spends in the port's
serving layer (``serve`` spans) outside every ``route.*`` span: intake,
the slice loop and the join (``port_spans.py``)."""


def read(record, cell):
    return record.serve_host_us

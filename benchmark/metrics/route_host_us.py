"""route_host_us: host time a traced request spends in the port's route
layer, the union of its ``route.*`` spans: operand caches, argument
set-up and the kernels' launches (``port_spans.py``)."""


def read(record, cell):
    return record.route_host_us

"""launches_per_request: the device operations (kernels, copies, sets)
that the host launched inside the port's calls, per traced request."""


def read(record, cell):
    if record.requests == 0 or record.engine_ops == 0:
        return None
    return record.engine_ops / record.requests

"""device_idle.host: the share of the traced stretch with nothing running
on the device (kernels, copies and fills), in the cell whose
host paces it (it moves ``serve_tok_s.host``)."""


def read(ctx):
    tr = ctx.get("trace")
    return tr.idle_percent() if tr is not None else None

"""device_idle.train: the share of the traced stretch with nothing running
on the device (kernels, copies and fills)."""


def read(ctx):
    tr = ctx.get("trace")
    return tr.idle_percent() if tr is not None else None

"""decode_hbm_share.serve: the least bytes of the traced decode steps (the
weights once, each active sequence's cached K/V read once, the new K/V
written) over their device time at the card's peak bandwidth. A decode
span's name carries the step's active slots and their cached tokens."""

import yardstick


def read(ctx):
    tr = ctx.get("trace")
    steps = tr.extents("portbench.decode.") if tr else []
    need = took = 0.0
    for name, secs in steps:
        active, cached = (int(x) for x in name.rsplit(".", 2)[1:])
        need += yardstick.decode_least_bytes(ctx["mc"], active, cached)
        took += secs
    return 100.0 * need / (took * yardstick.PEAK_HBM_BYTES) if took else None

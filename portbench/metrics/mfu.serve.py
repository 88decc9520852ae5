"""mfu.serve: model FLOPs of the window's served work over the window and
the card's bf16 peak: each prompt prefilled whose first token came in the
window (its real length, not the padded one) and each decode token
received in the window, at its position (``yardstick.forward_flops``)."""

import yardstick


def read(ctx):
    mc, t0, t1 = ctx["mc"], ctx["t_open"], ctx["t_close"]
    flops = 0.0
    for r in ctx["records"]:
        plen = len(r["prompt"])
        for j, t in enumerate(r["times"]):
            if t0 <= t <= t1:
                flops += (yardstick.forward_flops(mc, 0, plen) if j == 0 else
                          yardstick.forward_flops(mc, plen + j - 1, 1))
    if not flops:
        return None
    return 100.0 * flops / ((t1 - t0) * yardstick.PEAK_BF16_FLOPS)

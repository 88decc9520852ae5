"""decode_step_ms.host: the device time of one decode step, from the first
kernel it launched starting to the last ending, averaged over the steps
the traced stretch holds whole (``eng._decode`` wrapped in a span);
in the cell whose host paces it (it moves ``serve_tok_s.host``)."""

import yardstick


def read(ctx):
    tr = ctx.get("trace")
    return yardstick.mean_ms(tr.extents("portbench.decode.")) if tr else None

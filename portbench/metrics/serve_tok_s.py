"""serve_tok_s: output tokens that clients received inside the window,
divided by the window's length (host clock)."""

import yardstick


def read(ctx):
    return yardstick.tokens_per_s(ctx["records"], ctx["t_open"], ctx["t_close"])

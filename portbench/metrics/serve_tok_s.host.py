"""serve_tok_s.host: output tokens that clients received inside the window,
divided by the window's length (host clock), in a cell whose host paces
it: its spread from run to run asks for a bound of its own (PERF.md)."""

import yardstick


def read(ctx):
    return yardstick.tokens_per_s(ctx["records"], ctx["t_open"], ctx["t_close"])

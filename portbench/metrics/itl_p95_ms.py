"""itl_p95_ms: 95th percentile (nearest rank) of every gap between two
consecutive tokens of one request, both received inside the window, over
all requests (host clock at the client)."""

import yardstick


def read(ctx):
    gaps = yardstick.itl_gaps(ctx["records"], ctx["t_open"], ctx["t_close"])
    return yardstick.percentile(gaps, 95) * 1e3 if gaps else None

"""ttft_p95_ms.host: 95th percentile (nearest rank), over every request
sent inside the window, of send to first token received; a request with
no first token when the window closes counts at its wait so far. Read in
the traced run, where the host paces it (its spread from run to run is
too wide for an end-to-end bound: PERF.md), over the window up to the
profiler's start, since the profiler stalls the host."""

import yardstick


def read(ctx):
    waits = yardstick.ttft_waits(ctx["records"], ctx["t_open"],
                                 ctx["t_host_close"])
    return yardstick.percentile(waits, 95) * 1e3 if waits else None

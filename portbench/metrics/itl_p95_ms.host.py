"""itl_p95_ms.host: ``itl_p95_ms`` where the host paces the tail, read in
the traced run (its spread from run to run is too wide for an end-to-end
bound: PERF.md), over the window up to the profiler's start, since the
profiler stalls the host."""

import yardstick


def read(ctx):
    gaps = yardstick.itl_gaps(ctx["records"], ctx["t_open"],
                              ctx["t_host_close"])
    return yardstick.percentile(gaps, 95) * 1e3 if gaps else None

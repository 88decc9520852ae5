"""prefill_share.serve: the share of the traced stretch that the device
spent in kernels launched by the engine's prefill (``eng._prefill``,
wrapped in a span in the traced run)."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    spans = tr.by_span("portbench.prefill.")
    if not spans or tr.window_s <= 0:
        return None
    busy = sum(min(e, tr.t1) - max(s, tr.t0)
               for ks in spans.values() for s, e, _, _ in ks)
    return 100.0 * busy * 1e-6 / tr.window_s

"""batch_occupancy.serve: the share of decode slots that held a request,
over the decode steps of the window: active slots (the engine's own
``active``, read at each step) over steps x max_num_seqs."""


def read(ctx):
    probe = ctx.get("probe")
    if probe is None:
        return None
    t0, t1 = ctx["t_open"], ctx["t_close"]
    act = [a for t, a, _ in probe.decodes if t0 <= t <= t1]
    if not act:
        return None
    return 100.0 * sum(act) / (len(act) * ctx["engine"]["max_num_seqs"])

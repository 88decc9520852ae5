"""optimizer_ms.train: device time of the optimizer's kernels a step (the
fused AdamW launched inside ``opt.step``, wrapped in a span in the traced
run), averaged over the steps the traced stretch holds whole."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    per = [sum(e - s for s, e, _, _ in ks) * 1e-6
           for ks in tr.by_span("portbench.optimizer").values()
           if ks and ks[0][0] >= tr.t0 and max(k[1] for k in ks) <= tr.t1]
    return 1e3 * sum(per) / len(per) if per else None

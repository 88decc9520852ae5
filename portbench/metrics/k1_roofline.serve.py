"""k1_roofline.serve: K1's share of its roofline in the prefills of the
traced stretch: the least time of each launch (the larger of its
operations at the bf16 peak and its bytes at the HBM peak, causal, at the
padded length the prefill span names) summed, over K1's summed kernel
time."""

import yardstick

K1 = "attn_fwd"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    w = yardstick.dims(ctx["mc"])
    need = took = 0.0
    for span, ks in tr.by_span("portbench.prefill.").items():
        S = int(span[2].rsplit(".", 1)[1])
        for ts, end, name, _ in ks:
            if K1 in name:
                need += yardstick.bound_s(*yardstick.k1_cost(
                    1, w["n_heads"], w["n_kv_heads"], S, w["head_dim"], True))
                took += (end - ts) * 1e-6
    return 100.0 * need / took if took else None

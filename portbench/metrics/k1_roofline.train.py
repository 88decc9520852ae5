"""k1_roofline.train: K1's share of its roofline in the training step
(forward and its recompute under remat "dots"): each launch's least time
at the step's shape, causal, summed, over K1's summed kernel time."""

import yardstick

K1 = "attn_fwd"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    w, mix = yardstick.dims(ctx["mc"]), ctx["mix"]
    ks = tr.named(K1)
    if not ks:
        return None
    one = yardstick.bound_s(*yardstick.k1_cost(
        mix["batch"], w["n_heads"], w["n_kv_heads"], mix["seq"],
        w["head_dim"], True))
    return 100.0 * one * len(ks) / (sum(e - s for s, e, _, _ in ks) * 1e-6)

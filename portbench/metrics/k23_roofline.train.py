"""k23_roofline.train: the backward kernels' share of their roofline, K2
(dq, ``flash_bwd_dq_kernel``) and K3 (dk, dv, ``flash_bwd_dkv_kernel``)
together: each launch's least time at the step's shape, causal, summed,
over their summed kernel time."""

import yardstick

NAMES = {"k2": "flash_bwd_dq_kernel", "k3": "flash_bwd_dkv_kernel"}


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    w, mix = yardstick.dims(ctx["mc"]), ctx["mix"]
    cost = yardstick.k23_cost(mix["batch"], w["n_heads"], w["n_kv_heads"],
                              mix["seq"], w["head_dim"], True)
    need = took = 0.0
    for k, part in NAMES.items():
        ks = tr.named(part)
        need += yardstick.bound_s(*cost[k]) * len(ks)
        took += sum(e - s for s, e, _, _ in ks) * 1e-6
    return 100.0 * need / took if took else None

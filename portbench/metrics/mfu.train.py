"""mfu.train: PaLM's model FLOPs a token (6N + 12 L dim s, recompute not
counted) times the traced run's train_tok_s, over the card's bf16 peak."""

import yardstick


def read(ctx):
    if not ctx["steps"]:
        return None
    rate = ctx["steps"] * ctx["tokens_per_step"] / (ctx["t_end"] - ctx["t_open"])
    return 100.0 * yardstick.train_flops_per_token(
        ctx["mc"], ctx["mix"]["seq"]) * rate / yardstick.PEAK_BF16_FLOPS

"""train_tok_s: tokens of every step run in the window divided by the
window, which ends when the device has finished the last of them (host
clock ending in a synchronize)."""


def read(ctx):
    return ctx["steps"] * ctx["tokens_per_step"] / (ctx["t_end"] - ctx["t_open"])

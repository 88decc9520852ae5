"""setup_s: process start to the window's opening (host clock): imports,
the CUDA context, kernel libraries, weights drawn on the card, warm-up,
and for serving the clients' first admissions."""


def read(ctx):
    return ctx["setup_s"]

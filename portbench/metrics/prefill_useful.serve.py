"""prefill_useful.serve: the share of the prefills' padded positions that
hold prompt tokens: the sum over the traced stretch's ``engine.prefill``
spans of ``tokens`` (the real length) over that of ``padded`` (the
power-of-two bucket), in %."""

import progspans


def read(ctx):
    return progspans.share(ctx, "engine.prefill", "tokens", "padded")

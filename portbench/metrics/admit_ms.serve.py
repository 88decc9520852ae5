"""admit_ms.serve: host time of one admission, the engine's
``engine.admit`` span (blocks, the prefill, the first token) for each
request it admitted, averaged over the traced stretch's; the decode slots
wait for it."""

import progspans


def read(ctx):
    return progspans.mean_ms(ctx, "engine.admit",
                             lambda s: "new_blocks" in s.attrs)

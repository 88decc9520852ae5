"""step_gap_ms.serve: host time between two decode steps, from one
``engine.step`` span's end to the next one's start, averaged over the
traced stretch's consecutive steps with no ``engine.admit`` between them:
the engine loop's own turn (fan-out, wake-up, the consumers' work)."""

import progspans


def read(ctx):
    return progspans.step_gap_ms(ctx)

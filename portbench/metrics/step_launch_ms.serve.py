"""step_launch_ms.serve: host time of one decode step's launch, the
engine's ``engine.launch`` span (the host-to-device copies of the slot
state and the eager launch of the step's kernels), averaged over the spans
the traced stretch holds whole (``progspans``)."""

import progspans


def read(ctx):
    return progspans.mean_ms(ctx, "engine.launch")

"""step_launch_ms.host: ``step_launch_ms.serve`` in the cell whose host
paces it (it moves ``serve_tok_s.host``): host time of the engine's
``engine.launch`` span, averaged over the traced stretch's."""

import progspans


def read(ctx):
    return progspans.mean_ms(ctx, "engine.launch")

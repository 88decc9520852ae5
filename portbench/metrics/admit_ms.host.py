"""admit_ms.host: ``admit_ms.serve`` in the cell whose host paces it (it
moves ``serve_tok_s.host``): host time of one ``engine.admit`` that
admitted its request, averaged over the traced stretch's."""

import progspans


def read(ctx):
    return progspans.mean_ms(ctx, "engine.admit",
                             lambda s: "new_blocks" in s.attrs)

"""step_gap_ms.host: ``step_gap_ms.serve`` in the cell whose host paces it
(it moves ``serve_tok_s.host``): from one ``engine.step``'s end to the
next one's start, over consecutive steps with no admission between."""

import progspans


def read(ctx):
    return progspans.step_gap_ms(ctx)

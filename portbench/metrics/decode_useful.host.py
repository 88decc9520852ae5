"""decode_useful.host: ``decode_useful.serve`` in the cell whose host paces
it (it moves ``serve_tok_s.host``): cached over gathered positions of the
traced stretch's ``engine.step`` spans, in %."""

import progspans


def read(ctx):
    return progspans.share(ctx, "engine.step", "cached", "gathered")

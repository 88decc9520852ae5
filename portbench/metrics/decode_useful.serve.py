"""decode_useful.serve: the share of the decode step's paged gather that
holds cached positions: the sum over the traced stretch's ``engine.step``
spans of ``cached`` (the active slots' lengths) over that of ``gathered``
(every slot's ``max_model_len``, rounded up to blocks), in %."""

import progspans


def read(ctx):
    return progspans.share(ctx, "engine.step", "cached", "gathered")

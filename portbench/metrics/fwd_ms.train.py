"""fwd_ms.train: device time of the kernels launched inside the program's
``train.forward`` span (the loss's forward pass), per step the traced
stretch holds whole. Under remat the recompute runs in the backward."""

import progspans


def read(ctx):
    return progspans.device_ms(ctx, "train.forward")

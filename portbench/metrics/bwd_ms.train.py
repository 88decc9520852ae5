"""bwd_ms.train: device time of the kernels launched inside the program's
``train.backward`` span (``loss.backward()``, the remat recompute with it;
autograd's own thread launches them while the span is open), per step the
traced stretch holds whole."""

import progspans


def read(ctx):
    return progspans.device_ms(ctx, "train.backward")

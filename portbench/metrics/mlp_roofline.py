"""The step's LN and MLP kernels' share of their roofline, in %."""

import pb_readers


def read(ctx):
    return pb_readers.roofline(ctx, "mlp")

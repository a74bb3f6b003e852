"""The step's attention kernels' share of their roofline, in %."""

import pb_readers


def read(ctx):
    return pb_readers.roofline(ctx, "attention")

"""The step's model operations over the window's time, in % of the bf16 peak."""

import pb_readers


def read(ctx):
    return pb_readers.mfu(ctx)

"""The share of the profiled span in which the device ran nothing, in %."""

import pb_readers


def read(ctx):
    return pb_readers.idle_pct(ctx)

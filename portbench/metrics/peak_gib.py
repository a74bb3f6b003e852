"""The run's peak of allocated device memory, GiB."""

import pb_readers


def read(ctx):
    return pb_readers.peak_gib(ctx)

"""Pretrain clips stepped over the window's whole time."""

import pb_readers


def read(ctx):
    return pb_readers.clips_per_s(ctx, "pretrain")

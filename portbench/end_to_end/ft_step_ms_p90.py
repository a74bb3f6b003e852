"""The 90th percentile of every finetune step time of the window, ms."""

import pb_readers


def read(ctx):
    return pb_readers.step_ms_p90(ctx, "finetune")

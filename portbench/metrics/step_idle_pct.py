"""The span's share in which the device idled inside avsiam.step, in %."""

import pb_spans


def read(ctx):
    return pb_spans.step_idle_pct(ctx)

"""Device ms a step of the graph's other phases: zeroing, means, Adam."""

import pb_spans


def read(ctx):
    return pb_spans.phase_ms(ctx, "other")

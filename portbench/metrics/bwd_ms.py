"""Device ms a step of the graph's backward phases (bwd* marks)."""

import pb_spans


def read(ctx):
    return pb_spans.phase_ms(ctx, "bwd")

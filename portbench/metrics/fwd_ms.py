"""Device ms a step of the graph's forward phases (fwd* marks)."""

import pb_spans


def read(ctx):
    return pb_spans.phase_ms(ctx, "fwd")

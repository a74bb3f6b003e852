"""Host ms inside a step call (copies, rates, the replay), median."""

import pb_readers


def read(ctx):
    return pb_readers.replay_host_ms(ctx)

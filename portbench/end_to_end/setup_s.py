"""Set-up: from process start to the first timed step, s."""


def read(ctx):
    return ctx.setup_s

"""calls_per_s.<kind>: the window's calls over its seconds."""


def read(ctx):
    return ctx.window.calls / ctx.window.seconds

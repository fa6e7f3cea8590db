"""Queries completed in the window over the window's whole time, from the
first call's start to the return of the last (host clock)."""


def read(ctx):
    return ctx.queries / ctx.window_s if ctx.window_s > 0 else None

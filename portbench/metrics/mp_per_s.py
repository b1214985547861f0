"""mp_per_s: the pixels of every call completed in the window, in millions,
over the window's wall time (host clock, from the first call's start to
the last call's end, each call from the host image to the host palette and
map)."""


def read(ctx):
    return ctx.pixels_done / 1e6 / ctx.window_s

"""mse_luv: CIELuv MSE of palette[map] against the input, float64, on a
seeded subsample of at most 2^22 pixels of each of the window's first calls
(one a distinct image), averaged; computed after the window closed."""


def read(ctx):
    return ctx.quality.get("mse_luv")

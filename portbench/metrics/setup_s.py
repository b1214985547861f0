"""setup_s: seconds from the start of the process to the first timed call
(imports, CUDA context, the kernel library from its cache, the images, the
warm calls)."""


def read(ctx):
    return ctx.setup_s

"""peak_device_mb: torch.cuda.max_memory_allocated() over the window (reset
after the warm calls), in 10^6 bytes."""


def read(ctx):
    return None if ctx.peak_bytes is None else ctx.peak_bytes / 1e6

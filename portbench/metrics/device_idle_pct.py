"""device_idle_pct (device): the share of the traced calls' wall in which
no kernel, copy or set runs on the card (profiler timeline)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.calls:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s())

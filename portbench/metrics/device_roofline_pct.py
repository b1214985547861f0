"""device_roofline_pct (kernels): the least time the H100 could take for
the traced calls' work (bounds.call_least_ms, from the cell's shapes, at
the published peaks) over the time in which the profiler saw any kernel
run in those calls, whatever its name."""

from portbench import bounds


def read(ctx):
    if ctx.trace is None or not ctx.trace.calls:
        return None
    kernel_s = ctx.trace.kernel_s()
    if kernel_s <= 0:
        ctx.log("device_roofline_pct: the trace holds no kernel")
        return None
    cfg = ctx.cell["config"]
    least_ms = bounds.call_least_ms(cfg["call"], ctx.n, ctx.valid,
                                    cfg["input_dtype"])
    return 100.0 * least_ms * 1e-3 * len(ctx.trace.calls) / kernel_s

"""call_p90_ms (quantize call): the 90th percentile of the host-clock time
of every call of the window, with the count beside it."""

from portbench.harness import stats


def read(ctx):
    ms = [c["ms"] for c in ctx.calls]
    return {"value": stats.p90(ms), "n": len(ms)}

"""host_syncs (quantize call): the runtime calls in which the host waits
for the card, per traced call, over the whole call (profiler timeline).

The waits counted, by CUDA runtime name (a version or per-thread suffix
such as ``_v3020`` or ``_ptsz`` dropped): ``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize`` and the synchronous
``cudaMemcpy``. Every wait drains the card's queue, which then idles while
the host enqueues again. A pageable ``cudaMemcpyAsync`` that blocks the
host is not counted; driver-API calls are not in the trace's host events.
"""

import re

WAITS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})
_SUFFIX = re.compile(r"(_pt(sz|ds))?(_v\d+)?$")


def runtime_name(name):
    """``name`` without its CUPTI version or per-thread suffix."""
    return _SUFFIX.sub("", name)


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.calls:
        return None
    waits = sum(1 for name, s, _ in tr.host
                if runtime_name(name) in WAITS
                and any(c0 <= s <= c1 for c0, c1 in tr.calls))
    return {"value": float(waits) / len(tr.calls), "n": len(tr.calls)}

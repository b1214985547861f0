"""A short stretch of calls under ``torch.profiler``, reduced to the
device's busy time, kernel time, the device operations that took most time
and the idle gaps named by what the host was doing.

The profiler's timeline is exported as a Chrome trace into a temporary
directory (under ``TMPDIR``), read back and deleted. Times are in
microseconds of the profiler's clock; each traced call is a
``record_function`` range named ``portbench_call_<i>``.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import shutil
import tempfile

from portbench.harness import stats

CALL = "portbench_call_"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "cuda_runtime")
TOP = 10


class Trace:
    """``calls``: (start, end) of each traced call; ``device``: (name,
    kind, start, end) of every kernel, copy and set on the card; ``host``:
    (name, start, end) of every operator and runtime call on the host."""

    def __init__(self, calls, device, host):
        self.calls = calls
        self.device = device
        self.host = sorted(host, key=lambda h: h[1])
        self._starts = [h[1] for h in self.host]

    @classmethod
    def from_chrome(cls, events):
        calls, device, host = [], [], []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, name = ev.get("cat", ""), ev.get("name", "")
            s = float(ev["ts"])
            e = s + float(ev.get("dur", 0.0))
            if cat == "user_annotation" and name.startswith(CALL):
                calls.append((int(name[len(CALL):]), s, e))
            elif cat in DEVICE_KINDS:
                device.append((name, cat, s, e))
            elif cat in HOST_KINDS:
                host.append((name, s, e))
        return cls([(s, e) for _, s, e in sorted(calls)], device, host)

    @property
    def lo(self):
        return self.calls[0][0]

    @property
    def hi(self):
        return self.calls[-1][1]

    def window_s(self):
        return (self.hi - self.lo) * 1e-6

    def busy_s(self):
        """Seconds of the traced calls' wall in which a kernel, copy or
        set ran on the card."""
        return stats.covered([(s, e) for _, _, s, e in self.device],
                             self.lo, self.hi) * 1e-6

    def kernel_s(self):
        return stats.covered([(s, e) for _, k, s, e in self.device
                              if k == "kernel"], self.lo, self.hi) * 1e-6

    def device_ops(self, top=TOP):
        """[name, seconds] of the device operations that took most time."""
        acc = collections.Counter()
        for name, _, s, e in self.device:
            acc[name[:160]] += max(0.0, min(e, self.hi) - max(s, self.lo))
        return [[n, t * 1e-6] for n, t in acc.most_common(top) if t > 0]

    def _lap_at(self, t, laps):
        for i, (s, e) in enumerate(self.calls):
            if s <= t <= e:
                at = s
                for name, ms in laps[i].items():
                    at += ms * 1e3
                    if t <= at:
                        return name
                return "after the last lap"
        return "between calls"

    def _host_op_at(self, t, look=256):
        """The latest-starting host operation still running at ``t`` (the
        innermost, where they nest), looking back at most ``look``."""
        i = bisect.bisect_right(self._starts, t)
        for name, _, e in reversed(self.host[max(0, i - look):i]):
            if e >= t:
                return name
        return "python"

    def idle_gaps(self, laps, top=TOP):
        """[name, seconds]: the card's idle time within the traced calls,
        summed by the lap and the innermost host operation at each gap's
        middle; ``laps`` holds each traced call's stage laps (ms)."""
        acc = collections.Counter()
        for s, e in stats.gaps([(s, e) for _, _, s, e in self.device],
                               self.lo, self.hi):
            mid = 0.5 * (s + e)
            acc[f"{self._lap_at(mid, laps)} | {self._host_op_at(mid)}"] += \
                e - s
        return [[n, t * 1e-6] for n, t in acc.most_common(top)]


def profile_calls(call, count):
    """Run ``call(i)`` for i < ``count`` under the profiler; the Trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for i in range(count):
            with record_function(f"{CALL}{i}"):
                call(i)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="portbench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return Trace.from_chrome(events)

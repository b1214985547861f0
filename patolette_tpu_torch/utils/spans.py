"""Named spans of the port in the profiler's own timeline.

``with span(name):`` marks a stretch of host code as the range
``patolette/<name>`` while a ``torch.profiler`` session is active, so the
span lies in the same trace as the kernels, copies and runtime calls it
enqueues, on the same clock, nested in whatever range encloses it. With no
profiler it costs one flag read: ``record_function`` alone costs about a
hundred times that even with no profiler.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

PREFIX = "patolette/"
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: ``record_function(PREFIX + name)`` while the
    profiler is on, else a shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(PREFIX + name)

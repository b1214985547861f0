"""Where an entry point of the port runs, and its inputs put there.

One rule for every public function that takes arrays: numpy input goes to
``device`` (``cuda`` by default; with no CUDA device the call fails, typed,
unless the caller passes ``"cpu"``, which runs the kernels' plain
versions); a tensor stays on its own device, and a ``device`` that names
another one is an error. uint8 stays uint8 (the kernels' byte paths) and
every other input becomes f32.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, ``cuda`` by default; a CUDA device
    where there is none fails (typed), never falls back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device not available; pass device='cpu' to run the plain "
            "versions of the kernels"
        )
    return device


def _same(a: torch.device, b: torch.device) -> bool:
    """``a`` names ``b`` (``cuda`` names every CUDA device)."""
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def call_device(x, device=None) -> torch.device:
    """The device a call on ``x`` (an array, a tensor, or a tuple of them:
    the first decides) runs on: a tensor's own, else ``device``."""
    first = x[0] if isinstance(x, (tuple, list)) else x
    if not isinstance(first, torch.Tensor):
        return resolve_device(device)
    if device is not None and not _same(torch.device(device), first.device):
        raise ValueError(f"device {device} is not the input's "
                         f"{first.device}")
    return first.device


def on_device(a, device, dtype=None):
    """``a`` (numpy or a tensor) on ``device``, contiguous, as ``dtype``;
    by default uint8 kept and anything else f32. A tensor on another device
    is an error: it is never moved."""
    if isinstance(a, np.ndarray) and not a.flags.writeable:
        a = a.copy()  # torch takes no read-only memory (e.g. a JAX result's)
    t = torch.as_tensor(a)
    if isinstance(a, torch.Tensor) and not _same(torch.device(device),
                                                 t.device):
        raise ValueError(f"input on {t.device}, the call runs on {device}")
    if dtype is None:
        dtype = torch.uint8 if t.dtype == torch.uint8 else torch.float32
    return t.to(device=device, dtype=dtype).contiguous()

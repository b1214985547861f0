"""Hilbert-curve visit order of an image's pixels.

Port of ``patolette_tpu/ops/hilbert.py``: each pixel's position along the
curve (K7, ``kernels.hilbert``, which also holds ``xy_to_d``), then an
argsort into the permutation the dither scan walks. The curve's
orientation differs from the reference's recursive UP-start walk (README
divergence S3).
"""

from __future__ import annotations

import torch

from patolette_tpu_torch.kernels.hilbert import hilbert_keys


def curve_order(width: int, height: int) -> int:
    """Smallest order with 2^order >= max(width, height)
    (reference riemersma.c:124-144)."""
    m = max(int(width), int(height))
    level = 0
    while (1 << level) < m:
        level += 1
    return max(level, 1)


def pixel_visit_order(width: int, height: int, device="cpu"):
    """(width*height,) int32: ``perm[i]`` is the row-major index of the
    i-th pixel visited. The keys are distinct, so any sort gives the same
    permutation."""
    keys = hilbert_keys(int(width), int(height), curve_order(width, height),
                        device)
    return torch.argsort(keys).to(torch.int32)

"""Nearest-centroid assignment (K3).

Port of ``patolette_tpu/ops/assign.py``. Both forms run the hand-written
kernel ``kernels.assign.assign_planar``: exact f32 distances
``|c|^2 - 2 x.c``, invalid slots never win, ties go to the lowest index
(as faiss' exhaustive search and FLANN's exact search do).
"""

from __future__ import annotations

from patolette_tpu_torch.kernels.assign import assign_planar as _kernel


def assign_planar(channels, centers, valid=None):
    """Nearest centre for channel-planar pixels (3-tuple of ``(N,)``)."""
    if valid is None:
        valid = centers.new_ones((centers.shape[0],), dtype=bool)
    return _kernel(tuple(ch.contiguous() for ch in channels), centers, valid)


def assign(colors, centers, valid=None):
    """Nearest centre per row of ``(N, 3)`` colors."""
    return assign_planar(
        (colors[:, 0], colors[:, 1], colors[:, 2]), centers, valid
    )

"""Hilbert-curve visit order of an image's pixels.

Port of ``patolette_tpu/ops/hilbert.py``: the permutation the dither scan
walks, the pixels in ascending curve distance. On the card K7
(``kernels.hilbert.visit_order``) enumerates the distances in order, with
no keys and no sort; on the CPU the plain version argsorts ``xy_to_d``.
The curve's orientation differs from the reference's recursive UP-start
walk (README divergence S3).
"""

from __future__ import annotations

from patolette_tpu_torch.kernels.hilbert import (curve_order, visit_order,
                                                 xy_to_d)

__all__ = ["curve_order", "pixel_visit_order", "xy_to_d"]


def pixel_visit_order(width: int, height: int, device="cuda"):
    """(width*height,) int32: ``perm[i]`` is the row-major index of the
    i-th pixel visited. On the card unless ``device`` is the CPU."""
    return visit_order(width, height, device)

"""Riemersma (Hilbert-curve) error-diffusion dithering.

Port of ``patolette_tpu/models/dither.py`` (reference
lib/src/dither/riemersma.c). Semantics kept: the scan runs in linear
Rec2020; a 16-deep error queue with weights decaying by a ratio of 16;
corrected colours are not clamped; the nearest palette entry is searched
in luma-weighted space (channel scales sqrt of the Rec2020 Y
coefficients). The curve is cut into lanes of ``segment`` pixels whose
queues start at zero (``segment=0``: one serial chain).

The curve order comes from K7 (``ops/hilbert.py``) and the scan is K8
(``kernels/dither.py``), which reads pixels through the permutation and
writes each index to its pixel directly.
"""

from __future__ import annotations

from patolette_tpu_torch.kernels.dither import dither_scan, palette_table
from patolette_tpu_torch.ops import colorspace as cs
from patolette_tpu_torch.ops import hilbert


def riemersma_dither_planar(channels_working, palette_working, valid,
                            width, height, color_space, segment=4096):
    """Palette map (N,) int32 of the planar working-space image
    ``channels_working`` (3-tuple of (N,)) against ``palette_working``
    (K, 3) with ``valid`` (K,) bool."""
    ch2020 = cs.working_to_linear_rec2020(tuple(channels_working),
                                          color_space)
    p2020 = cs.working_to_linear_rec2020(palette_working, color_space)
    perm = hilbert.pixel_visit_order(width, height, ch2020[0].device)
    return dither_scan(tuple(ch.contiguous() for ch in ch2020), perm,
                       palette_table(p2020, valid), int(segment))

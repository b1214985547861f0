"""Riemersma (Hilbert-curve) error-diffusion dithering.

Port of ``patolette_tpu/models/dither.py`` (reference
lib/src/dither/riemersma.c). Semantics kept: the scan runs in linear
Rec2020; a 16-deep error queue with weights decaying by a ratio of 16;
corrected colours are not clamped; the nearest palette entry is searched
in luma-weighted space (channel scales sqrt of the Rec2020 Y
coefficients). The curve is cut into lanes of ``segment`` pixels whose
queues start at zero (``segment=0``: one serial chain).

Three feeds, as in the JAX package: the planar one and the interleaved
one (:func:`riemersma_dither`, (N, 3) rows) convert working-space colours
to linear Rec2020; the packed uint8 one (the streamed route's
uint8 strips) converts the bytes directly from sRGB. Both conversions are
K10 (``kernels/colorspace.py``); :func:`riemersma_dither_rec2020` takes
channels already in linear Rec2020 (the streamed route's float strips,
converted from sRGB through the working space in one K10 pass). The curve
order comes from K7 (``ops/hilbert.py``) and the scan is K8
(``kernels/dither.py``), which reads pixels through the permutation and
writes each index to its pixel directly.
"""

from __future__ import annotations

import torch

from patolette_tpu_torch.kernels.colorspace import color_convert
from patolette_tpu_torch.kernels.dither import dither_scan, palette_table
from patolette_tpu_torch.ops import colorspace as cs
from patolette_tpu_torch.ops import hilbert
from patolette_tpu_torch.utils.device import call_device, on_device


def riemersma_dither_rec2020(ch2020, palette_working, valid, width, height,
                             color_space, segment=4096):
    """Palette map (N,) int32 of the linear Rec2020 channels ``ch2020``
    (3-tuple of (N,)) against ``palette_working`` (K, 3) in the working
    space, with ``valid`` (K,) bool."""
    p2020 = cs.working_to_linear_rec2020(palette_working, color_space)
    perm = hilbert.pixel_visit_order(width, height, ch2020[0].device)
    return dither_scan(tuple(ch.contiguous() for ch in ch2020), perm,
                       palette_table(p2020, valid), int(segment))


def riemersma_dither_planar(channels_working, palette_working, valid,
                            width, height, color_space, segment=4096):
    """Palette map (N,) int32 of the planar working-space image
    ``channels_working`` (3-tuple of (N,)) against ``palette_working``
    (K, 3) with ``valid`` (K,) bool."""
    ch2020 = cs.working_to_linear_rec2020(tuple(channels_working),
                                          color_space)
    return riemersma_dither_rec2020(ch2020, palette_working, valid, width,
                                    height, color_space, segment)


def riemersma_dither(colors_working, palette_working, valid, width, height,
                     color_space, segment=4096, device=None):
    """Palette map (N,) int32 of the (N, 3) working-space image
    ``colors_working`` against ``palette_working`` (K, 3) with ``valid``
    (K,) bool (the JAX package's ``riemersma_dither``, dither.py:79). K10
    reads the rows as they are (no planes made first), then K7 and K8 as
    in :func:`riemersma_dither_planar`, whose bits it gives. Numpy input
    goes to ``device`` (``cuda`` by default); tensors stay where they
    are."""
    dev = call_device(colors_working, device)
    ch2020 = color_convert(on_device(colors_working, dev, torch.float32),
                           color_space, "working_to_rec2020")
    return riemersma_dither_rec2020(
        ch2020, on_device(palette_working, dev),
        on_device(valid, dev, torch.bool), width, height, color_space,
        segment)


def riemersma_dither_packed_u8(pixels_u8, palette_working, valid, width,
                               height, color_space, segment=4096):
    """Palette map (N,) int32 of the (N, 3) uint8 sRGB image ``pixels_u8``
    (the JAX package's ``riemersma_dither_packed_u8``, dither.py:220-263).

    The bytes go to linear Rec2020 directly (sRGB -> XYZ -> Rec2020), not
    through the working space: the JAX feed's chain (dither.py:228-233),
    which differs from the planar feed's only in f32 rounding. Its single
    packed gather into curve order, a TPU gather-cost workaround, has no
    counterpart: K8 reads pixels through the permutation."""
    ch2020 = color_convert(pixels_u8, 0, "rec2020_direct")
    return riemersma_dither_rec2020(ch2020, palette_working, valid, width,
                                    height, color_space, segment)

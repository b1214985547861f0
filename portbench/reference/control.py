"""The control: the reference put in the program's place and computed in
bfloat16, the precision below the float32 the configurations state. Its
maps and palettes are judged by :mod:`portbench.reference.check` like the
program's, and must fail the limits the program passes.

The colour transforms run in float32, as the program's do; the pixels and
the palette are then rounded to bfloat16 and every distance, queue sum and
error of the maps is computed in bfloat16; the palette search (saliency,
GQ, LQ, KMeans) keeps every tensor in bfloat16 and takes torch's
bfloat16 operations, its sums by bucket and cluster accumulated in
bfloat16 too: the step a faster kernel would tempt a later change to
take.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import check, colour, palette as search


def nearest_map(pixels, palette, device, block=1 << 18,
                dtype=torch.bfloat16):
    """(N,) int32 map: the nearest valid entry in ICtCp, computed in
    ``dtype`` (bfloat16 for the control)."""
    valid, _ = check.palette_rows(palette)
    idx = np.flatnonzero(valid)
    work = colour.transform_dtype(dtype)
    pal = colour.srgb_to_ictcp(torch.as_tensor(
        np.asarray(palette)[idx], dtype=work, device=device)).to(dtype)
    out = []
    for s in range(0, len(pixels), block):
        x = colour.srgb_to_ictcp(colour.srgb_of(
            np.ascontiguousarray(pixels[s:s + block]), device,
            work)).to(dtype)
        d = ((x[:, None, :] - pal[None, :, :]) ** 2).sum(-1)
        out.append(torch.as_tensor(idx, device=device)[d.argmin(1)])
    return torch.cat(out).to(torch.int32).cpu().numpy()


def dither_map(pixels, palette, width, height, device, segment=4096,
               dtype=torch.bfloat16):
    """(N,) int32 Riemersma map made by the reference's walk in ``dtype``
    (bfloat16 for the control)."""
    return check.walk(pixels, palette, width, height, device, segment,
                      dtype)[2]


def dither_map_strips(pixels, palette, width, height, device, strip_rows,
                      segment=4096, dtype=torch.bfloat16):
    """(N,) int32 Riemersma map of a streamed call, each strip of
    ``strip_rows`` rows along its own curve, made by the reference's walk
    in ``dtype`` (bfloat16 for the control)."""
    return check.walk(pixels, palette, width, height, device, segment,
                      dtype, strip_rows=strip_rows)[2]


def palette(ref, dtype=torch.bfloat16):
    """The palette of the reference's search in ``dtype`` (bfloat16 for the
    control), saliency too, on the image of ``ref``
    (a :class:`check.PaletteReference`)."""
    width, height = ref.size
    srgb = ref.srgb.to(dtype)
    weights = search.weights_of(srgb, width, height, ref.call)
    return search.search(srgb, weights, ref.call, ref.seed, dtype)

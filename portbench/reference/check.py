"""What decides ``correct``: the program's palette and map, judged by the
reference in float64.

* ``bad_outputs``: a count that must be 0. A failed call, a palette that is
  not (p, 3) with every row in [0, 1] or exactly [-1, -1, -1], a map that is
  not (N,) int32 or that names a slot outside the palette or a filled one.
* ``map_gap`` (undithered maps): the widest gap, over every pixel, between
  the squared ICtCp distance from the pixel to the entry the map names and
  the least over the palette's valid entries.
* ``dither_gap`` (Riemersma maps): the same gap, step by step along the
  dither's walk, between the entry the map names and the nearest entry to
  the error-corrected colour that the walk holds at that step, the queue
  fed with the program's own earlier choices (as a served model's tokens
  are fed back when its logits are checked).
* ``dither_gap_strips`` (``checks/dither_gap_strips.py``, maps of a
  streamed call): ``dither_gap`` with each strip walked along its own
  curve with a fresh queue, as the program dithers it. A check that only
  some configurations need is a file of ``checks/``, found by its name.
* ``palette_excess``: how much worse the program's palette serves the
  image than the reference's own palette search does (``palette.py``,
  float64): the weighted squared ICtCp distance of a draw of pixels to
  their nearest entry, the program's palette over the reference's, less 1.

The program's internal centres are not returned: the palette comes back as
sRGB clamped to [0, 1] (upstream's sRGB transfer function clamps). An entry
with a channel at exactly 0 or 1 may therefore differ from the centre the
map was made with, so pixels whose named or nearest entry is such an entry
(and, for the dither, steps whose queue holds such an entry's error) are
left out and counted in ``excluded``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import colour, palette as search

QUEUE = 16
# Riemersma queue weights m^i / 16, m = 16^(1/15), oldest entry first
# (upstream riemersma.c), and the channel scales: sqrt of the Rec2020 luma
# coefficients (upstream riemersma.c)
QUEUE_WEIGHTS = tuple(16.0 ** (i / 15.0) / 16.0 for i in range(QUEUE))
CHANNEL_WEIGHTS = (0.51254268114958, 0.8234075540095561, 0.2435159132377184)


def palette_rows(palette):
    """(valid (p,) bool, clamped (p,) bool) of a returned palette."""
    pal = np.asarray(palette, dtype=np.float64)
    valid = ~np.all(pal == -1.0, axis=1)
    clamped = valid & np.any((pal == 0.0) | (pal == 1.0), axis=1)
    return valid, clamped


def bad_outputs(ok, palette, pmap, n, p):
    """Count of structural faults of one call's outputs (0 when sound)."""
    if not ok or palette is None or pmap is None:
        return 1
    pal = np.asarray(palette)
    if pal.shape != (p, 3) or not np.all(np.isfinite(pal)):
        return 1
    valid, _ = palette_rows(pal)
    bad = int(np.sum(valid & ~np.all((pal >= 0.0) & (pal <= 1.0), axis=1)))
    if not valid.any():
        bad += 1
    if not isinstance(pmap, np.ndarray) or pmap.dtype != np.int32 \
            or pmap.shape != (n,):
        return bad + 1
    lo, hi = int(pmap.min()), int(pmap.max())
    if lo < 0 or hi >= p:
        return bad + 1
    return bad + int(np.count_nonzero(~valid[pmap]))


def _rows(pixels, start, stop, device):
    return colour.srgb_of(np.ascontiguousarray(pixels[start:stop]), device)


def map_gap(pixels, palette, pmap, device, block=1 << 20):
    """(widest gap, pixels left out) of an undithered map, float64."""
    valid, clamped = palette_rows(palette)
    idx = np.flatnonzero(valid)
    # slot -> row of the valid entries (a filled slot is bad_outputs' fault)
    slot = torch.as_tensor(np.maximum(np.cumsum(valid) - 1, 0), device=device)
    pal = colour.srgb_to_ictcp(torch.as_tensor(
        np.asarray(palette)[idx], dtype=torch.float64, device=device))
    clamp_rows = torch.as_tensor(clamped[idx], device=device)
    pp = (pal * pal).sum(1)
    worst, left_out = 0.0, 0
    for s in range(0, len(pixels), block):
        x = colour.srgb_to_ictcp(_rows(pixels, s, s + block, device))
        d = torch.addmm(pp[None, :], x, pal.T, alpha=-2.0) \
            + (x * x).sum(1, keepdim=True)
        dmin, best = d.min(1)
        lab = slot[torch.as_tensor(pmap[s:s + block], device=device).long()]
        gap = d.gather(1, lab[:, None])[:, 0] - dmin
        skip = clamp_rows[lab] | clamp_rows[best]
        left_out += int(skip.sum())
        gap = torch.where(skip, torch.zeros_like(gap), gap)
        worst = max(worst, float(gap.max()))
    return worst, left_out


def hilbert_d(x, y, order):
    """Distance along the Hilbert curve of side 2^order (the classic
    rotation loop) for int64 tensors ``x``, ``y``."""
    d = torch.zeros_like(x)
    s = 1 << (order - 1)
    while s > 0:
        rx = (x & s) > 0
        ry = (y & s) > 0
        d += s * s * ((3 * rx.long()) ^ ry.long())
        flip = ~ry & rx
        xf = torch.where(flip, s - 1 - x, x)
        yf = torch.where(flip, s - 1 - y, y)
        x, y = torch.where(~ry, yf, xf), torch.where(~ry, xf, yf)
        x, y = x & (s - 1), y & (s - 1)
        s >>= 1
    return d


def visit_order(width, height, device):
    """(N,) int64 row-major pixel indices in ascending curve distance; the
    curve's side is the least power of two >= max(width, height)."""
    order = max(1, math.ceil(math.log2(max(width, height))))
    idx = torch.arange(width * height, device=device)
    return torch.argsort(hilbert_d(idx % width, idx // width, order))


def _lanes(width, height, segment, device, strip_rows=None):
    """(L, seg) visit steps: each strip of ``strip_rows`` rows (by default
    one strip, the whole image) along its own curve, whose side is the
    least power of two >= max(width, the strip's rows), in lanes of
    ``segment`` of its curve pixels, each with its own queue from zero;
    each strip's last lane, and any lane shorter than the widest, padded
    with index N."""
    n = width * height
    rows = height if not strip_rows else min(int(strip_rows), height)
    parts = []
    for r0 in range(0, height, rows):
        h = min(rows, height - r0)
        ns = width * h
        seg = max(1, min(int(segment) or ns, ns))
        lanes = -(-ns // seg)
        perm = visit_order(width, h, device) + r0 * width
        pad = torch.full((lanes * seg - ns,), n, dtype=perm.dtype,
                         device=device)
        parts.append(torch.cat([perm, pad]).reshape(lanes, seg))
    seg = max(p.shape[1] for p in parts)
    parts = [torch.nn.functional.pad(p, (0, seg - p.shape[1]), value=n)
             for p in parts]
    return torch.cat(parts), n


def walk(pixels, palette, width, height, device, segment=4096,
         dtype=torch.float64, labels=None, strip_rows=None):
    """The Riemersma walk (the curve, ``segment``-pixel lanes, the 16-deep
    queue, luma-weighted linear Rec2020) in ``dtype``, the transforms in
    float32 under a narrower one: ``(widest gap, steps left out, map)``.
    With ``strip_rows`` each strip of that many rows is walked along its
    own curve, as a streamed call dithers it (see :func:`_lanes`).
    With ``labels`` (a map to judge) the queue is fed with them and the gap
    is each label's; without, the walk takes its own nearest entry at each
    step, which makes the (N,) int32 ``map``, and the gap is 0."""
    valid, clamped = palette_rows(palette)
    idx = np.flatnonzero(valid)
    work = colour.transform_dtype(dtype)
    pal = colour.srgb_to_rec2020(torch.as_tensor(
        np.asarray(palette)[idx], dtype=work, device=device)).to(dtype)
    rec = colour.srgb_to_rec2020(colour.srgb_of(pixels, device, work))
    rec = torch.cat([rec, rec.new_zeros(1, 3)]).to(dtype)   # the pad pixel
    cw = torch.tensor(CHANNEL_WEIGHTS, dtype=dtype, device=device)
    qw = torch.tensor(QUEUE_WEIGHTS, dtype=dtype, device=device)
    clamp_rows = torch.as_tensor(clamped[idx], device=device)
    steps, n = _lanes(width, height, segment, device, strip_rows)
    slot = torch.as_tensor(np.maximum(np.cumsum(valid) - 1, 0), device=device)
    forced = labels is not None
    out = torch.zeros(n + 1, dtype=torch.long, device=device)
    if forced:
        out = torch.cat([slot[torch.as_tensor(labels, device=device).long()],
                         slot.new_zeros(1)])
    lanes = steps.shape[0]
    queue = rec.new_zeros(lanes, QUEUE, 3)
    taint = torch.zeros(lanes, dtype=torch.long, device=device)
    worst = torch.zeros((), dtype=torch.float64, device=device)
    left_out = torch.zeros((), dtype=torch.long, device=device)
    pal_s = pal * cw
    for s in range(steps.shape[1]):
        at = steps[:, s]
        px = rec[at]
        t = (px + (qw[None, :, None] * queue).sum(1)) * cw
        d = ((t[:, None, :] - pal_s[None, :, :]) ** 2).sum(-1)
        dmin, best = d.min(1)
        if forced:
            lab = out[at]
            gap = (d.gather(1, lab[:, None])[:, 0] - dmin).double()
            skip = (taint > 0) | clamp_rows[lab] | clamp_rows[best] \
                | (at == n)
            left_out += (skip & (at < n)).sum()
            worst = torch.maximum(worst, torch.where(skip, 0.0, gap).max())
            taint = torch.where(clamp_rows[lab], QUEUE,
                                (taint - 1).clamp_min(0))
        else:
            lab = out[at] = best
        queue = torch.cat([queue[:, 1:], (px - pal[lab])[:, None, :]], 1)
    pmap = torch.as_tensor(idx, device=device)[out[:n]] if not forced \
        else None
    return (float(worst), int(left_out),
            None if pmap is None else pmap.to(torch.int32).cpu().numpy())


def dither_gap(pixels, palette, pmap, width, height, device, segment=4096):
    """(widest gap, steps left out) of a Riemersma map, float64, the queue
    fed with the map's own choices."""
    worst, left_out, _ = walk(pixels, palette, width, height, device,
                              segment, labels=pmap)
    return worst, left_out


class PaletteReference:
    """The reference's palette for one image and the measure a palette is
    held to there: the weighted squared ICtCp distance of ``EVAL_PIXELS``
    pixels drawn from ``seed`` to their nearest entry. The weights are the
    call's saliency worked out again by the reference (1 without it)."""

    EVAL_PIXELS = 1 << 20

    def __init__(self, pixels, width, height, call, device, seed):
        if call.get("color_space", "ICtCp") != "ICtCp":
            raise ValueError("the reference searches in ICtCp only")
        self.call, self.seed, self.size = call, seed, (width, height)
        self.srgb = colour.srgb_of(pixels, device)
        self.weights = search.weights_of(self.srgb, width, height, call)
        n = len(self.srgb)
        g = search._generator(seed, self.srgb.device, 3)
        idx = torch.randint(n, (min(n, self.EVAL_PIXELS),), generator=g,
                            device=self.srgb.device)
        self.x = colour.srgb_to_ictcp(self.srgb[idx])
        self.w = None if self.weights is None else self.weights[idx]
        self.palette = search.search(self.srgb, self.weights, call, seed)
        self.best = search.distortion(self.x, self.w, self.palette)

    def excess(self, palette):
        """The ``palette``'s distortion over the reference's, less 1."""
        return search.distortion(self.x, self.w, palette) / self.best - 1.0


def mse_luv(pixels, palette, pmap, device, rng, cap=1 << 22):
    """CIELuv MSE of ``palette[pmap]`` against the pixels, float64, on a
    subsample of at most ``cap`` pixels drawn by ``rng`` (all pixels when
    there are no more)."""
    n = len(pixels)
    if n > cap:
        idx = rng.integers(0, n, size=cap)
        pixels, pmap = pixels[idx], pmap[idx]
    a = colour.srgb_to_cieluv(colour.srgb_of(pixels, device))
    pal = torch.as_tensor(np.clip(palette, 0.0, 1.0), dtype=torch.float64,
                          device=device)
    b = colour.srgb_to_cieluv(pal)[torch.as_tensor(pmap, device=device)
                                   .long()]
    return float(((a - b) ** 2).sum(-1).mean())

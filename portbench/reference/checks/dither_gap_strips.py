"""``dither_gap_strips``: the widest gap of a streamed call's Riemersma map.

A streamed call dithers its image in strips of rows, each along its own
Hilbert curve (side the least power of two >= max(width, the strip's
rows)), in lanes of ``dither_segment`` curve pixels with the error queue
from zero. The configuration states the strip's height as
``strip_rows``. The walk is ``check.walk``'s float64 walk over those
strips, fed with the map's own labels; the gap and the steps left out
follow ``dither_gap``'s rules (clamped entries, their taint, the pad).
With one strip covering the image it is ``dither_gap``.
"""

from __future__ import annotations

from portbench.reference import check as ref
from portbench.reference import control as ctl


def _geometry(config):
    return (int(config["strip_rows"]),
            int(config["call"].get("dither_segment", 4096)))


def check(pixels, palette, pmap, width, height, device, config):
    """(widest gap, steps left out) of the map ``pmap``."""
    rows, segment = _geometry(config)
    worst, left_out, _ = ref.walk(pixels, palette, width, height, device,
                                  segment, labels=pmap, strip_rows=rows)
    return worst, left_out


def control(pixels, palette, width, height, device, config):
    """The control's map: the same strips walked in bfloat16."""
    rows, segment = _geometry(config)
    return ctl.dither_map_strips(pixels, palette, width, height, device,
                                 rows, segment)

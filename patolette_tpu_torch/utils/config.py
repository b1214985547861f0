"""Configuration surface, copied from ``patolette_tpu/utils/config.py``.

Mirrors the reference option struct ``patolette__QuantizationOptions``
(patolette.h:13-20, defaults at patolette.c:107-119) plus the Python-level
``tile_size`` saliency knob (patolette.pyx:332-343) and the JAX package's
extensions (sampling caps, dither tiling). Field names and defaults are the
JAX package's, so an options object converts field for field
(:func:`patolette_tpu_torch.utils.carry.options_from_fields`).
"""

from __future__ import annotations

import dataclasses
import enum


class ColorSpace(enum.IntEnum):
    """Working color space for palette generation (reference enum order,
    patolette.pyx:15-18)."""

    sRGB = 0
    CIELuv = 1
    ICtCp = 2


ColorSpace_sRGB = ColorSpace.sRGB
ColorSpace_CIELuv = ColorSpace.CIELuv
ColorSpace_ICtCp = ColorSpace.ICtCp


@dataclasses.dataclass(frozen=True)
class QuantizeOptions:
    """Options for :func:`patolette_tpu_torch.quantize`.

    dither:
        Riemersma error-diffusion dithering of the palette map.
    palette_only:
        Only generate the palette; skip palette-map generation.
    color_space:
        Working space for palette generation; the direct map always runs in
        ICtCp (reference patolette.c:135-141).
    kmeans_niter:
        Weighted-KMeans refinement iterations (<=0 disables refinement).
    kmeans_max_samples:
        Max samples for KMeans refinement; hard floor of 256**2 applied as
        ``max_points_per_centroid = max(kmeans_max_samples, 256**2) / k``
        (reference refine.c:77-90).
    tile_size:
        Saliency weighting control; 0 disables saliency. With
        ``tile_size > 0`` and no explicit weights, pixels are weighted by
        MBD saliency, ``1 + sal^2 * pixels / tile_size^2``.
    verbose:
        Stage logging.
    lq_max_samples:
        Subsample cap for the GQ/LQ split decisions (0 = no cap).
    lq_batch_splits:
        Clusters split per LQ round (top-B by benefit); 1 is the reference's
        strictly sequential greedy.
    dither_segment:
        Hilbert-curve segment length of the dither scan: the error queue
        restarts every ``dither_segment`` pixels (0 = one serial chain).
    seed:
        Seed of the host sample draws (``np.random.default_rng``).
    """

    dither: bool = True
    palette_only: bool = False
    color_space: ColorSpace = ColorSpace.ICtCp
    kmeans_niter: int = 32
    kmeans_max_samples: int = 512**2
    tile_size: float = 512.0
    verbose: bool = False

    lq_max_samples: int = 1 << 18
    lq_batch_splits: int = 8
    dither_segment: int = 4096
    seed: int = 1234

    def __post_init__(self):
        if self.tile_size < 0:
            raise ValueError(
                "tile_size parameter expected to be in the range [0, inf]"
            )


def default_options() -> QuantizeOptions:
    """Default options (reference patolette.c:107-119)."""
    return QuantizeOptions()

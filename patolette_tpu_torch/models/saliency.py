"""Minimum-barrier-distance saliency weighting.

Port of ``patolette_tpu/models/saliency.py`` (reference
src/patolette/patolette.pyx:47-317):

  1. MBD of the channel-mean image (K9, ``kernels/mbd.py``; :func:`mbd`).
  2. Border prior: the Mahalanobis distance of every pixel's Lab colour to
     the mean of each of 4 border strips (thickness
     ``floor(0.1 * sqrt(rows * cols))``), each over its max, combined as
     ``sum - max``.
  3. Centre prior, sigmoid with b = 10, weights
     ``1 + sal^2 * rows * cols / tile_size^2``.

Everything but the MBD is torch glue on the image's device. Divergences
kept from the JAX package (README S5): singular border covariances take
the pseudo-inverse, and an image with a side <= 3 gets no weights (None).
Orientation: rows = height, cols = width.
"""

from __future__ import annotations

import numpy as np
import torch

from patolette_tpu_torch.kernels import mbd as K9
from patolette_tpu_torch.ops import colorspace as cs
from patolette_tpu_torch.utils.device import call_device, on_device

# jnp.linalg.pinv's default cutoff: 10 * max(m, n) * eps(f32)
_PINV_RTOL = 10.0 * 3 * float(np.finfo(np.float32).eps)


def _border_prior(lab, border):
    """4 Mahalanobis border maps, each over its max, combined sum - max
    (pyx:215-288). ``lab``: 3-tuple of (rows, cols) planes."""
    l0, l1, l2 = lab
    rows, cols = l0.shape

    def strip_view(ch):
        return [
            ch[0:border],                      # "left" (top rows, pyx:215)
            ch[rows - border - 1:-1],          # "right" (bottom rows)
            ch[:, 0:border],                   # "top" (left cols)
            ch[:, cols - border - 1:-1],       # "bottom" (right cols)
        ]

    s0, s1, s2 = strip_view(l0), strip_view(l1), strip_view(l2)
    maps = []
    for k in range(4):
        a, b, c = s0[k].reshape(-1), s1[k].reshape(-1), s2[k].reshape(-1)
        m0, m1, m2 = a.mean(), b.mean(), c.mean()
        da, db, dc = a - m0, b - m1, c - m2
        nrm = 1.0 / max(a.shape[0] - 1, 1)    # np.cov's (n - 1), pyx:232
        sab, sac, sbc = (da * db).sum(), (da * dc).sum(), (db * dc).sum()
        cov = torch.stack([
            torch.stack([(da * da).sum(), sab, sac]),
            torch.stack([sab, (db * db).sum(), sbc]),
            torch.stack([sac, sbc, (dc * dc).sum()]),
        ]) * nrm
        vi = torch.linalg.pinv(cov, rtol=_PINV_RTOL)
        x0, x1, x2 = l0 - m0, l1 - m1, l2 - m2
        d2 = (
            vi[0, 0] * x0 * x0 + vi[1, 1] * x1 * x1 + vi[2, 2] * x2 * x2
            + 2.0 * (vi[0, 1] * x0 * x1 + vi[0, 2] * x0 * x2
                     + vi[1, 2] * x1 * x2)
        )
        u = torch.sqrt(torch.clamp_min(d2, 0.0))
        maps.append(u / torch.clamp_min(u.max(), 1e-30))
    stacked = torch.stack(maps)
    return stacked.sum(0) - stacked.max(0).values


def mbd(img, device=None):
    """Minimum barrier distance (rows, cols) f32 of the (rows, cols) image
    ``img``, three alternating raster passes (pyx:158-201): K9. Numpy input
    goes to ``device`` (``cuda`` by default); tensors stay where they
    are."""
    return K9.mbd(on_device(img, call_device(img, device), torch.float32))


def get_weights(img_srgb, tile_size: float, device=None):
    """Saliency weights (H*W,) f32 in [1, inf) of the (H, W, 3) sRGB image
    ``img_srgb`` (rows = H, cols = W), or None when a side is <= 3
    (pyx:203-313), through :func:`get_weights_planar` (K9, K10). Numpy
    input goes to ``device`` (``cuda`` by default); tensors stay where
    they are."""
    img = on_device(img_srgb, call_device(img_srgb, device))
    rows, cols = int(img.shape[0]), int(img.shape[1])
    return get_weights_planar(tuple(img[..., k] for k in range(3)), rows,
                              cols, tile_size)


def _unit_max(x):
    return x / torch.clamp_min(x.max(), 1e-30)


def get_weights_planar(channels, rows: int, cols: int, tile_size: float,
                       total_pixels: int | None = None):
    """Saliency weights (rows*cols,) f32 in [1, inf) of the planar sRGB
    image ``channels`` (3-tuple of (rows*cols,) or (rows, cols)), or None
    when a side is <= 3 (pyx:203-313).

    ``total_pixels`` replaces ``rows * cols`` in the weight's area factor:
    the multi-device route runs this on each rank's row strip, whose
    weights keep the whole image's scale (JAX ``saliency.py:230-238``)."""
    rows, cols = int(rows), int(cols)
    if rows <= 3 or cols <= 3:
        return None
    r, g, b = (ch.reshape(rows, cols).to(torch.float32) for ch in channels)

    sal = K9.mbd((r + g + b) * cs._f32(1.0 / 3.0))

    border = max(int(0.1 * (rows * cols) ** 0.5), 1)
    u_final = _border_prior(cs.srgb_to_lab((r, g, b)), border)

    sal = _unit_max(_unit_max(sal) + _unit_max(u_final))

    # centre prior (pyx:296-304); w = rows, h = cols in the reference's
    # naming
    w2, h2 = rows / 2.0, cols / 2.0
    yv = torch.arange(rows, dtype=torch.float32, device=r.device)[:, None]
    xv = torch.arange(cols, dtype=torch.float32, device=r.device)[None, :]
    dist = torch.sqrt((xv - h2) ** 2 + (yv - w2) ** 2)
    c = 1.0 - dist * cs._f32(1.0 / cs._f32((w2**2 + h2**2) ** 0.5))
    sal = _unit_max(sal * c)
    sal = 1.0 / (1.0 + torch.exp(-10.0 * (sal - 0.5)))  # pyx:306-312
    area = sal.reshape(-1) ** 2 * float(
        rows * cols if total_pixels is None else int(total_pixels))
    return 1.0 + cs._div(area, float(tile_size) ** 2)

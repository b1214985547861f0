"""Palette creation from cluster labels.

Port of ``patolette_tpu/models/palette.py`` (reference
PALETTE_create, create.c:11-33): palette entry i is the weighted center of
cluster i, from one segment sum (K1) over the labels, summed over the
ranks with ``mesh``.
"""

from __future__ import annotations

import torch

from patolette_tpu_torch.ops import moments as M


def centers_from_labels(colors, weights, labels, num_slots: int, mesh=None):
    """Returns ``(centers (P,3), mass (P,))``; empty slots get zero centers
    and zero mass."""
    n = colors.shape[0]
    w = (torch.ones((n,), dtype=colors.dtype, device=colors.device)
         if weights is None else weights)
    mom = M.segment_matmul(
        torch.cat([w[:, None], w[:, None] * colors], dim=-1),
        labels.to(torch.int32),
        num_slots,
        mesh=mesh,
    )
    mass = mom[:, 0]
    ok = mass > 0.0
    centers = torch.where(
        ok[:, None], mom[:, 1:4] / torch.where(ok, mass, 1.0)[:, None], 0.0
    )
    return centers, mass

"""K5: the 24-bit nearest-palette table over the ICtCp grid.

Kernel: ``csrc/lut.cu`` (the nearest-centre scan of K3, ``csrc/nearest.cuh``,
writing u8 or u16). Twin: the JAX package's ``_argmin_lut``
(``lut.py:145-162``), whose distances and first-index ties are K3's, so the
plain version is K3's plain version over the grid, narrowed.
"""

from __future__ import annotations

import torch

from patolette_tpu_torch import kernels
from patolette_tpu_torch.kernels import build
from patolette_tpu_torch.kernels.assign import (assign_planar_plain,
                                                center_table)

# Output type -> the largest palette whose indices it holds.
_MAX_ENTRIES = {torch.uint8: 256, torch.uint16: 65536}


def lut_argmin_plain(grid, centers, valid, out_dtype):
    return assign_planar_plain(grid, centers, valid).to(out_dtype)


def lut_argmin(grid, centers, valid, out_dtype):
    """(N,) ``out_dtype`` index of the nearest valid centre for each grid
    point; ``grid`` a 3-tuple of (N,) f32 ICtCp planes, ``centers`` (K, 3)
    ICtCp, ``valid`` (K,) bool, ``out_dtype`` torch.uint8 or torch.uint16
    (the CPU twin takes any integer type)."""
    a, b, c = grid
    if a.device.type == "cpu":
        return lut_argmin_plain(grid, centers, valid, out_dtype)
    n = a.shape[0]
    k = centers.shape[0]
    for t in (a, b, c, centers):
        if t.dtype != torch.float32:
            raise TypeError("lut_argmin: f32 grid and centers")
    if (b.shape != (n,) or c.shape != (n,) or centers.shape != (k, 3)
            or valid.shape != (k,) or k < 1):
        raise ValueError("lut_argmin: bad shapes")
    if k > _MAX_ENTRIES.get(out_dtype, 0):
        raise ValueError(f"lut_argmin: {k} entries do not fit {out_dtype}")
    tab = center_table(centers)
    valid_i = valid.to(torch.int32)
    build.require_cuda("lut_argmin", a, b, c, tab, valid_i)
    out = torch.empty((n,), dtype=out_dtype, device=a.device)
    if n == 0:
        return out
    err = build.library().pt_lut_argmin(
        build.ptr(a), build.ptr(b), build.ptr(c), build.ptr(tab),
        build.ptr(valid_i), n, k, build.ptr(out), out.element_size(),
        build.stream(),
    )
    build.check(err, "lut_argmin")
    kernels.LAUNCHES["lut_argmin"] += 1
    return out

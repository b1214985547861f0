"""K3: nearest centre of channel-planar pixels.

Kernel: ``csrc/assign.cu``. Twin: the JAX package's ``assign_planar`` block
(``assign.py:96-108``): ``d = |c|^2 - 2 ((xa ca + xb cb) + xc cc)``, invalid
slots at +inf, first minimum wins.
"""

from __future__ import annotations

import torch

from patolette_tpu_torch import kernels
from patolette_tpu_torch.kernels import build

_CHUNK = 1 << 16


def center_table(centers):
    """``(K, 4)`` rows ``[c0, c1, c2, |c|^2]`` with ``|c|^2`` summed as
    ``(c0 c0 + c1 c1) + c2 c2`` (the kernels compute it the same way)."""
    c = centers.to(torch.float32)
    sq = c * c
    c2 = (sq[:, 0] + sq[:, 1]) + sq[:, 2]
    return torch.cat([c, c2[:, None]], dim=1).contiguous()


def assign_planar_plain(channels, centers, valid):
    a, b, c = channels
    tab = center_table(centers)
    ca, cb, cc, c2 = (tab[:, i] for i in range(4))
    n = a.shape[0]
    out = torch.empty((n,), dtype=torch.int32, device=a.device)
    invalid = ~valid[None, :]
    for s in range(0, n, _CHUNK):
        xa, xb, xc = (v[s:s + _CHUNK, None] for v in (a, b, c))
        # c2 - 2 ((xa ca + xb cb) + xc cc), each op rounded in this order,
        # in place (three (chunk, K) buffers, not eight)
        d = xa * ca
        d += xb * cb
        d += xc * cc
        d *= 2.0
        torch.sub(c2[None, :], d, out=d)
        d.masked_fill_(invalid, torch.inf)
        out[s:s + _CHUNK] = torch.argmin(d, dim=1).to(torch.int32)
    return out


def assign_planar(channels, centers, valid):
    """Labels (N,) int32 of the nearest valid centre; ``channels`` a 3-tuple
    of (N,) f32, ``centers`` (K, 3), ``valid`` (K,) bool."""
    a, b, c = channels
    if a.device.type == "cpu":
        return assign_planar_plain(channels, centers, valid)
    n = a.shape[0]
    k = centers.shape[0]
    for t in (a, b, c, centers):
        if t.dtype != torch.float32:
            raise TypeError("assign_planar: f32 channels and centers")
    if (b.shape != (n,) or c.shape != (n,) or centers.shape != (k, 3)
            or valid.shape != (k,) or k < 1):
        raise ValueError("assign_planar: bad shapes")
    tab = center_table(centers)
    valid_i = valid.to(torch.int32)
    build.require_cuda("assign_planar", a, b, c, tab, valid_i)
    labels = torch.empty((n,), dtype=torch.int32, device=a.device)
    if n == 0:
        return labels
    err = build.library().pt_assign_planar(
        build.ptr(a), build.ptr(b), build.ptr(c), build.ptr(tab),
        build.ptr(valid_i), n, k, build.ptr(labels), build.stream(),
    )
    build.check(err, "assign_planar")
    kernels.LAUNCHES["assign_planar"] += 1
    return labels

"""K8: the Riemersma error-diffusion scan along the Hilbert curve.

Kernel: ``csrc/dither.cu``. Twin: the JAX package's ``_dither_scan_core``
(``dither.py:144-203``) fed by ``_dither_stream_planar``: lanes of ``seg``
curve pixels (the last short), each a serial chain with a 16-deep error
queue that starts at zero. Both versions sum the queue in one fixed order
(oldest first) and round every op on its own, so their labels agree bit
for bit.
"""

from __future__ import annotations

import functools

import torch

from patolette_tpu_torch import kernels
from patolette_tpu_torch.kernels import build

QUEUE = 16

# The JAX package's f32 queue weights w_i = m^i / 16, m = exp(ln 16 / 15),
# oldest entry first (riemersma.c:360-373), copied bit for bit.
QUEUE_WEIGHTS = tuple(float.fromhex(h) for h in (
    "0x1p-4", "0x1.33f972p-4", "0x1.72803ap-4", "0x1.bdb8cap-4",
    "0x1.0c1b74p-3", "0x1.428a2ap-3", "0x1.8405fap-3", "0x1.d2cd4p-3",
    "0x1.18c98p-2", "0x1.51cb3cp-2", "0x1.965fdep-2", "0x1.e8e0fp-2",
    "0x1.26110ep-1", "0x1.61c4fep-1", "0x1.a997f2p-1", "0x1.ffffeap-1",
))

# sqrt of the Rec2020 luma coefficients (riemersma.c:38-42)
R_WEIGHT = 0.51254268114958
G_WEIGHT = 0.8234075540095561
B_WEIGHT = 0.2435159132377184


@functools.lru_cache(maxsize=None)
def _params(device):
    """The 16 queue weights then the 3 channel weights, f32 (made once a
    device: a copy from the host would wait for the device each call)."""
    return torch.tensor(QUEUE_WEIGHTS + (R_WEIGHT, G_WEIGHT, B_WEIGHT),
                        dtype=torch.float32, device=device)


def palette_table(palette2020, valid):
    """(K, 8) f32 rows ``[pa, pb, pc, ps2, r0, r1, r2, 0]``: the
    luma-scaled palette, its squared norm ``(pa pa + pb pb) + pc pc`` (+inf
    for invalid slots) and the raw linear-Rec2020 colour."""
    pal = palette2020.to(torch.float32)
    scaled = pal * _params(pal.device)[QUEUE:][None, :]
    sq = scaled * scaled
    ps2 = (sq[:, 0] + sq[:, 1]) + sq[:, 2]
    ps2 = torch.where(valid, ps2, torch.inf)
    zero = torch.zeros_like(ps2)
    return torch.stack([scaled[:, 0], scaled[:, 1], scaled[:, 2], ps2,
                        pal[:, 0], pal[:, 1], pal[:, 2], zero], 1).contiguous()


def lane_shape(n: int, segment: int):
    """``(seg, lanes)``: ``segment`` 0 means one serial lane."""
    seg = int(segment) if segment else n
    seg = max(1, min(seg, n))
    return seg, -(-n // seg)


def dither_scan_plain(channels, perm, table, segment):
    n = channels[0].shape[0]
    seg, lanes = lane_shape(n, segment)
    dev = channels[0].device
    params = _params(dev)
    qw, cw = params[:QUEUE], params[QUEUE:]
    pa, pb, pc, ps2 = (table[:, i][:, None] for i in range(4))
    raw = table[:, 4:7]
    # lane-major steps; pad slots read a zero pixel and write slot n
    pad = torch.full((lanes * seg - n,), n, dtype=torch.int64, device=dev)
    steps = torch.cat([perm.long(), pad]).reshape(lanes, seg)
    x = torch.stack([torch.cat([ch, ch.new_zeros(1)]) for ch in channels])
    queues = x.new_zeros((3, QUEUE, lanes))
    out = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
    for s in range(seg):
        idx = steps[:, s]
        px = x[:, idx]                                    # (3, lanes)
        acc = torch.zeros_like(px)
        for q in range(QUEUE):
            acc = acc + qw[q] * queues[:, q]
        q = (px + acc) * cw[:, None]
        d = ps2 - 2.0 * ((pa * q[0][None, :] + pb * q[1][None, :])
                         + pc * q[2][None, :])            # (K, lanes)
        best = torch.argmin(d, dim=0)
        err = px - raw[best].T
        queues = torch.cat([queues[:, 1:], err[:, None, :]], dim=1)
        out[idx] = best.to(torch.int32)
    return out[:n]


# Threads a lane for a palette of up to so many entries (csrc/dither.cu's
# G): each thread then holds at most 32 entries in registers. At 256
# entries chip_smoke.py's sweep at the 4K shape put G = 8 first (1.58–1.67
# ms; 16: 1.68–1.80, 32: 2.44–2.58, 4, from shared memory: 4.41–4.50;
# NVIDIA H100 80GB HBM3, 700 W).
GROUPS = ((256, 8), (512, 16))
GROUP_MAX = 32


def group_for(k):
    """csrc/dither.cu's threads a lane for a palette of ``k`` entries."""
    return next((g for top, g in GROUPS if k <= top), GROUP_MAX)


def dither_scan(channels, perm, table, segment):
    """Palette index (N,) int32 of every pixel. ``channels``: 3-tuple of
    (N,) f32 linear Rec2020; ``perm``: (N,) int32 visit order; ``table``:
    :func:`palette_table`; ``segment``: lane length (0 = one lane)."""
    if channels[0].device.type == "cpu":
        return dither_scan_plain(channels, perm, table, segment)
    out = _launch(channels, perm, table, segment, group_for(table.shape[0]))
    kernels.LAUNCHES["dither_scan"] += 1
    return out


def dither_scan_group(channels, perm, table, segment, group):
    """One launch on the card with ``group`` (4, 8, 16 or 32) threads a
    lane: a measurement for chip_smoke.py's sweep, on no path and not
    counted in ``LAUNCHES``."""
    return _launch(channels, perm, table, segment, group)


def _launch(channels, perm, table, segment, group):
    a, b, c = channels
    n = a.shape[0]
    k = table.shape[0]
    for t in (a, b, c, table):
        if t.dtype != torch.float32:
            raise TypeError("dither_scan: f32 channels and table")
    if (b.shape != (n,) or c.shape != (n,) or perm.shape != (n,)
            or perm.dtype != torch.int32 or table.shape != (k, 8) or k < 1):
        raise ValueError("dither_scan: bad shapes")
    params = _params(a.device)
    build.require_cuda("dither_scan", a, b, c, perm, table, params)
    out = torch.empty((n,), dtype=torch.int32, device=a.device)
    if n == 0:
        return out
    seg, lanes = lane_shape(n, segment)
    err = build.library().pt_dither_scan(
        build.ptr(a), build.ptr(b), build.ptr(c), build.ptr(perm),
        build.ptr(table), build.ptr(params), n, k, seg, lanes, int(group),
        build.ptr(out), build.stream(),
    )
    build.check(err, "dither_scan")
    return out

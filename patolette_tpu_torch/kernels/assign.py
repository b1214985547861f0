"""K3: nearest centre of channel-planar pixels.

Kernel: ``csrc/assign.cu``. Twin: the JAX package's ``assign_planar`` block
(``assign.py:96-108``): ``d = |c|^2 - 2 ((xa ca + xb cb) + xc cc)``, invalid
slots at +inf, the first minimum wins and a NaN distance counts as the
least (``argmin``'s rule).

:func:`sorted_groups` and :func:`assign_grouped_model` are the kernel's
grouping in numpy: each tile of ``SORT_TILE`` consecutive pixels cut by
median splits of its widest channel into boxes of ``GROUP`` points (a
k-d tree), each scanned over ``kernels.lut.box_candidates`` alone. The
tests hold the model's labels to the JAX package's.
"""

from __future__ import annotations

import numpy as np
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
    # two (chunk, K) buffers made once: a fresh one a chunk pays the first
    # touch of its pages every time
    d_buf = torch.empty((min(n, _CHUNK), tab.shape[0]), dtype=torch.float32,
                        device=a.device)
    t_buf = torch.empty_like(d_buf)
    for s in range(0, n, _CHUNK):
        m = min(_CHUNK, n - s)
        d, t = d_buf[:m], t_buf[:m]
        xa, xb, xc = (v[s:s + m, None] for v in (a, b, c))
        # c2 - 2 ((xa ca + xb cb) + xc cc), each op rounded in this order
        # (the doubling is exact, so c2 - 2 d rounds once either way)
        torch.mul(xa, ca, out=d)
        d += torch.mul(xb, cb, out=t)
        d += torch.mul(xc, cc, out=t)
        torch.sub(c2[None, :], d, alpha=2.0, out=d)
        d.masked_fill_(invalid, torch.inf)
        out[s:s + m] = torch.argmin(d, dim=1)
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


# csrc/nearest.cuh's sorted layout (K3's): points a block splits, points a
# warp scans (a leaf), bins a split sorts by
SORT_TILE = 8192
GROUP = 256
KD_BINS = 256


def _kd_bins(v, lo, ext):
    """The kernel's bin of each value ``v`` (f32) across [lo, lo + ext):
    ``(v - lo) * (KD_BINS / ext)`` cut to an integer, below 1 (NaN among
    them) to 0, saturating at KD_BINS - 1."""
    with np.errstate(all="ignore"):
        scale = np.float32(KD_BINS) / np.float32(ext)
        t = (v - np.float32(lo)) * scale
        return np.where(t >= 1, np.minimum(t, KD_BINS - 1), 0).astype(
            np.int64)


def kd_order(x):
    """The order of one tile ``x`` (SORT_TILE, 3) f32 (padded with NaN)
    after the kernel's median splits: each level cuts every node (a run of
    the order) at the median of its widest channel, by a stable sort on
    :func:`_kd_bins` (the kernel's order within a bin depends on
    scheduling, which moves only which centres a warp lists)."""
    order = np.arange(len(x))
    size = len(x)
    while size > GROUP:
        for s in range(0, len(x), size):
            node = order[s:s + size]
            pts = x[node]
            with np.errstate(all="ignore"):
                lo = np.fmin.reduce(pts, axis=0)
                hi = np.fmax.reduce(pts, axis=0)
                lo = np.where(np.isnan(lo), np.float32(np.inf), lo)
                hi = np.where(np.isnan(hi), np.float32(-np.inf), hi)
                ext = hi - lo
            axis = 0
            for ch in (1, 2):
                if ext[ch] > ext[axis]:
                    axis = ch
            bins = _kd_bins(pts[:, axis], lo[axis], ext[axis])
            order[s:s + size] = node[np.argsort(bins, kind="stable")]
        size //= 2
    return order


def sorted_groups(x):
    """Index arrays into ``x`` (N, 3) f32: the groups of at most ``GROUP``
    points one warp of the kernel scans, tile by tile (the leaves of
    :func:`kd_order`, without the tile's padding)."""
    out = []
    for s in range(0, len(x), SORT_TILE):
        tile = x[s:s + SORT_TILE]
        pad = np.full((SORT_TILE - len(tile), 3), np.nan, np.float32)
        order = kd_order(np.concatenate([tile, pad]))
        for g in range(0, SORT_TILE, GROUP):
            leaf = order[g:g + GROUP]
            leaf = leaf[leaf < len(tile)]
            if len(leaf):
                out.append(s + leaf)
    return out


def scan_listed(d, listed):
    """The kernel's scan of one group's (M, L) distances to its listed
    centres (ascending): the first NaN, else the first minimum below
    +inf, else 0."""
    out = np.zeros(len(d), np.int64)
    nan = np.isnan(d)
    has_nan = nan.any(axis=1)
    out[has_nan] = listed[np.argmax(nan[has_nan], axis=1)]
    rest = ~has_nan
    if rest.any() and len(listed):
        m = np.argmin(d[rest], axis=1)
        finite = d[rest][np.arange(int(rest.sum())), m] < np.inf
        out[np.flatnonzero(rest)[finite]] = listed[m[finite]]
    return out


def assign_grouped_model(channels, centers, valid):
    """K3's labels by the kernel's own route, in numpy: the groups of
    :func:`sorted_groups`, each scanned over the centres that
    ``box_candidates`` lists for it (:func:`scan_listed`), a point with a
    NaN coordinate at the first valid slot (every distance NaN). Also the
    number of centres each group listed."""
    from patolette_tpu_torch.kernels.lut import box_candidates

    x = np.stack([np.asarray(ch, np.float32) for ch in channels], 1)
    centers = np.asarray(centers, np.float32)
    ok = np.asarray(valid, bool)
    tab = center_table(torch.from_numpy(centers)).numpy()
    labels = np.zeros(len(x), np.int64)
    listed_counts = []
    for idx in sorted_groups(x):
        pts = x[idx]
        listed = box_candidates(pts, centers, ok)
        listed_counts.append(len(listed))
        c = tab[listed]
        with np.errstate(all="ignore"):
            dot = (pts[:, :1] * c[None, :, 0] + pts[:, 1:2] * c[None, :, 1]
                   ) + pts[:, 2:] * c[None, :, 2]
            d = c[None, :, 3] - np.float32(2) * dot
        labels[idx] = scan_listed(d, listed)
    first_valid = int(np.argmax(ok)) if ok.any() else 0
    labels[np.isnan(x).any(axis=1)] = first_valid
    return labels.astype(np.int32), np.asarray(listed_counts)

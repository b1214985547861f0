"""The reference's palette search: upstream's semantics, worked out again
from the input pixels, in any torch floating dtype (float64 for the
reference, bfloat16 for the control).

Upstream (big-nacho/patolette, lib/src and patolette.pyx), as the float64
NumPy oracle of the repo's tests transcribes it (``tests/ref_oracle.py``):

* weights: MBD saliency when ``tile_size > 0`` (pyx:47-313): three
  alternating raster scans of the minimum barrier distance on the channel
  mean, plus a border prior (Mahalanobis distance of each pixel's CIELAB
  colour to four border strips), a centre prior and a sigmoid;
  ``1 + sal^2 * area / tile_size^2``;
* GQ (global.c): 512 buckets along the unweighted principal axis, Wu's
  dynamic program over the buckets' unweighted moments up to 12 cells,
  stopped by the bias test;
* LQ (local.c): greedy splits of the cluster of largest benefit, each along
  its weighted principal axis at the best of 512 buckets, bucket masses
  summed as whole numbers (``size_t += double``);
* KMeans (refine.c, faiss): weighted Lloyd iterations from the LQ centres on
  a draw of ``k * (max(max_samples, 256^2) // k)`` pixels, an empty cluster
  split off the largest.

The search runs on a draw of at most ``SEARCH_PIXELS`` pixels (saliency
on the whole image), so that it fits a run's budget at any size; upstream
searches every pixel. Every tensor of the search is in ``dtype`` and
every operation is torch's in that dtype (the sums by bucket or cluster,
``index_add_``, accumulate in it); under a narrower ``dtype`` than
float32 the colour transforms run in float32, as the program's do. The
3x3 eigenproblems are solved in float64 on the host from the ``dtype``
covariance.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import colour

DELTA = 1e-16
BUCKETS = 512
MAX_K = 12
BIAS_THRESHOLD = 0.1
CELL_BIAS_THRESHOLD = 0.9
MIN_KMEANS_SAMPLES = 256 * 256
SPLIT_EPS = 1.0 / 1024.0
SEARCH_PIXELS = 1 << 21


def _generator(seed, device, stream):
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 2654435761 + stream) % (1 << 63))
    return g


def _bucket_sum(index, values, size):
    """Sums of ``values`` by ``index`` into ``size`` rows."""
    return torch.zeros((size, *values.shape[1:]), dtype=values.dtype,
                       device=values.device).index_add_(0, index, values)


def _prefix(index, values, size):
    """Cumulative ``_bucket_sum``."""
    return _bucket_sum(index, values, size).cumsum(0)


# --------------------------------------------------------------- saliency

def _mbd(img):
    """Minimum barrier distance of (rows, cols) ``img``: three raster
    scans, inverse, forward, inverse (pyx:54-201). Each scan goes one
    anti-diagonal at a time: cell (x, y) is row x of diagonal x + y, and
    its two neighbours lie on the diagonal before (after, inverse)."""
    rows, cols = img.shape
    x = torch.arange(rows, device=img.device)[:, None].expand(rows, cols)
    s = x + torch.arange(cols, device=img.device)[None, :]
    d = torch.full_like(img, float("inf"))
    d[0], d[-1], d[:, 0], d[:, -1] = 0, 0, 0, 0
    # (diagonal, [distance, upper, lower, value], row)
    st = img.new_zeros(rows + cols - 1, 4, rows)
    for k, plane in enumerate((d, img, img, img)):
        st[s, k, x] = plane
    for it in range(3):
        inverse = it % 2 == 0
        x_lo, x_hi = (2, rows - 2) if inverse else (1, rows - 2)
        y_lo, y_hi = (2, cols - 2) if inverse else (1, cols - 2)
        diags = range(x_lo + y_lo, x_hi + y_hi + 1)
        for t in (reversed(diags) if inverse else diags):
            xa, xb = max(x_lo, t - y_hi), min(x_hi, t - y_lo)
            if xa > xb:
                continue
            cur = st[t, :, xa:xb + 1]
            v = cur[3]
            if inverse:     # (x + 1, y) and (x, y + 1): rows x + 1, x
                nb = st[t + 1, 1:3, xa:xb + 2]
                nb = torch.stack([nb[:, 1:], nb[:, :-1]])
            else:           # (x - 1, y) and (x, y - 1): rows x - 1, x
                nb = st[t - 1, 1:3, xa - 1:xb + 1]
                nb = torch.stack([nb[:, :-1], nb[:, 1:]])
            hi = torch.maximum(nb[:, 0], v)
            lo = torch.minimum(nb[:, 1], v)
            # keep, else the first neighbour, else the second: the least
            # barrier, the earlier of equals
            opts = torch.cat([cur[None, :3],
                              torch.stack([hi - lo, hi, lo], 1)])
            pick = opts[:, 0].argmin(0)
            cur[:3] = opts.gather(0, pick[None, None].expand(1, 3, -1))[0]
    return st[s, 0, x]


def _border_prior(lab, rows, cols):
    """Four Mahalanobis maps to the border strips, each over its max,
    summed less their max (pyx:203-288)."""
    border = max(int(0.1 * (rows * cols) ** 0.5), 1)
    img = lab.reshape(rows, cols, 3)
    strips = (img[0:border], img[rows - border - 1:-1],
              img[:, 0:border], img[:, cols - border - 1:-1])
    maps = []
    for st in strips:
        v = st.reshape(-1, 3)
        m = v.mean(0)
        dv = v - m
        cov = dv.T @ dv / max(v.shape[0] - 1, 1)
        vi = torch.linalg.pinv(cov.double()).to(lab.dtype)
        x = lab - m
        u = ((x @ vi) * x).sum(-1).clamp_min(0.0).sqrt()
        maps.append(u / u.max().clamp_min(1e-30))
    stacked = torch.stack(maps)
    return stacked.sum(0) - stacked.max(0).values


def saliency(srgb, rows, cols, tile_size):
    """(N,) weights in [1, inf) of an (N, 3) sRGB image of ``rows`` x
    ``cols``, or None when a side is 3 or less (pyx:203-313)."""
    if rows <= 3 or cols <= 3:
        return None
    sal = _mbd(srgb.mean(-1).reshape(rows, cols)).reshape(-1)
    lab = colour.srgb_to_lab(srgb.to(colour.transform_dtype(srgb.dtype)))
    prior = _border_prior(lab.to(srgb.dtype), rows, cols)
    sal = sal / sal.max().clamp_min(1e-30) \
        + prior / prior.max().clamp_min(1e-30)
    sal = sal / sal.max().clamp_min(1e-30)
    yv, xv = torch.meshgrid(
        torch.arange(rows, dtype=srgb.dtype, device=srgb.device),
        torch.arange(cols, dtype=srgb.dtype, device=srgb.device),
        indexing="ij")
    w2, h2 = rows / 2.0, cols / 2.0
    centre = 1.0 - ((xv - h2) ** 2 + (yv - w2) ** 2).sqrt() \
        / (w2 ** 2 + h2 ** 2) ** 0.5
    sal = sal * centre.reshape(-1)
    sal = sal / sal.max().clamp_min(1e-30)
    sal = torch.sigmoid(10.0 * (sal - 0.5))
    return 1.0 + sal ** 2 * (rows * cols) / tile_size ** 2


# -------------------------------------------------------- shared machinery

def _eig_axis(cov):
    """Principal axis of a 3x3 covariance (largest eigenvalue's vector)."""
    _, vecs = np.linalg.eigh(cov.double().cpu().numpy())
    return torch.as_tensor(vecs[:, -1], dtype=cov.dtype, device=cov.device)


def pca_axis(x, w):
    """Weighted principal axis (pca.c), or None for no mass."""
    if w is None:
        w = torch.ones(len(x), dtype=x.dtype, device=x.device)
    wsum = w.sum()
    if float(wsum) <= 0:
        return None
    mu = (w[:, None] * x).sum(0) / wsum
    xc = x - mu
    return _eig_axis((w[:, None] * xc).T @ xc / wsum)


def axis_sort(x, axis):
    """Bucket of each row along ``axis`` (sort.c), round robin when the
    projections are all equal."""
    dots = x @ axis
    lo, hi = dots.min(), dots.max()
    if float(hi - lo) < DELTA:
        return torch.arange(len(x), device=x.device) % BUCKETS
    ratio = (dots - lo) / (hi - lo)
    return (BUCKETS * ratio).long().clamp_max(BUCKETS - 1)


# --------------------------------------------------------------------- GQ

def gq(x):
    """(labels, cells): Wu's dynamic program along the unweighted principal
    axis (global.c:388-443), ties to the largest cut, each row seeded with
    ``E[n-1]`` (global.c:270-276)."""
    dt, dev = x.dtype, x.device
    axis = pca_axis(x, None)
    bm = axis_sort(x, axis)
    axis = axis.cpu()
    j = bm + 1
    w0 = _prefix(j, torch.ones(len(x), dtype=dt, device=dev), BUCKETS + 1)
    w1 = _prefix(j, x, BUCKETS + 1)
    w2 = _prefix(j, (x * x).sum(1), BUCKETS + 1)
    wrs = _prefix(j, (x[:, :, None] * x[:, None, :]).reshape(-1, 9),
                  BUCKETS + 1)
    w0, w1, w2, wrs = (t.cpu() for t in (w0, w1, w2, wrs))
    # D[t, n]: distortion of buckets t+1..n (0 for an empty cell)
    cnt = w0[None, :] - w0[:, None]
    d1 = w1[None, :, :] - w1[:, None, :]
    dist = w2[None, :] - w2[:, None] \
        - (d1 * d1).sum(-1) / torch.where(cnt > 0, cnt, torch.ones_like(cnt))
    dist = torch.where(cnt > 0, dist, torch.zeros_like(dist))

    def cell_axis(a, b):
        n = w0[b] - w0[a]
        if float(n) == 0:
            return torch.zeros(3, dtype=dt)
        mu = (w1[b] - w1[a]) / n
        cov = (wrs[b] - wrs[a]).reshape(3, 3) / n - torch.outer(mu, mu)
        return _eig_axis(cov)

    def terminate(q):
        cells = list(zip(q[:-1], q[1:]))
        total = sum(float(dist[a, b]) for a, b in cells)
        if total < DELTA:
            return True
        bias = 0.0
        for a, b in cells:
            ca = cell_axis(a, b)
            norms = float(torch.linalg.norm(axis) * torch.linalg.norm(ca))
            cb = 0.0 if norms < DELTA else min(
                1.0, abs(float(ca @ axis)) / norms)
            if cb >= CELL_BIAS_THRESHOLD:
                bias += float(dist[a, b]) / total * cb
        return bias < BIAS_THRESHOLD

    e = dist[0].clone()
    cut = torch.zeros(MAX_K + 1, BUCKETS + 1, dtype=torch.long)
    q = [0, BUCKETS]
    t_idx = torch.arange(BUCKETS + 1)
    inf = torch.tensor(float("inf"), dtype=dt)
    for k in range(2, MAX_K + 1):
        if terminate(q):
            break
        prev = e.clone()
        cost = prev[:, None] + dist
        ok = (t_idx[:, None] >= k - 1) & (t_idx[:, None] <= t_idx[None, :] - 2)
        cost = torch.where(ok, cost, inf)
        m = cost.min(0).values
        # the largest t of the least cost: first in the reversed rows
        t_best = BUCKETS - (cost.flip(0) == m[None, :]).long().argmax(0)
        for_n = t_idx[k + 1:]
        better = m[for_n] < prev[for_n - 1]
        cut[k, for_n] = torch.where(better, t_best[for_n], for_n - 1)
        e[for_n] = torch.where(better, m[for_n], prev[for_n - 1])
        chain = [0] * (k + 1)
        chain[k] = t = BUCKETS
        for i in range(k - 1, 0, -1):
            t = int(cut[i + 1, t])
            chain[i] = t
        q = chain
    ends = torch.tensor(q[1:], device=dev)
    cell_of_bucket = torch.searchsorted(
        ends, torch.arange(BUCKETS, device=dev) + 1, side="left")
    return cell_of_bucket[bm], len(q) - 1


# --------------------------------------------------------------------- LQ

class _Cluster:
    """Rows of one cluster, with its weighted centre and distortion."""

    def __init__(self, x, w, idx):
        self.idx = idx
        c = x[idx]
        cw = torch.ones(len(idx), dtype=x.dtype, device=x.device) \
            if w is None else w[idx]
        wsum = cw.sum()
        if len(idx) == 0 or float(wsum) <= 0:
            self.centre = torch.zeros(3, dtype=x.dtype, device=x.device)
            self.distortion = 0.0
            return
        self.centre = (cw[:, None] * c).sum(0) / wsum
        self.distortion = float((cw * ((c - self.centre) ** 2).sum(-1))
                                .sum())


def _best_bucket(c, w, bm):
    """local.c:102-177: the bucket that splits best, masses summed as
    whole numbers (each add truncated, so a weight counts as its floor)."""
    dt, dev = c.dtype, c.device
    mass = torch.ones(len(c), dtype=dt, device=dev) if w is None \
        else torch.floor(w)
    ww = torch.ones(len(c), dtype=dt, device=dev) if w is None else w
    sums = _prefix(bm, ww[:, None] * c, BUCKETS)
    sizes = _prefix(bm, mass, BUCKETS)
    sl, sr = sizes, sizes[-1] - sizes
    sr_sum = sums[-1] - sums

    def part(s, n):
        return torch.where(n[:, None] != 0,
                           s ** 2 / torch.where(n[:, None] != 0, n[:, None],
                                                torch.ones_like(n[:, None])),
                           torch.zeros_like(s))

    return int((part(sums, sl) + part(sr_sum, sr)).sum(-1).argmax())


def _split(x, w, cl):
    """local.c:179-254: the two halves of a cluster, or None."""
    if len(cl.idx) <= 1:
        return None
    c = x[cl.idx]
    cw = None if w is None else w[cl.idx]
    axis = pca_axis(c, cw)
    if axis is None:
        return None
    bm = axis_sort(c, axis)
    left = bm <= _best_bucket(c, cw, bm)
    return _Cluster(x, w, cl.idx[left]), _Cluster(x, w, cl.idx[~left])


def lq(x, w, labels, k0, palette_size):
    """local.c:318-404: greedy splits up to ``palette_size`` clusters, the
    first of the largest benefits; (k, 3) centres."""
    order = torch.argsort(labels, stable=True)
    counts = torch.bincount(labels, minlength=k0).tolist()
    clusters = [_Cluster(x, w, idx) for idx in torch.split(order, counts)]
    if len(clusters) < palette_size:
        children = [_split(x, w, c) for c in clusters]

        def benefit(i):
            ch = children[i]
            if ch is None:
                return 0.0
            return clusters[i].distortion - (ch[0].distortion
                                             + ch[1].distortion)

        gains = [benefit(i) for i in range(len(clusters))]
        for _ in range(len(clusters), palette_size):
            best = int(np.argmax(gains))
            if gains[best] < DELTA:
                break
            left, right = children[best]
            clusters.append(left)
            clusters[best] = right
            children.append(_split(x, w, left))
            children[best] = _split(x, w, right)
            gains.append(benefit(len(clusters) - 1))
            gains[best] = benefit(best)
    return torch.stack([c.centre for c in clusters])


# ----------------------------------------------------------------- KMeans

def nearest(x, c, block=1 << 15):
    """(n,) index of the nearest row of ``c`` to each row of ``x``."""
    return torch.cat([((x[s:s + block, None, :] - c[None]) ** 2).sum(-1)
                      .argmin(1) for s in range(0, len(x), block)])


def kmeans(x, w, centres, niter, max_samples, generator):
    """Weighted Lloyd iterations (refine.c, faiss Clustering.cpp)."""
    k = len(centres)
    cap = (max(int(max_samples), MIN_KMEANS_SAMPLES) // max(k, 1)) * k
    if len(x) > cap:
        idx = torch.randperm(len(x), generator=generator,
                             device=generator.device)[:cap].to(x.device)
        x, w = x[idx], None if w is None else w[idx]
    if w is None:
        w = torch.ones(len(x), dtype=x.dtype, device=x.device)
    c = centres.clone()
    parity = torch.tensor([1.0, -1.0, 1.0], dtype=x.dtype, device=x.device)
    for _ in range(niter):
        a = nearest(x, c)
        mass = _bucket_sum(a, w, k)
        sums = _bucket_sum(a, w[:, None] * x, k)
        nz = mass > 0
        c = torch.where(nz[:, None], sums / torch.where(
            nz, mass, torch.ones_like(mass))[:, None], c)
        for ci in torch.nonzero(~nz).flatten().tolist():
            cj = int(mass.argmax())
            base = c[cj].clone()
            c[ci] = base * (1.0 + SPLIT_EPS * parity)
            c[cj] = base * (1.0 - SPLIT_EPS * parity)
            mass[ci] = mass[cj] / 2.0
            mass[cj] -= mass[ci]
    return c


# ------------------------------------------------------------------ whole

def weights_of(srgb, width, height, call):
    """The call's pixel weights (saliency when ``tile_size > 0``), or
    None."""
    tile = float(call.get("tile_size", 0.0))
    if tile <= 0:
        return None
    return saliency(srgb, height, width, tile)


def search(srgb, weights, call, seed, dtype=torch.float64):
    """(P, 3) float64 sRGB palette clamped to [0, 1], the unused slots
    [-1, -1, -1], as the program returns one: the search in ``dtype`` on a
    draw of at most ``SEARCH_PIXELS`` rows of the (N, 3) sRGB ``srgb``
    with their ``weights`` (or None)."""
    dev = srgb.device
    p = int(call["palette_size"])
    n = len(srgb)
    if n > SEARCH_PIXELS:
        idx = torch.randperm(n, generator=_generator(seed, dev, 1),
                             device=dev)[:SEARCH_PIXELS]
        srgb = srgb[idx]
        weights = None if weights is None else weights[idx]
    work = colour.transform_dtype(dtype)
    x = colour.srgb_to_ictcp(srgb.to(work)).to(dtype)
    w = None if weights is None else weights.to(dtype)
    labels, k0 = gq(x)
    centres = lq(x, w, labels, k0, p)
    if int(call.get("kmeans_niter", 0)) > 0:
        centres = kmeans(x, w, centres, int(call["kmeans_niter"]),
                         int(call.get("kmeans_max_samples", 512 ** 2)),
                         _generator(seed, dev, 2))
    pal = colour.ictcp_to_srgb(centres.to(torch.float64)).cpu().numpy()
    out = np.full((p, 3), -1.0)
    out[:len(pal)] = pal
    return out


def distortion(ictcp, weights, palette):
    """Weighted squared ICtCp distance of each row of ``ictcp`` to its
    nearest valid entry of the sRGB ``palette``, summed (float64)."""
    pal = np.asarray(palette, dtype=np.float64)
    pal = pal[~np.all(pal == -1.0, axis=1)]
    c = colour.srgb_to_ictcp(torch.as_tensor(pal, device=ictcp.device))
    a = nearest(ictcp, c)
    d = ((ictcp - c[a]) ** 2).sum(-1)
    return float(d.sum() if weights is None else (weights * d).sum())

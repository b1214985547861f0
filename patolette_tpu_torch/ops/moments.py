"""Weighted moment accumulation, axis projection and bucket sorting.

Port of ``patolette_tpu/ops/moments.py``. The per-segment sum
(:func:`segment_matmul`, K1) is the hand-written CUDA kernel
``kernels.segment.segment_sum``; the JAX package's one-hot matmul was a TPU
formulation and is not carried over.

With ``mesh`` (``parallel/mesh.py``), each rank's partial sums are
summed over the ranks in rank order, as the JAX package ``psum``s them.

Colors are SHIFTED by a provided center before squaring, so f32
accumulation of the translation-invariant statistics (distortion,
covariance) does not cancel catastrophically.

Moment vector layout (length 11):
  [0]    w0   = sum w
  [1:4]  w1   = sum w * x
  [4]    w2   = sum w * |x|^2
  [5:11] wrs  = sum w * (xx, xy, xz, yy, yz, zz)
"""

from __future__ import annotations

import torch

from patolette_tpu_torch.kernels.segment import segment_sum
from patolette_tpu_torch.parallel import mesh as PM

NUM_MOMENTS = 11
IDX_W0 = 0
IDX_W1 = slice(1, 4)
IDX_W2 = 4
IDX_WRS = slice(5, 11)


def sum3(t):
    """``t[..., 0] + t[..., 1] + t[..., 2]`` in that order (a reduction over
    a 3-wide axis may pair the terms differently on each device)."""
    return (t[..., 0] + t[..., 1]) + t[..., 2]


def moment_features(colors, weights=None, shift=None):
    """Per-pixel moment features ``(N, 11)``; ``weights`` None means 1."""
    x = colors
    if shift is not None:
        x = x - shift
    n = x.shape[0]
    one = (torch.ones((n,), dtype=x.dtype, device=x.device)
           if weights is None else weights)
    w = one[:, None]
    wx = w * x
    w2 = sum3(wx * x)[:, None]
    xx = wx[:, 0:1] * x[:, 0:3]
    yy = wx[:, 1:2] * x[:, 1:3]
    zz = wx[:, 2:3] * x[:, 2:3]
    return torch.cat([one[:, None], wx, w2, xx, yy, zz], dim=-1)


def total_moments(colors, weights=None, shift=None, mesh=None):
    """Single global moment tuple ``(11,)``."""
    return PM.psum(mesh, torch.sum(moment_features(colors, weights, shift),
                                   dim=0))


def segment_matmul(feats, segment_ids, num_segments, mesh=None):
    """``(N, F)`` features summed into ``(num_segments, F)`` by id (K1).

    Ids outside ``[0, num_segments)`` contribute nothing, as a one-hot row
    of zeros would."""
    return PM.psum(mesh, segment_sum(feats, segment_ids, num_segments))


def segment_moments(colors, segment_ids, num_segments, weights=None,
                    shift=None, mesh=None):
    """Per-segment moment tuple ``(num_segments, 11)``."""
    feats = moment_features(colors, weights, shift)
    return segment_matmul(feats, segment_ids, num_segments, mesh=mesh)


# --------------------------------------------------------------------------
# Moment tuple queries
# --------------------------------------------------------------------------

def moments_center(m, delta=1e-30):
    """Weighted center from a moment tuple (..., 11) -> (..., 3)."""
    w0 = m[..., IDX_W0:IDX_W0 + 1]
    safe = w0 > delta
    return torch.where(safe, m[..., IDX_W1] / torch.where(safe, w0, 1.0),
                       0.0)


def moments_distortion(m, delta=1e-30):
    """Weighted SSE around the weighted mean: ``w2 - |w1|^2 / w0``."""
    w0 = m[..., IDX_W0]
    safe = w0 > delta
    w1 = m[..., IDX_W1]
    d = m[..., IDX_W2] - sum3(w1 * w1) / torch.where(safe, w0, 1.0)
    return torch.where(safe, torch.clamp_min(d, 0.0), 0.0)


def moments_cov(m, delta=1e-30):
    """Weighted covariance ``wrs/w0 - mu mu^T`` -> (..., 3, 3); zeros for
    empty segments."""
    w0 = m[..., IDX_W0]
    safe = w0 > delta
    w0s = torch.where(safe, w0, 1.0)
    mu = m[..., IDX_W1] / w0s[..., None]
    wrs = m[..., IDX_WRS] / w0s[..., None]
    xx, xy, xz, yy, yz, zz = (wrs[..., i] for i in range(6))
    second = torch.stack(
        [
            torch.stack([xx, xy, xz], dim=-1),
            torch.stack([xy, yy, yz], dim=-1),
            torch.stack([xz, yz, zz], dim=-1),
        ],
        dim=-2,
    )
    cov = second - mu[..., :, None] * mu[..., None, :]
    return torch.where(safe[..., None, None], cov, 0.0)


# --------------------------------------------------------------------------
# Axis projection + bucket sort
# --------------------------------------------------------------------------

def project(colors, axis):
    """``(N,3) . (3,) -> (N,)`` as three products summed in order."""
    return sum3(colors * axis)


def linear_bin(ratio, n_buckets):
    """``clip(int(ratio * n), 0, n - 1)`` with truncation toward zero (the
    float is clamped first so the integer conversion is always defined;
    NaN lands in bucket 0)."""
    v = torch.nan_to_num(ratio * n_buckets, nan=0.0)
    return torch.clamp(v, 0.0, n_buckets - 1).to(torch.int32)


def bucket_scale(span, delta=0.0):
    """``1 / span`` where ``span > delta`` (``>= delta`` for delta > 0),
    else 0: the binning scale shared by both bucketizers and the LQ
    kernel."""
    ok = span > 0.0 if delta == 0.0 else ~(span < delta)
    return torch.where(ok, 1.0 / torch.where(ok, span, 1.0), 0.0)


def bucketize_linear(proj, n_buckets, pmin, pmax):
    """Pure linear binning, no degenerate fallback (LQ: a flat cluster bins
    into bucket 0 and has zero split benefit)."""
    scale = bucket_scale(pmax - pmin)
    return linear_bin((proj - pmin) * scale, n_buckets)


def bucketize(proj, n_buckets, pmin, pmax, delta=1e-12, mask=None,
              mesh=None):
    """Linear binning into ``n_buckets`` (reference sort.c:58-92).

    Degenerate case (flat projection range): the reference round-robins
    buckets ``i % n_buckets`` over the input order (sort.c:61-79). With
    ``mask``, round-robin positions count only masked entries. With
    ``mesh``, ``pmin``/``pmax`` are the global ones and the positions are
    global: offset by the (masked) counts of the lower ranks.
    Returns int32 bucket ids.
    """
    span = pmax - pmin
    degenerate = span < delta
    b = linear_bin((proj - pmin) * bucket_scale(span, delta), n_buckets)
    if mask is None:
        pos = torch.arange(proj.shape[0], device=proj.device)
        local = proj.shape[0]
    else:
        pos = torch.cumsum(mask.to(torch.int64), 0) - 1
        local = int(mask.sum()) if mesh is not None else 0
    pos = pos + PM.rank_offset(mesh, local)
    rr = torch.remainder(pos, n_buckets).to(torch.int32)
    return torch.where(degenerate, rr, b)

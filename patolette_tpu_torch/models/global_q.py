"""Global principal quantization (GQ).

Port of ``patolette_tpu/models/global_q.py``: Wu's dynamic-programming
optimal 1-D partition of the colors projected on their global principal
axis (reference global.c). The per-bucket moments come from the device
(K1). Two implementations, as in the JAX package:

* :func:`gq_host`: numpy f64 on the (513, 11) prefix moments, as the JAX
  package's staged route runs it (the sampled, streamed, resident and
  sharded routes).
* :func:`gq_device`: the DP on the device (K11, ``kernels/gq.py``) and the
  termination test in torch glue, with no host read; the one-shot route
  and ``palette_pipeline_device`` run it, as the JAX package's one-shot
  program runs its ``gq_device``.

Semantics kept (see the JAX module for the reference citations): 512
buckets, at most 12 cells, bias thresholds 0.9 / 0.1; unweighted moments
and global PCA (quirk Q1); per-iteration termination by distortion-weighted
cell bias; the exact Bellman cost ``E[t] + D(t, n)`` (divergence Q7); the
LARGEST minimizing t wins a tie.
"""

from __future__ import annotations

import numpy as np
import torch

from patolette_tpu_torch.kernels.gq import cell_distortion, gq_dp
from patolette_tpu_torch.ops import eigen3
from patolette_tpu_torch.ops import moments as M

BUCKET_COUNT = 512
MAX_K = 12
BIAS_THRESHOLD = 0.1
CELL_BIAS_THRESHOLD = 0.9
DELTA = 1e-16


def _pairwise_cell_distortion(prefix):
    """D[t, n] = SSE of the cell covering buckets (t, n], from the (B+1, 11)
    prefix-summed moments (reference cells.c:141-182)."""
    w0 = prefix[:, M.IDX_W0]
    w1 = prefix[:, M.IDX_W1]
    w2 = prefix[:, M.IDX_W2]
    dw0 = w0[None, :] - w0[:, None]
    dw1 = w1[None, :, :] - w1[:, None, :]
    dw2 = w2[None, :] - w2[:, None]
    nonempty = dw0 > 0
    d = dw2 - np.sum(dw1 * dw1, axis=-1) / np.where(nonempty, dw0, 1.0)
    return np.where(nonempty, np.maximum(d, 0.0), 0.0)


def _np_moments_cov(mom):
    """Covariance from an (11,) moment tuple, f64."""
    w0 = mom[0]
    mu = mom[1:4] / w0
    xx, xy, xz, yy, yz, zz = mom[5:11] / w0
    second = np.array([[xx, xy, xz], [xy, yy, yz], [xz, yz, zz]])
    return second - np.outer(mu, mu)


def _cell_bias_host(prefix, a, b, global_axis):
    """|cos angle(cell principal axis, global axis)|, clamped to <= 1
    (reference cells.c:280-328)."""
    mom = prefix[b] - prefix[a]
    if mom[M.IDX_W0] <= 0:
        cell_axis = np.array([0.0, 0.0, 1.0])
    else:
        _, vecs = np.linalg.eigh(_np_moments_cov(mom))
        cell_axis = vecs[:, 2]
    norms = np.linalg.norm(cell_axis) * np.linalg.norm(global_axis)
    if norms < DELTA:
        return 0.0
    cosv = float(np.dot(cell_axis, global_axis)) / norms
    return min(1.0, abs(cosv))


def _should_terminate_host(quantizer, dmat, prefix, global_axis):
    """Mirror of should_terminate (reference global.c:99-187)."""
    cells = list(zip(quantizer[:-1], quantizer[1:]))
    distortion = sum(float(dmat[a, b]) for a, b in cells)
    if distortion < DELTA:
        return True
    bias = 0.0
    for a, b in cells:
        cell_bias = _cell_bias_host(prefix, a, b, global_axis)
        if cell_bias < CELL_BIAS_THRESHOLD:
            continue
        bias += (float(dmat[a, b]) / distortion) * cell_bias
    return bias < BIAS_THRESHOLD


def _backtrack(cuts_rows, k, n_total):
    """l_chain (reference global.c:72-97): build [0=q0, ..., qk=N]."""
    chain = np.zeros(k + 1, dtype=np.int64)
    t = n_total
    for j in range(k - 1, 0, -1):
        t = int(cuts_rows[j + 1][t])
        chain[j] = t
    chain[k] = n_total
    return chain


def gq_host(bucket_moments, palette_size):
    """GQ on per-bucket (unweighted, not prefix-summed) moment tuples
    ``(BUCKET_COUNT, 11)``. Returns cuts int64 ``[0, q1, ..., qK = 512]``,
    K <= 12."""
    bm = np.asarray(bucket_moments, dtype=np.float64)
    b = bm.shape[0]
    prefix = np.zeros((b + 1, M.NUM_MOMENTS))
    np.cumsum(bm, axis=0, out=prefix[1:])

    _, vecs = np.linalg.eigh(_np_moments_cov(prefix[b]))
    global_axis = vecs[:, 2]

    dmat = _pairwise_cell_distortion(prefix)

    k_max = min(MAX_K, palette_size)
    e_prev = dmat[0, :].copy()
    cuts_rows = {1: None}
    result = np.array([0, b], dtype=np.int64)

    t_idx = np.arange(b + 1)
    for k in range(2, k_max + 1):
        if _should_terminate_host(result, dmat, prefix, global_axis):
            break
        # E_k[n] = min_{k-1 <= t <= n-1} E_{k-1}[t] + D(t, n); the largest
        # minimizing t wins (the reference scans t downward with strict <).
        cost = e_prev[:, None] + dmat
        valid = ((t_idx[:, None] >= k - 1)
                 & (t_idx[:, None] <= t_idx[None, :] - 1))
        cost = np.where(valid, cost, np.inf)
        cut = b - np.argmin(cost[::-1, :], axis=0)
        e_prev = np.min(cost, axis=0)
        cuts_rows[k] = cut
        result = _backtrack(cuts_rows, k, b)

    return result


def _norm3(v):
    return torch.sqrt(M.sum3(v * v))


def _cell_bias_device(prefix, a, b, global_axis):
    """|cos angle(cell principal axis, global axis)| clamped to <= 1 for
    the cells ``(a, b]`` (any shape of index tensors), 0 for an empty cell
    (JAX ``global_q.py:190-202``)."""
    mom = prefix[b] - prefix[a]
    cell_axis, _ = eigen3.principal_axis(M.moments_cov(mom))
    norms = _norm3(cell_axis) * _norm3(global_axis)
    cosv = M.sum3(cell_axis * global_axis) / torch.clamp_min(norms, DELTA)
    bias = torch.where(norms < DELTA, 0.0,
                       torch.clamp_max(torch.abs(cosv), 1.0))
    return torch.where(mom[..., M.IDX_W0] <= 0, 0.0, bias)


def gq_device(bucket_moments, palette_size: int):
    """GQ with no host read (JAX ``global_q.py:205-293``): the DP of every
    level up to ``min(12, palette_size)`` (K11), then each level's
    termination test on the device, batched over the levels; the first
    level that stops the refinement is the result. Returns ``(cuts, k)``:
    cuts int32 (13,) padded with ``BUCKET_COUNT`` beyond position k, k a
    0-d int32 tensor."""
    bm = bucket_moments
    b = bm.shape[0]
    dev = bm.device
    k_max = min(MAX_K, int(palette_size))
    prefix, _, _, chains = gq_dp(bm.contiguous(), k_max)
    global_axis, _ = eigen3.principal_axis(M.moments_cov(prefix[b]))

    # Termination flags for levels 1..k_max, on each level's quantizer
    # before it is refined (global.c:244-254).
    starts = chains[:, :-1].long()
    ends = chains[:, 1:].long()
    lv = torch.arange(1, k_max + 1, device=dev)
    live = torch.arange(MAX_K, device=dev)[None, :] < lv[:, None]
    cell_d = torch.where(
        live, cell_distortion(prefix[starts], prefix[ends]), 0.0)
    distortion = cell_d.sum(dim=1)
    biases = _cell_bias_device(prefix, starts, ends, global_axis)
    contrib = torch.where(
        live & (biases >= CELL_BIAS_THRESHOLD),
        (cell_d / torch.clamp_min(distortion, DELTA)[:, None]) * biases,
        0.0,
    )
    term = (distortion < DELTA) | (contrib.sum(dim=1) < BIAS_THRESHOLD)
    k = torch.where(term & (lv < k_max), lv, k_max).min()
    cuts = chains.index_select(0, (k - 1).reshape(1))[0]
    return cuts, k.to(torch.int32)


def labels_from_cuts(buckets, cuts):
    """Bucket ids -> GQ cell labels: bucket b is in cell j iff
    q_j < b + 1 <= q_{j+1} (reference global.c:324-340). ``cuts`` is
    ``[0, q1, ..., qK]`` (a tensor or array), optionally padded with
    ``BUCKET_COUNT`` as :func:`gq_device` pads it."""
    interior = torch.as_tensor(cuts, dtype=torch.int64,
                               device=buckets.device)[1:].contiguous()
    return torch.searchsorted(
        interior, buckets.to(torch.int64) + 1, side="left"
    ).to(torch.int32)

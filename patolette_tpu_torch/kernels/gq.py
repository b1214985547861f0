"""K11: the GQ dynamic program and its backtrack.

Kernel: ``csrc/gq_dp.cu``, one launch of one thread block cluster: every
block sums the prefix moments of the ``(b, 11)`` bucket moments, computes
D(t, n) once for its own columns n (n = rank mod C) into shared memory,
then the levels ``E_k[n] = min_{k-1 <= t <= n-1} E_{k-1}[t] + D(t, n)``
for k = 2 .. ``k_max``, a warp a column, each level's values and cuts
sent to the other blocks' shared memory and counted on their barriers;
block 0 backtracks every level's chain. Twin: the JAX package's
``gq_device`` DP (``models/global_q.py:205-264``), written out here as
:func:`gq_dp_plain` in the kernel's order of operations, so the two agree
bit for bit on the card (the kernel's minimum follows one total order on
(NaN, cost, t), so its reduction order does not matter).

Returns ``(prefix (b+1, 11), cost (k_max, b+1), cut (k_max+1, b+1) int32,
chains (k_max, 13) int32)``: ``cost[k-1]`` is ``E_k``; ``cut[k]`` is level
k's cut row (rows 0 and 1 zero, as the JAX package pads them);
``chains[k-1]`` is level k's quantizer ``[0, q1, .., q_{k-1}, b]`` padded
with ``b``.
"""

from __future__ import annotations

import numpy as np
import torch

from patolette_tpu_torch import kernels
from patolette_tpu_torch.kernels import build

MAX_K = 12
NUM_MOMENTS = 11


def cell_distortion(pa, pb):
    """SSE of the cells ``(a, b]`` from their prefix rows ``pa``, ``pb``
    (``(..., 11)``): the JAX package's ``_pairwise_cell_distortion``
    (``global_q.py:55-69``) with the kernel's order of operations; 0 for an
    empty cell, negative values clamped to 0, NaN kept."""
    dw0 = pb[..., 0] - pa[..., 0]
    dw1 = pb[..., 1:4] - pa[..., 1:4]
    dw2 = pb[..., 4] - pa[..., 4]
    nonempty = dw0 > 0
    sq = dw1 * dw1
    s = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    d = dw2 - s / torch.where(nonempty, dw0, torch.ones_like(dw0))
    d = torch.where((d > 0) | torch.isnan(d), d, torch.zeros_like(d))
    return torch.where(nonempty, d, torch.zeros_like(d))


def chains_from_cuts(cut, k_max, b):
    """``(k_max, 13)`` int32 quantizers of every level from the cut rows
    (the JAX package's ``chain_scan``)."""
    dev = cut.device
    chains = torch.full((k_max, MAX_K + 1), b, dtype=torch.int32,
                        device=dev)
    chains[:, 0] = 0
    levels = torch.arange(1, k_max + 1, device=dev)
    t = torch.full((k_max,), b, dtype=torch.int64, device=dev)
    for j in range(MAX_K - 1, 0, -1):
        if j + 1 > k_max:
            continue
        active = j <= levels - 1
        t = torch.where(active, cut[j + 1].long()[t], t)
        chains[:, j] = torch.where(active, t.to(torch.int32), chains[:, j])
    return chains


def gq_dp_plain(bucket_moments, k_max: int):
    """The DP in plain PyTorch, in the input's dtype (f32 or f64): the
    prefix summed row by row, the full D matrix, each level's minimum
    (NaN first, as ``jnp.min``) and its largest minimising t."""
    bm = bucket_moments
    b = bm.shape[0]
    dev, dt = bm.device, bm.dtype
    prefix = torch.zeros((b + 1, NUM_MOMENTS), dtype=dt, device=dev)
    acc = prefix[0]
    for i in range(b):
        acc = acc + bm[i]
        prefix[i + 1] = acc

    dmat = cell_distortion(prefix[:, None, :], prefix[None, :, :])  # [t, n]
    t_idx = torch.arange(b + 1, device=dev)
    e = dmat[0].clone()
    cost = torch.empty((k_max, b + 1), dtype=dt, device=dev)
    cost[0] = e
    cut = torch.zeros((k_max + 1, b + 1), dtype=torch.int32, device=dev)
    for k in range(2, k_max + 1):
        valid = ((t_idx[:, None] >= k - 1)
                 & (t_idx[:, None] <= t_idx[None, :] - 1))
        c = torch.where(valid, e[:, None] + dmat, float("inf"))
        m = torch.amin(c, dim=0)
        hit = (c == m) | (torch.isnan(c) & torch.isnan(m))
        cut[k] = torch.where(hit, t_idx[:, None], -1).amax(0).to(torch.int32)
        e = m
        cost[k - 1] = e
    return prefix, cost, cut, chains_from_cuts(cut, k_max, b)


def random_moments(b: int, seed: int):
    """(b, 11) f32 bucket moments of 1000-5000 random anisotropic points
    in random buckets (numpy, from ``seed``)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1000, 5000))
    x = rng.normal(size=(n, 3)) * rng.uniform(0.1, 2, 3)
    x -= x.mean(0)
    f = np.concatenate([np.ones((n, 1)), x, (x * x).sum(1)[:, None],
                        x[:, 0:1] * x[:, 0:3], x[:, 1:2] * x[:, 1:3],
                        x[:, 2:3] * x[:, 2:3]], 1)
    bm = np.zeros((b, NUM_MOMENTS))
    np.add.at(bm, rng.integers(0, b, n), f)
    return bm.astype(np.float32)


def adversarial_moments(b: int, seed: int = 0):
    """K11's hard cases, for the tests and ``chip_smoke.py``: name -> (b,
    11) f32 bucket moments. Random moments; the mass in 5 buckets (most
    cells empty, so exact ties of E across the blocks' columns); that
    with a NaN w2 in one of them; +inf in x then -inf further on (NaN at
    several t of the columns between); NaN w0 (empty cells) in two
    buckets; +inf and -inf in w2 and x of several buckets; all empty; all
    the mass in one bucket."""
    rng = np.random.default_rng(seed)
    base = random_moments(b, seed)
    out = {"random": base}
    sparse = np.zeros_like(base)
    at = np.sort(rng.choice(b, min(5, b), replace=False))
    sparse[at] = random_moments(len(at), seed + 1)
    sparse[at, 0] = np.maximum(sparse[at, 0], 1)
    out["sparse5"] = sparse
    bm = sparse.copy()
    bm[at[len(at) // 2], 4] = np.nan
    out["sparse5_nan"] = bm
    bm = base.copy()
    bm[b // 4, 1] = np.inf
    bm[b // 2, 1] = -np.inf if b // 2 != b // 4 else np.nan
    out["nan_window"] = bm
    bm = base.copy()
    bm[[b // 3, (2 * b) // 3], 0] = np.nan
    out["nan_w0"] = bm
    bm = base.copy()
    bm[b // 5, 4] = np.inf
    bm[(3 * b) // 5, 1] = np.inf
    bm[(4 * b) // 5, 4] = -np.inf
    bm[b - 1, 2] = -np.inf
    out["inf"] = bm
    out["empty"] = np.zeros_like(base)
    bm = np.zeros_like(base)
    bm[b // 2] = base.astype(np.float64).sum(0)
    out["one_bucket"] = bm
    return out


def gq_dp(bucket_moments, k_max: int):
    """The DP of ``(b, 11)`` bucket moments up to ``k_max`` cells; the
    kernel on the card (f32), the twin on the CPU."""
    bm = bucket_moments
    if not 1 <= k_max <= MAX_K:
        raise ValueError(f"gq_dp: k_max {k_max} outside [1, {MAX_K}]")
    if bm.device.type == "cpu":
        return gq_dp_plain(bm, k_max)
    out = _launch(bm, k_max, 0)
    kernels.LAUNCHES["gq_dp"] += 1
    return out


# Cluster sizes the kernel is built for (csrc/gq_dp.cu picks its own).
CLUSTERS = (4, 8, 16)


def gq_dp_cluster(bucket_moments, k_max: int, cluster: int):
    """One launch on the card with a cluster of ``cluster`` blocks (one of
    :data:`CLUSTERS`): a measurement for chip_smoke.py's sweep, on no path
    and not counted in ``LAUNCHES``."""
    if cluster not in CLUSTERS:
        raise ValueError(f"gq_dp_cluster: cluster {cluster}")
    return _launch(bucket_moments, k_max, cluster)


def _launch(bm, k_max, cluster):
    b = bm.shape[0]
    if bm.dtype != torch.float32:
        raise TypeError("gq_dp: f32 bucket moments")
    if bm.shape != (b, NUM_MOMENTS) or not 1 <= b <= 1023:
        raise ValueError(f"gq_dp: bad shape {tuple(bm.shape)}")
    build.require_cuda("gq_dp", bm)
    dev = bm.device
    prefix = torch.empty((b + 1, NUM_MOMENTS), dtype=torch.float32,
                         device=dev)
    cost = torch.empty((k_max, b + 1), dtype=torch.float32, device=dev)
    cut = torch.empty((k_max + 1, b + 1), dtype=torch.int32, device=dev)
    chains = torch.empty((k_max, MAX_K + 1), dtype=torch.int32, device=dev)
    err = build.library().pt_gq_dp(
        build.ptr(bm), b, k_max, int(cluster), build.ptr(prefix),
        build.ptr(cost), build.ptr(cut), build.ptr(chains), build.stream(),
    )
    build.check(err, "gq_dp")
    return prefix, cost, cut, chains

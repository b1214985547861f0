"""K4: one weighted Lloyd step.

Kernel: ``csrc/kmeans.cu``, two entry points of one launch each: the
moments (``pt_kmeans_moments``: assignment, warp-grouped ``[w, w x]``
sums, the blocks' partials summed in the same launch into ``(P, 4)``) and
the update (``pt_kmeans_update``: one block updates the centres from those
sums and runs the empty-cluster split). ``reduce`` runs between them: the
multi-device route sums the ranks' moments there, as the JAX package
``psum``s its one-hot sums before the update (``kmeans.py:107-113``). Any
number of centres: the kernel tiles them through shared memory and keeps
tables that do not fit there in device scratch. The partials, the ticket
counters and the masses scratch are reused from call to call
(``build.scratch``). Twin: the JAX package's loop body
(``kmeans.py:104-117``) with ``_split_empty`` (``kmeans.py:59-86``).
"""

from __future__ import annotations

import numpy as np
import torch

from patolette_tpu_torch import kernels
from patolette_tpu_torch.kernels import build
from patolette_tpu_torch.kernels.assign import assign_planar_plain
from patolette_tpu_torch.kernels.segment import segment_sum_plain

SPLIT_EPS = 1.0 / 1024.0  # Clustering.cpp EPS
BATCH = 1024         # samples of a block's pass (csrc/kmeans.cu kBatch)
BLOCKS_PER_SM = 2
GROUP = 16           # blocks whose partials are summed first (PT_GROUP)
MAX_BLOCKS = 1024    # PT_GROUP * PT_MAX_GROUPS


def split_empty(centers, hassign, valid):
    """Empty-cluster handling (Clustering.cpp:216-262), deterministic donor:
    walks the slots in order; a valid empty slot takes half the mass of the
    valid cluster of largest mass (first on ties), both moved by +-eps with
    the even/odd-coordinate sign pattern. Runs on the host in f32 numpy;
    returns the centres unchanged (no copy) when no slot is empty."""
    if not bool((valid & (hassign == 0.0)).any()):
        return centers
    c = centers.detach().cpu().numpy().astype(np.float32, copy=True)
    h = hassign.detach().cpu().numpy().astype(np.float32, copy=True)
    v = valid.detach().cpu().numpy()
    parity = np.array([1.0, -1.0, 1.0], np.float32)
    up = np.float32(1.0) + np.float32(SPLIT_EPS) * parity
    dn = np.float32(1.0) - np.float32(SPLIT_EPS) * parity
    for ci in range(c.shape[0]):
        if v[ci] and h[ci] == 0.0:
            cj = int(np.argmax(np.where(v, h, np.float32(-np.inf))))
            src = c[cj].copy()
            c[ci] = src * up
            c[cj] = src * dn
            half = h[cj] / np.float32(2.0)
            h[ci] = half
            h[cj] = h[cj] + (-half)
    return torch.from_numpy(c).to(centers.device)


def kmeans_step_plain(samples, weights, centers, valid, reduce=None):
    p = centers.shape[0]
    labels = assign_planar_plain(
        (samples[:, 0], samples[:, 1], samples[:, 2]), centers, valid
    )
    m = samples.shape[0]
    w = (torch.ones((m,), dtype=torch.float32, device=samples.device)
         if weights is None else weights)
    mom = segment_sum_plain(
        torch.cat([w[:, None], w[:, None] * samples], dim=-1), labels, p
    )
    if reduce is not None:
        mom = reduce(mom)
    hassign = mom[:, 0]
    nonzero = hassign > 0.0
    new = mom[:, 1:4] / torch.where(nonzero, hassign, 1.0)[:, None]
    centers = torch.where((nonzero & valid)[:, None], new, centers)
    centers = split_empty(centers, torch.where(valid, hassign, 1.0), valid)
    return centers, labels


def kmeans_step(samples, weights, centers, valid, return_labels=False,
                reduce=None):
    """One Lloyd step; returns the new centres (and the labels it assigned
    when ``return_labels``). ``reduce``: maps this device's ``(P, 4)``
    ``[w, w x]`` sums to the sums the update uses (None: itself)."""
    if samples.device.type == "cpu":
        new, labels = kmeans_step_plain(samples, weights, centers, valid,
                                        reduce)
        return (new, labels) if return_labels else new
    m = samples.shape[0]
    p = centers.shape[0]
    if samples.dtype != torch.float32 or centers.dtype != torch.float32 or (
            weights is not None and weights.dtype != torch.float32):
        raise TypeError("kmeans_step: f32 samples, weights and centers")
    if (samples.shape != (m, 3) or centers.shape != (p, 3)
            or valid.shape != (p,)
            or (weights is not None and weights.shape != (m,))):
        raise ValueError("kmeans_step: bad shapes")
    if p < 1:
        raise ValueError("kmeans_step: no centres")
    valid_b = valid.to(torch.bool).contiguous()  # read as bytes, 0 or 1
    build.require_cuda("kmeans_step", samples, weights, centers, valid_b)
    dev = samples.device
    nblocks = max(1, min(MAX_BLOCKS, BLOCKS_PER_SM * build.sm_count(dev),
                         -(-m // BATCH)))
    per_block = max(1, -(-m // nblocks))
    partials = build.scratch("partials", nblocks * p * 4, torch.float32,
                             dev)
    counters = build.scratch("kmeans_step.tickets", nblocks // GROUP + 2,
                             torch.int32, dev, zero=True)
    masses = build.scratch("kmeans_step.masses", p, torch.float32, dev)
    mom = torch.empty((p, 4), dtype=torch.float32, device=dev)
    out = torch.empty((p, 3), dtype=torch.float32, device=dev)
    labels = (torch.empty((m,), dtype=torch.int32, device=dev)
              if return_labels else None)
    lib = build.library()
    stream = build.stream()
    err = lib.pt_kmeans_moments(
        build.ptr(samples), build.ptr(weights), build.ptr(centers),
        build.ptr(valid_b), m, p, per_block, nblocks, build.ptr(partials),
        build.ptr(counters), build.ptr(labels), build.ptr(mom), stream,
    )
    build.check(err, "kmeans_step (moments)")
    if reduce is not None:
        mom = reduce(mom).contiguous()
        if mom.shape != (p, 4) or mom.dtype != torch.float32 \
                or mom.device != dev:
            raise ValueError("kmeans_step: reduce must keep (P, 4) f32")
        if mom.data_ptr() % 16:  # the update reads rows as float4
            mom = mom.clone()
    err = lib.pt_kmeans_update(
        build.ptr(mom), build.ptr(centers), build.ptr(valid_b), p,
        build.ptr(out), build.ptr(masses), stream,
    )
    build.check(err, "kmeans_step (update)")
    kernels.LAUNCHES["kmeans_step"] += 1
    return (out, labels) if return_labels else out

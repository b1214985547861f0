"""K1: segment sum, ``(N, F)`` features into ``(S, F)`` by int32 id.

Kernel: ``csrc/segment_sum.cu``. Twin: the JAX package's chunked one-hot
product with an f32 accumulator (``moments.py:108-168``).
"""

from __future__ import annotations

import torch

from patolette_tpu_torch import kernels
from patolette_tpu_torch.kernels import build

_CHUNK = 32768
MAX_FEATURES = 32
PIXELS_PER_BLOCK = 1024
MAX_BLOCKS = 1024


def segment_sum_plain(feats, ids, num_segments):
    """Chunked ``onehot(ids).T @ feats``; ids outside ``[0, S)`` add
    nothing."""
    n, f = feats.shape
    acc = torch.zeros((num_segments, f), dtype=torch.float32,
                      device=feats.device)
    seg = torch.arange(num_segments, dtype=ids.dtype, device=ids.device)
    for s in range(0, n, _CHUNK):
        onehot = (ids[s:s + _CHUNK, None] == seg[None, :]).to(torch.float32)
        acc += onehot.T @ feats[s:s + _CHUNK].to(torch.float32)
    return acc


def segment_sum(feats, ids, num_segments):
    """Per-segment sums (S, F) f32; the kernel on the card, the twin on the
    CPU."""
    if feats.device.type == "cpu":
        return segment_sum_plain(feats, ids, num_segments)
    n, f = feats.shape
    if feats.dtype != torch.float32 or ids.dtype != torch.int32:
        raise TypeError("segment_sum: feats f32 and ids int32 expected")
    if ids.shape != (n,) or not 0 < f <= MAX_FEATURES or num_segments < 1:
        raise ValueError(
            f"segment_sum: bad shapes feats {tuple(feats.shape)}, "
            f"ids {tuple(ids.shape)}, S {num_segments}"
        )
    build.require_cuda("segment_sum", feats, ids)
    out = torch.empty((num_segments, f), dtype=torch.float32,
                      device=feats.device)
    if n == 0:
        return out.zero_()
    nblocks = min(MAX_BLOCKS, -(-n // PIXELS_PER_BLOCK))
    per_block = -(-n // nblocks)
    partials = torch.empty((nblocks, num_segments, f), dtype=torch.float32,
                           device=feats.device)
    err = build.library().pt_segment_sum(
        build.ptr(feats), build.ptr(ids), n, f, num_segments, per_block,
        nblocks, build.ptr(partials), build.ptr(out), build.stream(),
    )
    build.check(err, "segment_sum")
    kernels.LAUNCHES["segment_sum"] += 1
    return out

"""K1: segment sum, ``(N, F)`` features into ``(S, F)`` by int32 id.

Kernel: ``csrc/segment_sum.cu``: warp-grouped accumulation over a grid of
one or two blocks an SM, the blocks' partials summed in the same launch
when ``S * F <= FUSE_MAX_LEN`` (one launch), else by a second one.
The partials and the ticket counters are reused from call to call
(``build.scratch``). Twin: the JAX package's chunked one-hot product with
an f32 accumulator (``moments.py:108-168``).
"""

from __future__ import annotations

import functools

import torch

from patolette_tpu_torch import kernels
from patolette_tpu_torch.kernels import build

_CHUNK = 32768
MAX_FEATURES = 32
WARPS = 8            # warps of a block (csrc/segment_sum.cu kWarps)
GROUP = 16           # blocks whose partials are summed first (PT_GROUP)
MAX_BLOCKS = 1024    # PT_GROUP * PT_MAX_GROUPS
FUSE_MAX_LEN = 2048  # largest S * F whose partials are summed in-launch


@functools.lru_cache(maxsize=256)
def _grid(n, s, f, device):
    """Blocks and pixels a warp: two blocks an SM where two blocks' shared
    memory fits one (the layout of csrc/segment_sum.cu: eight (S, F)
    tables, staged rows and group lists), else one; at most one block a
    256 pixels."""
    smem = WARPS * 4 * (s * f + 32 * f + 96)
    per_sm = 2 if smem <= 112 * 1024 else 1
    nblocks = max(1, min(MAX_BLOCKS, per_sm * build.sm_count(device),
                         -(-n // (WARPS * 32))))
    return nblocks, 32 * -(-n // (nblocks * WARPS * 32))


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
    dev = feats.device
    out = torch.empty((num_segments, f), dtype=torch.float32, device=dev)
    if n == 0:
        return out.zero_()
    nblocks, per_warp = _grid(n, num_segments, f, dev)
    partials = build.scratch("partials", nblocks * num_segments * f,
                             torch.float32, dev)
    counters = build.scratch("segment_sum.tickets", nblocks // GROUP + 2,
                             torch.int32, dev, zero=True)
    err = build.library().pt_segment_sum(
        build.ptr(feats), build.ptr(ids), n, f, num_segments, per_warp,
        nblocks, int(num_segments * f <= FUSE_MAX_LEN), build.ptr(partials),
        build.ptr(counters), build.ptr(out), build.stream(),
    )
    build.check(err, "segment_sum")
    kernels.LAUNCHES["segment_sum"] += 1
    return out

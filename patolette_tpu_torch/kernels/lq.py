"""K2: the per-pixel pass of the LQ candidate evaluation.

Kernel: ``csrc/lq_candidates.cu``: key-grouped accumulation (key = the
bucket within the candidate) into per-warp tables, a block a candidate,
the blocks' partials summed in the same launch (one launch a call). The
partials and ticket counters are reused from call to call
(``build.scratch``). Twin: the JAX package's passes 3-4 of
``local_q.py::_candidates_segmented`` (projection, ``bucketize_linear``,
bf16-rounded ``[w, w x', w |x'|^2]`` summed per (candidate, bucket)).

``tab`` is ``(C, 8)`` per candidate: mean (3), axis (3), pmin and the
binning scale ``1 / (pmax - pmin)`` (0 for a flat cluster). Returns the
``(C, nb, 5)`` table and every pixel's bucket (0 off the candidates).
"""

from __future__ import annotations

import functools

import torch

from patolette_tpu_torch import kernels
from patolette_tpu_torch.kernels import build
from patolette_tpu_torch.kernels.segment import segment_sum_plain
from patolette_tpu_torch.ops.moments import linear_bin

WARPS = 8             # warps of a block (csrc/lq_candidates.cu kWarps)
FEATURES = 5
GROUP = 16            # blocks whose partials are summed first (PT_GROUP)
MAX_BLOCKS = 1024     # PT_GROUP * PT_MAX_GROUPS
TWO_PER_SM = 110 * 1024  # shared memory under which two blocks share an SM


def _smem_bytes(nb):
    """A block's dynamic shared memory (csrc/lq_candidates.cu smem_bytes):
    eight (nb, 5) tables, the staged rows, the group lists."""
    return 4 * WARPS * (nb * FEATURES + 32 * FEATURES + 96)


@functools.lru_cache(maxsize=256)
def _grid(n, c, device):
    """(blocks a candidate, pixels a warp): two blocks an SM, the blocks of
    all candidates filling the SMs once."""
    nblocks = max(1, min(MAX_BLOCKS, 2 * build.sm_count(device) // c,
                         -(-n // (WARPS * 32))))
    return nblocks, 32 * -(-n // (nblocks * WARPS * 32))


def partial_bytes(device, n, c, nb):
    """Bytes of the partial tables one call writes (and reads back): every
    block of a candidate one (nb, 5) row."""
    return 4 * FEATURES * c * nb * _grid(n, c, device)[0]


def lq_candidates_plain(colors, wm, cand, tab, n_buckets):
    c = tab.shape[0]
    t = torch.cat([tab, torch.zeros((1, 8), dtype=tab.dtype,
                                    device=tab.device)])[cand.long()]
    x = colors - t[:, 0:3]
    xa = x * t[:, 3:6]
    proj = (xa[:, 0] + xa[:, 1]) + xa[:, 2]
    bucket = linear_bin((proj - t[:, 6]) * t[:, 7], n_buckets)
    wx = wm[:, None] * x
    wxx = wx * x
    feats = torch.cat(
        [wm[:, None], wx, ((wxx[:, 0] + wxx[:, 1]) + wxx[:, 2])[:, None]],
        dim=-1,
    ).to(torch.bfloat16).to(torch.float32)
    # per candidate, the (n_c, nb) one-hot product the JAX package runs
    # for all candidates at once (its candidates ride the feature columns)
    table = torch.zeros((c, n_buckets, 5), dtype=torch.float32,
                        device=colors.device)
    for j in range(c):
        sel = cand == j
        if bool(sel.any()):
            table[j] = segment_sum_plain(feats[sel], bucket[sel], n_buckets)
    return table, bucket


def lq_candidates(colors, wm, cand, tab, n_buckets):
    if colors.device.type == "cpu":
        return lq_candidates_plain(colors, wm, cand, tab, n_buckets)
    n = colors.shape[0]
    c = tab.shape[0]
    if (colors.dtype != torch.float32 or wm.dtype != torch.float32
            or tab.dtype != torch.float32 or cand.dtype != torch.int32):
        raise TypeError("lq_candidates: f32 colors/wm/tab, int32 cand")
    if (colors.shape != (n, 3) or wm.shape != (n,) or cand.shape != (n,)
            or tab.shape != (c, 8) or c < 1 or n_buckets < 1):
        raise ValueError("lq_candidates: bad shapes")
    if _smem_bytes(n_buckets) > TWO_PER_SM:
        raise ValueError(f"lq_candidates: {n_buckets} buckets do not fit "
                         "two blocks an SM")
    build.require_cuda("lq_candidates", colors, wm, cand, tab)
    dev = colors.device
    out = torch.empty((c, n_buckets, 5), dtype=torch.float32, device=dev)
    bucket = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return out.zero_(), bucket
    nblocks, per_warp = _grid(n, c, dev)
    partials = build.scratch("partials", c * nblocks * n_buckets * 5,
                             torch.float32, dev)
    counters = build.scratch("lq_candidates.tickets",
                             c * (nblocks // GROUP + 2), torch.int32, dev,
                             zero=True)
    err = build.library().pt_lq_candidates(
        build.ptr(colors), build.ptr(wm), build.ptr(cand), build.ptr(tab),
        n, c, n_buckets, per_warp, nblocks, build.ptr(partials),
        build.ptr(counters), build.ptr(out), build.ptr(bucket),
        build.stream(),
    )
    build.check(err, "lq_candidates")
    kernels.LAUNCHES["lq_candidates"] += 1
    return out, bucket

"""Local quantization (LQ): greedy weighted principal-axis splitting.

Port of ``patolette_tpu/models/local_q.py`` (reference local.c). Turns the
K <= 12 GQ clusters into up to ``palette_size`` clusters by repeatedly
splitting the clusters whose candidate split gives the largest weighted-SSE
benefit ``d - (dl + dr)``; each candidate projects its cluster on its own
weighted principal axis and takes the 512-bucket cut that maximizes
``sum_ch csl^2/sl + csr^2/sr``.

Kept from the JAX package: the cached side bit (a cluster's pixel set
cannot change between its candidate evaluation and its split, so applying
a split is a mask), the +-4 sigma projection range (S7), float bucket
masses (Q2), linear binning without the round-robin fallback, the DELTA
stop, the top-B batch (S6) with its cap and round count, and the left
child taking the new slot ``count + j``.

With ``mesh``, the pass-1 and pass-2 segment sums and K2's (C, 512, 5)
table are summed over the ranks (the JAX package's ``psum``s), so every
rank takes the same splits from the same reduced values.

The rounds are the JAX package's fixed trip count with the loop's state
on the device (the count, the stop flag, the benefits and child means):
a round after the palette is full or no split is left changes nothing,
its picks all going to the dead slot ``p``, so no round reads the host.
The loop's table writes are rank maps (compares), as in the JAX package:
on the card an index write waits for the device. The JAX package's
compare-and-select in place of gathers is a plain gather here.

On the card, without ``mesh`` and for float32 colours of at most
``GRAPH_MAX_ROWS`` rows, the loop (:func:`lq_loop`: the first candidate
pass and the rounds) runs as one CUDA graph from the second call with a key
on: the same kernels in the same order, submitted in one launch in place of
~12.7k (:func:`lq_quantize`). ``LQ_GRAPH`` counts the calls by the way they
ran; the replayed kernels' wrappers do not run, so ``kernels.LAUNCHES``
counts none of them.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import NamedTuple

import torch

from patolette_tpu_torch.kernels import build
from patolette_tpu_torch.kernels.lq import lq_candidates
from patolette_tpu_torch.ops import eigen3
from patolette_tpu_torch.ops import moments as M
from patolette_tpu_torch.parallel import mesh as PM
from patolette_tpu_torch.utils.spans import span

BUCKET_COUNT = 512
DELTA = 1e-16
_EPS = 1e-30
GRAPH_KEYS = 4   # the keys the graph cache holds, least recent out first
# A graph only up to the LQ sample's default cap (quantize's lq_max_samples):
# a larger N (a call with lq_max_samples=0 runs LQ on the whole image) runs
# eagerly, so what the graphs hold stays bounded whatever the image.
GRAPH_MAX_ROWS = 1 << 18
# The device bytes the graphs hold from call to call, at most: their shared
# inputs at GRAPH_MAX_ROWS rows (colours 12 B a row, weights 4, labels 1 up
# to 256 colours and 4 above) and k0 in one 512-byte block. The pipeline's
# footprint model adds it to every route (pipeline.LQ_GRAPH_BYTES).
GRAPH_HELD_BYTES = 21 * GRAPH_MAX_ROWS + 512

# calls of lq_quantize by how the loop ran: on the host's launches
# ("eager"), captured as a graph, replayed from one
LQ_GRAPH = {"eager": 0, "captured": 0, "replayed": 0}


def reset_lq_graph() -> None:
    for name in LQ_GRAPH:
        LQ_GRAPH[name] = 0


class Candidates(NamedTuple):
    benefit: torch.Tensor    # (C,) split benefit
    mu: torch.Tensor         # (C, 3) cluster mean
    axis: torch.Tensor       # (C, 3) principal axis
    pmin: torch.Tensor       # (C,)
    pmax: torch.Tensor       # (C,)
    split: torch.Tensor      # (C,) int32 optimal cut bucket
    mu_child: torch.Tensor   # (C, 2, 3) left/right child means
    side: torch.Tensor       # (N,) bool: member left of its cut
    member: torch.Tensor     # (N,) bool: pixel belongs to a candidate


def _rank_map(ids, size: int):
    """``out[c] = j`` where ``ids[j] == c`` (the first such j), else
    ``len(ids)``, for c in [0, size): the JAX package's ``_rank_map``
    (``local_q.py:75-85``), a (size, C) compare. An index write into a
    table waits for the device on the card; this does not."""
    c = ids.shape[0]
    eq = (torch.arange(size, dtype=ids.dtype, device=ids.device)[:, None]
          == ids[None, :])
    j = torch.argmax(eq.to(torch.int32), dim=1).to(torch.int32)
    return torch.where(eq.any(dim=1), j, c)


def _candidates_segmented(colors, w, labels, ids, p,
                          bucket_count=BUCKET_COUNT, mu_known=None,
                          mesh=None):
    """Candidate splits for a SET of pairwise-disjoint clusters ``ids``
    ((C,) int; entries equal to ``p`` are dead slots with no pixels).

    Passes 1-2 (means, central moments) are segment sums (K1) keyed by
    each pixel's candidate slot; passes 3-4 (projection, binning,
    per-(candidate, bucket) sums) are K2; the per-candidate tail runs on
    the small ``(C, 512, 5)`` table.
    """
    c = ids.shape[0]
    dev = colors.device
    # each cluster's candidate slot; the dead id p holds no pixels
    slot = torch.nn.functional.pad(_rank_map(ids, p), (0, 1), value=c)
    cand = slot[labels.long()]
    member = cand < c
    wm = torch.where(member, w, 0.0)

    if mu_known is None:
        # Pass 1: weighted means (cluster.c:171-189).
        m1 = M.segment_matmul(
            torch.cat([wm[:, None], wm[:, None] * colors], dim=-1), cand, c,
            mesh=mesh,
        )
        mu = m1[:, 1:4] / torch.clamp_min(m1[:, 0:1], _EPS)
    else:
        mu = mu_known

    # Pass 2: central moments -> distortion, covariance, principal axis.
    mu_ext = torch.cat([mu, torch.zeros((1, 3), dtype=mu.dtype, device=dev)])
    x = colors - mu_ext[cand.long()]
    mom = M.segment_moments(x, cand, c, weights=wm, mesh=mesh)
    w0 = mom[:, M.IDX_W0]
    d = M.moments_distortion(mom)
    axis, evals = eigen3.principal_axis(M.moments_cov(mom))

    # Passes 3-4 (K2): +-4 sigma range (S7), projection, binning, sums.
    sigma = torch.sqrt(torch.clamp_min(evals[:, 2], 0.0))
    pmax = 4.0 * sigma
    pmin = -pmax
    scale = M.bucket_scale(pmax - pmin)
    tab = torch.cat([mu, axis, pmin[:, None], scale[:, None]], dim=1)
    bstats, bucket = lq_candidates(colors, wm, cand, tab.contiguous(),
                                   bucket_count)
    bstats = PM.psum(mesh, bstats)

    cum = torch.cumsum(bstats, dim=1)
    sl = cum[..., 0]
    csl = cum[..., 1:4]
    cw2l = cum[..., 4]
    st = cum[:, -1, 0]
    cst = cum[:, -1, 1:4]
    w2t = cum[:, -1, 4]
    sr = st[:, None] - sl
    csr = cst[:, None, :] - csl

    sl_ok = sl > 0.0
    sr_ok = sr > 0.0
    obj = torch.where(
        sl_ok, M.sum3(csl * csl) / torch.where(sl_ok, sl, 1.0), 0.0
    ) + torch.where(
        sr_ok, M.sum3(csr * csr) / torch.where(sr_ok, sr, 1.0), 0.0
    )
    s = torch.argmax(obj, dim=1)  # first max (Vector_maxloc)

    ar = torch.arange(c, device=dev)
    sl_s, csl_s, cw2l_s = sl[ar, s], csl[ar, s], cw2l[ar, s]
    sl_ok_s = sl_s > 0.0
    sr_s = st - sl_s
    sr_ok_s = sr_s > 0.0

    dl = torch.where(
        sl_ok_s,
        torch.clamp_min(
            cw2l_s - M.sum3(csl_s * csl_s) / torch.clamp_min(sl_s, _EPS), 0.0
        ),
        0.0,
    )
    w2r = w2t - cw2l_s
    csr_s = cst - csl_s
    dr = torch.where(
        sr_ok_s,
        torch.clamp_min(
            w2r - M.sum3(csr_s * csr_s) / torch.clamp_min(sr_s, _EPS), 0.0
        ),
        0.0,
    )
    benefit = torch.clamp_min(d - (dl + dr), 0.0)
    benefit = torch.where(w0 <= 0.0, 0.0, benefit)

    mu_l = mu + csl_s / torch.clamp_min(sl_s, _EPS)[:, None]
    mu_r = mu + csr_s / torch.clamp_min(sr_s, _EPS)[:, None]
    mu_child = torch.stack([mu_l, mu_r], dim=1)

    s32 = s.to(torch.int32)
    s_ext = torch.cat([s32, torch.zeros((1,), dtype=torch.int32, device=dev)])
    side = member & (bucket <= s_ext[cand.long()])
    return Candidates(benefit, mu, axis, pmin, pmax, s32, mu_child, side,
                      member)


def top_b(values, b):
    """The ``b`` largest values and their indices, ties to the LOWEST index
    (as ``lax.top_k``); a stable sort, because ``torch.topk`` leaves the
    tie order unspecified on the card."""
    order = torch.sort(values, descending=True, stable=True).indices[:b]
    return values[order], order


def _batch_size(batch_splits, p: int) -> int:
    """Splits a round (at most one in 16 of the palette, fewer than p)."""
    return max(1, min(int(batch_splits), (p + 15) // 16, p - 1))


def lq_loop(colors, weights, init_labels, k0, palette_size: int,
            bucket_count=BUCKET_COUNT, batch_splits: int = 1, mesh=None):
    """:func:`lq_quantize`'s loop as the host launches it, every kernel
    one call: the mesh route, the CPU, the first call with a key, and
    the body a graph captures."""
    n = colors.shape[0]
    p = int(palette_size)
    dev = colors.device
    w = (torch.ones((n,), dtype=colors.dtype, device=dev)
         if weights is None else weights.to(colors.dtype))
    if isinstance(k0, torch.Tensor):
        k0 = k0.to(device=dev, dtype=torch.int32).reshape(())
    else:  # a fill, not a host-to-device copy
        k0 = torch.full((), int(k0), dtype=torch.int32, device=dev)
    max_k0 = min(12, p)

    with span("lq-loop"):
        ids0 = torch.arange(max_k0, dtype=torch.int32, device=dev)
        first = _candidates_segmented(colors, w, init_labels, ids0, p,
                                      bucket_count, mesh=mesh)
        benefit = torch.zeros((p,), dtype=colors.dtype, device=dev)
        mu_child = torch.zeros((p, 2, 3), dtype=colors.dtype, device=dev)
        benefit[:max_k0] = torch.where(ids0 < k0, first.benefit, 0.0)
        mu_child[:max_k0] = first.mu_child
        labels = init_labels.to(torch.int32)
        side = first.side
        count = k0
        done = torch.zeros((), dtype=torch.bool, device=dev)

        bsz = _batch_size(batch_splits, p)
        # Ramp-up headroom: from k0 = 1 it takes ~log2(bsz) doubling rounds
        # before bsz splits per round are possible. Extra rounds change
        # nothing once the palette is full or no benefit is left.
        rounds = -(-(p - 1) // bsz) + max(1, bsz).bit_length()
        j_idx = torch.arange(bsz, dtype=torch.int32, device=dev)
        for _ in range(rounds):
            vals, sel = top_b(benefit, bsz)
            sel = sel.to(torch.int32)
            # top-B is value-sorted, so the valid picks form a prefix.
            valid = (vals >= DELTA) & (j_idx < p - count)
            m = valid.sum(dtype=torch.int32)
            active = ~done & (count < p)
            done = done | (active & (m == 0))  # no benefit left: stop
            valid = valid & active
            # invalid picks go to the dead id p: they match no cluster
            sel_v = torch.where(valid, sel, p)

            # Relabel: each picked cluster's cached LEFT side moves to slot
            # count + j (parents are disjoint, so no conflicts).
            jpix = _rank_map(sel_v, p)[labels.long()]
            labels = torch.where((jpix < bsz) & side, count + jpix, labels)

            # Left child takes the NEW slot, right child keeps the old one
            # (local.c:372-379); all 2B children in one candidate pass, their
            # means from the parents' cumulative bucket sums.
            valid2 = torch.cat([valid, valid])
            ids2b = torch.where(valid2, torch.cat([count + j_idx, sel]), p)
            mu_known = torch.cat([mu_child[sel.long(), 0],
                                  mu_child[sel.long(), 1]])
            res = _candidates_segmented(colors, w, labels, ids2b, p,
                                        bucket_count, mu_known=mu_known,
                                        mesh=mesh)
            side = torch.where(res.member, res.side, side)
            # the new rows by gathers from the rank map (no index writes)
            rk = _rank_map(ids2b, p)
            has = rk < 2 * bsz
            rk = torch.clamp_max(rk, 2 * bsz - 1).long()
            benefit = torch.where(has, res.benefit[rk], benefit)
            mu_child = torch.where(has[:, None, None], res.mu_child[rk],
                                   mu_child)
            count = count + torch.where(active, m, 0)
    return labels, count


class _LoopGraph:
    """One key's :func:`lq_loop` captured as a CUDA graph. It reads and
    writes fixed addresses: ``colors``, ``w`` (None unweighted: the ones
    are made inside the graph), ``k0`` (0-d) and ``labels`` (the GQ labels
    in, the final labels out; bytes up to 256 colours), views of the
    inputs every key shares (:func:`_input`). A call loads them before its
    replay and copies the outputs after, under one lock; what the loop
    makes in between lives in the graph's own pool."""

    def __init__(self, colors, weighted: bool, p: int, bucket_count: int,
                 bsz: int):
        n, dev, rows = colors.shape[0], colors.device, GRAPH_MAX_ROWS
        self.colors = _input(dev, "colors", torch.float32,
                             3 * rows)[:3 * n].view(n, 3)
        self.w = (_input(dev, "weights", torch.float32, rows)[:n]
                  if weighted else None)
        self.labels = (_input(dev, "labels", torch.uint8, rows)[:n]
                       if p <= 256 else
                       _input(dev, "wide labels", torch.int32, rows)[:n])
        self.k0 = _input(dev, "k0", torch.int32, 1)[0]
        self.held = ()   # the kernels' reused buffers the graph writes
        self.args = (p, bucket_count, bsz)
        self.count = None
        self.graph = None

    def load(self, colors, weights, init_labels, k0) -> None:
        self.colors.copy_(colors)
        if self.w is not None:
            self.w.copy_(weights)
        self.labels.copy_(init_labels)
        if isinstance(k0, torch.Tensor):
            self.k0.copy_(k0.reshape(()))
        else:  # a fill, not a host-to-device copy
            self.k0.fill_(int(k0))

    def body(self):
        """The loop on the buffers; returns ``count``."""
        labels, count = lq_loop(self.colors, self.w, self.labels, self.k0,
                                *self.args)
        self.labels.copy_(labels)
        return count

    def capture(self) -> None:
        """Capture on a side stream. Not ``torch.cuda.graph``: it waits
        for the card and empties the allocator's cache first, and the
        planes a call allocates next then take fresh segments whose unsplit
        tails count as allocated."""
        dev = self.colors.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.stream(side):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.count = self.body()
            finally:
                self.graph.capture_end()
        # every kernel's reused buffer at the capture, those the graph
        # writes among them: a later, larger buffer under the same name
        # must not free an address the graph writes
        self.held = tuple(build._scratch.values())

    def outputs(self):
        """Copies of the labels (int32) and the count, which the next
        replay overwrites."""
        return self.labels.to(torch.int32, copy=True), self.count.clone()

    def replay(self) -> None:
        with torch.cuda.device(self.colors.device):
            self.graph.replay()


_graphs = collections.OrderedDict()   # key -> _LoopGraph, or None: seen once
_graphs_lock = threading.Lock()
_inputs = {}        # (device, name) -> an input buffer the graphs share
_input_pools = {}   # device -> the memory pool of the graphs' inputs


def _input(dev, name, dtype, numel):
    """The graphs' shared input ``name`` on ``dev``, made at the largest N
    a graph takes, so that no key's address ever moves. It lives from call
    to call in a memory pool of its own, so it takes no block of the pool a
    call's tensors are cut from (where an unsplit block counts whole)."""
    key = (dev, name)
    if key not in _inputs:
        pool = contextlib.nullcontext()
        if dev.type == "cuda":
            if dev not in _input_pools:
                _input_pools[dev] = torch.cuda.MemPool()
            pool = torch.cuda.use_mem_pool(_input_pools[dev], device=dev)
        with pool:
            _inputs[key] = torch.empty(numel, dtype=dtype, device=dev)
    return _inputs[key]


def _forget(keep: int) -> None:
    """Drop the least recent keys down to ``keep``; with no graph left,
    release the inputs (under ``_graphs_lock``)."""
    while len(_graphs) > keep:
        _graphs.popitem(last=False)
    if not any(g is not None for g in _graphs.values()):
        _inputs.clear()
        _input_pools.clear()


def clear_lq_graphs() -> None:
    """Forget every key and captured loop, and release their inputs: each
    key's next call runs eagerly."""
    with _graphs_lock:
        _forget(0)


def graph_bytes() -> int:
    """Device bytes the graphs hold from call to call (their shared inputs,
    at most ``GRAPH_HELD_BYTES``)."""
    with _graphs_lock:
        return sum(t.numel() * t.element_size() for t in _inputs.values())


def _on_card(colors) -> bool:
    return colors.is_cuda


def lq_quantize(colors, weights, init_labels, k0, palette_size: int,
                bucket_count=BUCKET_COUNT, batch_splits: int = 1,
                mesh=None):
    """Greedy splitting from ``k0`` initial clusters (an int or a 0-d
    tensor, <= 12) up to ``palette_size``, with the loop's control on the
    device (the JAX package's ``lq_quantize``, ``local_q.py:282-430``).
    Returns ``(labels (N,) int32, count)``, ``count`` a 0-d int32 tensor on
    ``colors``' device.

    On the card without ``mesh`` (whose sums are collectives), for float32
    colours of at most ``GRAPH_MAX_ROWS`` rows, the loop runs eagerly on a
    key's first call, is captured as a graph on its second and replayed
    from then on. The key is what fixes the graph's shapes: the device, N,
    the palette size, the batch, the buckets, the dtype and whether
    ``weights`` is given; ``k0`` goes in as data. The cache keeps the
    ``GRAPH_KEYS`` most recent keys, so a size seen once never pays for a
    capture. One lock spans a replay and its outputs' copies."""
    p = int(palette_size)
    n = colors.shape[0]
    if (mesh is not None or not _on_card(colors) or n > GRAPH_MAX_ROWS
            or colors.dtype != torch.float32):
        LQ_GRAPH["eager"] += 1
        return lq_loop(colors, weights, init_labels, k0, p, bucket_count,
                       batch_splits, mesh)
    bsz = _batch_size(batch_splits, p)
    key = (colors.device, n, p, bsz, int(bucket_count), colors.dtype,
           weights is not None)
    with _graphs_lock:
        seen = key in _graphs
        graph = _graphs.pop(key, None)
        if seen and graph is None:
            graph = _LoopGraph(colors, weights is not None, p,
                               int(bucket_count), bsz)
            graph.load(colors, weights, init_labels, k0)
            graph.capture()
            LQ_GRAPH["captured"] += 1
        elif graph is not None:
            graph.load(colors, weights, init_labels, k0)
        _graphs[key] = graph
        _forget(GRAPH_KEYS)
        if graph is not None:
            with span("lq-loop"):
                graph.replay()
                labels, count = graph.outputs()
            LQ_GRAPH["replayed"] += 1
            return labels, count
    LQ_GRAPH["eager"] += 1
    return lq_loop(colors, weights, init_labels, k0, p, bucket_count,
                   batch_splits)

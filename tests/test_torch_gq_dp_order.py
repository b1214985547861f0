"""K11's reduction rule (``csrc/gq_dp.cu``) modelled in numpy and held bit
for bit against its plain version.

The kernel splits the DP's columns over the C blocks of a thread block
cluster (column n in block n mod C, its D cells at ``d_offset`` in the
block's table, each column's two halves dealt to the warps from the
longest down in snake order), scans each column's candidates over the 32
lanes of a warp (lane l takes t = n-1-l, n-33-l, .. with the running
rule), takes the warp's minimum of the 64-bit order key (two
``__reduce_min_sync``: the smallest high word, then the smallest low word
among the lanes that hold it), and reads the winner's own value from its
lane. The model below does the same in f32, and beside the kernel's
reduction a 5-step xor-shuffle tree on the comparator, which must pick
the same lane; it sends the level rows and cut rows as the kernel does,
backtracks the chains from block 0's cut table, and must give
``gq_dp_plain``'s prefix, costs, cut rows and chains (f32) bit for bit,
NaN where NaN: at C = 4, 8 and 16, b = 1, 2, 33, 512 and 1023, k_max 1 ..
12, on the adversarial moments of ``kernels.gq.adversarial_moments``. A
hypothesis property holds the comparator to one winner under any
permutation and grouping of a candidate list with NaN, +-inf and +-0, and
the kernel's 64-bit order key to the comparator.
"""

import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from patolette_tpu_torch.kernels import gq as KGQ
from test_torch_cores import share_cores  # noqa: F401

LANES = 32
WARPS = 32
INF = np.float32(np.inf)


def d_offset(j, r, c):
    """Cells of D before block r's local column j (csrc/gq_dp.cu)."""
    return j * r + c * (j * (j - 1) // 2)


def snake(items):
    """The item indices in the order the kernel deals them to its warps,
    (warp, item): round q, warp w -> w (q even) or (q+1) W - 1 - w (q
    odd); items listed from the longest down."""
    order = []
    for q in range(-(-items // WARPS)):
        for w in range(WARPS):
            i = (q + 1) * WARPS - 1 - w if q & 1 else q * WARPS + w
            if i < items:
                order.append((w, i))
    return order


def beats(va, ta, vb, tb):
    """The kernel's rule: does (va, ta) beat (vb, tb)? Elementwise."""
    an, bn = np.isnan(va), np.isnan(vb)
    with np.errstate(invalid="ignore"):
        return ((an & ~bn) | (an & bn & (ta > tb))
                | (~an & ~bn & ((va < vb) | ((va == vb) & (ta > tb)))))


def order_key(v, t):
    """The kernel's 64-bit key (the smaller wins), elementwise."""
    u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    u = np.where(((u << np.uint64(1)) & np.uint64(0xffffffff)) == 0,
                 np.uint64(0), u)
    sign = (u & np.uint64(0x80000000)) != 0
    hi = np.where(sign, ~u & np.uint64(0xffffffff),
                  u | np.uint64(0x80000000))
    hi = np.where(np.isnan(v), np.uint64(0), hi)
    lo = ~np.asarray(t).astype(np.uint64) & np.uint64(0xffffffff)
    return (hi << np.uint64(32)) | lo


def kernel_model(bm, k_max, c):
    """csrc/gq_dp.cu's DP in numpy f32: (prefix, cost, cut, chains)."""
    b = bm.shape[0]
    cols = b + 1
    prefix = np.zeros((cols, 11), np.float32)
    acc = np.zeros(11, np.float32)
    with np.errstate(invalid="ignore"):
        for i in range(b):
            acc = acc + bm[i]
            prefix[i + 1] = acc
    # D(t, n) with the kernel's rounding (each op on its own), then each
    # block's table: its columns n = r + j c, each of n cells, in order
    p = torch.from_numpy(prefix)
    with np.errstate(invalid="ignore"):
        dfull = KGQ.cell_distortion(p[:, None, :], p[None, :, :]).numpy()
    tables = []
    for r in range(c):
        ncl = (b - r) // c + 1 if r <= b else 0
        tab = np.zeros(d_offset(ncl, r, c), np.float32)
        writes = np.zeros(len(tab), np.int64)
        for _, i in snake(2 * ncl):  # column ncl-1-i//2, half i % 2
            j = ncl - 1 - i // 2
            n = r + j * c
            lo, hi = (n // 2, n) if i & 1 else (0, n // 2)
            at = d_offset(j, r, c)
            tab[at + lo:at + hi] = dfull[lo:hi, n]
            writes[at + lo:at + hi] += 1
        assert (writes == 1).all()  # every cell of the table once
        tables.append(tab)
    assert sum(len(t) for t in tables) == b * (b + 1) // 2

    n_all = np.arange(cols)
    owner, local = n_all % c, n_all // c
    base = np.array([d_offset(j, r, c) for j, r in zip(local, owner)])
    flat = np.concatenate(tables)
    start = np.cumsum([0] + [len(t) for t in tables])[owner] + base
    lane = np.arange(LANES)

    cost = np.empty((k_max, cols), np.float32)
    cut = np.zeros((k_max + 1, cols), np.int32)
    cut_tables = np.zeros((c, k_max + 1, cols), np.int32)
    e = dfull[0].copy()  # level 1: the cell (0, n]
    cost[0] = e
    for k in range(2, k_max + 1):
        best = np.full((cols, LANES), INF, np.float32)
        arg = np.full((cols, LANES), b, np.int64)
        for i in range(-(-b // LANES)):
            t = n_all[:, None] - 1 - lane[None, :] - LANES * i
            live = t >= k - 1
            tc = np.where(live, t, 0)
            with np.errstate(invalid="ignore", over="ignore"):
                cand = e[tc] + flat[start[:, None] + tc]
                take = live & ~np.isnan(best) & ~(cand >= best)
            best = np.where(take, cand, best)
            arg = np.where(take, t, arg)
        # the kernel's reduction of the order key: the smallest high word,
        # then the smallest low word among the lanes that hold it
        key = order_key(best, arg)
        hi, lo = key >> np.uint64(32), key & np.uint64(0xffffffff)
        min_hi = hi.min(axis=1, keepdims=True)
        min_lo = np.where(hi == min_hi, lo, np.uint64(0xffffffff)).min(1)
        tw = (~min_lo & np.uint64(0xffffffff)).astype(np.int64)
        # a 5-step xor-shuffle tree on the comparator picks the same
        v, tv = best.copy(), arg.copy()
        for s in (16, 8, 4, 2, 1):
            ov, ot = v[:, lane ^ s], tv[:, lane ^ s]
            w = beats(ov, ot, v, tv)
            v, tv = np.where(w, ov, v), np.where(w, ot, tv)
        assert (tv == tw[:, None]).all()
        won = best[n_all, (n_all - 1 - tw) & (LANES - 1)]
        e = np.where(tw == b, INF, won).astype(np.float32)
        cost[k - 1] = e
        cut[k] = tw
        cut_tables[:, k] = tw[None, :]  # every block's copy of the row
    chains = np.full((k_max, 13), b, np.int32)
    chains[:, 0] = 0
    for k in range(1, k_max + 1):
        t = b
        for j in range(k - 1, 0, -1):
            t = cut_tables[0, j + 1, t]
            chains[k - 1, j] = t
    return prefix, cost, cut, chains


def same_bits(got, want):
    """Identical bits, NaN where NaN (any payload)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype.kind != "f":
        return np.array_equal(got, want)
    gn, wn = np.isnan(got), np.isnan(want)
    return bool((gn == wn).all()
                and (got[~gn].view(np.uint32)
                     == want[~wn].view(np.uint32)).all())


@functools.lru_cache(maxsize=None)
def _cases(b):
    return KGQ.adversarial_moments(b)


@functools.lru_cache(maxsize=None)
def _plain(name, b, k_max):
    return tuple(t.numpy() for t in KGQ.gq_dp_plain(
        torch.from_numpy(_cases(b)[name]), k_max))


CASES = ("random", "sparse5", "sparse5_nan", "nan_window", "nan_w0", "inf",
         "empty", "one_bucket")


@pytest.mark.parametrize("c", [4, 8, 16])
@pytest.mark.parametrize("b", [1, 2, 33, 512, 1023])
@pytest.mark.parametrize("name", CASES)
def test_model_equals_plain(name, b, c):
    want = _plain(name, b, 12)
    got = kernel_model(_cases(b)[name], 12, c)
    for what, g, w in zip(("prefix", "cost", "cut", "chains"), got, want):
        assert same_bits(g, w), (name, b, c, what)


@pytest.mark.parametrize("k_max", range(1, 13))
@pytest.mark.parametrize("b", [33, 512])
def test_model_every_k_max(k_max, b):
    for name in ("random", "sparse5_nan", "nan_window"):
        want = _plain(name, b, k_max)
        got = kernel_model(_cases(b)[name], k_max, 8)
        for what, g, w in zip(("prefix", "cost", "cut", "chains"), got,
                              want):
            assert same_bits(g, w), (name, b, k_max, what)


def test_adversarial_cases_are_adversarial():
    """The sparse case ties exactly, the NaN cases give NaN candidates in
    some columns beside finite ones."""
    _, cost, cut, _ = _plain("sparse5", 512, 12)
    assert (cost[1:] == 0).sum() > 100
    for name in ("sparse5_nan", "nan_window", "inf"):
        _, cost, _, _ = _plain(name, 512, 12)
        assert np.isnan(cost).any() and np.isfinite(cost).any(), name


VALUES = st.sampled_from([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0,
                          2.5, 1e-30, -3e38])


@settings(max_examples=200, deadline=None)
@given(st.lists(VALUES, min_size=1, max_size=40), st.randoms())
def test_comparator_any_order_and_grouping(values, rnd):
    """The rule is a total order: any permutation of the candidates, cut
    into any groups, each group reduced in its order and the groups'
    winners reduced in theirs, gives the same winner, value bits and all;
    the order key sorts the candidates as the rule does."""
    v = np.array(values, np.float32)
    t = np.array(rnd.sample(range(1000), len(values)), np.int64)
    keys = order_key(v, t)
    first = int(np.argmin(keys))
    for i in range(len(v)):
        for j in range(len(v)):
            if i != j:
                assert bool(beats(v[i], t[i], v[j], t[j])) == bool(
                    keys[i] < keys[j])

    def reduce(idx):
        w = idx[0]
        for i in idx[1:]:
            if beats(v[i], t[i], v[w], t[w]):
                w = i
        return w

    for _ in range(4):
        perm = list(range(len(v)))
        rnd.shuffle(perm)
        cuts = sorted(rnd.sample(range(1, len(v)),
                                 rnd.randint(0, len(v) - 1))) + [len(v)]
        groups = [perm[a:z] for a, z in zip([0] + cuts[:-1], cuts)]
        winners = [reduce(g) for g in groups]
        rnd.shuffle(winners)
        w = reduce(winners)
        assert w == first
        assert v[w].view(np.uint32) == v[first].view(np.uint32)

"""The CPU side of K3's and K8's redesigns, against the JAX package.

K3 (``csrc/nearest.cuh``, the sorted layout): a block cuts its tile of
pixels by median splits of the widest channel into warps' boxes and scans
each box over ``kernels.lut.box_candidates``' list alone.
``kernels.assign.assign_grouped_model`` is that route in numpy; its labels
must equal the JAX package's ``assign_planar`` exactly (and the port's plain
version) on exact ties, invalid slots, +-inf and NaN coordinates (a NaN
distance counts as the least, as ``argmin`` has it), one pixel, one
centre and a constant image, with two tiles and a ragged end.

K8 (``csrc/dither.cu``): the kernel is held on the card to
``dither_scan_plain``; here the plain version is held bit for bit to the
JAX package's ``_dither_stream_planar`` (``_dither_scan_core`` fed in
Hilbert order) on the same linear-Rec2020 inputs: one pixel, one lane at
5x3, lanes of one step, one entry, duplicated entries (exact ties) and
2100 entries (a palette above the kernel's resident tile).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patolette_tpu.models import dither as JD
from patolette_tpu.ops import assign as JA
from patolette_tpu_torch.kernels import assign as KA
from patolette_tpu_torch.kernels.dither import dither_scan_plain, palette_table
from patolette_tpu_torch.ops import hilbert as TH
from test_torch_cores import share_cores  # noqa: F401

# two sorted tiles and a ragged third
N_GROUPED = 2 * KA.SORT_TILE + 300


def _k3_inputs(case):
    rng = np.random.default_rng(len(case))
    n = 1 if case == "n1" else N_GROUPED
    # an image-like cloud: a few colour clusters, not a uniform cube
    hubs = rng.uniform(0.0, 1.0, (6, 3)).astype(np.float32)
    x = hubs[rng.integers(0, 6, n)] + rng.normal(0, 0.04, (n, 3))
    x = x.astype(np.float32)
    p = 1 if case == "p1" else 48
    cen = x[rng.integers(0, n, p)].copy()
    ok = np.ones(p, bool)
    if case == "ties":
        cen[p // 2:] = cen[:p // 2][::-1]
        x[::5] = cen[rng.integers(0, p, len(x[::5]))]
    elif case == "invalid":
        ok[::2] = False
    elif case == "inf":
        ok[0] = False
        x[3::211, 0] = np.inf
        x[7::307, 2] = -np.inf
        cen[4, 0] = 0.0  # inf * 0: a NaN distance
    elif case == "nan":
        ok[:2] = False
        x[11::173, 1] = np.nan
        x[5] = np.nan
        cen[6, 2] = np.nan  # invalid: its NaN distances never win
        ok[6] = False
    elif case == "constant":
        x[:] = x[0]
    return x, cen, ok


@pytest.mark.parametrize("case", ["ties", "invalid", "inf", "nan", "n1",
                                  "p1", "constant", "clusters"])
def test_grouped_scan_equals_jax(case):
    x, cen, ok = _k3_inputs(case)
    planes = tuple(x[:, i].copy() for i in range(3))
    want = np.asarray(JA.assign_planar(
        tuple(jnp.asarray(v) for v in planes), jnp.asarray(cen),
        jnp.asarray(ok)))
    got, listed = KA.assign_grouped_model(planes, cen, ok)
    plain = KA.assign_planar_plain(
        tuple(torch.from_numpy(v) for v in planes), torch.from_numpy(cen),
        torch.from_numpy(ok)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)
    tiles = -(-len(x) // KA.SORT_TILE)
    assert -(-len(x) // KA.GROUP) <= len(listed)
    assert len(listed) <= tiles * KA.SORT_TILE // KA.GROUP
    if case == "clusters":  # the grouping prunes: most centres drop out
        assert listed.mean() < 0.5 * ok.sum()


def test_median_splits_partition_by_the_widest_channel():
    """Every point of a ragged tile falls in exactly one box of at most
    GROUP points; the first split cuts the widest channel (here 1) at its
    median, to within one bin of the tile's range."""
    rng = np.random.default_rng(3)
    n = KA.SORT_TILE - 700
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    x[:, 1] *= 10
    groups = KA.sorted_groups(x)
    flat = np.concatenate(groups)
    np.testing.assert_array_equal(np.sort(flat), np.arange(n))
    assert max(len(g) for g in groups) <= KA.GROUP
    half = KA.SORT_TILE // 2
    pad = np.full((KA.SORT_TILE - n, 3), np.nan, np.float32)
    order = KA.kd_order(np.concatenate([x, pad]))
    first = order[:half][order[:half] < n]
    second = order[half:][order[half:] < n]
    width = (x[:, 1].max() - x[:, 1].min()) / KA.KD_BINS
    assert x[first, 1].max() <= x[second, 1].min() + width


def _rec2020(n, k, seed):
    rng = np.random.default_rng(seed)
    ch = tuple(rng.uniform(0, 1, n).astype(np.float32) for _ in range(3))
    pal = rng.uniform(0, 1, (k, 3)).astype(np.float32)
    return ch, pal


@pytest.mark.parametrize("w,h,k,segment,kind", [
    (1, 1, 16, 4096, "random"),
    (5, 3, 16, 0, "random"),
    (24, 16, 16, 1, "random"),
    (24, 16, 1, 4096, "random"),
    (32, 24, 64, 100, "duplicates"),
    (20, 12, 2100, 4096, "random"),
])
def test_dither_plain_equals_jax_scan(w, h, k, segment, kind):
    ch, pal = _rec2020(w * h, k, seed=w * h + k)
    if kind == "duplicates":
        pal[k // 2:] = pal[:k // 2][::-1]
    valid = np.ones(k, bool)
    if k > 3:
        valid[1] = False
    want = np.asarray(JD._dither_stream_planar(
        tuple(jnp.asarray(c) for c in ch), jnp.asarray(pal),
        jnp.asarray(valid), w, h, segment))
    got = dither_scan_plain(
        tuple(torch.from_numpy(c) for c in ch),
        TH.pixel_visit_order(w, h, "cpu"),
        palette_table(torch.from_numpy(pal), torch.from_numpy(valid)),
        segment).numpy()
    np.testing.assert_array_equal(got, want)

"""K6 (the v2 run-length encode of a u8 LUT slice) and the sharded table
assembly, the port's plain versions against the JAX package.

Tolerances: the encoding is integer work, so every comparison is exact:
the header (count, overflow) always, and the first ``count`` words when
the header says they are to be read (past ``count`` the JAX buffer holds
sort sentinels and the port's holds nothing the format defines). The
decode of an encoding equals the table it encoded; the host C++ decode
equals ``np.repeat`` of the runs; the ranks' K5 slices of a palette's
table, concatenated, equal the whole table bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patolette_tpu.ops import lut as JL
from patolette_tpu_torch.kernels.rle import (MAX_RUNS, buffer_words, header,
                                             rle_encode_u8_v2)
from patolette_tpu_torch.ops import colorspace as TCS
from patolette_tpu_torch.ops import lut as TL
from test_torch_cores import share_cores  # noqa: F401


def _voronoi(length, k, seed, start=None):
    """u8 table of ``length`` consecutive codes from ``start`` (a seeded
    128-aligned place by default): each code's nearest of ``k`` random
    sRGB points, as a slice of a palette's table is."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 255, (k, 3)).astype(np.float32)
    if start is None:
        start = 128 * int(rng.integers(0, ((1 << 24) - length) // 128))
    codes = start + np.arange(length, dtype=np.int64)
    rgb = np.stack([(codes >> 16) & 255, (codes >> 8) & 255, codes & 255],
                   axis=1).astype(np.float32)
    out = np.empty((length,), np.uint8)
    for s in range(0, length, 1 << 18):
        d = ((rgb[s:s + (1 << 18), None, :] - pts[None]) ** 2).sum(-1)
        out[s:s + (1 << 18)] = d.argmin(1)
    return out


def _jax_encode(table):
    enc = np.asarray(JL._rle_encode_u8_v2(jnp.asarray(table)))
    count = int(enc[0]) | (int(enc[1]) << 16)
    return enc, count, bool(enc[2])


def _assert_same(table):
    enc = rle_encode_u8_v2(torch.from_numpy(table)).numpy()
    want, count, over = _jax_encode(table)
    assert enc.dtype == np.uint16 and enc.shape == (buffer_words(len(table)),)
    np.testing.assert_array_equal(enc[:3], want[:3])
    assert header(torch.from_numpy(enc)) == (count, over)
    if not over:
        np.testing.assert_array_equal(enc[3:3 + count], want[3:3 + count])
    return enc, count, over


def _repeat_decode(words, size):
    pos = np.cumsum((words >> 8).astype(np.int64))
    return np.repeat((words & 0xFF).astype(np.uint8),
                     np.diff(np.append(pos, size)))


@pytest.mark.parametrize("log_len,k,seed", [(16, 256, 0), (18, 64, 1),
                                            (20, 24, 2)])
def test_voronoi_tables_match_jax(log_len, k, seed):
    table = _voronoi(1 << log_len, k, seed)
    enc, count, over = _assert_same(table)
    assert not over and count > (1 << log_len) // 128
    words = enc[3:3 + count]
    out = np.empty_like(table)
    TL.rle_decode_u8_v2(words, out)
    np.testing.assert_array_equal(out, table)
    np.testing.assert_array_equal(_repeat_decode(words, len(table)), table)


def test_quarter_slice_matches_jax():
    per = 1 << 22
    table = _voronoi(per, 12, 3, start=2 * per)
    enc, count, over = _assert_same(table)
    assert not over
    out = np.empty_like(table)
    TL.rle_decode_u8_v2(enc[3:3 + count], out)
    np.testing.assert_array_equal(out, table)


@pytest.mark.parametrize("value", [0, 7, 255])
def test_constant_table(value):
    table = np.full((1 << 12,), value, np.uint8)
    enc, count, over = _assert_same(table)
    # only the forced starts: one run a 128-block, delta 128 after the first
    assert (count, over) == (32, False)
    np.testing.assert_array_equal(enc[3:3 + count],
                                  [value] + [(128 << 8) | value] * 31)


@pytest.mark.parametrize("starts,overflow", [(32, False), (33, True)])
def test_block_of_32_and_33_starts(starts, overflow):
    table = np.zeros((1024,), np.uint8)
    block = 3 * 128
    # starts - 1 value changes inside the block after its forced start; the
    # last value runs on to the block's end
    for j in range(1, starts):
        table[block + 2 * j:block + 128] = j % 2 + 1
    enc, count, over = _assert_same(table)
    assert over is overflow
    assert count == 7 + starts  # the other 7 blocks: their forced starts


def test_alternating_full_table_overflows():
    table = np.tile(np.array([1, 2], np.uint8), 1 << 23)
    enc, count, over = _assert_same(table)
    assert count == 1 << 24 and count > MAX_RUNS and over


def test_decode_rejects_words_past_the_table():
    words = np.array([5, (200 << 8) | 1], np.uint16)
    with pytest.raises(RuntimeError):
        TL.rle_decode_u8_v2(words, np.empty((100,), np.uint8))


def test_rank_slices_concatenate_to_the_table():
    """The four ranks' K5 slices (plain versions, explicit rank and world)
    equal the single-device table bit for bit, and each slice's encoding
    decodes back to it."""
    rng = np.random.default_rng(5)
    p = 16
    pal = torch.from_numpy(rng.uniform(0.05, 0.95, (p, 3)).astype(np.float32))
    work = TCS.srgb_to_working(pal, 2)
    valid = torch.tensor([True] * (p - 1) + [False])

    class _Rank:
        world = 4

        def __init__(self, rank):
            self.rank = rank

    try:
        slices = []
        for r in range(4):
            enc, sl = TL.build_lut_enc_sharded(_Rank(r), work, valid, 2)
            count, over = header(enc)
            assert not over
            out = np.empty((sl.shape[0],), np.uint8)
            TL.rle_decode_u8_v2(enc.numpy()[3:3 + count], out)
            np.testing.assert_array_equal(out, sl.numpy())
            slices.append(sl.numpy())
        whole = TL.build_lut_device(work, valid, 2).numpy()
    finally:
        TL.clear_grid_cache()
    np.testing.assert_array_equal(np.concatenate(slices), whole)

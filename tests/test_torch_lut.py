"""The port's 24-bit LUT modules (``patolette_tpu_torch/ops/lut.py``,
``kernels/lut.py`` K5's plain version, ``csrc/lut_map.cpp``) against the
JAX package's ``ops/lut.py`` on the same inputs.

Tolerances:
  * grid: the ICtCp values of a strided 2^18-code subset within 5e-5 of
    JAX's compiled ``_codes_to_ictcp`` in all three spaces, the ICtCp-valued
    tolerance of ``tests/test_torch_colorspace.py`` (libm ``powf`` is not
    always correctly rounded, and the PQ curve turns a last-bit difference
    into ~1e-5).
  * argmin: identical indices when both sides get the same grid and palette
    (same distance formula, same first-index ties), u8 and u16.
  * full table: identical to the port's direct map (K3's plain version) of
    the same pixels, as ``tests/test_lut.py::test_lut_matches_direct_assign``
    holds the JAX package's table to its direct map.
  * host map: exact.

The full 2^24 grid is built once in this file (ICtCp, on the CPU), with a
small palette; the grid cache serves every test after the first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patolette_tpu.ops import lut as JL
from patolette_tpu_torch.kernels.lut import lut_argmin_plain
from patolette_tpu_torch.ops import colorspace as cs
from patolette_tpu_torch.ops import lut as TL
from patolette_tpu_torch.ops.assign import assign_planar
from test_torch_cores import share_cores  # noqa: F401

SUBSET = np.arange(0, 1 << 24, 64, dtype=np.int32)  # 2^18 codes


def _jax_codes_to_ictcp(codes, color_space):
    f = jax.jit(lambda c: JL._codes_to_ictcp(c, color_space))
    return tuple(np.array(v, np.float32) for v in f(jnp.asarray(codes)))


def _palette(p, color_space, seed=7):
    rng = np.random.default_rng(seed)
    pal = rng.uniform(0.05, 0.95, size=(p, 3)).astype(np.float32)
    work = cs.srgb_to_working(torch.from_numpy(pal), color_space)
    valid = torch.ones(p, dtype=torch.bool)
    valid[-1] = False
    return work, valid


def test_lut_dtype_widths():
    for p, dt in ((1, torch.uint8), (256, torch.uint8), (257, torch.uint16),
                  (65536, torch.uint16), (65537, torch.int32),
                  (70000, torch.int32)):
        assert TL.lut_dtype(p) == dt
        assert dt.itemsize == np.dtype(JL.lut_dtype(p)).itemsize


@pytest.mark.parametrize("color_space", [0, 1, 2])
def test_grid_matches_jax_codes(color_space):
    port = TL._codes_to_ictcp(torch.from_numpy(SUBSET), color_space)
    ref = _jax_codes_to_ictcp(SUBSET, color_space)
    for got, want in zip(port, ref):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)


def test_cached_grid_is_the_staged_codes():
    """The chunked build gives what one call on the codes gives."""
    grid = TL.grid_ictcp(2, "cpu")
    assert all(g.shape == (TL.LUT_SIZE,) for g in grid)
    direct = TL._codes_to_ictcp(torch.from_numpy(SUBSET), 2)
    idx = torch.from_numpy(SUBSET).long()
    for g, d in zip(grid, direct):
        assert torch.equal(g[idx], d)


@pytest.mark.parametrize("out_dtype,jdtype", [
    (torch.uint8, jnp.uint8), (torch.uint16, jnp.uint16)])
def test_argmin_plain_matches_jax(out_dtype, jdtype):
    a, b, c = _jax_codes_to_ictcp(SUBSET, 2)
    work, valid = _palette(8, 2)
    pi_j, c2_j = JL._palette_ictcp(jnp.asarray(work.numpy()),
                                   jnp.asarray(valid.numpy()), 2)
    pi_t = TL.palette_ictcp(work, 2)
    np.testing.assert_array_equal(pi_t.numpy(), np.asarray(pi_j))
    want = np.asarray(JL._argmin_lut(
        tuple(jnp.asarray(v)[None] for v in (a, b, c)), pi_j, c2_j, jdtype))
    got = lut_argmin_plain(tuple(torch.from_numpy(v) for v in (a, b, c)),
                           pi_t, valid, out_dtype)
    assert got.dtype == out_dtype
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  want.astype(np.int64))
    assert not (got.numpy() == 7).any()  # the invalid slot never wins


def test_table_matches_direct_assign():
    """The full ICtCp table against the port's direct map of pixels staged
    the way the pipeline stages them."""
    work, valid = _palette(8, 2)
    table = TL.build_lut_device(work, valid, 2, torch.uint8)
    assert table.shape == (TL.LUT_SIZE,) and table.dtype == torch.uint8
    rng = np.random.default_rng(3)
    pix = rng.integers(0, 256, size=(4096, 3), dtype=np.uint8)
    pix[0], pix[1] = 0, 255
    codes = ((pix[:, 0].astype(np.int64) << 16)
             | (pix[:, 1].astype(np.int64) << 8) | pix[:, 2])
    inv = np.float32(1.0 / 255.0)
    chans = tuple(torch.from_numpy(pix[:, k].copy()).to(torch.float32) * inv
                  for k in range(3))
    direct = assign_planar(
        cs.working_to_ictcp(cs.srgb_to_working(chans, 2), 2),
        TL.palette_ictcp(work, 2), valid)
    np.testing.assert_array_equal(table.numpy()[codes], direct.numpy())


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32])
def test_lut_map_host(dtype):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, size=(100_003, 3), dtype=np.uint8)
    img[:64] = 255  # code 0xFFFFFF, the table's last entry
    img[64:128] = 0
    table = rng.integers(0, 250, size=(TL.LUT_SIZE,)).astype(dtype)
    codes = ((img[:, 0].astype(np.int64) << 16)
             | (img[:, 1].astype(np.int64) << 8) | img[:, 2])
    want = table[codes]
    assert codes.max() == 0xFFFFFF and codes.min() == 0

    out = TL.lut_map_host(img, torch.from_numpy(table))
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, want)
    # a strided view of the pixels maps the same as a contiguous copy
    out2 = TL.lut_map_host(np.asfortranarray(img), table)
    assert out2.dtype == np.int32
    np.testing.assert_array_equal(out2, want)


@pytest.mark.parametrize("pixels, table", [
    (np.zeros((16, 3), np.float32), np.zeros((TL.LUT_SIZE,), np.uint8)),
    (np.zeros((16, 4), np.uint8), np.zeros((TL.LUT_SIZE,), np.uint8)),
    (np.zeros((16, 3), np.uint8), np.zeros((TL.LUT_SIZE - 1,), np.uint8)),
    (np.zeros((16, 3), np.uint8), np.zeros((TL.LUT_SIZE,), np.int64)),
])
def test_lut_map_host_rejects_bad_inputs(pixels, table):
    with pytest.raises(ValueError):
        TL.lut_map_host(pixels, table)


def test_grid_cache_reuse(monkeypatch):
    """Repeated builds in one space reuse the cached grid; another space
    evicts it (one grid of 201 MB at a time)."""
    grid = TL.grid_ictcp(2, "cpu")
    assert TL.grid_ictcp(2, "cpu") is grid
    built = []

    def fake_build(color_space, device, lo, hi):
        built.append(color_space)
        return (torch.zeros(1),) * 3

    saved = dict(TL._GRID_CACHE)
    monkeypatch.setattr(TL, "_grid_build", fake_build)
    try:
        TL.grid_ictcp(1, "cpu")
        assert built == [1] and list(TL._GRID_CACHE) == [
            (1, torch.device("cpu"), 0, 1)]
        TL.grid_ictcp(1, "cpu")
        assert built == [1]
    finally:
        TL._GRID_CACHE.clear()
        TL._GRID_CACHE.update(saved)

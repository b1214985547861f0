"""Port Hilbert order (K7's plain version) and Riemersma dither (K8's)
against the JAX package on the same seed-made inputs.

Tolerances:
  * curve indices and visit orders: exact (integer arithmetic; the keys are
    distinct, so the argsort is unique).
  * queue weights: bit for bit (the port holds the JAX package's f32
    values as constants).
  * dither maps: agreement >= 0.999 against the JAX function compiled as
    one program (as the one-shot route and the goldens run it). The port
    converts working space -> linear Rec2020 with the compiled program's
    arithmetic; a last-bit difference there can flip a near-tie and the
    flip travels down the error queue. The JAX package's own eager and
    compiled conversions disagree on up to ~1.2% of these maps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patolette_tpu.models import dither as JD
from patolette_tpu.ops import colorspace as JCS
from patolette_tpu.ops import hilbert as JH
from patolette_tpu_torch.kernels.dither import (QUEUE_WEIGHTS, dither_scan,
                                                palette_table)
from patolette_tpu_torch.kernels.hilbert import xy_to_d
from patolette_tpu_torch.models import dither as TD
from patolette_tpu_torch.ops import hilbert as TH
from test_torch_cores import share_cores  # noqa: F401


def test_curve_order_matches():
    for w, h in ((512, 512), (513, 100), (1, 1), (3840, 2160), (40000, 2)):
        assert TH.curve_order(w, h) == JH.curve_order(w, h)


@pytest.mark.parametrize("order", range(1, 17))
def test_xy_to_d_bits(order):
    rng = np.random.default_rng(order)
    side = 1 << order
    x = rng.integers(0, side, 4096).astype(np.uint32)
    y = rng.integers(0, side, 4096).astype(np.uint32)
    # the four corners and the max-d corner region of test_dither.py
    x[:4] = [0, side - 1, 0, side - 1]
    y[:4] = [0, 0, side - 1, side - 1]
    if order == 16:
        x[4:12] = np.arange(65528, 65536, dtype=np.uint32)
        y[4:12] = 0
    jd = np.asarray(JH.xy_to_d(jnp.asarray(x), jnp.asarray(y), order))
    td = xy_to_d(torch.from_numpy(x.astype(np.int64)),
                 torch.from_numpy(y.astype(np.int64)), order)
    np.testing.assert_array_equal(td.numpy(), jd.astype(np.int64))
    if order == 16:
        assert td.max() > (1 << 31)  # the u32 range is used


@pytest.mark.parametrize("wh", [(13, 7), (64, 64), (40000, 2)])
def test_pixel_visit_order_matches(wh):
    w, h = wh
    perm = TH.pixel_visit_order(w, h, device="cpu")
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(),
                                  np.asarray(JH.pixel_visit_order(w, h)))


def test_queue_weights_bits():
    w32 = np.asarray(QUEUE_WEIGHTS, np.float32)
    np.testing.assert_array_equal(w32, np.asarray(QUEUE_WEIGHTS))  # exact
    np.testing.assert_array_equal(w32,
                                  np.asarray(JD._queue_weights(jnp.float32)))
    assert QUEUE_WEIGHTS[1] == float.fromhex("0x1.33f972p-4")


def _working(csp, side, k, seed):
    """Seed-made sRGB image and palette, taken to the working space by the
    JAX package (both sides get the same working-space inputs)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (side * side, 3)).astype(np.float32)
    pal = rng.uniform(0, 1, (k, 3)).astype(np.float32)
    xw = jax.jit(lambda a, b, c: JCS.srgb_to_working((a, b, c), csp))(
        *(img[:, i] for i in range(3)))
    pw = jax.jit(lambda a: JCS.srgb_to_working(a, csp))(pal)
    return [np.asarray(v) for v in xw], np.asarray(pw)


@pytest.mark.parametrize("segment", [512, 0])
@pytest.mark.parametrize("csp", [0, 1, 2])
def test_dither_planar_matches_jax(csp, segment):
    side, k = 96, 16
    xw, pw = _working(csp, side, k, seed=10 + csp)
    valid = np.ones(k, bool)
    valid[3] = False
    jmap = np.asarray(jax.jit(
        lambda a, b, c, p, v: JD.riemersma_dither_planar(
            (a, b, c), p, v, side, side, csp, segment=segment)
    )(*xw, pw, valid))
    tmap = TD.riemersma_dither_planar(
        tuple(torch.from_numpy(v.copy()) for v in xw),
        torch.from_numpy(pw.copy()), torch.from_numpy(valid), side, side,
        csp, segment=segment).numpy()
    assert tmap.dtype == np.int32 and tmap.shape == (side * side,)
    assert (tmap == jmap).mean() >= 0.999
    assert 3 not in np.unique(tmap)  # the invalid slot is never chosen


def test_exact_colors_pass_through():
    g = np.linspace(0, 1, 9)
    pal = np.stack([g, g, g], -1).astype(np.float32)
    idx = np.random.default_rng(0).integers(0, len(pal), 256)
    img = torch.from_numpy(pal[idx])
    pmap = TD.riemersma_dither_planar(
        (img[:, 0], img[:, 1], img[:, 2]), torch.from_numpy(pal),
        torch.ones(len(pal), dtype=torch.bool), 16, 16, 0, segment=0)
    np.testing.assert_array_equal(pmap.numpy(), idx)


def test_grey_mixes_black_and_white():
    """A flat linear grey against black and white dithers to a mix whose
    mean is near the grey (plain nearest-colour would give all black)."""
    img = torch.full((4096,), 0.4)
    table = palette_table(torch.tensor([[0.0] * 3, [1.0] * 3]),
                          torch.ones(2, dtype=torch.bool))
    pmap = dither_scan((img, img, img),
                       TH.pixel_visit_order(64, 64, "cpu"), table, 0)
    assert 0.25 < float(pmap.float().mean()) < 0.55


def test_scan_lanes_and_short_last_lane():
    """The queue restarts at every lane: a lane's labels depend only on its
    own pixels; the short last lane is scanned to its end."""
    rng = np.random.default_rng(5)
    n, seg = 1000, 128                       # 8 lanes, the last of 104
    ch = tuple(torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
               for _ in range(3))
    pal = torch.from_numpy(rng.uniform(0, 1, (12, 3)).astype(np.float32))
    table = palette_table(pal, torch.ones(12, dtype=torch.bool))
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32))
    full = dither_scan(ch, perm, table, seg)
    for lane in range(8):
        part = perm[lane * seg:(lane + 1) * seg]
        alone = dither_scan(tuple(c[part.long()] for c in ch),
                            torch.arange(len(part), dtype=torch.int32),
                            table, 0)
        np.testing.assert_array_equal(full[part.long()].numpy(),
                                      alone.numpy())

"""K7's redesign and K4's and K8's NaN rule, on the CPU, against the JAX
package.

K7 (``csrc/hilbert.cu``) computes the whole visit order with no sort: the
square of the curve cut into tiles, each image-meeting tile found by rank
in the quadtree, its cells walked in curve order from one canonical tile
under the rotation state there. Here:
- ``pixel_visit_order_plain`` (argsort of ``xy_to_d``, what the card's
  kernel is held to) equals the JAX ``pixel_visit_order`` exactly at the
  thin, tiny and just-over-a-power-of-two shapes the card checks;
- ``visit_order_model`` (the kernel's arithmetic in numpy) equals it
  exactly at the same shapes;
- ``d_to_xy`` (the kernel's inverse of the curve) inverts ``xy_to_d`` on
  every cell of orders 1 to 6.

K4 and K8 on the card take argmin's rule (a NaN distance is the least,
the first NaN wins) where a point or an entry is not finite; their plain
versions, which the card holds them to, must equal the JAX package's on
those inputs: NaN and +-inf points with slot 0 invalid, +inf against a
zero coordinate (inf x 0), non-finite centres (K4). Labels exactly; K4's
centres at atol 1e-6 with the same NaN and infinite entries. K8's
non-finite palette entries are held on the card only: the JAX scan
selects the chosen colour by a one-hot matrix product, in which 0 x inf
makes every chosen colour NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patolette_tpu.models import dither as JD
from patolette_tpu.models import kmeans as JKM
from patolette_tpu.ops import assign as JA
from patolette_tpu.ops import hilbert as JH
from patolette_tpu_torch.kernels import hilbert as KH
from patolette_tpu_torch.kernels.dither import dither_scan_plain, palette_table
from patolette_tpu_torch.kernels.kmeans import kmeans_step_plain
from test_torch_cores import share_cores  # noqa: F401

SHAPES = [(1, 1), (8, 1), (1, 8), (5, 3), (7, 3), (3, 40000), (40000, 3),
          (4097, 2), (33, 65)]


@pytest.mark.parametrize("w,h", SHAPES)
def test_plain_visit_order_equals_jax(w, h):
    got = KH.pixel_visit_order_plain(w, h)
    assert got.dtype == torch.int32 and got.shape == (w * h,)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JH.pixel_visit_order(w, h)))


@pytest.mark.parametrize("w,h", SHAPES)
def test_tile_walk_model_equals_plain(w, h):
    np.testing.assert_array_equal(KH.visit_order_model(w, h),
                                  KH.pixel_visit_order_plain(w, h).numpy())


@pytest.mark.parametrize("order", range(1, 7))
def test_inverse_inverts_xy_to_d(order):
    side = 1 << order
    d = np.arange(side * side)
    x, y, _, _ = KH.d_to_xy(d, order)
    assert x.max() < side and y.max() < side
    back = KH.xy_to_d(torch.from_numpy(x), torch.from_numpy(y), order)
    np.testing.assert_array_equal(back.numpy(), d)


def _nonfinite(case, x, c, ok):
    """Points x (n, 3) and centres c (p, 3): NaN and +-inf points (every
    97th from a channel's own offset, point 5 NaN in all three) with slot
    0 invalid; +inf in channel 0 of every 53rd point against centre 3,
    whose channel 0 is 0; centre 7 at (inf, 0, 0) and a NaN in centre 9."""
    if case == "nonfinite":
        for i, v in enumerate((np.nan, np.inf, -np.inf)):
            x[i::97, i] = v
        x[5] = np.nan
        ok[0] = False
    elif case == "inf-times-zero":
        x[::53, 0] = np.inf
        c[3, 0] = 0.0
    elif case == "nonfinite-centres":
        c[7] = (np.inf, 0.0, 0.0)
        c[9, 2] = np.nan
    return x, c, ok


@pytest.mark.parametrize("case", ["nonfinite", "inf-times-zero",
                                  "nonfinite-centres"])
def test_kmeans_plain_nan_rule_equals_jax(case):
    rng = np.random.default_rng(90)
    n, p = 3000, 24
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    c = x[rng.choice(n, p, replace=False)].copy()
    x, c, ok = _nonfinite(case, x, c, np.ones(p, bool))
    tc, labels = kmeans_step_plain(torch.from_numpy(x), None,
                                   torch.from_numpy(c), torch.from_numpy(ok))
    jl = np.asarray(JA.assign_planar(tuple(x[:, k] for k in range(3)),
                                     jnp.asarray(c), valid=ok))
    np.testing.assert_array_equal(labels.numpy(), jl)
    jc = np.asarray(jax.jit(JKM.lloyd_iterations, static_argnames="niter")(
        jnp.asarray(x), None, jnp.asarray(c), jnp.asarray(ok), niter=1))
    np.testing.assert_allclose(tc.numpy(), jc, atol=1e-6, rtol=0)
    if case == "nonfinite":
        assert labels[5] == 1  # all NaN: the first valid slot
    if case == "inf-times-zero":
        assert (labels.numpy()[::53] == 3).all()


@pytest.mark.parametrize("case", ["nonfinite", "inf-times-zero"])
def test_dither_plain_nan_rule_equals_jax(case):
    rng = np.random.default_rng(91)
    w, h, k, segment = 24, 16, 16, 37
    x = rng.uniform(0, 1, (w * h, 3)).astype(np.float32)
    pal = rng.uniform(0, 1, (k, 3)).astype(np.float32)
    x, pal, ok = _nonfinite(case, x, pal, np.ones(k, bool))
    ch = tuple(np.ascontiguousarray(x[:, i]) for i in range(3))
    want = np.asarray(JD._dither_stream_planar(
        tuple(jnp.asarray(v) for v in ch), jnp.asarray(pal),
        jnp.asarray(ok), w, h, segment))
    got = dither_scan_plain(
        tuple(torch.from_numpy(v) for v in ch),
        KH.pixel_visit_order_plain(w, h),
        palette_table(torch.from_numpy(pal), torch.from_numpy(ok)),
        segment).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "inf-times-zero":
        assert (got[::53] == 3).all()

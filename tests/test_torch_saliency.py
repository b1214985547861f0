"""Port saliency (K9's plain version and the torch priors) against the JAX
package on the same seed-made inputs.

Tolerances:
  * ``mbd``: exact (min, max and one subtraction per cell).
  * ``srgb_to_lab``: >= 99.5% of values bit-equal to the JAX package's
    compiled planar form, the rest within 1e-4 (|L| <= 100, a few f32
    ulps): libm ``powf`` (the compiled ``cbrt``) is not always correctly
    rounded. The JAX package's own planar and (N, 3) forms differ on 5-12%
    of these values.
  * ``get_weights_planar``: rtol 1e-5 (means, covariance sums, pinv and
    ``exp`` taken in another order or by another library).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patolette_tpu.models import saliency as JS
from patolette_tpu.ops import colorspace as JCS
from patolette_tpu_torch.kernels.mbd import mbd, mbd_plain
from patolette_tpu_torch.models import saliency as TS
from patolette_tpu_torch.ops import colorspace as TCS
from test_torch_cores import share_cores  # noqa: F401


@pytest.mark.parametrize("shape", [(24, 24), (17, 45), (45, 17), (4, 4)])
def test_mbd_matches_jax(shape):
    img = np.random.default_rng(sum(shape)).uniform(0, 1, shape).astype(
        np.float32)
    np.testing.assert_array_equal(mbd(torch.from_numpy(img)).numpy(),
                                  np.asarray(JS.mbd(jnp.asarray(img))))


def test_mbd_bright_centre_and_planes():
    img = np.zeros((32, 32), np.float32)
    img[12:20, 12:20] = 1.0
    d, l, u = mbd(torch.from_numpy(img), return_lu=True)
    assert d[15, 15] > 0.9 and d[2, 2] < 0.1
    assert bool((l <= u).all())
    np.testing.assert_array_equal(d.numpy(),
                                  mbd_plain(torch.from_numpy(img))[0].numpy())


def test_srgb_to_lab_bits():
    x = np.random.default_rng(0).uniform(0, 1, (20000, 3)).astype(np.float32)
    x[:500] *= 0.02  # the linear branch below K_E
    want = np.stack([np.asarray(v) for v in jax.jit(
        lambda a, b, c: JCS.srgb_to_lab((a, b, c)))(
            *(x[:, k] for k in range(3)))], -1)
    got = torch.stack(TCS.srgb_to_lab(
        tuple(torch.from_numpy(x[:, k].copy()) for k in range(3))), -1)
    got = got.numpy()
    assert (got == want).mean() >= 0.995
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    arr = TCS.srgb_to_lab(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(arr, got)


def _salient_image(rows, cols, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:rows, 0:cols].astype(np.float32)
    img = np.stack([0.5 + 0.4 * np.sin(xx / 7.0),
                    0.5 + 0.4 * np.cos(yy / 5.0),
                    rng.uniform(0, 1, (rows, cols))], -1).astype(np.float32)
    img[rows // 3:rows // 2, cols // 3:cols // 2] = [0.9, 0.1, 0.1]
    return img


@pytest.mark.parametrize("shape,tile", [((90, 30), 16.0)])
def test_weights_match_jax(shape, tile):
    img = _salient_image(*shape, seed=shape[0])
    want = np.asarray(JS.get_weights(jnp.asarray(img), tile))
    got = TS.get_weights_planar(
        tuple(torch.from_numpy(img[..., k].reshape(-1).copy())
              for k in range(3)), shape[0], shape[1], tile)
    assert got.shape == (shape[0] * shape[1],) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    assert float(got.min()) >= 1.0


@pytest.mark.parametrize("shape", [(3, 10), (10, 3), (2, 2)])
def test_small_side_gives_none(shape):
    ch = tuple(torch.zeros(shape[0] * shape[1]) for _ in range(3))
    assert TS.get_weights_planar(ch, shape[0], shape[1], 512.0) is None
    assert JS.get_weights(jnp.zeros(shape + (3,)), 512.0) is None

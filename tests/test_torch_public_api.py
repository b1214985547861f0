"""The JAX package's last public functions in the port, against the JAX
package on the same seed-made numpy inputs (the port on the CPU: its
kernels' plain versions).

Tolerances:
  * ``get_weights``: rtol 1e-5 (``test_torch_saliency.py``'s); None where
    a side is <= 3, as in the JAX package.
  * ``mbd``: exact (min, max and a subtraction).
  * ``riemersma_dither``: >= 99.9% of the map against the JAX function
    compiled as one program (``test_torch_hilbert_dither.py``'s), and the
    bits of the port's ``riemersma_dither_planar`` on the same planes.
  * ``cieluv_to_srgb`` and ``ictcp_to_srgb``: 1e-4, the sRGB-valued
    tolerance of ``test_torch_colorspace.py``, in both input forms.
  * ``pca_from_cov``: axis and explained share within 2e-6 (f32: the
    spectrum's arccos and cos come from another libm), on covariances
    whose top eigenvalue stands apart, and exactly on degenerate ones
    (zero, a multiple of the identity, diagonal, below ``delta``).
  * ``xy_to_d`` and ``pad_to_shards``: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patolette_tpu.models import dither as JD
from patolette_tpu.models import saliency as JS
from patolette_tpu.ops import colorspace as JCS
from patolette_tpu.ops import eigen3 as JE
from patolette_tpu.ops import hilbert as JH
from patolette_tpu.parallel import mesh as JM
from patolette_tpu_torch.models import dither as TD
from patolette_tpu_torch.models import pipeline as TP
from patolette_tpu_torch.models import saliency as TS
from patolette_tpu_torch.ops import colorspace as TCS
from patolette_tpu_torch.ops import eigen3 as TE
from patolette_tpu_torch.ops import hilbert as TH
from patolette_tpu_torch.parallel import mesh as TM
from test_torch_cores import share_cores  # noqa: F401


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([0.5 + 0.45 * np.sin(xx / 7.0) * np.cos(yy / 5.0),
                    0.5 + 0.45 * np.cos(xx / 11.0),
                    yy / h + 0.05 * rng.standard_normal((h, w))], axis=-1)
    return np.clip(img, 0, 1).astype(np.float32)


def test_get_weights_against_jax():
    img = _image(40, 56, seed=0)  # rows = H = 40, cols = W = 56
    want = np.asarray(JS.get_weights(jnp.asarray(img), 16.0))
    got = TS.get_weights(img, 16.0, device="cpu")
    assert got.shape == (40 * 56,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    planes = tuple(torch.from_numpy(img[..., k].reshape(-1).copy())
                   for k in range(3))
    assert torch.equal(got, TS.get_weights_planar(planes, 40, 56, 16.0))


@pytest.mark.parametrize("hw", [(3, 20), (20, 3), (2, 2)])
def test_get_weights_none_on_thin_images(hw):
    img = _image(*hw, seed=1)
    assert JS.get_weights(jnp.asarray(img), 16.0) is None
    assert TS.get_weights(img, 16.0, device="cpu") is None


def test_mbd_against_jax():
    img = _image(24, 31, seed=2).mean(-1)
    want = np.asarray(JS.mbd(jnp.asarray(img)))
    got = TS.mbd(img, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("csp", [1, 2])
def test_riemersma_dither_against_jax(csp):
    w, h, k = 56, 40, 12
    rng = np.random.default_rng(3 + csp)
    pal = rng.uniform(0.05, 0.95, (k, 3)).astype(np.float32)
    valid = np.arange(k) != 5
    to_working = jax.jit(lambda a: JCS.srgb_to_working(a, csp))
    xw = np.asarray(to_working(_image(h, w, seed=3).reshape(-1, 3)))
    pw = np.asarray(to_working(pal))
    want = np.asarray(jax.jit(lambda x, p, v: JD.riemersma_dither(
        x, p, v, w, h, csp, segment=256))(xw, pw, valid))
    got = TD.riemersma_dither(xw, pw, valid, w, h, csp, segment=256,
                              device="cpu")
    assert got.dtype == torch.int32 and got.shape == (w * h,)
    assert (got.numpy() == want).mean() >= 0.999
    planar = TD.riemersma_dither_planar(
        tuple(torch.from_numpy(xw[:, i].copy()) for i in range(3)),
        torch.from_numpy(pw.copy()), torch.from_numpy(valid), w, h, csp,
        segment=256)
    assert torch.equal(got, planar)
    assert 5 not in np.unique(got.numpy())


@pytest.mark.parametrize("form", ["planar", "array"])
@pytest.mark.parametrize("name,csp", [("cieluv_to_srgb", 1),
                                      ("ictcp_to_srgb", 2)])
def test_inverse_transforms_against_jax(name, csp, form):
    x = np.random.default_rng(5).uniform(0, 1, (4096, 3)).astype(np.float32)
    w = np.asarray(jax.jit(lambda a: JCS.srgb_to_working(a, csp))(x))
    if form == "planar":
        want = np.stack([np.asarray(c) for c in jax.jit(
            lambda a, b, c: getattr(JCS, name)((a, b, c)))(*w.T)], -1)
        got = torch.stack(getattr(TCS, name)(tuple(w.T), device="cpu"), -1)
    else:
        want = np.asarray(jax.jit(getattr(JCS, name))(w))
        got = getattr(TCS, name)(w, device="cpu")
    assert got.shape == (4096, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def _covariances(n, seed):
    """Covariances whose top eigenvalue stands apart (0.7-1.0 of the
    scale against 0.25-0.45 and 0-0.2), rotated at random."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    lam = np.stack([rng.uniform(0.0, 0.2, n), rng.uniform(0.25, 0.45, n),
                    rng.uniform(0.7, 1.0, n)], -1)
    lam *= 10.0 ** rng.uniform(-3, 3, (n, 1))
    return np.einsum("nij,nj,nkj->nik", q, lam, q).astype(np.float32)


DEGENERATE = np.stack([np.zeros((3, 3)), 2.5 * np.eye(3),
                       np.diag([0.1, 3.0, 0.7]), np.diag([4.0, 4.0, 1.0]),
                       1e-18 * np.eye(3)]).astype(np.float32)


def test_pca_from_cov_against_jax():
    cov = _covariances(4096, seed=6)
    ja, je = (np.asarray(v) for v in jax.jit(JE.pca_from_cov)(cov))
    ta, te = TE.pca_from_cov(cov, device="cpu")
    np.testing.assert_allclose(ta.numpy(), ja, atol=2e-6, rtol=0)
    np.testing.assert_allclose(te.numpy(), je, atol=2e-6, rtol=0)
    ja, je = (np.asarray(v) for v in jax.jit(JE.pca_from_cov)(DEGENERATE))
    ta, te = TE.pca_from_cov(torch.from_numpy(DEGENERATE))
    np.testing.assert_array_equal(ta.numpy(), ja)
    np.testing.assert_array_equal(te.numpy(), je)
    assert te[0] == 0.0 and te[4] == 0.0  # eigenvalue sums <= delta


@pytest.mark.parametrize("order", [1, 5, 16, 17, 20])
def test_xy_to_d_against_jax(order):
    side = 1 << order
    rng = np.random.default_rng(order)
    x = rng.integers(0, side, 4096).astype(np.int64)
    y = rng.integers(0, side, 4096).astype(np.int64)
    want = np.asarray(JH.xy_to_d(jnp.asarray(x), jnp.asarray(y), order))
    got = TH.xy_to_d(x, y, order, device="cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_pad_to_shards():
    for n in (0, 1, 7, 8, 9, 4096, 4097):
        for shards in (1, 2, 3, 4, 8):
            assert TM.pad_to_shards(n, shards) == JM.pad_to_shards(n, shards)


def test_set_sync_stages(monkeypatch):
    synced = []
    real = TP._StageTimer.__init__

    def spy(self, verbose, sync, device):
        synced.append(sync)
        real(self, verbose, sync, device)

    monkeypatch.setattr(TP._StageTimer, "__init__", spy)
    img = _image(16, 24, seed=7).reshape(-1, 3)
    kw = dict(dither=False, tile_size=0, kmeans_niter=0, device="cpu")
    prev = TP.set_sync_stages(True)
    try:
        assert TP.set_sync_stages(True) is True
        ok, _, _, msg = TP.quantize(24, 16, img, 8, **kw)
        assert ok, msg
        assert synced[-1] is True and TP.LAST_STAGE_TIMES
    finally:
        assert TP.set_sync_stages(prev) is True
    TP.set_sync_stages(False)
    try:
        ok, _, _, _ = TP.quantize(24, 16, img, 8, **kw)
        assert ok and synced[-1] is False
    finally:
        TP.set_sync_stages(prev)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    """Numpy input with no card: the typed failure, no quiet CPU run; the
    same call with ``device="cpu"`` runs. A tensor's own device decides,
    and a ``device`` that disagrees with it is an error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = _image(8, 8, seed=8)
    xw = img.reshape(-1, 3)
    calls = {
        "get_weights": lambda **d: TS.get_weights(img, 4.0, **d),
        "mbd": lambda **d: TS.mbd(img[..., 0], **d),
        "riemersma_dither": lambda **d: TD.riemersma_dither(
            xw, xw[:4], np.ones(4, bool), 8, 8, 2, **d),
        "cieluv_to_srgb": lambda **d: TCS.cieluv_to_srgb(xw, **d),
        "ictcp_to_srgb": lambda **d: TCS.ictcp_to_srgb(tuple(xw.T), **d),
        "pca_from_cov": lambda **d: TE.pca_from_cov(DEGENERATE, **d),
        "xy_to_d": lambda **d: TH.xy_to_d(np.arange(4), np.arange(4), 2,
                                          **d),
        "palette_pipeline_device": lambda **d: TP.palette_pipeline_device(
            xw, None, 4, **d),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA device not available"):
            call()
        call(device="cpu")
    with pytest.raises(ValueError, match="not the input's"):
        TCS.cieluv_to_srgb(torch.from_numpy(xw), device="meta")

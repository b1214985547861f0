"""The port's sampled uint8 route (host-drawn samples, palette search on
them, K5 table, host map), and the resident route's uint8 direct map,
against the JAX package's routes on the same inputs.

Both sides run with ``LUT_MIN_PIXELS = 0``, so small images take the LUT
routes, and the JAX package takes its staged routes
(``PATOLETTE_NO_ONE_SHOT``, ``PATOLETTE_NO_FUSED_LUT``) unless a test says
otherwise. ICtCp throughout, so the file builds one grid.

Tolerances:
  * samples in the working space: within the colour transforms' tolerances
    of ``tests/test_torch_colorspace.py`` (sRGB exact, CIELuv 1e-3, ICtCp
    5e-5). The JAX sampled route converts its (M, 3) samples with
    ``jnp.dot``; the port runs one elementwise arithmetic for every form.
  * sampled route against JAX's staged route (the same host draws):
    palette atol 1e-3, map agreement >= 99.9%, the tolerances of
    ``test_torch_pipeline.py::test_large_image_against_jax_staged[0]``; one
    different split would move entries by > 1e-2.
  * sampled against the port's own resident route with no sampling in
    play: identical palette and map (the table is a wire format, not an
    approximation).
  * the port's resident direct map against the JAX resident route's LUT
    branch (saliency, uint8, no dither): as against JAX's staged route.
  * against JAX's default fused route (f32 device GQ DP): palette atol
    2e-3, map >= 99.9%, JAX's own tolerance between its two routes
    (``tests/test_lut.py::test_fast_path_matches_full_path``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import patolette_tpu as jpt
import patolette_tpu_torch as tpt
from patolette_tpu.models import pipeline as JP
from patolette_tpu_torch.models import pipeline as TP
from patolette_tpu_torch.ops import colorspace as TCS
from test_torch_cores import share_cores  # noqa: F401

ICTCP = dict(dither=False, tile_size=0, color_space=tpt.ColorSpace_ICtCp)


@pytest.fixture(autouse=True)
def _lut_routes(monkeypatch):
    monkeypatch.setenv("PATOLETTE_NO_ONE_SHOT", "1")
    monkeypatch.setenv("PATOLETTE_NO_FUSED_LUT", "1")
    monkeypatch.setattr(JP, "LUT_MIN_PIXELS", 0)
    monkeypatch.setattr(TP, "LUT_MIN_PIXELS", 0)


def _port(*args, **kw):
    return tpt.quantize(*args, device="cpu", **kw)


def _large_u8(w=520, h=512, seed=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack(
        [
            0.5 + 0.45 * np.sin(xx / 23.0) * np.cos(yy / 31.0),
            0.5 + 0.45 * np.cos(xx / 41.0 + yy / 57.0),
            np.clip(yy / h + 0.06 * rng.standard_normal((h, w)), 0, 1),
        ],
        axis=-1,
    )
    return np.round(np.clip(img, 0, 1) * 255).reshape(-1, 3).astype(np.uint8)


def _random_u8(n=64 * 64, seed=11):
    return np.random.default_rng(seed).integers(0, 256, size=(n, 3),
                                                dtype=np.uint8)


def _close(pal, pmap, jpal, jmap, atol):
    np.testing.assert_allclose(pal, jpal, atol=atol, rtol=0)
    assert pmap.dtype == np.int32 and pmap.shape == jmap.shape
    assert (pmap == jmap).mean() >= 0.999


@pytest.mark.parametrize("color_space", [0, 1, 2])
def test_sample_working_values_against_jax(color_space):
    sub = _random_u8(1 << 14, seed=5)
    want = np.asarray(JP._to_working(jnp.asarray(sub), color_space))
    got = TCS.srgb_to_working(TP._put(sub, "cpu"), color_space).numpy()
    atol = {0: 0.0, 1: 1e-3, 2: 5e-5}[color_space]
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("p", [64, 24])
def test_sampled_u8_against_jax_staged(p):
    """520x512 = 266,240 px: at p = 64 the KMeans cap equals the LQ
    sample's size and KMeans reuses the LQ sample (S11); at p = 24 the cap
    is 262,128 and KMeans gets a second draw. Both sides draw the same
    pixels from np.random.default_rng(seed)."""
    x = _large_u8()
    kw = dict(ICTCP, kmeans_niter=8)
    ok, pal, pmap, msg = _port(520, 512, x, p, **kw)
    assert ok, msg
    laps = set(TP.LAST_STAGE_TIMES)
    jok, jpal, jmap, jmsg = jpt.quantize(520, 512, x, p, **kw)
    assert jok, jmsg
    assert laps == set(JP.LAST_STAGE_TIMES) == {
        "sample-in", "gq-moments", "gq-dp", "lq", "kmeans", "lut-build",
        "lut-build+pull", "lut-map-host"}
    _close(pal, pmap, jpal, jmap, 1e-3)


@pytest.fixture(scope="module")
def port_64x64():
    """The port's sampled route on a 64x64 uint8 image, p = 17, 4 KMeans
    iterations (nothing sampled: n is under every cap)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP, "LUT_MIN_PIXELS", 0)
        ok, pal, pmap, msg = _port(64, 64, _random_u8(), 17, kmeans_niter=4,
                                   **ICTCP)
        assert ok, msg
        assert "lut-map-host" in TP.LAST_STAGE_TIMES
    return pal, pmap


def test_sampled_matches_resident_without_sampling(port_64x64, monkeypatch):
    monkeypatch.setattr(TP, "LUT_MIN_PIXELS", 1 << 22)
    ok, pal, pmap, msg = _port(64, 64, _random_u8(), 17, kmeans_niter=4,
                               **ICTCP)
    assert ok, msg
    assert "nn-map" in TP.LAST_STAGE_TIMES
    np.testing.assert_array_equal(port_64x64[0], pal)
    np.testing.assert_array_equal(port_64x64[1], pmap)


def test_sampled_against_jax_fused(port_64x64, monkeypatch):
    monkeypatch.delenv("PATOLETTE_NO_FUSED_LUT")
    jok, jpal, jmap, jmsg = jpt.quantize(64, 64, _random_u8(), 17,
                                         kmeans_niter=4, **ICTCP)
    assert jok, jmsg
    assert "palette+lut-build" in JP.LAST_STAGE_TIMES
    _close(*port_64x64, jpal, jmap, 2e-3)


def test_saliency_u8_direct_map_against_jax_lut_branch():
    """Saliency + uint8 + no dither stays on the resident route. The JAX
    package maps it through its 24-bit table (its resident route's LUT
    branch, at LUT_MIN_PIXELS = 0 here); the port maps it with K3 directly.
    The table is exact, so the two maps agree as the routes' palettes do."""
    x = _large_u8(96, 64, seed=4)
    kw = dict(ICTCP, tile_size=256.0, kmeans_niter=2)
    ok, pal, pmap, msg = _port(96, 64, x, 16, **kw)
    assert ok, msg
    assert {"saliency", "nn-map"} <= set(TP.LAST_STAGE_TIMES)
    assert "lut-map-host" not in TP.LAST_STAGE_TIMES
    jok, jpal, jmap, jmsg = jpt.quantize(96, 64, x, 16, **kw)
    assert jok, jmsg
    _close(pal, pmap, jpal, jmap, 1e-3)


def test_palette_only_float_against_jax():
    """palette_only takes the sampled route for any input type."""
    x = _large_u8().astype(np.float64) / 255.0
    kw = dict(ICTCP, kmeans_niter=8, palette_only=True)
    ok, pal, pmap, msg = _port(520, 512, x, 64, **kw)
    assert ok, msg
    assert pmap is None and "sample-in" in TP.LAST_STAGE_TIMES
    jok, jpal, jmap, jmsg = jpt.quantize(520, 512, x, 64, **kw)
    assert jok and jmap is None, jmsg
    np.testing.assert_allclose(pal, jpal, atol=1e-3, rtol=0)


def test_weights_sampled_against_jax():
    """Explicit weights: gathered with both draws (no S11 reuse)."""
    x = _large_u8()
    w = 1.0 + np.random.default_rng(5).random(len(x))
    kw = dict(ICTCP, kmeans_niter=4, weights=w)
    ok, pal, pmap, msg = _port(520, 512, x, 24, **kw)
    assert ok, msg
    assert "lut-map-host" in TP.LAST_STAGE_TIMES
    jok, jpal, jmap, jmsg = jpt.quantize(520, 512, x, 24, **kw)
    assert jok, jmsg
    _close(pal, pmap, jpal, jmap, 1e-3)


def test_route_thresholds_equal_jax(monkeypatch):
    monkeypatch.undo()  # the module's own values
    assert TP.LUT_MIN_PIXELS == JP.LUT_MIN_PIXELS
    assert TP.SAMPLE_MAX == JP.SAMPLE_MAX
    for p in (2, 256, 257, 65536):
        assert TP._lut_min_pixels(p) == JP._lut_min_pixels(p)


def test_u8_undithered_call_needs_no_device_budget(monkeypatch):
    """Only samples, grid and table live on the device, so the device
    budget does not bound the sampled route; a dithered call over the
    budget takes the streamed route instead."""
    monkeypatch.setattr(TP, "_device_budget", lambda device: 0)
    x = _random_u8()
    ok, pal, pmap, msg = _port(64, 64, x, 8, kmeans_niter=2, **ICTCP)
    assert ok, msg
    assert pmap.shape == (64 * 64,) and (pal[pmap] >= 0).all()
    assert "lut-map-host" in TP.LAST_STAGE_TIMES
    ok, pal, pmap, msg = _port(64, 64, x, 8, kmeans_niter=2,
                               **dict(ICTCP, dither=True))
    assert ok, msg
    assert pmap.shape == (64 * 64,) and (pal[pmap] >= 0).all()
    assert {"strip-in", "dither"} <= set(TP.LAST_STAGE_TIMES)

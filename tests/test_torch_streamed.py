"""The port's strip-streamed route against the JAX package's.

96x64 images in strips of 96x16 (``_stream_strip_pixels`` patched in both
packages), pushed onto the streamed route by a zero device budget (the
port) or a 100 kB HBM budget (the JAX package), and, for the dither, by
putting the 4 MP threshold of the strip dither at 0 in both, as
``tests/test_streamed.py`` does.

Tolerances:
  * the undithered map decomposes exactly over strips: the port's strips
    equal its resident map for the same palette, bit for bit;
  * the streamed palette against the JAX package's streamed route (both
    run the palette program with the f32 device GQ DP on the same host
    draws; each side converts the samples with its own arithmetic):
    palette atol 1e-3, map >= 99.9%;
  * the dither against the JAX package's: CIELuv MSE ratio <= 1.01 for the
    whole call (the palettes differ as above); with the same palette, each
    strip's map >= 99.9% equal to JAX's ``riemersma_dither_planar`` /
    ``riemersma_dither_packed_u8`` on that strip (the port reproduces the
    JAX compiled conversions up to libm ``powf``'s last bit, which can move
    a near tie, and the error queue carries a moved tie on).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import patolette_tpu as jpt
import patolette_tpu_torch as tpt
from patolette_tpu.models import dither as JD
from patolette_tpu.models import pipeline as JP
from patolette_tpu_torch.kernels.colorspace import color_convert
from patolette_tpu_torch.models import pipeline as TP
from patolette_tpu_torch.ops import colorspace as TCS
from patolette_tpu_torch.ops.assign import assign_planar
from test_torch_cores import share_cores  # noqa: F401

W, H, STRIP = 96, 64, 16
P = 16
KW = dict(tile_size=0, kmeans_niter=2, lq_max_samples=1024,
          color_space=tpt.ColorSpace_ICtCp)


def _image(seed=2):
    return np.random.default_rng(seed).uniform(0, 1, (W * H, 3))


def _image_u8(seed=2):
    return np.round(_image(seed) * 255.0).astype(np.uint8)


def _port(*args, **kw):
    return tpt.quantize(*args, device="cpu", **kw)


@pytest.fixture
def streamed(monkeypatch):
    """Both packages stream 96x16 strips: dithered calls at any size,
    undithered ones through the budget."""
    for mod in (TP, JP):
        monkeypatch.setattr(mod, "_stream_strip_pixels", lambda n: W * STRIP)
    monkeypatch.setattr(TP, "STRIP_DITHER_MIN_PIXELS", 0)
    monkeypatch.setattr(JP, "ONE_SHOT_MAX_PIXELS", 0)
    monkeypatch.setattr(TP, "_device_budget", lambda device: 0)
    monkeypatch.setattr(JP, "HBM_BUDGET_BYTES", 100_000)
    return monkeypatch


def _luv_mse(colors, pal, pmap):
    x = torch.from_numpy(np.asarray(colors, np.float32))
    if colors.dtype == np.uint8:
        x = x / 255.0
    a = TCS.srgb_to_working(x, 1)
    b = TCS.srgb_to_working(torch.from_numpy(pal.astype(np.float32)), 1)
    return float(((a - b[torch.from_numpy(pmap).long()]) ** 2).sum(-1)
                 .mean())


def _palette(colors, csp=2):
    """The streamed route's working-space palette for ``colors``: its
    palette program on the host-drawn samples."""
    samples = TP._upload_samples(
        colors, P, weights=None, seed=1234, lq_max_samples=1024,
        kmeans_niter=2, kmeans_max_samples=512 ** 2, device="cpu")
    centers, valid, _ = TP._sample_palette_program(
        *samples, p=P, csp=csp, kmeans_niter=2, kmeans_max_samples=512 ** 2,
        seed=1234, lq_batch_splits=8)
    return centers, valid


def _strips(colors):
    for r0 in range(0, H, STRIP):
        yield r0, colors[r0 * W:(r0 + STRIP) * W]


@pytest.mark.parametrize("kind", ["f32", "u8"])
@pytest.mark.parametrize("cs", [1, 2])
def test_strip_map_equals_resident_map(kind, cs):
    """The undithered map is per pixel: strips give the resident route's
    map for the same palette, bit for bit."""
    colors = _image_u8() if kind == "u8" else _image()
    centers, valid = _palette(colors, csp=cs)
    x = TP._put(colors, "cpu")
    # the resident route's chain: sRGB -> working, then working -> ICtCp
    whole = assign_planar(
        TCS.working_to_ictcp(color_convert(x, cs, "working"), cs),
        TCS.working_to_ictcp(centers, cs), valid).numpy()
    parts = [TP._map_strip(TP._put(s, "cpu"), centers, valid, W, STRIP, cs,
                           False, 4096).numpy() for _, s in _strips(colors)]
    np.testing.assert_array_equal(np.concatenate(parts), whole)


@pytest.mark.parametrize("kind", ["f32", "u8"])
def test_streamed_undithered_against_jax(streamed, kind):
    colors = _image_u8() if kind == "u8" else _image()
    ok, pal, pmap, msg = _port(W, H, colors, P, dither=False, **KW)
    assert ok, msg
    assert {"sample-in", "strip-in", "nn-map", "palette-out"} <= set(
        TP.LAST_STAGE_TIMES)
    jok, jpal, jmap, jmsg = jpt.quantize(W, H, colors, P, dither=False, **KW)
    assert jok, jmsg
    assert "palette (device)" in JP.LAST_STAGE_TIMES
    np.testing.assert_allclose(pal, jpal, atol=1e-3, rtol=0)
    assert pmap.dtype == np.int32 and (pmap == jmap).mean() >= 0.999


@pytest.mark.parametrize("kind", ["f32", "u8"])
def test_streamed_dither_against_jax(streamed, kind):
    colors = _image_u8() if kind == "u8" else _image()
    ok, pal, pmap, msg = _port(W, H, colors, P, dither=True, **KW)
    assert ok, msg
    assert {"strip-in", "dither"} <= set(TP.LAST_STAGE_TIMES)
    jok, jpal, jmap, jmsg = jpt.quantize(W, H, colors, P, dither=True, **KW)
    assert jok, jmsg
    ratio = _luv_mse(colors, pal, pmap) / _luv_mse(colors, jpal, jmap)
    assert ratio <= 1.01

    # each strip with the port's palette, against JAX's feed for its type
    centers, valid = _palette(colors)
    cj, vj = jnp.asarray(centers.numpy()), jnp.asarray(valid.numpy())
    for r0, strip in _strips(colors):
        got = TP._map_strip(TP._put(strip, "cpu"), centers, valid, W, STRIP,
                            2, True, 4096).numpy()
        if kind == "u8":
            want = JD.riemersma_dither_packed_u8(
                tuple(jnp.asarray(strip[:, k]) for k in range(3)), cj, vj,
                W, STRIP, 2)
        else:
            chans = tuple(jnp.asarray(strip[:, k], jnp.float32)
                          for k in range(3))
            want = JD.riemersma_dither_planar(
                JP._to_working(chans, 2), cj, vj, W, STRIP, 2)
        assert (got == np.asarray(want)).mean() >= 0.999, r0


@pytest.mark.parametrize("kind", ["f32", "u8"])
def test_seams_restart_each_strip(streamed, kind):
    """Strip k of the streamed map is strip k dithered alone (its own
    curve, a fresh queue); the whole image along one curve differs."""
    colors = _image_u8() if kind == "u8" else _image()
    ok, _, pmap, msg = _port(W, H, colors, P, dither=True, **KW)
    assert ok, msg
    centers, valid = _palette(colors)
    for r0, strip in _strips(colors):
        alone = TP._map_strip(TP._put(strip, "cpu"), centers, valid, W,
                              STRIP, 2, True, 4096).numpy()
        np.testing.assert_array_equal(pmap[r0 * W:(r0 + STRIP) * W], alone)
    whole = TP._map_strip(TP._put(colors, "cpu"), centers, valid, W, H, 2,
                          True, 4096).numpy()
    assert not np.array_equal(pmap, whole)


@pytest.mark.parametrize("kw,needle", [
    (dict(tile_size=512.0), "saliency"),
    (dict(tile_size=0, lq_max_samples=0), "lq_max_samples"),
])
def test_over_budget_fails_typed(streamed, kw, needle):
    ok, pal, pmap, msg = _port(W, H, _image(), P, dither=False,
                               kmeans_niter=0, **kw)
    assert ok is False and pal is None and pmap is None
    assert msg.startswith("Internal quantization error.")
    assert needle in msg and "device budget" in msg


def _resident_fails(monkeypatch, exc):
    """The resident route raises ``exc``; a 96x64 image reaches it only
    with the one-shot route off."""
    monkeypatch.setenv("PATOLETTE_NO_ONE_SHOT", "1")
    calls = []

    def fail(*args, **kw):
        calls.append(1)
        raise exc

    monkeypatch.setattr(TP, "_quantize_resident", fail)
    return calls


def test_oom_retries_streamed(streamed, monkeypatch):
    """A device OOM on the resident route (under the budget) retries on
    the streamed route, which gives the streamed call's result."""
    colors = _image()
    ok, pal, pmap, msg = _port(W, H, colors, P, dither=False, **KW)
    assert ok, msg
    monkeypatch.setattr(TP, "_device_budget", lambda device: 1 << 62)
    calls = _resident_fails(monkeypatch, torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 MiB"))
    ok2, pal2, pmap2, msg2 = _port(W, H, colors, P, dither=False, **KW)
    assert ok2, msg2
    assert calls == [1] and "strip-in" in TP.LAST_STAGE_TIMES
    np.testing.assert_array_equal(pal, pal2)
    np.testing.assert_array_equal(pmap, pmap2)
    # an allocator failure that is only a RuntimeError counts too
    _resident_fails(monkeypatch, RuntimeError("CUDA error: out of memory"))
    assert _port(W, H, colors, P, dither=False, **KW)[0]
    # with saliency there is no streamed equivalent: typed -1
    _resident_fails(monkeypatch, torch.cuda.OutOfMemoryError("out of memory"))
    ok, _, _, msg = _port(W, H, colors, P, dither=False,
                          **dict(KW, tile_size=512.0))
    assert ok is False and "OutOfMemoryError" in msg


def test_other_resident_error_stays_typed(monkeypatch):
    calls = _resident_fails(monkeypatch, RuntimeError("injected failure"))
    ok, pal, pmap, msg = _port(W, H, _image(), P, dither=False, **KW)
    assert ok is False and pal is None and pmap is None and calls == [1]
    assert msg.startswith("Internal quantization error.")
    assert "injected failure" in msg


@pytest.mark.parametrize("tile_size,route", [(0, "strip-in"),
                                             (512.0, "saliency")])
def test_dither_above_threshold_routing(monkeypatch, tile_size, route):
    """Above the threshold a dithered call without saliency streams; with
    saliency it stays resident (its weights need the whole image). At the
    threshold itself it stays resident."""
    monkeypatch.setattr(TP, "_stream_strip_pixels", lambda n: W * STRIP)
    monkeypatch.setattr(TP, "STRIP_DITHER_MIN_PIXELS", W * H - 1)
    ok, _, _, msg = _port(W, H, _image(), P, dither=True,
                          **dict(KW, tile_size=tile_size))
    assert ok, msg
    assert route in TP.LAST_STAGE_TIMES
    if route == "saliency":
        assert "strip-in" not in TP.LAST_STAGE_TIMES
    monkeypatch.setattr(TP, "STRIP_DITHER_MIN_PIXELS", W * H)
    ok, _, _, msg = _port(W, H, _image(), P, dither=True, **KW)
    assert ok, msg
    assert "strip-in" not in TP.LAST_STAGE_TIMES


def test_strip_constants_equal_jax():
    """Strip size and the dither threshold are semantics: the JAX
    package's values."""
    assert TP.STREAM_STRIP_MIN == JP.STREAM_STRIP_MIN
    assert TP.STREAM_STRIP_MAX == JP.STREAM_STRIP_MAX
    assert TP.STRIP_DITHER_MIN_PIXELS == JP.ONE_SHOT_MAX_PIXELS
    for n in (1, 1 << 20, 3840 * 2160, 7680 * 4320, 10 ** 8, 40000 ** 2):
        assert TP._stream_strip_pixels(n) == JP._stream_strip_pixels(n)

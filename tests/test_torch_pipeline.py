"""End-to-end ``patolette_tpu_torch.quantize`` on the CPU (the kernels'
plain versions), against the goldens and the JAX package's staged route.

Tolerances:
  * goldens: identical palette-map histograms. Palette atol 5e-5 in sRGB
    for ``cieluv_plain``. For ``ictcp_kmeans8`` the port's centres agree
    with the JAX package's to ~2 f32 ulps (different summation order), but
    entry 12 sits where the ICtCp -> sRGB curve (PQ EOTF next to its C1
    offset) multiplies that by ~2500: the JAX package's own eager and
    compiled conversions of the SAME centres differ by 6.2e-5 there. So that
    palette is held at 5e-5 in ICtCp (its working space) and at 1e-4 in
    sRGB.
  * 520x512, p = 64, no KMeans (the LQ sample is the same pixels on both
    sides): palette atol 1e-3, map agreement >= 99.9%; one different split
    would move entries by > 1e-2.
  * with KMeans the sample draws differ by design (host numpy draw vs
    ``jax.random``): CIELuv MSE ratio port / JAX <= 1.01. The same ratio
    holds the default call (saliency, dither, 32 KMeans iterations).
  * goldens ``ictcp_dither`` and ``srgb_saliency``: identical histograms,
    palette atol 5e-5 (the golden's own; measured 5.7e-7 and 3.6e-7).
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import patolette_tpu as jpt
import patolette_tpu_torch as tpt
from patolette_tpu.ops import colorspace as JCS
from patolette_tpu_torch.models import pipeline as TP
from patolette_tpu_torch.utils import errors
from patolette_tpu_torch.utils.carry import options_from_fields
from test_torch_cores import share_cores  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN_PATH = REPO / "tests" / "golden" / "quantize_golden.npz"


def _golden_image(w=96, h=64, seed=11):
    """The input of tests/test_golden.py."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack(
        [
            0.5 + 0.45 * np.sin(xx / 9.0) * np.cos(yy / 13.0),
            0.5 + 0.45 * np.cos(xx / 17.0),
            np.clip(yy / h + 0.08 * rng.standard_normal((h, w)), 0, 1),
        ],
        axis=-1,
    )
    return np.clip(img, 0, 1).reshape(-1, 3)


def _posterized_image(w=64, h=64, k=5, seed=0):
    rng = np.random.default_rng(seed)
    palette = rng.uniform(0.05, 0.95, size=(k, 3))
    idx = rng.integers(0, k, size=(h * w))
    return palette[idx], palette, idx


def _large_image(w=520, h=512, seed=3):
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
    return np.clip(img, 0, 1).reshape(-1, 3)


def _mse_luv(colors, palette, pmap):
    a = np.asarray(JCS.srgb_to_cieluv(colors))
    b = np.asarray(JCS.srgb_to_cieluv(palette))[pmap]
    return float(((a - b) ** 2).sum(-1).mean())


def _port(*args, **kw):
    return tpt.quantize(*args, device="cpu", **kw)


GOLDENS = {
    "cieluv_plain": (32, dict(dither=False, tile_size=0, kmeans_niter=0,
                              color_space=tpt.ColorSpace_CIELuv), 5e-5),
    "ictcp_kmeans8": (24, dict(dither=False, tile_size=0, kmeans_niter=8,
                               color_space=tpt.ColorSpace_ICtCp), 1e-4),
    "srgb_saliency": (16, dict(dither=False, tile_size=256, kmeans_niter=0,
                               color_space=tpt.ColorSpace_sRGB), 5e-5),
    "ictcp_dither": (16, dict(dither=True, tile_size=0, kmeans_niter=4,
                              color_space=tpt.ColorSpace_ICtCp), 5e-5),
}


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_golden_palette(name):
    golden = np.load(GOLDEN_PATH)
    p, kw, srgb_atol = GOLDENS[name]
    ok, pal, pmap, msg = _port(96, 64, _golden_image(), p, **kw)
    assert ok, msg
    expect = golden[f"{name}__palette"]
    np.testing.assert_array_equal(np.bincount(pmap, minlength=p),
                                  golden[f"{name}__hist"])
    np.testing.assert_allclose(pal, expect, atol=srgb_atol, rtol=0)
    if name == "ictcp_kmeans8":
        used = expect[:, 0] >= 0
        np.testing.assert_array_equal(pal[:, 0] >= 0, used)
        np.testing.assert_allclose(
            np.asarray(JCS.srgb_to_ictcp(jnp.asarray(pal[used]))),
            np.asarray(JCS.srgb_to_ictcp(jnp.asarray(expect[used]))),
            atol=5e-5, rtol=0,
        )


class TestValidation:
    def test_bad_channels(self):
        ok, _, _, msg = _port(2, 2, np.zeros((4, 4)), 4)
        assert not ok and "Channel count" in msg

    def test_count_mismatch(self):
        ok, _, _, msg = _port(2, 2, np.zeros((5, 3)), 4)
        assert not ok and "doesn't match" in msg

    def test_bad_dims(self):
        ok, _, _, msg = _port(0, 2, np.zeros((0, 3)), 4)
        assert not ok and "greater than 0" in msg and "Internal" not in msg

    def test_bad_palette(self):
        ok, _, _, msg = _port(2, 2, np.zeros((4, 3)), 0)
        assert not ok and "Palette size" in msg

    def test_bad_tile_size(self):
        ok, _, _, msg = _port(2, 2, np.zeros((4, 3)), 2, tile_size=-1.0)
        assert not ok and "tile_size" in msg

    def test_internal_error_returns_bad_quant(self, monkeypatch):
        def boom(*a, **kw):
            raise RuntimeError("injected device failure")

        monkeypatch.setattr(TP, "_gq_bucket_stage", boom)
        colors, _, _ = _posterized_image()
        ok, pal, pmap, msg = _port(64, 64, colors, 8, dither=False,
                                   tile_size=0, kmeans_niter=0)
        assert ok is False and pal is None and pmap is None
        assert msg.startswith(
            errors.exit_code_message(errors.ExitCode.BAD_QUANT))
        assert "injected device failure" in msg

    @pytest.mark.parametrize("kw,needle", [
        (dict(dither=False, tile_size=0, mesh=object()), "mesh"),
        (dict(dither=True, tile_size=512.0), "device budget"),
    ])
    def test_uncovered_calls_fail_typed(self, kw, needle, monkeypatch):
        if needle == "device budget":
            monkeypatch.setattr(TP, "_device_budget", lambda device: 0)
        colors, _, _ = _posterized_image()
        ok, pal, pmap, msg = _port(64, 64, colors, 8, **kw)
        assert ok is False and pal is None and pmap is None
        assert msg.startswith("Internal quantization error.")
        assert needle in msg

    @pytest.mark.parametrize("kw,stage", [
        (dict(dither=True, tile_size=0), "dither"),
        (dict(dither=False, tile_size=512.0), "saliency"),
    ])
    def test_dither_and_saliency_calls_succeed(self, kw, stage):
        """The two calls the first slice refused now run."""
        colors, _, _ = _posterized_image()
        ok, pal, pmap, msg = _port(64, 64, colors, 8, kmeans_niter=2, **kw)
        assert ok, msg
        assert pmap.shape == (64 * 64,) and pmap.dtype == np.int32
        assert (pal[pmap] >= 0).all()
        assert stage in TP.LAST_STAGE_TIMES

    def test_default_device_is_cuda(self, monkeypatch):
        """With no CUDA device the default call fails typed; it never
        falls back to the CPU on its own."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        colors, _, _ = _posterized_image()
        ok, pal, pmap, msg = tpt.quantize(64, 64, colors, 8, dither=False,
                                          tile_size=0, kmeans_niter=0)
        assert ok is False and pal is None and pmap is None
        assert "RuntimeError: CUDA device not available" in msg


class TestExactRecovery:
    @pytest.mark.parametrize("space", [
        tpt.ColorSpace_sRGB, tpt.ColorSpace_CIELuv, tpt.ColorSpace_ICtCp
    ])
    def test_posterized_all_spaces(self, space):
        colors, true_pal, idx = _posterized_image(k=5)
        ok, pal, pmap, msg = _port(64, 64, colors, 8, dither=False,
                                   color_space=space, tile_size=0,
                                   kmeans_niter=0)
        assert ok, msg
        used = pal[pal[:, 0] >= 0]
        assert len(used) == 5
        for c in true_pal:
            assert np.min(np.abs(used - c).sum(-1)) < 5e-3
        np.testing.assert_allclose(pal[pmap], colors, atol=5e-3)
        assert pmap.dtype == np.int32 and pmap.shape == (64 * 64,)

    def test_palette_only(self):
        colors, _, _ = _posterized_image()
        ok, pal, pmap, _ = _port(64, 64, colors, 8, palette_only=True,
                                 tile_size=0, kmeans_niter=0, dither=False)
        assert ok and pmap is None and pal.shape == (8, 3)

    def test_unused_fill(self):
        colors, _, _ = _posterized_image(k=3)
        ok, pal, _, _ = _port(64, 64, colors, 16, dither=False, tile_size=0,
                              kmeans_niter=0)
        assert ok
        assert np.all(pal[(pal[:, 0] < 0)] == -1.0)
        assert (pal[:, 0] >= 0).sum() == 3


def test_uint8_input_matches_jax_staged(monkeypatch):
    """uint8 is normalised on the device and takes the direct map."""
    monkeypatch.setenv("PATOLETTE_NO_ONE_SHOT", "1")
    colors = np.round(_golden_image() * 255).astype(np.uint8)
    kw = dict(dither=False, tile_size=0, kmeans_niter=0,
              color_space=tpt.ColorSpace_CIELuv)
    ok, pal, pmap, msg = _port(96, 64, colors, 32, **kw)
    assert ok, msg
    _, jpal, jmap, _ = jpt.quantize(96, 64, colors, 32, **kw)
    np.testing.assert_allclose(pal, jpal, atol=5e-5, rtol=0)
    np.testing.assert_array_equal(np.bincount(pmap, minlength=32),
                                  np.bincount(jmap, minlength=32))


def test_quantize_options_from_jax_fields():
    fields = dataclasses.asdict(jpt.QuantizeOptions(
        dither=False, tile_size=0, kmeans_niter=2, color_space=1, seed=7))
    opts = options_from_fields(fields)
    assert opts == tpt.QuantizeOptions(
        dither=False, tile_size=0, kmeans_niter=2,
        color_space=tpt.ColorSpace_CIELuv, seed=7)
    colors, _, _ = _posterized_image(k=4)
    ok, pal, pmap, msg = tpt.quantize_options(64, 64, colors, 8, opts,
                                              device="cpu")
    assert ok, msg
    assert (pal[:, 0] >= 0).sum() == 4
    with pytest.raises(ValueError):
        options_from_fields(dict(fields, mesh_axis="x"))


@pytest.mark.parametrize("niter", [0, 8])
def test_large_image_against_jax_staged(monkeypatch, niter):
    """520x512 = 266,240 px, above the 2^18 LQ cap: both sides draw the
    same LQ sample from np.random.default_rng(seed)."""
    monkeypatch.setenv("PATOLETTE_NO_ONE_SHOT", "1")
    x = _large_image()
    kw = dict(dither=False, tile_size=0, kmeans_niter=niter,
              color_space=tpt.ColorSpace_ICtCp)
    ok, pal, pmap, msg = _port(520, 512, x, 64, **kw)
    assert ok, msg
    jok, jpal, jmap, jmsg = jpt.quantize(520, 512, x, 64, **kw)
    assert jok, jmsg
    if niter == 0:
        np.testing.assert_allclose(pal, jpal, atol=1e-3, rtol=0)
        assert (pmap == jmap).mean() >= 0.999
    else:
        assert _mse_luv(x, pal, pmap) / _mse_luv(x, jpal, jmap) <= 1.01


def test_default_call_against_jax_staged(monkeypatch):
    """The library's default call (saliency weights, Riemersma dither, 32
    KMeans iterations, ICtCp) at 520x512, against the JAX staged route."""
    monkeypatch.setenv("PATOLETTE_NO_ONE_SHOT", "1")
    x = _large_image()
    ok, pal, pmap, msg = _port(520, 512, x, 64)
    assert ok, msg
    assert {"saliency", "dither"} <= set(TP.LAST_STAGE_TIMES)
    jok, jpal, jmap, jmsg = jpt.quantize(520, 512, x, 64)
    assert jok, jmsg
    assert _mse_luv(x, pal, pmap) / _mse_luv(x, jpal, jmap) <= 1.01


def test_import_leaves_jax_out():
    code = ("import sys, patolette_tpu_torch; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('patolette_tpu.') or "
            "m == 'patolette_tpu']; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_stage_times_recorded(monkeypatch):
    """The one-shot route's laps by default, the resident route's stages
    under PATOLETTE_NO_ONE_SHOT."""
    colors, _, _ = _posterized_image()
    ok, *_ = _port(64, 64, colors, 8, dither=False, tile_size=0,
                   kmeans_niter=2)
    assert ok
    assert {"stage-in", "palette", "nn-map", "one-shot"} <= set(
        TP.LAST_STAGE_TIMES)
    monkeypatch.setenv("PATOLETTE_NO_ONE_SHOT", "1")
    ok, *_ = _port(64, 64, colors, 8, dither=False, tile_size=0,
                   kmeans_niter=2)
    assert ok
    assert {"gq-moments", "gq-dp", "lq", "kmeans", "nn-map"} <= set(
        TP.LAST_STAGE_TIMES)

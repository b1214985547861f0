"""The port against the JAX package's default route for small images.

For n <= 2^22 pixels, with no mesh and off the sampled route, both
packages run their one-shot route (``_quantize_one_shot``): saliency, the
working space, device draws of the LQ and KMeans samples, the f32 device
GQ DP (the port's K11), LQ with its control on the device, KMeans, and
the dither or the direct map. The draws differ by design: ``jax.random``
against the port's ``torch.Generator`` seeded from ``(seed, stream)``
(README T6). These tests run with no routing variable set, on the 520x512
image of ``test_torch_pipeline.py::test_large_image_against_jax_staged``
(266,240 px, above the 2^18 LQ cap, so both sides draw).

Bound, the T1 bound: port / JAX one-shot CIELuv MSE of ``palette[map]``
against the image <= 1.01 for the two undithered calls (``dither=False,
tile_size=0``, ICtCp, 64 colours, ``kmeans_niter`` 0 and 8) and for the
library's default call (saliency, dither). Readings with the suite's
settings (x64): 0.9942, 1.0065 and 1.0061. Before the port had its
one-shot route (resident route, numpy draws, host f64 DP) they were
1.0002, 1.0062 and 1.0253, and the default call was held only at <= 1.05
and at <= 1.01 x the JAX package's own staged / one-shot ratio.
"""

import numpy as np
import pytest

import patolette_tpu as jpt
import patolette_tpu_torch as tpt
from patolette_tpu.models import pipeline as JP
from patolette_tpu.ops import colorspace as JCS
from patolette_tpu_torch.models import pipeline as TP
from test_torch_cores import share_cores  # noqa: F401

W, H, P = 520, 512, 64


def _large_image(w=W, h=H, seed=3):
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


@pytest.fixture(autouse=True)
def _default_routing(monkeypatch):
    for name in ("PATOLETTE_NO_ONE_SHOT", "PATOLETTE_NO_FUSED_LUT",
                 "PATOLETTE_FUSED_IMAGE_LUT"):
        monkeypatch.delenv(name, raising=False)


def _jax_one_shot(x, **kw):
    ok, pal, pmap, msg = jpt.quantize(W, H, x, P, **kw)
    assert ok, msg
    assert "one-shot" in JP.LAST_STAGE_TIMES, JP.LAST_STAGE_TIMES
    return _mse_luv(x, pal, pmap)


def _port(x, **kw):
    ok, pal, pmap, msg = tpt.quantize(W, H, x, P, device="cpu", **kw)
    assert ok, msg
    assert "one-shot" in TP.LAST_STAGE_TIMES, TP.LAST_STAGE_TIMES
    return _mse_luv(x, pal, pmap)


@pytest.mark.parametrize("niter", [0, 8])
def test_undithered_against_jax_one_shot(niter):
    x = _large_image()
    kw = dict(dither=False, tile_size=0, kmeans_niter=niter,
              color_space=tpt.ColorSpace_ICtCp)
    assert _port(x, **kw) / _jax_one_shot(x, **kw) <= 1.01


def test_default_call_against_jax_one_shot():
    x = _large_image()
    port = _port(x)
    assert {"saliency", "dither", "one-shot"} <= set(TP.LAST_STAGE_TIMES)
    assert port / _jax_one_shot(x) <= 1.01

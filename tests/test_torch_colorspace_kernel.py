"""K10's wrapper (``patolette_tpu_torch.kernels.colorspace.color_convert``)
on the CPU, where it runs its plain version, against the JAX package's
compiled composites on the same inputs, for every input kind and target.

Tolerances are those of ``tests/test_torch_colorspace.py``, absolute, at
each output's scale: sRGB-space working values exact; ICtCp-valued 5e-5
(libm ``powf`` is not always correctly rounded and the PQ curve's
exponent, 78.84, turns a last-bit difference into ~1e-5); CIELuv- and
CIELAB-valued (|v| up to ~175) 1e-3; linear Rec2020 (values in about
[-0.1, 1.1]) 1e-4, as sRGB-valued outputs through the inverse curves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patolette_tpu.ops import colorspace as J
from patolette_tpu.ops import lut as JL
from patolette_tpu_torch import kernels
from patolette_tpu_torch.kernels.colorspace import (TARGETS, color_convert,
                                                    color_convert_plain)
from patolette_tpu_torch.models import pipeline as TP
from patolette_tpu_torch.ops import colorspace as T
from test_torch_cores import share_cores  # noqa: F401

SPACES = (0, 1, 2)
INV255 = np.float32(1.0 / 255.0)
WORKING_ATOL = {0: 0.0, 1: 1e-3, 2: 5e-5}
REC2020_ATOL = 1e-4


def _pixels_u8(n=4096, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 3),
                                                dtype=np.uint8)


def _pixels_f32(n=4096, seed=1):
    return np.random.default_rng(seed).uniform(0, 1, (n, 3)).astype(
        np.float32)


def _jax_target(target, cs):
    """The JAX composite chain of a K10 target, on planar f32 channels."""
    def working(x):
        return J.srgb_to_working(x, cs)

    return {
        "working": working,
        "ictcp": lambda x: J.working_to_ictcp(working(x), cs),
        "rec2020": lambda x: J.working_to_linear_rec2020(working(x), cs),
        "rec2020_direct": J.srgb_to_linear_rec2020,
        "lab": J.srgb_to_lab,
        "working_to_ictcp": lambda x: J.working_to_ictcp(x, cs),
        "working_to_rec2020": lambda x: J.working_to_linear_rec2020(x, cs),
    }[target]


def _jax(target, cs, planes):
    f = jax.jit(lambda a, b, c: _jax_target(target, cs)((a, b, c)))
    return np.stack([np.asarray(v, np.float32) for v in f(*planes)], -1)


def _atol(target, cs):
    if target in ("working", "working_to_ictcp", "ictcp"):
        return 5e-5 if target != "working" else WORKING_ATOL[cs]
    if target == "lab":
        return 1e-3
    return REC2020_ATOL


def _inputs(kind):
    """(port input, the sRGB f32 planes the JAX side sees)."""
    if kind == "u8":
        x = _pixels_u8()
        f = x.astype(np.float32) * INV255
        return torch.from_numpy(x), tuple(f[:, k] for k in range(3))
    if kind == "codes":
        px = _pixels_u8(seed=2).astype(np.int32)
        codes = (px[:, 0] << 16) | (px[:, 1] << 8) | px[:, 2]
        f = px.astype(np.float32) * INV255
        return torch.from_numpy(codes), tuple(f[:, k] for k in range(3))
    x = _pixels_f32()
    planes = tuple(x[:, k].copy() for k in range(3))
    if kind == "f32x3":
        return torch.from_numpy(x), planes
    return tuple(torch.from_numpy(p) for p in planes), planes


def _port(x, cs, target):
    out = color_convert(x, cs, target)
    assert len(out) == 3
    assert all(o.dtype == torch.float32 and o.dim() == 1
               and o.is_contiguous() for o in out)
    return torch.stack(out, -1).numpy()


@pytest.mark.parametrize("cs", SPACES)
@pytest.mark.parametrize("kind", ["f32", "f32x3", "u8", "codes"])
@pytest.mark.parametrize("target", ["working", "ictcp", "rec2020",
                                    "rec2020_direct", "lab"])
def test_srgb_targets_against_jax(target, kind, cs):
    x, planes = _inputs(kind)
    np.testing.assert_allclose(_port(x, cs, target),
                               _jax(target, cs, planes),
                               atol=_atol(target, cs), rtol=0)


@pytest.mark.parametrize("cs", SPACES)
@pytest.mark.parametrize("target", ["working_to_ictcp",
                                    "working_to_rec2020"])
def test_working_targets_against_jax(target, cs):
    """From the working space: each space's working values of random
    pixels, as the JAX package computes them."""
    w = _jax("working", cs, tuple(_pixels_f32(seed=3)[:, k]
                                  for k in range(3)))
    planes = tuple(w[:, k].copy() for k in range(3))
    np.testing.assert_allclose(
        _port(tuple(torch.from_numpy(p) for p in planes), cs, target),
        _jax(target, cs, planes), atol=_atol(target, cs), rtol=0)


@pytest.mark.parametrize("cs", SPACES)
def test_codes_and_u8_against_jax_codes_to_ictcp(cs):
    """The LUT grid's staging: the JAX package's ``_codes_to_ictcp`` of
    the codes, against K10's codes input and the same colours as (N, 3)
    uint8 pixels (which must agree with each other exactly)."""
    codes = np.arange(0, 1 << 24, 97, dtype=np.int32)
    want = np.stack([np.asarray(v, np.float32) for v in jax.jit(
        lambda c: JL._codes_to_ictcp(c, cs))(jnp.asarray(codes))], -1)
    got = _port(torch.from_numpy(codes), cs, "ictcp")
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)
    px = np.stack([(codes >> s) & 0xFF for s in (16, 8, 0)], 1).astype(
        np.uint8)
    np.testing.assert_array_equal(_port(torch.from_numpy(px), cs, "ictcp"),
                                  got)


def test_direct_u8_chain_against_jax_packed_feed():
    """The packed uint8 dither feed converts bytes straight to linear
    Rec2020 (dither.py:228-233): the same arithmetic as inside JAX's
    ``riemersma_dither_packed_u8``."""
    x = _pixels_u8(seed=4)

    @jax.jit
    def feed(r, g, b):
        s = jnp.float32(1.0 / 255.0)
        return J.srgb_to_linear_rec2020(
            tuple(c.astype(jnp.float32) * s for c in (r, g, b)))

    want = np.stack([np.asarray(v) for v in feed(
        *(jnp.asarray(x[:, k]) for k in range(3)))], -1)
    got = _port(torch.from_numpy(x), 0, "rec2020_direct")
    np.testing.assert_allclose(got, want, atol=REC2020_ATOL, rtol=0)


@pytest.mark.parametrize("cs", SPACES)
@pytest.mark.parametrize("target", sorted(set(TARGETS) - {
    "working_to_ictcp", "working_to_rec2020"}))
def test_fused_u8_normalisation_is_put_then_glue(target, cs):
    """K10's uint8 input equals, bit for bit, the pixels normalised as the
    upload did before K10 (``x.to(f32) * f32(1/255)``) and sent through
    the glue."""
    x = torch.from_numpy(_pixels_u8(seed=5))
    f = x.to(torch.float32) * INV255
    want = color_convert_plain(tuple(f[:, k] for k in range(3)), cs, target)
    got = color_convert(x, cs, target)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_pipeline_upload_keeps_bytes():
    """The upload no longer normalises: the bytes go up as they are and
    K10 normalises them as it converts."""
    x = _pixels_u8(n=64, seed=6)
    up = TP._put(x, "cpu")
    assert up.dtype == torch.uint8 and np.array_equal(up.numpy(), x)
    f32 = TP._put(x.astype(np.float64) / 255.0, "cpu")
    assert f32.dtype == torch.float32 and f32.shape == (64, 3)


def test_composites_route_through_the_wrapper(monkeypatch):
    """The public composites call K10's wrapper (here its plain version),
    keep the form they were given, and count no launch on the CPU."""
    calls = []

    def spy(x, cs, target):
        calls.append(target)
        return color_convert_plain(x, cs, target)

    monkeypatch.setattr("patolette_tpu_torch.kernels.colorspace."
                        "color_convert", spy)
    kernels.reset_launches()
    x = torch.from_numpy(_pixels_f32(n=256, seed=7))
    planes = tuple(x[:, k].contiguous() for k in range(3))
    assert T.srgb_to_working(x, 2).shape == (256, 3)
    assert len(T.working_to_ictcp(planes, 1)) == 3
    assert T.working_to_linear_rec2020(x, 0).shape == (256, 3)
    assert T.srgb_to_linear_rec2020(planes)[0].shape == (256,)
    lab = T.srgb_to_lab(tuple(p.reshape(16, 16) for p in planes))
    assert lab[0].shape == (16, 16)
    assert calls == ["working", "working_to_ictcp", "working_to_rec2020",
                     "rec2020_direct", "lab"]
    # identities stay identities
    assert T.srgb_to_working(x, 0) is x and T.working_to_ictcp(x, 2) is x
    assert kernels.LAUNCHES["color_convert"] == 0


def test_unknown_target_raises():
    with pytest.raises(ValueError, match="unknown target"):
        color_convert(torch.zeros((4, 3)), 2, "hsv")

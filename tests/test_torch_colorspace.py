"""Port colorspace (patolette_tpu_torch.ops.colorspace) against the JAX
package on the same inputs, both compiled forms of JAX (planar tuple and
(N, 3) array).

Tolerances are absolute, at each output's scale:
  * ICtCp-valued outputs (|v| < 1): 5e-5. The port matches the JAX
    package's compiled arithmetic op for op except libm ``powf``, which is
    not always correctly rounded; the PQ curve's exponent (78.84) turns
    that last-bit difference into ~1e-5 here.
  * sRGB-valued outputs ([0, 1]): 1e-4, for the same reason through the
    inverse curve.
  * CIELuv-valued outputs (|v| up to ~175, f32 ulp there 1.5e-5): 1e-3.
"""

import jax
import numpy as np
import pytest
import torch

from patolette_tpu.ops import colorspace as J
from patolette_tpu_torch.ops import colorspace as T
from test_torch_cores import share_cores  # noqa: F401

SPACES = {0: "sRGB", 1: "CIELuv", 2: "ICtCp"}
WORKING_ATOL = {0: 0.0, 1: 1e-3, 2: 5e-5}


def _colors(n=4096, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, 3)).astype(
        np.float32)


def _jax(fn, x, cs, form):
    if form == "planar":
        out = jax.jit(lambda a, b, c: fn((a, b, c), cs))(
            *(x[:, k] for k in range(3)))
        return np.stack([np.asarray(v, np.float32) for v in out], -1)
    return np.asarray(jax.jit(lambda a: fn(a, cs))(x), np.float32)


def _port(fn, x, cs, form):
    if form == "planar":
        out = fn(tuple(torch.from_numpy(x[:, k].copy()) for k in range(3)),
                 cs)
        assert isinstance(out, tuple) and len(out) == 3
        return torch.stack(out, -1).numpy()
    out = fn(torch.from_numpy(x.copy()), cs)
    assert out.shape == x.shape and out.dtype == torch.float32
    return out.numpy()


@pytest.mark.parametrize("form", ["planar", "array"])
@pytest.mark.parametrize("cs", sorted(SPACES))
def test_srgb_to_working(cs, form):
    x = _colors()
    np.testing.assert_allclose(
        _port(T.srgb_to_working, x, cs, form),
        _jax(J.srgb_to_working, x, cs, form),
        atol=WORKING_ATOL[cs], rtol=0,
    )


@pytest.mark.parametrize("form", ["planar", "array"])
@pytest.mark.parametrize("cs", sorted(SPACES))
def test_working_to_ictcp(cs, form):
    w = _jax(J.srgb_to_working, _colors(seed=1), cs, "planar")
    np.testing.assert_allclose(
        _port(T.working_to_ictcp, w, cs, form),
        _jax(J.working_to_ictcp, w, cs, form),
        atol=5e-5, rtol=0,
    )


@pytest.mark.parametrize("form", ["planar", "array"])
@pytest.mark.parametrize("cs", sorted(SPACES))
def test_working_to_srgb(cs, form):
    w = _jax(J.srgb_to_working, _colors(seed=2), cs, "planar")
    np.testing.assert_allclose(
        _port(T.working_to_srgb, w, cs, form),
        _jax(J.working_to_srgb, w, cs, form),
        atol=1e-4, rtol=0,
    )


def test_planar_and_array_forms_agree_exactly():
    """The port runs one arithmetic for both forms (on every device)."""
    x = _colors(seed=3)
    for cs in SPACES:
        np.testing.assert_array_equal(
            _port(T.srgb_to_working, x, cs, "planar"),
            _port(T.srgb_to_working, x, cs, "array"),
        )

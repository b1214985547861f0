"""K10: the colour-transform composites in one elementwise pass.

Kernel: ``csrc/colorspace.cu``. Twin: the port's torch glue in
``ops/colorspace.py``, which is op for op the JAX package's compiled
arithmetic of ``srgb_to_working`` (``colorspace.py:353``),
``working_to_ictcp`` (``:376``), ``working_to_linear_rec2020`` (``:365``),
``srgb_to_lab`` (``:329``) and ``srgb_to_linear_rec2020`` (``:301``), fed
as the pipeline's upload (``_put``), the LUT grid's codes
(``_codes_to_ictcp``) and the packed dither feed feed them. Both versions
round every op alike, so on the card they agree bit for bit.

Inputs: three (N,) f32 planes; an (N, 3) f32 or uint8 array (each byte
times f32(1/255), as the upload normalises it); or (N,) int32 codes
``r << 16 | g << 8 | b``. All are sRGB except for the two ``working_to_*``
targets, which take working-space f32. Output: three (N,) f32 planes.

The kernel's powers are ``pow_exact``: a short f64 evaluation, rounded to
f32 where Ziv's test shows that libdevice's ``pow`` rounds to the same f32,
and ``pow`` itself elsewhere. :func:`pow_exact_model` is that function in
numpy (the same tables and f64 operations), for the tests;
:func:`pow_exact_check` counts, on the card, the f32 inputs of one exponent
where the kernel's ``pow_exact`` and ``pow`` differ.
"""

from __future__ import annotations

import functools
import re

import numpy as np
import torch

from patolette_tpu_torch import kernels
from patolette_tpu_torch.kernels import build
from patolette_tpu_torch.ops import colorspace as cs

# target -> the kernel's code (csrc/colorspace.cu k*)
TARGETS = {
    "working": 0,             # sRGB -> working
    "ictcp": 1,               # sRGB -> working -> ICtCp (the direct map)
    "rec2020": 2,             # sRGB -> working -> linear Rec2020 (dither)
    "rec2020_direct": 3,      # sRGB -> linear Rec2020 (packed uint8 feed)
    "lab": 4,                 # sRGB -> CIELAB (saliency's border prior)
    "working_to_ictcp": 5,
    "working_to_rec2020": 6,
}
_IN_F32, _IN_U8, _IN_CODES = 0, 1, 2
_INV255 = float(np.float32(1.0 / 255.0))


def _plain_target(target, x, c):
    if target == "working":
        return cs.srgb_to_working_plain(x, c)
    if target == "ictcp":
        return cs.working_to_ictcp_plain(cs.srgb_to_working_plain(x, c), c)
    if target == "rec2020":
        return cs.working_to_linear_rec2020_plain(
            cs.srgb_to_working_plain(x, c), c)
    if target == "rec2020_direct":
        return cs.srgb_to_linear_rec2020_plain(x)
    if target == "lab":
        return cs.srgb_to_lab_plain(x)
    if target == "working_to_ictcp":
        return cs.working_to_ictcp_plain(x, c)
    if target == "working_to_rec2020":
        return cs.working_to_linear_rec2020_plain(x, c)
    raise ValueError(f"color_convert: unknown target {target!r}")


def _input_planes(x):
    """Any input kind -> three f32 tensors, staged as the pipeline stages
    them."""
    if isinstance(x, (tuple, list)):
        return tuple(x)
    if x.dtype == torch.int32 and x.dim() == 1:
        return tuple(((x >> s) & 0xFF).to(torch.float32) * _INV255
                     for s in (16, 8, 0))
    if x.dtype == torch.uint8:
        x = x.to(torch.float32) * _INV255
    return x[:, 0], x[:, 1], x[:, 2]


def color_convert_plain(x, color_space, target):
    out = _plain_target(target, _input_planes(x), int(color_space))
    return tuple(o.contiguous() for o in out)


def color_convert(x, color_space, target):
    """Three (N,) f32 planes of ``target`` (a key of :data:`TARGETS`) for
    ``x`` in ``color_space`` (0 sRGB, 1 CIELuv, 2 ICtCp): ``x`` a 3-tuple
    of (N,) f32, an (N, 3) f32 or uint8 tensor, or (N,) int32 codes."""
    planar = isinstance(x, (tuple, list))
    first = x[0] if planar else x
    if first.device.type == "cpu":
        return color_convert_plain(x, color_space, target)
    if target not in TARGETS:
        raise ValueError(f"color_convert: unknown target {target!r}")
    c = int(color_space)
    if c not in (0, 1, 2):
        raise ValueError(f"color_convert: color space {c}")
    if planar:
        n = first.shape[0]
        if any(t.dtype != torch.float32 or t.shape != (n,) for t in x):
            raise ValueError("color_convert: planes must be (N,) f32")
        kind, stride, ptrs, ins = _IN_F32, 1, [t.data_ptr() for t in x], x
    elif x.dtype == torch.int32 and x.dim() == 1:
        n = x.shape[0]
        kind, stride, ptrs, ins = _IN_CODES, 1, [x.data_ptr(), None, None], (x,)
    elif x.dim() == 2 and x.shape[1] == 3 and x.dtype in (torch.float32,
                                                          torch.uint8):
        n = x.shape[0]
        kind = _IN_F32 if x.dtype == torch.float32 else _IN_U8
        base, size = x.data_ptr(), x.element_size()
        stride, ptrs, ins = 3, [base, base + size, base + 2 * size], (x,)
    else:
        raise ValueError(
            "color_convert: expected 3 (N,) f32 planes, (N, 3) f32 or uint8, "
            f"or (N,) int32 codes; got {tuple(first.shape)} {first.dtype}")
    if target.startswith("working_to") and kind != _IN_F32:
        raise ValueError(f"color_convert: {target} takes f32 input")
    out = tuple(torch.empty((n,), dtype=torch.float32, device=first.device)
                for _ in range(3))
    build.require_cuda("color_convert", *ins, *out)
    if n == 0:
        return out
    err = build.library().pt_color_convert(
        *ptrs, kind, stride, n, c, TARGETS[target],
        *(build.ptr(o) for o in out), build.stream(),
    )
    build.check(err, "color_convert")
    kernels.LAUNCHES["color_convert"] += 1
    return out


def _exp(e):
    """An exponent as the kernel's EXP(e): the f32 value, widened."""
    return float(np.float32(e))


# The exponents of the kernel's powers (csrc/colorspace.cu): the sRGB
# decode and encode, the PQ curve's four, and CIELuv's and CIELAB's cube
# root.
POW_EXPONENTS = {
    "2.4": _exp(2.4), "1/2.4": _exp(1.0 / 2.4),
    "1/m2": _exp(1.0 / cs.PQ_M2), "1/m1": _exp(1.0 / cs.PQ_M1),
    "m1": _exp(cs.PQ_M1), "m2": _exp(cs.PQ_M2), "1/3": _exp(1.0 / 3.0),
}
_HEX = re.compile(r"-?0x[0-9a-fA-F]+\.[0-9a-fA-F]*p[+-]?\d+")


@functools.lru_cache(maxsize=None)
def pow_tables():
    """pow_exact's tables as the kernel's source spells them: (log (128, 2)
    rows [c_i, -log2 c_i], exp2 (128,), log polynomial (6,), exp
    polynomial (5,)), float64."""
    text = (build.CSRC / "colorspace.cu").read_text()

    def block(name):
        body = text[text.index(name):]
        body = body[body.index("{"):body.index("};")]
        return np.array([float.fromhex(v) for v in _HEX.findall(body)])

    return (block("kLogTab[128]").reshape(128, 2), block("kExp2Tab[128]"),
            block("kLogPoly[6]"), block("kExpPoly[5]"))


def pow_exact_model(x, e):
    """The kernel's ``pow_exact(x, e)`` in numpy: (f32 results, bool mask
    of the inputs where it falls back to ``pow``, whose value here is
    numpy's f64 power rounded to f32). ``x`` f32, ``e`` a float64
    exponent of :data:`POW_EXPONENTS`."""
    log, exp2, lp, ep = pow_tables()
    x = np.asarray(x, np.float32)
    xd = x.astype(np.float64)
    bits = xd.view(np.int64)
    k = ((bits >> 52) - 1023).astype(np.float64)
    m = ((bits & 0x000FFFFFFFFFFFFF) | 0x3FF0000000000000).view(np.float64)
    i = (bits >> 45) & 127
    with np.errstate(all="ignore"):
        r = m * log[i, 0] - 1.0
        p = np.full_like(r, lp[5])
        for a in lp[4::-1]:
            p = p * r + a
        p = p * r
        t = e * (k + (log[i, 1] + p))
        inside = np.abs(t) < 150.0
        t = np.where(inside, t, 0.0)
        n = np.rint(t * 128.0).astype(np.int64)
        g = t - n * 0.0078125
        q = np.full_like(g, ep[4])
        for b in ep[3::-1]:
            q = q * g + b
        q = q * g + 1.0
        scale = (((n >> 7) + 1023) << 52).view(np.float64)
        y = np.where(inside, (exp2[n & 127] * q) * scale, 0.0)
        yb = y.view(np.int64)
        ex = (yb >> 52) - 1023
        low = (yb & 0x1FFFFFFF) - (1 << 28)
        clear = (ex >= -126) & (ex <= 127) & (np.abs(low) > (1 << 13))
        fast = (x > 0) & (x < np.inf) & clear
        out = np.where(fast, y.astype(np.float32),
                       np.power(xd, e).astype(np.float32))
    out = np.where(x == 0, np.float32(0), out)
    return out, ~fast & (x != 0)


def pow_exact_check(e, device="cuda"):
    """The kernel's pow_exact against pow over all 2^32 f32 inputs of the
    exponent ``e``, counted on the card (a check, on no path): {"differ":
    inputs whose bits differ, "fell": positive finite inputs that fell
    back to pow, "fell_normal" and "normal": those and all positive finite
    inputs, among the ones whose power is an f32-normal number}."""
    counts = torch.zeros((4,), dtype=torch.int64, device=device)
    build.require_cuda("pow_exact_check", counts)
    err = build.library().pt_pow_exact_check(float(e), build.ptr(counts),
                                             build.stream())
    build.check(err, "pow_exact_check")
    return dict(zip(("differ", "fell", "fell_normal", "normal"),
                    counts.tolist()))

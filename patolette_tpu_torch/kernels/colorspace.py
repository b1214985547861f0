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
"""

from __future__ import annotations

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

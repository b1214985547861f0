"""Color-space transforms in torch f32.

Port of ``patolette_tpu/ops/colorspace.py``. Every transform takes EITHER an
``(..., 3)`` tensor OR a channel-planar 3-tuple of same-shaped tensors and
returns the matching form. Full images stay planar (three ``(N,)``
tensors, the layout the nearest-centre kernel reads); palettes and samples
use the ``(..., 3)`` form.

Both forms run the same arithmetic, op for op the JAX package's compiled
CPU code (the reference the tests hold the port to): where that code
contracts a product into an add (an FMA), the port rounds ``x * y + z``
once through f64 (:func:`_fma`); a division by a constant is a multiply by
its f32 reciprocal; the PQ scale is folded into the LMS matrix; powers are
taken in f64 and rounded once. Every op is elementwise and IEEE-rounded,
so the result is the same on the CPU and the card, and no 3x3 product
goes through a (possibly TF32) matrix unit. Without this, a 1-ulp
difference before the PQ curve (exponent 78.84) grows ~80x and moves
KMeans decisions.

The composites the pipeline converts images with (``srgb_to_working``,
``working_to_ictcp``, ``working_to_linear_rec2020``,
``srgb_to_linear_rec2020``, ``srgb_to_lab``) go through K10
(``kernels/colorspace.py``): one kernel pass on the card, these functions'
``*_plain`` glue on the CPU. They also take an ``(N, 3)`` uint8 tensor,
normalised as the upload normalises it. The other conversions (the
palette's way back to sRGB, ``cieluv_to_srgb``, ``ictcp_to_srgb``, the
pairwise steps) stay glue: the JAX package runs them on palettes, never
on an image, so they are no device hot loop.

Conventions (identical to the reference and the JAX package):
  * sRGB values are gamma-encoded in [0, 1]; gamma decode/encode clamp to
    [0, 1] (reference sRGB.c:70-110).
  * ICtCp stores the Ct coordinate HALVED so Euclidean distance approximates
    Delta-E ITP (reference ICtCp.c:60-65,78; the inverse doubles it).
  * CIELuv uses the D65 reference white (reference CIELuv.c:19-25).
"""

from __future__ import annotations

import numpy as np
import torch

from patolette_tpu_torch.utils.device import call_device, on_device

# Matrices act on column vectors: out = M @ [c0, c1, c2]^T.

# sRGB (linear) -> CIE XYZ (reference xyz.c:37-39)
M_SRGB_TO_XYZ = (
    (0.4124564, 0.3575761, 0.1804375),
    (0.2126729, 0.7151522, 0.0721750),
    (0.0193339, 0.1191920, 0.9503041),
)

# CIE XYZ -> sRGB (linear) (reference sRGB.c:52-54)
M_XYZ_TO_SRGB = (
    (3.2404542, -1.5371385, -0.4985314),
    (-0.9692660, 1.8760108, 0.0415560),
    (0.0556434, -0.2040259, 1.0572252),
)

# CIE XYZ -> linear Rec2020 (reference rec2020.c:99-101)
M_XYZ_TO_REC2020 = (
    (1.71666343, -0.35567332, -0.25336809),
    (-0.66667384, 1.61645574, 0.0157683),
    (0.01764248, -0.04277698, 0.94224328),
)

# linear Rec2020 -> CIE XYZ (reference xyz.c:61-63)
M_REC2020_TO_XYZ = (
    (0.63695351, 0.14461919, 0.16885585),
    (0.26269834, 0.67800877, 0.0592929),
    (0.0, 0.02807314, 1.06082723),
)

# linear Rec2020 -> LMS (reference ICtCp.c:66-68)
M_REC2020_TO_LMS = (
    (1688.0 / 4096.0, 2146.0 / 4096.0, 262.0 / 4096.0),
    (683.0 / 4096.0, 2951.0 / 4096.0, 462.0 / 4096.0),
    (99.0 / 4096.0, 309.0 / 4096.0, 3688.0 / 4096.0),
)

# L'M'S' -> ICtCp, with the Ct row already halved (reference ICtCp.c:74-78)
M_LMSP_TO_ICTCP = (
    (0.5, 0.5, 0.0),
    (0.5 * 6610.0 / 4096.0, 0.5 * -13613.0 / 4096.0, 0.5 * 7003.0 / 4096.0),
    (17933.0 / 4096.0, -17390.0 / 4096.0, -543.0 / 4096.0),
)

# ICtCp (halved Ct) -> L'M'S'; Ct column doubled (reference rec2020.c:51-56)
M_ICTCP_TO_LMSP = (
    (1.0, 2.0 * 0.00860904, 0.11102963),
    (1.0, 2.0 * -0.00860904, -0.11102963),
    (1.0, 2.0 * 0.56003134, -0.32062717),
)

# LMS -> linear Rec2020 (reference rec2020.c:58-60)
M_LMS_TO_REC2020 = (
    (3.43660669, -2.50645212, 0.06984542),
    (-0.79132956, 1.98360045, -0.1922709),
    (-0.0259499, -0.09891371, 1.12486361),
)

# D65 reference white (reference CIELuv.c:19-25)
D65_X = 0.95047
D65_Y = 1.0
D65_Z = 1.08883
K_E = 216.0 / 24389.0
K_K = 24389.0 / 27.0
K_KE = 8.0

# SMPTE ST 2084 PQ constants (reference eotf.c:13-18)
PQ_LP = 10000.0
PQ_M1 = 0.1593017578125
PQ_M2 = 78.84375
PQ_C1 = 0.8359375
PQ_C2 = 18.8515625
PQ_C3 = 18.6875


def _is_planar(x):
    return isinstance(x, (tuple, list))


def _split(x):
    """(..., 3) tensor or 3-tuple -> 3 channel tensors."""
    if _is_planar(x):
        return x[0], x[1], x[2]
    return x[..., 0], x[..., 1], x[..., 2]


def _join(like, a, b, c):
    """3 channel tensors -> same container kind as ``like``."""
    if _is_planar(like):
        return (a, b, c)
    return torch.stack([a, b, c], dim=-1)


def _map1(f, x):
    """Apply an elementwise primitive to a tensor or each planar channel."""
    if _is_planar(x):
        return tuple(f(ch) for ch in x)
    return f(x)


def _pow(x, e):
    """``x ** e`` through f64, rounded once to f32: the correctly rounded
    power, which libm ``powf`` (the JAX package's CPU pow) gives for all
    but ~0.1% of inputs. The exponent is rounded to f32 first, as a
    Python float meeting an f32 array is in JAX."""
    e32 = float(np.float32(e))
    return torch.pow(x.to(torch.float64), e32).to(x.dtype)


def _f32(v):
    """A Python constant as the f32 value JAX computes with."""
    return float(np.float32(v))


def _fma(x, y, z):
    """``x * y + z`` rounded once to f32 (through f64), as the JAX
    package's compiled CPU code contracts a product feeding an add."""
    return (x.to(torch.float64) * y + z).to(torch.float32)


def _div(x, k):
    """``x / k`` for a constant k, as the compiled JAX code evaluates it:
    ``x * fl32(1 / fl32(k))``."""
    return x * _f32(1.0 / _f32(k))


def _row(a, b, c, m):
    """One output of the 3x3 product, contracted as the JAX package's
    compiled CPU code does: ``fma(c, m2, fma(a, m0, m1 * b))``, or with a
    and b swapped when m0 is the only negative coefficient of the two (or
    exactly 1), where the compiler rewrites the sum as a subtraction."""
    m0, m1, m2 = (_f32(v) for v in m)
    if (m0 < 0.0 <= m1) or m0 == 1.0:
        ab = _fma(b, m1, m0 * a)
    else:
        ab = _fma(a, m0, m1 * b)
    return _fma(c, m2, ab)


def _cube(x):
    """``x ** 3.0``, which the JAX package's compiled code evaluates as
    ``(x * x) * x``."""
    return (x * x) * x


def _matmul(x, m):
    """``out_i = m[i][0]*a + m[i][1]*b + m[i][2]*c`` for both forms."""
    a, b, c = _split(x)
    return _join(x, *(_row(a, b, c, m[i]) for i in range(3)))


# --------------------------------------------------------------------------
# Elementwise primitives
# --------------------------------------------------------------------------

def srgb_gamma_decode(c):
    """sRGB transfer function; clamps output to [0, 1]
    (reference sRGB.c:70-89)."""
    lin = torch.where(
        c <= 0.0404500,
        _div(c, 12.92),
        _pow(_div(torch.clamp_min(c + 0.055, 0.0), 1.055), 2.4),
    )
    return torch.clamp(lin, 0.0, 1.0)


def srgb_gamma_encode(c):
    """Inverse sRGB transfer function; clamps output to [0, 1]
    (reference sRGB.c:91-110)."""
    enc = torch.where(
        c <= 0.0031308,
        c * 12.92,
        _fma(_pow(torch.clamp_min(c, 0.0), 1.0 / 2.4), _f32(1.055),
             _f32(-0.055)),
    )
    return torch.clamp(enc, 0.0, 1.0)


def _pq_eotf_unit(v):
    """The ST 2084 EOTF before its ``PQ_LP`` scale."""
    v_p = _pow(torch.clamp_min(v, 0.0), 1.0 / PQ_M2)
    n = torch.clamp_min(v_p - PQ_C1, 0.0)
    return _pow(n / _fma(v_p, -_f32(PQ_C3), _f32(PQ_C2)), 1.0 / PQ_M1)


def pq_eotf(v):
    """SMPTE ST 2084 EOTF (reference eotf.c:29-44); negative inputs clamp
    to 0 instead of propagating NaN through ``pow``."""
    return PQ_LP * _pq_eotf_unit(v)


def pq_eotf_inverse(f):
    """Inverse of the ST 2084 EOTF (reference eotf.c:46-57)."""
    y = _pow(_div(torch.clamp_min(f, 0.0), PQ_LP), PQ_M1)
    return _pow(_fma(y, _f32(PQ_C2), _f32(PQ_C1))
                / _fma(y, _f32(PQ_C3), 1.0), PQ_M2)


# --------------------------------------------------------------------------
# Pairwise space conversions
# --------------------------------------------------------------------------

def srgb_to_xyz(rgb):
    """Gamma decode + primaries matrix (reference xyz.c:14-40)."""
    return _matmul(_map1(srgb_gamma_decode, rgb), M_SRGB_TO_XYZ)


def xyz_to_srgb(xyz):
    """Primaries matrix + gamma encode (reference sRGB.c:30-58)."""
    return _map1(srgb_gamma_encode, _matmul(xyz, M_XYZ_TO_SRGB))


def xyz_to_linear_rec2020(xyz):
    return _matmul(xyz, M_XYZ_TO_REC2020)


def linear_rec2020_to_xyz(rgb2020):
    return _matmul(rgb2020, M_REC2020_TO_XYZ)


def xyz_to_cieluv(xyz):
    """CIE XYZ -> CIELuv with D65 white (reference CIELuv.c:54-100)."""
    x, y, z = _split(xyz)
    den = _fma(z, 3.0, _fma(y, 15.0, x))
    safe = den > 0.0
    den_safe = torch.where(safe, den, 1.0)
    up = torch.where(safe, 4.0 * x / den_safe, 0.0)
    vp = torch.where(safe, 9.0 * y / den_safe, 0.0)

    ref_den = D65_X + 15.0 * D65_Y + 3.0 * D65_Z
    urp = 4.0 * D65_X / ref_den
    vrp = 9.0 * D65_Y / ref_den

    yr = y / D65_Y
    big = yr > K_E
    l = torch.where(
        big,
        _fma(_pow(torch.clamp_min(yr, 0.0), 1.0 / 3.0), 116.0, -16.0),
        K_K * yr,
    )
    u = 13.0 * l * (up - urp)
    v = 13.0 * l * (vp - vrp)
    return _join(xyz, l, u, v)


def cieluv_to_xyz(luv):
    """CIELuv -> CIE XYZ with zero-denominator guards
    (reference CIELuv.c:110-164)."""
    l, u, v = _split(luv)
    y = torch.where(
        l > K_KE,
        _cube(_div(l + 16.0, 116.0)),
        _div(l, K_K),
    )
    ref_den = D65_X + 15.0 * D65_Y + 3.0 * D65_Z
    u0 = 4.0 * D65_X / ref_den
    v0 = 9.0 * D65_Y / ref_den

    a_den = _fma(13.0 * l, _f32(u0), u)
    a_safe = a_den != 0.0
    a = torch.where(
        a_safe,
        _div((52.0 * l) / torch.where(a_safe, a_den, 1.0) - 1.0, 3.0),
        0.0,
    )
    b = -5.0 * y
    c = -1.0 / 3.0
    d_den = _fma(13.0 * l, _f32(v0), v)
    d_safe = d_den != 0.0
    d = torch.where(
        d_safe,
        y * ((39.0 * l) / torch.where(d_safe, d_den, 1.0) - 5.0),
        0.0,
    )
    x_den = a - c
    x_safe = x_den != 0.0
    x = torch.where(x_safe, (d - b) / torch.where(x_safe, x_den, 1.0), 0.0)
    z = _fma(x, a, b)
    return _join(luv, x, y, z)


def linear_rec2020_to_ictcp(rgb2020):
    """Linear Rec2020 -> ICtCp with HALVED Ct (reference ICtCp.c:41-79)."""
    lms = _matmul(rgb2020, M_REC2020_TO_LMS)
    lmsp = _map1(pq_eotf_inverse, lms)
    return _matmul(lmsp, M_LMSP_TO_ICTCP)


def ictcp_to_linear_rec2020(ictcp):
    """ICtCp (halved Ct) -> linear Rec2020 (reference rec2020.c:32-69)."""
    lmsp = _matmul(ictcp, M_ICTCP_TO_LMSP)
    # the compiled JAX code folds the EOTF's PQ_LP scale into the matrix
    scaled = tuple(tuple(_f32(_f32(v) * _f32(PQ_LP)) for v in row)
                   for row in M_LMS_TO_REC2020)
    return _matmul(_map1(_pq_eotf_unit, lmsp), scaled)


# --------------------------------------------------------------------------
# Composites used by the pipeline: the glue (K10's plain version) and the
# routed public functions
# --------------------------------------------------------------------------

def srgb_to_linear_rec2020_plain(rgb):
    return xyz_to_linear_rec2020(srgb_to_xyz(rgb))


def linear_rec2020_to_srgb(rgb2020):
    return xyz_to_srgb(linear_rec2020_to_xyz(rgb2020))


def srgb_to_cieluv(rgb):
    return xyz_to_cieluv(srgb_to_xyz(rgb))


def cieluv_to_linear_rec2020(luv):
    return xyz_to_linear_rec2020(cieluv_to_xyz(luv))


def srgb_to_ictcp(rgb):
    return linear_rec2020_to_ictcp(srgb_to_linear_rec2020_plain(rgb))


def _put(x, device):
    """``x`` (numpy or tensors, an array or a 3-tuple) as f32 where the
    call runs (``utils/device.py``)."""
    dev = call_device(x, device)
    if _is_planar(x):
        return tuple(on_device(ch, dev, torch.float32) for ch in x)
    return on_device(x, dev, torch.float32)


def cieluv_to_srgb(luv, device=None):
    """CIELuv -> sRGB through XYZ, glue in either form. Numpy input goes
    to ``device`` (``cuda`` by default); tensors stay where they are."""
    return xyz_to_srgb(cieluv_to_xyz(_put(luv, device)))


def ictcp_to_srgb(ictcp, device=None):
    """ICtCp (halved Ct) -> sRGB through linear Rec2020, glue in either
    form. Numpy input goes to ``device`` (``cuda`` by default); tensors
    stay where they are."""
    return linear_rec2020_to_srgb(ictcp_to_linear_rec2020(_put(ictcp,
                                                               device)))


def srgb_to_lab_plain(rgb):
    """sRGB -> CIELAB (D65) for the saliency border prior (the reference
    calls skimage.color.rgb2lab, patolette.pyx:213). The cube root is
    ``pow(t, fl32(1/3))`` rounded once, as the JAX package's compiled
    ``cbrt`` evaluates it."""
    x0, y0, z0 = _split(srgb_to_xyz(rgb))

    def fwhite(t):
        return torch.where(t > K_E, _pow(t, 1.0 / 3.0),
                           _div(_fma(t, _f32(K_K), 16.0), 116.0))

    fx = fwhite(_div(x0, D65_X))
    fy = fwhite(_div(y0, D65_Y))
    fz = fwhite(_div(z0, D65_Z))
    l = _fma(fy, 116.0, -16.0)
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return _join(rgb, l, a, b)


def srgb_to_working_plain(rgb, color_space):
    """sRGB -> working space (reference patolette.c:201-207)."""
    cs = int(color_space)
    if cs == 1:  # CIELuv
        return srgb_to_cieluv(rgb)
    if cs == 2:  # ICtCp
        return srgb_to_ictcp(rgb)
    return rgb


def working_to_ictcp_plain(x, color_space):
    """Working space -> ICtCp for the direct map. The CIELuv path follows
    the reference's chain Luv -> Rec2020 -> sRGB -> ICtCp
    (patolette.c:304-313)."""
    cs = int(color_space)
    if cs == 1:
        return srgb_to_ictcp(
            linear_rec2020_to_srgb(cieluv_to_linear_rec2020(x))
        )
    if cs == 2:
        return x
    return srgb_to_ictcp(x)


def working_to_linear_rec2020_plain(x, color_space):
    """Working space -> linear Rec2020 for dithering
    (reference patolette.c:274-287)."""
    cs = int(color_space)
    if cs == 1:
        return cieluv_to_linear_rec2020(x)
    if cs == 2:
        return ictcp_to_linear_rec2020(x)
    return srgb_to_linear_rec2020_plain(x)


def working_to_srgb(x, color_space):
    """Working space -> sRGB for the final palette."""
    cs = int(color_space)
    if cs == 1:
        return linear_rec2020_to_srgb(cieluv_to_linear_rec2020(x))
    if cs == 2:
        return linear_rec2020_to_srgb(ictcp_to_linear_rec2020(x))
    return x


def _convert(x, color_space, target):
    """``target`` of K10's wrapper in the form ``x`` came in: planar in,
    planar out (each plane of the input's shape); (..., 3) in, (..., 3)
    out."""
    # K10's plain version is this module's glue, so the wrapper's module
    # imports this one and is imported here at the call
    from patolette_tpu_torch.kernels.colorspace import color_convert

    if _is_planar(x):
        shape = x[0].shape
        out = color_convert(tuple(ch.reshape(-1).contiguous() for ch in x),
                            color_space, target)
        return tuple(o.view(shape) for o in out)
    out = color_convert(x.reshape(-1, 3).contiguous(), color_space, target)
    return torch.stack(out, -1).view(*x.shape[:-1], 3)


def _is_f32(x):
    return (x[0] if _is_planar(x) else x).dtype == torch.float32


def srgb_to_working(rgb, color_space):
    """sRGB (f32, or (N, 3) uint8) -> working space, through K10."""
    if int(color_space) == 0 and _is_f32(rgb):
        return rgb
    return _convert(rgb, color_space, "working")


def working_to_ictcp(x, color_space):
    """Working space -> ICtCp for the direct map, through K10."""
    if int(color_space) == 2:
        return x
    return _convert(x, color_space, "working_to_ictcp")


def working_to_linear_rec2020(x, color_space):
    """Working space -> linear Rec2020 for dithering, through K10."""
    return _convert(x, color_space, "working_to_rec2020")


def srgb_to_linear_rec2020(rgb):
    """sRGB -> linear Rec2020 directly (the packed uint8 dither feed's
    chain), through K10."""
    return _convert(rgb, 0, "rec2020_direct")


def srgb_to_lab(rgb):
    """sRGB -> CIELAB for the saliency border prior, through K10."""
    return _convert(rgb, 0, "lab")

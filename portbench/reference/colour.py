"""Colour transforms of the reference, in any torch floating dtype.

Written from the published definitions with the constants of the upstream
C library (big-nacho/patolette, lib/src: xyz.c, rec2020.c, ICtCp.c,
eotf.c, CIELuv.c): sRGB transfer function clamped to [0, 1], sRGB -> XYZ ->
linear Rec2020 (two matrices, as upstream chains them), SMPTE ST 2084 (PQ),
ICtCp with the Ct coordinate halved, CIELuv against D65. Every function
takes and returns an (N, 3) tensor and computes in its dtype.
"""

from __future__ import annotations

import torch

M_SRGB_TO_XYZ = (
    (0.4124564, 0.3575761, 0.1804375),
    (0.2126729, 0.7151522, 0.0721750),
    (0.0193339, 0.1191920, 0.9503041),
)
M_XYZ_TO_REC2020 = (
    (1.71666343, -0.35567332, -0.25336809),
    (-0.66667384, 1.61645574, 0.0157683),
    (0.01764248, -0.04277698, 0.94224328),
)
M_REC2020_TO_LMS = (
    (1688.0 / 4096.0, 2146.0 / 4096.0, 262.0 / 4096.0),
    (683.0 / 4096.0, 2951.0 / 4096.0, 462.0 / 4096.0),
    (99.0 / 4096.0, 309.0 / 4096.0, 3688.0 / 4096.0),
)
# L'M'S' -> ICtCp; the Ct row is halved so that Euclidean distance
# approximates Delta-E ITP (upstream ICtCp.c)
M_LMSP_TO_ICTCP = (
    (0.5, 0.5, 0.0),
    (0.5 * 6610.0 / 4096.0, 0.5 * -13613.0 / 4096.0, 0.5 * 7003.0 / 4096.0),
    (17933.0 / 4096.0, -17390.0 / 4096.0, -543.0 / 4096.0),
)
PQ_LP = 10000.0
PQ_M1 = 0.1593017578125
PQ_M2 = 78.84375
PQ_C1 = 0.8359375
PQ_C2 = 18.8515625
PQ_C3 = 18.6875
D65 = (0.95047, 1.0, 1.08883)
K_E = 216.0 / 24389.0
K_K = 24389.0 / 27.0


def transform_dtype(dtype):
    """The dtype the transforms run in under ``dtype``: float32 under a
    narrower one, as the program's do."""
    return torch.float32 if dtype.itemsize < 4 else dtype


def _mat(x, m):
    return x @ torch.tensor(m, dtype=x.dtype, device=x.device).T


def srgb_decode(c):
    lin = torch.where(c <= 0.04045, c / 12.92,
                      ((c + 0.055).clamp_min(0.0) / 1.055) ** 2.4)
    return lin.clamp(0.0, 1.0)


def srgb_to_xyz(rgb):
    return _mat(srgb_decode(rgb), M_SRGB_TO_XYZ)


def srgb_to_rec2020(rgb):
    """sRGB -> linear Rec2020 (the dither's space)."""
    return _mat(srgb_to_xyz(rgb), M_XYZ_TO_REC2020)


def pq_inverse(f):
    y = (f.clamp_min(0.0) / PQ_LP) ** PQ_M1
    return ((PQ_C1 + PQ_C2 * y) / (1.0 + PQ_C3 * y)) ** PQ_M2


def srgb_to_ictcp(rgb):
    """sRGB -> ICtCp with halved Ct (the nearest-colour map's space)."""
    lms = _mat(srgb_to_rec2020(rgb), M_REC2020_TO_LMS)
    return _mat(pq_inverse(lms), M_LMSP_TO_ICTCP)


def srgb_to_cieluv(rgb):
    xyz = srgb_to_xyz(rgb)
    x, y, z = xyz.unbind(-1)
    den = x + 15.0 * y + 3.0 * z
    safe = den > 0.0
    den1 = torch.where(safe, den, torch.ones_like(den))
    up = torch.where(safe, 4.0 * x / den1, torch.zeros_like(x))
    vp = torch.where(safe, 9.0 * y / den1, torch.zeros_like(y))
    ref = D65[0] + 15.0 * D65[1] + 3.0 * D65[2]
    yr = y / D65[1]
    l = torch.where(yr > K_E, 116.0 * yr.clamp_min(0.0) ** (1.0 / 3.0) - 16.0,
                    K_K * yr)
    u = 13.0 * l * (up - 4.0 * D65[0] / ref)
    v = 13.0 * l * (vp - 9.0 * D65[1] / ref)
    return torch.stack([l, u, v], -1)


def srgb_of(pixels, device, dtype=torch.float64):
    """(N, 3) host or device pixels (uint8 or float) as sRGB in [0, 1] of
    ``dtype`` on ``device``: uint8 divided by 255, floats as they are."""
    t = torch.as_tensor(pixels).to(device)
    if t.dtype == torch.uint8:
        return t.to(dtype) / 255.0
    return t.to(dtype)


def srgb_to_lab(rgb):
    """sRGB -> CIELAB against D65 (the saliency's border prior)."""
    xyz = srgb_to_xyz(rgb) / torch.tensor(D65, dtype=rgb.dtype,
                                          device=rgb.device)
    f = torch.where(xyz > K_E, xyz.clamp_min(0.0) ** (1.0 / 3.0),
                    (K_K * xyz + 16.0) / 116.0)
    fx, fy, fz = f.unbind(-1)
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], -1)


def srgb_encode(lin):
    c = lin.clamp_min(0.0)
    out = torch.where(c <= 0.0031308, c * 12.92,
                      1.055 * c ** (1.0 / 2.4) - 0.055)
    return out.clamp(0.0, 1.0)


def ictcp_to_srgb(ictcp):
    """ICtCp (halved Ct) -> sRGB clamped to [0, 1]: the way a palette
    leaves the working space (upstream rec2020.c, eotf.c, xyz.c)."""
    def inv(m):
        return torch.linalg.inv(torch.tensor(m, dtype=torch.float64)).to(
            ictcp.dtype).to(ictcp.device)

    lmsp = ictcp @ inv(M_LMSP_TO_ICTCP).T
    # PQ's range is [0, 1]: beyond it the curve has no inverse
    vp = lmsp.clamp(0.0, 1.0) ** (1.0 / PQ_M2)
    lms = PQ_LP * ((vp - PQ_C1).clamp_min(0.0)
                   / (PQ_C2 - PQ_C3 * vp)) ** (1.0 / PQ_M1)
    lin = lms @ inv(M_REC2020_TO_LMS).T @ inv(M_XYZ_TO_REC2020).T \
        @ inv(M_SRGB_TO_XYZ).T
    return srgb_encode(lin)

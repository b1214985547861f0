"""Frozen bound arithmetic: the least time the H100 could take for the
work of one ``quantize()`` call, from its shapes.

Copied from ``chip_smoke.py`` (``bound_ms``, the peaks, ``k8_chain_cycles``,
``k11_chain_cycles``, ``k10_ops`` and each kernel's byte and operation
counts in its kernels phase) and frozen here, so that the yardstick stays
as it is when the program's own script changes. Bytes are counted once for
each input read and each output written; operations at the published
dense peaks of one H100 SXM (NVIDIA's data sheet). A dependency chain is
timed at the card's highest SM clock, 1980 MHz, so that no clock reads
under it. Where the work depends on the data (members of an LQ candidate,
runs of an encoded table), the least these shapes need is counted.
"""

from __future__ import annotations

import math

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 33.5e12
# f32 instructions a second (132 SMs x 128 lanes x 1.98 GHz): operations
# that cannot fuse into an FMA
PEAK_F32_INSTR = 33.5e12
SM_CLOCK_HZ = 1.98e9
LAT_F32, LAT_SHFL, LAT_LDS = 4, 23, 23

# the program's fixed shapes of one call (models/local_q.py, kmeans.py,
# global_q.py, ops/lut.py): LQ rounds (1 + 36), GQ buckets and levels, the
# 2^24-entry table, moments features
LQ_ROUNDS = 37
GQ_BUCKETS = 512
GQ_LEVELS = 12
LUT_CODES = 1 << 24
MOMENT_FEATURES = 11
# dithered calls without saliency above this many pixels take the
# streamed route (models/pipeline.py STRIP_DITHER_MIN_PIXELS)
STRIP_DITHER_MIN_PIXELS = 1 << 22


def bound_ms(nbytes, flops, f64_flops=0):
    """The larger of bytes over the memory rate and operations over their
    type's rate, in ms."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_F32_FLOPS + f64_flops / PEAK_F64_FLOPS) * 1e3
    return max(t_bytes, t_ops)


def k8_chain_cycles(k, group):
    """K8's least latency of one dither step in cycles (see chip_smoke)."""
    per = max(1, -(-k // group))
    levels = math.ceil(math.log2(per)) if per > 1 else 0
    return (LAT_F32 * (2 + 5 + 2 * levels + 3) + LAT_SHFL
            + int(math.log2(group)) * (LAT_SHFL + 2 * LAT_F32) + LAT_LDS)


def k8_group(k):
    return 8 if k <= 256 else 16 if k <= 512 else 32


def k11_chain_cycles(k_max, b=GQ_BUCKETS):
    lg = math.ceil(math.log2(b))
    return LAT_F32 * (lg + 7 + (k_max - 1) * (1 + 2 * lg))


# K10's (f32, f64) operations per pixel, read off csrc/colorspace.cu
_DECODE, _ENCODE, _MAT = (5, 1), (4, 3), (3, 12)
_PQ_INV, _PQ_UNIT = (3, 6), (4, 4)


def _ops(*parts):
    return (sum(p[0] for p in parts), sum(p[1] for p in parts))


_TO_XYZ = _ops(*[_DECODE] * 3, _MAT)
_TO_2020 = _ops(_TO_XYZ, _MAT)
_2020_ICTCP = _ops(_MAT, *[_PQ_INV] * 3, _MAT)
_TO_ICTCP = _ops(_TO_2020, _2020_ICTCP)
_ICTCP_2020 = _ops(_MAT, *[_PQ_UNIT] * 3, _MAT)
# the streamed dither's one pass a strip: float sRGB -> working (ICtCp) ->
# linear Rec2020; uint8 sRGB -> linear Rec2020 directly (the packed feed)
K10_OPS = {"srgb_to_ictcp": _TO_ICTCP, "ictcp_to_rec2020": _ICTCP_2020,
           "srgb_to_ictcp_to_rec2020": _ops(_TO_ICTCP, _ICTCP_2020),
           "srgb_to_rec2020": _TO_2020}


def k10_ms(m, target, in_bytes):
    f32, f64 = K10_OPS[target]
    return bound_ms(m * (in_bytes + 12), m * f32, m * f64)


def k1_ms(n, segments, members, features=MOMENT_FEATURES):
    """Segment moments: every id read, the member rows, the sums."""
    return bound_ms(n * 4 + members * features * 4
                    + segments * features * 4, members * features)


def k2_ms(n):
    """One LQ candidate pass at its least: every pixel's candidate read
    and bucket written (members and tables depend on the data)."""
    return bound_ms(n * 8, 0)


def k4_ms(m, p, valid):
    return bound_ms(m * 12 + p * 12 * 2 + p * 4, m * valid * 7 + m * 4)


def k11_ms(b=GQ_BUCKETS, k_max=GQ_LEVELS):
    cand = sum(max(0, n - k + 1) for k in range(2, k_max + 1)
               for n in range(b + 1))
    cells = b * (b + 1) // 2
    ops = (12 * cells + 2 * cand + 11 * b) / PEAK_F32_INSTR * 1e3
    chain = k11_chain_cycles(k_max, b) / SM_CLOCK_HZ * 1e3
    return max(ops, chain)


def k5_ms(p, out_bytes=1):
    """The table: the grid read, the palette, the table written."""
    return bound_ms(LUT_CODES * 12 + p * 16 + LUT_CODES * out_bytes, 0)


def k6_v2_ms():
    """The table read and the least words written (no run)."""
    return bound_ms(LUT_CODES + 2 * 3, 0)


def k3_ms(n, p):
    return bound_ms(n * 12 + p * 16 + n * 4, 0)


def k7_ms(n):
    return bound_ms(n * 4, 0)


def k8_ms(n, p, valid, segment):
    chain = min(segment, n) * k8_chain_cycles(p, k8_group(p)) \
        / SM_CLOCK_HZ * 1e3
    return max(chain, bound_ms(n * (12 + 4 + 4) + p * 32,
                               n * (7 * valid + 2 * 3 * 16 + 9)))


def k9_ms(n):
    return bound_ms((16 + 28 + 28) * n, 3 * 8 * n)


def palette_core_ms(m, p, valid, kmeans_niter):
    """GQ moments (K1), the DP (K11), the LQ rounds (K2 and K1 on the
    candidates) and KMeans (K4) on ``m`` samples."""
    lq = LQ_ROUNDS * (k2_ms(m) + k1_ms(m, 16, 0))
    return (k1_ms(m, GQ_BUCKETS, m) + k11_ms() + lq
            + kmeans_niter * k4_ms(m, p, valid))


def call_least_ms(call, n, valid, input_dtype):
    """Least device time of one ``quantize()`` call of ``n`` pixels with
    the configuration's arguments ``call`` (palette_size, dither,
    tile_size, kmeans_niter, lq_max_samples, kmeans_max_samples,
    dither_segment) and ``valid`` palette entries: the uint8 undithered
    call of at least 2^22 pixels draws its samples on the host and maps
    through the 2^24-entry table (its grid is built once a process, so no
    call pays it); the dithered call without saliency of more than 2^22
    pixels draws its samples on the host and converts only them to the
    working space, then converts each strip once, sRGB to linear Rec2020,
    orders and dithers it; every other converts the whole image,
    with saliency when tile_size > 0, then dithers or maps it."""
    p = int(call["palette_size"])
    m = min(n, int(call.get("lq_max_samples", 1 << 18)))
    niter = int(call.get("kmeans_niter", 32))
    in_bytes = 3 if input_dtype == "uint8" else 12
    segment = int(call.get("dither_segment", 4096))
    dither = call.get("dither", True)
    saliency = float(call.get("tile_size", 512.0)) > 0
    if input_dtype == "uint8" and not dither and n >= 1 << 22:
        return (k10_ms(m, "srgb_to_ictcp", 3)
                + palette_core_ms(m, p, valid, niter)
                + k5_ms(p) + k6_v2_ms())
    if dither and not saliency and n > STRIP_DITHER_MIN_PIXELS:
        strip = ("srgb_to_rec2020" if input_dtype == "uint8"
                 else "srgb_to_ictcp_to_rec2020")
        return (k10_ms(m, "srgb_to_ictcp", in_bytes)
                + palette_core_ms(m, p, valid, niter)
                + k10_ms(n, strip, in_bytes) + k7_ms(n)
                + k8_ms(n, p, valid, segment))
    t = k10_ms(n, "srgb_to_ictcp", in_bytes)
    if saliency:
        t += k9_ms(n)
    t += palette_core_ms(m, p, valid, niter)
    if dither:
        t += k10_ms(n, "ictcp_to_rec2020", 12) + k7_ms(n) + k8_ms(
            n, p, valid, segment)
    else:
        t += k3_ms(n, p)
    return t

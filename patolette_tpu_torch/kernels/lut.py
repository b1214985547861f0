"""K5: the 24-bit nearest-palette table over the ICtCp grid.

Kernel: ``csrc/lut.cu`` (the nearest-centre scan of K3, ``csrc/nearest.cuh``,
writing u8 or u16, pruned by each warp's box of grid values). Twin: the
JAX package's ``_argmin_lut`` (``lut.py:145-162``), whose distances and
first-index ties are K3's, so the plain version is K3's plain version over
the grid, narrowed.

:func:`box_candidates` is the pruned scan's candidate rule in numpy, and
:func:`warp_codes` the codes one warp of the kernel loads; the tests and
``chip_smoke.py`` hold the rule to the brute-force argmin with them.
:func:`nearest_probe` runs the kernel's scan once with a count of the
centres each warp scanned (a measurement, on no path).
"""

from __future__ import annotations

import numpy as np
import torch

from patolette_tpu_torch import kernels
from patolette_tpu_torch.kernels import build
from patolette_tpu_torch.kernels.assign import (assign_planar_plain,
                                                center_table)

# Output type -> the largest palette whose indices it holds.
_MAX_ENTRIES = {torch.uint8: 256, torch.uint16: 65536}
# The kernel's warps: 32 lanes of 8 points; the brick layout's slab.
WARP_POINTS = 256
BRICK_SLAB = 1 << 18
# nearest.cuh's eta: 5 u relative, 2^-126 absolute
_DIST_REL = np.float32(5.0 / 2 ** 24)
_DIST_ABS = np.float32(2.0 ** -126)


def lut_argmin_plain(grid, centers, valid, out_dtype):
    return assign_planar_plain(grid, centers, valid).to(out_dtype)


def lut_argmin(grid, centers, valid, out_dtype):
    """(N,) ``out_dtype`` index of the nearest valid centre for each grid
    point; ``grid`` a 3-tuple of (N,) f32 ICtCp planes, ``centers`` (K, 3)
    ICtCp, ``valid`` (K,) bool, ``out_dtype`` torch.uint8 or torch.uint16
    (the CPU twin takes any integer type)."""
    a, b, c = grid
    if a.device.type == "cpu":
        return lut_argmin_plain(grid, centers, valid, out_dtype)
    n, k, tab, valid_i = _check(grid, centers, valid, "lut_argmin")
    if k > _MAX_ENTRIES.get(out_dtype, 0):
        raise ValueError(f"lut_argmin: {k} entries do not fit {out_dtype}")
    out = torch.empty((n,), dtype=out_dtype, device=a.device)
    if n == 0:
        return out
    err = build.library().pt_lut_argmin(
        build.ptr(a), build.ptr(b), build.ptr(c), build.ptr(tab),
        build.ptr(valid_i), n, k, build.ptr(out), out.element_size(),
        build.stream(),
    )
    build.check(err, "lut_argmin")
    kernels.LAUNCHES["lut_argmin"] += 1
    return out


def _check(grid, centers, valid, name):
    a, b, c = grid
    n = a.shape[0]
    k = centers.shape[0]
    for t in (a, b, c, centers):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: f32 grid and centers")
    if (b.shape != (n,) or c.shape != (n,) or centers.shape != (k, 3)
            or valid.shape != (k,) or k < 1):
        raise ValueError(f"{name}: bad shapes")
    tab = center_table(centers)
    valid_i = valid.to(torch.int32)
    build.require_cuda(name, a, b, c, tab, valid_i)
    return n, k, tab, valid_i


# nearest_probe's layouts: name -> (the kernel's code, points a block,
# warps a block)
PROBE_LAYOUTS = {"linear": (0, 2048, 8), "brick": (1, 2048, 8),
                 "sorted": (2, 8192, 32), "sorted4096": (3, 4096, 16)}


def nearest_probe(grid, centers, valid, layout="brick"):
    """One launch of the scan on the card: (labels (N,) int32, centres
    scanned per warp (W,) int32), in the layout ``layout``: "brick" (N a
    multiple of 2^18), as K5 runs it on the grid; "linear", as K5 runs it
    elsewhere; "sorted", as K3 runs it (8192-point tiles cut by median
    splits); "sorted4096" (4096-point tiles, a measurement). Not counted
    in ``LAUNCHES``."""
    a, b, c = grid
    n, k, tab, valid_i = _check(grid, centers, valid, "nearest_probe")
    code, points, warps = PROBE_LAYOUTS[layout]
    blocks = -(-n // points)
    labels = torch.empty((n,), dtype=torch.int32, device=a.device)
    counts = torch.zeros((blocks * warps,), dtype=torch.int32,
                         device=a.device)
    err = build.library().pt_nearest_probe(
        build.ptr(a), build.ptr(b), build.ptr(c), build.ptr(tab),
        build.ptr(valid_i), n, k, code, build.ptr(labels),
        build.ptr(counts), build.stream(),
    )
    build.check(err, "nearest_probe")
    return labels, counts


def warp_codes(warp, brick):
    """(256,) int64 indices of the points warp ``warp`` of a launch loads
    (nearest.cuh's ``nearest_point``), lane-major: a 4 r x 8 g x 8 b brick
    of codes, or 8 runs of 32 consecutive points 256 apart."""
    lane = np.arange(32)[:, None]
    j = np.arange(8)[None, :]
    if brick:
        slab, rem = warp >> 10, warp & 1023
        r = slab * 4 + (j >> 1)
        g = (rem >> 5) * 8 + (lane >> 3) + 4 * (j & 1)
        b = (rem & 31) * 8 + (lane & 7)
        q = (r << 16) | (g << 8) | b
    else:
        q = (warp >> 3) * 2048 + (warp & 7) * 32 + lane + 256 * j
    return np.asarray(q, np.int64).reshape(-1)


def _down(v):
    """f64 -> f32 rounded toward -inf (exact for f64 values that are the
    exact result of the f32 operation, as the bounds' are but for sums of
    far-apart magnitudes)."""
    f = v.astype(np.float32)
    return np.where(f.astype(np.float64) > v, np.nextafter(f, -np.inf), f)


def _up(v):
    f = v.astype(np.float32)
    return np.where(f.astype(np.float64) < v, np.nextafter(f, np.inf), f)


def box_candidates(points, centers, valid):
    """The pruned scan's candidate rule (``csrc/nearest.cuh``) for one
    warp's points, in numpy: ``points`` (M, 3) f32 (the warp's in-range
    values), ``centers`` (K, 3) f32, ``valid`` (K,) bool -> the indices of
    the valid centres that can be nearest, or tie, somewhere in the points'
    box, ascending. Each bound is rounded outward to f32 as the kernel
    rounds it; where several centres share the least UB, eta_U is their
    largest eta (the kernel takes one of them), so for K <= 1024 (one tile)
    this list holds the kernel's."""
    with np.errstate(over="ignore", invalid="ignore"):
        return _box_candidates(np.asarray(points, np.float32),
                               np.asarray(centers, np.float32),
                               np.asarray(valid, bool))


def _box_candidates(x, centers, ok):
    tab = center_table(torch.as_tensor(centers))
    cen = tab.numpy()
    c, w = cen[:, :3].astype(np.float64), cen[:, 3]
    lo = np.fmin.reduce(x, axis=0).astype(np.float64)
    hi = np.fmax.reduce(x, axis=0).astype(np.float64)
    far = np.zeros(len(c), np.float32)
    near = np.zeros(len(c), np.float32)
    for i in range(3):
        m = np.maximum(_up(c[:, i] - lo[i]), _up(hi[i] - c[:, i]))
        far = _up(far.astype(np.float64) + _up(m.astype(np.float64) ** 2))
        m = np.maximum(np.maximum(_down(lo[i] - c[:, i]),
                                  _down(c[:, i] - hi[i])), np.float32(0))
        near = _down(near.astype(np.float64)
                     + _down(m.astype(np.float64) ** 2))
    xmax = np.maximum(np.abs(lo), np.abs(hi))
    s = np.zeros(len(c), np.float32)
    for i in range(3):
        s = _up(s.astype(np.float64)
                + _up(xmax[i] * np.abs(c[:, i])).astype(np.float64))
    s = _up(w.astype(np.float64) + 2.0 * s.astype(np.float64))
    eta = _up(_up(s.astype(np.float64) * float(_DIST_REL)).astype(np.float64)
              + float(_DIST_ABS))
    usable = ok & (far < np.inf)
    if not usable.any():
        return np.flatnonzero(ok)
    k = np.flatnonzero(usable & (far == far[usable].min()))
    u, eta_u = far[k[0]], eta[k].max()
    gap = _down(near.astype(np.float64) - float(u))
    bound = _up(eta.astype(np.float64) + float(eta_u))
    return np.flatnonzero(ok & ~(gap > bound))


def adversarial_palettes(grid_at, seed=0):
    """K5's hard cases, for the tests and ``chip_smoke.py``: name ->
    (centres (K, 3) f32, valid (K,) bool), from ``grid_at(codes)``, the
    (len, 3) f32 ICtCp values of int64 codes. One entry; duplicated entries
    (every grid point twice, the copies in reverse order); entries on the
    faces between warps' patches (b and g at 0 or 7 mod 8, r at 0 or 3 mod
    4), each twice, with invalid slots; entries far outside the gamut
    (|c|^2 up to inf in f32); every other slot invalid."""
    rng = np.random.default_rng(seed)

    def codes(n):
        return rng.integers(0, 1 << 24, n)

    def ones(n, off=()):
        v = np.ones(n, bool)
        v[list(off)] = False
        return v

    out = {"one": (grid_at(codes(1)), ones(1))}
    base = grid_at(codes(128))
    out["duplicates"] = (np.concatenate([base, base[::-1]]), ones(256, (3,)))
    n = 512
    r = (rng.integers(0, 64, n) * 4 + rng.choice([0, 3], n))
    g = (rng.integers(0, 32, n) * 8 + rng.choice([0, 7], n))
    b = (rng.integers(0, 32, n) * 8 + rng.choice([0, 7], n))
    faces = grid_at((r << 16) | (g << 8) | b)
    out["faces"] = (np.concatenate([faces, faces]),
                    ones(2 * n, (0, 5, n + 6, 2 * n - 1)))
    far = np.array([[10, 0, 0], [-10, 5, 5], [1e3, -1e3, 1e3],
                    [2e19, 2e19, -2e19], [0.5e6, 0.5e6, 0.5e6],
                    [-3, -3, -3]], np.float32)
    out["far"] = (np.concatenate([grid_at(codes(250)), far]), ones(256))
    spaced = ones(1024)
    spaced[::2] = False
    spaced[:64] = False
    out["spaced"] = (grid_at(codes(1024)), spaced)
    return {k: (np.ascontiguousarray(c, np.float32), v)
            for k, (c, v) in out.items()}

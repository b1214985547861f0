"""K7: the Hilbert-curve visit order of a ``width x height`` image.

Kernel: ``csrc/hilbert.cu``. Twin: the JAX package's ``pixel_visit_order``
(``hilbert.py:62-79``): every row-major pixel's curve distance ``d``
(``xy_to_d``, ``hilbert.py:31-59``), then an argsort. The keys are
distinct, so the permutation is exact; the kernel enumerates ``d`` in
ascending order instead of sorting (:func:`visit_order_model` is its
arithmetic on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from patolette_tpu_torch import kernels
from patolette_tpu_torch.kernels import build
from patolette_tpu_torch.utils.device import call_device, on_device

MAX_ORDER = 16
# The kernel's tiles: aligned squares of side 2^TILE_BITS, each a run of
# 4^TILE_BITS consecutive curve distances (csrc/hilbert.cu kTileBits).
TILE_BITS = 5
WARPS = 8   # tiles a block walks at once (csrc/hilbert.cu kWarps)
BLOCKS_PER_SM = 4  # the grid's most blocks (each builds its tables once)
_U32 = 0xFFFFFFFF
# curve digit q = (3 rx) ^ ry -> the bits (rx, ry) it came from
_RX = (0, 0, 1, 1)
_RY = (0, 1, 1, 0)


def curve_order(width: int, height: int) -> int:
    """Smallest order with 2^order >= max(width, height)
    (reference riemersma.c:124-144)."""
    m = max(int(width), int(height))
    level = 0
    while (1 << level) < m:
        level += 1
    return max(level, 1)


def xy_to_d(x, y, order: int, device=None):
    """Distance along the Hilbert curve of order ``order`` for integer
    coordinate arrays ``x``, ``y`` (the classic rotation loop, the JAX
    package's ``xy_to_d``, hilbert.py:31). The JAX package's values, as
    int64 where it returns uint32 (uint64 above order 16): its uint32
    arithmetic is emulated in int64, exact through order 31. Numpy input
    goes to ``device`` (``cuda`` by default); tensors stay where they
    are."""
    if not 1 <= order <= 31:
        raise ValueError(f"xy_to_d: order {order} outside 1..31")
    dev = call_device(x, device)
    x = on_device(x, dev, torch.int64) & _U32
    y = on_device(y, dev, torch.int64) & _U32
    d = torch.zeros_like(x)
    s = 1 << (order - 1)
    while s > 0:
        rx = (x & s) > 0
        ry = (y & s) > 0
        d = d + (s * s) * ((3 * rx.to(torch.int64)) ^ ry.to(torch.int64))
        swap = ~ry
        flip = swap & rx
        x_f = torch.where(flip, (s - 1 - x) & _U32, x)
        y_f = torch.where(flip, (s - 1 - y) & _U32, y)
        x, y = torch.where(swap, y_f, x_f), torch.where(swap, x_f, y_f)
        s >>= 1
    return d


def pixel_visit_order_plain(width: int, height: int, device="cpu"):
    """(width*height,) int32: ``perm[i]`` is the row-major index of the
    i-th pixel in ascending curve distance (argsort of the keys)."""
    idx = torch.arange(width * height, dtype=torch.int64, device=device)
    d = xy_to_d(idx % width, idx // width, curve_order(width, height))
    return torch.argsort(d).to(torch.int32)


def d_to_xy(d, levels: int, c=0, s=0):
    """The inverse of ``xy_to_d`` over ``levels`` levels, as the kernel
    runs it: numpy int64 distances -> (x, y, c, s). A level's digit gives
    the bits (rx, ry) of the rotated coordinates; the rotation so far is a
    complement of both (``c``) and a swap (``s``), which commute, so the
    image's bits are ``swap^s(complement^c(rx, ry))``; a digit with ry = 0
    then flips ``s`` and, with rx = 1, ``c``. ``c`` and ``s`` (scalars or
    arrays) are the state to start from; the returned ones are the state
    after the last level."""
    d = np.asarray(d, np.int64)
    x = np.zeros_like(d)
    y = np.zeros_like(d)
    c = np.broadcast_to(np.asarray(c, np.int64), d.shape).copy()
    s = np.broadcast_to(np.asarray(s, np.int64), d.shape).copy()
    rxs, rys = np.array(_RX), np.array(_RY)
    for lv in range(levels - 1, -1, -1):
        q = (d >> (2 * lv)) & 3
        rx, ry = rxs[q], rys[q]
        ax, ay = rx ^ c, ry ^ c
        x |= np.where(s == 1, ay, ax) << lv
        y |= np.where(s == 1, ax, ay) << lv
        turn = ry == 0
        c = np.where(turn, c ^ rx, c)
        s = np.where(turn, s ^ 1, s)
    return x, y, c, s


def _span(a, n, limit):
    """Cells of [a, a + n) below ``limit`` (numpy, elementwise)."""
    return np.clip(limit - a, 0, n)


def visit_order_model(width: int, height: int):
    """csrc/hilbert.cu's arithmetic in numpy (for tests and measurement; on
    no path): the (width*height,) int32 visit order.

    The square of side 2^order is cut into tiles of side 2^b, b =
    min(TILE_BITS, order); tile t in curve order holds the distances [t
    4^b, (t + 1) 4^b). The tiles that meet the image are found by rank:
    the j-th of them descends the quadtree of tiles from the root, taking
    at each level the first child, in curve order, whose count of
    image-meeting tiles exceeds what is left of j, and adding the pixels
    of the children it passes (both counts in closed form) to the tile's
    output offset; the descent also yields the tile's corner and the
    rotation state there. A tile's cells in curve order are one canonical
    table (the inverse over b levels from state (0, 0)) under that state:
    complement (2^b - 1 - v) if c, swap if s. The in-image cells are
    written at the offset in order (the kernel: a tile inside the image
    through a table of each state's cell offsets, a tile on its edge by a
    ballot and a popc a 32 cells)."""
    order = curve_order(width, height)
    b = min(TILE_BITS, order)
    levels = order - b
    side = 1 << b
    tw, th = -(-width // side), -(-height // side)
    n_tiles = tw * th
    rank = np.arange(n_tiles, dtype=np.int64)
    tx = np.zeros(n_tiles, np.int64)
    ty = np.zeros(n_tiles, np.int64)
    c = np.zeros(n_tiles, np.int64)
    s = np.zeros(n_tiles, np.int64)
    off = np.zeros(n_tiles, np.int64)
    for lv in range(levels - 1, -1, -1):
        half = 1 << lv
        done = np.zeros(n_tiles, bool)
        for q in range(4):
            ax, ay = _RX[q] ^ c, _RY[q] ^ c
            cx = tx + np.where(s == 1, ay, ax) * half
            cy = ty + np.where(s == 1, ax, ay) * half
            count = _span(cx, half, tw) * _span(cy, half, th)
            take = ~done & ((rank < count) | (q == 3))
            skip = ~done & ~take
            rank = np.where(skip, rank - count, rank)
            off = np.where(skip, off + _span(cx * side, half * side, width)
                           * _span(cy * side, half * side, height), off)
            tx, ty = np.where(take, cx, tx), np.where(take, cy, ty)
            if _RY[q] == 0:
                c = np.where(take, c ^ _RX[q], c)
                s = np.where(take, s ^ 1, s)
            done |= take
    lx, ly, _, _ = d_to_xy(np.arange(side * side), b)
    lx, ly = lx[None, :], ly[None, :]
    m = side - 1
    cc, ss = c[:, None] == 1, s[:, None] == 1
    ax, ay = np.where(cc, m - lx, lx), np.where(cc, m - ly, ly)
    x = tx[:, None] * side + np.where(ss, ay, ax)
    y = ty[:, None] * side + np.where(ss, ax, ay)
    inside = (x < width) & (y < height)
    at = off[:, None] + np.cumsum(inside, axis=1) - 1
    perm = np.full(width * height, -1, np.int64)
    perm[at[inside]] = (y * width + x)[inside]
    return perm.astype(np.int32)


def visit_order(width: int, height: int, device="cuda"):
    """(width*height,) int32 visit order: ``perm[i]`` is the row-major
    index of the i-th pixel in ascending curve distance. On the card (the
    default) one launch of the kernel, no sort; with ``device="cpu"`` the
    plain version."""
    device = torch.device(device)
    width, height = int(width), int(height)
    if device.type == "cpu":
        return pixel_visit_order_plain(width, height, device)
    if width < 1 or height < 1 or width * height >= 1 << 31 \
            or curve_order(width, height) > MAX_ORDER:
        raise ValueError(f"visit_order: {width}x{height}")
    if device.type != "cuda":
        raise ValueError(f"visit_order: {device} is not a CUDA device")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "visit_order: CUDA device not available; pass device='cpu' to "
            "run the plain version")
    out = torch.empty((width * height,), dtype=torch.int32, device=device)
    side = 1 << min(TILE_BITS, curve_order(width, height))
    tiles = -(-width // side) * -(-height // side)
    blocks = max(1, min(-(-tiles // WARPS), BLOCKS_PER_SM
                        * build.sm_count(device)))
    err = build.library().pt_visit_order(
        width, height, curve_order(width, height), blocks, build.ptr(out),
        build.stream())
    build.check(err, "visit_order")
    kernels.LAUNCHES["visit_order"] += 1
    return out

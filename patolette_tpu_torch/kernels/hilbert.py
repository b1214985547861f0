"""K7: Hilbert-curve index of every pixel of a ``width x height`` image.

Kernel: ``csrc/hilbert.cu``. Twin: the JAX package's ``xy_to_d``
(``hilbert.py:31-59``) over the row-major pixel grid, as
``pixel_visit_order`` (``hilbert.py:62-79``) calls it. Keys are int64
holding the exact uint32 ``d`` (orders 1..16).
"""

from __future__ import annotations

import torch

from patolette_tpu_torch import kernels
from patolette_tpu_torch.kernels import build

MAX_ORDER = 16
_U32 = 0xFFFFFFFF


def xy_to_d(x, y, order: int):
    """Distance along the Hilbert curve of order ``order`` for integer
    coordinate tensors (the classic rotation loop); uint32 arithmetic
    emulated in int64, so ``d`` is exact through order 16."""
    if not 1 <= order <= MAX_ORDER:
        raise ValueError(f"xy_to_d: order {order} outside 1..{MAX_ORDER}")
    x = x.to(torch.int64) & _U32
    y = y.to(torch.int64) & _U32
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


def hilbert_keys_plain(width: int, height: int, order: int, device):
    idx = torch.arange(width * height, dtype=torch.int64, device=device)
    return xy_to_d(idx % width, idx // width, order)


def hilbert_keys(width: int, height: int, order: int, device):
    """(width*height,) int64 curve index of each row-major pixel."""
    device = torch.device(device)
    if device.type == "cpu":
        return hilbert_keys_plain(width, height, order, device)
    if not 1 <= order <= MAX_ORDER or (1 << order) < max(width, height):
        raise ValueError(f"hilbert_keys: order {order} for {width}x{height}")
    n = width * height
    keys = torch.empty((n,), dtype=torch.int64, device=device)
    if n == 0:
        return keys
    err = build.library().pt_hilbert_keys(
        n, width, order, build.ptr(keys), build.stream())
    build.check(err, "hilbert_keys")
    kernels.LAUNCHES["hilbert_keys"] += 1
    return keys

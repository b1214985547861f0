"""K6: run-length encode of a u8 LUT slice (the v2 wire format).

Kernel: ``csrc/rle.cu`` (per-128-block counts summed per group of 256
blocks, one scan of the group sums, per-block writes).
Twin: the JAX package's ``_rle_encode_u8_v2`` (``lut.py:206-267``), which
compacts with two sorts; the plain version here compacts with ``nonzero``.

Format, u16 words: ``[count_lo, count_hi, overflow, w_0 .. w_{count-1}]``
with ``w_i = (pos_i - pos_{i-1}) << 8 | x[pos_i]``, ``pos_0 = 0``, a run
start forced at every 128th position. ``overflow``: a 128-block holds more
than 32 run starts, or ``count > MAX_RUNS``; the words are then not to be
read (the JAX package leaves sort sentinels there, the port leaves them
unwritten). The buffer holds ``4 + 32 * L / 128`` words, one more than the
JAX package's, so that it is a whole number of int32 words: the
multi-device route exchanges it as int32 slots.
"""

from __future__ import annotations

import torch

from patolette_tpu_torch import kernels
from patolette_tpu_torch.kernels import build

FORCE = 128
COLS = 32
MAX_RUNS = (1 << 21) - 1
GROUP = 256  # 128-blocks a thread block of the kernel takes


def buffer_words(length: int) -> int:
    return 4 + COLS * (length // FORCE)


def header(enc):
    """``(count, overflow)`` of an encoded buffer (a host read)."""
    h = enc[:3].cpu().to(torch.int32).tolist()
    return h[0] | (h[1] << 16), bool(h[2])


def _check(table):
    if table.dtype != torch.uint8 or table.dim() != 1:
        raise TypeError("rle_encode_u8_v2: a (L,) uint8 table")
    if table.shape[0] < FORCE or table.shape[0] % FORCE:
        raise ValueError("rle_encode_u8_v2: length must be a multiple of 128")


def rle_encode_u8_v2_plain(table):
    _check(table)
    n = table.shape[0]
    x = table.to(torch.int32)
    start = torch.ones((n,), dtype=torch.bool, device=table.device)
    start[1:] = x[1:] != x[:-1]
    start[::FORCE] = True
    count = int(start.sum())
    overflow = (bool((start.view(-1, FORCE).sum(1) > COLS).any())
                or count > MAX_RUNS)
    out = torch.zeros((buffer_words(n),), dtype=torch.int32,
                      device=table.device)
    out[0], out[1], out[2] = count & 0xFFFF, count >> 16, int(overflow)
    if not overflow:
        pos = torch.nonzero(start).squeeze(1)
        delta = torch.diff(pos, prepend=pos[:1])
        out[3:3 + count] = ((delta << 8) | x[pos]).to(torch.int32)
    return out.to(torch.uint16)


def rle_encode_u8_v2(table):
    """(L,) u8 table -> its (4 + L / 4,) u16 v2 buffer (module docstring);
    L a multiple of 128."""
    if table.device.type == "cpu":
        return rle_encode_u8_v2_plain(table)
    _check(table)
    if table.data_ptr() % 4:
        table = table.clone()
    build.require_cuda("rle_encode_u8_v2", table)
    rows = table.shape[0] // FORCE
    dev = table.device
    n_words = buffer_words(table.shape[0])
    out = torch.empty((n_words // 2,), dtype=torch.int32,
                      device=dev).view(torch.uint16)
    groups = -(-rows // GROUP)
    counts = torch.empty((rows + 3 * groups,), dtype=torch.int32, device=dev)
    last = torch.empty((rows,), dtype=torch.uint8, device=dev)
    err = build.library().pt_rle_encode_u8_v2(
        build.ptr(table), rows, build.ptr(counts[:rows]), build.ptr(last),
        build.ptr(counts[rows:]), build.ptr(out), n_words, build.stream(),
    )
    build.check(err, "rle_encode_u8_v2")
    kernels.LAUNCHES["rle_encode"] += 1
    return out

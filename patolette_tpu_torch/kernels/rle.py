"""K6: run-length encode of a LUT table, in the three wire formats of the
JAX package's ``pull_lut``.

Kernel: ``csrc/rle.cu`` (one launch, templated on the format: groups of
32 KB of 128-blocks taken by ticket and copied into shared memory, so the
table is read once; their offsets by look-back over the groups before).
Twins: the JAX package's ``_rle_encode_u8_v2`` (``lut.py:206-267``),
``_rle_encode_u8`` (v1, ``lut.py:187-203``) and ``_rle_encode_u16_v2``
(``lut.py:270-310``), which compact with sorts; the plain versions here
compact with ``nonzero``.

A position starts a run where its entry differs from the one before.

* v2 (:func:`rle_encode_u8_v2`), u8 table, u16 words: ``[count_lo,
  count_hi, overflow, w_0 .. w_{count-1}]`` with ``w_i = (pos_i -
  pos_{i-1}) << 8 | x[pos_i]``, ``pos_0 = 0``, a run start forced at every
  128th position. ``overflow``: a 128-block holds more than 32 run starts,
  or ``count > MAX_RUNS``. The buffer holds ``4 + 32 * L / 128`` words, one
  more than the JAX package's, so that it is a whole number of int32 words:
  the multi-device route exchanges it as int32 slots.
* v1 (:func:`rle_encode_u8`), u8 table, u32 words: ``[count, w_0 ..]``
  with ``w_i = pos_i << 8 | x[pos_i]``; no forced start, no per-block cap.
  The buffer holds ``1 + MAX_RUNS`` words, the JAX size: words past
  ``MAX_RUNS`` are not written, but ``count`` stays exact, and the reader
  takes the table raw when ``count > MAX_RUNS``.
* u16 v2 (:func:`rle_encode_u16_v2`), u16 table, u32 words: ``[count,
  overflow, w_0 ..]`` with ``w_i = (pos_i - pos_{i-1}) << 16 | x[pos_i]``,
  v2's forced starts and overflow; ``2 + 32 * L / 128`` words, the JAX
  size.

Where the header says not to read them, the JAX buffers hold sort
sentinels and the port's hold nothing the format defines; past ``count``
likewise.
"""

from __future__ import annotations

import torch

from patolette_tpu_torch import kernels
from patolette_tpu_torch.kernels import build

FORCE = 128
COLS = 32
MAX_RUNS = (1 << 21) - 1
GROUP = 128  # fewest 128-blocks a thread block of the kernel takes
V1_WORDS = 1 + MAX_RUNS


def buffer_words(length: int) -> int:
    """Words of a v2 buffer for a table of ``length`` entries."""
    return 4 + COLS * (length // FORCE)


def buffer_words_u16(length: int) -> int:
    """Words of a u16 v2 buffer for a table of ``length`` entries."""
    return 2 + COLS * (length // FORCE)


def header(enc):
    """``(count, overflow)`` of a v2 buffer (a host read)."""
    h = enc[:3].cpu().to(torch.int32).tolist()
    return h[0] | (h[1] << 16), bool(h[2])


def header_v1(enc) -> int:
    """``count`` of a v1 buffer (a host read)."""
    return int(enc[:1].cpu().numpy()[0])


def header_u16_v2(enc):
    """``(count, overflow)`` of a u16 v2 buffer (a host read)."""
    h = enc[:2].cpu().numpy()
    return int(h[0]), bool(h[1])


def _check(table, dtype, name, most=None):
    if table.dtype != dtype or table.dim() != 1:
        raise TypeError(f"{name}: a (L,) {dtype} table")
    if table.shape[0] < FORCE or table.shape[0] % FORCE:
        raise ValueError(f"{name}: length must be a multiple of 128")
    if most is not None and table.shape[0] > most:
        raise ValueError(f"{name}: at most {most} entries")


def _starts(x, forced):
    """Run-start flags of ``x``; with ``forced`` also every 128th."""
    start = torch.ones((x.shape[0],), dtype=torch.bool, device=x.device)
    start[1:] = x[1:] != x[:-1]
    if forced:
        start[::FORCE] = True
    return start


def _overflow(start, count):
    return bool((start.view(-1, FORCE).sum(1) > COLS).any()) \
        or count > MAX_RUNS


def _delta_words(x, start, shift):
    pos = torch.nonzero(start).squeeze(1)
    delta = torch.diff(pos, prepend=pos[:1])
    return (delta << shift) | x[pos]


def rle_encode_u8_v2_plain(table):
    _check(table, torch.uint8, "rle_encode_u8_v2")
    x = table.to(torch.int32)
    start = _starts(x, True)
    count = int(start.sum())
    overflow = _overflow(start, count)
    out = torch.zeros((buffer_words(x.shape[0]),), dtype=torch.int32,
                      device=table.device)
    out[0], out[1], out[2] = count & 0xFFFF, count >> 16, int(overflow)
    if not overflow:
        out[3:3 + count] = _delta_words(x, start, 8).to(torch.int32)
    return out.to(torch.uint16)


def rle_encode_u8_plain(table):
    _check(table, torch.uint8, "rle_encode_u8", 1 << 24)
    x = table.to(torch.int64)
    start = _starts(x, False)
    out = torch.zeros((V1_WORDS,), dtype=torch.int64, device=table.device)
    out[0] = int(start.sum())
    pos = torch.nonzero(start).squeeze(1)[:MAX_RUNS]
    out[1:1 + pos.shape[0]] = (pos << 8) | x[pos]
    return out.to(torch.uint32)


def rle_encode_u16_v2_plain(table):
    _check(table, torch.uint16, "rle_encode_u16_v2")
    x = table.to(torch.int64)
    start = _starts(x, True)
    count = int(start.sum())
    overflow = _overflow(start, count)
    out = torch.zeros((buffer_words_u16(x.shape[0]),), dtype=torch.int64,
                      device=table.device)
    out[0], out[1] = count, int(overflow)
    if not overflow:
        out[2:2 + count] = _delta_words(x, start, 16)
    return out.to(torch.uint32)


def _launch(name, table, out, n_words):
    """Launch ``pt_<name>`` on ``table`` into the ``n_words`` words of
    ``out`` and count it. The groups' status words and tickets are one
    reused scratch buffer, which the kernel leaves at 0."""
    if table.data_ptr() % 16:  # the kernel copies 16-byte pieces
        table = table.clone()
    build.require_cuda(name, table, out)
    rows = table.shape[0] // FORCE
    status = build.scratch("rle_encode.status", -(-rows // GROUP) + 1,
                           torch.int64, table.device, zero=True)
    err = getattr(build.library(), "pt_" + name)(
        build.ptr(table), rows, build.ptr(status), build.ptr(out), n_words,
        build.stream())
    build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return out


def rle_encode_u8_v2(table):
    """(L,) u8 table -> its (4 + L / 4,) u16 v2 buffer (module docstring);
    L a multiple of 128."""
    if table.device.type == "cpu":
        return rle_encode_u8_v2_plain(table)
    _check(table, torch.uint8, "rle_encode_u8_v2")
    n_words = buffer_words(table.shape[0])
    out = torch.empty((n_words // 2,), dtype=torch.int32,
                      device=table.device)
    return _launch("rle_encode_u8_v2", table, out,
                   n_words).view(torch.uint16)


def rle_encode_u8(table):
    """(L,) u8 table -> its (1 + MAX_RUNS,) u32 v1 buffer (module
    docstring); L a multiple of 128, at most 2^24."""
    if table.device.type == "cpu":
        return rle_encode_u8_plain(table)
    _check(table, torch.uint8, "rle_encode_u8", 1 << 24)
    out = torch.empty((V1_WORDS,), dtype=torch.uint32, device=table.device)
    return _launch("rle_encode_u8", table, out, V1_WORDS)


def rle_encode_u16_v2(table):
    """(L,) u16 table -> its (2 + L / 4,) u32 buffer (module docstring);
    L a multiple of 128."""
    if table.device.type == "cpu":
        return rle_encode_u16_v2_plain(table)
    _check(table, torch.uint16, "rle_encode_u16_v2")
    n_words = buffer_words_u16(table.shape[0])
    out = torch.empty((n_words,), dtype=torch.uint32, device=table.device)
    return _launch("rle_encode_u16_v2", table, out, n_words)


"""K9: minimum barrier distance (three raster passes).

Kernel: ``csrc/mbd.cu``: one launch a pass, each a set of 32-row bands
walked as systolic wavefronts (a block a band: one warp walks, one stages
the columns through shared memory, one writes them back; bands handed out
by an integer ticket, the row between bands handed over as self-flagging
64-bit words); the first pass also initialises the planes. The ticket
and the words are reused from call to call (``build.scratch``). Twin:
the JAX package's ``mbd`` with ``_wavefront_pass``
(``saliency.py:62-164``): passes inverse, forward, inverse; ``d`` starts
at +inf with zero borders and ``l = u = img``. The plain version walks
the cell anti-diagonals of each pass with vector ops over a diagonal.
Min, max and a subtraction only: every version gives the same bits.
"""

from __future__ import annotations

import torch

from patolette_tpu_torch import kernels
from patolette_tpu_torch.kernels import build


def _init(img):
    l = img.clone()
    u = img.clone()
    d = torch.full_like(img, torch.inf)
    d[0, :] = 0.0
    d[-1, :] = 0.0
    d[:, 0] = 0.0
    d[:, -1] = 0.0
    return l, u, d


def _pass_plain(img, l, u, d, inverse):
    """One raster pass on flat (rows*cols,) views, updated in place, one
    anti-diagonal of active cells at a time (each reads the diagonal
    before it)."""
    rows, cols = img.shape
    img, l, u, d = (t.view(-1) for t in (img, l, u, d))
    lo = 2 if inverse else 1
    x_hi, y_hi = rows - 2, cols - 2
    if x_hi < lo or y_hi < lo:
        return
    step = 1 if inverse else -1
    n1, n2 = step * cols, step  # neighbour 1: (x + step, y); 2: (x, y + step)
    xoff = torch.arange(rows, device=img.device) * (cols - 1)
    diags = range(2 * lo, x_hi + y_hi + 1)
    for dg in (reversed(diags) if inverse else diags):
        xa, xb = max(lo, dg - y_hi), min(x_hi, dg - lo)
        flat = xoff[xa:xb + 1] + dg          # x * cols + (dg - x)
        ix, dd = img[flat], d[flat]
        hi1 = torch.maximum(u[flat + n1], ix)
        lo1 = torch.minimum(l[flat + n1], ix)
        hi2 = torch.maximum(u[flat + n2], ix)
        lo2 = torch.minimum(l[flat + n2], ix)
        b1, b2 = hi1 - lo1, hi2 - lo2
        keep = (dd <= b1) & (dd <= b2)
        use1 = ~keep & (b1 < dd) & (b1 <= b2)
        use2 = ~keep & ~use1
        d[flat] = torch.where(use1, b1, torch.where(use2, b2, dd))
        u[flat] = torch.where(use1, hi1, torch.where(use2, hi2, u[flat]))
        l[flat] = torch.where(use1, lo1, torch.where(use2, lo2, l[flat]))


def mbd_plain(img):
    l, u, d = _init(img)
    for it in range(3):
        _pass_plain(img, l, u, d, inverse=it % 2 == 0)
    return d, l, u


def mbd(img, return_lu=False):
    """Minimum barrier distance of the (rows, cols) f32 image; with
    ``return_lu`` also the final lower and upper barrier planes."""
    if img.device.type == "cpu":
        d, l, u = mbd_plain(img)
        return (d, l, u) if return_lu else d
    if img.dtype != torch.float32 or img.dim() != 2:
        raise TypeError("mbd: a (rows, cols) f32 image")
    rows, cols = img.shape
    if rows < 1 or cols < 1:
        raise ValueError("mbd: empty image")
    img = img.contiguous()
    build.require_cuda("mbd", img)
    # the first pass initialises the planes where it has cells to update
    init = rows >= 4 and cols >= 4
    if init:
        l, u, d = (torch.empty_like(img) for _ in range(3))
    else:
        l, u, d = _init(img)
    dev = img.device
    ticket = build.scratch("mbd.ticket", 1, torch.int32, dev, zero=True)
    words = build.scratch("mbd.handover", -(-max(rows - 2, 1) // 32) * cols,
                          torch.int64, dev, zero=True)
    err = build.library().pt_mbd(
        build.ptr(img), build.ptr(l), build.ptr(u), build.ptr(d), rows, cols,
        int(init), build.ptr(ticket), build.ptr(words), build.stream(),
    )
    build.check(err, "mbd")
    kernels.LAUNCHES["mbd"] += 1
    return (d, l, u) if return_lu else d

"""The pixel axis laid over the ranks of a ``torch.distributed`` group.

Port of ``patolette_tpu/parallel/mesh.py``. The JAX package shards the
pixel axis over a 1-D device mesh and runs its pipeline as the body of a
``shard_map``; here each rank is one process with one device, rank r
holds the r-th contiguous slice of the pixels (a row strip when the height
divides), and the "shard body" is the port's ordinary code with
``mesh=`` passed down. NCCL carries the exchanges across GPUs; gloo
carries them on the CPU and for several ranks sharing one card (NCCL
refuses two ranks on one GPU).

Every cross-rank reduction goes through :func:`exchange`: an all-reduce
of a zero-filled ``(world, ...)`` slot buffer in which this rank has
written only its own slot. That is an exact all-gather (``x + 0 = x``),
whatever algorithm the backend picks; each rank then sums (or takes the
min or max over) the slots in rank order. So every rank holds the same
bits, which the greedy LQ loop needs (a rank that took another split
would issue another number of collectives and hang the group), the sums
are deterministic, and with one rank they equal the single-device sums.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from patolette_tpu_torch.kernels.colorspace import color_convert
from patolette_tpu_torch.models import dither as DITH
from patolette_tpu_torch.models import saliency as SAL
from patolette_tpu_torch.utils.device import on_device, resolve_device

# Slot types every backend reduces (not u8/u16).
_SLOT_DTYPES = (torch.int32, torch.int64, torch.float32, torch.float64)


class Mesh:
    """The shard axis: a process group and this rank's device.

    ``group``: a ``torch.distributed`` group (default: the default group,
    which must be initialised). ``device``: this rank's device, by default
    ``cuda:<LOCAL_RANK or 0>``; ``"cpu"`` runs the kernels' plain
    versions, as everywhere in the port.
    """

    def __init__(self, group=None, device=None):
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                "Mesh needs an initialised torch.distributed process group "
                "(parallel.distributed.init_distributed)")
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group)).lower()
        self.device = rank_device(device)
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            # the kernels launch on the current device's stream
            torch.cuda.set_device(self.device)


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device``, by default ``cuda:<LOCAL_RANK or
    0>``. A CUDA device where there is none fails (typed); only an explicit
    ``"cpu"`` runs the plain versions."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    return resolve_device(device)


def shard_range(n: int, mesh) -> tuple[int, int]:
    """``[lo, hi)`` of this rank's contiguous slice of ``n`` items; ``n``
    must divide over the ranks (the JAX package's ``P(AXIS)`` split)."""
    if n % mesh.world:
        raise ValueError(f"{n} items do not divide over {mesh.world} ranks")
    per = n // mesh.world
    return mesh.rank * per, (mesh.rank + 1) * per


def per_rank_cap(cap: int, mesh) -> int:
    """This rank's share of a global sample cap (ceil division), as the
    JAX package's ``_per_shard_cap``."""
    cap = int(cap)
    if cap and mesh is not None:
        cap = -(-cap // mesh.world)
    return cap


def exchange(mesh, t):
    """``(world, *t.shape)``: slot r holds rank r's ``t``, on every rank,
    on ``t``'s device. Every rank must call it with the same shape and
    type."""
    if t.dtype not in _SLOT_DTYPES:
        raise TypeError(f"exchange: {t.dtype} slots (int32, int64, f32, f64)")
    # NCCL reduces tensors on the mesh's device, gloo host tensors
    on = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    slots = torch.zeros((mesh.world,) + tuple(t.shape), dtype=t.dtype,
                        device=on)
    slots[mesh.rank] = t
    dist.all_reduce(slots, op=dist.ReduceOp.SUM, group=mesh.group)
    return slots.to(t.device)


def _fold(mesh, t, op):
    if mesh is None:
        return t
    slots = exchange(mesh, t)
    acc = slots[0].clone()
    for r in range(1, mesh.world):
        acc = op(acc, slots[r])
    return acc


def psum(mesh, t):
    """Sum of every rank's ``t``, rank 0 first (``t`` itself without a
    mesh)."""
    return _fold(mesh, t, torch.add)


def pmin(mesh, t):
    return _fold(mesh, t, torch.minimum)


def pmax(mesh, t):
    return _fold(mesh, t, torch.maximum)


def gather(mesh, t):
    """Every rank's ``t`` concatenated along dim 0 in rank order."""
    if mesh is None:
        return t
    slots = exchange(mesh, t)
    return slots.reshape((-1,) + tuple(t.shape[1:]))


def rank_offset(mesh, count: int) -> int:
    """Sum of ``count`` over the ranks below this one (0 without a
    mesh)."""
    if mesh is None:
        return 0
    counts = exchange(mesh, torch.tensor([int(count)], dtype=torch.int64))
    return int(counts[:mesh.rank].sum())


# --- The JAX package's shard_map factories (mesh.py:100-243). Each returns
# the function a rank calls on its own rows; the JAX shard body is the
# port's ordinary code with ``mesh=``. Nothing is cached on the mesh: the
# JAX cache keeps jax.jit's identity, here it would only keep groups alive.


def pad_to_shards(n: int, n_shards: int) -> int:
    """``n`` rounded up to a multiple of ``n_shards``."""
    return -(-n // n_shards) * n_shards


def _srgb_strip(channels, device):
    """A rank's 3-tuple of (N,) sRGB channels, raw uint8 or f32, as K10
    takes them: uint8 stacked into (N, 3) bytes (one copy, K10's byte
    path; the bits of the port's uint8 routes), floats as f32 planes."""
    ch = tuple(on_device(c, device) for c in channels)
    if ch[0].dtype == torch.uint8:
        return torch.stack(ch, dim=1)
    return ch


def _check_form(colors, planar):
    if isinstance(colors, (tuple, list)) != bool(planar):
        raise ValueError("planar=True takes a 3-tuple of (N,) channels, "
                         "planar=False (N, 3) rows")


def quantize_palette_sharded(mesh, palette_size: int, color_space: int = 2,
                             kmeans_niter: int = 0,
                             kmeans_max_samples: int = 512**2,
                             seed: int = 1234, *, lq_max_samples: int = 0,
                             planar: bool = False, with_map: bool = True):
    """The palette pipeline over the ranks of ``mesh`` (JAX
    ``mesh.py:105-147``): ``fn(colors, weights)`` runs
    ``models.pipeline.palette_pipeline_device(..., mesh=mesh)`` on this
    rank's rows, with ``lq_batch_splits`` 8 as the JAX factory. Every rank
    of the group calls its ``fn`` once with its own rows.

    ``colors``: (N, 3) sRGB rows, or with ``planar`` a 3-tuple of (N,)
    channels (raw uint8 or f32); ``weights``: (N,) or None. Numpy input
    goes to the mesh's device. Returns ``(palette_working, valid,
    local_map)`` on that device, the palette the same bits on every rank
    and the map this rank's rows; ``with_map=False`` returns
    ``(palette_working, valid)``. ``lq_max_samples`` caps the GQ/LQ search
    over all ranks, each drawing its share from ``(seed, rank)``.
    """
    # the pipeline imports this module
    from patolette_tpu_torch.models import pipeline as PIPE

    def fn(colors, weights=None):
        _check_form(colors, planar)
        return PIPE.palette_pipeline_device(
            colors, weights, palette_size, color_space, kmeans_niter,
            kmeans_max_samples, seed, mesh=mesh,
            lq_max_samples=lq_max_samples, with_map=with_map)

    return fn


def saliency_sharded(mesh, width: int, strip_h: int, tile_size: float,
                     total_pixels: int):
    """Saliency of each rank's ``strip_h x width`` row strip (JAX
    ``mesh.py:150-187``): ``fn(channels)`` takes a 3-tuple of (N,) sRGB
    channels (raw uint8 or f32) and returns the strip's (N,) f32 weights
    on the mesh's device. The strip's edges act as the image's borders
    (MBD and both priors are strip-local); the weights keep the whole
    image's scale through ``total_pixels``. K10, then K9 and K10 (lab)."""
    if strip_h <= 3:
        raise ValueError(f"a strip of {strip_h} rows is too thin for the "
                         "MBD stencil")

    def fn(channels):
        x = _srgb_strip(channels, mesh.device)
        planes = x if isinstance(x, tuple) else color_convert(x, 0, "working")
        return SAL.get_weights_planar(planes, strip_h, width, tile_size,
                                      total_pixels=total_pixels)

    return fn


def dither_sharded(mesh, width: int, height: int, color_space: int,
                   segment: int = 4096, *, planar: bool = False):
    """Riemersma dither of each rank's row strip along its own curve with a
    fresh error queue (JAX ``mesh.py:190-243``).
    ``fn(colors, palette_working, valid)`` returns the strip's (N,) int32
    map on the mesh's device. ``colors``: (N, 3) working-space rows, or with
    ``planar`` a 3-tuple of (N,) sRGB channels (raw uint8 or f32), which go
    from sRGB straight to linear Rec2020 in one K10 pass (JAX
    ``mesh.py:210-219``); then K7 and K8."""
    if height % mesh.world:
        raise ValueError(f"the height ({height}) does not divide over "
                         f"{mesh.world} ranks")
    strip_h = height // mesh.world

    def fn(colors, palette_working, valid):
        _check_form(colors, planar)
        dev = mesh.device
        if not planar:
            return DITH.riemersma_dither(colors, palette_working, valid,
                                         width, strip_h, color_space,
                                         segment, device=dev)
        ch2020 = color_convert(_srgb_strip(colors, dev), 0, "rec2020_direct")
        return DITH.riemersma_dither_rec2020(
            ch2020, on_device(palette_working, dev),
            on_device(valid, dev, torch.bool), width, strip_h, color_space,
            segment)

    return fn

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
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device not available; pass device='cpu' to run the plain "
            "versions of the kernels")
    return device


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

"""One call per process: the sharded route over a ``torch.distributed``
group, each process feeding only its own rows.

Port of ``patolette_tpu/parallel/distributed.py``. The JAX package lays one
mesh over every process's devices and feeds each process's rows into the
global arrays (``put_planar_local``), then reads each process's rows of
the map back (``local_shard``). Here each process is one rank with one
device, so the same program is :func:`quantize_distributed` on the rank's
rows, which returns the palette (the same on every rank) and the rank's
rows of the map.

Launch, one process per device (or several on one card, over gloo):

    from patolette_tpu_torch.parallel import distributed as D
    mesh = D.init_distributed("tcp://host0:29500", world_size, rank)
    ok, palette, local_map, msg = D.quantize_distributed(
        width, height, my_rows, 256, mesh=mesh)

where ``my_rows`` are rows ``[rank * n / world, (rank + 1) * n / world)``
of the (width * height, 3) image.
"""

from __future__ import annotations

import datetime
import inspect

import torch.distributed as dist

from patolette_tpu_torch.models import pipeline as PIPE
from patolette_tpu_torch.parallel import mesh as PM
from patolette_tpu_torch.parallel.mesh import Mesh, rank_device

DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)

# quantize's own keyword defaults, so the two entry points cannot drift
_DEFAULTS = {
    name: par.default
    for name, par in inspect.signature(PIPE.quantize).parameters.items()
    if par.default is not inspect.Parameter.empty
}


def init_distributed(init_method: str, world_size: int, rank: int, *,
                     backend: str | None = None, device=None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT,
                     store=None) -> Mesh:
    """Join the process group (``torch.distributed.init_process_group``)
    and return this rank's :class:`Mesh`. ``init_method``: the group's
    address, e.g. ``tcp://localhost:29500`` (ignored with ``store``).
    ``device``: this rank's device, by default ``cuda:<LOCAL_RANK or 0>``;
    with no CUDA device the call fails (typed) before joining, unless the
    caller passes ``"cpu"``. ``backend``: ``nccl`` for one GPU a rank,
    ``gloo`` on the CPU or for several ranks on one card; by default
    ``nccl`` on a GPU. Every collective fails after ``timeout`` instead of
    hanging."""
    device = rank_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kw = dict(backend=backend, world_size=int(world_size), rank=int(rank),
              timeout=timeout)
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = init_method
    dist.init_process_group(**kw)
    return Mesh(device=device)


def quantize_distributed(width: int, height: int, local_rows,
                         palette_size: int, *, mesh: Mesh, **kw):
    """Quantize the (width * height, 3) image of which this rank holds
    ``local_rows``, rows ``[rank * n / world, (rank + 1) * n / world)``.
    Keywords and their defaults as :func:`patolette_tpu_torch.quantize`
    (``weights``: this rank's rows' weights; ``device``, if given, must be
    the mesh's). Every rank of ``mesh`` must call it with the same
    arguments but its rows. Returns ``(success, palette, local_map,
    message)``: the palette as ``quantize`` returns it, the same on every
    rank, and the map of this rank's rows. Shapes that do not divide over
    the ranks fail: no rank holds the whole image to fall back on."""
    try:
        return PIPE._quantize_body(width, height, local_rows, palette_size,
                                   **{**_DEFAULTS, **kw, "mesh": mesh},
                                   local=True)
    except Exception as e:  # noqa: BLE001 -- the reference's -1 surface
        return PIPE.typed_failure(e)


def quantize_palette_distributed(mesh: Mesh, palette_size: int, **kw):
    """The palette pipeline over the processes of ``mesh``: the same
    function as :func:`parallel.mesh.quantize_palette_sharded`, with its
    arguments (JAX ``distributed.py:82-88``). Each process calls the
    returned ``fn`` on its own rows and gets the palette and its rows'
    map."""
    return PM.quantize_palette_sharded(mesh, palette_size, **kw)


def dither_distributed(mesh: Mesh, width: int, height: int,
                       color_space: int, **kw):
    """Per-strip dither over the processes of ``mesh``: the same function
    as :func:`parallel.mesh.dither_sharded`, with its arguments (JAX
    ``distributed.py:91-96``)."""
    return PM.dither_sharded(mesh, width, height, color_space, **kw)

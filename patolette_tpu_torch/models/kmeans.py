"""Weighted Lloyd KMeans palette refinement.

Port of ``patolette_tpu/models/kmeans.py`` (reference refine.c:165-224 and
faiss Clustering.cpp): caller-seeded centres, weights carried through, the
``k * max_points_per_centroid`` sampling cap, exact assignment, weighted
centre update and the empty-cluster split with eps = 1/1024. Every
iteration is one kernel step (K4: the moments, then the update); on the
card the loop enqueues all ``niter`` steps without a host sync. With
``mesh`` each step's ``(P, 4)`` sums are summed over the ranks between the
two.

Divergences, as in the JAX package: samples drawn with replacement; the
donor of an empty-cluster split is the largest cluster. The staged routes
draw their samples on the host (``np.random.default_rng``, see the
pipeline); :func:`subsample` and :func:`refine_palette` draw on the device
from a ``torch.Generator`` where the JAX package draws with ``jax.random``
(the same distribution, other numbers: README T6).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from patolette_tpu_torch.kernels.kmeans import kmeans_step
from patolette_tpu_torch.parallel import mesh as PM

MIN_KMEANS_SAMPLES = 256 * 256  # refine.c:21 min_kmeans_samples


def subsample_cap(k: int, max_samples: int) -> int:
    """k * max_points_per_centroid (refine.c:87, integer division)."""
    return (max(int(max_samples), MIN_KMEANS_SAMPLES) // max(k, 1)) * k


def device_generator(device, *words):
    """A ``torch.Generator`` on ``device`` seeded from the integers
    ``words`` (``(seed, stream)``, ``(seed, rank, stream)``, ...) through
    numpy's ``SeedSequence``: the port's counterpart of folding a
    ``jax.random`` key. Seeding it reads nothing from the device."""
    entropy = [int(v) & 0xFFFFFFFFFFFFFFFF for v in words]
    seed = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def draw_indices(n: int, cap: int, seed, device):
    """``cap`` indices into ``n`` rows drawn with replacement on ``device``,
    or None where ``cap`` is 0 or ``n <= cap`` (every row is kept): the
    port's one device draw. ``seed``: an int, or a ``torch.Generator`` on
    that device."""
    if not cap or n <= cap:
        return None
    gen = (seed if isinstance(seed, torch.Generator)
           else device_generator(device, seed))
    return torch.randint(0, n, (int(cap),), generator=gen, device=device)


def subsample(colors, weights, cap: int, seed):
    """At most ``cap`` of the (N, 3) ``colors`` (with their weights),
    drawn with replacement on their device (JAX ``kmeans.py:47-57``).
    ``seed``: an int, or a ``torch.Generator`` on that device."""
    idx = draw_indices(colors.shape[0], cap, seed, colors.device)
    if idx is None:
        return colors, weights
    return (colors[idx].contiguous(),
            None if weights is None else weights[idx])


def lloyd_iterations(samples, weights, centers, valid, niter: int,
                     mesh=None):
    """``niter`` weighted Lloyd iterations over fixed samples (each rank's
    own with ``mesh``). Invalid slots never attract assignments and are
    never updated."""
    samples = samples.contiguous()
    reduce = None if mesh is None else functools.partial(PM.psum, mesh)
    for _ in range(int(niter)):
        centers = kmeans_step(samples, weights, centers, valid,
                              reduce=reduce)
    return centers


def refine_palette(colors, weights, centers, valid, k: int, niter: int,
                   max_samples: int, seed: int, mesh=None):
    """Subsample then iterate (JAX ``kmeans.py:122-148``, refine.c:165-224).
    ``k`` is the static bound on live clusters that sets the cap. With
    ``mesh`` each rank draws its ``ceil(cap / world)`` samples from its own
    pixels with a generator seeded from ``(seed, rank)``, and every step's
    sums are summed over the ranks."""
    cap = subsample_cap(k, max_samples)
    if mesh is not None:
        cap = PM.per_rank_cap(cap, mesh)
        seed = device_generator(colors.device, seed, mesh.rank)
    samples, w = subsample(colors, weights, cap, seed)
    return lloyd_iterations(samples, w, centers, valid, niter, mesh=mesh)

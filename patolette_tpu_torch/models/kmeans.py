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
donor of an empty-cluster split is the largest cluster. The port draws the
samples on the host (``np.random.default_rng``, see the pipeline) where the
JAX package draws them with ``jax.random``.
"""

from __future__ import annotations

import functools

from patolette_tpu_torch.kernels.kmeans import kmeans_step
from patolette_tpu_torch.parallel import mesh as PM

MIN_KMEANS_SAMPLES = 256 * 256  # refine.c:21 min_kmeans_samples


def subsample_cap(k: int, max_samples: int) -> int:
    """k * max_points_per_centroid (refine.c:87, integer division)."""
    return (max(int(max_samples), MIN_KMEANS_SAMPLES) // max(k, 1)) * k


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

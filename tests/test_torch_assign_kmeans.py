"""Port assignment (K3's plain version) and KMeans (K4's) against the JAX
package on the same samples and start centres.

Labels are compared exactly, ties included: both sides compute the same
f32 distances and keep the first minimum. KMeans centres come from f32
sums taken in another order than XLA's, so they meet atol 1e-6 (samples
in [0, 1]); an order-of-summation difference that flipped an assignment
would move a centre by ~1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patolette_tpu.models import kmeans as JKM
from patolette_tpu.ops import assign as JA
from patolette_tpu_torch.kernels.kmeans import kmeans_step
from patolette_tpu_torch.models import kmeans as TKM
from patolette_tpu_torch.ops import assign as TA
from test_torch_cores import share_cores  # noqa: F401


def _planar(x):
    return tuple(torch.from_numpy(x[:, k].copy()) for k in range(3))


@pytest.mark.parametrize("with_invalid", [False, True])
def test_assign_planar_matches_jax_with_ties(with_invalid):
    rng = np.random.default_rng(0)
    centers = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    centers[25:30] = centers[5:10]          # exact duplicates: tied slots
    x = rng.uniform(0, 1, (30000, 3)).astype(np.float32)
    x[:200] = centers[rng.integers(0, 40, 200)]  # pixels ON centres
    valid = np.ones(40, bool)
    if with_invalid:
        valid[[5, 17, 39]] = False
    jl = np.asarray(jax.jit(lambda a, b, c, cc, v: JA.assign_planar(
        (a, b, c), cc, valid=v))(*(x[:, k] for k in range(3)), centers,
                                 valid))
    tl = TA.assign_planar(_planar(x), torch.from_numpy(centers),
                          torch.from_numpy(valid))
    assert tl.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), jl)
    # duplicates resolve to the lower slot; invalid slots never win
    assert not np.isin(tl.numpy(), np.arange(25, 30)[valid[5:10]]).any()
    assert valid[tl.numpy()].all()
    # the (N, 3) form gives the same labels
    np.testing.assert_array_equal(
        TA.assign(torch.from_numpy(x), torch.from_numpy(centers),
                  torch.from_numpy(valid)).numpy(), jl)


_jax_lloyd = jax.jit(JKM.lloyd_iterations, static_argnames=("niter",))


def _km_inputs(seed, p=24, n=20000):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    c = x[rng.choice(n, p, replace=False)].copy()
    valid = np.ones(p, bool)
    valid[-2:] = False
    return x, c, valid


@pytest.mark.parametrize("weighted", [False, True])
def test_lloyd_iterations_match_jax(weighted):
    x, c, valid = _km_inputs(1)
    w = (np.random.default_rng(2).uniform(0.5, 2, len(x)).astype(np.float32)
         if weighted else None)
    jc = np.asarray(_jax_lloyd(
        jnp.asarray(x), None if w is None else jnp.asarray(w),
        jnp.asarray(c), jnp.asarray(valid), niter=6))
    tc = TKM.lloyd_iterations(
        torch.from_numpy(x), None if w is None else torch.from_numpy(w),
        torch.from_numpy(c), torch.from_numpy(valid), 6)
    np.testing.assert_allclose(tc.numpy(), jc, atol=1e-6, rtol=0)
    # invalid slots are never updated
    np.testing.assert_array_equal(tc.numpy()[~valid], c[~valid])


def test_split_empty_matches_jax():
    """Two valid centres far from every sample get no assignment: each
    takes half the mass of the largest cluster, perturbed by +-1/1024."""
    x, c, valid = _km_inputs(3)
    c[3] = [5.0, 5.0, 5.0]
    c[11] = [-4.0, 6.0, -3.0]
    jc = np.asarray(_jax_lloyd(
        jnp.asarray(x), None, jnp.asarray(c), jnp.asarray(valid), niter=3))
    tc, labels = kmeans_step(torch.from_numpy(x), None, torch.from_numpy(c),
                             torch.from_numpy(valid), return_labels=True)
    assert not np.isin(labels.numpy(), [3, 11]).any()
    assert np.abs(tc.numpy()[3]).max() < 1.0   # moved onto a donor
    tc = TKM.lloyd_iterations(torch.from_numpy(x), None, tc,
                              torch.from_numpy(valid), 2)
    np.testing.assert_allclose(tc.numpy(), jc, atol=1e-6, rtol=0)


def test_subsample_cap_matches_jax():
    for k in (1, 16, 24, 256, 1024):
        for m in (0, 1000, 512 ** 2, 10 ** 6):
            assert TKM.subsample_cap(k, m) == JKM.subsample_cap(k, m)

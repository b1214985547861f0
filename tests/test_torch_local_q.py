"""Port LQ (K2's plain version and the round loop) against the JAX package.

The inputs are elongated Gaussian blobs, so every candidate has a clear
principal axis and a clear best cut. Split buckets, member and side bits
and final labels are compared exactly; benefits and means come from f32
sums taken in another order than XLA's (rtol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patolette_tpu.models import global_q as JGQ
from patolette_tpu.models import local_q as JLQ
from patolette_tpu.models import pipeline as JP
from patolette_tpu_torch.models import local_q as TLQ
from patolette_tpu_torch.utils.carry import state_from_numpy
from test_torch_cores import share_cores  # noqa: F401


def _blobs(n=12000, k=6, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.2, 0.8, (k, 3))
    axes = rng.standard_normal((k, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    lab = rng.integers(0, k, n)
    t = rng.standard_normal(n)[:, None] * 0.12
    x = centers[lab] + t * axes[lab] + 0.01 * rng.standard_normal((n, 3))
    return x.astype(np.float32), lab.astype(np.int32)


@pytest.mark.parametrize("weighted", [False, True])
def test_candidates_match_jax(weighted):
    x, lab = _blobs()
    p = 16
    w = (np.random.default_rng(1).uniform(0.5, 2.0, len(x)).astype(
        np.float32) if weighted else np.ones(len(x), np.float32))
    # 6 live clusters plus two dead slots (id p)
    ids = np.array([0, 1, 2, 3, 4, 5, p, p], np.int32)
    jout = jax.jit(lambda c, ww, l, i: JLQ._candidates_segmented(
        c, ww, l, i, p))(x, w, lab, ids)
    jb, jmu, jaxis, jpmin, jpmax, js, jmc, jside, jmember = (
        np.asarray(v) for v in jout)
    st = state_from_numpy(labels=lab)
    tout = TLQ._candidates_segmented(
        torch.from_numpy(x), torch.from_numpy(w), st["labels"],
        torch.from_numpy(ids), p,
    )
    np.testing.assert_array_equal(tout.member.numpy(), jmember)
    np.testing.assert_array_equal(tout.split.numpy(), js)
    np.testing.assert_array_equal(tout.side.numpy(), jside)
    np.testing.assert_allclose(tout.benefit.numpy(), jb, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tout.mu.numpy(), jmu, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tout.axis.numpy(), jaxis, atol=1e-4)
    np.testing.assert_allclose(tout.pmax.numpy(), jpmax, rtol=1e-4)
    np.testing.assert_allclose(tout.mu_child.numpy(), jmc, rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("batch_splits,p", [(1, 16), (8, 128)])
def test_lq_quantize_labels_match_jax(batch_splits, p):
    """GQ runs in JAX; its labels are fed to both LQ implementations. At
    p = 128 the batch cap (p + 15) // 16 lets all 8 splits a round run."""
    x, _ = _blobs(n=16000, k=5, seed=2)
    buckets, bm = JP._gq_bucket_stage(jnp.asarray(x))
    cuts = JGQ.gq_host(np.asarray(bm, np.float64), p)
    k0 = len(cuts) - 1
    labels0 = np.asarray(JGQ.labels_from_cuts(buckets, jnp.asarray(cuts)),
                         np.int32)
    jl, jn = jax.jit(JLQ.lq_quantize, static_argnames=(
        "palette_size", "batch_splits"))(
        jnp.asarray(x), None, jnp.asarray(labels0), k0, palette_size=p,
        batch_splits=batch_splits)
    st = state_from_numpy(labels=labels0, count=k0)
    tl, tn = TLQ.lq_quantize(torch.from_numpy(x), None, st["labels"],
                             st["count"], p, batch_splits=batch_splits)
    assert tn == int(jn)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl, np.int32))


def test_top_b_breaks_ties_to_lowest_index():
    v = torch.tensor([0.5, 2.0, 2.0, 0.0, 2.0, 1.0])
    vals, idx = TLQ.top_b(v, 4)
    assert idx.tolist() == [1, 2, 4, 5]
    jv, ji = jax.lax.top_k(jnp.asarray(v.numpy()), 4)
    assert idx.tolist() == np.asarray(ji).tolist()

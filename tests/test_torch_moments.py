"""Port moments, segment sum (K1's plain version) and eigen3 against the
JAX package on the same inputs.

Tolerances: segment and total sums are f32 sums taken in another order
than XLA's, so they agree to a few f32 ulps of the sums' magnitude
(rtol 1e-5, atol 1e-4 at |partial sums| <= ~100). Bucket ids and the
principal-axis sign are compared exactly: the binning runs the same f32
ops, and the sign decides LQ cuts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patolette_tpu.ops import eigen3 as JE
from patolette_tpu.ops import moments as JM
from patolette_tpu_torch.kernels.segment import segment_sum, segment_sum_plain
from patolette_tpu_torch.ops import eigen3 as TE
from patolette_tpu_torch.ops import moments as TM
from test_torch_cores import share_cores  # noqa: F401


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("s,f", [(512, 11), (17, 4), (256, 4)])
def test_segment_sum_matches_segment_matmul(s, f):
    rng = np.random.default_rng(s)
    n = 40000  # > one 32768 chunk, so the chunked accumulation runs
    feats = rng.standard_normal((n, f)).astype(np.float32)
    ids = rng.integers(0, s + 3, n).astype(np.int32)  # some out of range
    expect = np.asarray(jax.jit(
        lambda a, b: JM.segment_matmul(a, b, s))(feats, ids))
    got = segment_sum(_t(feats), _t(ids), s)
    assert got.shape == (s, f) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(
        got.numpy(), segment_sum_plain(_t(feats), _t(ids), s).numpy())


@pytest.mark.parametrize("weighted", [False, True])
def test_segment_and_total_moments(weighted):
    rng = np.random.default_rng(7)
    n, s = 20000, 17
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    w = rng.uniform(0.5, 2, n).astype(np.float32) if weighted else None
    ids = rng.integers(0, s, n).astype(np.int32)
    shift = x.mean(0).astype(np.float32)
    jw = None if w is None else jnp.asarray(w)
    expect = np.asarray(JM.segment_moments(jnp.asarray(x), jnp.asarray(ids),
                                           s, weights=jw, shift=shift))
    tw = None if w is None else _t(w)
    got = TM.segment_moments(_t(x), _t(ids), s, weights=tw,
                             shift=_t(shift))
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5, atol=1e-4)
    tot_j = np.asarray(JM.total_moments(jnp.asarray(x), jw, shift))
    tot_t = TM.total_moments(_t(x), tw, _t(shift)).numpy()
    np.testing.assert_allclose(tot_t, tot_j, rtol=1e-5, atol=1e-3)
    for fn in ("moments_center", "moments_distortion", "moments_cov"):
        np.testing.assert_allclose(
            getattr(TM, fn)(got).numpy(),
            np.asarray(getattr(JM, fn)(jnp.asarray(got.numpy()))),
            rtol=1e-5, atol=1e-6,
        )


def _sym_batch(rng, k):
    a = rng.standard_normal((k, 3, 3)).astype(np.float32)
    spd = a @ a.transpose(0, 2, 1)
    special = np.stack([
        np.diag([3.0, 1.0, 2.0]),           # diagonal: fallback axis
        np.eye(3) * 0.5,                    # spherical
        np.outer([1.0, 2.0, -2.0], [1.0, 2.0, -2.0]),  # rank 1
        np.zeros((3, 3)),                   # empty cluster
    ]).astype(np.float32)
    return np.concatenate([spd, special])


def test_principal_axis_same_axis_and_sign():
    m = _sym_batch(np.random.default_rng(3), 200)
    ja, jv = JE.principal_axis(jnp.asarray(m))
    ta, tv = TE.principal_axis(_t(m))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-4)
    # same sign, exactly: the sign decides on which side of a cut mass lands
    dots = (ta.numpy() * np.asarray(ja)).sum(-1)
    assert (dots > 0).all()


def test_bucketize_linear_and_bucketize():
    rng = np.random.default_rng(5)
    proj = rng.standard_normal(10000).astype(np.float32)
    lo, hi = np.float32(-2.5), np.float32(2.5)
    expect = np.asarray(JM.bucketize_linear(jnp.asarray(proj), 512, lo, hi))
    got = TM.bucketize_linear(_t(proj), 512, torch.tensor(lo),
                              torch.tensor(hi))
    np.testing.assert_array_equal(got.numpy(), expect)
    pmin, pmax = proj.min(), proj.max()
    expect = np.asarray(JM.bucketize(jnp.asarray(proj), 512, pmin, pmax))
    got = TM.bucketize(_t(proj), 512, torch.tensor(pmin), torch.tensor(pmax))
    np.testing.assert_array_equal(got.numpy(), expect)


def test_bucketize_degenerate_round_robin():
    """A flat projection round-robins buckets over the input order
    (reference sort.c:61-79), counting only masked entries with a mask."""
    proj = np.full(2000, 0.25, np.float32)
    mask = np.random.default_rng(1).uniform(size=2000) < 0.5
    for m in (None, mask):
        expect = np.asarray(JM.bucketize(
            jnp.asarray(proj), 512, np.float32(0.25), np.float32(0.25),
            mask=None if m is None else jnp.asarray(m)))
        got = TM.bucketize(_t(proj), 512, torch.tensor(0.25),
                           torch.tensor(0.25),
                           mask=None if m is None else _t(m))
        np.testing.assert_array_equal(got.numpy(), expect)
    assert (got.numpy()[mask] == np.arange(mask.sum()) % 512).all()

"""K1's and K4's plain versions at the inputs that break a grouped
accumulation, against the JAX package; and the two wrappers' checks.

The chip check holds the CUDA kernels against these plain versions at the
same kinds of input (``chip_smoke.py``'s kernel-adversarial lines), so
here the plain versions are held against the JAX package on the same numpy
inputs, made from a seed:
- K1 (``segment_sum_plain`` against ``segment_matmul``): the LQ loop's
  shape (S = 16, F = 11, id 16 meaning "no candidate"), S = 1, every id
  equal, every id out of range (zeros). f32 sums in another order than
  XLA's: rtol 1e-5, atol 1e-4, as ``test_torch_moments.py``. The
  features lie in [0, 1), as weights and colours do: with 20000-40000
  terms in one segment, sums that cancel (standard-normal features)
  differ between any two summation orders by more than that atol.
- K4 (``kmeans_step`` / ``lloyd_iterations`` against ``lloyd_iterations``):
  P = 1, two centres exactly equal (the lower index takes every tied
  sample), zero weights on a third of the samples. Labels exactly; centres
  atol 1e-6, as ``test_torch_assign_kmeans.py``.
The wrappers must raise on bad types and shapes before anything reaches
the kernel library, which a tensor on the meta device shows here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patolette_tpu.models import kmeans as JKM
from patolette_tpu.ops import assign as JA
from patolette_tpu.ops import moments as JM
from patolette_tpu_torch import kernels
from patolette_tpu_torch.kernels import build
from patolette_tpu_torch.kernels.kmeans import kmeans_step, kmeans_step_plain
from patolette_tpu_torch.kernels.segment import segment_sum, segment_sum_plain
from patolette_tpu_torch.models import kmeans as TKM
from test_torch_cores import share_cores  # noqa: F401


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ids(case, n, rng):
    if case == "lq_16x11":
        return 16, 11, rng.integers(0, 17, n)      # 16: no candidate
    if case == "s_1":
        return 1, 11, rng.integers(0, 2, n)        # 1: out of range
    if case == "all_equal":
        return 16, 11, np.full(n, 5)
    return 16, 11, rng.choice([-1, 16, 1 << 30], n)  # all out of range


@pytest.mark.parametrize("case", ["lq_16x11", "s_1", "all_equal",
                                  "all_out_of_range"])
def test_segment_sum_plain_adversarial(case):
    rng = np.random.default_rng(70)
    n = 40000  # > one 32768 chunk
    s, f, ids = _ids(case, n, rng)
    ids = ids.astype(np.int32)
    feats = rng.uniform(0, 1, (n, f)).astype(np.float32)
    expect = np.asarray(jax.jit(
        lambda a, b: JM.segment_matmul(a, b, s))(feats, ids))
    got = segment_sum(_t(feats), _t(ids), s)
    assert got.shape == (s, f) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(
        got.numpy(), segment_sum_plain(_t(feats), _t(ids), s).numpy())
    if case == "all_out_of_range":
        assert not got.any()


_jax_lloyd = jax.jit(JKM.lloyd_iterations, static_argnames=("niter",))


def _km_case(case):
    rng = np.random.default_rng(71)
    n, p = 12000, 24
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    w = None
    if case == "p_1":
        p = 1
    c = x[rng.choice(n, p, replace=False)].copy()
    if case == "exact_ties":
        c[17] = c[4]
        x[:300] = c[4]  # samples exactly on the tied centres
    if case == "zero_weights":
        w = rng.uniform(0.5, 2, n).astype(np.float32)
        w[rng.uniform(size=n) < 1.0 / 3.0] = 0.0
    return x, w, c, np.ones(p, bool)


@pytest.mark.parametrize("case", ["p_1", "exact_ties", "zero_weights"])
def test_lloyd_adversarial_matches_jax(case):
    x, w, c, valid = _km_case(case)
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else _t(w)
    jc = np.asarray(_jax_lloyd(jnp.asarray(x), jw, jnp.asarray(c),
                               jnp.asarray(valid), niter=4))
    tc = TKM.lloyd_iterations(_t(x), tw, _t(c), _t(valid), 4)
    np.testing.assert_allclose(tc.numpy(), jc, atol=1e-6, rtol=0)
    # the first step's labels, exactly, against the JAX assignment
    _, labels = kmeans_step(_t(x), tw, _t(c), _t(valid), return_labels=True)
    jl = np.asarray(JA.assign_planar(tuple(x[:, k] for k in range(3)),
                                     jnp.asarray(c), valid=valid))
    np.testing.assert_array_equal(labels.numpy(), jl)
    if case == "p_1":
        assert not labels.any()
    if case == "exact_ties":
        assert (labels.numpy()[:300] == 4).all()
        assert not (labels.numpy() == 17).any()


def test_kmeans_step_on_the_cpu_is_its_plain_version():
    x, w, c, valid = _km_case("zero_weights")
    got, labels = kmeans_step(_t(x), _t(w), _t(c), _t(valid),
                              return_labels=True)
    twin, tl = kmeans_step_plain(_t(x), _t(w), _t(c), _t(valid))
    assert torch.equal(got, twin) and torch.equal(labels, tl)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


_BAD_SEGMENT = {
    "feats_f64": (TypeError, lambda: segment_sum(
        _meta((64, 11), torch.float64), _meta((64,), torch.int32), 16)),
    "ids_i64": (TypeError, lambda: segment_sum(
        _meta((64, 11)), _meta((64,), torch.int64), 16)),
    "ids_short": (ValueError, lambda: segment_sum(
        _meta((64, 11)), _meta((63,), torch.int32), 16)),
    "f_33": (ValueError, lambda: segment_sum(
        _meta((64, 33)), _meta((64,), torch.int32), 16)),
    "s_0": (ValueError, lambda: segment_sum(
        _meta((64, 11)), _meta((64,), torch.int32), 0)),
    "not_cuda": (ValueError, lambda: segment_sum(
        _meta((64, 11)), _meta((64,), torch.int32), 16)),
}
_BAD_KMEANS = {
    "samples_f64": (TypeError, lambda: kmeans_step(
        _meta((64, 3), torch.float64), None, _meta((8, 3)),
        _meta((8,), torch.bool))),
    "weights_f16": (TypeError, lambda: kmeans_step(
        _meta((64, 3)), _meta((64,), torch.float16), _meta((8, 3)),
        _meta((8,), torch.bool))),
    "samples_4": (ValueError, lambda: kmeans_step(
        _meta((64, 4)), None, _meta((8, 3)), _meta((8,), torch.bool))),
    "valid_long": (ValueError, lambda: kmeans_step(
        _meta((64, 3)), None, _meta((8, 3)), _meta((9,), torch.bool))),
    "weights_short": (ValueError, lambda: kmeans_step(
        _meta((64, 3)), _meta((63,)), _meta((8, 3)),
        _meta((8,), torch.bool))),
    "p_0": (ValueError, lambda: kmeans_step(
        _meta((64, 3)), None, _meta((0, 3)), _meta((0,), torch.bool))),
    "not_cuda": (ValueError, lambda: kmeans_step(
        _meta((64, 3)), None, _meta((8, 3)), _meta((8,), torch.bool))),
}


@pytest.mark.parametrize("name", [f"segment_sum:{k}" for k in _BAD_SEGMENT]
                         + [f"kmeans_step:{k}" for k in _BAD_KMEANS])
def test_wrapper_errors_before_any_launch(name, monkeypatch):
    wrapper, case = name.split(":")
    error, call = (_BAD_SEGMENT if wrapper == "segment_sum"
                   else _BAD_KMEANS)[case]

    def no_library():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(build, "library", no_library)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(error):
        call()
    assert kernels.LAUNCHES == before


def test_scratch_reuses_and_grows():
    build.clear_scratch()
    a = build.scratch("k", 10, torch.int32, "cpu", zero=True)
    assert a.shape == (10,) and not a.any()
    a.fill_(3)
    b = build.scratch("k", 6, torch.int32, "cpu", zero=True)
    assert b.data_ptr() == a.data_ptr() and (b == 3).all()  # reused as is
    c = build.scratch("k", 20, torch.int32, "cpu", zero=True)
    assert c.shape == (20,) and not c.any()                 # grown, zero
    assert build.scratch("k", 20, torch.float32, "cpu").dtype == torch.float32
    c.fill_(1)
    build.clear_scratch()
    assert not build.scratch("k", 20, torch.int32, "cpu", zero=True).any()
    build.clear_scratch()

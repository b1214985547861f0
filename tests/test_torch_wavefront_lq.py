"""The oracles of K9 and K2 at their kernels' edge cases, against the JAX
package; and both wrappers' checks.

The chip check holds the CUDA kernels against these plain versions
(``chip_smoke.py``'s kernel-adversarial lines), so here the plain versions
are held against the JAX package on the same numpy inputs, made from a
seed:
- K9 (``mbd_plain`` against the three ``_wavefront_pass`` calls of the
  JAX ``mbd``): shapes at the kernel's band and chunk edges
  (33 rows: one band of 32 plus one row; 65 columns: two chunks plus one
  column; 5 rows: one band, mostly idle lanes) and an image of plateaus
  and steps (every barrier ties somewhere). d, l and u exactly: min, max
  and one subtraction per cell. (``test_torch_saliency.py`` holds d to
  the JAX ``mbd`` itself.)
- K2 (``lq_candidates_plain``, through the port's
  ``_candidates_segmented``, against the JAX ``_candidates_segmented``):
  dead slots, a flat cluster (scale 0), every member in one bucket, one
  candidate, a low member share. Member and side bits and split buckets
  exactly; benefits, means and child means rtol 1e-4, atol 1e-6 (f32 sums
  in another order than XLA's, as ``test_torch_local_q.py``). And the
  table's own edges: no sums in a dead slot's rows, nothing off bucket 0
  in a flat cluster's, bucket 0 off the candidates.
The wrappers must raise on bad types and shapes before anything reaches
the kernel library, which a tensor on the meta device shows here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patolette_tpu.models import local_q as JLQ
from patolette_tpu.models import saliency as JS
from patolette_tpu_torch import kernels
from patolette_tpu_torch.kernels import build
from patolette_tpu_torch.kernels.lq import lq_candidates, lq_candidates_plain
from patolette_tpu_torch.kernels.mbd import mbd, mbd_plain
from patolette_tpu_torch.models import local_q as TLQ
from patolette_tpu_torch.utils.carry import state_from_numpy
from test_torch_cores import share_cores  # noqa: F401


def _mbd_planes(img):
    """The JAX ``mbd``'s three passes, with the l and u planes it drops."""
    rows, cols = img.shape
    l = u = img
    d = jnp.full((rows, cols), jnp.inf, img.dtype)
    d = d.at[0, :].set(0).at[-1, :].set(0).at[:, 0].set(0).at[:, -1].set(0)
    for it in range(3):
        l, u, d = JS._wavefront_pass(img, l, u, d, it % 2 == 0)
    return d, l, u


def _jax_mbd_planes(img):
    """``_mbd_planes`` compiled at XLA's backend optimisation level 1: half
    the compile time, and min, max and a subtraction give the same bits at
    every level."""
    img = jnp.asarray(img)
    return jax.jit(_mbd_planes).lower(img).compile(
        compiler_options={"xla_backend_optimization_level": 1})(img)


def _plateaus(rows, cols, seed):
    """Blocks of equal value on 4 levels, with a constant band: ties of d
    against both barriers and of the two barriers."""
    rng = np.random.default_rng(seed)
    img = np.repeat(np.repeat(rng.integers(0, 4, (rows // 4 + 1,
                                                  cols // 4 + 1)), 4, 0),
                    4, 1)[:rows, :cols] * 0.25
    img[rows // 3:rows // 2] = 0.5
    return img.astype(np.float32)


@pytest.mark.parametrize("case", ["33x70", "65x33", "5x100", "plateaus"])
def test_mbd_plain_matches_jax_bit_for_bit(case):
    if case == "plateaus":
        img = _plateaus(37, 66, 3)
    else:
        rows, cols = map(int, case.split("x"))
        img = np.random.default_rng(rows * cols).uniform(
            0, 1, (rows, cols)).astype(np.float32)
    want = [np.asarray(v) for v in _jax_mbd_planes(img)]
    got = mbd_plain(torch.from_numpy(img))
    for name, g, w in zip("dlu", got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    d, l, u = mbd(torch.from_numpy(img), return_lu=True)
    assert all(torch.equal(a, b) for a, b in zip((d, l, u), got))


_jax_candidates = jax.jit(JLQ._candidates_segmented, static_argnums=(4,))


def _lq_case(case):
    """(colors, weights, labels, ids, p): blobs of k clusters on elongated
    axes, cut for the case."""
    rng = np.random.default_rng(90)
    n, k = 6000, 10
    centers = rng.uniform(0.2, 0.8, (k, 3))
    axes = rng.standard_normal((k, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    lab = rng.integers(0, k, n)
    if case == "low_share":
        lab = np.where(rng.uniform(size=n) < 0.95, 7, lab)
    t = rng.standard_normal(n)[:, None] * 0.12
    x = centers[lab] + t * axes[lab] + 0.01 * rng.standard_normal((n, 3))
    w = rng.uniform(0.5, 2.0, n)
    p = 16
    ids = np.arange(8)
    if case == "dead_slots":
        ids = np.array([0, 1, 2, 3, p, 5, p, p])
    elif case == "flat_cluster":
        x[lab == 2] = centers[2]
    elif case == "low_share":
        ids = np.array([0, 3, p, p, p, p, p, p])
    elif case == "c_1":
        ids = np.array([4])
    elif case == "one_bucket":
        x[lab == 4] = centers[4]
        ids = np.array([4])
    return (x.astype(np.float32), w.astype(np.float32), lab.astype(np.int32),
            ids.astype(np.int32), p)


@pytest.mark.parametrize("case", ["dead_slots", "flat_cluster", "one_bucket",
                                  "c_1", "low_share"])
def test_lq_candidates_plain_matches_jax(case):
    x, w, lab, ids, p = _lq_case(case)
    jb, jmu, _, _, jpmax, js, jmc, jside, jmember = (
        np.asarray(v) for v in _jax_candidates(x, w, lab, ids, p))
    st = state_from_numpy(labels=lab)
    got = TLQ._candidates_segmented(torch.from_numpy(x), torch.from_numpy(w),
                                    st["labels"], torch.from_numpy(ids), p)
    np.testing.assert_array_equal(got.member.numpy(), jmember)
    np.testing.assert_array_equal(got.split.numpy(), js)
    np.testing.assert_array_equal(got.side.numpy(), jside)
    np.testing.assert_allclose(got.benefit.numpy(), jb, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.mu.numpy(), jmu, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.pmax.numpy(), jpmax, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got.mu_child.numpy(), jmc, rtol=1e-4,
                               atol=1e-6)

    # the table itself at the same inputs
    c = len(ids)
    slot = np.full(p + 1, c)
    slot[ids] = np.arange(c)
    slot[p] = c
    cand = slot[lab].astype(np.int32)
    wm = np.where(cand < c, w, 0).astype(np.float32)
    scale = np.where(jpmax > 0, 1 / np.where(jpmax > 0, 2 * jpmax, 1), 0)
    tab = np.concatenate([jmu, np.asarray(got.axis), -jpmax[:, None],
                          scale[:, None]], 1).astype(np.float32)
    table, bucket = lq_candidates_plain(
        torch.from_numpy(x), torch.from_numpy(wm), torch.from_numpy(cand),
        torch.from_numpy(tab), 512)
    table, bucket = table.numpy(), bucket.numpy()
    assert not bucket[cand == c].any()
    np.testing.assert_array_equal(table[ids == p], 0)
    flat = jpmax == 0
    assert not table[flat, 1:].any()
    np.testing.assert_allclose(
        table[:, :, 0].sum(1), np.bincount(cand, wm, c + 1)[:c], rtol=1e-2)
    if case in ("flat_cluster", "one_bucket"):
        assert flat.sum() == 1 and table[flat, 0, 0] > 0


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _lq(colors=(64, 3), wm=(64,), cand=(64,), tab=(16, 8), nb=512,
        cand_dtype=torch.int32, dtype=torch.float32):
    return lambda: lq_candidates(_meta(colors, dtype), _meta(wm),
                                 _meta(cand, cand_dtype), _meta(tab), nb)


_BAD = {
    "mbd:f64": (TypeError, lambda: mbd(_meta((8, 8), torch.float64))),
    "mbd:1d": (TypeError, lambda: mbd(_meta((64,)))),
    "mbd:empty": (ValueError, lambda: mbd(_meta((0, 8)))),
    "mbd:not_cuda": (ValueError, lambda: mbd(_meta((8, 8)))),
    "lq:colors_f64": (TypeError, _lq(dtype=torch.float64)),
    "lq:cand_i64": (TypeError, _lq(cand_dtype=torch.int64)),
    "lq:wm_short": (ValueError, _lq(wm=(63,))),
    "lq:tab_7": (ValueError, _lq(tab=(16, 7))),
    "lq:nb_0": (ValueError, _lq(nb=0)),
    "lq:nb_too_many": (ValueError, _lq(nb=1024)),
    "lq:not_cuda": (ValueError, _lq()),
}


@pytest.mark.parametrize("name", list(_BAD))
def test_wrapper_errors_before_any_launch(name, monkeypatch):
    error, call = _BAD[name]

    def no_library():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(build, "library", no_library)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(error):
        call()
    assert kernels.LAUNCHES == before

"""The port's one-shot route and its device palette core against the JAX
package's.

  * (a) K11's plain version through ``gq_device``: on the line clusters of
    ``tests/test_global_q.py`` cuts and k identical to JAX ``gq_device``,
    in f64 and f32 (where a cut meets an exact tie, in f32 k identical and
    the same DP cost); on random bucket moments k identical and the DP
    cost of the port's cuts within 1e-6 relative of JAX's (in f32 the
    prefix sums run in another order than XLA's, so a near tie may take
    another optimal cut); cuts padded with BUCKET_COUNT; NaN and +-inf
    buckets, empty and one-bucket moments, p = 1, 2 and 12, identical cuts
    and k; every level's costs and cut rows under NaN and inf against the
    JAX DP step in numpy.
  * (b) the LQ loop with its control on the device against JAX
    ``lq_quantize`` on the same inputs: identical labels and count at p =
    16, 64 and 256 with ``batch_splits`` 1 and 8 on 8192 pixels, and where
    splitting stops early (no benefit left); on 4096 pixels at p = 256 the
    count identical and the labels identical to a host-controlled loop's,
    no further from JAX's than that loop's.
  * (c) ``_palette_core`` against JAX's with ``lq_max_samples=0`` and
    JAX's own KMeans draw passed to both through ``x_km``/``w_km``:
    palette within 1e-4, ``valid`` identical.
  * (d) ``palette_pipeline_device`` against JAX's without draws (palette
    within 1e-4, ``valid`` identical, map >= 99.9% equal); ``quantize()``
    against the JAX one-shot route at 96x64 and 200x150, undithered and
    the default call: CIELuv MSE ratio <= 1.01. The device draws against
    ``jax.random``'s are held end to end by
    ``tests/test_torch_default_route.py`` (520x512, both draw).
  * (e) the route is taken for n <= ONE_SHOT_MAX_PIXELS with no routing
    variable, and left under ``PATOLETTE_NO_ONE_SHOT`` or above the
    threshold; the device-budget guard holds it to its own footprint
    model; a device OOM on it retries streamed, as on the resident route.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import patolette_tpu as jpt
import patolette_tpu_torch as tpt
from patolette_tpu.models import global_q as JGQ
from patolette_tpu.models import kmeans as JKM
from patolette_tpu.models import local_q as JLQ
from patolette_tpu.models import pipeline as JP
from patolette_tpu.ops import colorspace as JCS
from patolette_tpu.ops import eigen3 as JE
from patolette_tpu.ops import moments as JM
from patolette_tpu_torch.kernels import gq as KGQ
from patolette_tpu_torch.models import global_q as TGQ
from patolette_tpu_torch.models import kmeans as TKM
from patolette_tpu_torch.models import local_q as TLQ
from patolette_tpu_torch.models import pipeline as TP
from test_torch_cores import share_cores  # noqa: F401

B = JGQ.BUCKET_COUNT


@pytest.fixture(autouse=True)
def _default_routing(monkeypatch):
    for name in ("PATOLETTE_NO_ONE_SHOT", "PATOLETTE_NO_FUSED_LUT",
                 "PATOLETTE_FUSED_IMAGE_LUT"):
        monkeypatch.delenv(name, raising=False)


def _line_clusters(groups, per=200, spread=0.01, seed=0):
    """tests/test_global_q.py's tight groups along a line."""
    rng = np.random.default_rng(seed)
    pts = []
    for c in np.linspace(0, 100, groups):
        p = np.zeros((per, 3))
        p[:, 0] = c + rng.normal(0, spread, per)
        p[:, 1] = rng.normal(0, 3.0 * spread, per)
        p[:, 2] = rng.normal(0, spread, per)
        pts.append(p)
    return np.concatenate(pts)[rng.permutation(groups * per)]


def _stage(colors):
    """tests/test_global_q.py's bucket moments (f64)."""
    tot = JM.total_moments(colors)
    axis, _ = JE.principal_axis(JM.moments_cov(tot))
    proj = JM.project(colors, axis)
    buckets = JM.bucketize(proj, B, jnp.min(proj), jnp.max(proj))
    bm = JM.segment_moments(colors, buckets, B,
                            shift=JM.moments_center(tot))
    return np.asarray(buckets), np.asarray(bm, np.float64)


def _random_moments(seed):
    """Bucket moments of random anisotropic points in random buckets."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1000, 5000))
    x = rng.normal(size=(n, 3)) * rng.uniform(0.1, 2, 3)
    x -= x.mean(0)
    f = np.concatenate([np.ones((n, 1)), x, (x * x).sum(1)[:, None],
                        x[:, 0:1] * x[:, 0:3], x[:, 1:2] * x[:, 1:3],
                        x[:, 2:3] * x[:, 2:3]], 1)
    bm = np.zeros((B, 11))
    np.add.at(bm, rng.integers(0, B, n), f)
    return bm


@functools.lru_cache(maxsize=None)
def _jax_gq(p, dtype):
    """JAX ``gq_device`` compiled once a (p, dtype) at XLA's backend
    optimisation level 1 (half the compile time; the cuts are the same)."""
    spec = jax.ShapeDtypeStruct((B, 11), dtype)
    return jax.jit(JGQ.gq_device, static_argnums=1).lower(spec, p).compile(
        compiler_options={"xla_backend_optimization_level": 1})


def _both(bm, p, dtype):
    jc, jk = _jax_gq(p, np.dtype(dtype))(jnp.asarray(bm.astype(dtype)))
    tc, tk = TGQ.gq_device(torch.from_numpy(bm.astype(dtype)), p)
    assert tc.dtype == torch.int32 and tc.shape == (JGQ.MAX_K + 1,)
    assert tk.dtype == torch.int32 and tk.dim() == 0
    return np.asarray(jc), int(jk), tc.numpy(), int(tk)


def _dp_cost(bm, cuts, k):
    """Sum of the cells' distortions in f64 (global_q._pairwise_...)."""
    prefix = np.zeros((B + 1, 11))
    np.cumsum(bm, axis=0, out=prefix[1:])
    d = np.asarray(JGQ._pairwise_cell_distortion(prefix, np))
    return sum(d[a, b] for a, b in zip(cuts[:k], cuts[1:k + 1]))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("groups,spread,seed", [
    (5, 1.0, 0), (5, 1.0, 1), (5, 1.0, 2), (4, 0.01, 0), (8, 0.01, 2),
    (12, 0.01, 3)])
def test_gq_line_clusters(groups, spread, seed, dtype):
    """The configurations of tests/test_global_q.py:111-128 and more
    groups. In f64 cuts and k are identical. The empty buckets between the
    groups make every cut inside a gap an exact tie (the same cells); the
    port takes the largest minimiser, as the reference does, while the
    JAX package's f32 prefix sums, taken in XLA's order, round across a gap
    and break some of these ties elsewhere (with 5 groups at seed 1: 400
    against 485 inside the gap 366..485; with 8 at seed 2: 448 against
    511). So in f32: k identical and the same DP cost."""
    _, bm = _stage(_line_clusters(groups, spread=spread, seed=seed))
    jc, jk, tc, tk = _both(bm, 12, dtype)
    assert tk == jk
    assert (tc[tk:] == B).all() and tc[0] == 0
    if dtype == np.float64:
        np.testing.assert_array_equal(tc, jc)
    want = _dp_cost(bm, jc, jk)
    assert abs(_dp_cost(bm, tc, tk) - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gq_random_moments(dtype):
    for seed in range(6):
        bm = _random_moments(seed)
        for p in ((1, 2, 12) if dtype == np.float64 else (12,)):
            jc, jk, tc, tk = _both(bm, p, dtype)
            assert tk == jk, (seed, p)
            assert (tc[tk:] == B).all() and tc[0] == 0
            want = _dp_cost(bm, jc, jk)
            got = _dp_cost(bm, tc, tk)
            assert abs(got - want) <= 1e-6 * abs(want), (seed, p)


@pytest.mark.parametrize("case", ["nan", "posinf", "neginf", "empty",
                                  "one_bucket"])
@pytest.mark.parametrize("p", [1, 2, 12])
def test_gq_edge_moments(case, p):
    bm = _random_moments(7)
    if case == "nan":
        bm[200, 4] = np.nan
    elif case == "posinf":
        bm[100, 1] = np.inf
    elif case == "neginf":
        bm[300, 4] = -np.inf
    elif case == "empty":
        bm[:] = 0.0
    else:
        bm[:] = 0.0
        bm[37] = _random_moments(8).sum(0)
    for dtype in ((np.float64, np.float32) if p == 12 else (np.float64,)):
        jc, jk, tc, tk = _both(bm, p, dtype)
        assert tk == jk
        np.testing.assert_array_equal(tc, jc)


@pytest.mark.parametrize("case", ["nan_w2", "nan_w0", "inf_w1"])
def test_gq_dp_plain_levels_nan_rule(case):
    """Every level's cost row and cut row of the plain DP (f64) against
    the JAX package's ``dp_step`` written in numpy, whose ``min`` and
    ``argmin`` over the reversed rows follow jnp's NaN rule: a NaN
    candidate wins (the largest t among NaNs), then the smallest cost,
    ties to the largest t; no candidate gives +inf and cut b."""
    bm = _random_moments(9)
    row, col = {"nan_w2": (10, 4), "nan_w0": (300, 0),
                "inf_w1": (50, 2)}[case]
    bm[row, col] = np.inf if case == "inf_w1" else np.nan
    _, cost, cut, _ = KGQ.gq_dp_plain(torch.from_numpy(bm), 12)
    prefix = np.zeros((B + 1, 11))
    np.cumsum(bm, axis=0, out=prefix[1:])
    with np.errstate(invalid="ignore", divide="ignore"):
        dmat = np.asarray(JGQ._pairwise_cell_distortion(prefix, np))
        t_idx = np.arange(B + 1)
        e = dmat[0]
        np.testing.assert_array_equal(cost[0].numpy(), e)
        for k in range(2, 13):
            c = e[:, None] + dmat
            valid = (t_idx[:, None] >= k - 1) & (
                t_idx[:, None] <= t_idx[None, :] - 1)
            c = np.where(valid, c, np.inf)
            np.testing.assert_array_equal(
                cut[k].numpy(), B - np.argmin(c[::-1], axis=0))
            e = np.min(c, axis=0)
            np.testing.assert_array_equal(cost[k - 1].numpy(), e)
    # a NaN mass makes its cells empty (D = 0); NaN or inf sums give NaN
    assert np.isnan(cost.numpy()).any() == (case != "nan_w0")


def test_labels_from_padded_cuts():
    buckets = np.array([0, 5, 100, 101, 250, 511, 300], np.int32)
    cuts = np.array([0, 101, 300, 512] + [B] * 10, np.int32)
    want = np.asarray(JGQ.labels_from_cuts(jnp.asarray(buckets),
                                           jnp.asarray(cuts)))
    got = TGQ.labels_from_cuts(torch.from_numpy(buckets),
                               torch.from_numpy(cuts))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.max() == 2


def test_gq_dp_wrapper_refuses_meta_and_bad_k():
    with pytest.raises(ValueError):
        KGQ.gq_dp(torch.empty((B, 11), device="meta"), 12)
    with pytest.raises(ValueError):
        KGQ.gq_dp(torch.zeros((B, 11)), 13)


def _lq_inputs(x, p):
    """GQ in JAX; its labels and k0 go to both LQ implementations."""
    buckets, bm = JP._gq_bucket_stage(jnp.asarray(x))
    cuts = JGQ.gq_host(np.asarray(bm, np.float64), p)
    labels0 = np.asarray(JGQ.labels_from_cuts(buckets, jnp.asarray(cuts)),
                         np.int32).copy()
    return labels0, len(cuts) - 1


_jax_lq = jax.jit(JLQ.lq_quantize,
                  static_argnames=("palette_size", "batch_splits"))


def _working(colors):
    return np.array(JCS.srgb_to_working(
        jnp.asarray(colors.astype(np.float32)), 2), np.float32)


def _compiled(fn, *args):
    """``fn`` jitted and compiled for ``args`` at XLA's backend
    optimisation level 1 (about half the compile time)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 1})


@pytest.mark.parametrize("p,batch_splits", [
    (16, 1), (16, 8), (64, 1), (64, 8), (256, 1), (256, 8)])
def test_lq_device_control_matches_jax(p, batch_splits):
    """The 128x64 test image in ICtCp: at p = 256 a cluster holds 32
    pixels on average. (With 16 to 23 pixels a cluster, as with 4096 or
    6000 pixels at p = 256, the candidate sums' f32 rounding (README T4)
    flips a near tie of the greedy order and 1-1.5% of the labels differ;
    a loop that reads its split count on the host each round takes the
    same flips.)"""
    x = _working(_image(128, 64))
    labels0, k0 = _lq_inputs(x, p)
    jl, jn = _jax_lq(jnp.asarray(x), None, jnp.asarray(labels0), k0,
                     palette_size=p, batch_splits=batch_splits)
    # k0 as a 0-d tensor, as gq_device gives it
    tl, tn = TLQ.lq_quantize(torch.from_numpy(x), None,
                             torch.from_numpy(labels0),
                             torch.tensor(k0, dtype=torch.int32), p,
                             batch_splits=batch_splits)
    assert tn.dim() == 0 and tn.dtype == torch.int32
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl, np.int32))


def _lq_host_loop(x, labels0, k0, p, batch_splits):
    """The port's LQ loop with its control on the host, as it ran before
    the control moved to the device: the same candidate passes, but each
    round reads its split count, stops at ``m == 0`` or a full palette,
    and writes its tables by index."""
    colors = torch.from_numpy(x)
    w = torch.ones((len(x),), dtype=colors.dtype)
    labels = torch.from_numpy(labels0)
    max_k0 = min(12, p)
    ids0 = torch.arange(max_k0, dtype=torch.int32)
    first = TLQ._candidates_segmented(colors, w, labels, ids0, p)
    benefit = torch.zeros((p,), dtype=colors.dtype)
    mu_child = torch.zeros((p, 2, 3), dtype=colors.dtype)
    benefit[:max_k0] = torch.where(ids0 < k0, first.benefit, 0.0)
    mu_child[:max_k0] = first.mu_child
    side, count = first.side, k0
    bsz = max(1, min(batch_splits, (p + 15) // 16, p - 1))
    j_idx = torch.arange(bsz, dtype=torch.int32)
    for _ in range(-(-(p - 1) // bsz) + bsz.bit_length()):
        if count >= p:
            break
        vals, sel = TLQ.top_b(benefit, bsz)
        sel = sel.to(torch.int32)
        valid = (vals >= TLQ.DELTA) & (j_idx < p - count)
        m = int(valid.sum())
        if m == 0:
            break
        rank = torch.full((p,), -1, dtype=torch.int32)
        rank[sel[:m].long()] = j_idx[:m]
        jpix = rank[labels.long()]
        labels = torch.where((jpix >= 0) & side, count + jpix, labels)
        valid2 = torch.cat([valid, valid])
        ids2b = torch.where(valid2, torch.cat([count + j_idx, sel]), p)
        mu_known = torch.cat([mu_child[sel.long(), 0],
                              mu_child[sel.long(), 1]])
        res = TLQ._candidates_segmented(colors, w, labels, ids2b, p,
                                        mu_known=mu_known)
        side = torch.where(res.member, res.side, side)
        live = ids2b[valid2].long()
        benefit[live] = res.benefit[valid2]
        mu_child[live] = res.mu_child[valid2]
        count += m
    return labels.numpy(), count


@pytest.mark.parametrize("batch_splits", [1, 8])
@pytest.mark.parametrize("w,h", [(64, 64), (128, 32)])
def test_lq_device_control_few_pixels_a_cluster(w, h, batch_splits):
    """4096 pixels at p = 256: 16 pixels a cluster. Here the candidate
    sums' f32 rounding (README T4) can flip near ties of the greedy order
    against the JAX package's, whatever the control. Held: the count
    identical to JAX's, the labels identical to the host-controlled loop's
    on the same inputs, and the share of labels that differ from JAX's no
    larger than that loop's. Read: 64x64 identical to JAX; 128x32 1.32%
    of labels differ at batch 1 and 8, the host-controlled loop's too."""
    p = 256
    x = _working(_image(w, h))
    labels0, k0 = _lq_inputs(x, p)
    jl, jn = _jax_lq(jnp.asarray(x), None, jnp.asarray(labels0), k0,
                     palette_size=p, batch_splits=batch_splits)
    jl = np.asarray(jl, np.int32)
    tl, tn = TLQ.lq_quantize(torch.from_numpy(x), None,
                             torch.from_numpy(labels0),
                             torch.tensor(k0, dtype=torch.int32), p,
                             batch_splits=batch_splits)
    hl, hn = _lq_host_loop(x, labels0, k0, p, batch_splits)
    assert int(tn) == int(jn) == hn
    np.testing.assert_array_equal(tl.numpy(), hl)
    assert (tl.numpy() != jl).mean() <= (hl != jl).mean()


@pytest.mark.parametrize("batch_splits", [1, 8])
def test_lq_stops_when_no_benefit_left(batch_splits):
    """40 distinct pixels at p = 64: the splits end with one pixel a
    cluster (zero benefit everywhere, m == 0) at count 40, long before the
    trip count ends; the remaining rounds change nothing."""
    x = _working(np.random.default_rng(4).uniform(0, 1, (40, 3)))
    labels0, k0 = _lq_inputs(x, 64)
    jl, jn = _jax_lq(jnp.asarray(x), None, jnp.asarray(labels0), k0,
                     palette_size=64, batch_splits=batch_splits)
    tl, tn = TLQ.lq_quantize(torch.from_numpy(x), None,
                             torch.from_numpy(labels0), k0, 64,
                             batch_splits=batch_splits)
    assert int(tn) == int(jn) == 40
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl, np.int32))


def _image(w, h, seed=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([
        0.5 + 0.45 * np.sin(xx / 23.0) * np.cos(yy / 31.0),
        0.5 + 0.45 * np.cos(xx / 41.0 + yy / 57.0),
        np.clip(yy / h + 0.06 * rng.standard_normal((h, w)), 0, 1),
    ], axis=-1)
    return np.clip(img, 0, 1).reshape(-1, 3)


def _mse_luv(colors, palette, pmap):
    a = np.asarray(JCS.srgb_to_cieluv(colors))
    b = np.asarray(JCS.srgb_to_cieluv(palette))[pmap]
    return float(((a - b) ** 2).sum(-1).mean())


def test_kmeans_subsample_and_refine_palette():
    """``subsample`` draws ``cap`` rows with their weights, the same rows
    for the same seed or generator state; ``refine_palette`` below its cap
    (no draw) equals the JAX package's to f32 summation order."""
    x = _working(_image(64, 40))
    w = np.random.default_rng(1).uniform(0.5, 2, len(x)).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    sx, sw = TKM.subsample(xt, wt, 500, 7)
    assert sx.shape == (500, 3) and sw.shape == (500,)
    rows = {tuple(r) for r in x.tolist()}
    assert all(tuple(r) in rows for r in sx.tolist())
    np.testing.assert_array_equal(sx.numpy(), TKM.subsample(xt, wt, 500,
                                                            7)[0].numpy())
    gen = TKM.device_generator("cpu", 7)
    np.testing.assert_array_equal(sx.numpy(),
                                  TKM.subsample(xt, wt, 500, gen)[0].numpy())
    assert TKM.subsample(xt, wt, len(x), 7)[0] is xt
    centers = x[:: len(x) // 8][:8].copy()
    valid = np.array([True] * 7 + [False])
    jc = JKM.refine_palette(jnp.asarray(x), jnp.asarray(w),
                            jnp.asarray(centers), jnp.asarray(valid), 8, 3,
                            0, 3)
    tc = TKM.refine_palette(xt, wt, torch.from_numpy(centers),
                            torch.from_numpy(valid), 8, 3, 0, 3)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5,
                               rtol=0)


def test_palette_core_with_jax_kmeans_draw():
    p, niter, seed = 32, 4, 5
    x_srgb = _image(320, 250).astype(np.float32)  # 80,000 px > the cap
    x = np.array(JCS.srgb_to_working(jnp.asarray(x_srgb), 2), np.float32)
    cap = JP.KM.subsample_cap(p, 0)
    x_km, _ = JP._subsample_device(
        jnp.asarray(x), None, cap,
        jax.random.fold_in(jax.random.PRNGKey(seed), 1))
    assert x_km.shape == (cap, 3) and cap < len(x)
    core = functools.partial(
        JP._palette_core, palette_size=p, kmeans_niter=niter,
        kmeans_max_samples=0, seed=seed, axis_name=None, lq_batch_splits=8,
        lq_max_samples=0)
    args = (jnp.asarray(x), x_km)
    jc, jv = _compiled(lambda a, k: core(a, None, x_km=k, w_km=None),
                       *args)(*args)
    tc, tv = TP._palette_core(
        torch.from_numpy(x), None, p, niter, 0, seed, None, 8, 0,
        x_km=torch.from_numpy(np.array(x_km)), w_km=None)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    v = tv.numpy()
    np.testing.assert_allclose(tc.numpy()[v], np.asarray(jc)[v], atol=1e-4,
                               rtol=0)


def test_palette_pipeline_device_against_jax():
    x = _image(160, 120).astype(np.float32)
    w = np.random.default_rng(0).uniform(0.5, 2.0, len(x)).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(w))
    jc, jv, jm = _compiled(lambda c, ww: JP.palette_pipeline_device(
        c, ww, 24, color_space=1), *args)(*args)
    tc, tv, tm = TP.palette_pipeline_device(x, w, 24, color_space=1,
                                            device="cpu")
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    v = tv.numpy()
    np.testing.assert_allclose(tc.numpy()[v], np.asarray(jc)[v], atol=1e-4,
                               rtol=0)
    assert (tm.numpy() == np.asarray(jm)).mean() >= 0.999
    # planar uint8 in, palette only: the same working values
    x8 = np.round(x * 255).astype(np.uint8)
    planar = tuple(x8[:, i] for i in range(3))
    c8, v8 = TP.palette_pipeline_device(planar, w, 24, color_space=1,
                                        with_map=False, device="cpu")
    c8i, v8i, _ = TP.palette_pipeline_device(x8, w, 24, color_space=1,
                                             device="cpu")
    np.testing.assert_array_equal(v8.numpy(), v8i.numpy())
    np.testing.assert_allclose(c8.numpy(), c8i.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("w,h,kw", [
    (96, 64, dict(dither=False, tile_size=0, color_space=2)),
    (96, 64, {}),
    (200, 150, dict(dither=False, tile_size=0, color_space=2)),
    (200, 150, {}),
])
def test_quantize_against_jax_one_shot(w, h, kw):
    x = _image(w, h)
    ok, pal, pmap, msg = tpt.quantize(w, h, x, 32, device="cpu", **kw)
    assert ok, msg
    assert "one-shot" in TP.LAST_STAGE_TIMES
    jok, jpal, jmap, jmsg = jpt.quantize(w, h, x, 32, **kw)
    assert jok, jmsg
    assert "one-shot" in JP.LAST_STAGE_TIMES
    assert _mse_luv(x, pal, pmap) / _mse_luv(x, jpal, jmap) <= 1.01


def test_route_taken_and_left(monkeypatch):
    x = _image(64, 48)
    kw = dict(dither=False, tile_size=0, kmeans_niter=2, device="cpu")
    assert TP.ONE_SHOT_MAX_PIXELS == JP.ONE_SHOT_MAX_PIXELS == 1 << 22
    assert TP.STRIP_DITHER_MIN_PIXELS == TP.ONE_SHOT_MAX_PIXELS
    ok, pal, pmap, _ = tpt.quantize(64, 48, x, 8, **kw)
    assert ok and "one-shot" in TP.LAST_STAGE_TIMES
    assert "lq" not in TP.LAST_STAGE_TIMES
    monkeypatch.setenv("PATOLETTE_NO_ONE_SHOT", "1")
    ok, *_ = tpt.quantize(64, 48, x, 8, **kw)
    assert ok and "one-shot" not in TP.LAST_STAGE_TIMES
    assert "lq" in TP.LAST_STAGE_TIMES
    monkeypatch.delenv("PATOLETTE_NO_ONE_SHOT")
    monkeypatch.setattr(TP, "ONE_SHOT_MAX_PIXELS", 64 * 48 - 1)
    ok, *_ = tpt.quantize(64, 48, x, 8, **kw)
    assert ok and "one-shot" not in TP.LAST_STAGE_TIMES
    monkeypatch.setattr(TP, "ONE_SHOT_MAX_PIXELS", 64 * 48)
    ok, pal2, pmap2, _ = tpt.quantize(64, 48, x, 8, **kw)
    assert ok and "one-shot" in TP.LAST_STAGE_TIMES
    np.testing.assert_array_equal(pal, pal2)
    np.testing.assert_array_equal(pmap, pmap2)


@pytest.mark.parametrize("saliency", [False, True])
def test_budget_guard_uses_one_shot_footprint(monkeypatch, saliency):
    """The device-budget guard holds a call bound for the one-shot route
    to that route's footprint model (ONE_SHOT_BYTES_PER_PIXEL*), not the
    resident route's: with a budget between the two, the call leaves the
    one-shot route (streamed undithered, typed -1 with saliency), while
    under PATOLETTE_NO_ONE_SHOT the resident call fits."""
    w, h = 64, 48
    n = w * h
    if saliency:
        kw = dict(dither=False, tile_size=512.0)
        low, high = (TP.BYTES_PER_PIXEL_SALIENCY_OR_DITHER,
                     TP.ONE_SHOT_BYTES_PER_PIXEL_SALIENCY_OR_DITHER)
    else:
        kw = dict(dither=False, tile_size=0)
        low, high = TP.BYTES_PER_PIXEL, TP.ONE_SHOT_BYTES_PER_PIXEL
    assert low < high
    monkeypatch.setattr(TP, "_device_budget", lambda device: n * low)
    x = _image(w, h)
    ok, _, _, msg = tpt.quantize(w, h, x, 8, kmeans_niter=2, device="cpu",
                                 **kw)
    if saliency:
        assert ok is False and "device budget for saliency" in msg
    else:
        assert ok, msg
        assert "strip-in" in TP.LAST_STAGE_TIMES
        assert "one-shot" not in TP.LAST_STAGE_TIMES
    monkeypatch.setenv("PATOLETTE_NO_ONE_SHOT", "1")
    ok, _, _, msg = tpt.quantize(w, h, x, 8, kmeans_niter=2, device="cpu",
                                 **kw)
    assert ok, msg
    assert "lq" in TP.LAST_STAGE_TIMES


def test_one_shot_oom_retries_streamed(monkeypatch):
    """A device OOM on the one-shot route retries on the streamed route,
    as one on the resident route does; another error, or an OOM with
    saliency (no streamed equivalent), stays typed."""
    w, h = 64, 48
    x = _image(w, h)
    kw = dict(dither=False, tile_size=0, kmeans_niter=2, device="cpu")
    calls = []

    def fail_with(exc):
        def fail(*args, **kwargs):
            calls.append(1)
            raise exc
        monkeypatch.setattr(TP, "_quantize_one_shot", fail)

    fail_with(torch.cuda.OutOfMemoryError("CUDA out of memory."))
    ok, pal, pmap, msg = tpt.quantize(w, h, x, 8, **kw)
    assert ok, msg
    assert calls == [1] and "strip-in" in TP.LAST_STAGE_TIMES
    assert pmap.shape == (w * h,)
    fail_with(RuntimeError("injected failure"))
    ok, pal, _, msg = tpt.quantize(w, h, x, 8, **kw)
    assert ok is False and pal is None and "injected failure" in msg
    fail_with(torch.cuda.OutOfMemoryError("out of memory"))
    ok, _, _, msg = tpt.quantize(w, h, x, 8, **dict(kw, tile_size=512.0))
    assert ok is False and "OutOfMemoryError" in msg
    assert calls == [1, 1, 1]

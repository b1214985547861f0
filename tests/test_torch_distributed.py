"""The port's multi-device route with two and four ranks: one CPU process
a rank, gloo over TCP on localhost, every case of a world size in one
spawn (each rank runs the worker below and saves its results), then the
ranks' results held against each other, the port's single-device route
and the JAX package's k-device mesh in this process.

Tolerances:
  * every rank returns the same palette and map, bit for bit; the rows
    entry (``quantize_distributed``) gives each rank's rows of
    ``quantize(mesh=)``'s map and its palette, bit for bit; the flat
    image's round-robin buckets equal the single-process buckets of the
    concatenated ranks, bit for bit (all checked in the worker).
  * sharded against single-device on the port (the fixture of the JAX
    package's ``test_sharded_matches_single``): the same number of used
    entries, each within 1e-4 (sums over ranks in another order).
  * with draws, CIELuv MSE ratio port / JAX k-device mesh <= 1.01 (each
    rank draws on the device from ``(seed, rank, stream)``; README T5). The held
    draws are KMeans's (see ``test_torch_mesh.py``); the LQ draws of the
    other case are held by the rank and rows-entry identities.
  * the flat image: the single-device route's map, bit for bit, and its
    palette within 1e-5 (one colour, whatever the buckets; its mean summed
    over the ranks in another order), the colour within 1e-4 of the
    input's (the ICtCp round trip in f32, the goldens' sRGB tolerance).
  * per-strip dither with the same working palette against JAX's
    ``dither_sharded``: map >= 99.9%, in both input forms; per-strip
    saliency against JAX's ``saliency_sharded``: rtol 1e-5
    (``test_torch_saliency.py``).
  * ``quantize_palette_distributed`` with no draws (the palette pipeline
    with K11 on the reduced moments) against JAX's
    ``quantize_palette_sharded``: the same valid slots, each entry within
    1e-4 (the sums over ranks in another order), map >= 99.9%; its planar
    and interleaved forms the same bits (in the worker).
  * ``dither_distributed`` on the working palette ``quantize(mesh=)``
    ended with: that call's dithered map, bit for bit (in the worker).
  * shapes that do not divide over the ranks: the single-device route's
    result, bit for bit.
"""

import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import patolette_tpu as jpt
from patolette_tpu.ops import colorspace as JCS
from patolette_tpu.parallel import mesh as JM
from patolette_tpu_torch.ops import colorspace as TCS
from test_torch_cores import share_cores  # noqa: F401

REPO = str(pathlib.Path(__file__).resolve().parent.parent)
TIMEOUT_S = 300

# Inputs, made by the worker and by this process alike.
COMMON = r'''
import numpy as np


def image_a(h=64, w=64, seed=0):
    """The fixture of the JAX package's test_sharded_matches_single."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.1, 0.9, (6, 3))
    idx = rng.integers(0, 6, h * w)
    return np.clip(base[idx] + rng.normal(0, 0.03, (h * w, 3)), 0, 1)


def image_c(h=128, w=128, seed=1):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([0.5 + 0.45 * np.sin(xx / 9.0) * np.cos(yy / 13.0),
                    0.5 + 0.45 * np.cos(xx / 17.0),
                    np.clip(yy / h + 0.08 * rng.standard_normal((h, w)),
                            0, 1)], axis=-1)
    return np.clip(img, 0, 1).reshape(-1, 3)


def strip_palette(p=12, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.05, 0.95, (p, 3)).astype(np.float32),
            np.arange(p) < p - 1)


KW_A = dict(dither=False, tile_size=0, kmeans_niter=5)
KW_C = dict(dither=False, tile_size=0, kmeans_niter=2,
            lq_max_samples=4096)
KW_KM = dict(dither=False, tile_size=0, kmeans_niter=4, lq_max_samples=0,
             kmeans_max_samples=0)
KW_FLAT = dict(dither=False, tile_size=0, kmeans_niter=2)
FLAT = np.tile([[0.3, 0.5, 0.7]], (64 * 32, 1))
W_E, H_E, TILE_E = 32, 64, 128.0
'''

WORKER = r'''
import datetime, os, sys
port, rank, world, outdir, repo = (sys.argv[1], int(sys.argv[2]),
                                   int(sys.argv[3]), sys.argv[4], sys.argv[5])
sys.path.insert(0, repo)
sys.path.insert(0, outdir)
import numpy as np
import torch
from common import *
import patolette_tpu_torch as pt
from patolette_tpu_torch.models import pipeline as TP
from patolette_tpu_torch.ops import colorspace as TCS
from patolette_tpu_torch.ops import moments as M
from patolette_tpu_torch.parallel import distributed as D
from patolette_tpu_torch.parallel import mesh as PM

mesh = D.init_distributed(f"tcp://localhost:{port}", world, rank,
                          backend="gloo", device="cpu",
                          timeout=datetime.timedelta(seconds=120))
assert (mesh.rank, mesh.world) == (rank, world)
res = {}


def run(tag, w, h, img, p, **kw):
    ok, pal, pmap, msg = pt.quantize(w, h, img, p, mesh=mesh, **kw)
    assert ok, (tag, msg)
    res[tag + "_pal"], res[tag + "_map"] = pal, pmap
    return pal, pmap


# a. sharded against the port's single device
run("a", 64, 64, image_a(), 8, **KW_A)
ok, pal1, map1, msg = pt.quantize(64, 64, image_a(), 8, device="cpu",
                                  **KW_A)
assert ok, msg
res["a1_pal"], res["a1_map"] = pal1, map1

# c. with draws (each rank its own); the rows entry on the same call
pal_c, map_c = run("c", 128, 128, image_c(), 16, **KW_C)
lo, hi = PM.shard_range(128 * 128, mesh)
ok, pal_r, map_r, msg = D.quantize_distributed(
    128, 128, image_c()[lo:hi], 16, mesh=mesh, **KW_C)
assert ok, msg
assert np.array_equal(pal_r, pal_c) and np.array_equal(map_r, map_c[lo:hi])

# KMeans draws (384x256 pixels over the 65536 cap)
run("km", 384, 256, image_c(256, 384), 16, **KW_KM)

# the rows entry on a dithered call and on the uint8 24-bit table route
TP.LUT_MIN_PIXELS = 0
u8 = np.round(image_c() * 255).astype(np.uint8)
for tag, img, kw in (("dither", image_c(), dict(dither=True, tile_size=0,
                                                 kmeans_niter=2,
                                                 dither_segment=64)),
                     ("u8lut", u8, dict(dither=False, tile_size=0,
                                        kmeans_niter=2))):
    pal_m, map_m = run(tag, 128, 128, img, 16, **kw)
    ok, pal_r, map_r, msg = D.quantize_distributed(
        128, 128, img[lo:hi], 16, mesh=mesh, **kw)
    assert ok, (tag, msg)
    assert np.array_equal(pal_r, pal_m), tag
    assert np.array_equal(map_r, map_m[lo:hi]), tag
assert "nn-map" in TP.LAST_STAGE_TIMES

# d. the flat image, and its round-robin buckets
pal_f, map_f = run("flat", 64, 32, FLAT, 8, **KW_FLAT)
ok, pal_f1, map_f1, msg = pt.quantize(64, 32, FLAT, 8, device="cpu",
                                      **KW_FLAT)
assert ok and np.array_equal(map_f, map_f1)
assert np.abs(pal_f - pal_f1).max() < 1e-5, np.abs(pal_f - pal_f1).max()
n_local = 1000
proj = torch.full((n_local,), 0.25)
b = M.bucketize(proj, 512, PM.pmin(mesh, proj.min()),
                PM.pmax(mesh, proj.max()), mesh=mesh)
whole = M.bucketize(torch.full((n_local * world,), 0.25), 512,
                    torch.tensor(0.25), torch.tensor(0.25))
assert torch.equal(PM.gather(mesh, b), whole)
assert torch.equal(b, whole[rank * n_local:(rank + 1) * n_local])

# e. per-strip dither and saliency with a fixed working palette
img_e = image_c(H_E, W_E, seed=3)
strip_h = H_E // world
lo_e, hi_e = PM.shard_range(W_E * H_E, mesh)
strip = torch.from_numpy(img_e[lo_e:hi_e].astype(np.float32))
pal_e, valid_e = strip_palette()
centers = TCS.srgb_to_working(torch.from_numpy(pal_e), 2)
dmap = PM.dither_sharded(mesh, W_E, H_E, 2, segment=64, planar=True)(
    strip.unbind(1), centers, torch.from_numpy(valid_e))
res["strip_dither"] = PM.gather(mesh, dmap).numpy()
sal = PM.saliency_sharded(mesh, W_E, strip_h, TILE_E, W_E * H_E)(
    tuple(img_e[lo_e:hi_e, k].astype(np.float32) for k in range(3)))
res["strip_saliency"] = PM.gather(mesh, sal).numpy()

# f. the JAX package's distributed factories on image_a, no draws: the
# palette pipeline (K11 on the reduced moments, the device-control LQ
# loop and their exchanges), planar and interleaved alike; the dither in
# both forms; and the dither of quantize(mesh=)'s own palette gives its map
lo_a, hi_a = PM.shard_range(64 * 64, mesh)
rows_a = image_a()[lo_a:hi_a].astype(np.float32)
pal_q, valid_q, map_q = D.quantize_palette_distributed(
    mesh, 8, kmeans_niter=5)(rows_a, None)
out_p = D.quantize_palette_distributed(mesh, 8, kmeans_niter=5,
                                       planar=True)(tuple(rows_a.T), None)
for a, b in zip((pal_q, valid_q, map_q), out_p):
    assert torch.equal(a, b)
assert len(map_q) == hi_a - lo_a
res["qpd_pal"], res["qpd_valid"] = pal_q.numpy(), valid_q.numpy()
res["qpd_map"] = PM.gather(mesh, map_q).numpy()
work_a = TCS.srgb_to_working(torch.from_numpy(rows_a), 2)
res["dd_map"] = PM.gather(mesh, D.dither_distributed(
    mesh, 64, 64, 2, segment=64)(work_a, centers, valid_e)).numpy()
res["ddp_map"] = PM.gather(mesh, D.dither_distributed(
    mesh, 64, 64, 2, segment=64, planar=True)(
        tuple(rows_a.T), centers, valid_e)).numpy()
seen, finish = {}, TP._finish_palette


def spy(c, v, p, csp):
    seen.update(centers=c, valid=v)
    return finish(c, v, p, csp)


TP._finish_palette = spy
_, map_m = run("a_dither", 64, 64, image_a(), 8, dither=True, tile_size=0,
               kmeans_niter=5, dither_segment=64)
TP._finish_palette = finish
dm = D.dither_distributed(mesh, 64, 64, 2, segment=64, planar=True)(
    tuple(rows_a.T), seen["centers"], seen["valid"])
assert np.array_equal(PM.gather(mesh, dm).numpy(), map_m)

# g. shapes that do not divide over the ranks
ok, pal_g, map_g, msg = pt.quantize(11, 13, image_a(13, 11, 5), 4,
                                    mesh=mesh, dither=True, tile_size=0,
                                    kmeans_niter=0)
ok1, pal_g1, map_g1, _ = pt.quantize(11, 13, image_a(13, 11, 5), 4,
                                     device="cpu", dither=True, tile_size=0,
                                     kmeans_niter=0)
assert ok and ok1, msg
assert np.array_equal(pal_g, pal_g1) and np.array_equal(map_g, map_g1)
# the rows entry has no whole image to fall back on: a typed failure
lo_g, hi_g = PM.shard_range(12 * 13, mesh)
ok, _, _, msg = D.quantize_distributed(
    12, 13, image_a(13, 12, 5)[lo_g:hi_g], 4, mesh=mesh, dither=True,
    tile_size=0, kmeans_niter=0)
assert not ok and "divide" in msg, msg
try:  # the JAX factory asserts the height divides
    D.dither_distributed(mesh, 12, 13, 2)
    raise AssertionError("a height of 13 over the ranks")
except ValueError as e:
    assert "divide" in str(e)

np.savez(os.path.join(outdir, f"r{rank}.npz"), **res)
torch.distributed.destroy_process_group()
print(f"rank {rank} done", flush=True)
'''

exec(COMMON)  # the same inputs here


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(tmp_path, world):
    (tmp_path / "common.py").write_text(COMMON)
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    env = dict(os.environ)
    env.pop("PYTEST_CURRENT_TEST", None)
    env["OMP_NUM_THREADS"] = "1"
    port = _free_port()
    return [
        subprocess.Popen(
            [sys.executable, str(worker), str(port), str(r), str(world),
             str(tmp_path), REPO],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for r in range(world)
    ]


def _wait(procs):
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"


def _mse_luv(colors, pal, pmap):
    a = TCS.srgb_to_working(torch.from_numpy(colors.astype(np.float32)), 1)
    b = TCS.srgb_to_working(torch.from_numpy(pal.astype(np.float32)), 1)
    b = b[torch.from_numpy(pmap.astype(np.int64))]
    return float(((a - b) ** 2).sum(-1).mean())


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_against_each_other_and_jax(tmp_path, world):
    procs = _spawn(tmp_path, world)
    try:
        # the JAX package's k-device mesh, while the ranks run
        jmesh = JM.make_mesh(jax.devices()[:world])
        jkm = jpt.quantize(384, 256, image_c(256, 384), 16, mesh=jmesh,
                           **KW_KM)
        img_e = image_c(H_E, W_E, seed=3)
        chans = JM.put_planar_sharded(img_e.astype(np.float32), jmesh)
        pal_e, valid_e = strip_palette()
        jwork = JCS.srgb_to_working(jnp.asarray(pal_e), 2)
        jdither = np.asarray(JM.dither_sharded(
            jmesh, W_E, H_E, 2, segment=64, planar=True)(
                chans, jwork, jnp.asarray(valid_e)))
        jsal = np.asarray(JM.saliency_sharded(
            jmesh, W_E, H_E // world, TILE_E, total_pixels=W_E * H_E)(chans))
        xa = image_a().astype(np.float32)
        jq = [np.asarray(v) for v in JM.quantize_palette_sharded(
            jmesh, 8, kmeans_niter=5)(JM.shard_pixels(xa, jmesh),
                                      JM.put_vector_sharded(np.ones(len(xa)),
                                                            jmesh))]
        # the worker's working colours and palette (the transform is held
        # apart, test_torch_colorspace.py)
        twork_a, tpal_e = (TCS.srgb_to_working(torch.from_numpy(a), 2).numpy()
                           for a in (xa, pal_e))
        jdd = np.asarray(JM.dither_sharded(jmesh, 64, 64, 2, segment=64)(
            JM.shard_pixels(twork_a, jmesh), tpal_e, jnp.asarray(valid_e)))
        jddp = np.asarray(JM.dither_sharded(
            jmesh, 64, 64, 2, segment=64, planar=True)(
                JM.put_planar_sharded(xa, jmesh), tpal_e,
                jnp.asarray(valid_e)))
    finally:
        _wait(procs)
    ranks = [dict(np.load(tmp_path / f"r{r}.npz")) for r in range(world)]
    for r in ranks[1:]:
        assert r.keys() == ranks[0].keys()
        for k in r:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    res = ranks[0]

    used_s = res["a_pal"][res["a_pal"][:, 0] >= 0]
    used_1 = res["a1_pal"][res["a1_pal"][:, 0] >= 0]
    assert len(used_s) == len(used_1)
    for c in used_1:
        assert np.min(np.abs(used_s - c).sum(-1)) < 1e-4

    assert jkm[0]
    img = image_c(256, 384)
    assert (_mse_luv(img, res["km_pal"], res["km_map"])
            <= 1.01 * _mse_luv(img, jkm[1], jkm[2]))
    # its one colour back through ICtCp -> sRGB in f32: the goldens' 1e-4
    np.testing.assert_allclose(res["flat_pal"][0], FLAT[0], atol=1e-4)

    assert (res["strip_dither"] == jdither).mean() >= 0.999
    np.testing.assert_allclose(res["strip_saliency"], jsal, rtol=1e-5, atol=0)

    # the distributed factories against the JAX package's sharded ones
    np.testing.assert_array_equal(res["qpd_valid"], jq[1])
    v = jq[1]
    np.testing.assert_allclose(res["qpd_pal"][v], jq[0][v], atol=1e-4,
                               rtol=0)
    assert (res["qpd_map"] == jq[2]).mean() >= 0.999
    assert (res["dd_map"] == jdd).mean() >= 0.999
    assert (res["ddp_map"] == jddp).mean() >= 0.999

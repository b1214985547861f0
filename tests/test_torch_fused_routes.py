"""The port's single-program routes against the JAX package's: the fused
sampled LUT program, the streamed route's palette program, the sharded
route's palette through ``quantize_palette_sharded``, the opt-in
full-image fused LUT program, and the route every call takes.

Tolerances:
  * the fused sampled program (``_palette_program`` + ``_lut_program``) on
    the JAX program's own working samples, against the JAX
    ``_sample_lut_program`` on their sRGB: the same valid slots, the pack
    within 1e-4 (``test_torch_one_shot.py``'s palette core tolerance: the
    same arithmetic in another summation order); the table equal to K5's
    plain version on the port's palette bit for bit, and its v2 words
    decoding back to it.
  * ``quantize()`` on its default sampled route (fused) against the JAX
    package's, 520x512 uint8 at p = 24 and 64: palette atol 1e-3, map
    >= 99.9%. Both draw the same samples on the host and both run the f32
    device DP; what remains is each side's sRGB -> working arithmetic of
    the samples (ICtCp within 5e-5, ``test_torch_colorspace.py``).
  * the streamed route against the JAX package's (both with the f32 device
    DP on the host-drawn samples): palette atol 1e-3, map >= 99.9%, the
    dithered call's CIELuv MSE ratio port / JAX <= 1.01.
  * ``quantize(mesh=)`` against the JAX package's on a 1-, 2- and 4-device
    mesh (one CPU process a rank, gloo): without draws the same valid
    slots, each entry within 1e-4, map >= 99.9%; with draws, on four
    ranks (KMeans's: each rank draws on the device from ``(seed, rank,
    1)``, the JAX package with ``jax.random``, README T5), CIELuv MSE
    ratio <= 1.01 (one and two ranks with draws are held to the same bound
    in ``test_torch_mesh.py`` and ``test_torch_distributed.py``); every
    rank the same bits.
  * the full-image fused LUT route against the JAX package's
    ``_quantize_image_fused_lut``: CIELuv MSE ratio <= 1.01 (README T6's
    bound, both draw on the device); against the port's own one-shot
    route on the same uint8 image with saliency: the palette bit for bit,
    the map equal to that route's K3 direct map.
  * the route of every call in ``ROUTES``: the same in both packages,
    read from the lap names of route functions stubbed to lap their name
    (the routes themselves are held above and in the other files).
"""

import os
import pathlib
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import patolette_tpu as jpt
import patolette_tpu_torch as tpt
from patolette_tpu.models import pipeline as JP
from patolette_tpu.parallel import mesh as JM
from patolette_tpu_torch.kernels import lut as KL
from patolette_tpu_torch.models import pipeline as TP
from patolette_tpu_torch.ops import colorspace as TCS
from patolette_tpu_torch.ops import lut as TL
from patolette_tpu_torch.parallel import mesh as PM
from test_torch_cores import share_cores  # noqa: F401

REPO = str(pathlib.Path(__file__).resolve().parent.parent)
ICTCP = dict(dither=False, tile_size=0, color_space=tpt.ColorSpace_ICtCp)
FLAGS = ("PATOLETTE_NO_ONE_SHOT", "PATOLETTE_NO_FUSED_LUT",
         "PATOLETTE_FUSED_IMAGE_LUT", "PATOLETTE_NO_STRIP_DITHER")


@pytest.fixture(autouse=True)
def _no_flags(monkeypatch):
    for name in FLAGS:
        monkeypatch.delenv(name, raising=False)


def _image(w, h, seed=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack(
        [
            0.5 + 0.45 * np.sin(xx / 23.0) * np.cos(yy / 31.0),
            0.5 + 0.45 * np.cos(xx / 41.0 + yy / 57.0),
            np.clip(yy / h + 0.06 * rng.standard_normal((h, w)), 0, 1),
        ],
        axis=-1,
    )
    return np.clip(img, 0, 1).reshape(-1, 3)


def _u8(x):
    return np.round(x * 255).astype(np.uint8)


def _mse_luv(colors, pal, pmap):
    x = np.asarray(colors, np.float32)
    if colors.dtype == np.uint8:
        x = x / np.float32(255.0)
    a = TCS.srgb_to_working(torch.from_numpy(x), 1)
    b = TCS.srgb_to_working(torch.from_numpy(pal.astype(np.float32)), 1)
    return float(((a - b[torch.from_numpy(pmap).long()]) ** 2).sum(-1)
                 .mean())


def _port(*args, **kw):
    return tpt.quantize(*args, device="cpu", **kw)


# --- pull_lut(try_v2=False) -------------------------------------------------

def test_pull_lut_without_v2(monkeypatch):
    """With ``try_v2=False`` a u8 table goes to v1 words (or a raw copy),
    a u16 table to a raw copy, and no v2 encode runs (JAX ``lut.py:
    391-417``); either way the table comes back exact."""
    rng = np.random.default_rng(0)
    u8 = torch.from_numpy(np.repeat(rng.integers(0, 256, 64), 256)
                          .astype(np.uint8))
    u16 = u8.to(torch.int32).mul(257).to(torch.uint16)
    for name in ("rle_encode_u8_v2", "rle_encode_u16_v2"):
        monkeypatch.setattr(TL, name, lambda t: pytest.fail("a v2 encode"))
    v1 = []
    real = TL.rle_encode_u8
    monkeypatch.setattr(TL, "rle_encode_u8", lambda t: v1.append(1) or
                        real(t))
    np.testing.assert_array_equal(TL.pull_lut(u8, try_v2=False), u8.numpy())
    assert v1 == [1]
    np.testing.assert_array_equal(TL.pull_lut(u16, try_v2=False),
                                  u16.numpy())
    assert v1 == [1]


# --- the fused sampled program ----------------------------------------------

W8, H8 = 520, 512


@pytest.fixture(scope="module")
def sampled_u8():
    """The port's and the JAX package's default sampled route on the
    520x512 uint8 image at p = 24 (KMeans's own draw) and 64 (S11), with
    the JAX program's inputs and pack and the port program's palette,
    table and words caught on the way."""
    x = _u8(_image(W8, H8))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in FLAGS:
            mp.delenv(name, raising=False)
        mp.setattr(JP, "LUT_MIN_PIXELS", 0)
        mp.setattr(TP, "LUT_MIN_PIXELS", 0)
        jreal, treal = JP._sample_lut_program, TP._lut_program

        def jspy(*args, **kw):
            res = jreal(*args, **kw)
            seen.update(args=args, pack=np.asarray(res[0]))
            return res

        def tspy(centers, valid, csp):
            res = treal(centers, valid, csp)
            seen.update(centers=centers, valid=valid, program=res)
            return res

        mp.setattr(JP, "_sample_lut_program", jspy)
        mp.setattr(TP, "_lut_program", tspy)
        for p in (24, 64):
            seen = {}
            kw = dict(ICTCP, kmeans_niter=8)
            port = _port(W8, H8, x, p, **kw)
            port_laps = set(TP.LAST_STAGE_TIMES)
            jax_out = jpt.quantize(W8, H8, x, p, **kw)
            out[p] = dict(port=port, port_laps=port_laps, jax=jax_out,
                          jax_laps=set(JP.LAST_STAGE_TIMES), seen=seen)
    return x, out


def test_fused_program_against_jax_program(sampled_u8):
    """p = 24: the LQ sample and a KMeans sample of its own. The port's
    program gets the JAX program's working samples; its table, from the
    route's own call, is K5's plain version on its palette (here on every
    61st code) and comes back through its v2 words."""
    _, out = sampled_u8
    p = 24
    seen = out[p]["seen"]
    sub, w_lq, sub_km, w_km = seen["args"][:4]
    assert sub_km is not None and w_lq is None and w_km is None

    def work(s):
        return torch.from_numpy(np.array(JP._to_working(s, 2), np.float32))

    _, _, pack = TP._palette_program(
        work(sub), None, work(sub_km), None, p=p, csp=2, kmeans_niter=8,
        kmeans_max_samples=512 ** 2, seed=1234, lq_batch_splits=8)
    jpack = seen["pack"]
    np.testing.assert_array_equal(pack[3 * p:].numpy(), jpack[3 * p:])
    np.testing.assert_allclose(pack.numpy(), jpack, atol=1e-4, rtol=0)

    table, enc = seen["program"]
    grid = tuple(g[::61] for g in TL.grid_ictcp(2, "cpu"))
    want = KL.lut_argmin_plain(grid, TL.palette_ictcp(seen["centers"], 2),
                               seen["valid"], torch.uint8)
    assert torch.equal(table[::61], want)
    np.testing.assert_array_equal(TL.pull_encoded_v2(enc), table.numpy())


@pytest.mark.parametrize("p", [24, 64])
def test_sampled_route_against_jax_fused(sampled_u8, p):
    _, out = sampled_u8
    (ok, pal, pmap, msg), (jok, jpal, jmap, jmsg) = (out[p]["port"],
                                                      out[p]["jax"])
    assert ok and jok, (msg, jmsg)
    assert out[p]["port_laps"] == out[p]["jax_laps"] == {
        "sample-in", "palette+lut-build", "lut-pull", "lut-map-host"}
    np.testing.assert_allclose(pal, jpal, atol=1e-3, rtol=0)
    assert pmap.dtype == np.int32 and (pmap == jmap).mean() >= 0.999


# --- the streamed route's palette program -----------------------------------

WS, HS, STRIP = 320, 256, 64
KW_S = dict(tile_size=0, kmeans_niter=4, lq_max_samples=8192,
            color_space=tpt.ColorSpace_ICtCp)


@pytest.fixture
def streamed(monkeypatch):
    """Both packages stream 320x64 strips: dithered calls at any size,
    undithered ones through the budget. 81,920 pixels: the LQ draw of
    8192 and a KMeans draw of its own (over the 65,536 cap)."""
    for mod in (TP, JP):
        monkeypatch.setattr(mod, "_stream_strip_pixels", lambda n: WS * STRIP)
    monkeypatch.setattr(TP, "STRIP_DITHER_MIN_PIXELS", 0)
    monkeypatch.setattr(JP, "ONE_SHOT_MAX_PIXELS", 0)
    monkeypatch.setattr(TP, "_device_budget", lambda device: 0)
    monkeypatch.setattr(JP, "HBM_BUDGET_BYTES", 100_000)


def test_streamed_against_jax(streamed):
    """uint8: the LQ draw and the KMeans draw go up as bytes, the strips
    take the packed feed when dithered."""
    x = _u8(_image(WS, HS, seed=5))
    ok, pal, pmap, msg = _port(WS, HS, x, 16, dither=False, **KW_S)
    assert ok, msg
    assert {"sample-in", "palette (device)", "nn-map"} <= set(
        TP.LAST_STAGE_TIMES)
    assert not {"gq-moments", "gq-dp"} & set(TP.LAST_STAGE_TIMES)
    jok, jpal, jmap, jmsg = jpt.quantize(WS, HS, x, 16, dither=False, **KW_S)
    assert jok, jmsg
    assert "palette (device)" in JP.LAST_STAGE_TIMES
    np.testing.assert_allclose(pal, jpal, atol=1e-3, rtol=0)
    assert (pmap == jmap).mean() >= 0.999

    ok, pal, pmap, msg = _port(WS, HS, x, 16, dither=True, **KW_S)
    assert ok, msg
    assert {"palette (device)", "dither"} <= set(TP.LAST_STAGE_TIMES)
    jok, jpal, jmap, jmsg = jpt.quantize(WS, HS, x, 16, dither=True, **KW_S)
    assert jok, jmsg
    assert _mse_luv(x, pal, pmap) <= 1.01 * _mse_luv(x, jpal, jmap)


# --- the full-image fused LUT program ---------------------------------------

WI, HI = 96, 64
KW_I = dict(dither=False, kmeans_niter=2, color_space=tpt.ColorSpace_ICtCp)


def test_image_fused_lut_against_jax_and_one_shot(monkeypatch):
    """96x64 uint8 (no draws: under every cap), the route opened to it by
    ``LUT_MIN_PIXELS`` 0. Against the JAX route with explicit weights
    (``SAMPLE_MAX`` 0 keeps such a call off the sampled route); against
    the port's one-shot route with saliency."""
    x = _u8(_image(WI, HI, seed=4))
    w = np.random.default_rng(4).uniform(0.5, 2.0, WI * HI)
    for mod in (TP, JP):
        monkeypatch.setattr(mod, "LUT_MIN_PIXELS", 0)
    ok, pal1, map1, msg = _port(WI, HI, x, 16, tile_size=256.0, **KW_I)
    assert ok, msg
    assert "one-shot" in TP.LAST_STAGE_TIMES
    monkeypatch.setenv("PATOLETTE_FUSED_IMAGE_LUT", "1")
    ok, pal, pmap, msg = _port(WI, HI, x, 16, tile_size=256.0, **KW_I)
    assert ok, msg
    laps = {"stage-in", "saliency+palette+lut-build", "lut-pull",
            "lut-map-host"}
    assert set(TP.LAST_STAGE_TIMES) == laps
    np.testing.assert_array_equal(pal, pal1)
    np.testing.assert_array_equal(pmap, map1)

    for mod in (TP, JP):
        monkeypatch.setattr(mod, "SAMPLE_MAX", 0)
    ok, pal, pmap, msg = _port(WI, HI, x, 16, weights=w, **KW_I)
    assert ok, msg
    assert set(TP.LAST_STAGE_TIMES) == laps
    jok, jpal, jmap, jmsg = jpt.quantize(WI, HI, x, 16, weights=w, **KW_I)
    assert jok, jmsg
    assert set(JP.LAST_STAGE_TIMES) == laps
    assert _mse_luv(x, pal, pmap) <= 1.01 * _mse_luv(x, jpal, jmap)


# --- the sharded route ------------------------------------------------------

MESH_COMMON = r'''
import numpy as np


def mesh_image(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([0.5 + 0.45 * np.sin(xx / 9.0) * np.cos(yy / 13.0),
                    0.5 + 0.45 * np.cos(xx / 17.0),
                    np.clip(yy / h + 0.08 * rng.standard_normal((h, w)),
                            0, 1)], axis=-1)
    return np.clip(img, 0, 1).reshape(-1, 3)


# (tag, width, height, seed, quantize keywords, worlds): without draws (n
# under every cap), on every mesh; KMeans draws (98,304 pixels over its
# 65,536 cap) on four ranks
MESH_CASES = (
    ("plain", 64, 64, 0, dict(dither=False, tile_size=0, kmeans_niter=4,
                              lq_max_samples=0), (1, 2, 4)),
    ("draws", 384, 256, 1, dict(dither=False, tile_size=0, kmeans_niter=4,
                                lq_max_samples=0, kmeans_max_samples=0),
     (4,)),
)
'''

MESH_WORKER = r'''
import datetime, os, sys
port, rank, world, outdir, repo = (sys.argv[1], int(sys.argv[2]),
                                   int(sys.argv[3]), sys.argv[4], sys.argv[5])
sys.path.insert(0, repo)
sys.path.insert(0, outdir)
import numpy as np
from mesh_common import *
import patolette_tpu_torch as pt
from patolette_tpu_torch.models import global_q as GQ
from patolette_tpu_torch.models import pipeline as TP
from patolette_tpu_torch.parallel import distributed as D
from patolette_tpu_torch.parallel import mesh as PM

mesh = D.init_distributed(f"tcp://localhost:{port}", world, rank,
                          backend="gloo", device="cpu",
                          timeout=datetime.timedelta(seconds=120))
calls = {"sharded": 0}
factory = PM.quantize_palette_sharded


def counted(*a, **k):
    calls["sharded"] += 1
    return factory(*a, **k)


def no_host_dp(*a, **k):
    raise AssertionError("the sharded route ran the host DP")


PM.quantize_palette_sharded = counted
GQ.gq_host = no_host_dp
res = {}
cases = [c for c in MESH_CASES if world in c[5]]
for tag, w, h, seed, kw, _ in cases:
    img = mesh_image(h, w, seed)
    ok, pal, pmap, msg = pt.quantize(w, h, img, 16, mesh=mesh, **kw)
    assert ok, (tag, msg)
    assert "palette (sharded)" in TP.LAST_STAGE_TIMES, tag
    res[tag + "_pal"], res[tag + "_map"] = pal, pmap
assert calls["sharded"] == len(cases), calls
np.savez(os.path.join(outdir, f"r{rank}.npz"), **res)
import torch.distributed
torch.distributed.destroy_process_group()
print(f"rank {rank} done", flush=True)
'''

exec(MESH_COMMON)  # the same inputs here


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    """Every world's ranks, started at once (one process a rank, gloo on
    its own port), while the tests compute the JAX side."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTEST_CURRENT_TEST", None)
    runs = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"world{world}")
        (d / "mesh_common.py").write_text(MESH_COMMON)
        (d / "worker.py").write_text(MESH_WORKER)
        port = _free_port()
        runs[world] = (d, [subprocess.Popen(
            [sys.executable, str(d / "worker.py"), str(port), str(r),
             str(world), str(d), REPO],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)])
    yield runs
    for _, procs in runs.values():
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def _rank_results(run):
    d, procs = run
    logs = []
    for proc in procs:
        try:
            logs.append(proc.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            logs.append(proc.communicate()[0])
    for r, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [dict(np.load(d / f"r{r}.npz")) for r in range(len(procs))]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_against_jax_mesh(mesh_ranks, world):
    jmesh = JM.make_mesh(jax.devices()[:world])
    jres = {}
    for tag, w, h, seed, kw, worlds in MESH_CASES:
        if world in worlds:
            jok, jpal, jmap, jmsg = jpt.quantize(
                w, h, mesh_image(h, w, seed), 16, mesh=jmesh, **kw)
            assert jok, jmsg
            jres[tag] = (jpal, jmap)
    ranks = _rank_results(mesh_ranks[world])
    for r in ranks[1:]:
        assert r.keys() == ranks[0].keys()
        for k in r:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    res = ranks[0]

    pal, jpal = res["plain_pal"], jres["plain"][0]
    np.testing.assert_array_equal(pal[:, 0] >= 0, jpal[:, 0] >= 0)
    np.testing.assert_allclose(pal, jpal, atol=1e-4, rtol=0)
    assert (res["plain_map"] == jres["plain"][1]).mean() >= 0.999
    if "draws" in jres:
        _, w, h, seed, _, _ = MESH_CASES[1]
        img = mesh_image(h, w, seed)
        assert (_mse_luv(img, res["draws_pal"], res["draws_map"])
                <= 1.01 * _mse_luv(img, *jres["draws"]))


# --- the route of every call ------------------------------------------------

# Stubs take the place of each route's function in both packages and lap
# the route's name; a staged palette search laps "sampled-staged" and
# stops the call (its GQ stage, ``_gq_lq_palette``, is reached on no other
# route once the resident route is stubbed).
STUBS = {
    "sampled-fused": ("_quantize_via_samples_fused",
                      "_quantize_via_samples_fused"),
    "streamed": ("_quantize_streamed", "_quantize_streamed"),
    "image-fused-lut": ("_quantize_image_fused_lut",
                        "_quantize_image_fused_lut"),
    "one-shot": ("_quantize_one_shot", "_quantize_one_shot"),
    "resident": ("_quantize_resident", "_quantize_full_upload"),
    "sharded": ("_quantize_sharded", "_quantize_sharded"),
}


class _Stop(Exception):
    pass


def _stub(name):
    def stub(*args, timer, **kw):
        timer.lap(name)
        return True, None, None, name
    return stub


def _staged(*args):
    args[5].lap("sampled-staged")  # the timer
    raise _Stop


SMALL, LARGE = (16, 16), (64, 64)  # under and over every patched threshold
BIG_BUDGET, NO_BUDGET = 1 << 40, 0

# (id, dtype, p, keywords, (width, height), mesh world, flags, budget,
#  the route)
ROUTES = [
    ("u8-lut", "u8", 16, dict(dither=False, tile_size=0), LARGE, 0, (),
     BIG_BUDGET, "sampled-fused"),
    ("u8-lut-no-fused", "u8", 16, dict(dither=False, tile_size=0), LARGE, 0,
     ("PATOLETTE_NO_FUSED_LUT",), BIG_BUDGET, "sampled-staged"),
    ("u8-lut-u16", "u8", 300, dict(dither=False, tile_size=0), LARGE, 0, (),
     BIG_BUDGET, "sampled-staged"),
    ("u8-palette-only", "u8", 16, dict(palette_only=True, tile_size=0),
     LARGE, 0, (), BIG_BUDGET, "sampled-staged"),
    ("f32-palette-only", "f32", 16, dict(palette_only=True, tile_size=0),
     LARGE, 0, (), BIG_BUDGET, "sampled-staged"),
    ("u8-weights", "u8", 16, dict(dither=False, tile_size=0, weights=1),
     LARGE, 0, (), BIG_BUDGET, "sampled-fused"),
    ("u8-saliency", "u8", 16, dict(dither=False), LARGE, 0, (), BIG_BUDGET,
     "resident"),
    ("u8-saliency-image-lut", "u8", 16, dict(dither=False), LARGE, 0,
     ("PATOLETTE_FUSED_IMAGE_LUT",), BIG_BUDGET, "image-fused-lut"),
    ("u8-saliency-image-lut-no-fused", "u8", 16, dict(dither=False), LARGE,
     0, ("PATOLETTE_FUSED_IMAGE_LUT", "PATOLETTE_NO_FUSED_LUT"), BIG_BUDGET,
     "resident"),
    ("u8-saliency-image-lut-p300", "u8", 300, dict(dither=False), LARGE, 0,
     ("PATOLETTE_FUSED_IMAGE_LUT",), BIG_BUDGET, "resident"),
    ("u8-weights-full-image-lut", "u8", 16,
     dict(dither=False, tile_size=0, weights=1, lq_max_samples=0), LARGE, 0,
     ("PATOLETTE_FUSED_IMAGE_LUT",), BIG_BUDGET, "image-fused-lut"),
    ("u8-saliency-small", "u8", 16, dict(dither=False), SMALL, 0,
     ("PATOLETTE_FUSED_IMAGE_LUT",), BIG_BUDGET, "one-shot"),
    ("u8-dither", "u8", 16, dict(tile_size=0), LARGE, 0, (), BIG_BUDGET,
     "streamed"),
    ("u8-dither-no-strip", "u8", 16, dict(tile_size=0), LARGE, 0,
     ("PATOLETTE_NO_STRIP_DITHER",), BIG_BUDGET, "resident"),
    ("f32-default", "f32", 16, {}, LARGE, 0, (), BIG_BUDGET, "resident"),
    ("f32-default-small", "f32", 16, {}, SMALL, 0, (), BIG_BUDGET,
     "one-shot"),
    ("f32-small-no-one-shot", "f32", 16, dict(dither=False, tile_size=0),
     SMALL, 0, ("PATOLETTE_NO_ONE_SHOT",), BIG_BUDGET, "resident"),
    ("f32-over-budget", "f32", 16, dict(dither=False, tile_size=0), LARGE, 0,
     (), NO_BUDGET, "streamed"),
    ("f32-over-budget-saliency", "f32", 16, dict(dither=False), LARGE, 0, (),
     NO_BUDGET, "failed"),
    ("f32-over-budget-no-samples", "f32", 16,
     dict(dither=False, tile_size=0, lq_max_samples=0), LARGE, 0, (),
     NO_BUDGET, "failed"),
    ("mesh-u8-lut", "u8", 16, dict(dither=False, tile_size=0), LARGE, 2, (),
     BIG_BUDGET, "sharded"),
    ("mesh-f32-dither", "f32", 16, dict(tile_size=0), LARGE, 4, (),
     BIG_BUDGET, "sharded"),
    ("mesh-odd-height-dither", "f32", 16, dict(tile_size=0), (64, 62), 4, (),
     BIG_BUDGET, "streamed"),
]


def _mesh_pair(world):
    if not world:
        return None, None
    mesh = object.__new__(PM.Mesh)  # the route's view of a group
    mesh.world, mesh.rank, mesh.device = world, 0, torch.device("cpu")
    return mesh, JM.make_mesh(jax.devices()[:world])


def _route(laps):
    names = [k for k in laps if k in STUBS or k == "sampled-staged"]
    return names[0] if names else "failed"


@pytest.mark.parametrize("case", ROUTES, ids=[c[0] for c in ROUTES])
def test_both_packages_take_the_same_route(monkeypatch, case):
    _, kind, p, kw, (w, h), world, flags, budget, want = case
    for name, (tname, jname) in STUBS.items():
        monkeypatch.setattr(TP, tname, _stub(name))
        monkeypatch.setattr(JP, jname, _stub(name))
    monkeypatch.setattr(TP, "_gq_lq_palette", _staged)
    monkeypatch.setattr(JP, "_gq_lq_palette", _staged)
    for mod in (TP, JP):
        monkeypatch.setattr(mod, "ONE_SHOT_MAX_PIXELS", 1000)
        monkeypatch.setattr(mod, "LUT_MIN_PIXELS", 1000)
        monkeypatch.setattr(mod, "SAMPLE_MAX", 2000)
        monkeypatch.setattr(mod, "_lut_min_pixels", lambda p: 1000)
    monkeypatch.setattr(TP, "STRIP_DITHER_MIN_PIXELS", 1000)
    monkeypatch.setattr(TP, "_device_budget", lambda device: budget)
    monkeypatch.setattr(JP, "HBM_BUDGET_BYTES", budget)
    for name in flags:
        monkeypatch.setenv(name, "1")
    x = _image(w, h, seed=7)
    x = _u8(x) if kind == "u8" else x
    kw = dict(dict(kmeans_niter=0, lq_max_samples=1024), **kw)
    if kw.get("weights") is not None:
        kw["weights"] = np.ones(w * h)
    mesh, jmesh = _mesh_pair(world)
    TP.LAST_STAGE_TIMES.clear()
    _port(w, h, x, p, mesh=mesh, **kw)
    port = _route(TP.LAST_STAGE_TIMES)
    JP.LAST_STAGE_TIMES.clear()
    jpt.quantize(w, h, x, p, mesh=jmesh, **kw)
    assert (port, _route(JP.LAST_STAGE_TIMES)) == (want, want)

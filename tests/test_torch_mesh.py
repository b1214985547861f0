"""quantize(mesh=...) of the port with one rank, in process, against the
JAX package's quantize(mesh=...) on a one-device mesh.

The group is gloo over a FileStore in a temporary directory, world 1,
destroyed when the module ends, so no other test of the worker sees it.
The port runs the plain versions (``device="cpu"``).

Tolerances:
  * no sample draws (``lq_max_samples=0``, n below the KMeans cap): palette
    atol 1e-3 and map agreement >= 99.9%, the tolerance of the
    staged-route tests (``test_torch_lut_route.py``); both packages run
    the f32 device GQ DP on the reduced moments here
    (``test_torch_fused_routes.py`` holds this at 1e-4).
  * with draws: CIELuv MSE ratio port / JAX <= 1.01 (the ranks draw on the
    device from ``(seed, rank, stream)``; the JAX package with
    ``jax.random``, README T5). The draws are KMeans's (384x256 pixels
    over its 65536 cap): over seeds the port's MSE there spreads by 0.11%
    (std, with the host draws the route had before), where
    an LQ draw of a quarter of the pixels spreads by 1.9-2.5%, too much
    for one seed to hold to 1%.
  * uint8: the JAX mesh program folds the byte normalisation into its
    compiled sRGB -> working arithmetic, which moves working values by up
    to ~1.4e-5 from its own float route's and can flip a split, so it is
    held by the MSE ratio <= 1.01; the port's uint8 call must give the
    same palette as its float call on the same pixels, and its 24-bit
    table map the same map (both exact).
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import patolette_tpu as jpt
import patolette_tpu_torch as tpt
from patolette_tpu.models import pipeline as JP
from patolette_tpu.parallel import mesh as JM
from patolette_tpu_torch.models import pipeline as TP
from patolette_tpu_torch.ops import colorspace as TCS
from patolette_tpu_torch.ops import lut as TL
from patolette_tpu_torch.parallel import distributed as TD
from patolette_tpu_torch.parallel import mesh as PM
from patolette_tpu_torch.parallel.mesh import Mesh
from test_torch_cores import share_cores  # noqa: F401

W, H, P = 64, 64, 16


def test_mesh_needs_a_group():
    """Runs before the module's group exists (the first test of the
    file)."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        Mesh(device="cpu")


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield Mesh(device="cpu"), JM.make_mesh(jax.devices()[:1])
    finally:
        dist.destroy_process_group()
        TL.clear_grid_cache()


def _image(h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack(
        [
            0.5 + 0.45 * np.sin(xx / 9.0) * np.cos(yy / 13.0),
            0.5 + 0.45 * np.cos(xx / 17.0),
            np.clip(yy / h + 0.08 * rng.standard_normal((h, w)), 0, 1),
        ],
        axis=-1,
    )
    return np.clip(img, 0, 1).reshape(-1, 3)


def _mse_luv(colors, pal, pmap):
    a = TCS.srgb_to_working(torch.from_numpy(colors.astype(np.float32)), 1)
    b = TCS.srgb_to_working(torch.from_numpy(pal.astype(np.float32)), 1)
    b = b[torch.from_numpy(pmap.astype(np.int64))]
    return float(((a - b) ** 2).sum(-1).mean())


def _both(meshes, colors, **kw):
    mesh, jmesh = meshes
    ok, pal, pmap, msg = tpt.quantize(W, H, colors, P, mesh=mesh, **kw)
    assert ok, msg
    laps = set(TP.LAST_STAGE_TIMES)
    jok, jpal, jmap, jmsg = jpt.quantize(W, H, colors, P, mesh=jmesh, **kw)
    assert jok, jmsg
    assert laps == set(JP.LAST_STAGE_TIMES)
    return pal, pmap, jpal, jmap, laps


NO_DRAWS = dict(kmeans_niter=4, lq_max_samples=0)


@pytest.mark.parametrize("name,kw,laps", [
    ("direct-map", dict(dither=False, tile_size=0),
     {"stage-in", "palette (sharded)", "nn-map"}),
    ("dither", dict(dither=True, tile_size=0, dither_segment=64),
     {"stage-in", "palette (sharded)", "dither"}),
    ("saliency", dict(dither=False, tile_size=128),
     {"stage-in", "saliency", "palette (sharded)", "nn-map"}),
])
def test_one_rank_matches_jax_mesh(meshes, name, kw, laps):
    img = _image()
    pal, pmap, jpal, jmap, got = _both(meshes, img, **kw, **NO_DRAWS)
    assert got == laps
    np.testing.assert_allclose(pal, jpal, atol=1e-3, rtol=0)
    assert pmap.dtype == np.int32 and pmap.shape == (W * H,)
    assert (pmap == jmap).mean() >= 0.999


def test_one_rank_with_draws_mse(meshes):
    """384x256 pixels, 65536 KMeans samples drawn by each side its own
    way."""
    mesh, jmesh = meshes
    w, h = 384, 256
    img = _image(h, w, seed=1)
    kw = dict(dither=False, tile_size=0, kmeans_niter=4, lq_max_samples=0,
              kmeans_max_samples=0)
    ok, pal, pmap, msg = tpt.quantize(w, h, img, P, mesh=mesh, **kw)
    jok, jpal, jmap, jmsg = jpt.quantize(w, h, img, P, mesh=jmesh, **kw)
    assert ok and jok, (msg, jmsg)
    assert _mse_luv(img, pal, pmap) <= 1.01 * _mse_luv(img, jpal, jmap)


def test_one_rank_uint8_lut_route(meshes, monkeypatch):
    monkeypatch.setattr(JP, "LUT_MIN_PIXELS", 0)
    monkeypatch.setattr(TP, "LUT_MIN_PIXELS", 0)
    built = []
    real = TL.build_lut_enc_sharded
    monkeypatch.setattr(TL, "build_lut_enc_sharded",
                        lambda *a: built.append(1) or real(*a))
    u8 = np.round(_image(seed=2) * 255.0).astype(np.uint8)
    x8 = u8.astype(np.float32) * np.float32(1.0 / 255.0)
    kw = dict(dither=False, tile_size=0, **NO_DRAWS)
    pal, pmap, jpal, jmap, laps = _both(meshes, u8, **kw)
    assert built and laps == {"stage-in", "palette (sharded)", "nn-map"}
    assert _mse_luv(x8, pal, pmap) <= 1.01 * _mse_luv(x8, jpal, jmap)
    ok, palf, mapf, msg = tpt.quantize(W, H, x8, P, mesh=meshes[0], **kw)
    assert ok, msg
    np.testing.assert_array_equal(pal, palf)
    np.testing.assert_array_equal(pmap, mapf)


def test_one_rank_palette_only_and_rows_entry(meshes):
    mesh, jmesh = meshes
    img = _image(seed=3)
    kw = dict(dither=False, tile_size=0, **NO_DRAWS)
    ok, pal, pmap, _ = tpt.quantize(W, H, img, P, mesh=mesh,
                                    palette_only=True, **kw)
    jok, jpal, _, _ = jpt.quantize(W, H, img, P, mesh=jmesh,
                                   palette_only=True, **kw)
    assert ok and jok and pmap is None
    np.testing.assert_allclose(pal, jpal, atol=1e-3, rtol=0)
    ok, pal2, pmap2, _ = tpt.quantize(W, H, img, P, mesh=mesh, **kw)
    ok3, pal3, pmap3, msg = TD.quantize_distributed(W, H, img, P, mesh=mesh,
                                                    **kw)
    assert ok and ok3, msg
    np.testing.assert_array_equal(pal3, pal2)
    np.testing.assert_array_equal(pmap3, pmap2)


@pytest.mark.parametrize("planar", [False, True])
def test_one_rank_palette_distributed_equals_single_device(meshes, planar):
    """``quantize_palette_distributed`` with one rank and no draws (the
    mesh palette core: K11 on the exchanged moments, the device-control LQ
    loop with its exchanges) equals ``palette_pipeline_device`` without a
    mesh, bit for bit in centres, valid flags and map: one rank's exchange
    is exact."""
    x = _image(seed=4).astype(np.float32)
    w = np.random.default_rng(4).uniform(0.5, 2.0, len(x)).astype(np.float32)
    colors = tuple(x.T) if planar else x
    got = TD.quantize_palette_distributed(
        meshes[0], P, color_space=1, kmeans_niter=4, planar=planar)(colors, w)
    want = TP.palette_pipeline_device(colors, w, P, color_space=1,
                                      kmeans_niter=4, device="cpu")
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_factories_reject_what_jax_asserts(meshes):
    """A strip of <= 3 rows and the other input form raise ``ValueError``
    (the JAX factories assert; ``test_torch_distributed.py`` holds the
    height that does not divide)."""
    mesh = meshes[0]
    with pytest.raises(ValueError, match="too thin"):
        PM.saliency_sharded(mesh, W, 3, 128.0, W * 3)
    x = _image().astype(np.float32)
    with pytest.raises(ValueError, match="planar"):
        PM.quantize_palette_sharded(mesh, P, planar=True)(x, None)
    with pytest.raises(ValueError, match="planar"):
        PM.dither_sharded(mesh, W, H, 2)(tuple(x.T), x[:P], np.ones(P, bool))


def test_mesh_device_must_agree(meshes):
    ok, _, _, msg = tpt.quantize(W, H, _image(), P, mesh=meshes[0],
                                 device="cuda:0", tile_size=0)
    assert not ok and "mesh" in msg
    bad = TD.quantize_distributed(W, H, _image()[:-1], P, mesh=meshes[0])
    assert not bad[0]


def test_default_device_is_cuda(meshes, monkeypatch):
    """Without ``device`` the mesh asks for ``cuda:<LOCAL_RANK>``: a typed
    failure where there is none, no quiet fall back to the CPU."""
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device not available"):
        Mesh()


def test_init_distributed_default_device_is_cuda(meshes, monkeypatch,
                                                 tmp_path):
    """``init_distributed`` without ``device`` asks for ``cuda:<LOCAL_RANK>``
    too: with no CUDA device it fails typed before it joins a group,
    never quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = dist.FileStore(str(tmp_path / "store"), 1)
    with pytest.raises(RuntimeError, match="CUDA device not available"):
        TD.init_distributed("", 1, 0, store=store)
    assert dist.get_world_size() == 1  # the module's group, untouched

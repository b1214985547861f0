"""The plain reference: it finds no gap in its own float64 maps, flags a
corrupted palette and a corrupted map, searches its palette as the repo's
float64 oracle of upstream does, with upstream's saliency, and its
bfloat16 control fails the cells' limits that the program passes (here at
a size the CPU holds; on the card at the cells' sizes by
``portbench/control.py``)."""

import numpy as np
import pytest
import torch

from portbench.harness import images, manifest
from portbench.reference import check, control

W, H = 64, 48


@pytest.fixture(scope="module")
def scene():
    t = manifest.load_json(manifest.HERE / "traffic" / "stream-4k.json")
    t.update(width=W, height=H, images=1)
    (img,) = images.make_images(t, "float32", 11, "cpu")
    rng = np.random.default_rng(3)
    pal = np.full((16, 3), -1.0)
    pal[:13] = img[rng.integers(0, W * H, 13)]
    return img, pal


def test_palette_rows(scene):
    _, pal = scene
    p = pal.copy()
    p[0] = [1.0, 0.5, 0.2]
    valid, clamped = check.palette_rows(p)
    assert valid.sum() == 13 and clamped[0] and clamped.sum() >= 1


def test_map_gap_flags_a_corrupted_map_and_palette(scene):
    img, pal = scene
    good = control.nearest_map(img, pal, "cpu", dtype=torch.float64)
    assert check.map_gap(img, pal, good, "cpu")[0] == pytest.approx(0.0,
                                                                     abs=1e-12)
    bad = good.copy()
    bad[100] = np.argmax(np.abs(pal[:13] - pal[good[100]]).sum(1))
    assert check.map_gap(img, pal, bad, "cpu")[0] > 1e-3
    moved = pal.copy()
    moved[good[7]] = np.clip(moved[good[7]] + [0.3, -0.3, 0.0], 0.01, 0.99)
    assert check.map_gap(img, moved, good, "cpu")[0] > 1e-3


def test_dither_gap_flags_a_corrupted_map_and_palette(scene):
    img, pal = scene
    good = control.dither_map(img, pal, W, H, "cpu", segment=512,
                              dtype=torch.float64)
    gap, _ = check.dither_gap(img, pal, good, W, H, "cpu", segment=512)
    assert gap == pytest.approx(0.0, abs=1e-12)
    bad = good.copy()
    bad[1000] = np.argmax(np.abs(pal[:13] - pal[good[1000]]).sum(1))
    assert check.dither_gap(img, pal, bad, W, H, "cpu", 512)[0] > 1e-3
    moved = pal.copy()
    moved[3] = np.clip(moved[3] + [0.3, -0.3, 0.0], 0.01, 0.99)
    assert check.dither_gap(img, moved, good, W, H, "cpu", 512)[0] > 1e-3


def test_bad_outputs():
    pal = np.full((4, 3), -1.0)
    pal[:2] = 0.5
    m = np.zeros(6, np.int32)
    assert check.bad_outputs(True, pal, m, 6, 4) == 0
    assert check.bad_outputs(False, pal, m, 6, 4) == 1
    assert check.bad_outputs(True, pal, m.astype(np.int64), 6, 4) == 1
    m2 = m.copy()
    m2[3] = 3                                  # a filled slot
    assert check.bad_outputs(True, pal, m2, 6, 4) == 1
    p2 = pal.copy()
    p2[1] = [0.5, 1.2, 0.5]                    # out of [0, 1]
    assert check.bad_outputs(True, p2, m, 6, 4) == 1


def test_visit_order_is_the_hilbert_curve():
    assert check.visit_order(2, 2, "cpu").tolist() == [0, 2, 3, 1]
    for w, h in ((1, 1), (5, 3), (33, 65), (7, 3)):
        o = check.visit_order(w, h, "cpu")
        assert sorted(o.tolist()) == list(range(w * h))
        # consecutive pixels of the curve on a power-of-two square touch
    o = check.visit_order(8, 8, "cpu")
    x, y = o % 8, o // 8
    assert int(((x[1:] - x[:-1]).abs() + (y[1:] - y[:-1]).abs()).max()) == 1


def test_visit_order_matches_the_program():
    from patolette_tpu_torch.kernels.hilbert import pixel_visit_order_plain

    for w, h in ((5, 3), (33, 65), (64, 48), (4097, 2)):
        assert torch.equal(check.visit_order(w, h, "cpu"),
                           pixel_visit_order_plain(w, h).long())


@pytest.mark.parametrize("workload", ["export-4k", "default-2k"])
def test_program_passes_and_control_fails_the_limits(workload, small_cell):
    import patolette_tpu_torch as pt

    w, h = 256, 192     # the control's widest gap grows with the pixels
    cell = small_cell(workload, width=w, height=h, images=2)
    cfg = cell["config"]
    call = dict(cfg["call"])
    p = call.pop("palette_size")
    call["color_space"] = pt.ColorSpace[call["color_space"]]
    name = "dither_gap" if call["dither"] else "map_gap"
    limit = cell["limits"][name]
    for img in images.make_images(cell["traffic"], cfg["input_dtype"], 21,
                                  "cpu"):
        ok, pal, pmap, _ = pt.quantize(w, h, img, p, device="cpu", **call)
        assert check.bad_outputs(ok, pal, pmap, w * h, p) == 0
        if call["dither"]:
            prog = check.dither_gap(img, pal, pmap, w, h, "cpu")[0]
            cmap = control.dither_map(img, pal, w, h, "cpu")
            ctl = check.dither_gap(img, pal, cmap, w, h, "cpu")[0]
        else:
            prog = check.map_gap(img, pal, pmap, "cpu")[0]
            ctl = check.map_gap(img, pal, control.nearest_map(img, pal,
                                                              "cpu"), "cpu")[0]
        assert prog <= limit < ctl


@pytest.mark.parametrize("workload", ["export-4k", "default-2k"])
def test_program_passes_and_control_fails_the_palette_limit(workload,
                                                            small_cell):
    """The bfloat16 search loses its sums once a bucket or a cluster holds
    some hundreds of pixels, as every one does at the cells' sizes: here
    the least image (512x384, one image) where that is so."""
    import patolette_tpu_torch as pt

    w, h = 512, 384
    cell = small_cell(workload, width=w, height=h, images=1)
    cfg = cell["config"]
    call = dict(cfg["call"])
    p = call.pop("palette_size")
    call["color_space"] = pt.ColorSpace[call["color_space"]]
    (img,) = images.make_images(cell["traffic"], cfg["input_dtype"], 21,
                                "cpu")
    ok, pal, pmap, _ = pt.quantize(w, h, img, p, device="cpu", **call)
    assert check.bad_outputs(ok, pal, pmap, w * h, p) == 0
    ref = check.PaletteReference(img, w, h, cfg["call"], "cpu", 21)
    limit = cell["limits"]["palette_excess"]
    assert ref.excess(pal) <= limit < ref.excess(control.palette(ref))


def _serial_mbd(img):
    """The minimum barrier distance by upstream's raster scans, one pixel
    at a time (pyx:54-201)."""
    rows, cols = img.shape
    lo, hi = img.copy(), img.copy()
    d = np.full_like(img, np.inf)
    d[0], d[-1], d[:, 0], d[:, -1] = 0, 0, 0, 0
    for it in range(3):
        if it % 2 == 0:     # inverse: from the bottom right, (x+1, y), (x, y+1)
            xs, ys, nb = range(rows - 2, 1, -1), range(cols - 2, 1, -1), 1
        else:
            xs, ys, nb = range(1, rows - 1), range(1, cols - 1), -1
        for x in xs:
            for y in ys:
                v = img[x, y]
                u1, l1 = max(hi[x + nb, y], v), min(lo[x + nb, y], v)
                u2, l2 = max(hi[x, y + nb], v), min(lo[x, y + nb], v)
                b1, b2 = u1 - l1, u2 - l2
                if d[x, y] <= b1 and d[x, y] <= b2:
                    continue
                if b1 < d[x, y] and b1 <= b2:
                    d[x, y], hi[x, y], lo[x, y] = b1, u1, l1
                else:
                    d[x, y], hi[x, y], lo[x, y] = b2, u2, l2
    return d


@pytest.mark.parametrize("shape", [(9, 11), (16, 7), (5, 5)])
def test_mbd_is_the_raster_scan(shape):
    from portbench.reference import palette

    img = np.random.default_rng(shape[0]).uniform(0, 1, shape)
    img[2:4] = 0.5      # equal barriers: the ties take the same side
    got = palette._mbd(torch.as_tensor(img)).numpy()
    np.testing.assert_array_equal(got, _serial_mbd(img))


def test_saliency_matches_the_program(scene):
    from patolette_tpu_torch.models import saliency
    from portbench.reference import colour, palette

    img, _ = scene
    t = torch.as_tensor(img)
    prog = saliency.get_weights_planar((t[:, 0], t[:, 1], t[:, 2]), H, W,
                                       16.0).double()
    ref = palette.saliency(colour.srgb_of(img, "cpu"), H, W, 16.0)
    # float32 against float64: each weight within a thousandth of the range
    assert float((prog - ref).abs().max()) < 1e-3 * float((ref - 1).max())


def _oracle():
    import importlib.util

    path = manifest.ROOT / "tests" / "ref_oracle.py"
    if not path.exists():
        pytest.skip("the repo's float64 oracle is not in this checkout")
    spec = importlib.util.spec_from_file_location("ref_oracle", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("tile, niter", [(0.0, 0), (0.0, 8), (16.0, 8)])
def test_palette_search_follows_the_oracle(scene, tile, niter):
    """The search equals the repo's float64 NumPy oracle of upstream's GQ,
    LQ and KMeans, with the reference's own saliency as the weights (no
    pixel is drawn at this size)."""
    from portbench.reference import colour, palette

    oracle = _oracle()
    img, _ = scene
    call = {"palette_size": 32, "tile_size": tile, "kmeans_niter": niter}
    srgb = colour.srgb_of(img, "cpu")
    w = palette.weights_of(srgb, W, H, call)
    got = palette.search(srgb, w, call, 5)
    want, _ = oracle.quantize_ref(img.astype(np.float64), 32, 2,
                                  weights=None if w is None else w.numpy(),
                                  kmeans_niter=niter)
    assert got.shape == (32, 3) and len(want) == 32
    np.testing.assert_allclose(np.sort(got, 0), np.sort(want, 0), atol=1e-9)


def test_palette_excess_flags_a_worse_palette(scene):
    img, _ = scene
    call = {"palette_size": 16, "tile_size": 0.0, "kmeans_niter": 4}
    ref = check.PaletteReference(img, W, H, call, "cpu", 9)
    assert ref.excess(ref.palette) == pytest.approx(0.0, abs=1e-12)
    fewer = ref.palette.copy()
    fewer[8:] = -1.0
    assert ref.excess(fewer) > 0.2
    assert ref.excess(control.palette(ref)) > 0.02

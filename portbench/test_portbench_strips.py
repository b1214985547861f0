"""The streamed route's check, ``dither_gap_strips``: with one strip it is
``dither_gap`` bit for bit; a map walked strip by strip reads 0 on it and
fails the whole-image walk, and a map walked along the whole image fails
it; the port's streamed dither passes it and the bfloat16 control fails
it; checks that ``run.judge`` does not know are found by name under
``reference/checks/``, and a name with no file fails loudly."""

import numpy as np
import pytest
import torch

from portbench import run
from portbench.harness import images, manifest
from portbench.reference import check, control

W, H, ROWS = 64, 48, 16
CELL = "dither-100mp-streamed"


@pytest.fixture(scope="module")
def scene():
    t = manifest.load_json(manifest.HERE / "traffic" / "stream-100mp.json")
    t.update(width=W, height=H, images=1)
    (img,) = images.make_images(t, "float32", 17, "cpu")
    rng = np.random.default_rng(5)
    pal = np.full((16, 3), -1.0)
    pal[:13] = img[rng.integers(0, W * H, 13)]
    return img, pal


def _config(rows, segment=4096):
    cfg = manifest.load_json(manifest.HERE / "configs"
                             / "dither-no-saliency.json")
    cfg["strip_rows"] = rows
    cfg["call"]["dither_segment"] = segment
    return cfg


def _limit():
    return manifest.load_json(manifest.HERE / "checks"
                              / "dither-no-saliency.json")["dither_gap_strips"]


@pytest.mark.parametrize("rows, segment", [(H, 4096), (1677, 4096),
                                           (H, 512), (1677, 0)])
def test_one_strip_is_the_whole_image_walk(scene, rows, segment):
    img, pal = scene
    strips = manifest.check("dither_gap_strips")
    pmap = control.dither_map(img, pal, W, H, "cpu", segment)  # gaps > 0
    want = check.dither_gap(img, pal, pmap, W, H, "cpu", segment)
    got = strips.check(img, pal, pmap, W, H, "cpu", _config(rows, segment))
    assert want[0] > 0 and got == want


def test_the_strips_are_the_programs_own_curves():
    steps, n = check._lanes(10, 7, 16, "cpu", strip_rows=3)
    assert n == 70 and steps.shape == (5, 16)   # 2 + 2 lanes, then 1
    real = steps[steps < n]
    assert sorted(real.tolist()) == list(range(70))
    for r0, lanes in ((0, steps[:2]), (3, steps[2:4]), (6, steps[4:])):
        h = min(3, 7 - r0)
        order = lanes[lanes < n] - r0 * 10
        assert torch.equal(order, check.visit_order(10, h, "cpu"))


def test_a_strip_walked_map_needs_the_strip_walk(scene):
    img, pal = scene
    cfg = _config(ROWS)
    strips = manifest.check("dither_gap_strips")
    by_strip = check.walk(img, pal, W, H, "cpu", strip_rows=ROWS)[2]
    assert strips.check(img, pal, by_strip, W, H, "cpu", cfg)[0] == 0.0
    assert check.dither_gap(img, pal, by_strip, W, H, "cpu")[0] > _limit()
    whole = check.walk(img, pal, W, H, "cpu")[2]
    assert check.dither_gap(img, pal, whole, W, H, "cpu")[0] == 0.0
    assert strips.check(img, pal, whole, W, H, "cpu", cfg)[0] > _limit()


def test_the_streamed_program_passes_and_the_control_fails(small_cell,
                                                           small_strips,
                                                           monkeypatch):
    """The port's streamed call on the CPU, its dither run strip by strip
    (``riemersma_dither_rec2020`` once a strip), against the strips'
    limit; the control, the strips walked in bfloat16, fails it."""
    import patolette_tpu_torch as pt
    from patolette_tpu_torch.models import pipeline

    w, h, rows = 256, 192, 64    # the control's gap grows with the pixels
    cell = small_strips(small_cell(CELL, width=w, height=h, images=2), rows)
    cfg = cell["config"]
    call = dict(cfg["call"])
    p = call.pop("palette_size")
    call["color_space"] = pt.ColorSpace[call["color_space"]]
    strips_run = []
    dither = pipeline.DITH.riemersma_dither_rec2020

    def spy(ch, pal, valid, width, height, *a, **kw):
        strips_run.append((width, height))
        return dither(ch, pal, valid, width, height, *a, **kw)

    monkeypatch.setattr(pipeline.DITH, "riemersma_dither_rec2020", spy)
    strips = manifest.check("dither_gap_strips")
    limit = cell["limits"]["dither_gap_strips"]
    for img in images.make_images(cell["traffic"], cfg["input_dtype"], 23,
                                  "cpu"):
        strips_run.clear()
        ok, pal, pmap, _ = pt.quantize(w, h, img, p, device="cpu", **call)
        assert strips_run == [(w, rows)] * 3
        assert check.bad_outputs(ok, pal, pmap, w * h, p) == 0
        prog = strips.check(img, pal, pmap, w, h, "cpu", cfg)[0]
        cmap = strips.control(img, pal, w, h, "cpu", cfg)
        ctl = strips.check(img, pal, cmap, w, h, "cpu", cfg)[0]
        assert prog <= limit < ctl
        assert check.dither_gap(img, pal, pmap, w, h, "cpu")[0] > limit


def test_a_check_is_found_by_name():
    mod = manifest.check("dither_gap_strips")
    assert callable(mod.check) and callable(mod.control)
    limits = manifest.cell(manifest.load_benchmark(), CELL)["limits"]
    assert "dither_gap_strips" in limits


def test_an_unknown_check_fails_loudly(small_cell):
    with pytest.raises(KeyError, match="no_such_gap"):
        manifest.check("no_such_gap")
    cell = small_cell("default-2k", width=32, height=24, images=1)
    cell["limits"] = {"bad_outputs": 0, "no_such_gap": 1.0}
    (img,) = images.make_images(cell["traffic"], "float32", 3, "cpu")
    pal = np.full((256, 3), -1.0)
    pal[0] = 0.5
    kept = {0: {"image": 0, "ok": True, "palette": pal,
                "map": np.zeros(32 * 24, np.int32), "message": "",
                "first": True, "drawn": True}}
    with pytest.raises(KeyError, match="no_such_gap"):
        run.judge(cell, [img], kept, "cpu", 1, log=lambda m: None)

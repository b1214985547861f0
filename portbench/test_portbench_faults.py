"""A run with the timed path broken underneath must come out not correct.

``run.run_cell`` is driven on the CPU (the card check skipped, the port's
plain versions) at a small size, with ``quantize`` wrapped so that it
answers wrongly where the answer is produced: one pixel's entry altered,
one palette entry moved, half of the map left as entry 0, the previous
image's answer returned again (its state unchanged), a call that fails;
or so that the palette search does less: KMeans skipped, the saliency
left out (weights of 1), half the palette's colours searched. The
unbroken run comes out correct. The streamed cell runs in strips of 32
rows, so that its check walks three strips. One-card cells have no exchange between
chips to leave out. The faults use entries with every channel inside
(0, 1): the reference leaves out pixels at entries clamped to the cube's
faces (see ``reference/check.py``). The saliency's tile is cut with the
image (16 pixels at 128x96), so that the weights weigh as much as at the
cells' sizes."""

import numpy as np
import pytest

from portbench import run


def _inner(pal):
    """Slots of valid entries with every channel inside (0, 1)."""
    return np.flatnonzero(np.all((pal > 0.0) & (pal < 1.0), axis=1))


def alter_entry(out, state):
    ok, pal, pmap, msg = out
    pmap = pmap.copy()
    inner = _inner(pal)
    i = int(np.flatnonzero(np.isin(pmap, inner))[0])
    pmap[i] = inner[np.argmax(np.abs(pal[inner] - pal[pmap[i]]).sum(1))]
    return ok, pal, pmap, msg


def move_palette(out, state):
    ok, pal, pmap, msg = out
    pal = pal.copy()
    j = int(_inner(pal)[0])
    pal[j] = np.where(pal[j] > 0.5, pal[j] - 0.3, pal[j] + 0.3)
    return ok, pal, pmap, msg


def half_left_out(out, state):
    ok, pal, pmap, msg = out
    pmap = pmap.copy()
    pmap[len(pmap) // 2:] = _inner(pal)[0]
    return ok, pal, pmap, msg


def stale(out, state):
    prev = state.get("prev")
    state["prev"] = out
    return out if prev is None else prev


def fail(out, state):
    return False, None, None, "Internal quantization error. [planted]"


def no_kmeans(w, h, px, p, **kw):
    return {**kw, "kmeans_niter": 0}, p


def no_saliency(w, h, px, p, **kw):
    return {**kw, "weights": np.ones(w * h, np.float32)}, p


def half_palette(w, h, px, p, **kw):
    return kw, p // 2


FAULTS = {"alter_entry": alter_entry, "move_palette": move_palette,
          "half_left_out": half_left_out, "stale": stale, "fail": fail}
SEARCH_FAULTS = {"no_kmeans": no_kmeans, "no_saliency": no_saliency,
                 "half_palette": half_palette}


CASES = [(w, f) for w in ("export-4k", "default-2k",
                           "dither-100mp-streamed")
         for f in (None, *FAULTS, *SEARCH_FAULTS)
         if not (f == "no_saliency" and w != "default-2k")]  # no saliency


@pytest.mark.parametrize("workload, fault", CASES)
def test_a_broken_path_is_not_correct(workload, fault, small_cell,
                                      small_strips):
    from patolette_tpu_torch.models import pipeline

    cell = small_cell(workload, width=128, height=96, images=2)
    if "strip_rows" in cell["config"]:      # 3 strips of 32 rows
        small_strips(cell, 32)
    call = cell["config"]["call"]
    if call["tile_size"] > 0:
        call["tile_size"] = 16.0
    state = {}

    def broken(w, h, px, p, **kw):
        if fault in SEARCH_FAULTS:
            kw, q = SEARCH_FAULTS[fault](w, h, px, p, **kw)
            ok, pal, pmap, msg = pipeline.quantize(w, h, px, q, **kw)
            if ok and q < p:    # the unsearched slots, filled
                pal = np.concatenate([pal, np.full((p - q, 3), -1.0)])
            return ok, pal, pmap, msg
        out = pipeline.quantize(w, h, px, p, **kw)
        return out if fault is None else FAULTS[fault](out, state)

    res = run.run_cell(cell, 2**31 + 3, 0.01, False, "cpu", 0.0,
                       log=lambda m: None, quantize=broken)
    assert res["correct"] is (fault is None), res["checks"]
    assert list(res)[-1] == "checks"

"""The port's stage spans (``utils/spans.py``, ``_StageTimer.stage``) in
the profiler's timeline.

A small call on each of the resident, one-shot, fused sampled and streamed
routes (forced through the module's thresholds) runs under
``torch.profiler`` with CPU activity. Its exported Chrome trace must hold
one ``patolette/<lap>`` range each time a lap is taken, in lap order,
disjoint and inside the call's own range, and one ``patolette/lq-loop``
inside a span of the palette core (the layer ``portbench/laps.json`` puts
those laps in). Without a profiler no ``record_function`` is entered; the
outputs are the same bits with the profiler on and off; ``sync_stages``
keeps the lap keys.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from patolette_tpu_torch.models import pipeline as TP
from patolette_tpu_torch.utils import spans
from test_torch_cores import share_cores  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
W, H = 32, 24
P = 6  # colours: the LQ loop takes six rounds

# route -> (pixel type, quantize keywords, module settings, the laps in
# order, each as often as it is taken)
ROUTES = {
    "resident": ("f32", dict(dither=False), {"ONE_SHOT_MAX_PIXELS": 0},
                 ["stage-in", "saliency", "to-working+sample", "gq-moments",
                  "gq-dp", "lq", "kmeans", "nn-map", "palette-out"]),
    "one-shot": ("f32", {}, {},
                 ["stage-in", "saliency", "palette", "dither", "one-shot"]),
    "fused": ("u8", dict(dither=False, tile_size=0), {"LUT_MIN_PIXELS": 0},
              ["sample-in", "palette+lut-build", "lut-pull",
               "lut-map-host"]),
    "streamed": ("f32", dict(dither=False, tile_size=0),
                 {"_device_budget": lambda device: 0,
                  "_stream_strip_pixels": lambda n: W * 10},
                 ["sample-in", "palette (device)", "strip-in", "nn-map",
                  "strip-in", "nn-map", "strip-in", "nn-map",
                  "palette-out"]),
}


def _image(kind):
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.stack([0.5 + 0.4 * np.sin(xx / 7.0),
                    0.5 + 0.4 * np.cos(yy / 5.0),
                    (xx + yy) / (W + H)], axis=-1).reshape(-1, 3)
    img = np.clip(img + 0.05 * rng.standard_normal(img.shape), 0.0, 1.0)
    img = img.astype(np.float32)
    return np.round(img * 255).astype(np.uint8) if kind == "u8" else img


def _call(route, monkeypatch, **extra):
    kind, kw, settings, _ = ROUTES[route]
    for name, value in settings.items():
        monkeypatch.setattr(TP, name, value)
    ok, pal, pmap, msg = TP.quantize(W, H, _image(kind), P, kmeans_niter=2,
                                     device="cpu", **kw, **extra)
    assert ok, msg
    return pal, pmap, list(TP.LAST_STAGE_TIMES)


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    """Every route's call in one profiler session, each in its own range
    named after the route: route -> (palette, map, laps, the user ranges
    (start, end, name) inside the call's range, the call's first)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    outs = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for route in ROUTES:
            with pytest.MonkeyPatch.context() as mp:
                with record_function(route):
                    outs[route] = _call(route, mp)
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation")
    out = {}
    for route, (pal, pmap, laps) in outs.items():
        (c0, c1, _), = [r for r in ranges if r[2] == route]
        out[route] = pal, pmap, laps, [r for r in ranges
                                       if c0 <= r[0] and r[1] <= c1]
    return out


@pytest.mark.parametrize("route", ROUTES)
def test_each_lap_is_one_span_in_lap_order(profiled, route):
    _, _, laps, ranges = profiled[route]
    assert laps == list(dict.fromkeys(ROUTES[route][3]))
    (c0, c1, _) = ranges[0]
    assert ranges[0][2] == route
    stages = [r for r in ranges if r[2].startswith(spans.PREFIX)
              and r[2] != spans.PREFIX + "lq-loop"]
    names = [n[len(spans.PREFIX):] for _, _, n in stages]
    assert names == ROUTES[route][3]
    assert set(names) == set(laps)
    for (s, e, _), (s2, _, _) in zip(stages, stages[1:]):
        assert s <= e <= s2
    assert all(c0 <= s and e <= c1 for s, e, _ in stages)


@pytest.mark.parametrize("route", ROUTES)
def test_one_lq_loop_span_inside_the_palette_core(profiled, route):
    _, _, _, ranges = profiled[route]
    layers = json.loads((ROOT / "portbench" / "laps.json").read_text())
    core = {spans.PREFIX + lap for lap in layers["layers"]["palette core"]}
    (s, e, _), = [r for r in ranges if r[2] == spans.PREFIX + "lq-loop"]
    assert [n for s0, e0, n in ranges if n in core and s0 <= s and e <= e0]


@pytest.mark.parametrize("route", ROUTES)
def test_no_record_function_without_a_profiler(profiled, route,
                                               monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    pal, pmap, laps = _call(route, monkeypatch)
    want_pal, want_map, want_laps, _ = profiled[route]
    assert laps == want_laps
    np.testing.assert_array_equal(pal, want_pal)
    np.testing.assert_array_equal(pmap, want_map)


@pytest.mark.parametrize("route", ROUTES)
def test_sync_stages_keeps_the_lap_keys(profiled, route, monkeypatch):
    _, _, laps = _call(route, monkeypatch, sync_stages=True)
    assert laps == profiled[route][2]

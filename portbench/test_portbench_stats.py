import statistics
import types

import pytest

from portbench.harness import manifest, stats
from portbench.harness.trace import Trace


def _ctx(**kw):
    base = dict(calls=[], log=lambda m: None, trace=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_mp_per_s():
    ctx = _ctx(pixels_done=3 * 8_294_400, window_s=0.9)
    assert manifest.reader("mp_per_s")(ctx) == pytest.approx(
        3 * 8.2944 / 0.9)


def test_p90_and_count():
    ms = [float(v) for v in range(1, 101)]
    ctx = _ctx(calls=[{"ms": v, "laps": {}} for v in ms])
    got = manifest.reader("call_p90_ms")(ctx)
    assert got["n"] == 100
    assert got["value"] == pytest.approx(statistics.quantiles(ms, n=10)[8])
    assert got["value"] == pytest.approx(90.9)


def test_interval_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (9, 12)]
    assert stats.merge(iv, 0, 10) == [(0, 3), (5, 6), (9, 10)]
    assert stats.covered(iv, 0, 10) == 3 + 1 + 1
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 9)]
    assert stats.idle_pct(iv, 0, 10) == pytest.approx(50.0)



def _chrome(calls, device, host=()):
    ev = [{"ph": "X", "cat": "user_annotation", "name": f"portbench_call_{i}",
           "ts": s, "dur": e - s} for i, (s, e) in enumerate(calls)]
    ev += [{"ph": "X", "cat": k, "name": n, "ts": s, "dur": e - s}
           for n, k, s, e in device]
    ev += [{"ph": "X", "cat": "cpu_op", "name": n, "ts": s, "dur": e - s}
           for n, s, e in host]
    return ev


def test_idle_share_and_breakdown_on_a_timeline():
    # two calls of 1000 us; kernels 100 + 300 us, a copy of 100 us
    tr = Trace.from_chrome(_chrome(
        [(0, 1000), (1000, 2000)],
        [("k1", "kernel", 100, 200), ("cp", "gpu_memcpy", 150, 250),
         ("k2", "kernel", 1200, 1500)],
        [("aten::lq", 300, 900), ("aten::map", 1600, 1990)]))
    assert tr.window_s() == pytest.approx(2000e-6)
    assert tr.busy_s() == pytest.approx(450e-6)
    assert tr.kernel_s() == pytest.approx(400e-6)
    ctx = _ctx(trace=tr)
    assert manifest.reader("device_idle_pct")(ctx) == pytest.approx(77.5)
    ops = dict(tr.device_ops())
    assert ops["k2"] == pytest.approx(300e-6)
    laps = [{"palette": 0.9, "map": 0.1}, {"palette": 0.5, "map": 0.5}]
    gaps = dict(tr.idle_gaps(laps))
    # gaps 0-100 (no host op), 250-1200 (its middle in aten::lq), 1500-2000
    assert gaps["palette | python"] == pytest.approx(100e-6)
    assert gaps["palette | aten::lq"] == pytest.approx(950e-6)
    assert gaps["map | aten::map"] == pytest.approx(500e-6)
    assert sum(gaps.values()) == pytest.approx(2000e-6 - 450e-6)


def test_lap_layers_and_missing_laps():
    said = []
    calls = [{"ms": 1.0, "laps": {"sample-in": 2.0, "palette+lut-build": 5.0,
                                  "lut-pull": 1.0, "lut-map-host": 3.0}},
             {"ms": 1.0, "laps": {"sample-in": 4.0, "palette+lut-build": 7.0,
                                  "lut-pull": 1.0, "lut-map-host": 5.0}}]
    ctx = _ctx(calls=calls, log=said.append)
    assert manifest.reader("staging_host_ms")(ctx) == 3.0
    assert manifest.reader("palette_host_ms")(ctx) == 6.0
    assert manifest.reader("map_host_ms")(ctx) == 5.0
    assert manifest.reader("saliency_host_ms")(ctx) is None
    assert said and "saliency" in said[0]

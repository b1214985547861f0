"""The program's spans in a traced pass: a synthetic Chrome trace of two
calls with ``patolette/<lap>`` ranges (one ``patolette/lq-loop`` nested in
each call's palette core), their device-side ``gpu_user_annotation``
shadows, runtime calls with correlation ids, kernels, copies, a graph
launch, host waits and idle gaps. ``host_syncs`` reads its hand-computed
count; the seven older per-layer readers and the breakdown read their
hand-computed values, the same as on the trace without the spans."""

import types

import pytest

from portbench import bounds
from portbench.harness import manifest
from portbench.harness.trace import Trace

CALLS = [(0, 1000), (1000, 2000)]
SPANS = [("sample-in", 10, 100), ("palette+lut-build", 100, 800),
         ("lq-loop", 200, 600), ("lut-pull", 800, 900),
         ("palette", 1050, 1700), ("lq-loop", 1100, 1500),
         ("one-shot", 1700, 1990)]
# (name, category, start, end, correlation)
RUNTIME = [("cudaLaunchKernel", "cuda_runtime", 210, 215, 1),
           ("cudaMemcpyAsync", "cuda_runtime", 300, 304, 2),
           ("cudaStreamSynchronize_v3020", "cuda_runtime", 350, 400, 3),
           ("cudaGraphLaunch", "cuda_runtime", 1200, 1210, 5),
           ("cuLaunchKernel", "cuda_driver", 1600, 1605, 6),
           ("cudaDeviceSynchronize", "cuda_runtime", 1900, 1950, 7),
           ("cudaMemcpy", "cuda_runtime", 1960, 1980, 8),
           ("cudaLaunchKernel", "cuda_runtime", 2100, 2105, 9),
           ("cudaStreamSynchronize", "cuda_runtime", 2300, 2310, 10)]
DEVICE = [("k1", "kernel", 220, 300, 1),
          ("copy", "gpu_memcpy", 310, 350, 2),
          ("gk1", "kernel", 1210, 1300, 5), ("gk2", "kernel", 1300, 1350, 5),
          ("tk", "kernel", 1610, 1640, 6),
          ("copy", "gpu_memcpy", 1962, 1978, 8),
          ("late", "kernel", 2110, 2200, 9)]
HOST = [("aten::add", 205, 216), ("aten::copy_", 296, 410),
        ("aten::item", 1880, 1995)]
LAPS = [{"sample-in": 0.1, "palette+lut-build": 0.7, "lut-pull": 0.1,
         "lut-map-host": 0.1},
        {"stage-in": 0.05, "palette": 0.65, "one-shot": 0.3}]


def _x(cat, name, s, e, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": s, "dur": e - s}
    if corr is not None:
        ev["args"] = {"correlation": corr, "External id": 7}
    return ev


def _events(spans=True):
    ev = [_x("user_annotation", f"portbench_call_{i}", s, e)
          for i, (s, e) in enumerate(CALLS)]
    ev += [_x(cat, n, s, e, c) for n, cat, s, e, c in RUNTIME]
    ev += [_x(cat, n, s, e, c) for n, cat, s, e, c in DEVICE]
    ev += [_x("cpu_op", n, s, e) for n, s, e in HOST]
    ev.append({"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "ts": 210})
    if spans:
        ev += [_x("user_annotation", f"patolette/{n}", s, e)
               for n, s, e in SPANS]
        ev += [_x("gpu_user_annotation", f"patolette/{n}", s + 5, e + 40)
               for n, s, e in SPANS]
    return ev


def _ctx(trace, cell=None):
    calls = [{"ms": 1.0 + i, "laps": LAPS[i % 2]} for i in range(10)]
    return types.SimpleNamespace(calls=calls, trace=trace, cell=cell,
                                 n=8_294_400, valid=256, log=lambda m: None)


@pytest.fixture
def trace():
    return Trace.from_chrome(_events())


def test_host_syncs_counts_the_waits_inside_the_calls(trace):
    # call 0: cudaStreamSynchronize_v3020; call 1: cudaDeviceSynchronize and
    # the synchronous cudaMemcpy; the wait after the last call is outside
    got = manifest.reader("host_syncs")(_ctx(trace))
    assert got == {"value": 1.5, "n": 2}


@pytest.mark.parametrize("name,waits", [
    ("cudaStreamSynchronize", 1), ("cudaStreamSynchronize_ptsz", 1),
    ("cudaEventSynchronize_v3020", 1), ("cudaDeviceSynchronize", 1),
    ("cudaMemcpy", 1), ("cudaMemcpy_v3020", 1), ("cudaMemcpyAsync", 0),
    ("cudaLaunchKernel_ptsz_v7000", 0), ("cudaGraphLaunch", 0),
])
def test_waits_by_runtime_name(name, waits):
    tr = Trace.from_chrome([_x("user_annotation", "portbench_call_0", 0, 10),
                            _x("cuda_runtime", name, 2, 3, 1)])
    assert manifest.reader("host_syncs")(_ctx(tr))["value"] == waits


def test_no_trace_reads_nothing():
    assert manifest.reader("host_syncs")(_ctx(None)) is None


def test_older_readers_and_breakdown_read_the_same_values(trace):
    # device work in the calls: k1 80, copy 40, gk1 + gk2 140, tk 30,
    # copy 16 us; the gpu_user_annotation shadows are no device work
    assert trace.busy_s() == pytest.approx(306e-6)
    assert trace.kernel_s() == pytest.approx(250e-6)
    ops = dict(trace.device_ops())
    assert ops == pytest.approx({"k1": 80e-6, "copy": 56e-6, "gk1": 90e-6,
                                 "gk2": 50e-6, "tk": 30e-6})
    gaps = dict(trace.idle_gaps(LAPS))
    # gaps 0-220, 300-310, 350-1210, 1350-1610, 1640-1962, 1978-2000; by
    # the lap the durations put each middle in and the innermost host
    # operation there (the runtime calls are host operations)
    assert gaps == pytest.approx({
        "palette+lut-build | python": 220e-6 + 860e-6,
        "palette+lut-build | aten::copy_": 10e-6,
        "palette | python": 260e-6,
        "one-shot | python": 322e-6,
        "one-shot | aten::item": 22e-6})
    cell = manifest.cell(manifest.load_benchmark(), "export-4k")
    ctx = _ctx(trace, cell)
    assert manifest.reader("device_idle_pct")(ctx) == pytest.approx(
        100.0 * (1.0 - 306.0 / 2000.0))
    least = bounds.call_least_ms(cell["config"]["call"], ctx.n, 256,
                                 cell["config"]["input_dtype"])
    assert manifest.reader("device_roofline_pct")(ctx) == pytest.approx(
        100.0 * least * 1e-3 * 2 / 250e-6)
    assert manifest.reader("call_p90_ms")(ctx)["value"] == pytest.approx(
        9.9)
    # host staging: sample-in 0.1; stage-in 0.05 + one-shot 0.3
    assert manifest.reader("staging_host_ms")(ctx) == pytest.approx(0.225)
    assert manifest.reader("palette_host_ms")(ctx) == pytest.approx(0.675)
    assert manifest.reader("map_host_ms")(ctx) == pytest.approx(0.1)
    assert manifest.reader("saliency_host_ms")(ctx) is None

    bare = Trace.from_chrome(_events(spans=False))
    assert bare.busy_s() == trace.busy_s()
    assert bare.kernel_s() == trace.kernel_s()
    assert bare.device_ops() == trace.device_ops()
    assert bare.idle_gaps(LAPS) == trace.idle_gaps(LAPS)
    assert bare.host == trace.host and bare.device == trace.device

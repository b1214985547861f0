"""The LQ loop's graph cache (``models/local_q.py::lq_quantize``) on the
CPU, with the capture and the replay stubbed.

A stub graph takes the place of ``_LoopGraph``: its capture records
nothing on the card, and its replay runs the eager loop on the graph's own
buffers, writing the labels and the count in place as a replay does. So
the cache's policy runs as on the card: the key, eager on a key's first
call, capture on its second, replay after, the least recent key out
first, the mesh and the CPU always eager, and every output a copy.
"""

import numpy as np
import pytest
import torch

from patolette_tpu_torch.models import local_q as LQ
from test_torch_cores import share_cores  # noqa: F401

P = 8


def _inputs(n=300, k=3, seed=0):
    """Elongated blobs in ``k`` GQ clusters: (colors, labels)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.2, 0.8, (k, 3))
    axes = rng.standard_normal((k, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    lab = rng.integers(0, k, n)
    t = rng.standard_normal(n)[:, None] * 0.12
    x = centers[lab] + t * axes[lab] + 0.01 * rng.standard_normal((n, 3))
    return (torch.from_numpy(x.astype(np.float32)),
            torch.from_numpy(lab.astype(np.int32)))


class StubGraph(LQ._LoopGraph):
    captures = 0

    def capture(self):
        StubGraph.captures += 1
        self.count = torch.zeros((), dtype=torch.int32)

    def replay(self):
        self.count.copy_(self.body())


@pytest.fixture
def stubbed(monkeypatch):
    monkeypatch.setattr(LQ, "_on_card", lambda colors: True)
    monkeypatch.setattr(LQ, "_LoopGraph", StubGraph)
    StubGraph.captures = 0
    LQ.clear_lq_graphs()
    LQ.reset_lq_graph()
    yield
    LQ.clear_lq_graphs()
    LQ.reset_lq_graph()


def _same(a, b):
    return torch.equal(a[0], b[0]) and int(a[1]) == int(b[1])


def test_eager_then_capture_then_replay(stubbed):
    x, lab = _inputs()
    want = LQ.lq_loop(x, None, lab, 3, P)
    seen = []
    for _ in range(4):
        got = LQ.lq_quantize(x, None, lab, 3, P)
        assert _same(got, want)
        seen.append(dict(LQ.LQ_GRAPH))
    assert seen == [
        {"eager": 1, "captured": 0, "replayed": 0},
        {"eager": 1, "captured": 1, "replayed": 1},
        {"eager": 1, "captured": 1, "replayed": 2},
        {"eager": 1, "captured": 1, "replayed": 3},
    ]
    assert StubGraph.captures == 1


def test_key_fields(stubbed):
    x, lab = _inputs()
    w = torch.linspace(0.5, 2.0, x.shape[0])
    LQ.lq_quantize(x, w, lab, 3, P, batch_splits=8)
    assert list(LQ._graphs) == [
        (x.device, x.shape[0], P, LQ._batch_size(8, P), LQ.BUCKET_COUNT,
         torch.float32, True)]


@pytest.mark.parametrize("change", [
    "n", "palette_size", "batch_splits", "bucket_count", "weights"])
def test_each_field_makes_its_own_key(stubbed, change):
    x, lab = _inputs()
    base = dict(palette_size=32, batch_splits=1, bucket_count=64)
    other = dict(base)
    xo, labo, wo = x, lab, None
    if change == "n":
        xo, labo = x[:-5].contiguous(), lab[:-5].contiguous()
    elif change == "palette_size":
        other["palette_size"] = 24
    elif change == "batch_splits":
        other["batch_splits"] = 2
    elif change == "bucket_count":
        other["bucket_count"] = 32
    else:
        wo = torch.ones(x.shape[0])
    LQ.lq_quantize(x, None, lab, 3, **base)
    LQ.lq_quantize(xo, wo, labo, 3, **other)
    assert len(LQ._graphs) == 2
    # neither key has been seen twice: no capture
    assert LQ.LQ_GRAPH == {"eager": 2, "captured": 0, "replayed": 0}


def test_k0_is_data_not_key(stubbed):
    x, lab = _inputs()
    runs = [(k0, LQ.lq_quantize(x, None, lab, k0, P))
            for k0 in (3, 2, torch.tensor(1, dtype=torch.int32), 3)]
    assert len(LQ._graphs) == 1
    assert LQ.LQ_GRAPH == {"eager": 1, "captured": 1, "replayed": 3}
    for k0, got in runs:
        assert _same(got, LQ.lq_loop(x, None, lab, k0, P))
    assert not _same(runs[0][1], runs[1][1])   # k0 reached the replay


def test_weights_go_through_the_graph(stubbed):
    x, lab = _inputs()
    w1 = torch.linspace(0.5, 2.0, x.shape[0])
    w2 = torch.flip(w1, (0,))
    for w in (w1, w1, w2):
        assert _same(LQ.lq_quantize(x, w, lab, 3, P),
                     LQ.lq_loop(x, w, lab, 3, P))
    assert LQ.LQ_GRAPH == {"eager": 1, "captured": 1, "replayed": 2}


def test_least_recent_key_goes_first(stubbed):
    sizes = [200 + 10 * i for i in range(LQ.GRAPH_KEYS + 1)]
    data = {n: _inputs(n) for n in sizes}

    def call(n):
        LQ.lq_quantize(data[n][0], None, data[n][1], 3, P)

    for n in sizes[:-1]:           # first sight of each
        call(n)
    first = sizes[0]
    call(first)                    # captured, and the most recent
    call(sizes[-1])                # first sight: one key must go
    held = [key[1] for key in LQ._graphs]
    assert len(held) == LQ.GRAPH_KEYS
    # the captured key was used last but one: the oldest untouched went
    assert sizes[1] not in held and first in held and sizes[-1] in held
    assert isinstance(LQ._graphs[next(k for k in LQ._graphs
                                      if k[1] == first)], StubGraph)
    call(sizes[1])
    assert LQ.LQ_GRAPH["eager"] == LQ.GRAPH_KEYS + 2   # seen again: eager


def test_outputs_of_consecutive_calls_are_apart(stubbed):
    x, lab = _inputs()
    x2, lab2 = _inputs(seed=1)
    LQ.lq_quantize(x, None, lab, 3, P)
    a = LQ.lq_quantize(x, None, lab, 3, P)
    kept = (a[0].clone(), a[1].clone())
    b = LQ.lq_quantize(x2, None, lab2, 3, P)
    assert LQ.LQ_GRAPH["replayed"] == 2
    assert _same(a, kept)          # the next replay left them alone
    assert _same(b, LQ.lq_loop(x2, None, lab2, 3, P))
    graph = next(iter(LQ._graphs.values()))
    for out in (a, b):
        assert out[0].data_ptr() != graph.labels.data_ptr()
        assert out[1].data_ptr() != graph.count.data_ptr()
    assert a[0].data_ptr() != b[0].data_ptr()


def test_cpu_runs_eager(monkeypatch):
    LQ.clear_lq_graphs()
    LQ.reset_lq_graph()
    x, lab = _inputs()
    for _ in range(3):
        LQ.lq_quantize(x, None, lab, 3, P)
    assert LQ.LQ_GRAPH == {"eager": 3, "captured": 0, "replayed": 0}
    assert not LQ._graphs


def test_mesh_runs_eager(stubbed, monkeypatch):
    x, lab = _inputs()
    mesh = object()
    calls = []

    def loop(*args, **kw):
        calls.append(args[-1] if len(args) == 8 else kw.get("mesh"))
        return lab.clone(), torch.zeros((), dtype=torch.int32)

    monkeypatch.setattr(LQ, "lq_loop", loop)
    for _ in range(3):
        LQ.lq_quantize(x, None, lab, 3, P, mesh=mesh)
    assert calls == [mesh] * 3
    assert LQ.LQ_GRAPH == {"eager": 3, "captured": 0, "replayed": 0}
    assert not LQ._graphs and StubGraph.captures == 0


def test_keys_share_the_graph_buffers(stubbed):
    x, lab = _inputs()
    w = torch.linspace(0.5, 2.0, x.shape[0])
    for _ in range(2):
        LQ.lq_quantize(x, None, lab, 3, P)
    rows = LQ.GRAPH_MAX_ROWS
    assert LQ.graph_bytes() == 12 * rows + rows + 4   # colours, labels, k0
    for _ in range(2):
        LQ.lq_quantize(x, w, lab, 3, P)
    g1, g2 = LQ._graphs.values()
    for name in ("colors", "labels", "k0"):
        assert getattr(g1, name).data_ptr() == getattr(g2, name).data_ptr()
    assert LQ.graph_bytes() == 17 * rows + 4
    assert _same(LQ.lq_quantize(x, None, lab, 3, P),
                 LQ.lq_loop(x, None, lab, 3, P))
    assert _same(LQ.lq_quantize(x, w, lab, 3, P), LQ.lq_loop(x, w, lab, 3, P))
    LQ.clear_lq_graphs()
    assert LQ.graph_bytes() == 0 and not LQ._inputs


def test_held_bytes_within_the_model(stubbed):
    """Every kind of key at once (weighted, unweighted, byte and int32
    labels, each N up to the cap) holds at most GRAPH_HELD_BYTES, the term
    the pipeline's footprint model adds."""
    x, lab = _inputs(n=600)
    w = torch.linspace(0.5, 2.0, x.shape[0])
    for n, weights, p in ((600, None, P), (600, w, P), (400, None, 264),
                          (300, w[:300], 264)):
        for _ in range(2):
            LQ.lq_quantize(x[:n], weights, lab[:n], 3, p, batch_splits=8)
    assert LQ.LQ_GRAPH == {"eager": 4, "captured": 4, "replayed": 4}
    held = LQ.graph_bytes()
    assert held == 21 * LQ.GRAPH_MAX_ROWS + 4
    assert held <= LQ.GRAPH_HELD_BYTES
    from patolette_tpu_torch.models import pipeline

    assert pipeline.LQ_GRAPH_BYTES == LQ.GRAPH_HELD_BYTES


@pytest.mark.parametrize("past", ["rows", "dtype"])
def test_past_the_cap_runs_eager(stubbed, monkeypatch, past):
    """More rows than GRAPH_MAX_ROWS, or colours other than float32, never
    make a key: every call runs the eager loop and nothing is held."""
    x, lab = _inputs()
    if past == "rows":
        monkeypatch.setattr(LQ, "GRAPH_MAX_ROWS", x.shape[0] - 1)
    else:
        x = x.double()
    for _ in range(3):
        assert _same(LQ.lq_quantize(x, None, lab, 3, P),
                     LQ.lq_loop(x, None, lab, 3, P))
    assert LQ.LQ_GRAPH == {"eager": 3, "captured": 0, "replayed": 0}
    assert not LQ._graphs and LQ.graph_bytes() == 0


def test_inputs_go_with_the_last_graph(stubbed):
    """The shared inputs stay while any captured key does, and go when
    the last one is pushed out."""
    sizes = [200 + 10 * i for i in range(LQ.GRAPH_KEYS + 1)]
    data = {n: _inputs(n) for n in sizes}

    def call(n):
        LQ.lq_quantize(data[n][0], None, data[n][1], 3, P)

    call(sizes[0])
    call(sizes[0])                 # captured
    assert LQ.graph_bytes() > 0
    for n in sizes[1:-1]:          # first sight: the captured key stays
        call(n)
    assert LQ.graph_bytes() > 0
    call(sizes[-1])                # pushes the captured key out
    assert sizes[0] not in [key[1] for key in LQ._graphs]
    assert LQ.graph_bytes() == 0 and not LQ._inputs
    call(sizes[-1])                # captured anew: the inputs come back
    assert LQ.graph_bytes() > 0


def test_device_budget_leaves_room_for_the_graphs(monkeypatch):
    """On the card the device budget keeps the graphs' held bytes out of
    what a route may take; on the CPU there are no graphs."""
    import types

    from patolette_tpu_torch.models import pipeline

    total = 80 * 10**9
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(
                            total_memory=total))
    assert pipeline._device_budget(torch.device("cuda")) == int(
        total * pipeline.DEVICE_BUDGET_FRACTION) - pipeline.LQ_GRAPH_BYTES
    assert pipeline._device_budget(torch.device("cpu")) == 1 << 62


def test_threads_do_not_interleave_on_one_graph(stubbed):
    """More threads than cores share one key's graph, its buffers loaded
    and replayed under the lock: each call's result is its own input's."""
    import sys
    import threading

    inputs = [_inputs(seed=s) for s in range(12)]
    want = [LQ.lq_loop(x, None, lab, 3, P) for x, lab in inputs]
    for _ in range(2):                      # eager, then captured
        LQ.lq_quantize(inputs[0][0], None, inputs[0][1], 3, P)
    bad = []

    def worker(i):
        x, lab = inputs[i]
        for _ in range(3):
            if not _same(LQ.lq_quantize(x, None, lab, 3, P), want[i]):
                bad.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(inputs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not bad
    assert LQ.LQ_GRAPH["replayed"] == 1 + 3 * len(inputs)

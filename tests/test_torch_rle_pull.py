"""The single-device table pull (``pull_lut``) and K6's v1 and u16 v2
formats: the port's plain versions against the JAX package, on the tables
of ``tests/test_lut.py``'s pull tests (``:55-84``, ``:255-350``).

Tolerances: the encodings are integer work, so every comparison is exact.
For each table the port's encoders equal the JAX encoders in the header
and in the words the header says are to be read: v2 and u16 v2 the first
``count`` words unless overflow is set; v1 the first ``min(count,
MAX_RUNS)`` words (it writes those even past its cap). Past them the JAX
buffers hold sort sentinels. The port's ``pull_lut`` returns the table bit
for bit, equals the JAX ``pull_lut``, and runs the same encoders in the
same order (v2, then v1 on v2's overflow, then the raw table past v1's
cap; u16 v2, then the raw table), shown by spies on both packages'
encoders. The host decoders equal ``np.repeat`` of the runs.

The sampled route at p = 300 (a u16 table) equals the port's own
resident route (K3's direct map) exactly, and is held against the JAX
package's ``_quantize_via_samples`` by a CIELuv MSE ratio <= 1.01, as T1
and T5 are. The ratio reads 0.9995 there; the port's own palettes with
fewer entries read 1.0043 (297 entries), 1.0199 (291) and 1.0794 (270)
against the same JAX call, so the bound catches a palette ~2% short.
README T3's tolerances (palette atol 1e-3, map agreement >= 99.9%) do not
hold on this image: 71 of 300 entries differ by more than 1e-3, and the
maps agree on 85.8%. The cause is measured, not the table and not the
LQ port: the two packages' ICtCp values of the same uint8 pixels differ
by up to 1.0e-5 (the PQ curve's last-bit ``powf`` differences, within
K10's stated 5e-5), which moves pixels across bucket edges and flips
near-tied cuts; fed the JAX package's own LQ inputs, the port's LQ takes
the JAX splits exactly (``test_lq_on_jax_inputs_takes_jax_splits``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import patolette_tpu as jpt
import patolette_tpu_torch as tpt
from patolette_tpu.models import pipeline as JP
from patolette_tpu.ops import colorspace as JCS
from patolette_tpu.ops import lut as JL
from patolette_tpu_torch.kernels import rle as TR
from patolette_tpu_torch.models import pipeline as TP
from patolette_tpu_torch.ops import lut as TL
from test_torch_cores import share_cores  # noqa: F401

N = 1 << 24
MAX_RUNS = TR.MAX_RUNS
# label -> (JAX encoder, port encoder, header words)
FORMATS = {"v2": ("_rle_encode_u8_v2", "rle_encode_u8_v2", 3),
           "v1": ("_rle_encode_u8", "rle_encode_u8", 1),
           "u16": ("_rle_encode_u16_v2", "rle_encode_u16_v2", 2)}


def _random_runs(runs, seed, hi, dtype):
    """A (2^24,) table of ``runs`` runs at seeded random places, adjacent
    values distinct (the JAX tests' construction)."""
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.choice(N - 1, size=runs - 1, replace=False) + 1)
    vals = rng.integers(0, hi, size=runs).astype(dtype)
    same = np.flatnonzero(vals[1:] == vals[:-1])
    vals[same + 1] = ((vals[same + 1].astype(np.int64) + 1) % hi).astype(
        dtype)
    return np.repeat(vals, np.diff(np.concatenate([[0], pos, [N]])))


def _u8_typical():
    host = _random_runs(300_000, 23, 256, np.uint8)
    # a one-entry run of 255 at the last position: its v1 word equals the
    # JAX sort's sentinel 0xFFFFFFFF bit for bit, and is a run
    host[-1] = 255 if host[-2] != 255 else 254
    return host


def _u8_tiny():
    host = np.zeros(N, np.uint8)
    host[12345:] = 7
    host[N - 3:] = 250
    return host


def _u8_block_overflow():
    # one 128-block alternates: 64 starts > 32, so v2 overflows
    host = np.zeros(N, np.uint8)
    host[4096:4096 + 128] = (np.arange(128) % 2).astype(np.uint8) + 3
    return host


def _u8_alternating():
    return (np.arange(N) % 2).astype(np.uint8)  # 2^24 runs > MAX_RUNS


def _u16_block_overflow():
    host = np.zeros(N, np.uint16)
    host[2048:2048 + 128] = (np.arange(128) % 2 + 7).astype(np.uint16)
    return host


# table, the JAX branch: the encoders pull_lut runs, in order
U8_TABLES = {
    "typical_300k": (_u8_typical, ["v2"]),
    "runs_1m": (lambda: _random_runs(1_000_000, 13, 256, np.uint8), ["v2"]),
    "tiny": (_u8_tiny, ["v2"]),
    "block_overflow": (_u8_block_overflow, ["v2", "v1"]),
    "alternating": (_u8_alternating, ["v2", "v1"]),
}
U16_TABLES = {
    "runs_400k": (lambda: _random_runs(400_000, 31, 4096, np.uint16),
                  ["u16"]),
    "stripes_1024": (lambda: ((np.arange(N) // 600) % 1024).astype(
        np.uint16), ["u16"]),
    "block_overflow": (_u16_block_overflow, ["u16"]),
}


def _spy(monkeypatch, module, idx, calls):
    """Record (label, output) of every encoder call in ``module``."""
    for label, names in FORMATS.items():
        fn = getattr(module, names[idx])

        def spy(table, _fn=fn, _label=label):
            out = _fn(table)
            calls.append((_label, out))
            return out

        monkeypatch.setattr(module, names[idx], spy)


def _read_count(enc, label):
    """(count, words to compare) of a JAX buffer."""
    if label == "v2":
        count, over = int(enc[0]) | (int(enc[1]) << 16), bool(enc[2])
    elif label == "v1":
        count = int(enc[0])
        return count, min(count, MAX_RUNS)
    else:
        count, over = int(enc[0]), bool(enc[1])
    return count, 0 if over else count


def _assert_same_encoding(port_enc, jax_enc, label):
    got = port_enc.numpy()
    want = np.asarray(jax_enc)
    hdr = FORMATS[label][2]
    # the JAX word types; under the suite's x64 JAX widens v1's buffer to
    # u64, with the same values
    assert got.dtype == (np.uint16 if label == "v2" else np.uint32)
    # v2's buffer is one word longer: whole int32 slots (kernels/rle.py)
    assert got.shape[0] == want.shape[0] + (label == "v2")
    np.testing.assert_array_equal(got[:hdr], want[:hdr])
    count, n = _read_count(want, label)
    np.testing.assert_array_equal(got[hdr:hdr + n], want[hdr:hdr + n])
    return count


def _pull_both(host, monkeypatch):
    """Both packages' pull_lut of ``host``, with the encoders each ran."""
    jcalls, tcalls = [], []
    _spy(monkeypatch, JL, 0, jcalls)
    _spy(monkeypatch, TL, 1, tcalls)
    jout = JL.pull_lut(jnp.asarray(host))
    tout = TL.pull_lut(torch.from_numpy(host))
    return jout, tout, jcalls, tcalls


@pytest.mark.parametrize("name", list(U8_TABLES))
def test_u8_pull_against_jax(name, monkeypatch):
    make, branch = U8_TABLES[name]
    host = make()
    jout, tout, jcalls, tcalls = _pull_both(host, monkeypatch)
    assert [c[0] for c in jcalls] == branch
    assert [c[0] for c in tcalls] == branch
    np.testing.assert_array_equal(tout, host)
    np.testing.assert_array_equal(tout, jout)
    for (label, jenc), (_, tenc) in zip(jcalls, tcalls):
        _assert_same_encoding(tenc, jenc, label)
    if "v1" not in branch:  # v1 on every u8 table
        _assert_same_encoding(TR.rle_encode_u8_plain(torch.from_numpy(host)),
                              JL._rle_encode_u8(jnp.asarray(host)), "v1")


@pytest.mark.parametrize("name", list(U16_TABLES))
def test_u16_pull_against_jax(name, monkeypatch):
    make, branch = U16_TABLES[name]
    host = make()
    jout, tout, jcalls, tcalls = _pull_both(host, monkeypatch)
    assert [c[0] for c in jcalls] == [c[0] for c in tcalls] == branch
    assert tout.dtype == np.uint16
    np.testing.assert_array_equal(tout, host)
    np.testing.assert_array_equal(tout, jout)
    _assert_same_encoding(tcalls[0][1], jcalls[0][1], "u16")


def test_branches_read_the_header():
    """Each fallback is taken on the header: v2's overflow flag on the
    block table, v1's count past MAX_RUNS on the alternating one, u16
    v2's overflow flag on its block table."""
    block = torch.from_numpy(_u8_block_overflow())
    assert TR.header(TR.rle_encode_u8_v2(block))[1]
    assert TL.pull_encoded_v2(TR.rle_encode_u8_v2(block)) is None
    assert TR.header_v1(TR.rle_encode_u8(block)) == 1 + 128 + 1
    alt = TR.rle_encode_u8(torch.from_numpy(_u8_alternating()))
    assert TR.header_v1(alt) == N > MAX_RUNS
    assert TL.pull_encoded(alt) is None
    enc16 = TR.rle_encode_u16_v2(torch.from_numpy(_u16_block_overflow()))
    assert TR.header_u16_v2(enc16)[1]
    assert TL.pull_words_u16_v2(enc16) is None


def test_pull_lut_rejects_other_types():
    with pytest.raises(TypeError, match="u8 or u16"):
        TL.pull_lut(torch.zeros(256, dtype=torch.int32))


def _v1_repeat(words, size):
    pos = (words >> 8).astype(np.int64)
    return np.repeat((words & 0xFF).astype(np.uint8),
                     np.diff(np.append(pos, size)))


def _u16_repeat(words, size):
    pos = np.cumsum((words >> 16).astype(np.int64))
    return np.repeat((words & 0xFFFF).astype(np.uint16),
                     np.diff(np.append(pos, size)))


def test_v1_decode_equals_repeat():
    host = _u8_typical()
    enc = TR.rle_encode_u8_plain(torch.from_numpy(host)).numpy()
    words = enc[1:1 + enc[0]]
    assert words[-1] == 0xFFFFFFFF  # the sentinel-equal run, decoded
    out = TL.rle_decode_u8(words, np.empty(N, np.uint8))
    np.testing.assert_array_equal(out, _v1_repeat(words, N))
    np.testing.assert_array_equal(out, host)


def test_u16_decode_equals_repeat():
    host = _random_runs(400_000, 31, 4096, np.uint16)
    enc = TR.rle_encode_u16_v2_plain(torch.from_numpy(host)).numpy()
    words = enc[2:2 + enc[0]]
    out = TL.rle_decode_u16_v2(words, np.empty(N, np.uint16))
    np.testing.assert_array_equal(out, _u16_repeat(words, N))
    np.testing.assert_array_equal(out, host)


@pytest.mark.parametrize("fmt,words", [
    ("v1", [0, (5 << 8) | 1, (5 << 8) | 2]),   # a position repeated
    ("v1", [1 << 8]),                           # the first run not at 0
    ("v1", [0, (100 << 8) | 3]),                # a run past the table
    ("u16", [0, 2 << 16, 0]),                   # a zero delta
    ("u16", [1 << 16]),                         # the first delta not 0
    ("u16", [0, (100 << 16) | 3]),              # a run past the table
])
def test_decoders_reject_bad_words(fmt, words):
    words = np.array(words, np.uint32)
    with pytest.raises(RuntimeError):
        if fmt == "v1":
            TL.rle_decode_u8(words, np.empty((100,), np.uint8))
        else:
            TL.rle_decode_u16_v2(words, np.empty((100,), np.uint16))


def _mse_luv(colors_u8, palette, pmap):
    x = colors_u8.astype(np.float64) / 255.0
    a = np.asarray(JCS.srgb_to_cieluv(x))
    b = np.asarray(JCS.srgb_to_cieluv(palette))[pmap]
    return float(((a - b) ** 2).sum(-1).mean())


X300 = np.random.default_rng(11).integers(0, 256, (128 * 128, 3),
                                         dtype=np.uint8)
KW300 = dict(dither=False, tile_size=0, kmeans_niter=4,
             color_space=tpt.ColorSpace_ICtCp)


@pytest.fixture(scope="module")
def jax_p300():
    """The JAX package's sampled call on X300 at p = 300 (its threshold
    patched so that a 128x128 image takes the route; nothing is drawn, n
    is under every cap), run once for the module: its result, laps, the
    encoders it ran, and its LQ stage's inputs and labels."""
    encoders, seen = [], {}
    stage = JP._lq_stage

    def lq_spy(*args, **kw):
        out = stage(*args, **kw)
        seen["args"], seen["kw"], seen["labels"] = args, kw, out[0]
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JP, "_lut_min_pixels", lambda p: 0)
        mp.setattr(JP, "_lq_stage", lq_spy)
        _spy(mp, JL, 0, encoders)
        ok, pal, pmap, msg = jpt.quantize(128, 128, X300, 300, **KW300)
        laps = set(JP.LAST_STAGE_TIMES)
    assert ok, msg
    return dict(pal=pal, map=pmap, laps=laps,
                encoders=[c[0] for c in encoders], lq=seen)


def test_sampled_u16_table_against_jax(monkeypatch, jax_p300):
    """p = 300 takes a u16 table. Both packages' sampled routes pull it
    through u16 v2. The port's call equals its own resident route (K3's
    direct map, no table) exactly, so the pulled table is the table;
    against the JAX call the CIELuv MSE ratio is <= 1.01 (docstring of
    the module)."""
    x, kw = X300, KW300
    ok, rpal, rmap, msg = tpt.quantize(128, 128, x, 300, device="cpu", **kw)
    assert ok, msg
    assert "nn-map" in TP.LAST_STAGE_TIMES
    monkeypatch.setattr(TP, "_lut_min_pixels", lambda p: 0)
    tcalls = []
    _spy(monkeypatch, TL, 1, tcalls)
    ok, pal, pmap, msg = tpt.quantize(128, 128, x, 300, device="cpu", **kw)
    assert ok, msg
    assert "lut-build+pull" in TP.LAST_STAGE_TIMES
    np.testing.assert_array_equal(pal, rpal)
    np.testing.assert_array_equal(pmap, rmap)
    assert "lut-build+pull" in jax_p300["laps"]
    assert jax_p300["encoders"] == [c[0] for c in tcalls] == ["u16"]
    jpal, jmap = jax_p300["pal"], jax_p300["map"]
    assert pmap.dtype == np.int32 and pmap.shape == jmap.shape
    assert _mse_luv(x, pal, pmap) / _mse_luv(x, jpal, jmap) <= 1.01


def test_lq_on_jax_inputs_takes_jax_splits(jax_p300):
    """The palette search of the JAX p = 300 call: the port's LQ stage,
    given the JAX package's own LQ inputs (working colours, GQ buckets and
    cuts), labels every pixel as the JAX LQ does. So the drift of the
    p = 300 call comes from its inputs, whose ICtCp values differ from
    the port's by up to ~1e-5 (module docstring)."""
    seen = jax_p300["lq"]
    colors, weights, buckets, cuts, k0, p = seen["args"]
    assert weights is None and p == 300
    cuts = np.array(cuts)
    labels, count, _, _ = TP._lq_stage(
        torch.from_numpy(np.array(colors)), None,
        torch.from_numpy(np.asarray(buckets).astype(np.int32)),
        cuts[:int(k0) + 1], int(k0), p, seen["kw"]["batch_splits"])
    assert count == p
    np.testing.assert_array_equal(labels.numpy(), np.asarray(seen["labels"]))

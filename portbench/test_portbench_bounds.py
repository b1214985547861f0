"""The frozen bound arithmetic against counts worked out by hand at the
cells' shapes (bytes at 3.35 TB/s, f32 operations at 67 TFLOP/s, f64 at
33.5, unfusable f32 operations at 33.5 T/s, chains at 1980 MHz)."""

import pytest

from portbench import bounds

MB = 3.35e12 / 1e3          # bytes a ms
N4K, N2K, N100 = 3840 * 2160, 2048 * 2048, 10000 * 10000
M = 1 << 18                 # the LQ and KMeans samples


def test_table_and_encoding():
    # the 2^24 codes' grid (12 B) read, the u8 table written, 256 entries
    assert bounds.k5_ms(256) == pytest.approx(
        ((1 << 24) * 13 + 256 * 16) / MB)
    assert bounds.k5_ms(256) == pytest.approx(0.065107, rel=1e-4)
    assert bounds.k6_v2_ms() == pytest.approx(((1 << 24) + 6) / MB)


def test_dither_chain_and_saliency_at_4k():
    assert bounds.k8_chain_cycles(256, 8) == 219
    assert bounds.k8_ms(N4K, 256, 256, 4096) == pytest.approx(
        4096 * 219 / 1.98e9 * 1e3)          # the chain binds: 0.453 ms
    assert bounds.k9_ms(N4K) == pytest.approx(72 * N4K / MB)
    assert bounds.k7_ms(N4K) == pytest.approx(4 * N4K / MB)


def test_gq_dp():
    assert bounds.k11_chain_cycles(12) == 900
    assert bounds.k11_ms() == pytest.approx(900 / 1.98e9 * 1e3)


def test_colour_transform_at_4k_and_samples():
    # sRGB f32 -> ICtCp: 12 B in, 12 out; (36 f32, 69 f64) operations
    assert bounds.K10_OPS["srgb_to_ictcp"] == (36, 69)
    assert bounds.k10_ms(N4K, "srgb_to_ictcp", 12) == pytest.approx(
        24 * N4K / MB)
    assert bounds.k10_ms(M, "srgb_to_ictcp", 3) == pytest.approx(
        15 * M / MB)


def test_kmeans_step_at_the_sample_cap():
    ops = M * 256 * 7 + M * 4
    assert bounds.k4_ms(M, 256, 256) == pytest.approx(ops / 67e12 * 1e3)


def test_call_least_time_by_route():
    export = {"palette_size": 256, "dither": False, "tile_size": 0.0,
              "kmeans_niter": 25}
    core = bounds.palette_core_ms(M, 256, 256, 25)
    assert core == pytest.approx(
        bounds.k1_ms(M, 512, M) + bounds.k11_ms()
        + 37 * (8 * M / MB + bounds.k1_ms(M, 16, 0))
        + 25 * bounds.k4_ms(M, 256, 256))
    want = (bounds.k10_ms(M, "srgb_to_ictcp", 3) + core
            + bounds.k5_ms(256) + bounds.k6_v2_ms())
    for n in (N100, N4K):
        assert bounds.call_least_ms(export, n, 256, "uint8") == \
            pytest.approx(want)
    default = {"palette_size": 256, "dither": True, "tile_size": 512.0,
               "kmeans_niter": 32}
    want = (bounds.k10_ms(N2K, "srgb_to_ictcp", 12) + bounds.k9_ms(N2K)
            + bounds.palette_core_ms(M, 256, 256, 32)
            + bounds.k10_ms(N2K, "ictcp_to_rec2020", 12)
            + bounds.k7_ms(N2K) + bounds.k8_ms(N2K, 256, 256, 4096))
    assert bounds.call_least_ms(default, N2K, 256, "float32") == \
        pytest.approx(want)


@pytest.mark.parametrize("config, n, valid, want", [
    ("default-call", N4K, 256, 1.0238927972790592),
    ("export-u8", N4K, 256, 0.2859333484396201),
    ("default-call", N2K, 256, 0.8721280498163727),
    ("default-call", N4K, 241, 1.01074647130891),
    ("export-u8", N4K, 241, 0.2756627812754409),
    ("default-call", N2K, 241, 0.8589817238462234),
])
def test_the_older_cells_least_time_is_pinned(config, n, valid, want):
    """default-4k, export-4k and default-2k read the least times they read
    before the streamed route had terms of its own."""
    from portbench.harness import manifest

    cfg = manifest.load_json(manifest.HERE / "configs" / f"{config}.json")
    assert bounds.call_least_ms(cfg["call"], n, valid,
                                cfg["input_dtype"]) == want


def test_streamed_dither_least_time():
    """The dithered call without saliency above 2^22 pixels: K10 on the
    draws, the palette core, then one K10 pass (sRGB -> ICtCp -> linear
    Rec2020), K7 and K8 over every pixel; no full-image ICtCp pass."""
    streamed = {"palette_size": 256, "dither": True, "tile_size": 0.0,
                "kmeans_niter": 32}
    assert bounds.K10_OPS["srgb_to_ictcp_to_rec2020"] == (54, 105)
    strip = bounds.k10_ms(N100, "srgb_to_ictcp_to_rec2020", 12)
    assert strip == pytest.approx(24 * N100 / MB)       # the bytes bind
    want = (bounds.k10_ms(M, "srgb_to_ictcp", 12)
            + bounds.palette_core_ms(M, 256, 256, 32) + strip
            + bounds.k7_ms(N100) + bounds.k8_ms(N100, 256, 256, 4096))
    assert bounds.call_least_ms(streamed, N100, 256, "float32") == \
        pytest.approx(want)
    # the uint8 strip goes to linear Rec2020 directly
    u8 = (bounds.k10_ms(M, "srgb_to_ictcp", 3)
          + bounds.palette_core_ms(M, 256, 256, 32)
          + bounds.k10_ms(N100, "srgb_to_rec2020", 3)
          + bounds.k7_ms(N100) + bounds.k8_ms(N100, 256, 256, 4096))
    assert bounds.call_least_ms(streamed, N100, 256, "uint8") == \
        pytest.approx(u8)
    # at most 2^22 pixels the call is one-shot: the whole image converted
    n = 1 << 22
    one_shot = (bounds.k10_ms(n, "srgb_to_ictcp", 12)
                + bounds.palette_core_ms(M, 256, 256, 32)
                + bounds.k10_ms(n, "ictcp_to_rec2020", 12)
                + bounds.k7_ms(n) + bounds.k8_ms(n, 256, 256, 4096))
    assert bounds.call_least_ms(streamed, n, 256, "float32") == \
        pytest.approx(one_shot)

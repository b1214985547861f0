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

import numpy as np

from portbench.harness import images, manifest


def _traffic(**kw):
    t = manifest.load_json(manifest.HERE / "traffic" / "stream-4k.json")
    t.update(dict(width=120, height=70, images=3), **kw)
    return t


def test_same_seed_same_bits():
    for dtype in ("uint8", "float32"):
        a = images.make_images(_traffic(), dtype, 2**31 + 77, "cpu")
        b = images.make_images(_traffic(), dtype, 2**31 + 77, "cpu")
        assert len(a) == 3
        for x, y in zip(a, b):
            assert x.dtype == np.dtype(dtype) and x.shape == (120 * 70, 3)
            assert np.array_equal(x, y)


def test_seeds_and_images_differ():
    a = images.make_images(_traffic(), "uint8", 5, "cpu")
    b = images.make_images(_traffic(), "uint8", 6, "cpu")
    assert not np.array_equal(a[0], a[1])
    assert not np.array_equal(a[0], b[0])


def test_range_and_not_few_colours():
    (img,) = images.make_images(_traffic(images=1), "float32", 1, "cpu")
    assert img.min() >= 0.0 and img.max() <= 1.0
    (u8,) = images.make_images(_traffic(images=1), "uint8", 1, "cpu")
    codes = u8.astype(np.int64) @ np.array([65536, 256, 1])
    assert len(np.unique(codes)) > 1000

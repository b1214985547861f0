"""pytest settings of the benchmark's own tests (``python -m pytest
portbench -q``): the ``card`` marker for tests that need a CUDA card, which
skip elsewhere; whether there is one is decided in a fixture, never at
import."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the H100 only")
    return "cuda"


@pytest.fixture
def small_cell():
    """A cell's data at a size the CPU runs in seconds."""
    from portbench.harness import manifest

    def make(workload, width=64, height=48, images=2):
        cell = manifest.cell(manifest.load_benchmark(), workload)
        cell["traffic"].update(width=width, height=height, images=images,
                               trace_calls=2)
        return cell

    return make


@pytest.fixture
def small_strips(monkeypatch):
    """Strips of ``rows`` rows for a small streamed cell: the program's
    strip size and the size above which a dither streams are patched so
    that a small image streams, and the configuration's ``strip_rows``
    follows them."""
    from patolette_tpu_torch.models import pipeline

    def make(cell, rows):
        width = int(cell["traffic"]["width"])
        monkeypatch.setattr(pipeline, "STREAM_STRIP_MIN", width * rows)
        monkeypatch.setattr(pipeline, "STREAM_STRIP_MAX", width * rows)
        monkeypatch.setattr(pipeline, "STRIP_DITHER_MIN_PIXELS", 0)
        cell["config"]["strip_rows"] = rows
        return cell

    return make

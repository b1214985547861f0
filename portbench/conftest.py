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

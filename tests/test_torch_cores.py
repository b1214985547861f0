"""Torch's CPU threads for the port's tests when several pytest-xdist
workers share the machine.

Each worker's torch takes every core by default, so with six workers on
eight cores the port's torch ops run on six times as many threads as
cores, and their threads wait on one another: six of the port's heaviest
test files took 413-612 s each run at once that way, and 45-140 s with two
threads a process (the same tests, the same results). ``share_cores``, an
autouse fixture of module scope that every ``tests/test_torch_*.py`` file
imports, gives a module's tests ``cores // workers`` threads (at least
one) while a pytest-xdist worker runs them, and puts the count back
after. Outside pytest-xdist nothing changes.
"""

import os

import pytest
import torch


def threads_a_worker(workers: int, cores: int) -> int:
    """Torch threads for each of ``workers`` processes on ``cores``."""
    return max(1, cores // max(1, workers))


@pytest.fixture(autouse=True, scope="module")
def share_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(
        min(before, threads_a_worker(workers, os.cpu_count() or 1)))
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("workers,cores,want", [
    (1, 8, 8), (6, 8, 1), (4, 8, 2), (16, 8, 1), (0, 8, 8), (3, 32, 10),
])
def test_threads_a_worker(workers, cores, want):
    assert threads_a_worker(workers, cores) == want


def test_share_cores_applies_to_this_module():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    assert torch.get_num_threads() <= max(
        1, threads_a_worker(workers, os.cpu_count() or 1))

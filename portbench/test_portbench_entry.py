"""The command as the driver runs it: no result without a card, none in a
directory that holds only the benchmark, and (on the card) one run of a
cell that comes out correct with the contract's keys."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench.harness import manifest

ARGS = ["--workload", "export-4k", "--seed", str(2**31 + 9), "--seconds",
        "1", "--trace", "0"]


def _run(cwd, args=ARGS, timeout=600):
    return subprocess.run([sys.executable, "portbench/run.py", *args],
                          capture_output=True, text=True, cwd=cwd,
                          timeout=timeout)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(manifest.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(manifest.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
def test_a_short_run_on_the_card(card):
    out = _run(manifest.ROOT, ["--workload", "default-2k", "--seed",
                               str(2**31 + 9), "--seconds", "2", "--trace",
                               "1"])
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    want = {m["name"] for m in manifest.load_benchmark()["per_layer"]}
    assert set(res["metrics"]) == want


def test_an_unmapped_lap_is_reported(small_cell):
    """A lap that ``laps.json`` puts in no layer (a lap the program renamed)
    is named on standard error, not dropped unseen."""
    from patolette_tpu_torch.models import pipeline
    from portbench import run

    cell = small_cell("export-4k", width=48, height=32, images=2)

    def renamed(*a, **kw):
        out = pipeline.quantize(*a, **kw)
        pipeline.LAST_STAGE_TIMES["lq-renamed"] = 1.0
        return out

    lines = []
    run.run_cell(cell, 2**31 + 5, 0.01, False, "cpu", 0.0,
                 log=lines.append, quantize=renamed)
    said = [m for m in lines if "in no layer" in m]
    assert len(said) == 1 and "'lq-renamed'" in said[0], lines

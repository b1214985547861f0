"""BENCHMARK.json against the contract's shape, and every part of every
cell found by name."""

import json
import re

from portbench import bounds
from portbench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return manifest.load_benchmark()


def test_top_level_keys_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert b["command"] == ["python3", "portbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024
    cells = len(b["workloads"])
    assert 2 + 14 * 24 * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, cells // 4)


def test_names_units_and_metrics():
    b = bench()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in b[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (manifest.HERE / "metrics" / f"{m['name']}.py").exists()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert set(e2e) == {"setup_s", "mp_per_s", "peak_device_mb", "mse_luv"}
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    for m in b["per_layer"]:
        assert m["moves"] == "mp_per_s"


def test_every_cell_loads_by_name():
    b = bench()
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and w["chips"] in (1, 4)
        cell = manifest.cell(b, w["name"])
        cfg = cell["config"]
        assert cfg["name"] == w["config"]
        assert cfg["input_dtype"] in ("uint8", "float32")
        assert {"palette_size", "color_space", "dither", "tile_size",
                "kmeans_niter"} <= set(cfg["call"])
        assert set(cell["limits"]) >= {"bad_outputs"}
        assert cell["traffic"]["width"] * cell["traffic"]["height"] > 0
        assert bounds.call_least_ms(cfg["call"], cell["traffic"]["width"]
                                    * cell["traffic"]["height"], 256,
                                    cfg["input_dtype"]) > 0


def test_configs_are_under_paths_and_used():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    for c in b["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        assert manifest.load_json(manifest.ROOT / c["file"])["reduced"] == \
            c["reduced"]


def test_lap_metrics_name_their_layers():
    layers = set(manifest.load_json(manifest.HERE / "laps.json")["layers"])
    for m in bench()["per_layer"]:
        src = (manifest.HERE / "metrics" / f"{m['name']}.py").read_text()
        if "layer_mean_ms" in src:
            assert f'"{m["layer"]}"' in src and m["layer"] in layers

"""Find a cell's parts by name: ``BENCHMARK.json`` at the checkout's root,
the configuration file it names, ``traffic/<traffic>.json``,
``checks/<config>.json``, ``metrics/<metric>.py`` and
``reference/checks/<number>.py``."""

from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent.parent
ROOT = HERE.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_benchmark(root=ROOT):
    return load_json(pathlib.Path(root) / "BENCHMARK.json")


def _applies(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


def cell(bench, workload, root=ROOT):
    """Everything one cell is made of, as plain data."""
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    root = pathlib.Path(root)
    return {
        "workload": w,
        "config": load_json(root / cfg["file"]),
        "traffic": load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        "limits": load_json(HERE / "checks" / f"{w['config']}.json"),
        "end_to_end": [m for m in bench["end_to_end"]
                       if _applies(m, workload)],
        "per_layer": [m for m in bench["per_layer"]
                      if _applies(m, workload)],
    }


def _module(path, prefix, name):
    spec = importlib.util.spec_from_file_location(
        f"{prefix}{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    return _module(HERE / "metrics" / f"{name}.py", "portbench_metric_",
                   name).read


def check(name):
    """The module ``reference/checks/<name>.py`` of a number compared that
    ``run.judge`` does not know: its ``check(pixels, palette, pmap, width,
    height, device, config)`` gives ``(value, left out)``, and its
    ``control(pixels, palette, width, height, device, config)``, where it
    has one, the control's map. KeyError where there is no such file."""
    path = HERE / "reference" / "checks" / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no reference number {name!r}")
    return _module(path, "portbench_check_", name)


def lap_layers():
    """Lap name -> layer, from ``laps.json``."""
    layers = load_json(HERE / "laps.json")["layers"]
    return {lap: layer for layer, laps in layers.items() for lap in laps}

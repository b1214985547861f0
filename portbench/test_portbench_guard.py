"""No module of the JAX side in a run: the guard's whole-name rule, and
the modules a run loads (a subprocess drives ``run.run_cell`` on the CPU
at a small size and lists them)."""

import json
import subprocess
import sys

from portbench.harness import guard, manifest


def test_whole_top_level_names():
    mods = ["patolette_tpu_torch", "patolette_tpu_torch.models.pipeline",
            "jaxtyping", "numpy", "portbench.run", "patolette_tpu",
            "patolette_tpu.ops.lut", "jax", "jax.numpy", "jaxlib.xla_client",
            "flax.linen"]
    assert guard.forbidden_loaded(mods) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "patolette_tpu", "patolette_tpu.ops.lut"]


SCRIPT = r"""
import json, sys
sys.path.insert(0, ROOT)
from portbench import run
from portbench.harness import guard, manifest
cell = manifest.cell(manifest.load_benchmark(), WORKLOAD)
cell["traffic"].update(width=128, height=96, images=1, trace_calls=1)
res = run.run_cell(cell, 7, 0.01, True, "cpu", 0.0)
print(json.dumps({"forbidden": guard.forbidden_loaded(),
                  "port": "patolette_tpu_torch" in sys.modules,
                  "correct": res["correct"]}))
"""


def test_a_run_loads_nothing_of_the_jax_side():
    for workload in ("export-4k", "default-2k"):
        src = SCRIPT.replace("ROOT", repr(str(manifest.ROOT))).replace(
            "WORKLOAD", repr(workload))
        out = subprocess.run([sys.executable, "-c", src], capture_output=True,
                             text=True, timeout=600, cwd=manifest.ROOT)
        assert out.returncode == 0, out.stderr[-2000:]
        got = json.loads(out.stdout.strip().splitlines()[-1])
        assert got == {"forbidden": [], "port": True, "correct": True}


def test_the_reference_imports_nothing_of_the_program():
    for path in (manifest.HERE / "reference").glob("*.py"):
        src = path.read_text()
        for name in ("patolette_tpu", "jax", "flax"):
            assert f"import {name}" not in src, path
            assert f"from {name}" not in src, path

"""portbench: the benchmark of the PyTorch/CUDA port (``patolette_tpu_torch``).

One command runs one cell once::

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name: its configuration in
``configs/``, its traffic mix in ``traffic/``, each metric's reader in
``metrics/``, the limits of its correctness numbers in ``checks/``, the
lap-to-layer map in ``laps.json`` and the frozen bound arithmetic in
``bounds.py``. The plain reference (``reference/``) imports nothing of the
program.
"""

"""The import guard: no module of the JAX side may be loaded in a run.

Names are compared by their top-level part (before the first dot), whole:
``patolette_tpu_torch`` is the port and passes, ``patolette_tpu`` and
``patolette_tpu.ops`` do not.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "patolette_tpu")


def forbidden_loaded(modules=None):
    """Sorted names in ``modules`` (default ``sys.modules``) whose
    top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)

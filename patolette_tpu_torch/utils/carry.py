"""State carried across from the JAX package.

patolette has no weights: what a stage consumes is the options and the
previous stage's output. These helpers turn the JAX package's values
(taken out of it as plain dicts and numpy arrays, so this module imports
nothing of it) into the port's, so one stage of the port can be fed the
JAX package's output of the stage before it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from patolette_tpu_torch.utils.config import ColorSpace, QuantizeOptions

# Stage outputs and the dtype each takes in the port.
_STATE_DTYPES = {
    "buckets": torch.int32,
    "cuts": torch.int64,
    "labels": torch.int32,
    "count": None,          # a Python int
    "centers": torch.float32,
    "valid": torch.bool,
}


def options_from_fields(fields: dict) -> QuantizeOptions:
    """A dict of ``QuantizeOptions`` fields (``dataclasses.asdict`` of the
    JAX package's object) -> the port's ``QuantizeOptions``. Unknown
    fields raise, so a field added on one side only is caught."""
    known = {f.name for f in dataclasses.fields(QuantizeOptions)}
    extra = set(fields) - known
    if extra:
        raise ValueError(f"unknown QuantizeOptions fields: {sorted(extra)}")
    kw = dict(fields)
    if "color_space" in kw:
        kw["color_space"] = ColorSpace(int(kw["color_space"]))
    return QuantizeOptions(**kw)


def state_from_numpy(device="cpu", **arrays) -> dict:
    """Stage outputs as numpy arrays (``buckets``, ``cuts``, ``labels``,
    ``count``, ``centers``, ``valid``) -> the port's tensors on
    ``device`` (``count`` becomes an int)."""
    out = {}
    for name, value in arrays.items():
        if name not in _STATE_DTYPES:
            raise ValueError(f"unknown stage output {name!r}")
        dtype = _STATE_DTYPES[name]
        if dtype is None:
            out[name] = int(np.asarray(value))
        else:
            out[name] = torch.as_tensor(np.array(value), dtype=dtype,
                                        device=device)
    return out

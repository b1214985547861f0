"""patolette_tpu_torch: the PyTorch/CUDA port of patolette-tpu.

A second package beside the JAX one (``patolette_tpu``, the reference),
with the same public surface:

    from patolette_tpu_torch import quantize, ColorSpace_ICtCp

Plain tensor code is PyTorch; the device hot loops are CUDA kernels written
for Hopper (``csrc/``), built on first use. Work runs on ``cuda`` unless
the caller passes ``device="cpu"``, which runs each kernel's plain-PyTorch
twin. This package never imports JAX or ``patolette_tpu``.
"""

from patolette_tpu_torch.utils.config import (  # noqa: F401
    ColorSpace,
    ColorSpace_CIELuv,
    ColorSpace_ICtCp,
    ColorSpace_sRGB,
    QuantizeOptions,
    default_options,
)
from patolette_tpu_torch.utils.errors import (  # noqa: F401
    ExitCode,
    exit_code_message,
)
from patolette_tpu_torch.models.pipeline import (  # noqa: F401
    quantize,
    quantize_options,
)

__version__ = "0.1.0"

__all__ = [
    "quantize",
    "quantize_options",
    "ColorSpace",
    "ColorSpace_sRGB",
    "ColorSpace_CIELuv",
    "ColorSpace_ICtCp",
    "QuantizeOptions",
    "default_options",
    "ExitCode",
    "exit_code_message",
]

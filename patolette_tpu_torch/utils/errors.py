"""Typed exit codes and messages.

A copy of ``patolette_tpu/utils/errors.py`` (importing that package would
import JAX): the reference orchestrator's error surface (patolette.c:26-38,
validation at :61-95) plus its Python-level validation messages
(patolette.pyx:328-330).
"""

from __future__ import annotations

import enum


class ExitCode(enum.IntEnum):
    SUCCESS = 0
    BAD_QUANT = -1
    BAD_DIMS = -2
    BAD_PALETTE_SIZE = -3
    HUGE_DIMS = -4


EXIT_CODE_MESSAGES = {
    ExitCode.SUCCESS: "Quantization successful.",
    ExitCode.BAD_QUANT: "Internal quantization error.",
    ExitCode.BAD_DIMS: "Image dimensions should be greater than 0.",
    ExitCode.BAD_PALETTE_SIZE: "Palette size should be greater than 0.",
    ExitCode.HUGE_DIMS: "Image dimensions are too big.",
}

# Python-level validation messages (reference pyx:328-330).
COLOR_MISMATCH = "The number of colors doesn't match the supplied width and height."
BAD_CHANNEL_COUNT = (
    "Expected colors to be in sRGB[0, 1] space. Channel count mismatch: {} found."
)
BAD_TILE_SIZE = "tile_size parameter expected to be in the range [0, inf]"

# Hard cap on image size (reference patolette.c:92).
MAX_PIXELS = 40000 * 40000


def exit_code_message(code: ExitCode | int) -> str:
    return EXIT_CODE_MESSAGES[ExitCode(code)]


def validate_dims(width: int, height: int, palette_size: int) -> ExitCode:
    """Mirror of validate_arguments (reference patolette.c:61-95).

    Dimensions must each be >= 1, not just have a positive product:
    width=-4, height=-9 multiplies to +36."""
    if width < 1 or height < 1:
        return ExitCode.BAD_DIMS
    if palette_size < 1:
        return ExitCode.BAD_PALETTE_SIZE
    if width * height > MAX_PIXELS:
        return ExitCode.HUGE_DIMS
    return ExitCode.SUCCESS

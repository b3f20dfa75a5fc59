"""libpillowfight_tpu — batched JAX stencil/scan-processing framework with
the full capability set of openpaperwork/libpillowfight (SURVEY.md).

Two API surfaces:

* **Native batched API** (`libpillowfight_tpu.ops`): jit-compiled kernels
  over uint8 RGBA page batches [B, H, W, 4] — the throughput interface.
* **Compatibility façade** (`libpillowfight_tpu.compat`, re-exported
  here): pillowfight drop-in, PIL.Image in/out, one call per image.
"""

from . import compat, core, io, ops, parallel
from .compat import (
    SWT_OUTPUT_BW_TEXT,
    SWT_OUTPUT_GRAYSCALE_TEXT,
    SWT_OUTPUT_ORIGINAL_BOXES,
)
from .core.bitmap import compare
from .ops import (
    ace,
    canny,
    gaussian,
    sobel,
    unpaper_blackfilter,
    unpaper_blurfilter,
    unpaper_border,
    unpaper_grayfilter,
    unpaper_masks,
    unpaper_noisefilter,
)
from .ops.swt import swt
from .version import __version__, get_version

__all__ = [
    "compat", "core", "io", "ops", "parallel",
    "ace", "canny", "compare", "gaussian", "get_version", "sobel", "swt",
    "unpaper_blackfilter", "unpaper_blurfilter", "unpaper_border",
    "unpaper_grayfilter", "unpaper_masks", "unpaper_noisefilter",
    "SWT_OUTPUT_BW_TEXT", "SWT_OUTPUT_GRAYSCALE_TEXT",
    "SWT_OUTPUT_ORIGINAL_BOXES", "__version__",
]

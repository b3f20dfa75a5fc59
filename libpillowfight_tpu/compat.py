"""pillowfight-compatible façade: PIL.Image in -> PIL.Image out.

Drop-in replacement for the reference's Python API
(ref: src/pillowfight/__init__.py — SURVEY.md §2.3: `import pillowfight;
pillowfight.ace(img)` etc.). Every public function accepts a PIL.Image
(or anything PIL can be built from: numpy uint8 RGBA) and returns a
PIL.Image, while dispatching to the batched device kernels underneath.

For throughput, use the native batched API (libpillowfight_tpu.ops.*)
directly — this façade pays a host<->device round trip per image, exactly
like the reference pays a PIL<->bytes round trip per call.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .core import bitmap
from .core import constants as C
from .ops.ace import ace as _ace
from .ops.canny import canny as _canny
from .ops.gaussian import gaussian as _gaussian
from .ops.sobel import sobel as _sobel
from .ops.swt import swt as _swt
from .ops import unpaper as _unpaper
from .version import get_version

SWT_OUTPUT_BW_TEXT = C.SWT_OUTPUT_BW_TEXT
SWT_OUTPUT_GRAYSCALE_TEXT = C.SWT_OUTPUT_GRAYSCALE_TEXT
SWT_OUTPUT_ORIGINAL_BOXES = C.SWT_OUTPUT_ORIGINAL_BOXES


def _in(img) -> jnp.ndarray:
    if hasattr(img, "convert"):  # PIL.Image
        return jnp.asarray(bitmap.from_pil(img))
    arr = np.asarray(img)
    if arr.ndim == 2:  # gray -> RGBA
        arr = np.stack([arr] * 3 + [np.full_like(arr, 255)], axis=-1)
    elif arr.ndim == 3 and arr.shape[-1] == 3:
        arr = np.concatenate(
            [arr, np.full(arr.shape[:2] + (1,), 255, arr.dtype)], axis=-1
        )
    return jnp.asarray(arr.astype(np.uint8))


def _out(arr):
    return bitmap.to_pil(np.asarray(arr))


def ace(img, slope=C.ACE_DEFAULT_SLOPE, limit=C.ACE_DEFAULT_LIMIT,
        samples=C.ACE_DEFAULT_NB_SAMPLES, seed=None, mode="rolled"):
    """ref: pillowfight.ace(img, slope=10, limit=1000, samples=100, seed=None).

    Default estimator is "rolled": per-pixel sampling via shared random
    offsets — every pixel's `samples` draws are exactly i.i.d. uniform
    over the page, so the per-pixel estimator distribution matches
    upstream's faithfully (pinned at the per_pixel-grade tolerance by
    tests/test_golden_oracle.py::test_ace_distributional_vs_oracle),
    while running dense at shared-spray speed. Remaining deviation
    (PARITY.md #15): cross-pixel sample correlation differs from
    upstream's fully independent draws. Pass mode="per_pixel" for fully
    independent sampling (gather-bound, much slower), or
    mode="shared" for the fastest single-spray approximation."""
    seed = C.ACE_DEFAULT_SEED if seed is None else int(seed)
    return _out(_ace(
        _in(img), nb_samples=int(samples), slope=float(slope),
        limit=float(limit), seed=seed, mode=mode,
    ))


def canny(img):
    return _out(_canny(_in(img)))


def gaussian(img, sigma=C.GAUSSIAN_DEFAULT_SIGMA,
             nb_stddev=C.GAUSSIAN_DEFAULT_NB_STDDEV):
    return _out(_gaussian(_in(img), float(sigma), int(nb_stddev)))


def sobel(img):
    return _out(_sobel(_in(img)))


def swt(img, output_type=SWT_OUTPUT_BW_TEXT):
    return _out(_swt(_in(img), output_type=int(output_type)))


def compare(img_in, img_in2, tolerance=C.COMPARE_DEFAULT_TOLERANCE):
    """ref: pillowfight.compare -> (nb_diff, diff PIL.Image)."""
    a = _in(img_in)[None]
    b = _in(img_in2)[None]
    n, diff = bitmap.compare(a, b, tolerance=int(tolerance))
    return int(n[0]), _out(diff[0])


def unpaper_blackfilter(img):
    return _out(_unpaper.unpaper_blackfilter(_in(img)))


def unpaper_blurfilter(img):
    return _out(_unpaper.unpaper_blurfilter(_in(img)))


def unpaper_border(img):
    return _out(_unpaper.unpaper_border(_in(img)))


def unpaper_grayfilter(img):
    return _out(_unpaper.unpaper_grayfilter(_in(img)))


def unpaper_masks(img):
    return _out(_unpaper.unpaper_masks(_in(img)))


def unpaper_noisefilter(img):
    return _out(_unpaper.unpaper_noisefilter(_in(img)))


__all__ = [
    "ace", "canny", "compare", "gaussian", "get_version", "sobel", "swt",
    "unpaper_blackfilter", "unpaper_blurfilter", "unpaper_border",
    "unpaper_grayfilter", "unpaper_masks", "unpaper_noisefilter",
    "SWT_OUTPUT_BW_TEXT", "SWT_OUTPUT_GRAYSCALE_TEXT",
    "SWT_OUTPUT_ORIGINAL_BOXES",
]

"""unpaper blackfilter (ref: src/pillowfight/blackfilter.c — SURVEY.md §3.4).

Erases solid black scan artifacts (borders, punch holes): any sliding
scan square whose dark-pixel ratio exceeds the scan threshold seeds a
flood fill over the connected dark region, which is wiped to white.

Re-design: the square sweep is one strided reduce_window; the flood
fill is morph.flood_reach's exact fixed point — seeds are the dark pixels
inside triggered squares, the fill domain is the dark mask.
"""

from __future__ import annotations

import jax

from ...core import constants as C
from ..morph import flood_reach
from .common import (apply_wipe, block_counts, coverage_from_blocks,
                     dark_mask)


def blackfilter_wipe_dark(
    dark: jax.Array,
    scan_size: int = C.BLACKFILTER_SCAN_SIZE,
    scan_step: int = C.BLACKFILTER_SCAN_STEP,
    scan_threshold: float = C.BLACKFILTER_SCAN_THRESHOLD,
    intensity: int = C.BLACKFILTER_INTENSITY,
) -> jax.Array:
    """Decision core on a precomputed dark-pixel plane (bool [B,H,W]).
    The fused pipeline threads bool planes between stages (a wiped pixel
    becomes white, i.e. dark &= ~wipe) — 4x less traffic than threading
    the f32 gray plane.

    `intensity` is the flood's gap-leap radius (unpaper
    --blackfilter-intensity: "larger values will leap larger gaps"):
    dark pixels within Chebyshev distance `intensity` are connected, so
    a black scan border broken by specks of white still floods end to
    end; the gap pixels themselves are never wiped."""
    counts = block_counts(dark, scan_size, scan_step)
    triggered = counts >= (scan_threshold * scan_size * scan_size)
    seed_area = coverage_from_blocks(triggered, dark.shape, scan_size, scan_step)

    return flood_reach(seed_area & dark, dark, connectivity=8, leap=intensity)


def blackfilter_wipe(
    gray: jax.Array,
    scan_size: int = C.BLACKFILTER_SCAN_SIZE,
    scan_step: int = C.BLACKFILTER_SCAN_STEP,
    scan_threshold: float = C.BLACKFILTER_SCAN_THRESHOLD,
    black_threshold: float = C.UNPAPER_BLACK_THRESHOLD,
    intensity: int = C.BLACKFILTER_INTENSITY,
) -> jax.Array:
    """Wipe mask from a gray plane f32 [B,H,W]."""
    return blackfilter_wipe_dark(
        dark_mask(gray, black_threshold), scan_size, scan_step,
        scan_threshold, intensity)


def unpaper_blackfilter(pages: jax.Array, **kwargs) -> jax.Array:
    return apply_wipe(pages, blackfilter_wipe, **kwargs)

"""unpaper border (ref: src/pillowfight/border.c — SURVEY.md §2.2).

Scans inward from each of the four page edges in strips of `size` rows/
columns at stride `step`, counting dark pixels per strip; the border ends
at the first strip whose count exceeds `threshold`. The detected border
area is wiped to white.

Re-design: strip counts come from one cumulative sum of per-row /
per-column dark counts (two reductions), the 'first strip exceeding'
search is an argmax over a [B, K] table, and the wipe is an iota
comparison — the whole filter is branch-free and batched over pages.
Scan depth is capped at half the page so opposite borders cannot overlap.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ...core import constants as C
from .common import apply_wipe, dark_mask, line_counts


def _border_extent(line_counts: jax.Array, extent: int, size: int, step: int,
                   threshold: float, from_end: bool) -> jax.Array:
    """line_counts f32 [B, N] (dark count per row/col). Returns int32 [B]:
    number of pixels of border measured from the chosen edge."""
    n = line_counts.shape[1]
    if from_end:
        line_counts = jnp.flip(line_counts, axis=1)
    cs = jnp.concatenate(
        [jnp.zeros((line_counts.shape[0], 1), line_counts.dtype),
         jnp.cumsum(line_counts, axis=1)], axis=1)
    k_max = max((extent // 2 - size) // step + 1, 1)
    starts = jnp.arange(k_max, dtype=jnp.int32) * step
    strip = cs[:, starts + size] - cs[:, starts]          # [B, K]
    has_content = strip > threshold
    any_content = jnp.any(has_content, axis=1)
    first = jnp.argmax(has_content, axis=1).astype(jnp.int32)
    first = jnp.where(any_content, first, k_max)
    return first * step


def border_wipe_dark(
    dark: jax.Array,
    scan_size: int = C.BORDER_SCAN_SIZE,
    scan_step: int = C.BORDER_SCAN_STEP,
    scan_threshold: float = C.BORDER_SCAN_THRESHOLD,
) -> jax.Array:
    """Decision core on a precomputed dark plane (bool [B,H,W])."""
    b, h, w = dark.shape

    row_counts, col_counts = line_counts(dark)  # [B,H], [B,W]

    top = _border_extent(row_counts, h, scan_size, scan_step, scan_threshold, False)
    bottom = _border_extent(row_counts, h, scan_size, scan_step, scan_threshold, True)
    left = _border_extent(col_counts, w, scan_size, scan_step, scan_threshold, False)
    right = _border_extent(col_counts, w, scan_size, scan_step, scan_threshold, True)

    ys = jax.lax.broadcasted_iota(jnp.int32, (b, h, w), 1)
    xs = jax.lax.broadcasted_iota(jnp.int32, (b, h, w), 2)
    return (
        (ys < top[:, None, None]) | (ys >= (h - bottom)[:, None, None])
        | (xs < left[:, None, None]) | (xs >= (w - right)[:, None, None])
    )


def border_wipe(
    gray: jax.Array,
    scan_size: int = C.BORDER_SCAN_SIZE,
    scan_step: int = C.BORDER_SCAN_STEP,
    scan_threshold: float = C.BORDER_SCAN_THRESHOLD,
) -> jax.Array:
    """Wipe mask from a gray plane f32 [B,H,W] (decision core)."""
    return border_wipe_dark(dark_mask(gray), scan_size, scan_step,
                            scan_threshold)


def unpaper_border(pages: jax.Array, **kwargs) -> jax.Array:
    return apply_wipe(pages, border_wipe, **kwargs)

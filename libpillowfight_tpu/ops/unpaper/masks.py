"""unpaper masks (ref: src/pillowfight/masks.c — SURVEY.md §2.2).

Detects the content mask: starting from each start point (default: the
page center, matching unpaper's default scan point), a scan strip of
width `size` slides outward (stride `step`) in each of the four
directions; the mask boundary is the first strip whose dark-pixel ratio
falls below `threshold` (content has ended). Everything outside the
union of detected mask rectangles is wiped to white.

Spec pinned for the oracle: left/top boundary = start of the first blank
strip (conservative, never clips content); right/bottom boundary = end of
the first blank strip; no blank strip found -> mask extends to the page
edge. Dark = gray < 0.33*255. Multiple start points (upstream masks.c
accepts user-supplied scan points) grow one rectangle each; the kept
content area is their union (PARITY.md #11).

Re-design: per-direction strip ratios come from one cumsum of dark
row/column counts; the outward search is an argmax over a [B, K] table;
the wipe is an iota comparison. Fully batched, no data-dependent shapes;
start points are static call parameters (part of the jit key), so N
starts cost N tiny [B, K] table searches over the same two cumsums.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ...core import constants as C
from .common import apply_wipe, dark_mask, line_counts


def _mask_edge(line_counts: jax.Array, perp_extent: int, center: int, size: int,
               step: int, threshold: float, outward_is_down: bool) -> jax.Array:
    """First blank strip scanning outward from `center`.

    line_counts f32 [B, N]. If outward_is_down, scanning toward index 0
    (left/top): returns the blank strip's START index. Otherwise toward N
    (right/bottom): returns the blank strip's END index. No blank strip
    -> 0 (resp. N). Strips that would fall off the page (start < 0 or
    start+size > N, possible for near-edge user start points) are never
    blank, matching the oracle's `if (start < 0) break`.
    """
    b, n = line_counts.shape
    cs = jnp.concatenate(
        [jnp.zeros((b, 1), line_counts.dtype), jnp.cumsum(line_counts, axis=1)],
        axis=1)

    if outward_is_down:
        k_max = max((center - size) // step + 1, 1)
        starts = center - size - jnp.arange(k_max, dtype=jnp.int32) * step  # desc
    else:
        k_max = max((n - center - size) // step + 1, 1)
        starts = center + jnp.arange(k_max, dtype=jnp.int32) * step  # asc

    in_range = (starts >= 0) & (starts + size <= n)
    safe = jnp.clip(starts, 0, max(n - size, 0))
    strip = cs[:, safe + size] - cs[:, safe]  # [B, K]
    blank = (strip < (threshold * size * perp_extent)) & in_range[None, :]
    any_blank = jnp.any(blank, axis=1)
    first = jnp.argmax(blank, axis=1).astype(jnp.int32)
    if outward_is_down:
        edge = starts[first]
        return jnp.where(any_blank, edge, 0)
    edge = starts[first] + size
    return jnp.where(any_blank, edge, n)


def masks_wipe_dark(
    dark: jax.Array,
    scan_size: int = C.MASKS_SCAN_SIZE,
    scan_step: int = C.MASKS_SCAN_STEP,
    scan_threshold: float = C.MASKS_SCAN_THRESHOLD,
    starts: tuple | None = None,
) -> jax.Array:
    """Decision core on a precomputed dark plane (bool [B,H,W]).

    starts: optional tuple of (y, x) pixel start points (static ints);
    None means the single page-center point, unpaper's default."""
    b, h, w = dark.shape
    if starts is None:
        starts = ((h // 2, w // 2),)

    row_counts, col_counts = line_counts(dark)  # [B,H], [B,W]

    ys = jax.lax.broadcasted_iota(jnp.int32, (b, h, w), 1)
    xs = jax.lax.broadcasted_iota(jnp.int32, (b, h, w), 2)
    keep = None
    for (sy, sx) in starts:
        sy, sx = int(sy), int(sx)
        left = _mask_edge(col_counts, h, sx, scan_size, scan_step, scan_threshold, True)
        right = _mask_edge(col_counts, h, sx, scan_size, scan_step, scan_threshold, False)
        top = _mask_edge(row_counts, w, sy, scan_size, scan_step, scan_threshold, True)
        bottom = _mask_edge(row_counts, w, sy, scan_size, scan_step, scan_threshold, False)
        rect = (
            (xs >= left[:, None, None]) & (xs < right[:, None, None])
            & (ys >= top[:, None, None]) & (ys < bottom[:, None, None])
        )
        keep = rect if keep is None else (keep | rect)
    return ~keep


def masks_wipe(
    gray: jax.Array,
    scan_size: int = C.MASKS_SCAN_SIZE,
    scan_step: int = C.MASKS_SCAN_STEP,
    scan_threshold: float = C.MASKS_SCAN_THRESHOLD,
    starts: tuple | None = None,
) -> jax.Array:
    """Wipe mask from a gray plane f32 [B,H,W] (decision core)."""
    return masks_wipe_dark(dark_mask(gray), scan_size, scan_step,
                           scan_threshold, starts)


def unpaper_masks(pages: jax.Array, **kwargs) -> jax.Array:
    return apply_wipe(pages, masks_wipe, **kwargs)

"""unpaper noisefilter (ref: src/pillowfight/noisefilter.c — SURVEY.md §2.2).

Erases speckle noise: every 8-connected cluster of non-white pixels with
at most `intensity` members is wiped to white.

Re-design: the reference's per-pixel bounded flood count becomes a
bit-parallel bounded flood (morph.small_cluster_mask): every pixel
carries a packed bitboard of locally reachable window offsets, k fused
elementwise dilation steps compute each pixel's exact graph-ball size, and the
<= intensity decision falls out with no global labeling, no while_loop,
and no scatter — every cluster on the page is measured simultaneously.
"""

from __future__ import annotations

import jax

from ...core import constants as C
from ..morph import small_cluster_mask
from .common import apply_wipe, nonwhite_mask


def noisefilter_wipe_nonwhite(
    nonwhite: jax.Array, intensity: int = C.NOISEFILTER_INTENSITY
) -> jax.Array:
    """Decision core on a precomputed non-white plane (bool [B,H,W])."""
    return small_cluster_mask(nonwhite, intensity, connectivity=8)


def noisefilter_wipe(
    gray: jax.Array, intensity: int = C.NOISEFILTER_INTENSITY
) -> jax.Array:
    """Wipe mask from a gray plane f32 [B,H,W] (decision core)."""
    return noisefilter_wipe_nonwhite(nonwhite_mask(gray), intensity)


def unpaper_noisefilter(pages: jax.Array, **kwargs) -> jax.Array:
    return apply_wipe(pages, noisefilter_wipe, **kwargs)

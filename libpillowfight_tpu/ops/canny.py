"""Canny edge detector (ref: src/pillowfight/canny.c pf_canny — SURVEY.md §3.2).

Stages: gray -> gaussian(sigma=2, 5 stddev) -> sobel gradients ->
non-maximum suppression (direction quantized to 4 bins) ->
double threshold (fractions of per-page max intensity) ->
hysteresis (weak pixels kept iff 8-connected to a strong pixel).

The reference's sequential BFS edge-linking becomes the exact
fixed-point reachability of morph.flood_reach. Everything up to the
thresholds is straight-line math that XLA fuses into the conv loops.
Output: edges white (255) on black, grayscale RGBA.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import constants as C
from ..core.bitmap import (
    ensure_batched,
    gray_to_rgba,
    maybe_unbatch,
    normalize,
    rgba_to_gray,
)
from .gaussian import gaussian_on_matrix
from .morph import flood_reach
from .sobel import sobel_gradients


def _nms(intensity: jax.Array, gx: jax.Array, gy: jax.Array) -> jax.Array:
    """Non-maximum suppression from the raw gradient pair. f32 [B,H,W].

    The 4 direction bins over [0, pi) are round-half-even of
    theta/(pi/4) (ref semantics: nearbyint(fmod(atan2(gy,gx), pi)/(pi/4))
    % 4, oracle/oracle.cc:148-150), computed WITHOUT materializing the
    atan2 plane: with ax=|gx|, ay=|gy| and half-even rounding,
      bin 0 (compare W/E)   <=>  theta <= 22.5  or theta >= 157.5
                            <=>  ay <= tan(22.5deg) * ax
      bin 2 (compare N/S)   <=>  67.5 <= theta <= 112.5
                            <=>  ay >= tan(67.5deg) * ax
      else diagonal: bin 1 (NE/SW) when gx*gy > 0, bin 3 (NW/SE) when < 0
    (gx*gy = 0 inside the diagonal band is impossible: gx=0 lands in bin
    2, gy=0 in bin 0). Saves one full-page transcendental intermediate —
    at batch 64 the atan2 plane alone is 2.2 GB."""
    t1 = float(np.tan(np.pi / 8))
    t2 = float(np.tan(3 * np.pi / 8))
    ax, ay = jnp.abs(gx), jnp.abs(gy)
    bin0 = ay <= t1 * ax
    bin2 = ay >= t2 * ax
    diag_pos = gx * gy > 0.0

    z = jnp.pad(intensity, ((0, 0), (1, 1), (1, 1)))

    def shift(dy, dx):  # neighbor intensity, zero outside
        return z[:, 1 + dy : z.shape[1] - 1 + dy, 1 + dx : z.shape[2] - 1 + dx]

    diag_a = jnp.where(diag_pos, shift(-1, 1), shift(-1, -1))
    diag_b = jnp.where(diag_pos, shift(1, -1), shift(1, 1))
    a = jnp.where(bin0, shift(0, 1), jnp.where(bin2, shift(-1, 0), diag_a))
    b = jnp.where(bin0, shift(0, -1), jnp.where(bin2, shift(1, 0), diag_b))
    keep = (intensity >= a) & (intensity >= b)
    return jnp.where(keep, intensity, 0.0)


def canny_gradients(gray: jax.Array):
    """(gx, gy) of the gaussian-smoothed page — the gradient stack canny
    AND swt share (swt re-deriving it separately cost a duplicate
    gaussian+sobel pass: vmap'd and direct tracings don't CSE)."""
    smoothed = gaussian_on_matrix(
        gray, C.CANNY_GAUSSIAN_SIGMA, C.CANNY_GAUSSIAN_NB_STDDEV
    )
    return sobel_gradients(smoothed)


def canny_edge_mask_from_gradients(gx: jax.Array, gy: jax.Array) -> jax.Array:
    """bool edge mask from precomputed smoothed gradients.

    NMS compares the intensity NORMALIZED to [0,255] and rounded to the
    integer grid (ref: the C library runs canny on normalized u8-scale
    matrices, SURVEY.md §2.2). Shared spec with the oracle: integer
    compares behave identically in f32 and f64, so ridge ties break the
    same way on both sides — without this the smooth gaussian gradient
    produces f32 false ties and systematically double-width f32 ridges.
    """
    inten_q = jnp.round(normalize(jnp.hypot(gx, gy)))
    nms = _nms(inten_q, gx, gy)
    peak = jnp.max(nms, axis=(-2, -1), keepdims=True)
    # strict > 0 guard: a flat page (peak == 0) has no edges at all
    strong = (nms >= peak * C.CANNY_HIGH_THRESHOLD_FRACTION) & (nms > 0.0)
    weak = (nms >= peak * C.CANNY_LOW_THRESHOLD_FRACTION) & (nms > 0.0)
    return flood_reach(strong, weak, connectivity=8)


def canny_edge_mask(gray: jax.Array) -> jax.Array:
    """f32 gray [B,H,W] -> bool edge mask [B,H,W]. Shared with SWT."""
    gx, gy = canny_gradients(gray)
    return canny_edge_mask_from_gradients(gx, gy)


@jax.jit
def canny(pages: jax.Array) -> jax.Array:
    """uint8 RGBA [B,H,W,4] -> edge bitmap (white edges on black)."""
    pages, unb = ensure_batched(pages)
    edges = canny_edge_mask(rgba_to_gray(pages))
    return maybe_unbatch(gray_to_rgba(edges.astype(jnp.float32) * 255.0), unb)

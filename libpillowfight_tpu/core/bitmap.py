"""Core image model: batched RGBA pages + grayscale planes.

Replacement for the reference's L1 data model
(ref: include/pillowfight/util.h `struct pf_bitmap` / `union pf_pixel`,
src/pillowfight/util.c matrix helpers — see SURVEY.md §2.1).

Design: instead of a single-image C struct, the canonical type is a
*batched* array so every kernel is data-parallel over pages from the start:

  - RGBA pages:  uint8  [B, H, W, 4]   (alpha preserved, ignored by filters)
  - gray planes: float32 [B, H, W]     values in [0, 255]

All ops are shape-polymorphic over B and jit-friendly (static H, W).
Single-image (H, W, 4) / (H, W) inputs are accepted everywhere via
`ensure_batched` and squeezed back on return by the public API layer.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as C


# --------------------------------------------------------------------------
# batching helpers
# --------------------------------------------------------------------------

def ensure_batched(img: jax.Array) -> tuple[jax.Array, bool]:
    """Return (batched_img, was_unbatched). Accepts [H,W], [H,W,4], [B,H,W], [B,H,W,4]."""
    if img.ndim == 2:  # [H, W] gray
        return img[None], True
    if img.ndim == 3:
        if img.shape[-1] == 4:  # [H, W, 4] rgba
            return img[None], True
        return img, False  # [B, H, W] gray batch
    if img.ndim == 4:
        return img, False
    raise ValueError(f"unsupported image rank {img.ndim}: shape {img.shape}")


def maybe_unbatch(img: jax.Array, was_unbatched: bool) -> jax.Array:
    return img[0] if was_unbatched else img


# --------------------------------------------------------------------------
# colorspace (ref: util.c pf_rgb_bitmap_to_grayscale_dbl_matrix and inverse)
# --------------------------------------------------------------------------

@jax.jit
def rgba_to_gray(pages: jax.Array) -> jax.Array:
    """uint8 [B,H,W,4] -> f32 [B,H,W] in [0,255], unweighted RGB mean."""
    rgb = pages[..., :3].astype(jnp.float32)
    return jnp.mean(rgb, axis=-1)


# -- packed-word transport -------------------------------------------------
# The reference's own pixel model (ref: util.h `union pf_pixel` — a 32-bit
# word): RGBA travels as uint32 words [B, H, W], so one load fetches a
# whole pixel and the channel split is shifts and masks. On host the view
# is free (same bytes); on device it is a bitcast.

def pages_to_words(pages: jax.Array) -> jax.Array:
    """uint8 [..., 4] RGBA -> uint32 [...] words (R = low byte)."""
    return jax.lax.bitcast_convert_type(pages, jnp.uint32)


def words_to_pages(words: jax.Array) -> jax.Array:
    """uint32 [...] words -> uint8 [..., 4] RGBA."""
    return jax.lax.bitcast_convert_type(words, jnp.uint8)


def host_pages_to_words(pages: np.ndarray) -> np.ndarray:
    """Free numpy view: uint8 [B,H,W,4] -> uint32 [B,H,W]."""
    pages = np.ascontiguousarray(pages, np.uint8)
    return pages.view(np.uint32).reshape(pages.shape[:-1])


def host_words_to_pages(words: np.ndarray) -> np.ndarray:
    """Free numpy view: uint32 [B,H,W] -> uint8 [B,H,W,4]."""
    words = np.ascontiguousarray(words, np.uint32)
    return words.view(np.uint8).reshape(words.shape + (4,))


def words_to_gray(words: jax.Array) -> jax.Array:
    """uint32 words -> f32 gray in [0,255]; same unweighted RGB mean as
    rgba_to_gray (bit-identical: exact small-int float arithmetic)."""
    r = (words & jnp.uint32(0xFF)).astype(jnp.float32)
    g = ((words >> jnp.uint32(8)) & jnp.uint32(0xFF)).astype(jnp.float32)
    b = ((words >> jnp.uint32(16)) & jnp.uint32(0xFF)).astype(jnp.float32)
    return (r + g + b) / 3.0


def words_to_s3(words: jax.Array) -> jax.Array:
    """uint32 words -> uint16 r+g+b in [0, 765] — the EXACT integer form
    of 3*gray. Half the traffic of the f32 gray plane and integer-exact
    block statistics (grayfilter means)."""
    r = words & jnp.uint32(0xFF)
    g = (words >> jnp.uint32(8)) & jnp.uint32(0xFF)
    b = (words >> jnp.uint32(16)) & jnp.uint32(0xFF)
    return (r + g + b).astype(jnp.uint16)


def wipe_white_words(words: jax.Array, wipe: jax.Array) -> jax.Array:
    """Set RGB bytes of wiped pixels to 255, preserving alpha."""
    return jnp.where(wipe, words | jnp.uint32(0x00FFFFFF), words)


@jax.jit
def gray_to_rgba(gray: jax.Array) -> jax.Array:
    """f32 [B,H,W] in [0,255] -> uint8 RGBA [B,H,W,4] with opaque alpha."""
    v = jnp.clip(jnp.round(gray), 0, 255).astype(jnp.uint8)
    alpha = jnp.full_like(v, 255)
    return jnp.stack([v, v, v, alpha], axis=-1)


def to_uint8(x: jax.Array) -> jax.Array:
    return jnp.clip(jnp.round(x), 0, 255).astype(jnp.uint8)


# --------------------------------------------------------------------------
# normalize (ref: util.c pf_normalize — min-max rescale to [0, 255])
# --------------------------------------------------------------------------

@jax.jit
def normalize(matrix: jax.Array) -> jax.Array:
    """Per-page min-max rescale of f32 [B,H,W] to [0,255]; flat pages -> 0."""
    lo = jnp.min(matrix, axis=(-2, -1), keepdims=True)
    hi = jnp.max(matrix, axis=(-2, -1), keepdims=True)
    span = jnp.maximum(hi - lo, 1e-12)
    return (matrix - lo) * (255.0 / span)


# --------------------------------------------------------------------------
# compare (ref: src/pillowfight/compare.c pf_compare)
# --------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("tolerance",))
def compare(a: jax.Array, b: jax.Array, tolerance: int = C.COMPARE_DEFAULT_TOLERANCE):
    """Pixel diff of two equal-shaped RGBA batches with per-channel tolerance.

    Returns (n_diff_per_page int32 [B], diff_bitmap uint8 [B,H,W,4]).
    The diff bitmap is white where pixels match and shows the absolute
    channel difference where they do not (alpha forced opaque) — the same
    role pf_compare's output bitmap plays as the reference's golden-test
    comparator.
    """
    a16 = a[..., :3].astype(jnp.int16)
    b16 = b[..., :3].astype(jnp.int16)
    delta = jnp.abs(a16 - b16)
    differs = jnp.any(delta > tolerance, axis=-1)  # [B,H,W]
    n_diff = jnp.sum(differs, axis=(-2, -1)).astype(jnp.int32)
    diff_rgb = jnp.where(differs[..., None], delta.astype(jnp.uint8), jnp.uint8(255))
    alpha = jnp.full(differs.shape + (1,), 255, jnp.uint8)
    return n_diff, jnp.concatenate([diff_rgb, alpha], axis=-1)


# --------------------------------------------------------------------------
# host-side conversions (PIL / numpy)
# --------------------------------------------------------------------------

def from_pil(img) -> np.ndarray:
    """PIL.Image -> uint8 RGBA [H, W, 4] (host numpy)."""
    return np.asarray(img.convert("RGBA"), dtype=np.uint8)


def to_pil(arr):
    """uint8 RGBA [H, W, 4] -> PIL.Image."""
    from PIL import Image

    return Image.fromarray(np.asarray(arr, dtype=np.uint8), mode="RGBA")


def write_ppm(path: str, arr) -> None:
    """Debug dump (ref: util.c pf_write_bitmap_to_ppm)."""
    a = np.asarray(arr)
    if a.ndim == 3 and a.shape[-1] == 4:
        a = a[..., :3]
    elif a.ndim == 2:
        a = np.stack([a] * 3, axis=-1)
    a = a.astype(np.uint8)
    h, w = a.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(a.tobytes())

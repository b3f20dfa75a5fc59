"""Filter pipelines: whole-page filter graphs fused under one jit.

SURVEY.md §2.4 (PP row): the reference runs filters sequentially with a
full-image barrier and a materialized bitmap between each pair. Here a
pipeline is a *spec* (tuple of (filter_name, frozen-kwargs) — hashable,
so it is the jit static-argument key, SURVEY.md §5 config item) compiled
into ONE XLA program: intermediates stay on the device, elementwise stages
fuse into the convs, and uint8<->f32 conversions between stages collapse.

The default `DOCUMENT_CLEANUP` chain mirrors the reference README's
intended unpaper usage: blackfilter -> noisefilter -> blurfilter ->
masks -> grayfilter -> border.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Iterable

import jax

import jax.numpy as jnp

from ..core.bitmap import (
    ensure_batched,
    maybe_unbatch,
    pages_to_words,
    rgba_to_gray,
    wipe_white_words,
    words_to_gray,
    words_to_pages,
    words_to_s3,
)
from ..core import constants as C
from ..ops import (
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
from ..ops.swt import swt
from ..ops.unpaper.blackfilter import blackfilter_wipe, blackfilter_wipe_dark
from ..ops.unpaper.blurfilter import blurfilter_wipe, blurfilter_wipe_nonwhite
from ..ops.unpaper.border import border_wipe, border_wipe_dark
from ..ops.unpaper.common import dark_mask, nonwhite_mask, wipe_white
from ..ops.unpaper.grayfilter import grayfilter_wipe, grayfilter_wipe_planes_s3
from ..ops.unpaper.masks import masks_wipe, masks_wipe_dark
from ..ops.unpaper.noisefilter import noisefilter_wipe, noisefilter_wipe_nonwhite

_FILTERS = {
    "ace": ace,
    "canny": canny,
    "gaussian": gaussian,
    "sobel": sobel,
    "swt": swt,
    "unpaper_blackfilter": unpaper_blackfilter,
    "unpaper_blurfilter": unpaper_blurfilter,
    "unpaper_border": unpaper_border,
    "unpaper_grayfilter": unpaper_grayfilter,
    "unpaper_masks": unpaper_masks,
    "unpaper_noisefilter": unpaper_noisefilter,
}

DOCUMENT_CLEANUP = (
    ("unpaper_blackfilter", ()),
    ("unpaper_noisefilter", ()),
    ("unpaper_blurfilter", ()),
    ("unpaper_masks", ()),
    ("unpaper_grayfilter", ()),
    ("unpaper_border", ()),
)

EDGE_STACK = (("canny", ()),)


def normalize_spec(spec: Iterable) -> tuple:
    """Canonicalize a pipeline spec to a hashable tuple of
    (name, ((kwarg, value), ...)) pairs."""
    out = []
    for item in spec:
        if isinstance(item, str):
            name, kwargs = item, ()
        else:
            name, kwargs = item
            if isinstance(kwargs, dict):
                kwargs = tuple(sorted(kwargs.items()))
            else:
                kwargs = tuple(kwargs)
        if name not in _FILTERS:
            raise ValueError(f"unknown filter {name!r}; have {sorted(_FILTERS)}")
        out.append((name, kwargs))
    return tuple(out)


# unpaper decision cores: wipe mask from a gray plane. A wiped pixel
# becomes exactly white, so threading the decision PLANES between stages
# is bit-identical to re-deriving them from the wiped RGBA — and because
# "white" means dark=False / nonwhite=False, the threaded state is two
# BOOL planes (dark &= ~wipe, nonwhite &= ~wipe; 2 B/px per update)
# instead of the f32 gray plane (9 B/px per update). Only grayfilter
# consumes actual gray values; it reads them lazily as
# where(acc, 255, gray0), which XLA fuses into its block reduction.
# (The reference materializes a full bitmap between every filter pair;
# SURVEY.md §2.4 PP row.)
_WIPES = {
    "unpaper_blackfilter": blackfilter_wipe,
    "unpaper_noisefilter": noisefilter_wipe,
    "unpaper_blurfilter": blurfilter_wipe,
    "unpaper_grayfilter": grayfilter_wipe,
    "unpaper_masks": masks_wipe,
    "unpaper_border": border_wipe,
}

# which threaded plane each stage's decision core consumes
_CORE_PLANE = {
    "unpaper_blackfilter": "dark",
    "unpaper_noisefilter": "nonwhite",
    "unpaper_blurfilter": "nonwhite",
    "unpaper_masks": "dark",
    "unpaper_grayfilter": "gray",  # dark plane + lazy gray values
    "unpaper_border": "dark",
}


def _run_unpaper_group(pages: jax.Array, group) -> jax.Array:
    """Apply a run of consecutive unpaper filters via bool-plane threading.

    Accepts uint8 RGBA [B,H,W,4] or uint32 words [B,H,W]; returns the
    same form. Internally everything runs on u32 words (see
    bitmap.pages_to_words)."""
    # a non-default blackfilter black_threshold would invalidate the
    # shared dark plane; fall back to gray threading for that rare case
    for name, kwargs in group:
        if name == "unpaper_blackfilter" and dict(kwargs).get(
                "black_threshold", C.UNPAPER_BLACK_THRESHOLD
        ) != C.UNPAPER_BLACK_THRESHOLD:
            return _run_unpaper_group_gray(pages, group)

    as_u8 = pages.dtype == jnp.uint8
    words = pages_to_words(pages) if as_u8 else pages
    gray0 = words_to_gray(words)  # lazy: fuses into each consumer pass
    dark0 = dark_mask(gray0)
    nonwhite0 = nonwhite_mask(gray0)

    # all updates are LAZY expressions over the accumulated wipe list —
    # XLA fuses the boolean algebra into each consumer's first read pass,
    # instead
    # of paying a materialized read-modify-write plane per stage
    wipes: list = []

    def acc():
        out = wipes[0]
        for w_ in wipes[1:]:
            out = out | w_
        return out

    def dark():
        return dark0 if not wipes else dark0 & ~acc()

    def nonwhite():
        return nonwhite0 if not wipes else nonwhite0 & ~acc()

    for name, kwargs in group:
        kw = dict(kwargs)
        if name == "unpaper_blackfilter":
            # an explicitly-passed DEFAULT black_threshold reaches here
            # (the gray fallback above only triggers on non-default
            # values); the dark plane already encodes it, and
            # blackfilter_wipe_dark has no such parameter
            kw.pop("black_threshold", None)
            wipe = blackfilter_wipe_dark(dark(), **kw)
        elif name == "unpaper_noisefilter":
            wipe = noisefilter_wipe_nonwhite(nonwhite(), **kw)
        elif name == "unpaper_blurfilter":
            wipe = blurfilter_wipe_nonwhite(nonwhite(), **kw)
        elif name == "unpaper_masks":
            wipe = masks_wipe_dark(dark(), **kw)
        elif name == "unpaper_grayfilter":
            # integer s3 = r+g+b (u16, half the f32 gray traffic); a
            # wiped pixel is exactly white = 765
            s3_0 = words_to_s3(words)
            g3 = s3_0 if not wipes else jnp.where(acc(), jnp.uint16(765),
                                                  s3_0)
            wipe = grayfilter_wipe_planes_s3(dark(), g3, **kw)
        else:  # unpaper_border
            wipe = border_wipe_dark(dark(), **kw)
        wipes.append(wipe)
    out = wipe_white_words(words, acc())
    return words_to_pages(out) if as_u8 else out


def _run_unpaper_group_gray(pages: jax.Array, group) -> jax.Array:
    """Gray-plane threading fallback (non-default plane thresholds)."""
    gray = rgba_to_gray(pages)
    acc = None
    for name, kwargs in group:
        wipe = _WIPES[name](gray, **dict(kwargs))
        gray = jnp.where(wipe, jnp.float32(255.0), gray)
        acc = wipe if acc is None else (acc | wipe)
    return wipe_white(pages, acc)


@partial(jax.jit, static_argnames=("spec",))
def run_pipeline(pages: jax.Array, spec: tuple) -> jax.Array:
    """Apply a normalized spec in one XLA program.

    Accepts uint8 RGBA [B,H,W,4] or uint32 words [B,H,W] (the fast
    transport form — see bitmap.host_pages_to_words); returns the same
    form. Consecutive unpaper filters run as one bool-plane-threaded
    group (single word-batch read + write for the whole group); other
    filters run in order on uint8 RGBA.
    """
    pages, unb = ensure_batched(pages)
    in_words = pages.dtype == jnp.uint32
    i, n = 0, len(spec)
    while i < n:
        name, kwargs = spec[i]
        if name in _WIPES:
            j = i
            while j < n and spec[j][0] in _WIPES:
                j += 1
            pages = _run_unpaper_group(pages, spec[i:j])
            i = j
        else:
            if pages.dtype == jnp.uint32:
                pages = words_to_pages(pages)
            pages = _FILTERS[name](pages, **dict(kwargs))
            i += 1
    if in_words and pages.dtype == jnp.uint8:
        pages = pages_to_words(pages)
    return maybe_unbatch(pages, unb)


def compile_pipeline(spec: Iterable):
    """Return a jitted fn(pages) for the given pipeline spec."""
    spec = normalize_spec(spec)
    return lambda pages: run_pipeline(pages, spec)

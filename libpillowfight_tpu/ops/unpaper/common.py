"""Shared helpers for the unpaper filter family (SURVEY.md §2.2, §3.4).

The six unpaper filters all follow one pattern: block-wise darkness
statistics over sliding windows, followed by a conditional wipe (and for
black/noise filters, a flood fill). The statistics are strided
`reduce_window` sums — dense, regular, perfectly tiled by XLA — and the
wipes are elementwise selects, so the whole chain stays fused on-chip.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ...core import constants as C
from ...core.bitmap import (
    ensure_batched,
    maybe_unbatch,
    pages_to_words,
    wipe_white_words,
    words_to_gray,
    words_to_pages,
)


def apply_wipe(pages: jax.Array, wipe_fn, **kwargs) -> jax.Array:
    """Shared single-filter wrapper: uint8 RGBA [B,H,W,4] or uint32
    words [B,H,W] (or single page) in, same form out. Internally runs on
    u32 words (see bitmap.pages_to_words)."""
    pages, unb = ensure_batched(pages)
    in_words = pages.dtype == jnp.uint32
    words = pages if in_words else pages_to_words(pages)
    wipe = wipe_fn(words_to_gray(words), **kwargs)
    out = wipe_white_words(words, wipe)
    if not in_words:
        out = words_to_pages(out)
    return maybe_unbatch(out, unb)


def dark_mask(gray: jax.Array, threshold: float = C.UNPAPER_BLACK_THRESHOLD) -> jax.Array:
    """Pixels considered 'black': gray < threshold * 255 (unpaper semantics)."""
    return gray < (threshold * 255.0)


def nonwhite_mask(gray: jax.Array) -> jax.Array:
    """Pixels considered 'non-white': gray < 0.9 * 255 (unpaper white threshold)."""
    return gray < (C.UNPAPER_WHITE_THRESHOLD * 255.0)


def block_sums(x: jax.Array, size: int, step: int) -> jax.Array:
    """Strided window sums. x f32/bool [B,H,W] -> f32 [B,nby,nbx] where
    grid cell (i,j) covers pixels [i*step, i*step+size) x [j*step, j*step+size)
    (VALID windows only)."""
    y = jax.lax.reduce_window(
        x.astype(jnp.float32), 0.0, jax.lax.add,
        (1, size, 1), (1, step, 1), "VALID",
    )
    return jax.lax.reduce_window(
        y, 0.0, jax.lax.add, (1, 1, size), (1, 1, step), "VALID",
    )


def block_sums_u16(x: jax.Array, size: int, step: int) -> jax.Array:
    """Exact strided window sums for uint16 planes (e.g. s3 = r+g+b,
    values <= 765): the H stage reduces in uint16 (exact while
    size*765 < 65536, i.e. size <= 85), the W stage in f32 on the
    step-shrunk plane. Half the HBM traffic of the f32 block_sums and
    integer-exact. Returns f32 [B,nby,nbx]."""
    assert size * 765 < 65536, size
    y = jax.lax.reduce_window(
        x, jnp.uint16(0), jax.lax.add, (1, size, 1), (1, step, 1), "VALID",
    )
    return jax.lax.reduce_window(
        y.astype(jnp.float32), 0.0, jax.lax.add,
        (1, 1, size), (1, 1, step), "VALID",
    )


def _window_sel(n: int, size: int, step: int) -> jax.Array:
    """[n, nb] bf16 0/1 selection matrix: column i covers
    [i*step, i*step+size)."""
    import numpy as np

    nb = (n - size) // step + 1
    s = np.zeros((n, nb), np.float32)
    for i in range(nb):
        s[i * step : i * step + size, i] = 1.0
    return jnp.asarray(s, jnp.bfloat16)


def block_counts(x: jax.Array, size: int, step: int) -> jax.Array:
    """block_sums for 0/1 (bool) planes: the H pass is a matmul with a
    0/1 selection matrix when the block grid is short (nby <= 256) and a
    strided int8 reduce_window otherwise; the W pass is a matmul on the
    step-shrunk plane. Whether these contractions pay on the GPU is not
    measured yet (ROADMAP design item 3).

    Exact on every backend, the GPU's tensor cores included: the bf16
    operands are 0/1 values or window counts <= size <= 256, all exact
    bf16 integers; every product is exact; and the f32 accumulator is
    integer-exact far beyond any window count."""
    hn, wn = x.shape[1], x.shape[2]
    nby = (hn - size) // step + 1
    assert size <= 256  # intermediate sums must stay exact in bf16
    if nby <= 256:
        y = jax.lax.dot_general(
            x.astype(jnp.bfloat16), _window_sel(hn, size, step),
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)  # [B, W, nby]
        y = y.astype(jnp.bfloat16).transpose(0, 2, 1)  # [B, nby, W]
    else:
        # i8 accumulation (window counts <= size <= 127): a quarter of
        # the bytes of an f32 input plane, and the pred->i8 convert fuses
        assert size <= 127
        y = jax.lax.reduce_window(
            x.astype(jnp.int8), jnp.int8(0), jax.lax.add,
            (1, size, 1), (1, step, 1), "VALID",
        ).astype(jnp.bfloat16)  # [B, nby, W]
    return jax.lax.dot_general(
        y, _window_sel(wn, size, step),
        (((2,), (0,)), ((), ())), preferred_element_type=jnp.float32)


def line_counts(dark: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(row_counts [B,H], col_counts [B,W]) f32 dark-pixel counts.
    Integer sums, then f32: exact (counts are far below 2**24)."""
    d = dark.astype(jnp.int32)
    return (d.sum(axis=2).astype(jnp.float32),
            d.sum(axis=1).astype(jnp.float32))


def _trailing_or(x: jax.Array, size: int, axis: int) -> jax.Array:
    """out[i] = any(x[i-size+1 : i+1]) along axis. OR is idempotent, so
    doubling shifts give O(log size) passes instead of `size` taps."""
    if size <= 0:
        return jnp.zeros_like(x)
    ax = axis % x.ndim
    covered = 1
    while covered < size:
        s = min(covered, size - covered)
        pad = [(0, 0)] * x.ndim
        pad[ax] = (s, 0)
        idx = [slice(None)] * x.ndim
        idx[ax] = slice(0, x.shape[ax])
        x = x | jnp.pad(x, pad)[tuple(idx)]
        covered += s
    return x


def _expand_axis(g: jax.Array, n_pix: int, size: int, step: int,
                 axis: int) -> jax.Array:
    """Expand a selected-block grid along one axis to per-pixel coverage.

    Pixel p is covered iff a selected block *starts* at index i with
    i*step in [p-size+1, p], i.e. block index i in
    [q - taps(r) + 1, q] for q = p // step, r = p % step, and
    taps(r) = floor((size-1-r)/step) + 1. taps takes at most TWO values
    over a stride cell (hi at small r, lo at large r), so coverage =
    phase-select between two trailing-OR grids upsampled by `step` —
    all the OR work happens at block-grid resolution (~size/step taps on
    a W/step-wide plane) instead of a pixel-resolution doubling chain
    (~2 log(size) full-plane passes)."""
    ax = axis % g.ndim
    nb = g.shape[ax]
    q_n = (n_pix - 1) // step + 1
    if q_n > nb:  # pixels past the last block start: zero-pad the grid
        pad = [(0, 0)] * g.ndim
        pad[ax] = (0, q_n - nb)
        g = jnp.pad(g, pad)
    t_hi = (size - 1) // step + 1
    t_lo = max((size - step) // step + 1, 0) if size >= step else 0
    hi = jnp.repeat(_trailing_or(g, t_hi, ax), step, axis=ax)
    hi = jax.lax.slice_in_dim(hi, 0, n_pix, axis=ax)
    if t_lo == t_hi:
        return hi
    lo = jnp.repeat(_trailing_or(g, t_lo, ax), step, axis=ax)
    lo = jax.lax.slice_in_dim(lo, 0, n_pix, axis=ax)
    r = jax.lax.iota(jnp.int32, n_pix) % step
    is_hi = r <= (size - 1 - (t_hi - 1) * step)
    shape = [1] * g.ndim
    shape[ax] = n_pix
    return jnp.where(is_hi.reshape(shape), hi, lo)


def _expand_lanes_mm(g: jax.Array, n_pix: int, size: int, step: int
                     ) -> jax.Array:
    """Last-axis coverage expansion as ONE matmul with a 0/1 expansion
    matrix (phase-select folded in): out[..., x] = trailing-OR grid at
    x//step, picking the hi/lo tap count by the stride phase. Exact on
    the GPU's tensor cores too: 0/1 operands, and each output sums at
    most two 0/1 products."""
    import numpy as np

    ax = g.ndim - 1
    nb = g.shape[ax]
    q_n = (n_pix - 1) // step + 1
    if q_n > nb:
        pad = [(0, 0)] * g.ndim
        pad[ax] = (0, q_n - nb)
        g = jnp.pad(g, pad)
    t_hi = (size - 1) // step + 1
    t_lo = max((size - step) // step + 1, 0) if size >= step else 0
    hi = _trailing_or(g, t_hi, ax).astype(jnp.bfloat16)
    e_hi = np.zeros((q_n, n_pix), np.float32)
    for x in range(n_pix):
        r = x % step
        is_hi = r <= (size - 1 - (t_hi - 1) * step)
        if t_lo == t_hi or is_hi:
            e_hi[x // step, x] = 1.0
    # bf16 output: each pixel is covered by exactly one expansion-matrix
    # column, so values are exactly 0/1 — and an f32 result would
    # materialize a full-resolution 4 B/px plane before the compare
    out = jax.lax.dot_general(
        hi, jnp.asarray(e_hi, jnp.bfloat16), (((ax,), (0,)), ((), ())),
        preferred_element_type=jnp.bfloat16)
    if t_lo != t_hi:
        lo = _trailing_or(g, t_lo, ax).astype(jnp.bfloat16)
        e_lo = np.zeros((q_n, n_pix), np.float32)
        for x in range(n_pix):
            r = x % step
            if not (r <= (size - 1 - (t_hi - 1) * step)):
                e_lo[x // step, x] = 1.0
        out = out + jax.lax.dot_general(
            lo, jnp.asarray(e_lo, jnp.bfloat16), (((ax,), (0,)), ((), ())),
            preferred_element_type=jnp.bfloat16)
    return out > 0.5


def coverage_from_blocks(blocks: jax.Array, shape: tuple[int, int, int],
                         size: int, step: int) -> jax.Array:
    """Inverse of block_sums' footprint: bool grid [B,nby,nbx] -> bool pixel
    mask [B,H,W] true where the pixel is covered by any selected block.
    Separable: expand rows at grid width first (cheap), then columns via
    a matmul (see _expand_lanes_mm)."""
    b, h, w = shape
    rows = _expand_axis(blocks, h, size, step, 1)
    return _expand_lanes_mm(rows, w, size, step)


def wipe_white(pages: jax.Array, wipe: jax.Array) -> jax.Array:
    """Set RGB of wiped pixels to white, preserving alpha.
    pages uint8 [B,H,W,4], wipe bool [B,H,W]."""
    rgb = jnp.where(wipe[..., None], jnp.uint8(C.PF_WHITE), pages[..., :3])
    return jnp.concatenate([rgb, pages[..., 3:]], axis=-1)

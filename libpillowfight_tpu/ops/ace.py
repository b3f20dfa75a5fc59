"""ACE — Automatic Color Equalization (Rizzi et al.).

Ref: src/pillowfight/ace.c pf_ace — SURVEY.md §3.1. The reference samples
`nb_samples` random pixels per output pixel (O(W*H*S) random-access reads,
split across pthreads — the library's only threaded kernel).

Re-design, three estimators:

* ``mode="shared"`` (default): S sample positions are drawn per page and
  shared by every pixel. Each sample contributes one dense elementwise
  term (distance from a broadcast point + saturated difference), so no
  pixel gathers anything; on the GPU the S terms accumulate in registers
  inside one Pallas kernel (pallas/ace_kernel.py), one read of the page
  and one write. This is the Monte-Carlo "random spray"
  estimator with a shared spray; statistically it equalizes against the
  same global sample distribution the reference draws from.
* ``mode="rolled"`` (the compat default): per-pixel sampling by shared
  random *offsets*: sample s of pixel p is (p + D_s) mod (H, W) with
  D_s drawn uniform per step. Because D_s is uniform, every pixel's S
  samples are exactly i.i.d. uniform over the page — the per-pixel
  MARGINAL estimator distribution is identical to the reference's
  (unlike "shared", whose fixed spray correlates errors around sample
  points) — while the gather collapses to a dense jnp.roll per sample:
  S streaming sweeps, no random access. Cross-pixel joint correlation
  still differs from upstream's fully independent draws (PARITY.md #15).
* ``mode="per_pixel"``: fully independent per-pixel sampling via
  counter-based jax.random + flat gathers, chunked over samples to bound
  memory. Matches the reference's estimator exactly (up to RNG), at
  gather speed.

Parity: `ace_with_samples` takes explicit sample coordinates so the C++
oracle and the kernels can be fed identical samples (exact per-pixel
comparison, no RNG mismatch).

Per pixel p, channel c, values in 0..255:
    R_c(p)  = sum_s sat(slope * (I_c(p) - I_c(s))) / d(p, s)
    Rmax(p) = sum_s limit / d(p, s)
    n_c(p)  = R_c(p) / Rmax(p)                      in [-1, 1]
    out_c   = round(255 * (n_c - min_c) / (max_c - min_c))
where min_c/max_c are the per-page per-channel extrema of n_c (the
reference's final "rescale to [0,255]" white-point step, SURVEY.md §3.1);
sat(x) = clamp(x, -limit, limit), d = euclidean distance (min 1).
A degenerate channel (max == min, e.g. constant image) maps to 127.5.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import constants as C
from ..core.bitmap import ensure_batched, maybe_unbatch, to_uint8
from .pallas.ace_kernel import ace_spray


def _rescale(n: jax.Array) -> jax.Array:
    """Per-page per-channel min-max stretch of n [B,H,W,3] to uint8 [0,255].

    On a sharded batch this is a per-page reduction (no cross-page
    collectives needed); degenerate channels map to 127.5.
    """
    lo = jnp.min(n, axis=(1, 2), keepdims=True)
    hi = jnp.max(n, axis=(1, 2), keepdims=True)
    span = hi - lo
    stretched = jnp.where(span > 1e-9, 255.0 * (n - lo) / jnp.maximum(span, 1e-9), 127.5)
    return to_uint8(stretched)


def _sample_coords(key: jax.Array, b: int, s: int, h: int, w: int):
    ky, kx = jax.random.split(key)
    sy = jax.random.randint(ky, (b, s), 0, h, dtype=jnp.int32)
    sx = jax.random.randint(kx, (b, s), 0, w, dtype=jnp.int32)
    return sy, sx


def ace_with_samples(pages: jax.Array, sy: jax.Array, sx: jax.Array,
                     slope: float, limit: float) -> jax.Array:
    """Shared-sample ACE. pages uint8 [B,H,W,4]; sy/sx int32 [B,S]."""
    n = spray_scan(pages, sy, sx, slope, limit)
    return jnp.concatenate([_rescale(n), pages[..., 3:]], axis=-1)


def spray_scan(pages: jax.Array, sy: jax.Array, sx: jax.Array,
               slope: float, limit: float) -> jax.Array:
    """The normalized field n = num / den, f32 [B,H,W,3], as a lax.scan
    over the S shared samples (the plain reference of the spray kernel)."""
    b, h, w, _ = pages.shape
    s = sy.shape[1]
    rgb = pages[..., :3].astype(jnp.float32)  # [B,H,W,3]

    py = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0).astype(jnp.float32)
    px = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1).astype(jnp.float32)

    # sample values: [B,S,3]
    flat = rgb.reshape(b, h * w, 3)
    sval = jnp.take_along_axis(flat, (sy * w + sx)[..., None], axis=1)

    def body(carry, inputs):
        num, den = carry
        syk, sxk, svk = inputs  # [B], [B], [B,3]
        d = jnp.sqrt(
            (py[None] - syk[:, None, None].astype(jnp.float32)) ** 2
            + (px[None] - sxk[:, None, None].astype(jnp.float32)) ** 2
        )
        d = jnp.maximum(d, 1.0)[..., None]  # [B,H,W,1]
        delta = rgb - svk[:, None, None, :]
        num = num + jnp.clip(slope * delta, -limit, limit) / d
        den = den + limit / d
        return (num, den), None

    zeros = jnp.zeros((b, h, w, 3), jnp.float32)
    (num, den), _ = jax.lax.scan(
        body, (zeros, zeros),
        (jnp.moveaxis(sy, 1, 0), jnp.moveaxis(sx, 1, 0), jnp.moveaxis(sval, 1, 0)),
    )
    return num / den


def _pixel_sample_accum(rgb, flat, idx, slope, limit):
    """(num, den) contribution of per-pixel flat sample indices
    idx int32 [B,H,W,S] against rgb f32 [B,H,W,3] (flat = rgb reshaped
    [B,H*W,3])."""
    b, h, w, _ = rgb.shape
    py = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    px = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    s = idx.shape[-1]
    svals = jax.vmap(lambda f, i: f[i])(flat, idx.reshape(b, -1))
    svals = svals.reshape(b, h, w, s, 3)
    dy = (idx // w - py[None, :, :, None]).astype(jnp.float32)
    dx = (idx % w - px[None, :, :, None]).astype(jnp.float32)
    d = jnp.maximum(jnp.sqrt(dy * dy + dx * dx), 1.0)[..., None]
    delta = rgb[:, :, :, None, :] - svals
    num = jnp.sum(jnp.clip(slope * delta, -limit, limit) / d, axis=3)
    den = jnp.sum(limit / d, axis=3)
    return num, den


def ace_with_pixel_samples(pages: jax.Array, idx: jax.Array, slope: float,
                           limit: float) -> jax.Array:
    """Per-pixel-sample ACE with EXPLICIT flat sample indices
    idx int32 [B,H,W,S] (pixel (y,x) uses its own S samples) — the parity
    harness for mode="per_pixel": the C++ oracle
    (pf_oracle_ace_pixel_samples) consumes identical indices, making the
    comparison pure arithmetic with no RNG mismatch."""
    b, h, w, _ = pages.shape
    rgb = pages[..., :3].astype(jnp.float32)
    num, den = _pixel_sample_accum(rgb, rgb.reshape(b, h * w, 3), idx,
                                   slope, limit)
    return jnp.concatenate([_rescale(num / den), pages[..., 3:]], axis=-1)


def _ace_rolled(pages: jax.Array, key: jax.Array, nb_samples: int,
                slope: float, limit: float, chunk: int = 10) -> jax.Array:
    """Per-pixel-faithful sampling via shared random offsets (see module
    docstring): X_{p,s} = (p + D_s) mod (H, W), evaluated as one dense
    roll + elementwise pass per sample.

    Samples run `chunk` at a time inside each lax.scan step (sequential
    adds in the SAME order as one-per-step, bit-identical): the scan's
    (num, den) carries are 2x12 B/px that XLA reads+writes every step,
    so per-sample stepping moved ~96 B/px/sample of pure carry traffic
    — 4x the useful sample reads. Chunking divides it by `chunk`."""
    b, h, w, _ = pages.shape
    rgb = pages[..., :3].astype(jnp.float32)
    ky, kx = jax.random.split(key)
    dys = jax.random.randint(ky, (nb_samples, b), 0, h, dtype=jnp.int32)
    dxs = jax.random.randint(kx, (nb_samples, b), 0, w, dtype=jnp.int32)

    py = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    px = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)

    def contrib(carry, dy, dx):
        num, den = carry
        rolled = jax.vmap(
            lambda img, a, c: jnp.roll(img, (-a, -c), (0, 1)))(rgb, dy, dx)
        # signed displacement to the actual (wrapped) sample position
        ey = jnp.where(py[None] + dy[:, None, None] >= h,
                       dy[:, None, None] - h, dy[:, None, None])
        ex = jnp.where(px[None] + dx[:, None, None] >= w,
                       dx[:, None, None] - w, dx[:, None, None])
        d = jnp.maximum(jnp.sqrt((ey * ey + ex * ex).astype(jnp.float32)),
                        1.0)[..., None]
        delta = rgb - rolled
        num = num + jnp.clip(slope * delta, -limit, limit) / d
        den = den + limit / d
        return num, den

    k_eff = max(1, min(chunk, nb_samples))
    n_full = nb_samples // k_eff

    def body(carry, inp):
        dyk, dxk = inp  # [k_eff, B] each
        for i in range(k_eff):
            carry = contrib(carry, dyk[i], dxk[i])
        return carry, None

    zeros = jnp.zeros((b, h, w, 3), jnp.float32)
    carry = (zeros, zeros)
    if n_full:
        m = n_full * k_eff
        carry, _ = jax.lax.scan(
            body, carry,
            (dys[:m].reshape(n_full, k_eff, b),
             dxs[:m].reshape(n_full, k_eff, b)))
    for j in range(n_full * k_eff, nb_samples):  # remainder, unrolled
        carry = contrib(carry, dys[j], dxs[j])
    num, den = carry
    return jnp.concatenate([_rescale(num / den), pages[..., 3:]], axis=-1)


def _ace_per_pixel(pages: jax.Array, key: jax.Array, nb_samples: int,
                   slope: float, limit: float, chunk: int = 8) -> jax.Array:
    """Faithful per-pixel independent sampling (gather-based)."""
    b, h, w, _ = pages.shape
    rgb = pages[..., :3].astype(jnp.float32)
    flat = rgb.reshape(b, h * w, 3)

    n_chunks = -(-nb_samples // chunk)
    keys = jax.random.split(key, n_chunks)

    def body(carry, k):
        num, den = carry
        idx = jax.random.randint(k, (b, h, w, chunk), 0, h * w, dtype=jnp.int32)
        dn, dd = _pixel_sample_accum(rgb, flat, idx, slope, limit)
        return (num + dn, den + dd), None

    zeros = jnp.zeros((b, h, w, 3), jnp.float32)
    (num, den), _ = jax.lax.scan(body, (zeros, zeros), keys)
    return jnp.concatenate([_rescale(num / den), pages[..., 3:]], axis=-1)


def ace_with_samples_kernel(pages: jax.Array, sy: jax.Array, sx: jax.Array,
                            slope: float, limit: float,
                            interpret: bool = False) -> jax.Array:
    """`ace_with_samples` through the Pallas spray kernel
    (pallas/ace_kernel.py): one read of the page and one write of the
    normalized field, instead of the scan's S read-modify-write sweeps
    of (num, den). The sample gather and the rescale stay in XLA."""
    b, h, w, _ = pages.shape
    rgb = pages[..., :3].astype(jnp.float32)
    flat = rgb.reshape(b, h * w, 3)
    sval = jnp.take_along_axis(flat, (sy * w + sx)[..., None], axis=1)  # [B,S,3]
    n = ace_spray(jnp.moveaxis(rgb, -1, 1), sy, sx, jnp.moveaxis(sval, -1, 1),
                  float(slope), float(limit), interpret=interpret)
    return jnp.concatenate([_rescale(jnp.moveaxis(n, 1, -1)), pages[..., 3:]],
                           axis=-1)


def _ace_shared(pages, sy, sx, slope, limit):
    """Shared-spray ACE: the Triton kernel where the program is lowered
    for CUDA, the XLA scan everywhere else (the CPU has no Triton)."""
    return jax.lax.platform_dependent(
        pages, sy, sx,
        cuda=lambda p, y, x: ace_with_samples_kernel(p, y, x, slope, limit),
        default=lambda p, y, x: ace_with_samples(p, y, x, slope, limit))


def ace(
    pages: jax.Array,
    nb_samples: int = C.ACE_DEFAULT_NB_SAMPLES,
    slope: float = C.ACE_DEFAULT_SLOPE,
    limit: float = C.ACE_DEFAULT_LIMIT,
    seed: int | jax.Array = C.ACE_DEFAULT_SEED,
    mode: str = "shared",
    nb_threads: int = C.ACE_DEFAULT_NB_THREADS,  # API parity; ignored
) -> jax.Array:
    del nb_threads
    key = jax.random.PRNGKey(seed) if isinstance(seed, int) else seed
    return _ace_jit(pages, key, nb_samples, float(slope), float(limit), mode)


@partial(jax.jit, static_argnames=("nb_samples", "slope", "limit", "mode"))
def _ace_jit(pages, key, nb_samples, slope, limit, mode):
    pages, unb = ensure_batched(pages)
    b, h, w, _ = pages.shape
    if mode == "shared":
        sy, sx = _sample_coords(key, b, nb_samples, h, w)
        out = _ace_shared(pages, sy, sx, slope, limit)
    elif mode == "rolled":
        out = _ace_rolled(pages, key, nb_samples, slope, limit)
    elif mode == "per_pixel":
        out = _ace_per_pixel(pages, key, nb_samples, slope, limit)
    else:
        raise ValueError(f"unknown ace mode {mode!r}")
    return maybe_unbatch(out, unb)

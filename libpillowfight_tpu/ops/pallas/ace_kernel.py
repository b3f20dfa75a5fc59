"""ACE's spray accumulation as a Pallas kernel for NVIDIA GPUs (Triton route).

Ref: src/pillowfight/ace.c pf_ace hot loop (SURVEY.md §3.1) — O(W*H*S)
with random-access reads, split across pthreads in the reference.

The XLA twin (`ops.ace.ace_with_samples`) is a `lax.scan` over the S
samples whose (num, den) carries, 24 B/px of f32, go through device
memory on every sample: memory-bound by a wide margin. Here each program
owns one TILE_H x TILE_W tile of pixels, loads its three channels once,
loops over all S samples with the four accumulators held in registers,
and writes the normalized field n_c = num_c / den once. Programs are
independent (nothing carries between blocks), so many tiles are in
flight across the card. Each program loads its own (sy, sx, value)
sample scalars: Triton has no scalar prefetch.

Layout: planar f32 [B, 3, H, W]; sample coords i32 [B, S] and values
f32 [B, 3, S] are read whole. H and W need not be tile multiples: the
edge tiles mask their loads and stores. The sample gather and the
per-page white-point rescale stay in plain JAX (ops/ace.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Triton wants power-of-two tiles. 32x128 with 8 warps keeps the seven
# live [TILE_H, TILE_W] f32 tiles (3 channels + 4 accumulators) at
# ~112 registers per thread.
TILE_H = 32
TILE_W = 128
NUM_WARPS = 8


def _spray_kernel(sy_ref, sx_ref, sval_ref, img_ref, n_ref, *, h, w, slope,
                  limit, n_samples):
    b = pl.program_id(0)
    rows = pl.program_id(1) * TILE_H + jnp.arange(TILE_H, dtype=jnp.int32)
    cols = pl.program_id(2) * TILE_W + jnp.arange(TILE_W, dtype=jnp.int32)
    inside = (rows < h)[:, None] & (cols < w)[None, :]
    img = [plgpu.load(img_ref.at[c], mask=inside, other=0.0)
           for c in range(3)]
    # separable distance: dy lives on a column vector, dx on a row vector
    py = rows.astype(jnp.float32)[:, None]
    px = cols.astype(jnp.float32)[None, :]

    def body(s, carry):
        n0, n1, n2, invd = carry
        dy = py - sy_ref[b, s].astype(jnp.float32)
        dx = px - sx_ref[b, s].astype(jnp.float32)
        # d2 is an integer: 1/max(d, 1) == rsqrt(max(d2, 1))
        inv_d = jax.lax.rsqrt(jnp.maximum(dy * dy + dx * dx, 1.0))
        out = []
        for c, acc in enumerate((n0, n1, n2)):
            delta = jnp.clip(slope * (img[c] - sval_ref[b, c, s]),
                             -limit, limit)
            out.append(acc + delta * inv_d)
        return out[0], out[1], out[2], invd + inv_d

    zero = jnp.zeros((TILE_H, TILE_W), jnp.float32)
    *num, invd = jax.lax.fori_loop(0, n_samples, body,
                                   (zero, zero, zero, zero))
    den = limit * invd
    for c in range(3):
        plgpu.store(n_ref.at[c], num[c] / den, mask=inside)


@functools.partial(jax.jit, static_argnames=("slope", "limit", "interpret"))
def ace_spray(planar: jax.Array, sy: jax.Array, sx: jax.Array,
              sval: jax.Array, slope: float, limit: float,
              interpret: bool = False) -> jax.Array:
    """planar f32 [B,3,H,W]; sy/sx i32 [B,S]; sval f32 [B,3,S].

    Returns n f32 [B,3,H,W] = num_c / den with
      num_c = sum_s clip(slope*(I_c - I_c(s)), +-limit) / d(p,s)
      den   = sum_s limit / d(p,s)           (d = euclidean, min 1)
    `interpret=True` runs the kernel through the Pallas interpreter
    (the CPU test path); otherwise it compiles through Triton.
    """
    b, _, h, w = planar.shape
    kernel = functools.partial(
        _spray_kernel, h=h, w=w, slope=float(slope), limit=float(limit),
        n_samples=sy.shape[1])
    tile = pl.BlockSpec((None, 3, TILE_H, TILE_W),
                        lambda b, i, j: (b, 0, i, j))
    whole = pl.BlockSpec()
    return pl.pallas_call(
        kernel,
        grid=(b, pl.cdiv(h, TILE_H), pl.cdiv(w, TILE_W)),
        in_specs=[whole, whole, whole, tile],
        out_specs=tile,
        out_shape=jax.ShapeDtypeStruct(planar.shape, jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="ace_spray",
    )(sy, sx, sval, planar)

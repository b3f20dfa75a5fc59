"""Gaussian blur (ref: src/pillowfight/gaussian.c pf_gaussian — SURVEY.md §2.2).

Separable 1-D Gaussian applied per RGB channel; alpha passes through.
The reference convolves rows, transposes, convolves again; here the two
rank-1 convs run directly with no materialized transpose and XLA fuses
the uint8<->f32 conversions into the conv loops.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import constants as C
from ..core.bitmap import ensure_batched, maybe_unbatch, to_uint8
from .conv import gaussian_kernel_1d, sep_conv2d


@partial(jax.jit, static_argnames=("sigma", "nb_stddev"))
def gaussian(
    pages: jax.Array,
    sigma: float = C.GAUSSIAN_DEFAULT_SIGMA,
    nb_stddev: int = C.GAUSSIAN_DEFAULT_NB_STDDEV,
) -> jax.Array:
    """uint8 RGBA [B,H,W,4] -> blurred uint8 RGBA [B,H,W,4]."""
    pages, unb = ensure_batched(pages)
    rgb = pages[..., :3].astype(jnp.float32)
    # vectorize the separable conv over the 3 channels via one reshape:
    b, h, w, _ = rgb.shape
    planes = jnp.moveaxis(rgb, -1, 1).reshape(b * 3, h, w)
    blurred = sep_conv2d(planes, gaussian_kernel_1d(sigma, nb_stddev))
    out_rgb = to_uint8(jnp.moveaxis(blurred.reshape(b, 3, h, w), 1, -1))
    out = jnp.concatenate([out_rgb, pages[..., 3:]], axis=-1)
    return maybe_unbatch(out, unb)


def gaussian_on_matrix(
    gray: jax.Array,
    sigma: float = C.GAUSSIAN_DEFAULT_SIGMA,
    nb_stddev: int = C.GAUSSIAN_DEFAULT_NB_STDDEV,
) -> jax.Array:
    """f32 [B,H,W] -> f32 [B,H,W]; internal helper reused by canny/swt
    (ref: gaussian.c pf_gaussian_on_matrix)."""
    return sep_conv2d(gray, gaussian_kernel_1d(sigma, nb_stddev))

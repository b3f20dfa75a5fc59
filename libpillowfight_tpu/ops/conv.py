"""Shared convolution primitives for the stencil kernels.

Replacement for the reference's direct 2-D convolution
(ref: src/pillowfight/util.c pf_dbl_matrix_convolution / _transpose —
SURVEY.md §2.1). Boundary semantics are pinned to the oracle: zero padding,
true convolution (kernel flipped), output same size as input.

Gray planes are f32 [B, H, W]. Small and separable stencils run as
unrolled shifted multiply-adds, which XLA fuses with their producers and
consumers; only a large dense kernel reaches lax.conv (NCHW, C=1).
Separable filters run as two rank-1 passes (row then column) — the same
factorization the reference uses (conv, transpose, conv), minus the
materialized transpose.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_DN = ("NCHW", "OIHW", "NCHW")


_SHIFT_MAX_TAPS = 32  # small stencils lower to shifted adds, not lax.conv


def _shift2(x: jax.Array, dy: int, dx: int) -> jax.Array:
    """out[y, x] = x[y + dy, x + dx] over the last two dims, zero outside."""
    h, w = x.shape[-2:]
    pad = [(0, 0)] * (x.ndim - 2) + [(abs(dy), abs(dy)), (abs(dx), abs(dx))]
    p = jnp.pad(x, pad)
    return p[..., abs(dy) + dy : abs(dy) + dy + h,
             abs(dx) + dx : abs(dx) + dx + w]


def _conv_shifts(x: jax.Array, kernel: np.ndarray) -> jax.Array:
    """Correlation as an unrolled chain of shifted multiply-adds (taps in
    row-major order, skipping zeros). Pure elementwise — fuses with
    producers/consumers, and a single-plane conv has too little work per
    output to feed a convolution library."""
    kh, kw = kernel.shape
    out = None
    for i in range(kh):
        for j in range(kw):
            c = float(kernel[i, j])
            if c == 0.0:
                continue
            term = _shift2(x, i - kh // 2, j - kw // 2)
            term = term if c == 1.0 else term * x.dtype.type(c)
            out = term if out is None else out + term
    return out if out is not None else jnp.zeros_like(x)


def _static_taps(kernel):
    """Kernel taps as a host numpy array, or None if traced (a traced
    kernel cannot take the unrolled static-shift path)."""
    if isinstance(kernel, np.ndarray):
        return kernel
    try:
        return np.asarray(kernel)
    except Exception:
        return None


def _conv(x: jax.Array, kernel) -> jax.Array:
    """f32 [B,H,W] (*) kernel [kh,kw] -> f32 [B,H,W], zero-padded SAME conv.

    True convolution: the kernel is flipped to match the reference's
    pf_dbl_matrix_convolution semantics.
    """
    taps = _static_taps(kernel)
    kh, kw = kernel.shape
    if taps is not None and (kh * kw <= _SHIFT_MAX_TAPS or min(kh, kw) == 1):
        return _conv_shifts(x, np.flip(taps, (0, 1)))
    k = jnp.flip(jnp.asarray(kernel), (0, 1)).reshape(1, 1, kh, kw).astype(x.dtype)
    y = jax.lax.conv_general_dilated(
        x[:, None], k, window_strides=(1, 1),
        padding=((kh // 2, (kh - 1) // 2), (kw // 2, (kw - 1) // 2)),
        dimension_numbers=_DN,
        # f32 convs may otherwise run in TF32 on the GPU (~3 digits),
        # which breaks the <= 1 LSB parity pin
        precision=jax.lax.Precision.HIGHEST,
    )
    return y[:, 0]


def conv2d(x: jax.Array, kernel) -> jax.Array:
    return _conv(x, kernel)


def correlate2d(x: jax.Array, kernel) -> jax.Array:
    """Cross-correlation (no kernel flip): out[p] = sum_k x[p+k]*kernel[k].

    Used by sobel so the gradient points from dark to light (standard
    convention; for the antisymmetric Sobel taps, true convolution would
    flip the sign)."""
    taps = _static_taps(kernel)
    if taps is not None:
        return _conv(x, np.flip(taps, (0, 1)))
    return _conv(x, jnp.flip(jnp.asarray(kernel), (0, 1)))


def sep_conv2d(x: jax.Array, k1d) -> jax.Array:
    """Separable filter: rows then columns with the same 1-D kernel."""
    taps = _static_taps(k1d)
    k = taps if taps is not None else jnp.asarray(k1d)
    y = _conv(x, k[None, :])   # along W
    return _conv(y, k[:, None])  # along H


def gaussian_kernel_1d(sigma: float, nb_stddev: int) -> np.ndarray:
    """1-D Gaussian taps, half-width ceil(sigma*nb_stddev), sum-normalized."""
    hw = int(np.ceil(float(sigma) * int(nb_stddev)))
    xs = np.arange(-hw, hw + 1, dtype=np.float64)
    k = np.exp(-(xs**2) / (2.0 * float(sigma) ** 2))
    return (k / k.sum()).astype(np.float32)


SOBEL_GX = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], np.float32)
SOBEL_GY = SOBEL_GX.T.copy()

"""Gaussian / Sobel kernels: closed-form and invariance tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from libpillowfight_tpu.ops.gaussian import gaussian, gaussian_on_matrix
from libpillowfight_tpu.ops.sobel import sobel, sobel_on_matrix


def _rgba(gray2d):
    g = np.asarray(gray2d, np.uint8)
    return np.stack([g, g, g, np.full_like(g, 255)], axis=-1)


def test_gaussian_constant_invariant():
    page = _rgba(np.full((40, 48), 180))
    out = np.asarray(gaussian(jnp.asarray(page)))
    # interior is exactly preserved (border darkens from zero padding)
    assert np.all(out[15:-15, 15:-15, :3] == 180)
    assert np.all(out[..., 3] == 255)


def test_gaussian_impulse_is_kernel():
    g = np.zeros((41, 41), np.float32)
    g[20, 20] = 255.0
    out = gaussian_on_matrix(jnp.asarray(g)[None], 2.0, 5)
    out = np.asarray(out[0])
    from libpillowfight_tpu.ops.conv import gaussian_kernel_1d

    k = gaussian_kernel_1d(2.0, 5)  # 21 taps (hw=10)
    want = np.zeros((41, 41), np.float32)
    want[10:31, 10:31] = 255.0 * np.outer(k, k)
    np.testing.assert_allclose(out, want, atol=1e-3)


def test_gaussian_smooths_noise(rng):
    noisy = _rgba(rng.integers(0, 255, (64, 64)))
    out = np.asarray(gaussian(jnp.asarray(noisy)))
    assert out[..., 0].std() < noisy[..., 0].std() * 0.5


def test_sobel_vertical_edge():
    g = np.zeros((32, 32), np.float32)
    g[:, 16:] = 255.0
    grad = sobel_on_matrix(jnp.asarray(g)[None])
    inten = np.asarray(grad.intensity[0])
    direc = np.asarray(grad.direction[0])
    # gradient concentrated at the edge columns, pointing along +x
    assert inten[16, 15] > 0 and inten[16, 16] > 0
    assert np.all(inten[5:-5, 3:12] == 0)
    assert abs(direc[16, 15]) < 1e-3  # atan2(0, positive) = 0


def test_sobel_public_op(page):
    out = np.asarray(sobel(jnp.asarray(page)))
    assert out.shape == page.shape and out.dtype == np.uint8
    # r == g == b (grayscale), alpha opaque
    assert np.array_equal(out[..., 0], out[..., 1])
    assert np.all(out[..., 3] == 255)
    # uniform regions are zero; edges are bright
    assert out[..., 0].max() == 255


def _numpy_sep_blur(g, sigma, nb_stddev):
    """Zero-padded separable gaussian in float64: rows, then columns."""
    hw = int(np.ceil(sigma * nb_stddev))
    xs = np.arange(-hw, hw + 1, dtype=np.float64)
    k = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    k /= k.sum()
    p = np.pad(g.astype(np.float64), ((0, 0), (hw, hw), (hw, hw)))
    h, w = g.shape[1:]
    rows = sum(k[i] * p[:, :, i : i + w] for i in range(2 * hw + 1))
    return sum(k[i] * rows[:, i : i + h, :] for i in range(2 * hw + 1))


@pytest.mark.parametrize("sigma,nb_stddev,shape", [
    (2.0, 5, (2, 150, 170)),   # canny/swt's blur
    (0.8, 3, (1, 64, 130)),    # a short kernel
])
def test_gaussian_on_matrix_matches_numpy(rng, sigma, nb_stddev, shape):
    x = (rng.standard_normal(shape) * 100).astype(np.float32)
    got = np.asarray(gaussian_on_matrix(jnp.asarray(x), sigma, nb_stddev))
    want = _numpy_sep_blur(x, sigma, nb_stddev)
    np.testing.assert_allclose(got, want, atol=2e-3)

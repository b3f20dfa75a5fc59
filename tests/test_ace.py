"""ACE: numpy-oracle comparison with explicit samples + statistical checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libpillowfight_tpu.ops.ace import ace, ace_with_samples


def _numpy_ace_shared(page, sy, sx, slope, limit):
    """Direct transcription of the ACE estimator (SURVEY.md §3.1) with
    shared per-page samples; float64 reference."""
    rgb = page[..., :3].astype(np.float64)
    h, w, _ = rgb.shape
    ys, xs = np.mgrid[0:h, 0:w]
    num = np.zeros((h, w, 3))
    den = np.zeros((h, w, 3))
    for y0, x0 in zip(sy, sx):
        d = np.sqrt((ys - y0) ** 2 + (xs - x0) ** 2)
        d = np.maximum(d, 1.0)[..., None]
        delta = rgb - rgb[y0, x0]
        num += np.clip(slope * delta, -limit, limit) / d
        den += limit / d
    n = num / den
    lo = n.min(axis=(0, 1), keepdims=True)
    hi = n.max(axis=(0, 1), keepdims=True)
    span = hi - lo
    out = np.where(span > 1e-9, 255.0 * (n - lo) / np.maximum(span, 1e-9), 127.5)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def test_ace_matches_numpy_oracle(rng, page):
    s = 16
    sy = rng.integers(0, page.shape[0], s).astype(np.int32)
    sx = rng.integers(0, page.shape[1], s).astype(np.int32)
    got = np.asarray(
        ace_with_samples(
            jnp.asarray(page)[None], jnp.asarray(sy)[None], jnp.asarray(sx)[None],
            slope=10.0, limit=1000.0,
        )[0]
    )
    want = _numpy_ace_shared(page, sy, sx, 10.0, 1000.0)
    # f32 vs f64 rounding can flip a borderline LSB
    assert np.abs(got[..., :3].astype(int) - want[..., :3].astype(int)).max() <= 1


def test_ace_constant_image_maps_to_mid():
    page = np.full((32, 32, 4), 77, np.uint8)
    page[..., 3] = 255
    out = np.asarray(ace(jnp.asarray(page), nb_samples=8))
    assert np.all(np.abs(out[..., :3].astype(int) - 128) <= 1)


def test_ace_increases_contrast(page):
    out = np.asarray(ace(jnp.asarray(page), nb_samples=32))
    assert out[..., :3].min() <= 5 and out[..., :3].max() >= 250


def test_ace_deterministic_seed(page):
    a = np.asarray(ace(jnp.asarray(page), nb_samples=16, seed=7))
    b = np.asarray(ace(jnp.asarray(page), nb_samples=16, seed=7))
    np.testing.assert_array_equal(a, b)


def test_ace_per_pixel_mode(page):
    out = np.asarray(ace(jnp.asarray(page), nb_samples=16, mode="per_pixel"))
    assert out.shape == page.shape
    # same qualitative behavior: full-range stretch
    assert out[..., :3].min() <= 5 and out[..., :3].max() >= 250


def test_ace_batched_independent(rng, page):
    other = rng.integers(0, 255, page.shape, np.uint8)
    pages = jnp.asarray(np.stack([page, other]))
    out = np.asarray(ace(pages, nb_samples=16))
    assert out.shape == pages.shape


def test_ace_rolled_matches_explicit_pixel_samples(rng, page):
    """mode='rolled' arithmetic pinned: with the same offsets, rolled
    must equal the explicit per-pixel-sample path with
    idx[p, s] = ((p + D_s) mod (H, W)) flattened."""
    import jax
    from libpillowfight_tpu.ops.ace import _ace_rolled, ace_with_pixel_samples

    h, w, _ = page.shape
    s = 7
    key = jax.random.PRNGKey(11)
    ky, kx = jax.random.split(key)
    dys = np.asarray(jax.random.randint(ky, (s, 1), 0, h, dtype=jnp.int32))
    dxs = np.asarray(jax.random.randint(kx, (s, 1), 0, w, dtype=jnp.int32))
    got = np.asarray(_ace_rolled(jnp.asarray(page)[None], key, s,
                                 10.0, 1000.0)[0])
    py, px = np.mgrid[0:h, 0:w]
    idx = np.zeros((h, w, s), np.int32)
    for j in range(s):
        idx[..., j] = ((py + int(dys[j, 0])) % h) * w + (px + int(dxs[j, 0])) % w
    want = np.asarray(ace_with_pixel_samples(
        jnp.asarray(page)[None], jnp.asarray(idx)[None], 10.0, 1000.0)[0])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b,h,w,s", [
    (1, 45, 150, 7),    # one tile row, width not a tile multiple
    (2, 70, 260, 12),   # several tiles per axis, ragged edges
    (1, 17, 33, 5),     # smaller than one tile
])
def test_ace_spray_kernel_interpret_matches_scan(rng, b, h, w, s):
    """The Triton spray kernel, run by the Pallas interpreter, against the
    XLA scan on identical samples: the normalized field n within f32
    rounding (rsqrt vs sqrt+divide), the uint8 output within 1 LSB, and
    the output shape and alpha untouched at edge-tile shapes."""
    from libpillowfight_tpu.ops.ace import ace_with_samples_kernel, spray_scan
    from libpillowfight_tpu.ops.pallas.ace_kernel import ace_spray

    pages = rng.integers(0, 256, (b, h, w, 4), dtype=np.uint8)
    sy = jnp.asarray(rng.integers(0, h, (b, s)).astype(np.int32))
    sx = jnp.asarray(rng.integers(0, w, (b, s)).astype(np.int32))
    x = jnp.asarray(pages)
    rgb = x[..., :3].astype(jnp.float32)
    sval = jnp.take_along_axis(rgb.reshape(b, h * w, 3),
                               (sy * w + sx)[..., None], axis=1)
    n = ace_spray(jnp.moveaxis(rgb, -1, 1), sy, sx, jnp.moveaxis(sval, -1, 1),
                  10.0, 1000.0, interpret=True)
    assert n.shape == (b, 3, h, w)
    np.testing.assert_allclose(
        np.moveaxis(np.asarray(n), 1, -1),
        np.asarray(spray_scan(x, sy, sx, 10.0, 1000.0)), atol=1e-5)

    got = np.asarray(ace_with_samples_kernel(x, sy, sx, 10.0, 1000.0,
                                             interpret=True))
    want = np.asarray(ace_with_samples(x, sy, sx, 10.0, 1000.0))
    assert got.shape == pages.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got[..., 3], pages[..., 3])
    assert np.abs(got[..., :3].astype(int) - want[..., :3].astype(int)).max() <= 1

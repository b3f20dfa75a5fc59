"""Golden tests: JAX kernels vs the C++ oracle, per-pixel.

Parity contract (PARITY.md): <=1 LSB for linear filters; structural
filters (flood/CC/strip scans are discrete decisions) must match
near-exactly — we allow a tiny fraction of boundary pixels to differ to
absorb f32-vs-f64 threshold rounding, and assert IoU >= 0.99 on the
wiped-region masks.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from libpillowfight_tpu.ops.ace import ace_with_samples
from libpillowfight_tpu.ops.canny import canny
from libpillowfight_tpu.ops.gaussian import gaussian
from libpillowfight_tpu.ops.sobel import sobel
from libpillowfight_tpu.core import bitmap
from libpillowfight_tpu.ops import unpaper
from libpillowfight_tpu.utils import oracle

pytestmark = pytest.mark.skipif(not oracle.available(), reason="oracle not built")


def _scanlike(rng, h=140, w=180):
    g = np.full((h, w), 245, np.uint8)
    g[:, :7] = 0
    for y0 in range(20, h - 20, 25):
        g[y0 : y0 + 3, 30 : w - 30] = 15
    g[100:120, 20:60] = 200
    ys = rng.integers(5, h - 5, 25)
    xs = rng.integers(10, w - 5, 25)
    g[ys, xs] = 35
    return np.stack([g, g, g, np.full_like(g, 255)], axis=-1)


def _lsb_diff(a, b):
    return np.abs(a[..., :3].astype(int) - b[..., :3].astype(int)).max()


def test_gaussian_vs_oracle(rng, page):
    want = oracle.gaussian(page, 2.0, 5)
    got = np.asarray(gaussian(jnp.asarray(page), 2.0, 5))
    assert _lsb_diff(got, want) <= 1


def test_sobel_vs_oracle(rng, page):
    want = oracle.sobel(page)
    got = np.asarray(sobel(jnp.asarray(page)))
    assert _lsb_diff(got, want) <= 1


def test_canny_vs_oracle(rng):
    page = _scanlike(rng)
    want = oracle.canny(page)[..., 0] > 0
    got = np.asarray(canny(jnp.asarray(page)))[..., 0] > 0
    # NMS runs on the normalized integer intensity grid on both sides,
    # so edge decisions are precision-independent: near-exact parity.
    # The 0.1% allowance covers the rare pixel whose normalized
    # intensity sits within f32 error of a .5 rounding boundary.
    ndiff = int((got != want).sum())
    assert ndiff <= max(0.001 * want.sum(), 2), (ndiff, int(want.sum()))


def test_ace_vs_oracle_identical_samples(rng, page):
    s = 24
    sy = rng.integers(0, page.shape[0], s).astype(np.int32)
    sx = rng.integers(0, page.shape[1], s).astype(np.int32)
    want = oracle.ace_samples(page, sy, sx, 10.0, 1000.0)
    got = np.asarray(ace_with_samples(
        jnp.asarray(page)[None], jnp.asarray(sy)[None], jnp.asarray(sx)[None],
        10.0, 1000.0)[0])
    assert _lsb_diff(got, want) <= 1


def _iou_wiped(a_in, a_out, b_out):
    wa = (a_out[..., :3] != a_in[..., :3]).any(-1)
    wb = (b_out[..., :3] != a_in[..., :3]).any(-1)
    union = (wa | wb).sum()
    if union == 0:
        return 1.0
    return (wa & wb).sum() / union


def _text_page(h=96, w=128):
    """Bar-'letters' of consistent stroke width on white + gray shading."""
    g = np.full((h, w), 255, np.uint8)
    for x0 in (20, 40, 60, 80):
        g[25:75, x0 : x0 + 6] = 0  # vertical strokes, width 6, height 50
    g[80:92, 8:40] = 210  # light shading the letter filters must ignore
    return np.stack([g, g, g, np.full_like(g, 255)], axis=-1)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_swt_vs_oracle(mode):
    """SWT letter masks pinned against pf_oracle_swt (ref: swt.c, the
    reference's largest kernel — SURVEY.md §2.2) for all 3 output modes."""
    from libpillowfight_tpu.ops.swt import swt

    page = _text_page()
    want = oracle.swt(page, mode)
    got = np.asarray(swt(jnp.asarray(page), mode))
    if mode == 2:
        # per-letter red boxes: 1-px localization tolerance both ways plus
        # a <=2% stray allowance (quantized digital rays can grow a
        # component's bbox by one pixel vs the oracle's continuous rays)
        import scipy.ndimage

        wr = (want[..., 0] == 255) & (want[..., 1] == 0) & (want[..., 2] == 0)
        gr = (got[..., 0] == 255) & (got[..., 1] == 0) & (got[..., 2] == 0)
        assert wr.sum() > 0 and gr.sum() > 0
        dil = np.ones((3, 3), bool)
        stray_got = (gr & ~scipy.ndimage.binary_dilation(wr, dil)).sum()
        stray_want = (wr & ~scipy.ndimage.binary_dilation(gr, dil)).sum()
        assert stray_got <= 0.02 * gr.sum(), (stray_got, gr.sum())
        assert stray_want <= 0.02 * wr.sum(), (stray_want, wr.sum())
    else:
        wm = (want[..., :3] != 255).any(-1)
        gm = (got[..., :3] != 255).any(-1)
        union = (wm | gm).sum()
        iou = (wm & gm).sum() / max(union, 1)
        assert wm.sum() > 0, "oracle found no text on the text page"
        assert iou >= 0.99, f"swt mode {mode} letter-mask IoU {iou:.4f}"
        if mode == 1:
            # gray values must agree exactly where both sides agree the
            # pixel is a letter (disagreement pixels are covered by IoU)
            both = wm & gm
            d = np.abs(got[..., :3].astype(int) - want[..., :3].astype(int))
            assert d[both].max() <= 1


@pytest.mark.parametrize("name,jax_fn", [
    ("blackfilter", unpaper.unpaper_blackfilter),
    ("noisefilter", unpaper.unpaper_noisefilter),
    ("blurfilter", unpaper.unpaper_blurfilter),
    ("grayfilter", unpaper.unpaper_grayfilter),
    ("border", unpaper.unpaper_border),
    ("masks", unpaper.unpaper_masks),
])
def test_unpaper_vs_oracle(rng, name, jax_fn):
    page = _scanlike(rng, h=220, w=260)
    want = getattr(oracle, name)(page)
    got = np.asarray(jax_fn(jnp.asarray(page)))
    iou = _iou_wiped(page, got, want)
    assert iou >= 0.99, f"{name} wiped-region IoU {iou:.4f}"
    n, _ = bitmap.compare(jnp.asarray(got)[None], jnp.asarray(want)[None])
    frac = int(n[0]) / (page.shape[0] * page.shape[1])
    assert frac < 0.01, f"{name} pixel mismatch fraction {frac:.4%}"


def test_masks_multi_start_vs_oracle():
    """Multiple user start points (ref: masks.c scan points — SURVEY.md
    §2.2 masks row): kept area is the union of per-start rectangles."""
    h, w = 220, 260
    g = np.full((h, w), 245, np.uint8)
    # two separated content clusters with a blank band between them
    for y0 in range(20, 70, 12):
        g[y0 : y0 + 3, 20:100] = 15
    for y0 in range(150, 200, 12):
        g[y0 : y0 + 3, 150:240] = 15
    page = np.stack([g, g, g, np.full_like(g, 255)], axis=-1)
    starts = ((45, 60), (175, 195))
    want = oracle.masks_multi(page, starts)
    got = np.asarray(unpaper.unpaper_masks(jnp.asarray(page), starts=starts))
    iou = _iou_wiped(page, got, want)
    assert iou >= 0.99, f"multi-start masks wiped-region IoU {iou:.4f}"
    # multi-start must keep BOTH clusters; the center-only default, whose
    # center sits in the blank band, must not be what we produced
    center_only = np.asarray(unpaper.unpaper_masks(jnp.asarray(page)))
    assert not np.array_equal(got, center_only)
    n, _ = bitmap.compare(jnp.asarray(got)[None], jnp.asarray(want)[None])
    assert int(n[0]) / (h * w) < 0.01


def _color_page(h=96, w=120):
    """Color gradients + blocks: exercises ACE's chromatic correction."""
    y = np.linspace(0, 255, h, dtype=np.float32)[:, None]
    x = np.linspace(0, 255, w, dtype=np.float32)[None, :]
    r = np.broadcast_to(x, (h, w))
    g = np.broadcast_to(y, (h, w))
    b = np.full((h, w), 128, np.float32)
    page = np.stack([r, g, b, np.full((h, w), 255, np.float32)], -1)
    page[20:40, 20:50, :3] = (200, 60, 40)
    page[60:80, 70:110, :3] = (30, 90, 220)
    return page.astype(np.uint8)


def test_ace_per_pixel_vs_oracle_identical_samples(rng):
    """mode='per_pixel' arithmetic pinned: both sides consume IDENTICAL
    per-pixel sample indices (SURVEY §7 hard-part 3 fixed-seed oracle
    mode), so the comparison is exact, no RNG involved."""
    from libpillowfight_tpu.ops.ace import ace_with_pixel_samples

    page = _color_page()
    h, w, _ = page.shape
    s = 12
    idx = rng.integers(0, h * w, (h, w, s)).astype(np.int32)
    want = oracle.ace_pixel_samples(page, idx, 10.0, 1000.0)
    got = np.asarray(ace_with_pixel_samples(
        jnp.asarray(page)[None], jnp.asarray(idx)[None], 10.0, 1000.0)[0])
    assert _lsb_diff(got, want) <= 1


def test_ace_distributional_vs_oracle():
    """Both JAX estimators (shared spray, per-pixel) must match the
    reference-faithful random estimator's output DISTRIBUTION (channel
    mean/std), since per-draw RNG cannot match (SURVEY §7 hard-part 3)."""
    from libpillowfight_tpu.ops.ace import ace

    page = _color_page()
    want = np.stack([oracle.ace_rand(page, 60, 10.0, 1000.0, seed)
                     for seed in range(5)]).astype(np.float64)
    wm = want[..., :3].mean(axis=(0, 1, 2))
    ws = want[..., :3].std(axis=(0, 1, 2))
    # the faithful estimator must sit right on the reference distribution;
    # the shared spray is a documented approximation (PARITY.md #15) whose
    # correlated sampling widens the post-stretch spread — measured on
    # this page: mean delta <= 7.0/255, std within 14.7%; bounds carry
    # modest seed headroom over those measurements.
    # "rolled" has exactly-faithful per-pixel marginals (uniform offsets
    # -> i.i.d. uniform samples per pixel; verified exact vs the explicit
    # per-pixel-sample harness), but the final min-max stretch couples
    # pixels through the page extrema, where its residual cross-pixel
    # correlation shows: measured drift <= 5.3/255 mean, <= 23% std at
    # S=60 — between per_pixel and shared
    tol = {"per_pixel": (3.0, 0.05), "rolled": (6.5, 0.30),
           "shared": (7.5, 0.20)}
    for mode in ("shared", "rolled", "per_pixel"):
        got = np.stack([
            np.asarray(ace(jnp.asarray(page), nb_samples=60, seed=seed,
                           mode=mode))
            for seed in range(5)
        ]).astype(np.float64)
        gm = got[..., :3].mean(axis=(0, 1, 2))
        gs = got[..., :3].std(axis=(0, 1, 2))
        mean_tol, std_tol = tol[mode]
        assert np.abs(gm - wm).max() < mean_tol, (mode, gm, wm)
        assert np.abs(gs / ws - 1.0).max() < std_tol, (mode, gs, ws)


def _a4_scan(rng):
    """A4 300dpi scan-textured page: black border with leap-size gaps,
    text lines, gray bleed-through, pepper noise — bench-shape parity so
    tile/halo/padding bugs surface here, not on the bench."""
    h, w = 3508 // 2, 2480  # half-height A4 keeps CPU golden runs tractable
    g = rng.normal(241.0, 3.0, (h, w)).astype(np.float32)
    g = np.clip(g, 230, 252).astype(np.uint8)
    g[:, :55] = 0
    g[:180, :] = 0
    g[60:75, 20:40] = 255          # gap in the border (leap target)
    for y0 in range(320, h - 200, 60):
        g[y0 : y0 + 4, 300 : w - 300] = 12
    g[h // 2 : h // 2 + 160, 150 : 420] = 205
    ys = rng.integers(200, h - 5, 900)
    xs = rng.integers(70, w - 5, 900)
    g[ys, xs] = 25
    return np.stack([g, g, g, np.full_like(g, 255)], axis=-1)


@pytest.mark.parametrize("name", [
    "gaussian", "sobel",
    "blackfilter", "noisefilter", "blurfilter", "grayfilter",
    "border", "masks",
])
def test_a4_golden(rng, name):
    page = _a4_scan(rng)
    if name == "gaussian":
        want = oracle.gaussian(page, 2.0, 5)
        got = np.asarray(gaussian(jnp.asarray(page), 2.0, 5))
        assert _lsb_diff(got, want) <= 1
        return
    if name == "sobel":
        want = oracle.sobel(page)
        got = np.asarray(sobel(jnp.asarray(page)))
        assert _lsb_diff(got, want) <= 1
        return
    want = getattr(oracle, name)(page)
    got = np.asarray(getattr(unpaper, f"unpaper_{name}")(jnp.asarray(page)))
    iou = _iou_wiped(page, got, want)
    assert iou >= 0.99, f"{name} A4 wiped-region IoU {iou:.4f}"

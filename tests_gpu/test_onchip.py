"""The compiled program on the card, at production shapes.

Four classes of assertion:
  1. memory guards — the fused cleanup chain and each heavy filter must
     compile with a bounded temp footprint at the bench shape (A4 x 16),
     so a regression of that class fails at compile time, before any run.
  2. exactness at scale — the flood, labelling and noise ball count
     (XLA paths) and the Triton ACE kernel, compiled for the card, against
     scipy and the XLA scan at awkward (non-tile-aligned) shapes.
  3. backend parity — each filter's GPU output equals JAX's CPU backend:
     exact for the unpaper wipes and canny, <= 1 LSB for gaussian/sobel.
  4. execution — the fused chain at the bench shape, inside shard_map,
     SWT against the oracle at A4, and the JPEG corpus end to end.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from scipy import ndimage

pytestmark = pytest.mark.gpu

# Budgets in temp bytes per page pixel. JAX reserves 75% of the 80 GB card
# (60 GB); BatchRunner keeps two chunks in flight, each with a 4 B/px input
# and output, so a chunk's temp may use at most 60e9 / 2 / px - 8 B/px:
# ~207 B/px at A4 x 16. The guards keep a margin below that.
TEMP_BUDGET_B_PER_PX = 192
# canny streams A4 x 64 in chunks of 16 through one program: all of it
# (arguments, outputs and temp) must fit the 60 GB pool.
CANNY64_BUDGET_B_PER_PX = 100

_ST8 = np.ones((3, 3), bool)


def _temp_b_per_px(fn, x):
    ma = jax.jit(fn).lower(x).compile().memory_analysis()
    return ma, ma.temp_size_in_bytes / (x.shape[0] * x.shape[1] * x.shape[2])


# ----------------------------------------------------------------- memory

def test_fused_chain_memory_budget(a4_batch16):
    from libpillowfight_tpu.parallel.pipeline import (
        DOCUMENT_CLEANUP, normalize_spec, run_pipeline,
    )

    spec = normalize_spec(DOCUMENT_CLEANUP)
    _, bpp = _temp_b_per_px(lambda p: run_pipeline(p, spec),
                            jnp.asarray(a4_batch16))
    assert bpp < TEMP_BUDGET_B_PER_PX, f"chain temp {bpp:.1f} B/px at A4x16"


@pytest.mark.parametrize("name", [
    "unpaper_blackfilter", "unpaper_noisefilter", "unpaper_blurfilter",
    "unpaper_masks", "unpaper_grayfilter", "unpaper_border",
])
def test_per_filter_memory_budget(a4_batch16, name):
    from libpillowfight_tpu.parallel.pipeline import normalize_spec, run_pipeline

    spec = normalize_spec(((name, ()),))
    _, bpp = _temp_b_per_px(lambda p: run_pipeline(p, spec),
                            jnp.asarray(a4_batch16))
    assert bpp < TEMP_BUDGET_B_PER_PX, f"{name} temp {bpp:.1f} B/px at A4x16"


def test_canny_chunked_memory_budget(a4_batch16):
    """BASELINE.json config 2's shape: canny over 64 pages in chunks of 16."""
    from libpillowfight_tpu.ops.canny import canny
    from libpillowfight_tpu.parallel.batch import map_chunked

    x = jax.ShapeDtypeStruct((64,) + a4_batch16.shape[1:], jnp.uint8)
    ma = jax.jit(lambda p: map_chunked(canny, p, 16)).lower(x).compile() \
        .memory_analysis()
    total = (ma.temp_size_in_bytes + ma.argument_size_in_bytes
             + ma.output_size_in_bytes)
    bpp = total / (64 * x.shape[1] * x.shape[2])
    assert bpp < CANNY64_BUDGET_B_PER_PX, f"chunked canny {bpp:.1f} B/px"


# --------------------------------------------------------------- exactness

def _reach_truth(seeds, mask):
    lab, _ = ndimage.label(mask, structure=_ST8)
    sl = np.unique(lab[seeds])
    return np.isin(lab, sl[sl > 0])


def test_flood_reach_compiled_exact(rng):
    from libpillowfight_tpu.ops.morph import flood_reach

    mask = rng.random((2, 1217, 933)) < 0.55
    seeds = np.zeros_like(mask)
    seeds[:, 0, :] = mask[:, 0, :]
    got = np.asarray(flood_reach(jnp.asarray(seeds), jnp.asarray(mask)))
    for b in range(2):
        np.testing.assert_array_equal(got[b], _reach_truth(seeds[b], mask[b]))


def test_flood_default_path_winding_serpentine():
    """Serpentine corridor through morph.flood_reach (the entry used by
    blackfilter/canny): H/pitch turns, plus a disconnected twin that must
    stay unflooded."""
    from libpillowfight_tpu.ops.morph import flood_reach

    h, w = 2048, 1400
    m = np.zeros((h, w), bool)
    for i, y in enumerate(range(0, h - 4, 6)):
        m[y : y + 2, 2 : w - 2] = True
        if y + 6 < h - 4:  # connector alternating sides
            xs = slice(2, 4) if i % 2 else slice(w - 4, w - 2)
            m[y : y + 8, xs] = True
    mask = np.stack([m, m])
    seeds = np.zeros_like(mask)
    seeds[0, 0, 3] = True  # page 0 seeded, page 1 not
    got = np.asarray(flood_reach(jnp.asarray(seeds), jnp.asarray(mask)))
    np.testing.assert_array_equal(got[0], mask[0])
    assert not got[1].any()


def test_labels_compiled_exact(rng):
    from libpillowfight_tpu.ops.morph import label_components

    mask = rng.random((1, 700, 1031)) < 0.5
    got = np.asarray(label_components(jnp.asarray(mask)))[0]
    lab, _ = ndimage.label(mask[0], structure=_ST8)
    ours, ref = got[mask[0]], lab[mask[0]]
    pairs = set(zip(ours.tolist(), ref.tolist()))
    assert len(pairs) == len({a for a, _ in pairs}) == len({b for _, b in pairs})


def test_noise_ball_compiled_exact(rng):
    from libpillowfight_tpu.ops.morph import small_cluster_mask

    mask = rng.random((2, 1111, 517)) < 0.25
    got = np.asarray(small_cluster_mask(jnp.asarray(mask), 4))
    for b in range(2):
        lab, _ = ndimage.label(mask[b], structure=_ST8)
        sizes = np.bincount(lab.ravel())
        sizes[0] = 0
        np.testing.assert_array_equal(got[b], mask[b] & (sizes[lab] <= 4))


def test_ace_triton_kernel_compiled(rng):
    """The Triton spray kernel against the XLA scan at a shape that is no
    tile multiple in either axis (edge tiles mask their loads/stores)."""
    from libpillowfight_tpu.ops.ace import ace_with_samples, ace_with_samples_kernel

    b, h, w, s = 2, 301, 455, 37
    pages = rng.integers(0, 256, (b, h, w, 4), dtype=np.uint8)
    sy = rng.integers(0, h, (b, s)).astype(np.int32)
    sx = rng.integers(0, w, (b, s)).astype(np.int32)
    args = (jnp.asarray(pages), jnp.asarray(sy), jnp.asarray(sx), 10.0, 1000.0)
    got = np.asarray(jax.jit(ace_with_samples_kernel, static_argnums=(3, 4))(*args))
    want = np.asarray(jax.jit(ace_with_samples, static_argnums=(3, 4))(*args))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 3], pages[..., 3])
    assert np.abs(got[..., :3].astype(int) - want[..., :3].astype(int)).max() <= 1


def test_ace_shared_entry_runs_triton(rng):
    """ace(mode="shared"), the public entry, lowers to the Triton kernel on
    the card and equals it on the samples it draws from its seed."""
    import re

    from libpillowfight_tpu.ops.ace import _sample_coords, ace, ace_with_samples_kernel

    b, h, w, s = 2, 301, 455, 37
    pages = jnp.asarray(rng.integers(0, 256, (b, h, w, 4), dtype=np.uint8))
    fn = jax.jit(lambda p: ace(p, nb_samples=s, seed=3, mode="shared"))
    calls = re.findall(r"custom_call @([\w$.]+)", fn.lower(pages).as_text())
    assert calls == ["__gpu$xla.gpu.triton"]
    sy, sx = _sample_coords(jax.random.PRNGKey(3), b, s, h, w)
    want = np.asarray(jax.jit(ace_with_samples_kernel, static_argnums=(3, 4))(
        pages, sy, sx, 10.0, 1000.0))
    got = np.asarray(fn(pages))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# ----------------------------------------------------------------- parity

def _cpu(fn, *args):
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        return np.asarray(fn(*jax.device_put(args, cpu)))


@pytest.mark.parametrize("name", [
    "unpaper_blackfilter", "unpaper_noisefilter", "unpaper_blurfilter",
    "unpaper_masks", "unpaper_grayfilter", "unpaper_border", "canny",
])
def test_filter_gpu_equals_cpu_reference(a4_page, name):
    """GPU == CPU backend, exactly: wipes and canny are discrete."""
    from libpillowfight_tpu.parallel.pipeline import _FILTERS

    fn = _FILTERS[name]
    x = np.asarray(a4_page)
    got = np.asarray(fn(jnp.asarray(x)))
    want = _cpu(fn, x)
    mismatch = int((got != want).sum())
    assert mismatch == 0, f"{name}: {mismatch} mismatched bytes at A4"


@pytest.mark.parametrize("name", ["gaussian", "sobel"])
def test_linear_filter_gpu_1lsb(a4_page, name):
    from libpillowfight_tpu.parallel.pipeline import _FILTERS

    fn = _FILTERS[name]
    x = np.asarray(a4_page)
    got = np.asarray(fn(jnp.asarray(x))).astype(np.int16)
    want = _cpu(fn, x).astype(np.int16)
    assert np.abs(got - want).max() <= 1


# ------------------------------------------------------------- execution

def test_fused_chain_executes_at_bench_shape(a4_batch16):
    """The bench configuration completes on the card and cleans the page."""
    from libpillowfight_tpu.parallel.pipeline import (
        DOCUMENT_CLEANUP, normalize_spec, run_pipeline,
    )

    spec = normalize_spec(DOCUMENT_CLEANUP)
    x = jnp.asarray(a4_batch16)
    arr = np.asarray(jax.jit(lambda p: run_pipeline(p, spec))(x))
    assert arr.shape == x.shape and arr.dtype == np.uint8
    # black scan border erased, page mostly white
    assert (arr[:, :, : arr.shape[2] // 40, :3] == 255).mean() > 0.99
    assert (arr[..., :3] == 255).mean() > 0.9


def test_chain_inside_shard_map(a4_page):
    """The chain inside shard_map on a pages-only mesh equals plain jit
    (the multi-GPU DP path, here on a 1-device mesh)."""
    from libpillowfight_tpu.parallel.mesh import make_mesh, map_sharded_pages
    from libpillowfight_tpu.parallel.pipeline import (
        DOCUMENT_CLEANUP, normalize_spec, run_pipeline,
    )

    spec = normalize_spec(DOCUMENT_CLEANUP)
    mesh = make_mesh(1, rows=1)
    x = jnp.asarray(a4_page)
    dp = jax.jit(map_sharded_pages(lambda p: run_pipeline(p, spec), mesh))
    got = np.asarray(dp(x))
    want = np.asarray(jax.jit(lambda p: run_pipeline(p, spec))(x))
    np.testing.assert_array_equal(got, want)


def _text_page_a4(h=3508, w=2480):
    """A4 grid of compact bar letters (SW 6, height 50 — passes the
    letter filters) + a gray shading block SWT must ignore."""
    g = np.full((h, w), 255, np.uint8)
    for y0 in range(120, h - 120, 110):
        for x0 in range(120, w - 120, 45):
            g[y0 : y0 + 50, x0 : x0 + 6] = 0
    g[h - 180 : h - 80, 40:400] = 215
    return np.stack([g, g, g, np.full_like(g, 255)], -1)


@pytest.mark.parametrize("mode", [0, 1])
def test_swt_a4_golden(mode):
    """SWT at full A4 on the card vs the C++ oracle (the compaction
    bounds and the dense median at page scale)."""
    from libpillowfight_tpu.ops.swt import swt
    from libpillowfight_tpu.utils import oracle

    if not oracle.available():
        pytest.skip("oracle not built")
    page = _text_page_a4()
    want = oracle.swt(page, mode)
    got = np.asarray(swt(jnp.asarray(page), mode))
    wm = (want[..., :3] != 255).any(-1)
    gm = (got[..., :3] != 255).any(-1)
    iou = (wm & gm).sum() / max((wm | gm).sum(), 1)
    assert wm.sum() > 100_000, "oracle found no text at A4"
    assert iou >= 0.99, f"A4 swt mode {mode} IoU {iou:.4f}"


def test_swt_a4_boxes_golden_no_dropped_letters():
    """SWT_OUTPUT_ORIGINAL_BOXES at dense A4: ~1,500 bar letters exceed a
    fixed cap of 1024. The area-scaled default must hold every letter
    (debug counts prove zero truncation) and the red boxes must match the
    oracle's within 1-px localization."""
    from libpillowfight_tpu.ops.swt import swt
    from libpillowfight_tpu.utils import oracle

    if not oracle.available():
        pytest.skip("oracle not built")
    page = _text_page_a4()
    want = oracle.swt(page, 2)
    got, dbg = swt(jnp.asarray(page), 2, return_debug=True)
    got = np.asarray(got)
    assert int(dbg["n_letters"].max()) > 1024, "page not dense enough to test the cap"
    assert int(dbg["n_letters"].max()) <= dbg["max_letters"]
    assert int(dbg["n_anchors"].max()) > 0
    assert int(dbg["n_runs"].max()) <= dbg["max_runs"]
    wr = (want[..., 0] == 255) & (want[..., 1] == 0) & (want[..., 2] == 0)
    gr = (got[..., 0] == 255) & (got[..., 1] == 0) & (got[..., 2] == 0)
    assert wr.sum() > 0 and gr.sum() > 0
    dil = np.ones((3, 3), bool)
    stray_got = (gr & ~ndimage.binary_dilation(wr, dil)).sum()
    stray_want = (wr & ~ndimage.binary_dilation(gr, dil)).sum()
    assert stray_got <= 0.02 * gr.sum(), (stray_got, gr.sum())
    assert stray_want <= 0.02 * wr.sum(), (stray_want, wr.sum())


def test_batch_runner_jpeg_corpus_end_to_end(tmp_path):
    """The production path on the card: JPEG corpus -> threaded PIL
    prefetch (ImagePageSource) -> BatchRunner (pipelined H2D/compute/D2H,
    resumable manifest) -> cleanup chain -> PPM sink. 24 pages in chunks
    of 8 with a resume after a 'crash' at the halfway point."""
    Image = pytest.importorskip("PIL.Image")

    from libpillowfight_tpu.io import ImagePageSource, PpmSink, decode_pnm
    from libpillowfight_tpu.parallel import BatchRunner

    h, w = 512, 640
    paths = []
    for i in range(24):
        g = np.full((h, w), 245, np.uint8)
        g[:, : w // 20] = 0                      # black border
        for y in range(60, h - 60, 40):
            g[y : y + 3, 80 : w - 40] = 15       # text lines
        p = str(tmp_path / f"scan{i:03d}.jpg")
        Image.fromarray(g).convert("RGB").save(p, quality=90)
        paths.append(p)

    manifest = str(tmp_path / "m.jsonl")
    out_dir = str(tmp_path / "out")
    spec = [("unpaper_blackfilter", ()), ("unpaper_border", ())]

    # first run: only the first half of the chunks (simulated interrupt)
    with ImagePageSource(paths, shape=(h, w)) as src:
        r1 = BatchRunner(spec, chunk_size=8, manifest_path=manifest)
        half_seen = []
        sink = PpmSink(out_dir)

        def half_sink(idx, pages):
            if len(half_seen) >= 2:
                raise KeyboardInterrupt  # crash after 2 chunks delivered
            half_seen.append(idx)
            sink(idx, pages)

        try:
            r1.run(len(paths), src, half_sink)
        except KeyboardInterrupt:
            pass

    # resume: a fresh runner skips the manifest-recorded chunks
    with ImagePageSource(paths, shape=(h, w)) as src2:
        r2 = BatchRunner(spec, chunk_size=8, manifest_path=manifest)
        m = r2.run(len(paths), src2, sink)
    assert m.pages + 16 == 24  # 2 chunks were already done
    assert src2.failed == 0

    # every page written, black border wiped
    import os as _os
    files = sorted(_os.listdir(out_dir))
    assert len(files) == 24
    page = decode_pnm(_os.path.join(out_dir, files[0]))
    assert (page[:, : w // 20, :3] == 255).mean() > 0.99

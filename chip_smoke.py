"""Smoke test: the system's main path and all twelve operations on a GPU.

    python chip_smoke.py [--seed N]    # one GPU: every phase below
    python chip_smoke.py --four        # four GPUs: the multi-GPU path only

One process drives the card(s). Phases, in order:

  card   nvidia-smi name and power limit (read before JAX takes the card),
         the JAX devices and version, the compile-cache directory.
  chain  64 A4 pages at 300 dpi, made from --seed, written as PGM files,
         read by PnmPageSource, cleaned by BatchRunner(DOCUMENT_CLEANUP,
         chunk_size=16), written by PpmSink; the run's BatchMetrics; the
         compiled chain step's memory analysis at A4 x 16.
  check  two output pages against the same chain on JAX's CPU backend
         (bit-identical: the chain is integer and boolean logic) and
         against the C++ oracle's chain (PARITY.md tolerances).
  ops    gaussian and sobel on A4 (<= 1 LSB of the oracle), canny on
         A4 x 16 through EDGE_STACK, SWT on an A4 text page, ACE shared at
         600-dpi A4 with S=100 (the Triton kernel against the XLA scan and
         the oracle, both timed; ace(mode="shared") must lower to the
         kernel and match it) and ACE rolled on A4 (against the CPU
         backend, same key).
  lane   the on-card pytest lane, tests_gpu/, in this process.

With --four only the four-GPU path runs: BatchRunner over make_mesh(4),
the pages x rows GSPMD chain, the DP shard_map and the ppermute halo
stencil, each compared with the one-device result.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}},
printed only when every phase passed. Without a GPU the script exits
non-zero before any phase. Wall times end in block_until_ready.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

from libpillowfight_tpu.utils.runtime import (
    REPO_ROOT, card_info, enable_compile_cache, require_gpu,
)

A4 = (3508, 2480)         # 300 dpi
A4_600 = (7016, 4960)     # 600 dpi
ACE_SAMPLES = 100
CHAIN_PAGES = 64
CHUNK = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what: str) -> None:
    """A failed check ends the run: non-zero exit, no result line."""
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def timed(fn, *args, reps: int = 3):
    """(median wall seconds over `reps` warm calls, last output); each
    call ends in block_until_ready. The first call compiles."""
    import jax

    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def scan_pages(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """n distinct scan-like RGBA pages (bench._pages, one seed each)."""
    from bench import _pages

    return np.concatenate([_pages(1, h, w, seed=seed + i) for i in range(n)])


def text_page(h: int, w: int) -> np.ndarray:
    """Grid of compact bar letters (stroke 6, height 50) plus a gray
    shading block SWT must ignore."""
    g = np.full((h, w), 255, np.uint8)
    for y0 in range(120, h - 120, 110):
        for x0 in range(120, w - 120, 45):
            g[y0 : y0 + 50, x0 : x0 + 6] = 0
    g[h - 180 : h - 80, 40:400] = 215
    return np.stack([g, g, g, np.full_like(g, 255)], -1)


def color_page(h: int, w: int, seed: int) -> np.ndarray:
    """Colour gradients under a scan-like page: exercises ACE's per-
    channel correction."""
    page = scan_pages(1, h, w, seed)[0]
    y = np.linspace(0, 120, h, dtype=np.float32)[:, None]
    x = np.linspace(0, 120, w, dtype=np.float32)[None, :]
    tint = np.stack(np.broadcast_arrays(x, y, (x + y) / 2), -1)
    rgb = np.clip(page[..., :3].astype(np.float32) - tint, 0, 255)
    page[..., :3] = rgb.astype(np.uint8)
    return page


def lsb(a, b) -> int:
    return int(np.abs(a[..., :3].astype(int) - b[..., :3].astype(int)).max())


def wiped_iou(page, a, b) -> float:
    wa = (a[..., :3] != page[..., :3]).any(-1)
    wb = (b[..., :3] != page[..., :3]).any(-1)
    union = (wa | wb).sum()
    return float((wa & wb).sum() / union) if union else 1.0


def on_cpu(fn, *args):
    """fn(*args) on JAX's CPU backend, as numpy."""
    import jax

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        return np.asarray(fn(*jax.device_put(args, cpu)))


def oracle_chain(page: np.ndarray) -> np.ndarray:
    from libpillowfight_tpu.utils import oracle

    for name in ("blackfilter", "noisefilter", "blurfilter", "masks",
                 "grayfilter", "border"):
        page = getattr(oracle, name)(page)
    return page


def memory_line(name: str, compiled, n_px: int) -> str:
    ma = compiled.memory_analysis()
    return (f"{name}: temp {ma.temp_size_in_bytes} B "
            f"({ma.temp_size_in_bytes / n_px:.2f} B/px), args "
            f"{ma.argument_size_in_bytes} B, out {ma.output_size_in_bytes} B")


# ------------------------------------------------------------------ phases

def phase_card() -> dict:
    card = card_info()  # child process, before JAX initializes the card
    log(f"nvidia-smi: {card}")
    cards = card.splitlines()
    if len(cards) > 1 and len(set(cards)) == 1:  # label for the log lines
        card = f"{len(cards)} x {cards[0]}"
    cache = enable_compile_cache()
    dev = require_gpu()
    import jax

    log(f"jax {jax.__version__}; devices {jax.devices()}")
    log(f"device_kind {dev.device_kind}; compile cache {cache}")
    return {"card": card, "platform": dev.platform, "kind": dev.device_kind}


def phase_chain(workdir: str, seed: int, n_pages: int = CHAIN_PAGES,
                shape=A4, chunk: int = CHUNK, card: str = "") -> dict:
    import jax

    from libpillowfight_tpu import io as pfio
    from libpillowfight_tpu.parallel import (
        DOCUMENT_CLEANUP, BatchRunner, normalize_spec, run_pipeline,
    )

    h, w = shape
    pages = scan_pages(n_pages, h, w, seed)
    src_dir = os.path.join(workdir, "in")
    os.makedirs(src_dir)
    paths = [os.path.join(src_dir, f"scan_{i:04d}.pgm") for i in range(n_pages)]
    for p, page in zip(paths, pages):
        pfio.write_pgm(p, page)
    log(f"chain: {n_pages} pages {h}x{w} written as PGM; IO path "
        f"{'native libpfio' if pfio.available() else 'numpy fallback'}")

    spec = normalize_spec(DOCUMENT_CLEANUP)
    n_px = chunk * h * w
    t0 = time.perf_counter()
    compiled = run_pipeline.lower(
        jax.ShapeDtypeStruct((chunk, h, w, 4), np.uint8), spec).compile()
    log(f"chain: compiled A4 x {chunk} step in "
        f"{time.perf_counter() - t0:.1f} s")
    log(memory_line(f"memory chain A4x{chunk}", compiled, n_px))
    noise = run_pipeline.lower(
        jax.ShapeDtypeStruct((chunk, h, w, 4), np.uint8),
        normalize_spec((("unpaper_noisefilter", ()),))).compile()
    log(memory_line(f"memory noisefilter A4x{chunk}", noise, n_px))

    out_dir = os.path.join(workdir, "out")
    with pfio.PnmPageSource(paths, shape=(h, w)) as source:
        # warm-up run over the first chunk: compilation is set-up time
        warm = BatchRunner(DOCUMENT_CLEANUP, chunk_size=chunk)
        warm.run(chunk, source, None)
    with pfio.PnmPageSource(paths, shape=(h, w)) as source:
        runner = BatchRunner(DOCUMENT_CLEANUP, chunk_size=chunk)
        m = runner.run(n_pages, source, pfio.PpmSink(out_dir))
        failed = source.failed
    log(f"chain metrics [{card}]: {json.dumps(m.to_dict())}")
    check(m.retries == 0, f"chain: {m.retries} chunk retries")
    check(failed == 0, f"chain: {failed} pages failed to decode")
    check(m.pages == n_pages, f"chain: {m.pages} of {n_pages} pages done")
    return {"pages": pages, "out_dir": out_dir}


def phase_check(pages: np.ndarray, out_dir: str, idx=(0, 37)) -> None:
    from libpillowfight_tpu import io as pfio
    from libpillowfight_tpu.parallel import (
        DOCUMENT_CLEANUP, normalize_spec, run_pipeline,
    )

    spec = normalize_spec(DOCUMENT_CLEANUP)
    idx = [i % len(pages) for i in idx]
    got = np.stack([pfio.decode_pnm(os.path.join(out_dir, f"page_{i:06d}.ppm"))
                    for i in idx])
    src = pages[idx]
    with concurrent.futures.ThreadPoolExecutor(len(idx)) as pool:
        want_oracle = list(pool.map(oracle_chain, src))
        t0 = time.perf_counter()
        want_cpu = on_cpu(lambda p: run_pipeline(p, spec), src)
        log(f"check: CPU backend chain on {len(idx)} pages in "
            f"{time.perf_counter() - t0:.1f} s")
    mism = int((got != want_cpu).sum())
    log(f"check: GPU vs CPU backend, pages {idx}: {mism} mismatched bytes")
    check(mism == 0, "check: GPU output differs from the CPU backend")
    for i, g, o, p in zip(idx, got, want_oracle, src):
        iou = wiped_iou(p, g, o)
        frac = float((g[..., :3] != o[..., :3]).any(-1).mean())
        log(f"check: page {i} vs oracle chain: wiped IoU {iou:.6f}, "
            f"mismatch {frac:.6%}")
        check(iou >= 0.99 and frac < 0.01,
              f"check: page {i} differs from the oracle chain")


def phase_ops(seed: int, shape=A4, shape_600=A4_600, canny_pages: int = 16,
              samples: int = ACE_SAMPLES, card: str = "") -> None:
    import jax
    import jax.numpy as jnp

    from libpillowfight_tpu.ops.ace import (
        _sample_coords, ace, ace_with_samples, ace_with_samples_kernel,
        spray_scan,
    )
    from libpillowfight_tpu.ops.gaussian import gaussian
    from libpillowfight_tpu.ops.pallas.ace_kernel import ace_spray
    from libpillowfight_tpu.ops.sobel import sobel
    from libpillowfight_tpu.ops.swt import swt
    from libpillowfight_tpu.parallel import (
        EDGE_STACK, normalize_spec, run_pipeline,
    )
    from libpillowfight_tpu.utils import oracle

    h, w = shape
    page = scan_pages(1, h, w, seed + 1000)[0]
    edge_pages = scan_pages(canny_pages, h, w, seed + 2000)
    tpage = text_page(h, w)
    cpage = color_page(*shape_600, seed + 3000)
    # the samples ace(mode="shared", seed=seed) draws for one page
    sy, sx = (np.asarray(a) for a in _sample_coords(
        jax.random.PRNGKey(seed), 1, samples, *shape_600))

    # the oracle runs on host threads (ctypes drops the GIL) while the
    # card works
    pool = concurrent.futures.ThreadPoolExecutor(6)
    want = {
        "gaussian": pool.submit(oracle.gaussian, page, 2.0, 5),
        "sobel": pool.submit(oracle.sobel, page),
        "canny": pool.submit(oracle.canny, edge_pages[0]),
        "swt": pool.submit(oracle.swt, tpage, 0),
        "ace": pool.submit(oracle.ace_samples, cpage, sy[0], sx[0], 10.0,
                           1000.0),
    }

    x = jnp.asarray(page)
    for name, fn in (("gaussian", gaussian), ("sobel", sobel)):
        dt, out = timed(jax.jit(fn), x)
        d = lsb(np.asarray(out), want[name].result())
        log(f"ops: {name} A4 {dt * 1e3:.3f} ms [{card}]; {d} LSB vs oracle")
        check(d <= 1, f"ops: {name} off by {d} LSB")

    edge = jax.jit(lambda p: run_pipeline(p, normalize_spec(EDGE_STACK)))
    dt, out = timed(edge, jnp.asarray(edge_pages), reps=1)
    got = np.asarray(out[0])[..., 0] > 0
    ref = want["canny"].result()[..., 0] > 0
    nd = int((got != ref).sum())
    log(f"ops: canny A4x{canny_pages} {dt * 1e3:.3f} ms [{card}]; page 0 "
        f"{nd} px differ of {int(ref.sum())} oracle edge px")
    check(nd <= max(0.001 * ref.sum(), 2), "ops: canny differs from the oracle")
    del out

    dt, out = timed(jax.jit(lambda p: swt(p, 0)), jnp.asarray(tpage), reps=1)
    gm = (np.asarray(out)[..., :3] != 255).any(-1)
    wm = (want["swt"].result()[..., :3] != 255).any(-1)
    iou = float((gm & wm).sum() / max((gm | wm).sum(), 1))
    log(f"ops: swt A4 {dt * 1e3:.3f} ms [{card}]; letter IoU {iou:.6f} "
        f"vs oracle ({int(wm.sum())} oracle px)")
    check(wm.sum() > 0 and iou >= 0.99, "ops: swt differs from the oracle")

    # ACE shared at 600 dpi: Triton kernel vs the XLA scan, same samples
    xc, ys, xs = jnp.asarray(cpage)[None], jnp.asarray(sy), jnp.asarray(sx)
    k_fn = jax.jit(lambda p, a, b: ace_with_samples_kernel(p, a, b, 10.0,
                                                           1000.0))
    s_fn = jax.jit(lambda p, a, b: ace_with_samples(p, a, b, 10.0, 1000.0))
    dt_k, out_k = timed(k_fn, xc, ys, xs)
    dt_s, out_s = timed(s_fn, xc, ys, xs)
    out_k, out_s = np.asarray(out_k[0]), np.asarray(out_s[0])
    d_ks = lsb(out_k, out_s)
    log(f"ops: ace shared {shape_600[0]}x{shape_600[1]} S={samples} "
        f"[{card}]: Triton kernel {dt_k * 1e3:.3f} ms, XLA scan "
        f"{dt_s * 1e3:.3f} ms; kernel vs scan {d_ks} LSB")
    check(d_ks <= 1, "ops: ace kernel differs from the scan")

    def fields(p, a, b):
        rgb = p[..., :3].astype(jnp.float32)
        flat = rgb.reshape(1, -1, 3)
        sv = jnp.take_along_axis(flat, (a * p.shape[2] + b)[..., None], 1)
        n_k = ace_spray(jnp.moveaxis(rgb, -1, 1), a, b,
                        jnp.moveaxis(sv, -1, 1), 10.0, 1000.0)
        return jnp.max(jnp.abs(jnp.moveaxis(n_k, 1, -1)
                               - spray_scan(p, a, b, 10.0, 1000.0)))

    dn = float(jax.jit(fields)(xc, ys, xs))
    log(f"ops: ace n = num/den, kernel vs scan: max |diff| {dn:.3e} (f32)")
    check(dn <= 1e-4, "ops: ace kernel's n differs from the scan's")
    d_ko = lsb(out_k, want["ace"].result())
    log(f"ops: ace kernel vs oracle.ace_samples: {d_ko} LSB")
    check(d_ko <= 1, "ops: ace kernel differs from the oracle")

    # the public entry point: shared mode must lower to the Triton kernel
    shared = jax.jit(lambda p: ace(p, nb_samples=samples, slope=10.0,
                                   limit=1000.0, seed=seed, mode="shared"))
    calls = re.findall(r"custom_call @([\w$.]+)", shared.lower(xc).as_text())
    check(calls == ["__gpu$xla.gpu.triton"],
          f"ops: ace shared lowers to custom calls {calls}, not the kernel")
    dt_e, out_e = timed(shared, xc)
    d_ek = lsb(np.asarray(out_e[0]), out_k)
    log(f"ops: ace(mode='shared') {dt_e * 1e3:.3f} ms [{card}]; custom calls "
        f"{calls}; vs the kernel on the same samples {d_ek} LSB")
    check(d_ek <= 1, "ops: ace(mode='shared') differs from the kernel")
    del out_k, out_s, out_e, xc

    # ACE rolled: distributional oracle pin only (PARITY.md #15), so the
    # GPU is held to the CPU backend on the same key
    rolled = jax.jit(lambda p: ace(p, mode="rolled", seed=seed))
    dt, out = timed(rolled, x, reps=1)
    d = lsb(np.asarray(out), on_cpu(rolled, page))
    log(f"ops: ace rolled A4 {dt * 1e3:.3f} ms [{card}]; {d} LSB vs CPU "
        f"backend")
    check(d <= 1, f"ops: ace rolled off by {d} LSB from the CPU backend")
    pool.shutdown()


def phase_lane() -> None:
    import pytest

    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-rs",
                      os.path.join(REPO_ROOT, "tests_gpu")])
    log(f"lane: pytest tests_gpu exit code {int(rc)}")
    check(rc == 0, f"lane: pytest exit code {rc}")


def phase_four(seed: int, n_pages: int = 16, shape=A4, chunk: int = 16,
               card: str = "") -> None:
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import __graft_entry__
    from libpillowfight_tpu.parallel import (
        DOCUMENT_CLEANUP, BatchRunner, make_mesh, normalize_spec,
        run_pipeline, shard_pages,
    )
    from libpillowfight_tpu.parallel.mesh import map_sharded_pages

    n = len(jax.devices())
    check(n == 4, f"--four needs 4 devices, found {n}")
    h, w = shape
    pages = scan_pages(n_pages, h, w, seed)
    # a host chunk goes to each card as that card's shard only (checked
    # first, while device 0's peak still reflects nothing else)
    mesh = make_mesh(4)
    dev0 = jax.devices()[0]
    before = (dev0.memory_stats() or {}).get("peak_bytes_in_use")
    xs = jax.block_until_ready(shard_pages(pages[:chunk], mesh))
    shard_devs = {s.device for s in xs.addressable_shards}
    check(len(shard_devs) == 4, "four: chunk not spread over 4 devices")
    if before is not None:  # the CPU backend keeps no memory stats
        grew = dev0.memory_stats()["peak_bytes_in_use"] - before
        log(f"four: shard_pages raised device 0's peak by {grew} B for a "
            f"{pages[:chunk].nbytes} B chunk, shards on 4 devices")
        check(grew <= pages[:chunk].nbytes // 4 + (1 << 20),
              "four: the chunk was staged through device 0")
    del xs

    spec = normalize_spec(DOCUMENT_CLEANUP)
    one = jax.jit(lambda p: run_pipeline(p, spec))
    t0 = time.perf_counter()
    ref = np.asarray(one(jax.device_put(pages, jax.devices()[0])))
    log(f"four: one-device chain on {n_pages} pages "
        f"{time.perf_counter() - t0:.1f} s (with compile)")

    got = {}
    BatchRunner(DOCUMENT_CLEANUP, chunk_size=chunk, mesh=mesh).run(
        chunk, lambda idx: pages[idx], None)  # warm-up: compiles
    runner = BatchRunner(DOCUMENT_CLEANUP, chunk_size=chunk, mesh=mesh)
    m = runner.run(n_pages, lambda idx: pages[idx],
                   lambda idx, out: got.update(zip(idx.tolist(), out)))
    log(f"four: BatchRunner metrics [{card}]: {json.dumps(m.to_dict())}")
    out = np.stack([got[i] for i in range(n_pages)])
    check(m.retries == 0 and np.array_equal(out, ref),
          "four: BatchRunner output differs from one device")

    dp = jax.jit(map_sharded_pages(lambda p: run_pipeline(p, spec), mesh))
    dt, out = timed(dp, shard_pages(pages, mesh), reps=1)
    log(f"four: DP shard_map chain {dt * 1e3:.3f} ms [{card}]")
    check(np.array_equal(np.asarray(out), ref),
          "four: DP shard_map output differs from one device")

    mesh2 = make_mesh(4, rows=2)
    gspmd = jax.jit(lambda p: run_pipeline(p, spec),
                    out_shardings=NamedSharding(mesh2, P("pages", "rows")))
    dt, out = timed(gspmd, shard_pages(pages, mesh2), reps=1)
    log(f"four: pages x rows GSPMD chain {dt * 1e3:.3f} ms [{card}]")
    check(np.array_equal(np.asarray(out), ref),
          "four: GSPMD output differs from one device")
    del out

    __graft_entry__.dryrun_multichip(4)  # includes the ppermute halo stencil
    log("four: dryrun_multichip(4) (GSPMD chain, DP shard_map, ppermute "
        "halo stencil) matched the one-device results")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU path")
    args = ap.parse_args(argv)

    t_all = time.perf_counter()
    info = phase_card()
    import jax

    card = info["card"]

    def run(name, fn, *a, **kw):
        t0 = time.perf_counter()
        log(f"== {name}")
        res = fn(*a, **kw)
        log(f"== {name} passed in {time.perf_counter() - t0:.1f} s")
        return res

    if args.four:
        run("four", phase_four, args.seed, card=card)
    else:
        with tempfile.TemporaryDirectory(dir=REPO_ROOT,
                                         prefix=".smoke_") as workdir:
            res = run("chain", phase_chain, workdir, args.seed, card=card)
            run("check", phase_check, res["pages"], res["out_dir"])
        del res
        run("ops", phase_ops, args.seed, card=card)
        run("lane", phase_lane)
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s "
        f"[{card}]")
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

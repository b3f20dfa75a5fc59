"""Headline benchmark: the unpaper cleanup chain on A4 pages, on one GPU.

Prints the card (nvidia-smi name and power limit) and then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device", "card"}.

`value` is MP/s of the jitted chain with the pages already on the device;
each timed step ends in block_until_ready. `vs_baseline` is the speedup
over the C++ oracle's chain on one page (oracle/ — the same algorithms,
compiled -O2), or null when the oracle binary is absent. The run fails
when JAX finds no GPU. Pass --quick for a reduced-size smoke run.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

A4_H, A4_W = 3508, 2480  # 300dpi A4 ~ 8.7 MP
BATCH = 16  # pages per step: the chunk chip_smoke.py hands BatchRunner


def _pages(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    pages = np.full((b, h, w, 4), 245, np.uint8)
    pages[..., 3] = 255
    # black border, text lines, gray shading, speckle — a scan-like page
    pages[:, :, : w // 40, :3] = 0
    for y in range(h // 10, h - h // 10, 40):
        pages[:, y : y + 3, w // 8 : w - w // 8, :3] = 15
    pages[:, h // 2 : h // 2 + h // 8, w // 10 : w // 4, :3] = 190
    ys = rng.integers(0, h, 500)
    xs = rng.integers(w // 20, w, 500)
    pages[:, ys, xs, :3] = 30
    return pages


def _bench_chain(pages, iters=3):
    import jax

    from libpillowfight_tpu.core.bitmap import host_pages_to_words
    from libpillowfight_tpu.parallel.pipeline import (
        DOCUMENT_CLEANUP, normalize_spec, run_pipeline,
    )

    spec = normalize_spec(DOCUMENT_CLEANUP)
    dev = jax.devices()[0]
    # two distinct device-resident dirty batches: every timed iteration
    # processes a FRESH page (output-feeds-input chaining would hand later
    # iterations an already-clean page, understating the flood-fill work).
    # Transport form: u32 words (bitmap.pages_to_words).
    xs = [jax.device_put(host_pages_to_words(pages), dev),
          jax.device_put(host_pages_to_words(
              _pages(*pages.shape[:3], seed=1)), dev)]
    fn = jax.jit(lambda p: run_pipeline(p, spec))
    fn(xs[0]).block_until_ready()  # compile + warm up
    times = []
    for i in range(iters):
        t0 = time.perf_counter()
        fn(xs[i % 2]).block_until_ready()
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    mp = pages.shape[0] * pages.shape[1] * pages.shape[2] / 1e6
    return mp / dt


def _bench_oracle_cpu(h, w):
    """Time the C oracle's unpaper chain on one page; MP/s, or None."""
    import os

    exe = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "oracle", "pf_oracle")
    if not os.path.exists(exe):
        return None
    out = subprocess.run(
        [exe, "bench-unpaper-chain", str(h), str(w)],
        capture_output=True, text=True, timeout=600,
    )
    if out.returncode != 0:
        return None
    return float(json.loads(out.stdout.strip())["mp_per_sec"])


def main():
    from libpillowfight_tpu.utils.runtime import (
        card_info, enable_compile_cache, require_gpu,
    )

    card = card_info()  # before JAX takes the card
    print(f"card: {card}", flush=True)
    enable_compile_cache()
    dev = require_gpu()
    quick = "--quick" in sys.argv
    h, w, b = (512, 512, 2) if quick else (A4_H, A4_W, BATCH)
    pages = _pages(b, h, w)
    mps = _bench_chain(pages, iters=2 if quick else 3)
    base_mps = _bench_oracle_cpu(h, w)
    import jax

    print(json.dumps({
        "metric": "unpaper_cleanup_pipeline_throughput",
        "value": mps,
        "unit": "MP/s",
        "vs_baseline": mps / base_mps if base_mps else None,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))


if __name__ == "__main__":
    main()

"""Run-time setup shared by the benchmark, the smoke test and the on-card
test lane: the persistent compile cache, the card's identity, and the
rule that a measurement runs on a GPU or not at all."""

from __future__ import annotations

import os
import subprocess

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; return its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX reads it by itself and
    nothing is set here. Otherwise the cache goes to `.jax_cache/` at the
    repository root (git-ignored): a fixed path, because the path is part
    of the cache key and a directory that moves never hits."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def card_info() -> str:
    """`name, power.limit` of each GPU as nvidia-smi reports them (one
    line per card), or why they could not be read. Runs nvidia-smi in a
    child process, which stays off JAX."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit",
           "--format=csv,noheader"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    if out.returncode != 0:
        return f"nvidia-smi failed: {out.stderr.strip()}"
    return out.stdout.strip()


def require_gpu() -> jax.Device:
    """The first device, which must be a GPU: a measurement or a smoke
    test never falls back to the CPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found only {dev.platform} devices "
                         f"({dev.device_kind})")
    return dev

"""Run-time setup: plain XLA on the main paths, the compile-cache rule,
and chip_smoke.py's refusal to run without a GPU."""

import os
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from libpillowfight_tpu.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cpu_lowering_is_plain_xla():
    """The cleanup chain and canny lower to plain XLA: no Mosaic kernel
    and no custom call is left anywhere on their paths."""
    from libpillowfight_tpu.ops.canny import canny
    from libpillowfight_tpu.parallel import (
        DOCUMENT_CLEANUP, normalize_spec, run_pipeline,
    )

    spec = normalize_spec(DOCUMENT_CLEANUP)
    x = jax.ShapeDtypeStruct((2, 96, 128, 4), jnp.uint8)
    for fn in (lambda p: run_pipeline(p, spec), canny):
        text = jax.jit(fn).lower(x).as_text().lower()
        assert "mosaic" not in text
        assert "custom_call" not in text


@pytest.mark.parametrize("platform", ["cuda", "cpu"])
def test_ace_shared_dispatch(platform):
    """ace(mode="shared") lowers to the Triton spray kernel for CUDA and
    to plain XLA for the CPU: no silent fallback on the GPU."""
    from libpillowfight_tpu.ops.ace import ace

    x = jax.ShapeDtypeStruct((1, 96, 160, 4), jnp.uint8)
    fn = jax.jit(lambda p: ace(p, nb_samples=9, mode="shared", seed=0))
    text = fn.trace(x).lower(lowering_platforms=(platform,)).as_text()
    calls = re.findall(r"custom_call @([\w$.]+)", text)
    if platform == "cuda":
        assert calls == ["__gpu$xla.gpu.triton"]
        assert "ace_spray" in text
    else:
        assert calls == []


def test_compile_cache_env_var_wins(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper sets nothing and the
    cache lands in that directory."""
    code = (
        "from libpillowfight_tpu.utils.runtime import enable_compile_cache\n"
        "import jax, jax.numpy as jnp\n"
        "print(enable_compile_cache())\n"
        "jax.jit(lambda x: x * 2 + 1)(jnp.ones(8)).block_until_ready()\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(tmp_path)
    assert os.listdir(tmp_path), "nothing was cached in the given directory"


def test_compile_cache_default_is_fixed_repo_path(monkeypatch):
    """Unset, the cache goes to <repo>/.jax_cache, which git ignores."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = runtime.enable_compile_cache()
        assert got == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_cpu(tmp_path, where):
    """chip_smoke.py exits non-zero and prints no result on the CPU, and
    in a directory that holds nothing else of the repository."""
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    else:
        cwd = REPO
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    if where == "alone":  # the program is not there to import
        assert "No module named 'libpillowfight_tpu'" in out.stderr
    else:
        assert "no GPU" in out.stderr

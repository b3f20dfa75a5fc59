"""On-card test lane: the compiled program on an NVIDIA GPU at production
shapes. tests/ runs on JAX's CPU backend; this lane runs what only the
card's compiler and memory can show.

Run: python -m pytest tests_gpu/ -q    (chip_smoke.py runs it as its last
phase inside its own process, so that one process holds the card.)

Every test carries the `gpu` marker. Whether a GPU is present is decided
in the session fixture below: without one, every test skips with a reason.
"""

import os
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

A4_H, A4_W = 3508, 2480


@pytest.fixture(scope="session", autouse=True)
def gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {dev.platform} ({dev.device_kind})")
    from libpillowfight_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    return dev


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(20260820)


@pytest.fixture(scope="session")
def a4_page():
    """One synthetic A4 scan page (bench.py's generator)."""
    from bench import _pages

    return _pages(1, A4_H, A4_W, seed=7)


@pytest.fixture(scope="session")
def a4_batch16():
    """The bench shape: 16 A4 pages."""
    from bench import _pages

    return _pages(16, A4_H, A4_W, seed=3)

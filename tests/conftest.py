"""Test environment: force a virtual 8-device CPU mesh.

Multi-chip hardware is unavailable in CI; sharding/collective tests run on
8 virtual CPU devices (jax docs' standard recipe). Must run before jax
imports anywhere, hence module scope in conftest.
"""

import os

# The suite runs on the CPU backend (jax_platforms=cpu), also on a machine
# with a GPU; the on-card lane is tests_gpu/, run by chip_smoke.py.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def page(rng):
    """A small synthetic scanned page: white background, dark text-ish
    strokes, a black border, light gray shading region. uint8 RGBA [H,W,4]."""
    h, w = 120, 160
    img = np.full((h, w, 3), 255, np.uint8)
    # black scan border on the left
    img[:, :6] = 0
    # a few "text" strokes
    for y0, x0 in [(30, 40), (50, 70), (80, 100)]:
        img[y0 : y0 + 3, x0 : x0 + 30] = 10
    # light gray shading block
    img[90:110, 20:60] = 200
    # speckle noise
    ys = rng.integers(10, h - 10, 15)
    xs = rng.integers(20, w - 10, 15)
    img[ys, xs] = 30
    alpha = np.full((h, w, 1), 255, np.uint8)
    return np.concatenate([img, alpha], axis=-1)

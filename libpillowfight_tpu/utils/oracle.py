"""ctypes bindings for the C++ reference oracle (oracle/libpf_oracle.so).

The oracle replaces the absent upstream C sources as the golden-output
authority (SURVEY.md §7 step 0). Golden tests feed identical inputs to
the JAX kernels and these functions and compare per-pixel.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SO = os.path.join(_REPO, "oracle", "libpf_oracle.so")
_lib = None


def available() -> bool:
    return _load() is not None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO):
        try:  # build on demand (g++ is in the image)
            subprocess.run(["make", "-C", os.path.dirname(_SO)], check=True,
                           capture_output=True, timeout=300)
        except Exception:
            return None
    try:
        _lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    _lib.pf_oracle_gaussian.argtypes = [u8p, u8p, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_double, ctypes.c_int]
    for name in ("sobel", "canny", "blackfilter", "noisefilter", "blurfilter",
                 "grayfilter", "border", "masks"):
        getattr(_lib, f"pf_oracle_{name}").argtypes = [
            u8p, u8p, ctypes.c_int, ctypes.c_int]
    _lib.pf_oracle_swt.argtypes = [u8p, u8p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int]
    _lib.pf_oracle_masks_multi.argtypes = [
        u8p, u8p, ctypes.c_int, ctypes.c_int, i32p, ctypes.c_int]
    _lib.pf_oracle_ace_samples.argtypes = [
        u8p, u8p, ctypes.c_int, ctypes.c_int, i32p, i32p, ctypes.c_int,
        ctypes.c_double, ctypes.c_double]
    _lib.pf_oracle_ace_pixel_samples.argtypes = [
        u8p, u8p, ctypes.c_int, ctypes.c_int, i32p, ctypes.c_int,
        ctypes.c_double, ctypes.c_double]
    _lib.pf_oracle_ace_rand.argtypes = [
        u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.c_uint64]
    _lib.pf_oracle_compare.argtypes = [
        u8p, u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p]
    return _lib


def _buf(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _run(name, page, *extra):
    lib = _load()
    page = np.ascontiguousarray(page, np.uint8)
    h, w, _ = page.shape
    out = np.empty_like(page)
    getattr(lib, f"pf_oracle_{name}")(_buf(page), _buf(out), h, w, *extra)
    return out


def gaussian(page, sigma=2.0, nb_stddev=5):
    return _run("gaussian", page, ctypes.c_double(sigma), nb_stddev)


def sobel(page):
    return _run("sobel", page)


def canny(page):
    return _run("canny", page)


def blackfilter(page):
    return _run("blackfilter", page)


def noisefilter(page):
    return _run("noisefilter", page)


def blurfilter(page):
    return _run("blurfilter", page)


def grayfilter(page):
    return _run("grayfilter", page)


def border(page):
    return _run("border", page)


def masks(page):
    return _run("masks", page)


def masks_multi(page, starts):
    """Multi-start masks: starts is a sequence of (y, x) pixel points."""
    lib = _load()
    page = np.ascontiguousarray(page, np.uint8)
    pts = np.ascontiguousarray(np.asarray(starts, np.int32).reshape(-1))
    h, w, _ = page.shape
    out = np.empty_like(page)
    lib.pf_oracle_masks_multi(
        _buf(page), _buf(out), h, w,
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(pts) // 2)
    return out


def swt(page, output_type=0):
    return _run("swt", page, output_type)


def ace_samples(page, sy, sx, slope=10.0, limit=1000.0):
    lib = _load()
    page = np.ascontiguousarray(page, np.uint8)
    sy = np.ascontiguousarray(sy, np.int32)
    sx = np.ascontiguousarray(sx, np.int32)
    h, w, _ = page.shape
    out = np.empty_like(page)
    lib.pf_oracle_ace_samples(
        _buf(page), _buf(out), h, w,
        sy.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        sx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(sy), ctypes.c_double(slope), ctypes.c_double(limit))
    return out


def ace_pixel_samples(page, idx, slope=10.0, limit=1000.0):
    """Per-pixel explicit samples: idx int32 [H, W, S] flat indices."""
    lib = _load()
    page = np.ascontiguousarray(page, np.uint8)
    idx = np.ascontiguousarray(idx, np.int32)
    h, w, _ = page.shape
    out = np.empty_like(page)
    lib.pf_oracle_ace_pixel_samples(
        _buf(page), _buf(out), h, w,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        idx.shape[-1], ctypes.c_double(slope), ctypes.c_double(limit))
    return out


def ace_rand(page, nb_samples=100, slope=10.0, limit=1000.0, seed=0):
    """Reference-faithful fully random per-pixel ACE (xorshift stream)."""
    lib = _load()
    page = np.ascontiguousarray(page, np.uint8)
    h, w, _ = page.shape
    out = np.empty_like(page)
    lib.pf_oracle_ace_rand(_buf(page), _buf(out), h, w, nb_samples,
                           ctypes.c_double(slope), ctypes.c_double(limit),
                           ctypes.c_uint64(seed))
    return out


def compare(a, b, tolerance=0):
    lib = _load()
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    h, w, _ = a.shape
    diff = np.empty_like(a)
    n = ctypes.c_int32(0)
    lib.pf_oracle_compare(_buf(a), _buf(b), _buf(diff), h, w, tolerance,
                          ctypes.byref(n))
    return int(n.value), diff

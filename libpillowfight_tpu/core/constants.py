"""Single source of truth for every algorithm constant in the framework.

The upstream reference (openpaperwork/libpillowfight) is mounted as a 2-file
stub (README + .gitignore; see /root/repo/SURVEY.md §0), so the numeric
constants below are reconstructed from the documented defaults of the
algorithms libpillowfight implements: the unpaper scan-filter family
(unpaper's published command-line defaults), the CCV/DetectText SWT port
(Epshtein CVPR'08), Rizzi et al.'s ACE, and standard Canny practice.

Parity contract: the C++ oracle under /root/repo/oracle is generated from
THIS file (`python -m libpillowfight_tpu.core.constants --emit-header`),
so the JAX kernels and the oracle share one definition of every constant.
Golden tests pin JAX output against the oracle per-pixel.

Reference-parity citations use upstream paths from SURVEY.md §2
(e.g. src/pillowfight/ace.c) — the files themselves are absent from the
mount, so no line numbers can be given.
"""

from __future__ import annotations

# --------------------------------------------------------------------------
# Pixel model (ref: include/pillowfight/util.h)
# --------------------------------------------------------------------------
PF_WHITE = 0xFF
PF_BLACK = 0x00

# Grayscale conversion: libpillowfight uses the unweighted channel mean
# (ref: src/pillowfight/util.c pf_rgb_bitmap_to_grayscale_dbl_matrix).
GRAYSCALE_MODE = "mean"  # gray = (r + g + b) / 3

# --------------------------------------------------------------------------
# Gaussian (ref: src/pillowfight/gaussian.c pf_gaussian)
# --------------------------------------------------------------------------
GAUSSIAN_DEFAULT_SIGMA = 2.0
GAUSSIAN_DEFAULT_NB_STDDEV = 5
# 1-D kernel half-width = ceil(sigma * nb_stddev); width = 2*hw + 1.
# Kernel: g(x) = exp(-x^2 / (2 sigma^2)), normalized to sum 1.

# --------------------------------------------------------------------------
# Sobel (ref: src/pillowfight/sobel.c pf_sobel)
# --------------------------------------------------------------------------
# Gx = [[-1,0,1],[-2,0,2],[-1,0,1]] ; Gy = Gx^T (standard Sobel).
# Output bitmap = intensity clamped to [0,255] (no min-max renormalize;
# the raw hypot of 8-bit gradients).

# --------------------------------------------------------------------------
# Canny (ref: src/pillowfight/canny.c pf_canny — no tunable C params)
# --------------------------------------------------------------------------
CANNY_GAUSSIAN_SIGMA = 2.0
CANNY_GAUSSIAN_NB_STDDEV = 5
# Double-threshold fractions of the max gradient intensity.
CANNY_LOW_THRESHOLD_FRACTION = 0.47 / 2.0  # weak-edge floor
CANNY_HIGH_THRESHOLD_FRACTION = 0.47       # strong-edge floor
# Hysteresis: weak pixels survive iff 8-connected to a strong pixel
# (transitively, flood fill / BFS in the reference).

# --------------------------------------------------------------------------
# ACE (ref: src/pillowfight/ace.c pf_ace; Rizzi et al. 2003)
# --------------------------------------------------------------------------
ACE_DEFAULT_NB_SAMPLES = 100
ACE_DEFAULT_SLOPE = 10.0
ACE_DEFAULT_LIMIT = 1000.0
ACE_DEFAULT_NB_THREADS = 2  # kept for API parity; ignored
ACE_DEFAULT_SEED = 0xACE5EED
# Per pixel p, per channel c (values in 0..255):
#   R_c(p)    = sum_s  sat(slope * (I_c(p) - I_c(s))) / d(p, s)
#   Rmax(p)   = sum_s  limit / d(p, s)
#   sat(x)    = clamp(x, -limit, +limit)
#   d(p, s)   = euclidean distance, s drawn uniformly over the page (s != p)
#   out_c(p)  = round(clamp((R_c/Rmax + 1) * 127.5, 0, 255))

# --------------------------------------------------------------------------
# SWT (ref: src/pillowfight/swt.c pf_swt; CCV DetectText port)
# --------------------------------------------------------------------------
SWT_OUTPUT_BW_TEXT = 0
SWT_OUTPUT_GRAYSCALE_TEXT = 1
SWT_OUTPUT_ORIGINAL_BOXES = 2

SWT_MAX_RAY_LEN = 128          # bounded ray march (static bound)
SWT_RAY_ANGLE_TOLERANCE = 0.5235987755982988  # pi/6: opposing-gradient cone
SWT_CC_SW_RATIO = 3.0          # connect pixels whose SW ratio <= 3
# Letter-candidate filters (CCV defaults):
SWT_LETTER_VARIANCE_RATIO = 0.5    # var(sw) <= ratio * mean(sw)^2 is kept
SWT_LETTER_ASPECT_RATIO_MAX = 10.0
SWT_LETTER_DIAMETER_SW_RATIO = 10.0  # diag / median_sw < 10
SWT_LETTER_HEIGHT_MIN = 10
SWT_LETTER_HEIGHT_MAX = 300
SWT_LETTER_MIN_PIXELS = 38     # reject tiny components (CCV: size filter)
SWT_MAX_NESTED_LETTERS = 2     # >2 nested boxes => reject as frame

# --------------------------------------------------------------------------
# unpaper thresholds shared across filters (unpaper published defaults)
# --------------------------------------------------------------------------
UNPAPER_BLACK_THRESHOLD = 0.33   # pixel is "black" if gray < 0.33 * 255
UNPAPER_WHITE_THRESHOLD = 0.9    # pixel is "non-white" if gray < 0.9 * 255

# blackfilter (ref: src/pillowfight/blackfilter.c; unpaper --blackfilter-*)
BLACKFILTER_SCAN_SIZE = 20
BLACKFILTER_SCAN_STEP = 5
BLACKFILTER_SCAN_THRESHOLD = 0.95   # square "blackness" ratio to trigger fill
BLACKFILTER_INTENSITY = 20          # flood gap-leap radius (px): dark pixels
                                    # within this Chebyshev distance are
                                    # connected (unpaper --blackfilter-intensity
                                    # "larger values will leap larger gaps")

# noisefilter (ref: src/pillowfight/noisefilter.c; unpaper --noisefilter-*)
NOISEFILTER_INTENSITY = 4   # clusters of <= 4 non-white pixels are erased

# blurfilter (ref: src/pillowfight/blurfilter.c; unpaper --blurfilter-*)
BLURFILTER_SIZE = 100
BLURFILTER_STEP = 50
BLURFILTER_INTENSITY = 0.01  # max dark ratio for a block to be "clean"

# grayfilter (ref: src/pillowfight/grayfilter.c; unpaper --grayfilter-*)
GRAYFILTER_SIZE = 50
GRAYFILTER_STEP = 20
GRAYFILTER_THRESHOLD = 0.5
# Wipe block iff it contains NO black pixel (UNPAPER_BLACK_THRESHOLD) and
# mean gray > 255 * (1 - GRAYFILTER_THRESHOLD)  (light gray shading).

# masks (ref: src/pillowfight/masks.c; unpaper --mask-scan-*)
MASKS_SCAN_SIZE = 50
MASKS_SCAN_STEP = 5
MASKS_SCAN_THRESHOLD = 0.1  # strip dark-ratio below which content has ended
# Start point: page center. Mask grows outward per direction until a scan
# strip's dark-pixel ratio (vs UNPAPER_BLACK_THRESHOLD) drops below
# MASKS_SCAN_THRESHOLD; everything outside the mask is wiped white.

# border (ref: src/pillowfight/border.c; unpaper --border-scan-*)
BORDER_SCAN_SIZE = 5
BORDER_SCAN_STEP = 5
BORDER_SCAN_THRESHOLD = 5  # dark-pixel COUNT above which a strip has content

# compare (ref: src/pillowfight/compare.c pf_compare)
COMPARE_DEFAULT_TOLERANCE = 0


def _emit_header() -> str:
    """Generate oracle/constants.h from this module (single source of truth)."""
    lines = [
        "// AUTO-GENERATED by libpillowfight_tpu.core.constants — do not edit.",
        "#pragma once",
        "",
    ]
    for name, val in sorted(globals().items()):
        if name.startswith("_") or not name.isupper():
            continue
        if isinstance(val, bool):
            lines.append(f"#define PFT_{name} {int(val)}")
        elif isinstance(val, int):
            lines.append(f"#define PFT_{name} {val}")
        elif isinstance(val, float):
            lines.append(f"#define PFT_{name} {val!r}")
        elif isinstance(val, str):
            lines.append(f'#define PFT_{name} "{val}"')
    lines.append("")
    return "\n".join(lines)


if __name__ == "__main__":
    import argparse
    import pathlib

    ap = argparse.ArgumentParser()
    ap.add_argument("--emit-header", action="store_true")
    ap.add_argument(
        "--out", default=str(pathlib.Path(__file__).parents[2] / "oracle" / "constants.h")
    )
    args = ap.parse_args()
    if args.emit_header:
        pathlib.Path(args.out).write_text(_emit_header())
        print(f"wrote {args.out}")

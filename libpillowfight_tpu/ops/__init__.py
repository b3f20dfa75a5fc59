"""Algorithm kernels (the reference's L2 — SURVEY.md §2.2), batched JAX."""

from .ace import ace, ace_with_samples
from .canny import canny, canny_edge_mask
from .gaussian import gaussian, gaussian_on_matrix
from .sobel import GradientMatrixes, sobel, sobel_on_matrix
from .unpaper import (
    unpaper_blackfilter,
    unpaper_blurfilter,
    unpaper_border,
    unpaper_grayfilter,
    unpaper_masks,
    unpaper_noisefilter,
)

__all__ = [
    "ace",
    "ace_with_samples",
    "canny",
    "canny_edge_mask",
    "gaussian",
    "gaussian_on_matrix",
    "GradientMatrixes",
    "sobel",
    "sobel_on_matrix",
    "unpaper_blackfilter",
    "unpaper_blurfilter",
    "unpaper_border",
    "unpaper_grayfilter",
    "unpaper_masks",
    "unpaper_noisefilter",
]

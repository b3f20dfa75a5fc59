"""Drop-in `pillowfight` module (ref: src/pillowfight/__init__.py —
SURVEY.md §1 L4: `import pillowfight; pillowfight.ace(img)`).

Existing pypillowfight user code runs unmodified against this build:
this top-level shim re-exports the compat façade from
`libpillowfight_tpu.compat` (PIL.Image in -> PIL.Image out, same public
names, enums, and defaults as the reference's Python package).
"""

from libpillowfight_tpu.compat import (  # noqa: F401
    SWT_OUTPUT_BW_TEXT,
    SWT_OUTPUT_GRAYSCALE_TEXT,
    SWT_OUTPUT_ORIGINAL_BOXES,
    __all__,
    ace,
    canny,
    compare,
    gaussian,
    get_version,
    sobel,
    swt,
    unpaper_blackfilter,
    unpaper_blurfilter,
    unpaper_border,
    unpaper_grayfilter,
    unpaper_masks,
    unpaper_noisefilter,
)

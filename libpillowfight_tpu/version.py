"""Version component (ref: src/pillowfight/version.c pf_get_version +
generated _version.h — SURVEY.md §2.1 / §3.5).

The reference bakes the git tag into a generated header at build time;
here the version is resolved at import: an installed package version if
present, else `git describe` of the working tree, else the static default.
"""

from __future__ import annotations

import os
import subprocess

__version__ = "0.4.0"


def get_version() -> str:
    try:
        from importlib.metadata import version

        return version("libpillowfight-tpu")
    except Exception:
        pass
    try:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        out = subprocess.run(
            ["git", "describe", "--tags", "--always", "--dirty"],
            cwd=root, capture_output=True, text=True, timeout=5,
        )
        if out.returncode == 0 and out.stdout.strip():
            return f"{__version__}+{out.stdout.strip()}"
    except Exception:
        pass
    return __version__

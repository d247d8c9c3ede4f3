"""Filesystem cleanup of temp artifacts (contract: helpers.py:579-589)."""
# A copy of ``whisper_nemo_tpu/utils/cleanup.py``, carried so that the
# port imports nothing of the JAX package.

from __future__ import annotations

import os
import shutil


def cleanup(path: str) -> None:
    """Remove a file, symlink, or directory tree; raise on anything else."""
    if os.path.isfile(path) or os.path.islink(path):
        os.remove(path)
    elif os.path.isdir(path):
        shutil.rmtree(path)
    else:
        raise ValueError(f"Path {path} is not a file or dir.")

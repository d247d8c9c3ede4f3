"""Structured logging for pipeline stages.

A copy of ``whisper_nemo_tpu/utils/logging.py``, carried so that the
port imports nothing of the JAX package.

The reference mixes stdlib logging with emoji prints (SURVEY §5); here a
single logger factory with a stage-timing helper replaces both.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Iterator

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def get_logger(name: str = "whisper_nemo_tpu") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


@contextlib.contextmanager
def stage_timer(stage: str, logger: logging.Logger | None = None) -> Iterator[dict]:
    """Log wall-clock duration of a pipeline stage; yields a dict that
    receives ``{"seconds": ...}`` on exit so callers can collect timings."""
    logger = logger or get_logger()
    info: dict = {}
    start = time.perf_counter()
    try:
        yield info
    finally:
        info["seconds"] = time.perf_counter() - start
        logger.info("stage %s took %.3fs", stage, info["seconds"])

"""Profiling hooks.

Counterpart of ``whisper_nemo_tpu/utils/profiling.py``: stage timing
lives in ``utils.logging.stage_timer``, and deep profiling records a
``torch.profiler`` trace of the host and the CUDA device, written as a
Chrome trace viewable in Perfetto or TensorBoard.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

from .logging import get_logger

logger = get_logger(__name__)


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Record a trace of the enclosed block (the CPU, and CUDA where it is
    available) into ``log_dir``; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof
    logger.info("profiler trace written to %s", log_dir)


def annotate(name: str):
    """Named trace span (shows up in the profiler timeline)."""
    return torch.profiler.record_function(name)

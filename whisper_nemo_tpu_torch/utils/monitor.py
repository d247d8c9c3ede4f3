"""Device memory reporting.

Counterpart of ``whisper_nemo_tpu/utils/monitor.py`` (the replacement for
the reference's nvidia-smi shell-out, main.py:85-100): per-device memory
from ``torch.cuda``, under the JAX package's keys, printed in the same
one-line spirit.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .logging import get_logger

logger = get_logger(__name__)


def device_memory_stats() -> List[Dict]:
    """Per CUDA device: bytes allocated by PyTorch now (``bytes_in_use``),
    the device's total memory (``bytes_limit``) and the most allocated
    since the last peak reset (``peak_bytes_in_use``). Without CUDA, one
    entry for the CPU with the three at None."""
    if not torch.cuda.is_available():
        return [{"device": "cpu", "bytes_in_use": None, "bytes_limit": None,
                 "peak_bytes_in_use": None}]
    return [
        {
            "device": f"cuda:{i}",
            "bytes_in_use": torch.cuda.memory_allocated(i),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
        }
        for i in range(torch.cuda.device_count())
    ]


def monitor_device_usage() -> None:
    """Log one line per device (contract: the reference's
    ``monitor_gpu_usage`` print, main.py:96)."""
    for s in device_memory_stats():
        used = s["bytes_in_use"]
        limit = s["bytes_limit"]
        if used is not None and limit:
            logger.info(
                "%s: %.0f/%.0f MB (%.1f%%)",
                s["device"],
                used / 2**20,
                limit / 2**20,
                100.0 * used / limit,
            )
        else:
            logger.info("%s: memory stats unavailable", s["device"])

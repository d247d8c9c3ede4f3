"""Energy-based voice activity detection.

Counterpart of ``whisper_nemo_tpu/vad/energy.py``: frame log-RMS energy,
normalized between the 10th and 95th percentiles into a pseudo speech
probability, then the hysteresis binarization of ``vad/binarize.py``.
Long recordings take their frame energies on the device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..ops.framing import frame_energy
from .binarize import binarize_probs, filter_segments

SAMPLE_RATE = 16000
DEVICE_ENERGY_FRAMES = 20_000  # above this, frame energies run on the device


def frame_energy_probs(
    audio: np.ndarray,
    frame_shift: float = 0.02,
    frame_length: float = 0.04,
    *,
    device,
    wave: Optional[torch.Tensor] = None,
) -> np.ndarray:
    """Pseudo speech probabilities in [0, 1] from log-RMS energy. Long
    recordings take their frame energies on ``device``, which the caller
    names; ``wave``, when given, is ``audio`` already on it."""
    hop = int(frame_shift * SAMPLE_RATE)
    win = int(frame_length * SAMPLE_RATE)
    if len(audio) < win:
        return np.zeros(0, np.float32)
    n_frames = 1 + (len(audio) - win) // hop
    if n_frames > DEVICE_ENERGY_FRAMES:
        if wave is None:
            wave = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(device)
        window_energy = (
            frame_energy(wave, n_frames, win, hop).cpu().numpy().astype(np.float64)
        )
    else:
        csum = np.concatenate([[0.0], np.cumsum(np.asarray(audio, np.float64) ** 2)])
        starts = hop * np.arange(n_frames)
        window_energy = (csum[starts + win] - csum[starts]) / win
    rms = np.sqrt(window_energy + 1e-12)
    log_e = 20 * np.log10(rms + 1e-12)
    lo, hi = np.percentile(log_e, 10), np.percentile(log_e, 95)
    if hi - lo < 6.0:  # nearly constant energy: all speech or all silence
        return (
            np.ones_like(log_e, np.float32)
            if hi > -45.0
            else np.zeros_like(log_e, np.float32)
        )
    probs = (log_e - lo) / (hi - lo)
    return np.clip(probs, 0.0, 1.0).astype(np.float32)


def get_speech_timestamps(
    audio: np.ndarray,
    onset: float = 0.6,
    offset: float = 0.4,
    min_duration_on: float = 0.1,
    min_duration_off: float = 0.3,
    pad: float = 0.1,
    frame_shift: float = 0.02,
    *,
    device,
    wave: Optional[torch.Tensor] = None,
) -> List[dict]:
    """Speech spans as ``[{"start": s0, "end": s1}, ...]`` in samples."""
    probs = frame_energy_probs(audio, frame_shift=frame_shift, device=device, wave=wave)
    segs = binarize_probs(probs, frame_shift, onset, offset, pad_onset=pad, pad_offset=pad)
    segs = filter_segments(segs, min_duration_on, min_duration_off)
    duration = len(audio) / SAMPLE_RATE
    return [
        {"start": int(s * SAMPLE_RATE), "end": int(min(e, duration) * SAMPLE_RATE)}
        for s, e in segs
    ]

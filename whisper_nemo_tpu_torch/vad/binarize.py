"""Frame-probability → speech-segment binarization.

A copy of ``whisper_nemo_tpu/vad/binarize.py``, carried so that the
port imports nothing of the JAX package.

Implements the NeMo-style VAD postprocessing contract driven by the
``VadParams`` config (reference telephonic.yaml:26-37 and the overrides
in helpers.py:296-298): onset/offset hysteresis thresholds, segment
padding, minimum on/off durations, and optional median smoothing. Used
by both the MarbleNet VAD and the energy fallback VAD.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def median_smooth(probs: np.ndarray, window_frames: int) -> np.ndarray:
    """Sliding median filter over frame probabilities."""
    if window_frames <= 1:
        return probs
    pad = window_frames // 2
    padded = np.pad(probs, (pad, pad), mode="edge")
    windows = np.lib.stride_tricks.sliding_window_view(padded, window_frames)
    return np.median(windows, axis=-1)[: len(probs)]


def binarize_probs(
    probs: np.ndarray,
    frame_shift: float,
    onset: float = 0.5,
    offset: float = 0.3,
    pad_onset: float = 0.0,
    pad_offset: float = 0.0,
) -> List[Tuple[float, float]]:
    """Hysteresis binarization of frame speech probabilities.

    A segment opens when prob rises above ``onset`` and closes when it
    falls below ``offset``; boundaries are padded by ``pad_onset`` /
    ``pad_offset`` seconds (which may be negative, as the reference's
    pad_offset=-0.05 override is). Returns [(start_s, end_s), ...].
    """
    probs = np.asarray(probs)
    n = len(probs)
    if n == 0:
        return []
    # vectorized hysteresis: the state at frame i is the sign of the
    # most recent onset/offset event (frames between thresholds keep
    # the previous state)
    events = np.where(
        probs >= onset, 1, np.where(probs < offset, -1, 0)
    )
    idx = np.arange(n)
    last_event = np.maximum.accumulate(np.where(events != 0, idx, -1))
    state = np.where(
        last_event >= 0, events[np.maximum(last_event, 0)] > 0, False
    )
    edges = np.diff(np.concatenate([[False], state, [False]]).astype(int))
    starts = np.nonzero(edges == 1)[0]
    ends = np.nonzero(edges == -1)[0]
    segments: List[Tuple[float, float]] = [
        (float(s * frame_shift), float(e * frame_shift))
        for s, e in zip(starts, ends)
    ]

    padded = []
    for s, e in segments:
        s = max(0.0, s - pad_onset)
        e = e + pad_offset
        if e > s:
            padded.append((s, e))
    # merge overlaps introduced by padding
    merged: List[Tuple[float, float]] = []
    for s, e in padded:
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def filter_segments(
    segments: List[Tuple[float, float]],
    min_duration_on: float = 0.0,
    min_duration_off: float = 0.0,
) -> List[Tuple[float, float]]:
    """Drop short speech segments and fill short gaps.

    ``min_duration_off``: gaps shorter than this merge the neighbors
    (short-pause deletion); ``min_duration_on``: segments shorter than
    this are removed — matching NeMo's ordering (gaps first).
    """
    if not segments:
        return []
    merged = [list(segments[0])]
    for s, e in segments[1:]:
        if s - merged[-1][1] < min_duration_off:
            merged[-1][1] = e
        else:
            merged.append([s, e])
    return [
        (s, e) for s, e in merged if (e - s) >= min_duration_on
    ]

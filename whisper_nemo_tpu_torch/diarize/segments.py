"""Multiscale segmentation of speech regions.

A copy of ``whisper_nemo_tpu/diarize/segments.py``, carried so that the
port imports nothing of the JAX package.

The reference's diarizer cuts VAD speech into overlapping windows at
several scales (telephonic: [1.5, 1.25, 1.0, 0.75, 0.5] s windows with
half shifts — reference telephonic.yaml:40-45) and maps every base-scale
(finest) segment to its closest segment at each coarser scale for the
multiscale affinity. This module is pure interval arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class ScaleSegment:
    start: float
    end: float

    @property
    def center(self) -> float:
        return 0.5 * (self.start + self.end)


def segment_speech_regions(
    regions: Sequence[Tuple[float, float]],
    window: float,
    shift: float,
    min_tail: float = 0.25,
) -> List[ScaleSegment]:
    """Slide a window over each speech region.

    Every region yields at least one segment (clipped to the region when
    shorter than the window); the final window is anchored to the region
    end so audio near boundaries is always covered.
    """
    segments: List[ScaleSegment] = []
    for r_start, r_end in regions:
        dur = r_end - r_start
        if dur <= 0:
            continue
        if dur <= window:
            segments.append(ScaleSegment(r_start, r_end))
            continue
        t = r_start
        while t + window < r_end - 1e-9:
            segments.append(ScaleSegment(t, t + window))
            t += shift
        segments.append(ScaleSegment(r_end - window, r_end))
    return segments


def multiscale_segmentation(
    regions: Sequence[Tuple[float, float]],
    window_lengths: Sequence[float],
    shift_lengths: Sequence[float],
) -> List[List[ScaleSegment]]:
    """Segments per scale, ordered as configured (base scale = last/
    finest, matching NeMo's convention of listing coarse→fine)."""
    return [
        segment_speech_regions(regions, w, s)
        for w, s in zip(window_lengths, shift_lengths)
    ]


def map_scales_to_base(
    scale_segments: List[List[ScaleSegment]],
) -> np.ndarray:
    """[n_scales, n_base] index map: for each base-scale segment, the
    closest-centered segment at every scale (NeMo's multiscale mapping).
    The base scale is the last (finest) one."""
    base = scale_segments[-1]
    base_centers = np.array([s.center for s in base])
    n_scales = len(scale_segments)
    mapping = np.zeros((n_scales, len(base)), np.int64)
    for si, segs in enumerate(scale_segments):
        centers = np.array([s.center for s in segs])
        # nearest center via bisection on the (time-ordered) centers:
        # O(n log m) — the naive [m, n] distance matrix costs tens of
        # seconds at hour scale (measured 36 s at n_base≈7.5k)
        order = np.argsort(centers, kind="stable")
        sorted_centers = centers[order]
        if len(sorted_centers) == 1:
            continue  # mapping stays 0
        j = np.searchsorted(sorted_centers, base_centers)
        j = np.clip(j, 1, len(sorted_centers) - 1)
        left_closer = np.abs(
            base_centers - sorted_centers[j - 1]
        ) <= np.abs(sorted_centers[j] - base_centers)
        nearest = np.where(left_closer, j - 1, j)
        mapping[si] = order[nearest]
    return mapping


def merge_frame_labels_to_turns(
    times: Sequence[Tuple[float, float]],
    labels: Sequence[int],
    gap_tolerance: float = 0.0,
) -> List[Tuple[float, float, int]]:
    """Per-segment speaker labels → merged speaker turns.

    Consecutive same-speaker segments merge when they touch or overlap
    (within ``gap_tolerance``); overlapping different-speaker segments
    split at the midpoint of the overlap.
    """
    if not times:
        return []
    order = np.argsort([t[0] for t in times])
    turns: List[List] = []
    for i in order:
        s, e = times[i]
        lab = int(labels[i])
        if turns and turns[-1][2] == lab and s <= turns[-1][1] + gap_tolerance:
            turns[-1][1] = max(turns[-1][1], e)
        elif turns and s < turns[-1][1]:
            mid = 0.5 * (s + turns[-1][1])
            turns[-1][1] = mid
            turns.append([mid, e, lab])
        else:
            turns.append([s, e, lab])
    return [(s, e, l) for s, e, l in turns if e > s]

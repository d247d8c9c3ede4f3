"""Diarization scoring: DER (diarization error rate).

A copy of ``whisper_nemo_tpu/diarize/metrics.py``, carried so that the
port imports nothing of the JAX package.

The BASELINE.json quality target is "DER within 0.5 abs of the
reference pipeline on test assets". This implements standard
NIST-style DER with collar and optional overlap handling (the
reference's scoring knobs: ``collar: 0.25`` and ``ignore_overlap:
True``, telephonic.yaml:20-21), including optimal speaker mapping via
greedy/Hungarian assignment over pairwise overlap.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

Turn = Tuple[float, float, int]  # (start_s, end_s, speaker)


def _merge_intervals(ivs: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    if not ivs:
        return []
    ivs = sorted(ivs)
    out = [list(ivs[0])]
    for s, e in ivs[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _total(ivs: Sequence[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in ivs)


def _intersect(
    a: Sequence[Tuple[float, float]], b: Sequence[Tuple[float, float]]
) -> float:
    total = 0.0
    for s1, e1 in a:
        for s2, e2 in b:
            total += max(0.0, min(e1, e2) - max(s1, s2))
    return total


def _apply_collar(
    turns: Sequence[Turn], collar: float
) -> List[Tuple[float, float]]:
    """Forgiveness zones: ±collar around every reference boundary."""
    zones = []
    for s, e, _ in turns:
        zones.append((s - collar, s + collar))
        zones.append((e - collar, e + collar))
    return _merge_intervals(zones)


def _subtract(
    ivs: List[Tuple[float, float]], cut: List[Tuple[float, float]]
) -> List[Tuple[float, float]]:
    """Interval-set difference ivs − cut."""
    result = list(ivs)
    for cs, ce in cut:
        next_result = []
        for s, e in result:
            if ce <= s or cs >= e:
                next_result.append((s, e))
                continue
            if s < cs:
                next_result.append((s, cs))
            if ce < e:
                next_result.append((ce, e))
        result = next_result
    return result


def optimal_speaker_mapping(
    reference: Sequence[Turn], hypothesis: Sequence[Turn]
) -> Dict[int, int]:
    """Map hypothesis speaker ids to reference ids maximizing overlap
    (Hungarian assignment over the pairwise-overlap matrix)."""
    ref_ids = sorted({t[2] for t in reference})
    hyp_ids = sorted({t[2] for t in hypothesis})
    if not ref_ids or not hyp_ids:
        return {}
    overlap = np.zeros((len(hyp_ids), len(ref_ids)))
    for i, h in enumerate(hyp_ids):
        h_ivs = [(s, e) for s, e, spk in hypothesis if spk == h]
        for j, r in enumerate(ref_ids):
            r_ivs = [(s, e) for s, e, spk in reference if spk == r]
            overlap[i, j] = _intersect(h_ivs, r_ivs)
    try:
        from scipy.optimize import linear_sum_assignment

        rows, cols = linear_sum_assignment(-overlap)
        return {hyp_ids[i]: ref_ids[j] for i, j in zip(rows, cols)}
    except ImportError:  # greedy fallback
        mapping: Dict[int, int] = {}
        used = set()
        order = np.argsort(-overlap, axis=None)
        for flat in order:
            i, j = divmod(int(flat), len(ref_ids))
            if hyp_ids[i] in mapping or ref_ids[j] in used:
                continue
            mapping[hyp_ids[i]] = ref_ids[j]
            used.add(ref_ids[j])
        return mapping


def diarization_error_rate(
    reference: Sequence[Turn],
    hypothesis: Sequence[Turn],
    collar: float = 0.25,
    ignore_overlap: bool = True,
    step: float = 0.01,
) -> Dict[str, float]:
    """DER = (missed + false alarm + confusion) / reference speech.

    Frame-based scoring at ``step`` resolution with boundary collars
    removed from scoring, matching the reference config's collar=0.25 /
    ignore_overlap=True defaults. Returns the component rates too.
    """
    if not reference:
        return {"der": 0.0 if not hypothesis else 1.0,
                "missed": 0.0, "false_alarm": 0.0, "confusion": 0.0}

    mapping = optimal_speaker_mapping(reference, hypothesis)
    hyp = [(s, e, mapping.get(spk, -1)) for s, e, spk in hypothesis]

    end = max(max(e for _, e, _ in reference),
              max((e for _, e, _ in hyp), default=0.0))
    n = int(np.ceil(end / step)) + 1
    times = (np.arange(n) + 0.5) * step

    def stack(turns):
        ids = sorted({t[2] for t in turns})
        active = np.zeros((len(ids), n), bool)
        for s, e, spk in turns:
            k = ids.index(spk)
            active[k, (times >= s) & (times < e)] = True
        return ids, active

    ref_ids, ref_act = stack(reference)
    hyp_ids, hyp_act = stack(hyp)

    scored = np.ones(n, bool)
    for cs, ce in _apply_collar(reference, collar):
        scored &= ~((times >= cs) & (times < ce))
    ref_count = ref_act.sum(axis=0)
    if ignore_overlap:
        scored &= ref_count <= 1

    ref_n = ref_count[scored]
    hyp_n = hyp_act.sum(axis=0)[scored]

    # correct: frames where a mapped hypothesis speaker matches an
    # active reference speaker
    match = np.zeros(n, int)
    for i, h in enumerate(hyp_ids):
        if h < 0:
            continue
        if h in ref_ids:
            j = ref_ids.index(h)
            match += (hyp_act[i] & ref_act[j]).astype(int)
    correct = match[scored]

    total_ref = float(ref_n.sum()) * step
    if total_ref == 0:
        return {"der": 0.0, "missed": 0.0, "false_alarm": 0.0,
                "confusion": 0.0}

    missed = float(np.maximum(ref_n - hyp_n, 0).sum()) * step
    false_alarm = float(np.maximum(hyp_n - ref_n, 0).sum()) * step
    confusion = float(
        (np.minimum(ref_n, hyp_n) - correct).clip(min=0).sum()
    ) * step

    return {
        "der": (missed + false_alarm + confusion) / total_ref,
        "missed": missed / total_ref,
        "false_alarm": false_alarm / total_ref,
        "confusion": confusion / total_ref,
    }

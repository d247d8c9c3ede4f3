"""Segment-level speaker merge, smoothing and formatted transcript.

A copy of ``whisper_nemo_tpu/post/merge.py``, carried so that the
port imports nothing of the JAX package.

These implement the serverless path's post-processing contracts
(reference main.py:163-315):

- overlap-based assignment of each ASR segment to the diarization turn it
  overlaps most, with a confidence (1 − no_speech_prob) and an
  ``overlap_quality`` ratio;
- smoothing that re-assigns short low-confidence segments sandwiched
  between a single speaker;
- the French-labeled human-readable transcript with per-speaker stats.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Dict, Iterable, List, Sequence

UNKNOWN_SPEAKER = "INCONNU"


def format_timestamp_mmss(seconds: float) -> str:
    """Seconds → ``MM:SS`` (contract: main.py:140-142)."""
    return str(timedelta(seconds=int(seconds)))[2:]


def merge_transcription_with_speakers_improved(
    whisper_segments: Iterable[dict],
    speaker_turns: Sequence[dict],
) -> List[dict]:
    """Assign each ASR segment the speaker with maximal temporal overlap.

    ``speaker_turns``: dicts with ``start``/``end``/``speaker`` (seconds) —
    the itertracks-flattened diarization output. Segments overlapping no
    turn get the ``INCONNU`` label. Contract: main.py:163-212, including
    the trailing smoothing pass.
    """
    merged: List[dict] = []
    for segment in whisper_segments:
        seg_start = segment["start"]
        seg_end = segment["end"]

        best_speaker = UNKNOWN_SPEAKER
        best_overlap = 0.0
        for turn in speaker_turns:
            lo = max(seg_start, turn["start"])
            hi = min(seg_end, turn["end"])
            overlap = max(0.0, hi - lo)
            if overlap > best_overlap:
                best_overlap = overlap
                best_speaker = turn["speaker"]

        duration = seg_end - seg_start
        merged.append(
            {
                "start": seg_start,
                "end": seg_end,
                "duration": duration,
                "speaker": best_speaker,
                "text": segment["text"].strip(),
                "confidence": 1 - segment.get("no_speech_prob", 0),
                "overlap_quality": best_overlap / duration,
            }
        )

    return smooth_speaker_transitions(merged)


def smooth_speaker_transitions(segments: List[dict]) -> List[dict]:
    """Re-assign short, low-confidence segments sandwiched between one
    speaker to that speaker (contract: main.py:214-238).
    """
    if len(segments) < 3:
        return segments

    smoothed = segments.copy()
    for i in range(1, len(smoothed) - 1):
        current = smoothed[i]
        prev_speaker = smoothed[i - 1]["speaker"]
        next_speaker = smoothed[i + 1]["speaker"]
        if (
            current["duration"] < 2.0
            and prev_speaker == next_speaker
            and current["speaker"] != prev_speaker
            and current["overlap_quality"] < 0.8
        ):
            smoothed[i]["speaker"] = prev_speaker
            smoothed[i]["smoothed"] = True
    return smoothed


def _speaker_stats(segments: Sequence[dict]) -> Dict[str, dict]:
    stats: Dict[str, dict] = {}
    for segment in segments:
        entry = stats.setdefault(
            segment["speaker"],
            {
                "total_time": 0.0,
                "segments_count": 0,
                "texts": [],
                "avg_confidence": 0.0,
            },
        )
        entry["total_time"] += segment["duration"]
        entry["segments_count"] += 1
        entry["texts"].append(segment["text"])
        entry["avg_confidence"] += segment["confidence"]

    total_end = segments[-1]["end"]
    for entry in stats.values():
        entry["avg_confidence"] /= entry["segments_count"]
        entry["percentage"] = entry["total_time"] / total_end * 100
    return stats


def create_readable_transcript_improved(segments: Sequence[dict]) -> str:
    """Build the formatted transcript: participant stats, chronological
    log, and a per-speaker digest (contract: main.py:240-315, including
    the French labels and emoji markers the serverless API returns).
    """
    if not segments:
        return "Aucune transcription disponible."

    stats = _speaker_stats(segments)
    lines: List[str] = ["=== TRANSCRIPTION OPTIMISÉE ===\n"]

    lines.append("📊 ANALYSE DES PARTICIPANTS:")
    for speaker, entry in stats.items():
        conf = int(entry["avg_confidence"] * 100)
        lines.append(
            f"🗣️ {speaker}: {entry['total_time']:.1f}s"
            f" ({entry['percentage']:.1f}%) - Confiance: {conf}%"
        )

    lines.append("\n" + "=" * 60)
    lines.append("📝 CONVERSATION CHRONOLOGIQUE:")
    current_speaker = None
    for segment in segments:
        start = format_timestamp_mmss(segment["start"])
        end = format_timestamp_mmss(segment["end"])
        confidence = int(segment["confidence"] * 100)
        speaker_change = ""
        if segment["speaker"] != current_speaker:
            speaker_change = f"\n👤 {segment['speaker']} prend la parole:"
            current_speaker = segment["speaker"]
        quality_icon = "🔧" if segment.get("smoothed") else ""
        lines.append(
            f"{speaker_change}\n[{start}-{end}] {segment['text']}"
            f" ({confidence}%) {quality_icon}"
        )

    lines.append("\n" + "=" * 60)
    lines.append("💬 RÉSUMÉ PAR PARTICIPANT:")
    for speaker, entry in stats.items():
        lines.append(
            f"\n🗣️ {speaker} ({entry['percentage']:.1f}% du temps):"
        )
        full_text = " ".join(entry["texts"])
        sentences = (
            full_text.replace(". ", ".\n   ")
            .replace("? ", "?\n   ")
            .replace("! ", "!\n   ")
        )
        lines.append(f"   {sentences}")

    return "\n".join(lines)

"""RTTM (Rich Transcription Time Marked) read/write.

A copy of ``whisper_nemo_tpu/diarize/rttm.py``, carried so that the
port imports nothing of the JAX package.

The RTTM file is the handoff artifact between the diarization branch and
the merge stage. Writer emits NIST-style SPEAKER lines with ``speaker_N``
labels; the parser implements the reference's field positions
(diarize.py:209-216: field 5 = start seconds, field 8 = duration seconds,
field 11 = ``speaker_N``).
"""

from __future__ import annotations

from typing import Iterable, List, Tuple


def write_rttm(
    path: str,
    turns: Iterable[Tuple[float, float, int]],
    uri: str = "mono_file",
) -> None:
    """Write ``(start_s, end_s, speaker_id)`` turns as RTTM SPEAKER lines.

    Uses NeMo's exact column spacing (three spaces around start/duration),
    because the reference's inline parser (diarize.py:209-216) splits on
    single spaces and reads positions 5/8/11 — positions that only line up
    when the empty strings produced by the triple spaces are counted. Files
    written here are therefore byte-parseable by the reference CLI.
    """
    with open(path, "w") as f:
        for start, end, speaker in turns:
            f.write(
                f"SPEAKER {uri} 1   {start:.3f}   {end - start:.3f} "
                f"<NA> <NA> speaker_{speaker} <NA> <NA>\n"
            )


def parse_rttm(lines: Iterable[str]) -> List[List[int]]:
    """Parse RTTM lines to ``[start_ms, end_ms, speaker_id]`` rows.

    Whitespace-robust equivalent of the reference's positional parser
    (diarize.py:209-216): after collapsing runs of whitespace, a SPEAKER
    line reads ``SPEAKER uri chan start dur <NA> <NA> label <NA> <NA>``.
    """
    turns: List[List[int]] = []
    for line in lines:
        tokens = line.split()
        if len(tokens) < 8 or tokens[0] != "SPEAKER":
            continue
        start_ms = int(float(tokens[3]) * 1000)
        end_ms = start_ms + int(float(tokens[4]) * 1000)
        speaker = int(tokens[7].split("_")[-1])
        turns.append([start_ms, end_ms, speaker])
    return turns


def read_speaker_timestamps(path: str) -> List[List[int]]:
    """Read an RTTM file into ``[start_ms, end_ms, speaker_id]`` rows."""
    with open(path) as f:
        return parse_rttm(f.readlines())

"""Transcript/SRT writers (output bit-compatibility layer).

A copy of ``whisper_nemo_tpu/post/writers.py``, carried so that the
port imports nothing of the JAX package.

Contracts: reference helpers.py:463-514 — paragraph-per-speaker text
transcript, SRT blocks with ``HH:MM:SS,mmm`` timestamps and ``-->``
sanitization inside cue text.
"""

from __future__ import annotations

from typing import IO, Iterable, Sequence


def format_timestamp(
    milliseconds: float,
    always_include_hours: bool = False,
    decimal_marker: str = ".",
) -> str:
    """Render a millisecond offset as ``[HH:]MM:SS<marker>mmm``.

    Contract: reference helpers.py:480-497 (floor-division decomposition;
    hours omitted when zero unless forced).
    """
    assert milliseconds >= 0, "non-negative timestamp expected"
    hours, milliseconds = divmod(milliseconds, 3_600_000)
    minutes, milliseconds = divmod(milliseconds, 60_000)
    seconds, milliseconds = divmod(milliseconds, 1_000)
    prefix = f"{int(hours):02d}:" if always_include_hours or hours > 0 else ""
    return (
        f"{prefix}{int(minutes):02d}:{int(seconds):02d}"
        f"{decimal_marker}{int(milliseconds):03d}"
    )


def get_speaker_aware_transcript(
    sentences_speaker_mapping: Sequence[dict], f: IO[str]
) -> None:
    """Write the paragraph-per-speaker text transcript.

    Contract: reference helpers.py:463-477.
    """
    previous_speaker = sentences_speaker_mapping[0]["speaker"]
    f.write(f"{previous_speaker}: ")
    for sentence in sentences_speaker_mapping:
        if sentence["speaker"] != previous_speaker:
            f.write(f"\n\n{sentence['speaker']}: ")
            previous_speaker = sentence["speaker"]
        f.write(sentence["text"] + " ")


def write_srt(transcript: Iterable[dict], file: IO[str]) -> None:
    """Write speaker-attributed sentences as an SRT subtitle file.

    Contract: reference helpers.py:500-514 (1-based cue numbering, comma
    decimal marker, forced hours, ``-->`` inside text replaced by ``->``).
    """
    for i, segment in enumerate(transcript, start=1):
        start = format_timestamp(
            segment["start_time"], always_include_hours=True, decimal_marker=","
        )
        end = format_timestamp(
            segment["end_time"], always_include_hours=True, decimal_marker=","
        )
        text = segment["text"].strip().replace("-->", "->")
        print(
            f"{i}\n{start} --> {end}\n{segment['speaker']}: {text}\n",
            file=file,
            flush=True,
        )

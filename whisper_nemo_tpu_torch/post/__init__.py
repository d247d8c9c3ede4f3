# A copy of ``whisper_nemo_tpu/post/__init__.py``, carried so that the
# port imports nothing of the JAX package.
from .speaker_map import (
    filter_missing_timestamps,
    get_realigned_ws_mapping_with_punctuation,
    get_sentences_speaker_mapping,
    get_word_ts_anchor,
    get_words_speaker_mapping,
)
from .punctuate import apply_punctuation_labels
from .writers import (
    format_timestamp,
    get_speaker_aware_transcript,
    write_srt,
)
from .merge import (
    create_readable_transcript_improved,
    merge_transcription_with_speakers_improved,
    smooth_speaker_transitions,
)

__all__ = [
    "apply_punctuation_labels",
    "create_readable_transcript_improved",
    "filter_missing_timestamps",
    "format_timestamp",
    "get_realigned_ws_mapping_with_punctuation",
    "get_sentences_speaker_mapping",
    "get_speaker_aware_transcript",
    "get_word_ts_anchor",
    "get_words_speaker_mapping",
    "merge_transcription_with_speakers_improved",
    "smooth_speaker_transitions",
    "write_srt",
]

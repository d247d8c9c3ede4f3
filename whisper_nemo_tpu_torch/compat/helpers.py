"""Drop-in surface for the reference's ``helpers`` module.

A copy of ``whisper_nemo_tpu/compat/helpers.py``, carried so that the
port imports nothing of the JAX package.

Code written against the reference (``from helpers import X``,
diarize.py:21-34) can switch to ``from whisper_nemo_tpu.compat.helpers
import X`` unchanged: every public symbol the reference CLI imports is
re-exported here with the same name and contract.
"""

from ..config import create_config
from ..post.punctuate import ENDING_PUNCTS as sentence_ending_punctuations
from ..post.speaker_map import (
    filter_missing_timestamps,
    get_realigned_ws_mapping_with_punctuation,
    get_sentences_speaker_mapping,
    get_word_ts_anchor,
    get_words_speaker_mapping,
)
from ..post.writers import (
    format_timestamp,
    get_speaker_aware_transcript,
    write_srt,
)
from ..text.languages import (
    LANGUAGES,
    TO_LANGUAGE_CODE,
    langs_to_iso,
    process_language_arg,
    punct_model_langs,
    whisper_langs,
)
from ..text.tokenizer import find_numeral_symbol_tokens
from ..utils.cleanup import cleanup

__all__ = [
    "LANGUAGES",
    "TO_LANGUAGE_CODE",
    "cleanup",
    "create_config",
    "filter_missing_timestamps",
    "find_numeral_symbol_tokens",
    "format_timestamp",
    "get_realigned_ws_mapping_with_punctuation",
    "get_sentences_speaker_mapping",
    "get_speaker_aware_transcript",
    "get_word_ts_anchor",
    "get_words_speaker_mapping",
    "langs_to_iso",
    "process_language_arg",
    "punct_model_langs",
    "sentence_ending_punctuations",
    "whisper_langs",
    "write_srt",
]

"""Text preprocessing for CTC forced alignment.

A copy of ``whisper_nemo_tpu/align/text.py``, carried so that the
port imports nothing of the JAX package.

Mirrors ctc-forced-aligner's preprocessing contract (reference
diarize.py:170-174): the transcript is normalized/romanized, split into
words, and each word is bracketed by ``<star>`` wildcard tokens so the
aligner can absorb untranscribed audio.

Romanization: the upstream tool shells out to uroman (Perl). Here
``align.uroman`` transliterates Cyrillic/Greek/Hebrew/Arabic/kana/
Hangul/Han(pinyin)/Devanagari plus — via ``align.uroman_ext`` — the
remaining Indic abugidas (Bengali/Gurmukhi/Gujarati/Oriya/Tamil/
Telugu/Kannada/Malayalam/Sinhala), Thai, Lao, Khmer, Myanmar, and
Ethiopic, host-side; the Latin-diacritic range is NFKD-stripped.
Rare hanzi outside the pinyin table fall back to the CTC dictionary's
``<star>`` wildcard, which keeps alignment defined if not exact
uroman output.
"""

from __future__ import annotations

import re
import unicodedata
from typing import List, Tuple

from . import uroman


def normalize_word(word: str, language: str = "eng") -> str:
    """Lowercase, romanize non-Latin scripts (align.uroman), strip
    diacritics to ASCII where possible, drop punctuation (the aligner
    vocabulary is bare lowercase letters and digits plus apostrophe)."""
    word = word.lower()
    if uroman.needs_romanization(word):
        word = uroman.romanize(word)
    decomposed = unicodedata.normalize("NFKD", word)
    stripped = "".join(c for c in decomposed if not unicodedata.combining(c))
    cleaned = re.sub(r"[^\w\s']", "", stripped, flags=re.UNICODE)
    return cleaned.strip()


def split_words(text: str) -> List[str]:
    return [w for w in text.split() if w]


def preprocess_text(
    text: str, romanize: bool = True, language: str = "eng"
) -> Tuple[List[str], List[str]]:
    """Transcript → (tokens_starred, text_starred).

    ``text_starred`` is the original word sequence interleaved with
    ``<star>`` wildcards; ``tokens_starred`` carries the normalized form
    the acoustic model aligns against (same interleaving). Contract of
    ``ctc_forced_aligner.preprocess_text`` as consumed at reference
    diarize.py:170-184 and helpers.py:319-323.
    """
    words = split_words(text)
    tokens_starred: List[str] = []
    text_starred: List[str] = []
    for word in words:
        tokens_starred.append("<star>")
        text_starred.append("<star>")
        norm = normalize_word(word, language) if romanize else word.lower()
        tokens_starred.append(norm if norm else "<star>")
        text_starred.append(word)
    return tokens_starred, text_starred

"""Acronym-aware application of predicted punctuation labels.

A copy of ``whisper_nemo_tpu/post/punctuate.py``, carried so that the
port imports nothing of the JAX package.

Contract: the inline punctuation-application loop in the reference CLI
(diarize.py:228-244): the punctuation model predicts a label per word;
sentence-ending labels (``.?!``) are appended to words that don't already
end in model punctuation — unless the word is an acronym like ``U.S.A.``,
which keeps its dots but never gains a doubled one.
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

ENDING_PUNCTS = ".?!"
MODEL_PUNCTS = ".,;:!?"

_ACRONYM_RE = re.compile(r"\b(?:[a-zA-Z]\.){2,}")


def is_acronym(word: str) -> bool:
    """True for dotted acronyms (``U.S.A.``), contract diarize.py:232."""
    return bool(_ACRONYM_RE.fullmatch(word))


def apply_punctuation_labels(
    word_speaker_mapping: List[dict],
    labeled_words: Sequence[Tuple],
) -> List[dict]:
    """Mutate ``word_speaker_mapping`` in place, appending predicted
    sentence-ending punctuation; returns the same list for chaining.

    ``labeled_words`` rows are ``(word, label, ...)`` tuples as produced by
    the punctuation model (label read at index 1, matching the reference's
    consumption of ``PunctuationModel.predict`` output).
    """
    for word_dict, labeled in zip(word_speaker_mapping, labeled_words):
        word = word_dict["word"]
        label = labeled[1]
        if (
            word
            and label in ENDING_PUNCTS
            and (word[-1] not in MODEL_PUNCTS or is_acronym(word))
        ):
            word += label
            if word.endswith(".."):
                word = word.rstrip(".")
            word_dict["word"] = word
    return word_speaker_mapping

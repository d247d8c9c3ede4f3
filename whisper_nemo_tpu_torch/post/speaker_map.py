"""Word/sentence ↔ speaker mapping algorithms (host-side, pure Python).

A copy of ``whisper_nemo_tpu/post/speaker_map.py``, carried so that the
port imports nothing of the JAX package, and not nltk either: the
sentence-break predicate is ``post/punkt.py``'s copy of an untrained
Punkt tokenizer's.

Behavioral contracts (output-compatible with the reference):
- word→speaker assignment over RTTM turns: reference helpers.py:306-334
- punctuation-guided speaker realignment:   reference helpers.py:337-432
- sentence grouping (Punkt + speaker turns): reference helpers.py:435-460
- missing-timestamp repair:                 reference helpers.py:528-576

These run on lists of small dicts after the TPU stages have produced word
timestamps and speaker turns; they are CPU string/interval algorithms with
no tensor math, so they intentionally stay host-side.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

from .punkt import text_contains_sentbreak

SENTENCE_END = ".?!"


def get_word_ts_anchor(start: float, end: float, option: str = "start"):
    """Pick the anchor timestamp of a word given its start/end."""
    if option == "end":
        return end
    if option == "mid":
        return (start + end) / 2
    return start


def get_words_speaker_mapping(
    word_timestamps: Iterable[dict],
    speaker_turns: Sequence[Sequence],
    word_anchor_option: str = "start",
) -> List[dict]:
    """Assign each word the speaker of the turn containing its anchor.

    ``word_timestamps``: dicts with ``text``/``start``/``end`` in seconds
    (the aligner's output shape). ``speaker_turns``: ``[start_ms, end_ms,
    speaker_id]`` rows parsed from RTTM. A sweeping cursor walks the turns;
    once past the final turn, the final turn absorbs every remaining word
    (its effective end is pushed to each word's own end), matching the
    reference's clamping behavior (helpers.py:325-330).
    """
    turn_idx = 0
    last_turn = len(speaker_turns) - 1
    turn_end = float(speaker_turns[0][1])
    speaker = speaker_turns[0][2]

    mapping: List[dict] = []
    for wd in word_timestamps:
        w_start = int(wd["start"] * 1000)
        w_end = int(wd["end"] * 1000)
        anchor = get_word_ts_anchor(w_start, w_end, word_anchor_option)
        while anchor > turn_end:
            turn_idx = min(turn_idx + 1, last_turn)
            _, turn_end, speaker = speaker_turns[turn_idx]
            turn_end = float(turn_end)
            if turn_idx == last_turn:
                turn_end = get_word_ts_anchor(w_start, w_end, "end")
        mapping.append(
            {
                "word": wd["text"],
                "start_time": w_start,
                "end_time": w_end,
                "speaker": speaker,
            }
        )
    return mapping


def _ends_sentence(word: str) -> bool:
    return bool(word) and word[-1] in SENTENCE_END


def _sentence_start_index(
    idx: int,
    words: Sequence[str],
    speakers: Sequence,
    max_words: int,
) -> int:
    """Index of the first word of the sentence containing ``idx``.

    Walks left while staying within ``max_words`` of ``idx``, on the same
    speaker, and not crossing a sentence end. Returns -1 when the sentence
    start could not be pinned down under those constraints (contract:
    helpers.py:340-353).
    """
    left = idx
    while (
        left > 0
        and idx - left < max_words
        and speakers[left - 1] == speakers[left]
        and not _ends_sentence(words[left - 1])
    ):
        left -= 1
    if left == 0 or _ends_sentence(words[left - 1]):
        return left
    return -1


def _sentence_end_index(idx: int, words: Sequence[str], max_words: int) -> int:
    """Index of the last word of the sentence containing ``idx``.

    Walks right until a sentence-ending word within the ``max_words``
    budget; -1 if none found (contract: helpers.py:356-372).
    """
    right = idx
    last = len(words) - 1
    while right < last and right - idx < max_words and not _ends_sentence(words[right]):
        right += 1
    if right == last or _ends_sentence(words[right]):
        return right
    return -1


def get_realigned_ws_mapping_with_punctuation(
    word_speaker_mapping: Sequence[dict],
    max_words_in_sentence: int = 50,
) -> List[dict]:
    """Fix speaker flips that occur mid-sentence.

    Wherever the speaker changes between word k and k+1 while word k does
    not end a sentence, expand to the containing sentence's bounds and, if
    one speaker holds at least half of its words, assign the whole sentence
    to that majority speaker (contract: helpers.py:375-432).
    """
    words = [wd["word"] for wd in word_speaker_mapping]
    speakers = [wd["speaker"] for wd in word_speaker_mapping]
    n = len(words)

    k = 0
    while k < n:
        if (
            k < n - 1
            and speakers[k] != speakers[k + 1]
            and not _ends_sentence(words[k])
        ):
            left = _sentence_start_index(
                k, words, speakers, max_words_in_sentence
            )
            right = (
                _sentence_end_index(
                    k, words, max_words_in_sentence - k + left - 1
                )
                if left > -1
                else -1
            )
            if left == -1 or right == -1:
                k += 1
                continue

            span = speakers[left : right + 1]
            majority = max(set(span), key=span.count)
            if span.count(majority) >= len(span) // 2:
                speakers[left : right + 1] = [majority] * len(span)
                k = right
        k += 1

    return [
        {**wd, "speaker": spk}
        for wd, spk in zip(word_speaker_mapping, speakers)
    ]


def get_sentences_speaker_mapping(
    word_speaker_mapping: Iterable[dict],
    speaker_turns: Sequence[Sequence],
) -> List[dict]:
    """Group the word stream into speaker-attributed sentences.

    A new sentence starts on a speaker change or when nltk's Punkt detects
    a sentence break in the accumulated text (contract: helpers.py:435-460,
    including the trailing-space text accumulation and the first sentence
    inheriting the first turn's start/end).
    """
    has_break = text_contains_sentbreak
    start, end, speaker = speaker_turns[0]
    prev_speaker = speaker

    sentences: List[dict] = []
    current = {
        "speaker": f"Speaker {speaker}",
        "start_time": start,
        "end_time": end,
        "text": "",
    }
    for wd in word_speaker_mapping:
        word, speaker = wd["word"], wd["speaker"]
        start, end = wd["start_time"], wd["end_time"]
        if speaker != prev_speaker or has_break(current["text"] + " " + word):
            sentences.append(current)
            current = {
                "speaker": f"Speaker {speaker}",
                "start_time": start,
                "end_time": end,
                "text": "",
            }
        else:
            current["end_time"] = end
        current["text"] += word + " "
        prev_speaker = speaker

    sentences.append(current)
    return sentences


def _next_known_start(
    word_timestamps: List[dict], index: int, final_timestamp: Optional[float]
):
    """Start of the next word that has a timestamp.

    Words with no timestamp at all get merged (text-wise) into the word at
    ``index`` and tombstoned with ``word=None`` (contract:
    helpers.py:528-548).
    """
    if index == len(word_timestamps) - 1:
        return word_timestamps[index]["start"]

    probe = index + 1
    while index < len(word_timestamps) - 1:
        if word_timestamps[probe].get("start") is None:
            word_timestamps[index]["word"] += (
                " " + word_timestamps[probe]["word"]
            )
            word_timestamps[probe]["word"] = None
            probe += 1
            if probe == len(word_timestamps):
                return final_timestamp
        else:
            return word_timestamps[probe]["start"]


def filter_missing_timestamps(
    word_timestamps: List[dict],
    initial_timestamp: Optional[float] = 0,
    final_timestamp: Optional[float] = None,
) -> List[dict]:
    """Fill in start/end for words the aligner dropped.

    A word with no ``start`` inherits the previous word's end as its start
    and the next timestamped word's start as its end; fully untimestamped
    runs merge into their predecessor (contract: helpers.py:551-576).
    """
    if word_timestamps[0].get("start") is None:
        word_timestamps[0]["start"] = (
            initial_timestamp if initial_timestamp is not None else 0
        )
        word_timestamps[0]["end"] = _next_known_start(
            word_timestamps, 0, final_timestamp
        )

    result = [word_timestamps[0]]
    for i, ws in enumerate(word_timestamps[1:], start=1):
        if ws.get("start") is None and ws.get("word") is not None:
            ws["start"] = word_timestamps[i - 1]["end"]
            ws["end"] = _next_known_start(word_timestamps, i, final_timestamp)
        if ws["word"] is not None:
            result.append(ws)
    return result

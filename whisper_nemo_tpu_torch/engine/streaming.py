"""Streaming transcription via the LocalAgreement-2 policy.

Counterpart of ``whisper_nemo_tpu/engine/streaming.py`` (host logic the
port keeps its own copy of): audio arrives in arbitrary chunks, the
growing buffer is re-transcribed, and a word becomes COMMITTED once two
consecutive hypotheses agree on it (same normalized word at the same
position past the committed point). Committed words never change — the
stable prefix a live captioning consumer can render immediately.

Each refresh is one ``transcribe_sequential`` call of the engine (one
window: its mel on kernel C, then the encoder and the decode on the
card); the agreement policy itself is pure host-side string logic. The
audio buffer trims at committed-segment boundaries so that the window the
device sees stays under 30 s however long the stream runs.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

SAMPLE_RATE = 16000
_MAX_BUFFER_S = 28.0  # keep under one 30 s window


@dataclass
class CommittedWord:
    word: str
    start: float  # seconds in the original stream
    end: float


def _norm(w: str) -> str:
    return re.sub(r"[^\w']", "", w.lower())


def _words_with_times(
    segments: Sequence,  # engine Segment objects (start/end/text)
) -> List[Tuple[str, float, float]]:
    """Segment texts → (word, start, end), times linearly interpolated
    inside each segment (word-level timing without running the
    aligner on every refresh)."""
    out: List[Tuple[str, float, float]] = []
    for seg in segments:
        words = seg.text.split()
        if not words:
            continue
        dur = max(seg.end - seg.start, 1e-3)
        step = dur / len(words)
        for i, w in enumerate(words):
            out.append(
                (w, seg.start + i * step, seg.start + (i + 1) * step)
            )
    return out


class StreamingTranscriber:
    """Incremental transcription with a stable committed prefix.

    >>> st = StreamingTranscriber(engine)
    >>> for chunk in audio_chunks:          # arbitrary sizes
    ...     new_words = st.push(chunk)      # newly committed words
    >>> tail = st.flush()                   # commit whatever remains

    ``transcribe_fn`` (tests / custom engines) overrides the refresh:
    it receives the current float32 buffer and returns segment-like
    objects with ``start``/``end``/``text``.
    """

    def __init__(
        self,
        engine=None,
        language: Optional[str] = None,
        beam_size: int = 1,
        min_refresh_s: float = 1.0,
        agreement_n: int = 2,
        transcribe_fn: Optional[Callable] = None,
    ):
        """``min_refresh_s`` sets how much new audio accumulates before
        a re-transcription (the latency/duty-cycle tradeoff: commit
        latency floors at ~agreement_n×refresh − chunk).
        ``agreement_n`` is the LocalAgreement window: a word commits
        once the last ``n`` consecutive hypotheses agree on it (n=2 is
        the published LocalAgreement-2 default; n=1 commits every
        refresh's words immediately — latency-optimal, revision-prone
        on unstable tails)."""
        if engine is None and transcribe_fn is None:
            raise ValueError("need an engine or a transcribe_fn")
        if agreement_n < 1:
            raise ValueError("agreement_n must be >= 1")
        self.engine = engine
        self.language = language
        self.beam_size = beam_size
        self.min_refresh_s = min_refresh_s
        self.agreement_n = agreement_n
        self._transcribe_fn = transcribe_fn

        self._buffer = np.zeros((0,), np.float32)
        self._buffer_offset = 0.0  # stream seconds trimmed off the front
        self._pending = 0  # samples since the last refresh
        # the previous agreement_n - 1 hypotheses (newest last)
        self._hyp_history: List[List[Tuple[str, float, float]]] = []
        self.committed: List[CommittedWord] = []

    # -- internals -----------------------------------------------------------
    def _refresh(self) -> List[Tuple[str, float, float]]:
        if self._transcribe_fn is not None:
            segments = self._transcribe_fn(self._buffer)
        else:
            prompt = " ".join(w.word for w in self.committed[-32:]) or None
            segments, _ = self.engine.transcribe_sequential(
                self._buffer,
                language=self.language,
                temperatures=(0.0,),
                beam_size=self.beam_size,
                condition_on_previous_text=False,
                initial_prompt=prompt,
            )
        return [
            (w, s + self._buffer_offset, e + self._buffer_offset)
            for (w, s, e) in _words_with_times(segments)
        ]

    def _commit_agreed(
        self, hyp: List[Tuple[str, float, float]]
    ) -> List[CommittedWord]:
        """LocalAgreement-n: commit the longest prefix (beyond the
        committed frontier) on which the last ``agreement_n``
        consecutive hypotheses agree (n=2 → previous vs current, the
        published LocalAgreement-2; n=1 → commit immediately)."""
        newly: List[CommittedWord] = []
        if len(self._hyp_history) >= self.agreement_n - 1:
            # strict frontier: a re-transcription can jitter word times
            # slightly, and re-including a committed word would commit
            # it twice — dropping a marginally-shifted word is the
            # safer failure
            frontier = (
                self.committed[-1].end if self.committed else -1e9
            )
            cur = [h for h in hyp if h[1] >= frontier]
            older = [
                [h for h in past if h[1] >= frontier]
                for past in self._hyp_history[
                    len(self._hyp_history) - (self.agreement_n - 1):
                ]
            ]
            for i, (cw, cs, ce) in enumerate(cur):
                if not _norm(cw):
                    break
                if any(
                    i >= len(past) or _norm(past[i][0]) != _norm(cw)
                    for past in older
                ):
                    break
                newly.append(CommittedWord(cw, cs, ce))
        self._hyp_history.append(hyp)
        if len(self._hyp_history) > max(self.agreement_n - 1, 1):
            self._hyp_history.pop(0)
        if newly:
            self.committed.extend(newly)
        return newly

    def _trim_buffer(self) -> None:
        """Drop audio the committed frontier has passed, once the
        buffer threatens the 30 s window."""
        if len(self._buffer) / SAMPLE_RATE <= _MAX_BUFFER_S:
            return
        if not self.committed:
            # nothing stable to anchor on: keep the last window
            drop_s = len(self._buffer) / SAMPLE_RATE - _MAX_BUFFER_S
        else:
            drop_s = min(
                self.committed[-1].end - self._buffer_offset,
                len(self._buffer) / SAMPLE_RATE - 1.0,
            )
            if drop_s <= 0:
                return
        n = int(drop_s * SAMPLE_RATE)
        self._buffer = self._buffer[n:]
        self._buffer_offset += n / SAMPLE_RATE
        # hypotheses before the cut are no longer comparable
        if self._hyp_history:
            self._hyp_history = [
                [h for h in past if h[1] >= self._buffer_offset]
                for past in self._hyp_history
            ]

    # -- public --------------------------------------------------------------
    def push(self, samples: np.ndarray) -> List[CommittedWord]:
        """Feed a chunk; returns words newly committed by this chunk."""
        samples = np.asarray(samples, np.float32)
        self._buffer = np.concatenate([self._buffer, samples])
        self._pending += len(samples)
        # integer sample count: float-second accumulation drifts below
        # the threshold (10 x 0.1 s < 1.0 s in binary)
        if self._pending < int(self.min_refresh_s * SAMPLE_RATE):
            return []
        self._pending = 0
        hyp = self._refresh()
        newly = self._commit_agreed(hyp)
        self._trim_buffer()
        return newly

    def flush(self) -> List[CommittedWord]:
        """End of stream: commit the remaining hypothesis tail (the
        final hypothesis is as good as it gets)."""
        hyp = self._refresh()
        newly = self._commit_agreed(hyp)
        frontier = self.committed[-1].end if self.committed else -1e9
        tail = [
            CommittedWord(w, s, e)
            for (w, s, e) in hyp
            if s >= frontier and _norm(w)
        ]
        self.committed.extend(tail)
        return newly + tail

    @property
    def text(self) -> str:
        return " ".join(w.word for w in self.committed)

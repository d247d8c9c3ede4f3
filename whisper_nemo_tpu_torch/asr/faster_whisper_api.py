"""faster-whisper-compatible facade over the port's engine.

Counterpart of ``whisper_nemo_tpu/asr/faster_whisper_api.py``, the two
calls the CLI makes:

    model = WhisperModel(name, device="cuda", compute_type="int8")
    pipeline = BatchedInferencePipeline(model)
    segments, info = pipeline.transcribe(audio, language="en", batch_size=32)
    segments, info = model.transcribe(audio, language, vad_filter=True)

``beam_size`` defaults to 5, as in faster-whisper and the JAX package; 1
runs greedy decode. ``model.transcribe`` is the sequential path
(timestamps, the temperature ladder, conditioning on the previous text).
``word_timestamps=True`` aligns each segment's words with the port's CTC
aligner. Audio is a 16 kHz waveform or a path, decoded by
``audio.decode_audio``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..audio import decode_audio
from ..engine.transcribe import Segment, TranscriptionInfo, WhisperEngine
from ..text.languages import langs_to_iso


@dataclass
class Word:
    """faster-whisper's per-word record (``word_timestamps=True``).
    ``probability`` is the mean per-frame CTC posterior of the word's
    aligned span, as in the JAX package, not faster-whisper's
    attention-DTW token probability."""

    start: float
    end: float
    word: str
    probability: float


def _attach_word_timestamps(
    segments: List[Segment], audio: np.ndarray, language: str, device
) -> None:
    """Fill ``Segment.words`` with the CTC aligner on ``device`` (bf16 on
    a CUDA device, f32 on the CPU): each spoken segment's text aligns
    against its own audio span, and its words attach to it."""
    from ..align.api import load_alignment_model
    from ..align.segmented import align_segments

    spoken = [s for s in segments if s.text.strip()]
    timed = [{"start": s.start, "end": s.end, "text": s.text} for s in spoken]
    if not timed:
        return
    model, tokenizer = load_alignment_model(
        device, dtype="bfloat16" if device.type == "cuda" else None
    )
    words = align_segments(
        model, tokenizer, audio, timed, language=langs_to_iso.get(language, "eng"),
        device=device,
    )
    for seg in segments:
        seg.words = []
    for w in words:
        # the mean-exp posterior lies in [0, 1]; clamp the rounding at its ends
        prob = min(1.0, max(0.0, float(w["score"])))
        spoken[w["segment"]].words.append(Word(w["start"], w["end"], w["text"], prob))


def _waveform(audio) -> np.ndarray:
    """A waveform as f32, or a path decoded to 16 kHz mono (faster-whisper
    accepts both)."""
    if isinstance(audio, (str, os.PathLike)):
        return decode_audio(os.fspath(audio))
    return np.asarray(audio, np.float32)


class WhisperModel:
    def __init__(
        self,
        model_size_or_path: str = "tiny",
        device: str = "cuda",
        compute_type: str = "default",
        seed: int = 0,
        **engine_kwargs,
    ):
        """``device`` is explicit ("cuda", "cuda:N" or "cpu"); there is no
        "auto". ``compute_type`` defaults to the JAX package's "default"
        (f32; see ``WhisperEngine``). ``seed`` makes the random weights used
        when no checkpoint is found."""
        if device == "auto":
            raise ValueError('device must be explicit: "cuda", "cuda:N" or "cpu"')
        self.engine = WhisperEngine(
            model_size_or_path, compute_type, device=device, seed=seed, **engine_kwargs
        )
        self.model_size = model_size_or_path

    @property
    def hf_tokenizer(self):
        """Tokenizer exposing ``get_vocab()``."""
        return self.engine.tokenizer

    def transcribe(
        self,
        audio: str | os.PathLike | np.ndarray,
        language: Optional[str] = None,
        task: str = "transcribe",
        beam_size: int = 5,
        suppress_tokens: Sequence[int] = (-1,),
        vad_filter: bool = False,
        without_timestamps: bool = False,
        word_timestamps: bool = False,
        temperature: Sequence[float] | float = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
        compression_ratio_threshold: float = 2.4,
        log_prob_threshold: float = -1.0,
        no_speech_threshold: float = 0.6,
        condition_on_previous_text: bool = True,
        initial_prompt: Optional[str] = None,
        **_ignored,
    ) -> Tuple[Iterable[Segment], TranscriptionInfo]:
        """The sequential path (the CLI's ``--batch-size 0`` call)."""
        if isinstance(temperature, (int, float)):
            temperature = (float(temperature),)
        audio = _waveform(audio)
        segments, info = self.engine.transcribe_sequential(
            audio,
            language=language,
            suppress_tokens=tuple(suppress_tokens),
            vad_filter=vad_filter,
            temperatures=tuple(temperature),
            compression_ratio_threshold=compression_ratio_threshold,
            logprob_threshold=log_prob_threshold,
            no_speech_threshold=no_speech_threshold,
            condition_on_previous_text=condition_on_previous_text,
            without_timestamps=without_timestamps,
            beam_size=beam_size,
            task=task,
            initial_prompt=initial_prompt,
        )
        if word_timestamps:
            _attach_word_timestamps(segments, audio, info.language, self.engine.device)
        return iter(segments), info


class BatchedInferencePipeline:
    """Batched VAD-windowed inference."""

    def __init__(self, model: WhisperModel):
        self.model = model

    def transcribe(
        self,
        audio: str | os.PathLike | np.ndarray,
        language: Optional[str] = None,
        task: str = "transcribe",
        beam_size: int = 5,
        suppress_tokens: Sequence[int] = (-1,),
        batch_size: int = 8,
        without_timestamps: bool = True,
        word_timestamps: bool = False,
        **_ignored,
    ) -> Tuple[Iterable[Segment], TranscriptionInfo]:
        audio = _waveform(audio)
        engine = self.model.engine
        segments, info = engine.transcribe_batched(
            audio,
            language=language,
            suppress_tokens=tuple(suppress_tokens),
            batch_size=batch_size,
            without_timestamps=without_timestamps,
            beam_size=beam_size,
            task=task,
        )
        if word_timestamps:
            _attach_word_timestamps(segments, audio, info.language, engine.device)
        return iter(segments), info

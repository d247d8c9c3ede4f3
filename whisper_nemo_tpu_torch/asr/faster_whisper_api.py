"""faster-whisper-compatible facade over the port's engine.

Counterpart of ``whisper_nemo_tpu/asr/faster_whisper_api.py`` for the
batched path the CLI's ``run_asr`` drives:

    model = WhisperModel(name, device="cuda", compute_type="int8")
    pipeline = BatchedInferencePipeline(model)
    segments, info = pipeline.transcribe(audio, language="en", batch_size=32)

``beam_size`` defaults to 5, as in faster-whisper and the JAX package; 1
runs greedy decode.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from ..engine.transcribe import ROADMAP_NOTE, Segment, TranscriptionInfo, WhisperEngine


class WhisperModel:
    def __init__(
        self,
        model_size_or_path: str = "tiny",
        device: str = "cuda",
        compute_type: str = "int8",
        seed: int = 0,
        **engine_kwargs,
    ):
        """``device`` is explicit ("cuda", "cuda:N" or "cpu"); there is no
        "auto". ``seed`` makes the random weights used when no checkpoint
        is found."""
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

    def transcribe(self, *args, **kwargs):
        raise NotImplementedError(f"sequential WhisperModel.transcribe is {ROADMAP_NOTE}")


class BatchedInferencePipeline:
    """Batched VAD-windowed inference."""

    def __init__(self, model: WhisperModel):
        self.model = model

    def transcribe(
        self,
        audio: np.ndarray,
        language: Optional[str] = None,
        task: str = "transcribe",
        beam_size: int = 5,
        suppress_tokens: Sequence[int] = (-1,),
        batch_size: int = 8,
        without_timestamps: bool = True,
        word_timestamps: bool = False,
        **_ignored,
    ) -> Tuple[Iterable[Segment], TranscriptionInfo]:
        if word_timestamps:
            raise NotImplementedError(f"word_timestamps=True is {ROADMAP_NOTE}")
        segments, info = self.model.engine.transcribe_batched(
            np.asarray(audio, np.float32),
            language=language,
            suppress_tokens=tuple(suppress_tokens),
            batch_size=batch_size,
            without_timestamps=without_timestamps,
            beam_size=beam_size,
            task=task,
        )
        return iter(segments), info

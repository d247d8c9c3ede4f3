"""openai-whisper-compatible facade over the port's engine.

Counterpart of ``whisper_nemo_tpu/asr/openai_api.py``: the dict contract
the serverless handler reads,

    model = load_model("medium.en", "cuda", compute_type="int8")
    result = model.transcribe(audio, language=..., temperature=0.0,
                              condition_on_previous_text=False)
    result["text"], result["segments"][i]["start"/"end"/"text"/
    "no_speech_prob"], result["language"], result["duration"]

over the sequential path. Audio is a 16 kHz waveform or a path, decoded
by ``audio.decode_audio``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from ..engine.transcribe import WhisperEngine
from .faster_whisper_api import _attach_word_timestamps, _waveform


class OpenAIWhisperModel:
    def __init__(self, name: str, device: str = "cuda", compute_type: Optional[str] = None,
                 **engine_kwargs):
        """``device`` is explicit ("cuda", "cuda:N" or "cpu"). Without
        ``compute_type`` large models run bf16 and the others
        openai-whisper's f32 ("default"), as in the JAX package; the
        serving handler passes int8."""
        if device == "auto":
            raise ValueError('device must be explicit: "cuda", "cuda:N" or "cpu"')
        compute = compute_type or ("bfloat16" if name.startswith("large") else "default")
        self.engine = WhisperEngine(name, compute, device=device, **engine_kwargs)
        self.name = name

    def transcribe(
        self,
        audio: np.ndarray,
        language: Optional[str] = None,
        task: str = "transcribe",
        beam_size: Optional[int] = None,
        fp16: bool = True,
        condition_on_previous_text: bool = True,
        no_speech_threshold: float = 0.6,
        logprob_threshold: float = -1.0,
        compression_ratio_threshold: float = 2.4,
        temperature: Union[float, Sequence[float]] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
        suppress_tokens: Union[str, Sequence[int], None] = "-1",
        word_timestamps: bool = False,
        verbose: Optional[bool] = None,
        **_ignored,
    ) -> dict:
        audio = _waveform(audio)
        if isinstance(temperature, (int, float)):
            temperature = (float(temperature),)
        if isinstance(suppress_tokens, str):
            # openai-whisper's default is the string "-1" (the non-speech list)
            suppress_tokens = (
                tuple(int(t) for t in suppress_tokens.split(",")) if suppress_tokens else ()
            )
        segments, info = self.engine.transcribe_sequential(
            audio,
            language=language,
            suppress_tokens=tuple(suppress_tokens or ()),
            temperatures=tuple(temperature),
            compression_ratio_threshold=compression_ratio_threshold,
            logprob_threshold=logprob_threshold,
            no_speech_threshold=no_speech_threshold,
            condition_on_previous_text=condition_on_previous_text,
            beam_size=beam_size or 1,
            task=task,
        )
        if word_timestamps:
            _attach_word_timestamps(segments, audio, info.language, self.engine.device)
        seg_dicts = [
            {
                "id": s.id,
                "seek": s.seek,
                "start": s.start,
                "end": s.end,
                "text": s.text,
                "tokens": s.tokens,
                "temperature": s.temperature,
                "avg_logprob": s.avg_logprob,
                "compression_ratio": s.compression_ratio,
                "no_speech_prob": s.no_speech_prob,
                **(
                    {
                        "words": [
                            {"word": w.word, "start": w.start, "end": w.end,
                             "probability": w.probability}
                            for w in (s.words or [])
                        ]
                    }
                    if word_timestamps
                    else {}
                ),
            }
            for s in segments
        ]
        return {
            "text": "".join(s.text for s in segments),
            "segments": seg_dicts,
            "language": info.language,
            "duration": info.duration,
        }


def load_model(
    name: str, device: str = "cuda", compute_type: Optional[str] = None, **engine_kwargs
) -> OpenAIWhisperModel:
    """``whisper.load_model``'s contract; ``compute_type`` pins the engine
    width (the serving handler passes int8)."""
    return OpenAIWhisperModel(name, device, compute_type=compute_type, **engine_kwargs)

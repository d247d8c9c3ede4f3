"""ASR facades: faster-whisper's (batched and sequential) and
openai-whisper's, and the audio decoder the CLI flow reads through
``asr.decode_audio``."""

from ..audio.decode import decode_audio
from ..engine.transcribe import Segment, TranscriptionInfo
from .faster_whisper_api import BatchedInferencePipeline, WhisperModel, Word
from .openai_api import load_model

__all__ = [
    "BatchedInferencePipeline",
    "Segment",
    "TranscriptionInfo",
    "WhisperModel",
    "Word",
    "decode_audio",
    "load_model",
]

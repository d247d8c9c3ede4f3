"""faster-whisper-compatible ASR facade."""

from .faster_whisper_api import BatchedInferencePipeline, WhisperModel

__all__ = ["BatchedInferencePipeline", "WhisperModel"]

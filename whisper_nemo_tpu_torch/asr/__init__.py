"""ASR facades: faster-whisper's (batched and sequential) and
openai-whisper's."""

from .faster_whisper_api import BatchedInferencePipeline, WhisperModel, Word
from .openai_api import load_model

__all__ = ["BatchedInferencePipeline", "WhisperModel", "Word", "load_model"]

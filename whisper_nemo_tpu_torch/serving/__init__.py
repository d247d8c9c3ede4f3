"""The serverless handler, its schemas and the cross-request window
scheduler (counterpart of ``whisper_nemo_tpu/serving/``)."""

from .schemas import TranscriptionRequest, TranscriptionResponse
from .handler import handler, load_models, serve

__all__ = [
    "TranscriptionRequest",
    "TranscriptionResponse",
    "handler",
    "load_models",
    "serve",
]

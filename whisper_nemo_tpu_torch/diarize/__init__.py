"""NeMo-style speaker diarization: VAD, multiscale TitaNet embeddings,
NME-SC clustering, MSDD, RTTM."""

from .pipeline import (
    DiarizationAnnotation,
    NeuralDiarizer,
    SpeakerDiarizationPipeline,
)
from .rttm import parse_rttm, read_speaker_timestamps, write_rttm

__all__ = [
    "DiarizationAnnotation",
    "NeuralDiarizer",
    "SpeakerDiarizationPipeline",
    "parse_rttm",
    "read_speaker_timestamps",
    "write_rttm",
]

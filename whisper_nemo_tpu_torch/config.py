"""Typed configuration tree for the diarization stack.

A copy of ``whisper_nemo_tpu/config.py``, carried so that the
port imports nothing of the JAX package.

Replaces the reference's OmegaConf YAML presets
(``nemo_msdd_configs/diar_infer_{telephonic,meeting,general}.yaml``) and its
``create_config`` factory (reference helpers.py:252-303) with a single typed
dataclass tree. The three domain presets carry the same numeric values as the
reference YAMLs; ``create_config`` applies the same programmatic overrides the
reference applies (VAD onset/offset/pad_offset, titanet_large, oracle flags,
MSDD telephonic model) and writes the same one-line input manifest. Unlike
the reference, which hardcodes ``DOMAIN_TYPE = "telephonic"``
(helpers.py:253), the domain is a real parameter here.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence


@dataclass
class VadParams:
    window_length_in_sec: float = 0.15
    shift_length_in_sec: float = 0.01
    smoothing: str | bool = "median"  # False or "median"
    overlap: float = 0.5
    onset: float = 0.1
    offset: float = 0.1
    pad_onset: float = 0.1
    pad_offset: float = 0.0
    min_duration_on: float = 0.0
    min_duration_off: float = 0.2
    filter_speech_first: bool = True


@dataclass
class VadConfig:
    model_path: str = "vad_multilingual_marblenet"
    external_vad_manifest: Optional[str] = None
    parameters: VadParams = field(default_factory=VadParams)


@dataclass
class SpeakerEmbeddingParams:
    window_length_in_sec: Sequence[float] = (1.5, 1.25, 1.0, 0.75, 0.5)
    shift_length_in_sec: Sequence[float] = (0.75, 0.625, 0.5, 0.375, 0.25)
    multiscale_weights: Sequence[float] = (1, 1, 1, 1, 1)
    save_embeddings: bool = True


@dataclass
class SpeakerEmbeddingConfig:
    model_path: str = "titanet_large"
    parameters: SpeakerEmbeddingParams = field(
        default_factory=SpeakerEmbeddingParams
    )


@dataclass
class ClusteringParams:
    oracle_num_speakers: bool = False
    max_num_speakers: int = 8
    enhanced_count_thres: int = 80
    max_rp_threshold: float = 0.25
    sparse_search_volume: int = 30
    maj_vote_spk_count: bool = False
    chunk_cluster_count: int = 50
    embeddings_per_chunk: int = 10000


@dataclass
class ClusteringConfig:
    parameters: ClusteringParams = field(default_factory=ClusteringParams)


@dataclass
class MsddParams:
    use_speaker_model_from_ckpt: bool = True
    infer_batch_size: int = 25
    sigmoid_threshold: Sequence[float] = (0.7,)
    seq_eval_mode: bool = False
    split_infer: bool = True
    diar_window_length: int = 50
    overlap_infer_spk_limit: int = 5


@dataclass
class MsddConfig:
    model_path: Optional[str] = "diar_msdd_telephonic"
    parameters: MsddParams = field(default_factory=MsddParams)


@dataclass
class DiarizerConfig:
    manifest_filepath: Optional[str] = None
    out_dir: Optional[str] = None
    oracle_vad: bool = False
    collar: float = 0.25
    ignore_overlap: bool = True
    vad: VadConfig = field(default_factory=VadConfig)
    speaker_embeddings: SpeakerEmbeddingConfig = field(
        default_factory=SpeakerEmbeddingConfig
    )
    clustering: ClusteringConfig = field(default_factory=ClusteringConfig)
    msdd_model: MsddConfig = field(default_factory=MsddConfig)


@dataclass
class DiarizationConfig:
    """Top-level inference config (mirrors the YAML root)."""

    name: str = "ClusterDiarizer"
    num_workers: int = 1
    sample_rate: int = 16000
    batch_size: int = 64
    device: Optional[str] = None
    verbose: bool = True
    diarizer: DiarizerConfig = field(default_factory=DiarizerConfig)


def _telephonic() -> DiarizationConfig:
    # Values: reference nemo_msdd_configs/diar_infer_telephonic.yaml.
    return DiarizationConfig()


def _meeting() -> DiarizationConfig:
    # Values: reference nemo_msdd_configs/diar_infer_meeting.yaml.
    cfg = DiarizationConfig()
    cfg.diarizer.vad.parameters = VadParams(
        window_length_in_sec=0.63,
        shift_length_in_sec=0.01,
        smoothing=False,
        overlap=0.5,
        onset=0.9,
        offset=0.5,
        pad_onset=0.0,
        pad_offset=0.0,
        min_duration_on=0.0,
        min_duration_off=0.6,
    )
    cfg.diarizer.speaker_embeddings.parameters = SpeakerEmbeddingParams(
        window_length_in_sec=(3.0, 2.5, 2.0, 1.5, 1.0, 0.5),
        shift_length_in_sec=(1.5, 1.25, 1.0, 0.75, 0.5, 0.25),
        multiscale_weights=(1, 1, 1, 1, 1, 1),
    )
    cfg.diarizer.msdd_model.model_path = None
    return cfg


def _general() -> DiarizationConfig:
    # Values: reference nemo_msdd_configs/diar_infer_general.yaml
    # (DIHARD3-tuned).
    cfg = DiarizationConfig()
    cfg.diarizer.vad.parameters = VadParams(
        window_length_in_sec=0.63,
        shift_length_in_sec=0.08,
        smoothing=False,
        overlap=0.5,
        onset=0.5,
        offset=0.3,
        pad_onset=0.2,
        pad_offset=0.2,
        min_duration_on=0.5,
        min_duration_off=0.5,
    )
    cfg.diarizer.speaker_embeddings.parameters = SpeakerEmbeddingParams(
        window_length_in_sec=(1.9, 1.2, 0.5),
        shift_length_in_sec=(0.95, 0.6, 0.25),
        multiscale_weights=(1, 1, 1),
    )
    cfg.diarizer.clustering.parameters.sparse_search_volume = 10
    cfg.diarizer.msdd_model.model_path = None
    return cfg


DOMAIN_PRESETS = {
    "telephonic": _telephonic,
    "meeting": _meeting,
    "general": _general,
}


def domain_config(domain: str = "telephonic") -> DiarizationConfig:
    """Return a fresh config for one of the three domain presets."""
    try:
        return DOMAIN_PRESETS[domain]()
    except KeyError:
        raise ValueError(
            f"Unknown domain {domain!r}; expected one of"
            f" {sorted(DOMAIN_PRESETS)}"
        ) from None


def write_manifest(
    manifest_path: str,
    audio_filepath: str,
    *,
    offset: float = 0,
    duration: Optional[float] = None,
    num_speakers: Optional[int] = None,
) -> None:
    """Write the one-line diarizer input manifest.

    Same JSON line the reference writes (helpers.py:267-278).
    """
    entry = {
        "audio_filepath": audio_filepath,
        "offset": offset,
        "duration": duration,
        "label": "infer",
        "text": "-",
        "rttm_filepath": None,
        "uem_filepath": None,
    }
    if num_speakers is not None:
        entry["num_speakers"] = num_speakers
    with open(manifest_path, "w") as fp:
        json.dump(entry, fp)
        fp.write("\n")


def create_config(
    output_dir: str, domain: str = "telephonic"
) -> DiarizationConfig:
    """Build the inference config for a run rooted at ``output_dir``.

    Behavioral contract of the reference factory (helpers.py:252-303):
    - manifest written to ``<output_dir>/data/input_manifest.json`` pointing
      at ``<output_dir>/mono_file.wav``
    - num_workers forced to 0
    - titanet_large embeddings, oracle VAD/speaker-count disabled
    - MarbleNet VAD with onset=0.8, offset=0.6, pad_offset=-0.05
    - telephonic MSDD model

    ``domain`` selects the preset (the reference hardcodes telephonic).
    """
    cfg = domain_config(domain)
    data_dir = os.path.join(output_dir, "data")
    os.makedirs(data_dir, exist_ok=True)
    manifest = os.path.join(data_dir, "input_manifest.json")
    write_manifest(manifest, os.path.join(output_dir, "mono_file.wav"))

    cfg.num_workers = 0
    d = cfg.diarizer
    d.manifest_filepath = manifest
    d.out_dir = output_dir
    d.speaker_embeddings.model_path = "titanet_large"
    d.oracle_vad = False
    d.clustering.parameters.oracle_num_speakers = False
    d.vad.model_path = "vad_multilingual_marblenet"
    d.vad.parameters.onset = 0.8
    d.vad.parameters.offset = 0.6
    d.vad.parameters.pad_offset = -0.05
    d.msdd_model.model_path = "diar_msdd_telephonic"
    return cfg


def asdict(cfg: DiarizationConfig) -> dict:
    """Config tree as a plain nested dict (for logging / serialization)."""
    return dataclasses.asdict(cfg)

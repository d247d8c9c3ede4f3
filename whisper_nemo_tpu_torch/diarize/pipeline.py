"""Neural diarization: VAD, multiscale embeddings, clustering, MSDD, RTTM.

Counterpart of ``whisper_nemo_tpu/diarize/pipeline.py``. ``NeuralDiarizer``
takes the config tree of ``config.create_config`` (a manifest in,
``pred_rttms/<uri>.rttm`` out); ``SpeakerDiarizationPipeline`` is the
pyannote-style facade over it at the ``"general"`` preset. Stages:
  (a) frame VAD: MarbleNet (or a converted ``.nemo`` Jasper stack) when a
      checkpoint is installed, else PyanNet (pyannote segmentation) when
      ``pyannote_segmentation.npz`` is, else the energy VAD; then the
      config's hysteresis, padding and minimum durations;
  (b) TitaNet (or ECAPA-TDNN, where the config names ``ecapa_tdnn``)
      embeddings of every scale's windows, gathered from one feature
      array of the whole recording;
  (c) NME-SC clustering of the scale-weighted affinity (long-form
      over-clustering past ``embeddings_per_chunk`` segments);
  (d) MSDD refinement when an MSDD checkpoint is installed (or with
      ``force_large_models``).
The waveform goes to the device once per call. The models run in f32 with
TF32 off, as the JAX package computes; the caller's settings come back
after each call.

Checkpoints are the JAX package's ``.npz`` files under ``$WNT_MODEL_DIR``.
Without one, ``force_large_models`` makes the production-size models from
seeded generators (the energy VAD still cuts the segments, and the
MarbleNet forward runs for its cost); otherwise a compact embedder is
made.
"""

from __future__ import annotations

import json
import logging
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..audio import decode_audio
from ..config import DiarizationConfig
from ..engine.checkpoint import load_params, model_cache_dir, to_device
from ..engine.precision import full_f32
from ..models import conv_asr, ecapa, marblenet, msdd as msdd_mod, pyannet, titanet
from ..ops.features import HOP_LENGTH, SAMPLE_RATE, log_mel_features
from ..vad.binarize import binarize_probs, filter_segments, median_smooth
from ..vad.energy import frame_energy_probs
from .clustering import _Stage, longform_cluster, multiscale_affinity
from .rttm import write_rttm
from .segments import ScaleSegment, map_scales_to_base, merge_frame_labels_to_turns, multiscale_segmentation

logger = logging.getLogger(__name__)

# compact architectures used when no checkpoint is installed
_TITANET_SMALL = titanet.TitaNetDims(
    n_mels=80, filters=(128, 128, 128, 384), kernels=(3, 7, 11, 1), repeat=2,
    se_reduction=8, emb_dim=192,
)
_TITANET_LARGE = titanet.TitaNetDims()
_ECAPA_SMALL = ecapa.EcapaDims(channels=64, agg_channels=96, res2net_scale=4, se_reduction=4,
                               attn_hidden=32)


def _load_cfg_sidecar(ckpt_path: str) -> Optional[dict]:
    """The ``<name>.cfg.json`` the .nemo converter writes beside a
    checkpoint; its presence selects the exact Jasper stack."""
    path = ckpt_path[: -len(".npz")] + ".cfg.json"
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


class NeuralDiarizer:
    """Manifest-driven diarizer (NeMo ``NeuralDiarizer`` contract) on
    ``device``; ``seed`` seeds the models made without a checkpoint."""

    def __init__(self, cfg: DiarizationConfig, force_large_models: bool = False,
                 device="cuda", seed: int = 0):
        self.cfg = cfg
        self._force_large = force_large_models
        self.device = torch.device(device)
        self.seed = seed
        # per-threshold turns of the last diarize_waveform call when MSDD ran
        self.last_threshold_turns = None
        self._load_models()

    def _generator(self, offset: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + offset)
        return gen

    # -- model resolution --------------------------------------------------
    def _load_models(self) -> None:
        cache = model_cache_dir()
        d = self.cfg.diarizer

        vad_ckpt = os.path.join(cache, f"{d.vad.model_path}.npz")
        self.marblenet_dims = marblenet.MarbleNetDims()
        self._vad_cfgs = None  # set when a converted-.nemo sidecar exists
        self.vad_params = None
        if os.path.exists(vad_ckpt):
            self.vad_params = load_params(vad_ckpt, self.device)
            meta = _load_cfg_sidecar(vad_ckpt)
            if meta is not None:
                self._vad_cfgs = [conv_asr.JasperBlockCfg(**b) for b in meta["blocks"]]
                self.marblenet_dims = marblenet.MarbleNetDims(n_mels=meta["n_mels"])

        # a converted pyannote segmentation model is the VAD where no
        # MarbleNet checkpoint is installed
        self.pyannet_params = None
        pyannet_ckpt = os.path.join(cache, "pyannote_segmentation.npz")
        if self.vad_params is None and os.path.exists(pyannet_ckpt):
            self.pyannet_params = load_params(pyannet_ckpt, self.device)

        # without a VAD checkpoint the energy VAD cuts the segments (random
        # logits would never cross the onset); force_large still runs a
        # production-size MarbleNet forward for its cost
        self._bench_vad_params = None
        if self.vad_params is None and self.pyannet_params is None and self._force_large:
            self._bench_vad_params = marblenet.init_marblenet_params(
                self.marblenet_dims, self.device, self._generator(4))

        spk_name = d.speaker_embeddings.model_path or "titanet_large"
        if spk_name == "ecapa_tdnn":
            self._embed_fn, init_fn = ecapa.embed, ecapa.init_ecapa_params
            full_dims, small_dims = ecapa.EcapaDims(), _ECAPA_SMALL
        else:  # titanet_* (and speakerverification_speakernet, as in JAX)
            self._embed_fn, init_fn = titanet.embed, titanet.init_titanet_params
            full_dims, small_dims = _TITANET_LARGE, _TITANET_SMALL
        spk_ckpt = os.path.join(cache, f"{spk_name}.npz")
        self._spk_cfgs = None
        if os.path.exists(spk_ckpt):
            self.spk_params = load_params(spk_ckpt, self.device)
            self.spk_dims = full_dims
            meta = _load_cfg_sidecar(spk_ckpt)
            if meta is not None:
                self._spk_cfgs = [conv_asr.JasperBlockCfg(**b) for b in meta["blocks"]]
                self.spk_dims = titanet.TitaNetDims(n_mels=meta["n_mels"], emb_dim=meta["emb_dim"])
        else:
            if self._force_large:
                self.spk_dims = full_dims
            else:
                logger.warning(
                    "no speaker-embedding checkpoint at %s; using a compact seeded random"
                    " %s (diarization quality will be meaningless until converted weights"
                    " are installed)", spk_ckpt, spk_name)
                self.spk_dims = small_dims
            self.spk_params = init_fn(self.spk_dims, self.device, self._generator(2))

        self.msdd_params = None
        if d.msdd_model.model_path:
            msdd_ckpt = os.path.join(cache, f"{d.msdd_model.model_path}.npz")
            self.msdd_dims = msdd_mod.MsddDims(
                n_scales=len(d.speaker_embeddings.parameters.window_length_in_sec))
            if os.path.exists(msdd_ckpt):
                self.msdd_params = load_params(msdd_ckpt, self.device)
            elif self._force_large:
                self.msdd_params = msdd_mod.init_msdd_params(
                    self.msdd_dims, self.device, self._generator(3))
            else:
                logger.warning("no MSDD checkpoint at %s; falling back to clustering-only"
                               " diarization", msdd_ckpt)

    def to(self, device) -> "NeuralDiarizer":
        """Moves every param tree to ``device``; later calls run there."""
        if device is None:
            return self
        self.device = torch.device(device)
        for attr in ("vad_params", "pyannet_params", "spk_params", "msdd_params",
                     "_bench_vad_params"):
            tree = getattr(self, attr)
            if tree is not None:
                setattr(self, attr, to_device(tree, self.device))
        return self

    # -- stages ------------------------------------------------------------
    def _embed(self, windows: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        if self._spk_cfgs is not None:
            return conv_asr.speaker_embed(self.spk_params, self._spk_cfgs, windows, lengths)
        return self._embed_fn(self.spk_params, windows, lengths, self.spk_dims)

    def _frame_speech_probs(self, audio: np.ndarray, wave: torch.Tensor,
                            stats: Optional[dict] = None) -> np.ndarray:
        p = self.cfg.diarizer.vad.parameters
        params = self.vad_params if self.vad_params is not None else self._bench_vad_params
        probs = None
        if params is not None:
            with _Stage(stats, "vad_marblenet", self.device):
                feats = log_mel_features(wave, n_mels=self.marblenet_dims.n_mels).T[None]
                if self._vad_cfgs is not None:
                    out = conv_asr.speech_probs(params, self._vad_cfgs, feats)[0]
                else:
                    out = marblenet.speech_probs(params, feats, self.marblenet_dims)[0]
                if self.vad_params is not None:
                    probs = out.cpu().numpy()
                # else: a force_large forward whose random output is discarded
        elif self.pyannet_params is not None:
            with _Stage(stats, "vad_pyannet", self.device):
                native = pyannet.speech_probs(self.pyannet_params, wave[None])[0].cpu().numpy()
            # PyanNet's frames (a 16.875 ms hop) onto the VAD's grid
            t_native = (np.arange(len(native)) + 0.5) / pyannet.frames_per_second()
            n_grid = max(1, int(len(audio) / SAMPLE_RATE / max(p.shift_length_in_sec, 1e-6)))
            probs = np.interp((np.arange(n_grid) + 0.5) * p.shift_length_in_sec, t_native, native)
        with _Stage(stats, "vad_energy", self.device):
            if probs is None:
                probs = frame_energy_probs(audio, frame_shift=p.shift_length_in_sec,
                                           frame_length=p.window_length_in_sec,
                                           device=self.device, wave=wave)
            if p.smoothing == "median":
                window = max(1, int(p.window_length_in_sec / max(p.shift_length_in_sec, 1e-6)
                                    * p.overlap))
                probs = median_smooth(probs, window)
        return probs

    def _speech_regions(self, audio: np.ndarray, wave: torch.Tensor,
                        stats: Optional[dict] = None) -> List[Tuple[float, float]]:
        p = self.cfg.diarizer.vad.parameters
        shift = p.shift_length_in_sec if self.vad_params is None else HOP_LENGTH / SAMPLE_RATE
        probs = self._frame_speech_probs(audio, wave, stats)
        with _Stage(stats, "segments"):
            segs = binarize_probs(probs, shift, onset=p.onset, offset=p.offset,
                                  pad_onset=p.pad_onset, pad_offset=p.pad_offset)
            segs = filter_segments(segs, p.min_duration_on, p.min_duration_off)
        duration = len(audio) / SAMPLE_RATE
        return [(max(0.0, s), min(e, duration)) for s, e in segs if e > s]

    def _embed_segments(self, features: torch.Tensor, segments: List[ScaleSegment],
                        window: float) -> torch.Tensor:
        """Embeddings ``[n, emb_dim]`` of one scale's segments, on the device.
        Each window is a slice of the shared ``[T, n_mels]`` features (one
        gather from a strided view), normalized per feature over its valid
        frames, and embedded in batches of at least 256."""
        batch_size = max(self.cfg.batch_size, 256)
        max_frames = int(window * SAMPLE_RATE) // HOP_LENGTH + 1
        t_total = features.shape[0]
        starts = np.array([int(seg.start * SAMPLE_RATE) // HOP_LENGTH for seg in segments])
        ends = np.minimum([int(seg.end * SAMPLE_RATE) // HOP_LENGTH for seg in segments], t_total)
        lengths = np.maximum(ends - starts, 1)
        # frames past the recording are zeros and never valid
        padded = torch.cat([features, features.new_zeros((max_frames, features.shape[1]))])
        view = padded.unfold(0, max_frames, 1)  # [t_total + 1, n_mels, max_frames]
        starts_d = torch.from_numpy(starts).to(self.device)
        lengths_d = torch.from_numpy(lengths).to(self.device)
        outs = []
        for b in range(0, len(segments), batch_size):
            lens = lengths_d[b: b + batch_size]
            windows = view[starts_d[b: b + batch_size]]  # [B, n_mels, max_frames]
            mask = titanet.frame_mask(lens, max_frames)
            denom = mask.sum(dim=-1, keepdim=True).clamp(min=1.0)
            mu = (windows * mask).sum(dim=-1, keepdim=True) / denom
            var = ((windows - mu) * mask).square().sum(dim=-1, keepdim=True) / denom
            outs.append(self._embed((windows - mu) / (var.sqrt() + 1e-5) * mask, lens))
        return torch.cat(outs)

    def _mapped_embeddings(self, wave: torch.Tensor, scales: List[List[ScaleSegment]],
                           stats: Optional[dict] = None) -> List[torch.Tensor]:
        """Per scale, the embeddings ``[n_base, D]`` of the segment each
        base segment maps to, on the device."""
        emb_cfg = self.cfg.diarizer.speaker_embeddings.parameters
        with _Stage(stats, "features", self.device):
            features = log_mel_features(wave, n_mels=self.spk_dims.n_mels, normalize=False)
        scale_embs = []
        for segs, w in zip(scales, emb_cfg.window_length_in_sec):
            with _Stage(stats, f"embed_{w:g}", self.device):
                scale_embs.append(self._embed_segments(features, segs, w))
        with _Stage(stats, "affinity", self.device):
            return [emb[torch.from_numpy(m).to(self.device)]
                    for emb, m in zip(scale_embs, map_scales_to_base(scales))]

    def _cluster_labels(self, mapped_embs: List[torch.Tensor], num_speakers: Optional[int] = None,
                        min_speakers: int = 1, max_speakers: Optional[int] = None,
                        stats: Optional[dict] = None) -> np.ndarray:
        """NME-SC labels of the base segments from their multiscale
        embeddings, on the device; the scale-weighted affinity is built
        only where the whole recording is clustered at once."""
        d = self.cfg.diarizer
        cl = d.clustering.parameters
        n_base = mapped_embs[0].shape[0]
        affinity = None
        if len(mapped_embs) > 1 and n_base <= cl.embeddings_per_chunk:
            with _Stage(stats, "affinity", self.device):
                weights = np.asarray(d.speaker_embeddings.parameters.multiscale_weights, np.float64)
                affinity = multiscale_affinity(torch.stack(mapped_embs), weights / weights.sum())
        oracle = num_speakers if num_speakers else (
            None if not cl.oracle_num_speakers else num_speakers)
        return longform_cluster(
            torch.cat(mapped_embs, dim=1),
            num_speakers=oracle,
            max_num_speakers=min(cl.max_num_speakers, max_speakers or cl.max_num_speakers),
            chunk_cluster_count=cl.chunk_cluster_count,
            embeddings_per_chunk=cl.embeddings_per_chunk,
            max_rp_threshold=cl.max_rp_threshold,
            sparse_search_volume=cl.sparse_search_volume,
            affinity=affinity,
            min_num_speakers=min_speakers,
            enhanced_count_thres=cl.enhanced_count_thres,
            maj_vote_spk_count=cl.maj_vote_spk_count,
            stats=stats,
        )

    def diarize_waveform(
        self,
        audio: np.ndarray,
        num_speakers: Optional[int] = None,
        min_speakers: int = 1,
        max_speakers: Optional[int] = None,
        stats: Optional[dict] = None,
    ) -> List[Tuple[float, float, int]]:
        """16 kHz waveform -> speaker turns ``[(start_s, end_s, speaker)]``.

        ``stats``, where a caller passes a dict, receives the seconds of
        each stage under ``stats["seconds"]``, each timed after the device
        finished it (``upload``, ``vad_marblenet``, ``vad_pyannet``,
        ``vad_energy``, ``segments``, ``features``, ``embed_<window>`` per scale,
        ``affinity``, ``nme_search``, ``eigen``, ``kmeans``, ``msdd``,
        ``turns``), and the counts ``n_base``, ``windows`` (per scale),
        ``path`` (``dense``, ``nystrom`` or ``longform``), ``eigengap``,
        ``speakers``, ``msdd_pairs`` and ``msdd_windows``."""
        with full_f32(), torch.inference_mode():
            return self._diarize(audio, num_speakers, min_speakers, max_speakers, stats)

    def _diarize(self, audio, num_speakers, min_speakers, max_speakers, stats):
        d = self.cfg.diarizer
        with _Stage(stats, "upload", self.device):
            wave = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(self.device)
        regions = self._speech_regions(audio, wave, stats)
        if not regions:
            return []

        emb_cfg = d.speaker_embeddings.parameters
        with _Stage(stats, "segments"):
            scales = multiscale_segmentation(regions, emb_cfg.window_length_in_sec,
                                             emb_cfg.shift_length_in_sec)
        base_segments = scales[-1]
        if not base_segments:
            return []
        n_base = len(base_segments)
        if stats is not None:
            stats.update(n_base=n_base, windows=[len(s) for s in scales])

        mapped_embs = self._mapped_embeddings(wave, scales, stats)
        labels = self._cluster_labels(mapped_embs, num_speakers, min_speakers, max_speakers, stats)
        times = [(s.start, s.end) for s in base_segments]
        if stats is not None:
            stats["speakers"] = len(np.unique(labels))

        if self.msdd_params is None:
            self.last_threshold_turns = None
            with _Stage(stats, "turns"):
                return merge_frame_labels_to_turns(times, labels, gap_tolerance=0.5)

        m = d.msdd_model.parameters
        thresholds = [float(t) for t in m.sigmoid_threshold]
        with _Stage(stats, "msdd", self.device):
            activity_by_thr = msdd_mod.msdd_infer_multi(
                self.msdd_params,
                torch.stack(mapped_embs),  # [S, n_base, D]
                labels,
                emb_cfg.multiscale_weights,
                sigmoid_thresholds=thresholds,
                diar_window=m.diar_window_length,
                seg_duration=emb_cfg.window_length_in_sec[-1],
                infer_batch_size=m.infer_batch_size,
                overlap_infer_spk_limit=m.overlap_infer_spk_limit,
                split_infer=bool(m.split_infer),
                stats=stats,
            )
        def activity_to_turns(activity):
            out: List[Tuple[float, float, int]] = []
            for k in range(activity.shape[1]):
                spk_times = [times[i] for i in range(len(times)) if activity[i, k]]
                out.extend(merge_frame_labels_to_turns(spk_times, [k] * len(spk_times),
                                                       gap_tolerance=0.5))
            return sorted(out, key=lambda t: t[0])

        with _Stage(stats, "turns"):
            self.last_threshold_turns = {thr: activity_to_turns(act)
                                         for thr, act in activity_by_thr.items()}
        return self.last_threshold_turns[thresholds[0]]

    # -- manifest/RTTM contract -------------------------------------------
    def diarize(self) -> List[Tuple[float, float, int]]:
        """Run from the manifest; write ``pred_rttms/<uri>.rttm`` (and one
        ``<uri>_t<threshold>.rttm`` per further MSDD threshold)."""
        d = self.cfg.diarizer
        with open(d.manifest_filepath) as f:
            entry = json.loads(f.readline())
        audio_path = entry["audio_filepath"]
        audio = decode_audio(audio_path)
        offset = entry.get("offset") or 0
        if offset:
            audio = audio[int(offset * SAMPLE_RATE):]
        if entry.get("duration"):
            audio = audio[: int(entry["duration"] * SAMPLE_RATE)]

        num_speakers = entry.get("num_speakers")
        if not d.clustering.parameters.oracle_num_speakers:
            num_speakers = None
        turns = self.diarize_waveform(audio, num_speakers=num_speakers)

        uri = os.path.splitext(os.path.basename(audio_path))[0]
        out_dir = os.path.join(d.out_dir, "pred_rttms")
        os.makedirs(out_dir, exist_ok=True)
        write_rttm(os.path.join(out_dir, f"{uri}.rttm"), turns, uri)
        extra = self.last_threshold_turns
        if extra and len(extra) > 1:
            for thr, thr_turns in extra.items():
                write_rttm(os.path.join(out_dir, f"{uri}_t{thr:g}.rttm"), thr_turns, uri)
        return turns


class SpeakerDiarizationPipeline:
    """pyannote-style facade at the ``"general"`` preset:

        pipeline = SpeakerDiarizationPipeline.from_pretrained(..., device="cuda")
        diarization = pipeline(path, num_speakers=..., min_speakers=...,
                               max_speakers=...)
        for turn, _, speaker in diarization.itertracks(yield_label=True):
            turn.start, turn.end, speaker
    """

    def __init__(self, cfg: Optional[DiarizationConfig] = None, device="cuda", seed: int = 0):
        from ..config import domain_config

        self.diarizer = NeuralDiarizer(cfg or domain_config("general"), device=device, seed=seed)

    @classmethod
    def from_pretrained(cls, name: str = "speaker-diarization", device="cuda", **_ignored):
        return cls(device=device)

    def to(self, device) -> "SpeakerDiarizationPipeline":
        self.diarizer.to(device)
        return self

    def __call__(self, audio_path: str, num_speakers: Optional[int] = None,
                 min_speakers: int = 1, max_speakers: int = 8) -> "DiarizationAnnotation":
        turns = self.diarizer.diarize_waveform(
            decode_audio(audio_path), num_speakers=num_speakers,
            min_speakers=min_speakers, max_speakers=max_speakers)
        return DiarizationAnnotation(turns)


class _Turn:
    def __init__(self, start: float, end: float):
        self.start = start
        self.end = end


class DiarizationAnnotation:
    """Minimal pyannote.Annotation-compatible result object."""

    def __init__(self, turns: Sequence[Tuple[float, float, int]]):
        self.turns = list(turns)

    def itertracks(self, yield_label: bool = False):
        for i, (start, end, spk) in enumerate(self.turns):
            turn = _Turn(start, end)
            if yield_label:
                yield turn, str(i), f"SPEAKER_{spk:02d}"
            else:
                yield turn, str(i)

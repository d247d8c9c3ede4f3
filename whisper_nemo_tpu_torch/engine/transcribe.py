"""WhisperEngine: VAD-windowed batched long-form transcription.

Counterpart of the batched half of ``whisper_nemo_tpu/engine/transcribe.py``
(faster-whisper's ``BatchedInferencePipeline`` strategy): energy-VAD
spans merge into windows of at most 30 s, windows run through the
encoder and a greedy or beam no-timestamp decode in batches, and each
window becomes one segment bounded by its span. The waveform goes to the
device once per call and each window is a slice of it.
"""

from __future__ import annotations

import os
import zlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.whisper import WhisperDims, encode
from ..models.whisper_stacked import stack_decoder_blocks
from ..ops.mel import HOP_LENGTH, N_SAMPLES, SAMPLE_RATE, log_mel_spectrogram_batch
from ..text.tokenizer import WhisperTokenizer, get_suppressed_tokens
from ..vad.energy import get_speech_timestamps
from .checkpoint import cast_floats, model_cache_dir, resolve_model, to_device
from .decode import ROADMAP_NOTE, DecodeOptions, beam_decode, build_suppress_mask, greedy_decode
from .quantize import quantize_whisper_params


@dataclass
class Segment:
    id: int
    seek: int
    start: float
    end: float
    text: str
    tokens: List[int]
    temperature: float = 0.0
    avg_logprob: float = 0.0
    compression_ratio: float = 0.0
    no_speech_prob: float = 0.0
    words: Optional[list] = None


@dataclass
class TranscriptionInfo:
    language: str
    language_probability: float
    duration: float
    duration_after_vad: float = 0.0
    all_language_probs: Optional[list] = None


def compression_ratio(text: str) -> float:
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


# compute type -> activation dtype; every one of these stores the
# cross-attention KV as int8 (the decode layout kernel A reads)
_COMPUTE_DTYPES = {
    "int8": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "float16": torch.bfloat16,
}


class WhisperEngine:
    """Model + tokenizer + batched greedy or beam decode on one device."""

    def __init__(
        self,
        model_name: str = "tiny",
        compute_type: str = "int8",
        device="cuda",
        params=None,
        dims: Optional[WhisperDims] = None,
        tokenizer: Optional[WhisperTokenizer] = None,
        kv_bits: int = 8,
        seed: int = 0,
    ):
        """``device`` is explicit ("cuda", "cuda:N" or "cpu"). ``params``
        (the port's tree, f32) and ``dims`` skip resolution by name;
        otherwise a checkpoint is looked up, and missing that, the model
        is initialized from ``seed`` on ``device``."""
        if compute_type not in _COMPUTE_DTYPES:
            raise NotImplementedError(
                f"compute_type {compute_type!r} (float cross-attention KV) is "
                f"{ROADMAP_NOTE}; the port runs {sorted(_COMPUTE_DTYPES)}"
            )
        if kv_bits not in (4, 8):
            raise ValueError(f"kv_bits must be 4 or 8, got {kv_bits}")
        self.device = torch.device(device)
        if params is None or dims is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params, dims = resolve_model(model_name, self.device, gen)
        params = to_device(params, self.device)
        if compute_type == "int8":
            params = quantize_whisper_params(params)
        else:
            params = cast_floats(params, torch.bfloat16)
        # the encoder reads the per-layer blocks; the decoder loop reads
        # the layer-stacked tree (models.whisper_stacked)
        self.params = stack_decoder_blocks(params)
        self.dims = dims
        self.model_name = model_name
        self.dtype = _COMPUTE_DTYPES[compute_type]
        self.kv_bits = kv_bits
        self.multilingual = not model_name.endswith(".en")
        if tokenizer is None:
            tokenizer = _find_tokenizer(model_name, dims, self.multilingual)
        self.tokenizer = tokenizer
        # decode steps of each batch of the last transcribe_batched call
        self.last_decode_steps: List[int] = []

    def _make_opts(self, **over) -> DecodeOptions:
        t = self.tokenizer
        kw = dict(
            eot=t.eot,
            sot=t.sot,
            no_speech=t.no_speech,
            no_timestamps=t.no_timestamps,
            timestamp_begin=t.timestamp_begin,
            blank_token=t.encode(" ")[0],
        )
        kw.update(over)
        return DecodeOptions(**kw)

    def unload(self) -> None:
        """Drop the parameters and return their device memory."""
        self.params = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.inference_mode()
    def encode_windows(self, mels: torch.Tensor) -> torch.Tensor:
        """``[B, n_mels, 3000]`` -> ``[B, 1500, D]``."""
        return encode(self.params, mels, self.dims, self.dtype)

    def _decode_batch(
        self,
        feats: torch.Tensor,
        language: Optional[str],
        suppress_mask: torch.Tensor,
        task: str = "transcribe",
        beam_size: int = 1,
    ):
        sot_seq = self.tokenizer.sot_sequence(
            language if self.multilingual else None, task, without_timestamps=True
        )
        n_prompt = len(sot_seq)
        opts = self._make_opts(max_new_tokens=min(224, self.dims.n_text_ctx - n_prompt))
        prompt = torch.tensor(sot_seq, device=self.device).repeat(feats.shape[0], 1)
        if beam_size > 1:
            out = beam_decode(
                self.params, feats, prompt, suppress_mask, self.dims, opts,
                beam_size=beam_size, dtype=self.dtype, kv_bits=self.kv_bits,
            )
        else:
            out = greedy_decode(
                self.params, feats, prompt, suppress_mask, self.dims, opts,
                dtype=self.dtype, kv_bits=self.kv_bits,
            )
        tokens, length, sum_logprob, no_speech, steps = out
        return tokens, length, sum_logprob, no_speech, n_prompt, steps

    def transcribe_batched(
        self,
        audio: np.ndarray,
        language: Optional[str] = None,
        suppress_tokens: Sequence[int] = (-1,),
        batch_size: int = 8,
        without_timestamps: bool = True,
        beam_size: int = 1,
        task: str = "transcribe",
    ) -> Tuple[List[Segment], TranscriptionInfo]:
        if beam_size < 1:
            raise ValueError(f"beam_size must be at least 1, got {beam_size}")
        if not without_timestamps:
            raise NotImplementedError(f"timestamp decoding is {ROADMAP_NOTE}")
        duration = len(audio) / SAMPLE_RATE
        wave = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(self.device)
        spans = get_speech_timestamps(audio, device=self.device, wave=wave)
        if not spans:
            spans = [{"start": 0, "end": len(audio)}]
        windows = _merge_spans_into_windows(spans, N_SAMPLES)
        duration_after_vad = sum(e - s for s, e in windows) / SAMPLE_RATE

        if language is None:
            if self.multilingual:
                raise NotImplementedError(f"language detection is {ROADMAP_NOTE}")
            language = "en"
        suppress_mask = torch.from_numpy(
            build_suppress_mask(
                self.dims.n_vocab, get_suppressed_tokens(self.tokenizer, suppress_tokens)
            )
        ).to(self.device)

        segments: List[Segment] = []
        self.last_decode_steps = []
        for batch_start in range(0, len(windows), batch_size):
            batch = windows[batch_start : batch_start + batch_size]
            # the last partial batch is zero-padded to batch_size, as in the
            # JAX package: the cross-KV scales are taken over the batch
            waves = torch.zeros((batch_size, N_SAMPLES), device=self.device)
            for i, (s, e) in enumerate(batch):
                n = min(e - s, N_SAMPLES)
                waves[i, :n] = wave[s : s + n]
            mels = log_mel_spectrogram_batch(waves, self.dims.n_mels)
            feats = self.encode_windows(mels)
            tokens, lengths, sum_lp, no_speech, n_prompt, steps = self._decode_batch(
                feats, language, suppress_mask, task=task, beam_size=beam_size
            )
            self.last_decode_steps.append(steps)
            tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
            sum_lp, no_speech = sum_lp.cpu().numpy(), no_speech.cpu().numpy()
            for i, (s, e) in enumerate(batch):
                toks = tokens[i, n_prompt : n_prompt + lengths[i]].tolist()
                text = self.tokenizer.decode(toks)
                segments.append(
                    Segment(
                        id=len(segments),
                        seek=s // HOP_LENGTH,
                        start=s / SAMPLE_RATE,
                        end=e / SAMPLE_RATE,
                        text=text,
                        tokens=toks,
                        avg_logprob=float(sum_lp[i]) / (int(lengths[i]) + 1),
                        compression_ratio=compression_ratio(text),
                        no_speech_prob=float(no_speech[i]),
                    )
                )
        info = TranscriptionInfo(
            language=language,
            language_probability=1.0,
            duration=duration,
            duration_after_vad=duration_after_vad,
        )
        return segments, info


def _find_tokenizer(model_name: str, dims: WhisperDims, multilingual: bool):
    candidates = [model_cache_dir()]
    if os.sep in model_name:
        candidates.insert(0, os.path.dirname(model_name))
    for vocab_dir in candidates:
        if os.path.exists(os.path.join(vocab_dir, "vocab.json")) or os.path.exists(
            os.path.join(vocab_dir, "tokenizer.json")
        ):
            return WhisperTokenizer.from_dir(vocab_dir, multilingual=multilingual)
    n_langs = 100 if dims.n_vocab >= 51866 else 99
    return WhisperTokenizer.byte_fallback(multilingual=multilingual, n_languages=n_langs)


def _merge_spans_into_windows(spans: List[dict], max_samples: int) -> List[Tuple[int, int]]:
    """Merge VAD spans into decode windows of at most ``max_samples``:
    adjacent spans pack into one window while the combined extent fits;
    an oversized span is sliced into ``max_samples`` pieces."""
    windows: List[Tuple[int, int]] = []
    cur_start = cur_end = None
    for span in spans:
        s, e = span["start"], span["end"]
        while e - s > max_samples:
            if cur_start is not None:
                windows.append((cur_start, cur_end))
                cur_start = cur_end = None
            windows.append((s, s + max_samples))
            s += max_samples
        if cur_start is None:
            cur_start, cur_end = s, e
        elif e - cur_start <= max_samples:
            cur_end = e
        else:
            windows.append((cur_start, cur_end))
            cur_start, cur_end = s, e
    if cur_start is not None:
        windows.append((cur_start, cur_end))
    return windows

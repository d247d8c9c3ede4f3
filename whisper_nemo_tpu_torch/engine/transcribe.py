"""WhisperEngine: long-form transcription, batched and sequential.

Counterpart of ``whisper_nemo_tpu/engine/transcribe.py``, both strategies:

- **batched** (faster-whisper's ``BatchedInferencePipeline``): energy-VAD
  spans merge into windows of at most 30 s, windows run through the
  encoder and a greedy or beam decode in batches, and each window becomes
  one segment bounded by its span (timestamp tokens, when asked for, are
  decoded and kept in the tokens);
- **sequential** (faster-whisper's ``WhisperModel.transcribe`` and
  openai-whisper's ``transcribe``): a 30 s window slides over the audio
  (after the VAD filter, if asked), its single-window mel runs kernel C,
  timestamp tokens split it into segments and set the next seek, a
  temperature ladder falls back on the compression-ratio and log-prob
  gates, and the previous text conditions the next window through a
  left-padded prefix.

The waveform goes to the device once per call; each window is a slice of
it.
"""

from __future__ import annotations

import functools
import os
import zlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.whisper import WhisperDims, encode
from ..models.whisper_stacked import stack_decoder_blocks
from ..ops.mel import (
    HOP_LENGTH,
    N_SAMPLES,
    SAMPLE_RATE,
    log_mel_spectrogram,
    log_mel_spectrogram_batch,
)
from ..text.languages import LANGUAGES
from ..text.tokenizer import WhisperTokenizer, get_suppressed_tokens
from ..vad.energy import get_speech_timestamps
from .checkpoint import cast_floats, model_cache_dir, resolve_model, to_device
from .decode import (
    DecodeOptions,
    beam_decode,
    build_suppress_mask,
    detect_language,
    greedy_decode,
)
from .precision import full_f32
from .quantize import quantize_whisper_params

FRAMES_PER_WINDOW = 3000  # 30 s of 10 ms mel frames
TIME_PER_FRAME = HOP_LENGTH / SAMPLE_RATE  # 0.01 s


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


# compute type -> activation dtype, as the JAX package maps them. The f32
# widths keep f32 weights and a float cross-attention KV; the reduced
# widths store bf16 weights (or int8 weight-only linears) and the int8
# cross-attention KV of kernel A's decode layout.
_COMPUTE_DTYPES = {
    "default": torch.float32,
    "float32": torch.float32,
    "int8": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "float16": torch.bfloat16,
}


def _window_at(wave: torch.Tensor, start_sample: int) -> torch.Tensor:
    """The 30 s window of the device waveform ``wave`` from
    ``start_sample``, zero-padded past its end."""
    window = torch.zeros(N_SAMPLES, dtype=torch.float32, device=wave.device)
    piece = wave[start_sample : start_sample + N_SAMPLES]
    window[: piece.shape[0]] = piece
    return window


# the largest beam kernels A and E take on the card (the plain versions
# take any)
MAX_CUDA_BEAM = 8


def _check_beam(beam_size: int, device: torch.device) -> None:
    if beam_size < 1:
        raise ValueError(f"beam_size must be at least 1, got {beam_size}")
    if device.type == "cuda" and beam_size > MAX_CUDA_BEAM:
        raise NotImplementedError(
            f"beam_size {beam_size} on a CUDA device: kernels A and E take beams of 1 to"
            f" {MAX_CUDA_BEAM} (ROADMAP.md, known differences)"
        )


def _full_f32_at_f32_widths(method):
    """Runs an engine method with full-f32 matrix products and
    convolutions on the card (TF32 off) when the engine runs an f32 width,
    as the JAX package computes on the CPU, where the port is held against
    it (``full_f32``). The reduced widths leave the settings as they are."""

    @functools.wraps(method)
    def run(self, *args, **kwargs):
        if self.dtype != torch.float32:
            return method(self, *args, **kwargs)
        with full_f32():
            return method(self, *args, **kwargs)

    return run


class WhisperEngine:
    """Model + tokenizer + greedy, sampled or beam decode on one device."""

    PREV_BLOCK = 65  # fixed slots for <|startofprev|> + the conditioning tail

    def __init__(
        self,
        model_name: str = "tiny",
        compute_type: str = "default",
        device="cuda",
        params=None,
        dims: Optional[WhisperDims] = None,
        tokenizer: Optional[WhisperTokenizer] = None,
        kv_bits: Optional[int] = None,
        seed: int = 0,
    ):
        """``device`` is explicit ("cuda", "cuda:N" or "cpu"). ``params``
        (the port's tree, f32) and ``dims`` skip resolution by name;
        otherwise a checkpoint is looked up, and missing that, the model
        is initialized from ``seed`` on ``device``. ``compute_type`` is
        the JAX package's: "default" and "float32" run f32 with a float
        cross-attention KV; "bfloat16" and "float16" run bf16 weights and
        "int8" int8 weight-only linears, both with the int8 cross-KV at
        ``kv_bits`` (8 or 4; default 8), which the f32 widths refuse. At
        the f32 widths the engine's calls run f32 matrix products and
        convolutions in full f32 (TF32 off) and restore the caller's
        settings after (``_full_f32_at_f32_widths``)."""
        if compute_type not in _COMPUTE_DTYPES:
            raise ValueError(
                f"compute_type {compute_type!r} is none of {sorted(_COMPUTE_DTYPES)}"
            )
        self.dtype = _COMPUTE_DTYPES[compute_type]
        # the decode's cross-KV: the int8 decode layout at these bits at the
        # reduced widths, as in the JAX package; the float form (None) at
        # the f32 widths
        if self.dtype == torch.float32:
            if kv_bits is not None:
                raise ValueError(
                    f"compute_type {compute_type!r} keeps a float cross-attention KV; kv_bits"
                    " applies to the reduced widths only"
                )
            self.cross_kv_bits: Optional[int] = None
        else:
            self.cross_kv_bits = 8 if kv_bits is None else kv_bits
            if self.cross_kv_bits not in (4, 8):
                raise ValueError(f"kv_bits must be 4 or 8, got {kv_bits}")
        self.device = torch.device(device)
        if params is None or dims is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params, dims = resolve_model(model_name, self.device, gen)
        params = to_device(params, self.device)
        if compute_type == "int8":
            params = quantize_whisper_params(params)
        elif self.dtype == torch.bfloat16:
            # stored in bf16, as the JAX package stores them, not cast per use
            params = cast_floats(params, torch.bfloat16)
        # the encoder reads the per-layer blocks; the decoder loop reads
        # the layer-stacked tree (models.whisper_stacked)
        self.params = stack_decoder_blocks(params)
        self.dims = dims
        self.model_name = model_name
        self.multilingual = not model_name.endswith(".en")
        if tokenizer is None:
            tokenizer = _find_tokenizer(model_name, dims, self.multilingual)
        self.tokenizer = tokenizer
        # decode steps of each batch of the last transcribe_batched call
        self.last_decode_steps: List[int] = []
        # per seek window of the last transcribe_sequential call: seek,
        # frames consumed, the conditioning tail, the temperatures tried
        # with their decode steps, and the tokens kept
        self.last_windows: List[dict] = []

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

    @_full_f32_at_f32_widths
    @torch.inference_mode()
    def encode_windows(self, mels: torch.Tensor) -> torch.Tensor:
        """``[B, n_mels, 3000]`` -> ``[B, 1500, D]``."""
        return encode(self.params, mels, self.dims, self.dtype)

    @_full_f32_at_f32_widths
    def mel_window(self, audio) -> torch.Tensor:
        """Mel ``[n_mels, 3000]`` of a chunk (numpy or a tensor), padded or
        trimmed to 30 s on the device: kernel C on a CUDA device."""
        if isinstance(audio, np.ndarray):
            audio = torch.from_numpy(np.ascontiguousarray(audio, np.float32))
        return log_mel_spectrogram(_window_at(audio.to(self.device).float(), 0), self.dims.n_mels)

    @_full_f32_at_f32_widths
    def detect_language(self, audio, return_all: bool = False):
        """Language of the first 30 s window: (code, probability), and with
        ``return_all`` also every (code, probability), most probable first
        (faster-whisper's ``all_language_probs``). English-only models
        answer "en" without running the model."""
        if not self.multilingual:
            return ("en", 1.0, [("en", 1.0)]) if return_all else ("en", 1.0)
        feats = self.encode_windows(self.mel_window(audio)[None])
        layout = self.tokenizer.layout
        idx, probs = detect_language(
            self.params, feats, self.dims, self.tokenizer.sot, layout.language_start,
            layout.n_languages, self.dtype,
        )
        codes = list(LANGUAGES.keys())[: layout.n_languages]
        i = int(idx[0])
        p = probs[0].cpu().numpy()
        if not return_all:
            return codes[i], float(p[i])
        ranked = sorted(zip(codes, p.tolist()), key=lambda cp: -cp[1])
        return codes[i], float(p[i]), ranked

    @_full_f32_at_f32_widths
    def _decode_batch(
        self,
        feats: torch.Tensor,
        language: Optional[str],
        suppress_mask: torch.Tensor,
        without_timestamps: bool = True,
        temperature: float = 0.0,
        rng_seed: int = 0,
        previous_tokens: Optional[Sequence[int]] = None,
        beam_size: int = 1,
        task: str = "transcribe",
        min_new_tokens: int = 0,
        max_new_tokens: Optional[int] = None,
    ):
        """Decode a batch of encoded windows -> (tokens, lengths,
        sum_logprob, no_speech_prob on the device, n_prompt, steps).
        ``previous_tokens`` conditions every window through a left-padded
        block of ``PREV_BLOCK`` slots: pad (EOT, masked), <|startofprev|>,
        then the tail of the previous text. Beam search runs at
        temperature 0 only; a sampled decode draws from a generator seeded
        with ``rng_seed``. EOT is suppressed below ``min_new_tokens``
        generated tokens, and a window stops at ``min(max_new_tokens or
        224, n_text_ctx - n_prompt)``, as in the JAX package."""
        b = feats.shape[0]
        prompt_np, valid_np = self._prompt(language, without_timestamps, previous_tokens, task)
        n_prompt = prompt_np.shape[0]
        opts = self._make_opts(
            without_timestamps=without_timestamps,
            temperature=float(temperature),
            min_new_tokens=min_new_tokens,
            max_new_tokens=min(max_new_tokens or 224, self.dims.n_text_ctx - n_prompt),
        )
        prompt_np = np.tile(prompt_np, (b, 1))
        prompt_valid = None
        if valid_np is not None:
            prompt_valid = torch.from_numpy(np.tile(valid_np, (b, 1))).to(self.device)
        prompt = torch.from_numpy(prompt_np).to(self.device)
        if beam_size > 1 and temperature == 0.0:
            out = beam_decode(
                self.params, feats, prompt, suppress_mask, self.dims, opts,
                beam_size=beam_size, dtype=self.dtype, kv_bits=self.cross_kv_bits,
                prompt_valid=prompt_valid,
            )
        else:
            generator = None
            if temperature > 0:
                generator = torch.Generator(device=self.device).manual_seed(rng_seed)
            out = greedy_decode(
                self.params, feats, prompt, suppress_mask, self.dims, opts,
                dtype=self.dtype, kv_bits=self.cross_kv_bits, prompt_valid=prompt_valid,
                generator=generator,
            )
        tokens, length, sum_logprob, no_speech, steps = out
        return tokens, length, sum_logprob, no_speech, n_prompt, steps

    def _prompt(
        self,
        language: Optional[str],
        without_timestamps: bool,
        previous_tokens: Optional[Sequence[int]],
        task: str = "transcribe",
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """One window's prompt ``[n_prompt]`` int64 and, with a
        conditioning block, its real slots ``[n_prompt]`` bool (else None).
        The block has ``min(PREV_BLOCK, n_text_ctx - len(sot) - 64)`` slots,
        which leaves room for a useful generation budget; without room,
        there is no conditioning."""
        sot_seq = self.tokenizer.sot_sequence(
            language if self.multilingual else None, task, without_timestamps=without_timestamps
        )
        pb = min(self.PREV_BLOCK, max(0, self.dims.n_text_ctx - len(sot_seq) - 64))
        if previous_tokens is None or pb == 0:
            return np.asarray(sot_seq, np.int64), None
        block = np.full(pb, self.tokenizer.eot, np.int64)
        valid = np.zeros(pb, bool)
        tail = list(previous_tokens)[-(pb - 1):]
        if tail:
            block[pb - len(tail) - 1] = self.tokenizer.layout.startofprev
            block[pb - len(tail):] = tail
            valid[pb - len(tail) - 1:] = True
        return (np.concatenate([block, np.asarray(sot_seq, np.int64)]),
                np.concatenate([valid, np.ones(len(sot_seq), bool)]))

    def _suppress_mask(self, suppress_tokens: Sequence[int]) -> torch.Tensor:
        return torch.from_numpy(
            build_suppress_mask(
                self.dims.n_vocab, get_suppressed_tokens(self.tokenizer, suppress_tokens)
            )
        ).to(self.device)

    @_full_f32_at_f32_widths
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
        _check_beam(beam_size, self.device)
        duration = len(audio) / SAMPLE_RATE
        wave = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(self.device)
        spans = get_speech_timestamps(audio, device=self.device, wave=wave)
        if not spans:
            spans = [{"start": 0, "end": len(audio)}]
        windows = _merge_spans_into_windows(spans, N_SAMPLES)
        duration_after_vad = sum(e - s for s, e in windows) / SAMPLE_RATE

        all_lang_probs = None
        if language is None:
            s0, e0 = windows[0]
            language, lang_prob, all_lang_probs = self.detect_language(wave[s0:e0], return_all=True)
        else:
            lang_prob = 1.0
        suppress_mask = self._suppress_mask(suppress_tokens)

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
                feats, language, suppress_mask, without_timestamps, 0.0,
                beam_size=beam_size, task=task,
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
            language_probability=lang_prob,
            duration=duration,
            duration_after_vad=duration_after_vad,
            all_language_probs=all_lang_probs,
        )
        return segments, info

    @_full_f32_at_f32_widths
    def transcribe_sequential(
        self,
        audio: np.ndarray,
        language: Optional[str] = None,
        suppress_tokens: Sequence[int] = (-1,),
        vad_filter: bool = False,
        temperatures: Sequence[float] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
        compression_ratio_threshold: float = 2.4,
        logprob_threshold: float = -1.0,
        no_speech_threshold: float = 0.6,
        condition_on_previous_text: bool = True,
        without_timestamps: bool = False,
        beam_size: int = 1,
        task: str = "transcribe",
        initial_prompt: Optional[str] = None,
    ) -> Tuple[List[Segment], TranscriptionInfo]:
        _check_beam(beam_size, self.device)
        duration = len(audio) / SAMPLE_RATE
        wave = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(self.device)
        time_map = None  # [(concat_start_s, orig_start_s, dur_s)]
        if vad_filter:
            spans = get_speech_timestamps(audio, device=self.device, wave=wave)
            if spans:
                wave = torch.cat([wave[s["start"] : s["end"]] for s in spans])
                time_map = []
                offset = 0.0
                for s in spans:
                    dur = (s["end"] - s["start"]) / SAMPLE_RATE
                    time_map.append((offset, s["start"] / SAMPLE_RATE, dur))
                    offset += dur
        n_samples = wave.shape[0]
        duration_after_vad = n_samples / SAMPLE_RATE

        all_lang_probs = None
        if language is None:
            language, lang_prob, all_lang_probs = self.detect_language(wave, return_all=True)
        else:
            lang_prob = 1.0
        suppress_mask = self._suppress_mask(suppress_tokens)

        content_frames = n_samples // HOP_LENGTH
        seek = 0
        segments: List[Segment] = []
        self.last_windows = []
        ts_begin = self.tokenizer.timestamp_begin
        all_tokens: List[int] = []  # conditioning history
        if initial_prompt:
            # a user's prompt conditions the first window even without
            # condition_on_previous_text (faster-whisper's contract)
            all_tokens.extend(self.tokenizer.encode(" " + initial_prompt.strip()))
        prompt_reset_since = 0

        while seek < content_frames:
            time_offset = seek * TIME_PER_FRAME
            window_frames = min(FRAMES_PER_WINDOW, content_frames - seek)
            mel = log_mel_spectrogram(_window_at(wave, seek * HOP_LENGTH), self.dims.n_mels)
            feats = self.encode_windows(mel[None])
            previous = all_tokens[prompt_reset_since:] or None
            record = {"seek": seek, "previous": previous and previous[-(self.PREV_BLOCK - 1):],
                      "temperatures": [], "steps": []}
            self.last_windows.append(record)

            result = None
            for ti, temp in enumerate(temperatures):
                tokens, lengths, sum_lp, no_speech, n_prompt, steps = self._decode_batch(
                    feats, language, suppress_mask, without_timestamps, temp,
                    rng_seed=seek + ti, previous_tokens=previous, beam_size=beam_size,
                    task=task,
                )
                record["temperatures"].append(temp)
                record["steps"].append(steps)
                n_gen = int(lengths[0])
                toks = tokens[0, n_prompt : n_prompt + n_gen].tolist()
                text = self.tokenizer.decode(toks)
                avg_lp = float(sum_lp[0]) / (n_gen + 1)
                cr = compression_ratio(text)
                needs_fallback = cr > compression_ratio_threshold or avg_lp < logprob_threshold
                result = (toks, text, avg_lp, cr, float(no_speech[0]), temp)
                if not needs_fallback:
                    break

            toks, text, avg_lp, cr, no_speech_p, temp = result
            record["tokens"], record["avg_logprob"] = toks, avg_lp
            # silent-window skip
            if no_speech_p > no_speech_threshold and avg_lp < logprob_threshold:
                record["frames"] = window_frames
                seek += window_frames
                continue

            new_segments, frames_consumed = _split_on_timestamps(
                toks, ts_begin, time_offset, window_frames * TIME_PER_FRAME, window_frames
            )
            for s_toks, s_start, s_end in new_segments:
                s_text = self.tokenizer.decode(s_toks)
                # an open segment begun past the window's audio runs to the
                # window's end, before its start: its text lies over the
                # zero padding (the JAX package keeps it)
                if not s_text.strip() or s_end <= s_start:
                    continue
                segments.append(
                    Segment(
                        id=len(segments),
                        seek=seek,
                        start=s_start,
                        end=s_end,
                        text=s_text,
                        tokens=s_toks,
                        temperature=temp,
                        avg_logprob=avg_lp,
                        compression_ratio=cr,
                        no_speech_prob=no_speech_p,
                    )
                )
            all_tokens.extend(toks)
            record["frames"] = frames_consumed
            seek += frames_consumed
            if temp > 0.5 or not condition_on_previous_text:
                # high-temperature output is unreliable context; without
                # conditioning only initial_prompt ever reaches the decoder
                prompt_reset_since = len(all_tokens)

        if time_map is not None:
            # times on the VAD-concatenated audio back to the recording's
            for seg in segments:
                seg.start = _restore_vad_time(seg.start, time_map)
                seg.end = _restore_vad_time(seg.end, time_map)
        info = TranscriptionInfo(
            language=language,
            language_probability=lang_prob,
            duration=duration,
            duration_after_vad=duration_after_vad,
            all_language_probs=all_lang_probs,
        )
        return segments, info


def _restore_vad_time(t: float, time_map) -> float:
    """Concatenated-audio time -> original-recording time."""
    for concat_start, orig_start, dur in time_map:
        if t <= concat_start + dur:
            return orig_start + max(0.0, t - concat_start)
    last_c, last_o, last_d = time_map[-1]
    return last_o + last_d + (t - last_c - last_d)


def _split_on_timestamps(
    tokens: List[int],
    ts_begin: int,
    time_offset: float,
    window_duration: float,
    window_frames: int,
) -> Tuple[List[Tuple[List[int], float, float]], int]:
    """Decoded tokens -> (segments ``(tokens, start_s, end_s)``, frames
    consumed). A segment is the text between a timestamp and the next;
    the last closed timestamp sets how far the window consumed its audio
    (whisper's seek rule), an open segment consumes the whole window."""
    def ts_value(t):
        return (t - ts_begin) * 0.02

    if not any(t >= ts_begin for t in tokens):
        return [(tokens, time_offset, time_offset + window_duration)], window_frames

    segments = []
    prev_ts_val = 0.0
    consumed = window_frames
    pending_start: Optional[float] = None
    seg_tokens: List[int] = []
    for tok in tokens:
        if tok >= ts_begin:
            if pending_start is None:
                pending_start = ts_value(tok)
                seg_tokens = []
            else:
                segments.append(
                    (seg_tokens, time_offset + pending_start, time_offset + ts_value(tok))
                )
                prev_ts_val = ts_value(tok)
                pending_start = None
                seg_tokens = []
        else:
            seg_tokens.append(tok)
    if pending_start is not None and seg_tokens:
        # an open segment runs to the window's end
        segments.append((seg_tokens, time_offset + pending_start, time_offset + window_duration))
        consumed = window_frames
    elif prev_ts_val > 0:
        consumed = min(window_frames, max(1, int(round(prev_ts_val / 0.01))))
    if not segments and seg_tokens:
        segments.append((seg_tokens, time_offset, time_offset + window_duration))
    return segments, consumed


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

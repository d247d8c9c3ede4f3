"""Cross-request window batching for serving.

Counterpart of ``whisper_nemo_tpu/serving/scheduler.py``. The reference
serves one request at a time (RunPod worker). A decode batch is most
efficient full, so this scheduler lets many concurrent transcription
requests share one engine: each request's 30 s windows enter a queue, a
single device thread drains the queue into batches (padding the tail to
a bucket size), and per-window results are routed back to the submitting
request's future. With one request the behavior degrades to plain
batched decoding; with many, windows from different requests ride the
same decode loop ("continuous batching" at window granularity — natural
for Whisper because every window is an independent decode).

A batch runs one launch of kernel C for its mel, the encoder (kernel B)
and the decode (kernel A over the int8 cross-KV at the reduced widths).
The worker thread enters ``torch.inference_mode`` and the engine's CUDA
device itself: both are thread-local.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..engine.decode import build_suppress_mask
from ..engine.transcribe import (
    Segment,
    WhisperEngine,
    _merge_spans_into_windows,
    _split_on_timestamps,
    compression_ratio,
)
from ..ops.mel import HOP_LENGTH, N_SAMPLES, SAMPLE_RATE, log_mel_spectrogram_batch
from ..text.tokenizer import get_suppressed_tokens
from ..utils import get_logger
from ..vad.energy import get_speech_timestamps

logger = get_logger(__name__)


def on_device(device: torch.device) -> contextlib.ExitStack:
    """``torch.inference_mode`` and ``device`` as the calling thread's CUDA
    device, for a thread that runs a model: both are thread-local, and
    without the device a ``cuda:N`` model's kernels would launch on
    device 0."""
    stack = contextlib.ExitStack()
    stack.enter_context(torch.inference_mode())
    if device.type == "cuda":
        stack.enter_context(torch.cuda.device(device))
    return stack


@dataclass
class _WindowItem:
    audio: np.ndarray  # exactly one ≤30 s window, zero-padded by caller
    start_s: float
    end_s: float
    language: str
    future: Future = field(default_factory=Future)


class WindowScheduler:
    """Single-device scheduler batching windows across requests."""

    def __init__(
        self,
        engine: WhisperEngine,
        batch_size: int = 16,
        max_wait_s: float = 0.05,
        beam_size: int = 1,
        max_new_tokens: Optional[int] = None,
        without_timestamps: bool = True,
        min_new_tokens: int = 0,
        bucket_sizes: Optional[List[int]] = None,
        bucket_policy: str = "two-tier",
        load_cooldown_s: float = 2.0,
    ):
        """``bucket_sizes`` overrides the power-of-two pad targets
        (ascending; batch_size is appended if absent). A single-entry
        list ``[batch_size]`` recovers full-batch padding. Env
        override: ``WNT_SERVING_BUCKETS`` as comma-separated ints.

        ``bucket_policy`` decides WHEN a partial batch pads to a small
        bucket instead of the full batch:

        - ``"two-tier"`` (default): pad to a small bucket only while
          the scheduler is idle — no full batch dispatched and no
          queue backlog seen within the last ``load_cooldown_s``
          seconds. A lone request on a quiet worker gets the bucket-1
          decode; a saturated run keeps every dispatch (including
          mid-run stragglers and the drain tail) at the full batch.
        - ``"always"``: every partial batch buckets.
        - ``"never"``: always pad to the full batch.

        Env override: ``WNT_SERVING_BUCKET_POLICY``. ``max_new_tokens``
        and ``min_new_tokens`` bound each window's generated tokens
        (``WhisperEngine._decode_batch``)."""
        self.engine = engine
        self.batch_size = batch_size
        env_buckets = os.environ.get("WNT_SERVING_BUCKETS")
        if bucket_sizes is None and env_buckets:
            try:
                bucket_sizes = [int(v) for v in env_buckets.split(",") if v]
            except ValueError:
                logger.warning(
                    "ignoring malformed WNT_SERVING_BUCKETS=%r "
                    "(expected comma-separated ints)", env_buckets,
                )
                bucket_sizes = None
        if bucket_sizes is not None:
            sizes = sorted({min(b, batch_size) for b in bucket_sizes if b > 0})
            if not sizes or sizes[-1] != batch_size:
                sizes.append(batch_size)
            self._bucket_list = sizes
        else:
            self._bucket_list = None
        policy = os.environ.get("WNT_SERVING_BUCKET_POLICY", bucket_policy)
        if policy not in ("two-tier", "always", "never"):
            logger.warning(
                "unknown bucket policy %r; using 'two-tier'", policy
            )
            policy = "two-tier"
        self.bucket_policy = policy
        self.load_cooldown_s = load_cooldown_s
        self._loaded_until = 0.0  # monotonic deadline of the loaded state
        self.max_wait_s = max_wait_s
        self.beam_size = beam_size
        self.max_new_tokens = max_new_tokens
        # benchmarking knob: random-init weights never emit EOT, so a
        # bench pins decode work to the real-transcript token range
        self.min_new_tokens = min_new_tokens
        # timestamped mode decodes whisper's timestamp grammar and
        # splits each window into sub-segments with real in-window
        # times (what the serving merge with diarization turns needs);
        # futures then resolve to List[Segment] instead of one Segment
        self.without_timestamps = without_timestamps
        self._queue: "queue.Queue[_WindowItem]" = queue.Queue()
        # serving uses the engines' default suppression (the reference
        # handler runs openai-whisper defaults, main.py:381-391:
        # suppress_tokens="-1" → non-speech list + specials)
        self._suppress = torch.from_numpy(build_suppress_mask(
            engine.dims.n_vocab,
            get_suppressed_tokens(engine.tokenizer, (-1,)),
        )).to(engine.device)
        self._stop = threading.Event()
        self._worker = threading.Thread(
            target=self._run, name="window-scheduler", daemon=True
        )
        self._worker.start()

    # -- request side -------------------------------------------------------
    def submit_audio(
        self, audio: np.ndarray, language: str = "en"
    ) -> List[Future]:
        """Split a recording into VAD windows and enqueue them.

        Returns one future per window; each resolves to a Segment, or in
        timestamped mode to a list of them.
        """
        spans = get_speech_timestamps(audio, device=self.engine.device) or [
            {"start": 0, "end": len(audio)}
        ]
        windows = _merge_spans_into_windows(spans, N_SAMPLES)
        futures = []
        for s, e in windows:
            chunk = np.zeros(N_SAMPLES, np.float32)
            piece = audio[s:e][:N_SAMPLES]
            chunk[: len(piece)] = piece
            item = _WindowItem(
                audio=chunk,
                start_s=s / SAMPLE_RATE,
                end_s=e / SAMPLE_RATE,
                language=language,
            )
            self._queue.put(item)
            futures.append(item.future)
        return futures

    def transcribe(
        self, audio: np.ndarray, language: str = "en"
    ) -> List[Segment]:
        """Blocking convenience wrapper: submit and gather in order."""
        futures = self.submit_audio(audio, language)
        segments: List[Segment] = []
        for f in futures:
            result = f.result()
            segments.extend(result if isinstance(result, list) else [result])
        for i, seg in enumerate(segments):
            seg.id = i
        return segments

    def shutdown(self) -> None:
        self._stop.set()
        self._worker.join(timeout=5)

    # -- batch shaping --------------------------------------------------------
    def _buckets(self) -> List[int]:
        """Pad targets up to batch_size: the explicit ``bucket_sizes``
        list when given, else powers of two (plus batch_size itself
        when it is not a power of two)."""
        if self._bucket_list is not None:
            return self._bucket_list
        out, b = [], 1
        while b < self.batch_size:
            out.append(b)
            b *= 2
        out.append(self.batch_size)
        return out

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets():
            if n <= b:
                return b
        return self.batch_size

    def warmup(self) -> None:
        """Run every bucket shape (encode + decode) once before traffic,
        on the calling thread, so that the kernels are built and loaded
        and the allocator holds each shape's buffers before the first
        request."""
        for b in self._buckets():
            items = [
                _WindowItem(
                    audio=np.zeros(N_SAMPLES, np.float32),
                    start_s=0.0,
                    end_s=30.0,
                    language="en",
                )
                for _ in range(b)
            ]
            with on_device(self.engine.device):
                self._process(items)
            for item in items:
                item.future.result()

    # -- device side ---------------------------------------------------------
    def _collect_batch(self) -> List[_WindowItem]:
        items: List[_WindowItem] = []
        try:
            items.append(self._queue.get(timeout=0.1))
        except queue.Empty:
            return items
        # wait briefly for more work to fill the batch
        deadline = self.max_wait_s
        while len(items) < self.batch_size:
            try:
                items.append(self._queue.get(timeout=deadline))
            except queue.Empty:
                break
        return items

    def _loaded(self, n_collected: int) -> bool:
        """Two-tier load detector: a full batch or a queue backlog
        marks the scheduler loaded for ``load_cooldown_s`` seconds, so
        stragglers and the drain tail of a saturated run stay at the
        full batch instead of fragmenting across bucket shapes."""
        now = time.monotonic()
        if n_collected >= self.batch_size or self._queue.qsize() > 0:
            self._loaded_until = now + self.load_cooldown_s
        return now < self._loaded_until

    def _run(self) -> None:
        with on_device(self.engine.device):
            while not self._stop.is_set():
                items = self._collect_batch()
                if not items:
                    continue
                try:
                    self._process(items, loaded=self._loaded(len(items)))
                except Exception as exc:  # route the failure to every waiter
                    logger.error("scheduler batch failed: %s", exc)
                    for item in items:
                        if not item.future.done():
                            item.future.set_exception(exc)

    def _pad_target(self, n: int, loaded: bool) -> int:
        if self.bucket_policy == "never":
            return self.batch_size
        if self.bucket_policy == "two-tier" and loaded:
            return self.batch_size
        return self._bucket_for(n)

    def _process(self, items: List[_WindowItem], loaded: bool = False) -> None:
        engine = self.engine
        # group by language (prompt differs); usually one group
        by_lang = {}
        for item in items:
            by_lang.setdefault(item.language, []).append(item)
        for language, group in by_lang.items():
            # pad to the smallest power-of-two bucket when idle: a lone
            # request then pays a 1-window decode; under load, pad full
            # (see bucket_policy)
            bucket = self._pad_target(len(group), loaded)
            waves = np.zeros((bucket, N_SAMPLES), np.float32)
            for i, item in enumerate(group):
                waves[i] = item.audio
            mels = log_mel_spectrogram_batch(
                torch.from_numpy(waves).to(engine.device), engine.dims.n_mels
            )
            feats = engine.encode_windows(mels)
            tokens, lengths, sum_lp, no_speech, n_prompt, _ = engine._decode_batch(
                feats,
                language,
                self._suppress,
                self.without_timestamps,
                0.0,
                beam_size=self.beam_size,
                max_new_tokens=self.max_new_tokens,
                min_new_tokens=self.min_new_tokens,
            )
            tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
            sum_lp, no_speech = sum_lp.cpu().numpy(), no_speech.cpu().numpy()
            for i, item in enumerate(group):
                toks = tokens[i, n_prompt : n_prompt + lengths[i]].tolist()
                avg_lp = float(sum_lp[i]) / (int(lengths[i]) + 1)
                seek = int(item.start_s * SAMPLE_RATE) // HOP_LENGTH
                if self.without_timestamps:
                    text = engine.tokenizer.decode(toks)
                    item.future.set_result(
                        Segment(
                            id=0,
                            seek=seek,
                            start=item.start_s,
                            end=item.end_s,
                            text=text,
                            tokens=toks,
                            avg_logprob=avg_lp,
                            compression_ratio=compression_ratio(text),
                            no_speech_prob=float(no_speech[i]),
                        )
                    )
                    continue
                # timestamped mode: split the window on whisper's
                # timestamp tokens; in-window times are relative to the
                # window start (windows are contiguous original audio)
                window_duration = item.end_s - item.start_s
                window_frames = max(
                    1, int(round(window_duration / (HOP_LENGTH / SAMPLE_RATE)))
                )
                pieces, _ = _split_on_timestamps(
                    toks,
                    engine.tokenizer.timestamp_begin,
                    item.start_s,
                    window_duration,
                    window_frames,
                )
                out: List[Segment] = []
                for s_toks, s_start, s_end in pieces:
                    s_text = engine.tokenizer.decode(s_toks)
                    s_end = min(s_end, item.end_s)
                    # a segment that starts at or past the window's audio
                    # holds text decoded over its zero padding: the JAX
                    # package keeps it, ending at or before its start, and
                    # the handler's merge divides by its duration
                    if not s_text.strip() or s_end <= s_start:
                        continue
                    out.append(
                        Segment(
                            id=0,
                            seek=seek,
                            start=s_start,
                            end=s_end,
                            text=s_text,
                            tokens=s_toks,
                            avg_logprob=avg_lp,
                            compression_ratio=compression_ratio(s_text),
                            no_speech_prob=float(no_speech[i]),
                        )
                    )
                item.future.set_result(out)

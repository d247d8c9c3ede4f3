"""Serverless-style transcription job handler.

Counterpart of ``whisper_nemo_tpu/serving/handler.py``, the replacement
for the reference's RunPod worker (main.py:361-558): models load once at
worker start, each job dict (``{"id", "input": {...}}``) is validated
against the request schema, the audio is downloaded, transcribed through
the cross-request window scheduler (or the openai-whisper facade) and
optionally diarized, merged, smoothed and formatted; the JSON response
carries the same French-labeled fields and statistics block.

``serve`` runs a minimal asyncio HTTP front end on aiohttp exposing POST
/run with the same job schema (the stand-in for
``runpod.serverless.start``) and POST /stream, live NDJSON
transcription; ``python -m whisper_nemo_tpu_torch.serving.handler``
starts it. aiohttp is imported by ``serve``, ``stream_route`` and the
download only: ``ndjson_lines`` is the stream's logic without it.

Every model call runs in a thread that enters ``torch.inference_mode``
and its model's CUDA device (``scheduler.on_device``): both are
thread-local, and the handler's calls run on the event loop's executor
threads.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import traceback
from datetime import datetime
from typing import Any, AsyncIterable, AsyncIterator, Dict, Optional

import numpy as np
import torch

from ..post import (
    create_readable_transcript_improved,
    merge_transcription_with_speakers_improved,
)
from ..utils import get_logger
from ..utils.monitor import monitor_device_usage
from .download import download_audio_file
from .scheduler import on_device
from .schemas import TranscriptionRequest, TranscriptionResponse

logger = get_logger(__name__)

WHISPER_MODEL_NAME = os.environ.get("WNT_SERVING_MODEL", "large-v2")

whisper_model = None
diarization_pipeline = None
window_scheduler = None


def _devices(device: str):
    """(ASR device, diarization device) for ``device``: "cuda" takes the
    first CUDA device for ASR and the last for diarization (the
    reference's two-GPU placement, main.py:109-130: whisper on cuda:0,
    diarization on cuda:1), the same one when there is one; an explicit
    "cuda:N" or "cpu" takes that device for both. CUDA is required
    unless the caller names the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"load_models(device={device!r}) needs a CUDA device and none is available;"
            ' pass device="cpu" to serve on the host'
        )
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count()
        return torch.device("cuda", 0), torch.device("cuda", n - 1)
    return dev, dev


def load_models(warm: bool = True, device: str = "cuda") -> None:
    """Load the ASR engine and the diarization pipeline once
    (contract: main.py:102-138), stand up the cross-request window
    scheduler, and warm up so the first request pays steady-state
    latency (the reference fails fast with an import-time GPU warmup,
    main.py:33-38). The width comes from ``WNT_SERVING_COMPUTE``
    (default int8: int8 weight-only linears and the int8 cross-KV, the
    reference's reduced-precision serving choice, diarize.py:36) and is
    logged; the batch from ``WNT_SERVING_BATCH`` (default 16)."""
    global whisper_model, diarization_pipeline, window_scheduler

    from ..asr import load_model
    from ..diarize import SpeakerDiarizationPipeline
    from .scheduler import WindowScheduler

    asr_device, diar_device = _devices(device)
    compute_type = os.environ.get("WNT_SERVING_COMPUTE", "int8")
    logger.info(
        "loading whisper %s at compute type %s on %s; diarization on %s",
        WHISPER_MODEL_NAME, compute_type, asr_device, diar_device,
    )
    whisper_model = load_model(
        WHISPER_MODEL_NAME, device=str(asr_device), compute_type=compute_type
    )
    logger.info("loading diarization pipeline")
    diarization_pipeline = SpeakerDiarizationPipeline.from_pretrained(
        "speaker-diarization", device=diar_device
    )
    window_scheduler = WindowScheduler(
        whisper_model.engine,
        batch_size=int(os.environ.get("WNT_SERVING_BATCH", "16")),
        without_timestamps=False,
    )
    if warm:
        warmup()
    # device memory after load (contract: the reference polls
    # nvidia-smi from load_models, main.py:133)
    monitor_device_usage()
    logger.info("models ready")


def warmup() -> None:
    """Run the serving decode path once before the first request: one
    dummy batch per bucket shape through the scheduler (full encode +
    timestamped decode), then a one-second request, so that every kernel
    is built and loaded. Raises on failure — the fail-fast contract of
    the reference's import-time GPU check (main.py:33-38)."""
    import time

    t0 = time.time()
    window_scheduler.warmup()
    window_scheduler.transcribe(np.zeros(16000, np.float32), "en")
    logger.info("warmup done in %.1fs", time.time() - t0)


def _diarization_turns(
    audio_path: str,
    num_speakers: Optional[int],
    min_speakers: int,
    max_speakers: int,
):
    with on_device(diarization_pipeline.diarizer.device):
        result = diarization_pipeline(
            audio_path,
            num_speakers=num_speakers,
            min_speakers=min_speakers,
            max_speakers=max_speakers,
        )
    return [
        {"start": turn.start, "end": turn.end, "speaker": speaker}
        for turn, _, speaker in result.itertracks(yield_label=True)
    ]


def _transcribe_via_scheduler(audio_path: str, language: Optional[str]) -> dict:
    """Batched serving transcription through the shared window
    scheduler (cross-request continuous batching at window
    granularity), returning the openai-whisper dict contract the rest
    of the handler consumes."""
    from ..audio.decode import decode_audio

    audio = np.asarray(decode_audio(audio_path), np.float32)
    if language is None:
        with on_device(whisper_model.engine.device):
            language, _ = whisper_model.engine.detect_language(audio)
    segments = window_scheduler.transcribe(audio, language)
    return {
        "text": "".join(s.text for s in segments),
        "segments": [
            {
                "id": s.id,
                "seek": s.seek,
                "start": s.start,
                "end": s.end,
                "text": s.text,
                "tokens": s.tokens,
                "temperature": s.temperature,
                "avg_logprob": s.avg_logprob,
                "compression_ratio": s.compression_ratio,
                "no_speech_prob": s.no_speech_prob,
            }
            for s in segments
        ],
        "language": language,
        "duration": len(audio) / 16000.0,
    }


def _transcribe_via_facade(audio_path: str, language: Optional[str]) -> dict:
    """The reference-faithful sequential call through the openai facade
    (``WNT_SERVING_SCHEDULER=0``)."""
    with on_device(whisper_model.engine.device):
        return whisper_model.transcribe(
            audio_path,
            language=language,
            fp16=True,
            condition_on_previous_text=False,
            no_speech_threshold=0.6,
            logprob_threshold=-1.0,
            compression_ratio_threshold=2.4,
            temperature=0.0,
            verbose=False,
        )


async def process_transcription_optimized(
    audio_path: str, request: TranscriptionRequest
) -> TranscriptionResponse:
    """Transcribe (+ diarize + merge + format); error-wrapped response
    on failure (contract: main.py:361-486)."""
    start_time = datetime.now()
    try:
        language = None if request.language == "auto" else request.language
        use_scheduler = window_scheduler is not None and (
            os.environ.get("WNT_SERVING_SCHEDULER", "1") != "0"
        )
        # off the event loop: blocking future-gathers must not stall
        # other requests' submissions (two concurrent jobs share a
        # decode batch only if both can enqueue)
        transcription = await asyncio.get_running_loop().run_in_executor(
            None,
            _transcribe_via_scheduler if use_scheduler else _transcribe_via_facade,
            audio_path,
            language,
        )

        # device memory after the ASR stage (the reference polls
        # nvidia-smi during processing, main.py:85-100 called from the
        # worker loop)
        monitor_device_usage()

        if request.transcription_only:
            elapsed = (datetime.now() - start_time).total_seconds()
            return TranscriptionResponse(
                success=True,
                model=WHISPER_MODEL_NAME,
                transcription_brute=transcription["text"],
                parametres={
                    "transcription_only": True,
                    "language": request.language,
                },
                statistiques={
                    "duree_totale": f"{transcription.get('duration', 0):.1f}s",
                    "nombre_segments": len(transcription["segments"]),
                    "language_detected": transcription.get(
                        "language", "unknown"
                    ),
                },
                processing_time=elapsed,
            )

        # off the event loop for the same reason as the ASR stage: a
        # blocking diarization here would stall every other in-flight
        # job's submissions (and their /run responses) for the whole
        # diarize wall-time
        turns = await asyncio.get_running_loop().run_in_executor(
            None,
            _diarization_turns,
            audio_path,
            request.num_speakers,
            request.min_speakers,
            request.max_speakers,
        )
        merged = merge_transcription_with_speakers_improved(
            transcription["segments"], turns
        )
        readable = create_readable_transcript_improved(merged)
        gc.collect()

        elapsed = (datetime.now() - start_time).total_seconds()
        detected = len(
            {s["speaker"] for s in merged if s["speaker"] != "INCONNU"}
        )
        return TranscriptionResponse(
            success=True,
            model=WHISPER_MODEL_NAME,
            transcription_brute=transcription["text"],
            transcription_formatee=readable,
            segments_detailles=merged,
            parametres={
                "num_speakers_force": request.num_speakers,
                "min_speakers": request.min_speakers,
                "max_speakers": request.max_speakers,
                "language": request.language,
            },
            statistiques={
                "speakers_detectes": detected,
                "speakers_inconnus": len(
                    [s for s in merged if s["speaker"] == "INCONNU"]
                ),
                "duree_totale": (
                    f"{max(s['end'] for s in merged):.1f}s" if merged else "0s"
                ),
                "nombre_segments": len(merged),
                "confiance_moyenne": (
                    f"{sum(s['confidence'] for s in merged) / len(merged) * 100:.1f}%"
                    if merged
                    else "0%"
                ),
                "segments_lisses": len(
                    [s for s in merged if s.get("smoothed")]
                ),
                "language_detected": transcription.get(
                    "language", "unknown"
                ),
            },
            processing_time=elapsed,
        )
    except Exception as exc:
        logger.error("processing failed: %s", exc)
        logger.error(traceback.format_exc())
        gc.collect()
        elapsed = (datetime.now() - start_time).total_seconds()
        return TranscriptionResponse(
            success=False,
            model=WHISPER_MODEL_NAME,
            transcription_brute="",
            parametres={"error": True},
            statistiques={"processing_time": elapsed},
            processing_time=elapsed,
            error=f"Processing failed: {exc}",
        )


async def handler(job: Dict[str, Any]) -> Dict[str, Any]:
    """Job-dict entry point (contract: main.py:489-538)."""
    job_input = job.get("input", {})
    try:
        request = TranscriptionRequest.from_input(job_input)
        audio_path = await download_audio_file(str(request.audio_url))
        try:
            result = await process_transcription_optimized(
                audio_path, request
            )
        finally:
            try:
                os.unlink(audio_path)
            except OSError as exc:
                logger.warning("could not delete temp file: %s", exc)

        if result.error:
            return {
                "success": False,
                "error": result.error,
                "processing_time": result.processing_time,
            }
        return {
            "success": True,
            "model": result.model,
            "transcription_brute": result.transcription_brute,
            "transcription_formatee": result.transcription_formatee,
            "segments_detailles": result.segments_detailles,
            "parametres": result.parametres,
            "statistiques": result.statistiques,
            "processing_time": result.processing_time,
        }
    except Exception as exc:
        logger.error("handler error: %s", exc)
        return {"success": False, "error": f"Handler error: {exc}"}


def _ndjson(obj: Dict[str, Any]) -> bytes:
    return (json.dumps(obj, ensure_ascii=False) + "\n").encode()


async def ndjson_lines(
    chunks: AsyncIterable[bytes],
    fmt: str = "s16",
    language: Optional[str] = None,
    refresh: float = 1.0,
    agreement: int = 2,
) -> AsyncIterator[bytes]:
    """The stream's logic: raw 16 kHz mono PCM ``chunks`` (``fmt`` "s16",
    int16 little-endian, or "f32") in, NDJSON lines out — one per
    committed word as the LocalAgreement policy stabilizes it, then a
    final ``{"done": true, "text": ...}``. Decode refreshes run in an
    executor thread so the event loop keeps draining its input."""
    from ..engine.streaming import StreamingTranscriber

    itemsize = 2 if fmt == "s16" else 4
    engine = whisper_model.engine
    st = StreamingTranscriber(
        engine, language=language,
        min_refresh_s=refresh, agreement_n=agreement,
    )
    loop = asyncio.get_running_loop()

    def run(fn, *args):
        with on_device(engine.device):
            return fn(*args)

    def lines(words):
        return [
            _ndjson({"word": w.word, "start": round(w.start, 3),
                     "end": round(w.end, 3)})
            for w in words
        ]

    remainder = b""
    async for chunk in chunks:
        data = remainder + chunk
        usable = len(data) - len(data) % itemsize
        remainder = data[usable:]
        if not usable:
            continue
        if fmt == "s16":
            samples = (
                np.frombuffer(data[:usable], "<i2").astype(np.float32)
                / 32768.0
            )
        else:
            samples = np.frombuffer(data[:usable], "<f4").astype(
                np.float32
            )
        for line in lines(await loop.run_in_executor(None, run, st.push, samples)):
            yield line
    for line in lines(await loop.run_in_executor(None, run, st.flush)):
        yield line
    yield _ndjson({"done": True, "text": st.text})


async def stream_route(request):
    """POST /stream: live transcription over one HTTP exchange.

    The request body is a chunked stream of raw 16 kHz mono PCM
    (``?format=s16`` int16 little-endian, the default, or
    ``?format=f32``); the response streams ``ndjson_lines``' NDJSON.
    ``?refresh=<seconds>`` sets the minimum audio between decode
    refreshes (default 1.0; commit latency floors at
    ~agreement×refresh − chunk) and ``?agreement=<n>`` the
    LocalAgreement window (default 2; 1 commits every refresh's words
    immediately).
    """
    from aiohttp import web

    fmt = request.query.get("format", "s16")
    if fmt not in ("s16", "f32"):
        return web.json_response(
            {"error": f"unknown format {fmt!r} (use s16 or f32)"},
            status=400,
        )
    language = request.query.get("language")
    try:
        refresh = float(request.query.get("refresh", 1.0))
        agreement = int(request.query.get("agreement", 2))
        if refresh <= 0 or agreement < 1:
            raise ValueError
    except ValueError:
        return web.json_response(
            {"error": "refresh must be > 0 seconds, agreement >= 1"},
            status=400,
        )

    resp = web.StreamResponse(
        headers={"Content-Type": "application/x-ndjson"}
    )
    await resp.prepare(request)
    async for line in ndjson_lines(
        request.content.iter_chunked(65536), fmt, language, refresh, agreement
    ):
        await resp.write(line)
    await resp.write_eof()
    return resp


def serve(host: str = "0.0.0.0", port: int = 8000, device: str = "cuda") -> None:
    """Minimal HTTP job server: POST /run with ``{"input": {...}}``
    (the runpod.serverless.start stand-in, main.py:558), plus
    POST /stream for live NDJSON transcription and GET /health."""
    from aiohttp import web

    load_models(device=device)

    async def run_route(request: "web.Request") -> "web.Response":
        job = await request.json()
        result = await handler(job)
        return web.json_response(result)

    async def health(_request) -> "web.Response":
        return web.json_response(
            {"status": "ok", "model": WHISPER_MODEL_NAME}
        )

    app = web.Application()
    app.router.add_post("/run", run_route)
    app.router.add_post("/stream", stream_route)
    app.router.add_get("/health", health)
    web.run_app(app, host=host, port=port)


if __name__ == "__main__":
    serve()

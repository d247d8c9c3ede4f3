"""The port's serving layer against the JAX package's on the CPU.

Both packages' handlers, window schedulers and decodes run one seeded JAX
Whisper tree (converted array by array for the port) at the small dims of
``DIMS``, multilingual, at ``"default"`` (f32, the float cross-KV: the
tokens do not depend on which windows share a batch, so the port's
batches of 4 may be held against the JAX package's batches of 1), with
one vocabulary whose tokens are words (``chip_smoke.word_vocab``), so the
timestamped segments carry text to merge. Diarization is the handler's
``SpeakerDiarizationPipeline`` at the ``"general"`` preset over one small
TitaNet tree saved with the JAX package's ``save_params`` into the
``$WNT_MODEL_DIR`` both read. The audio is three voices whose Laplacian
has an eigengap above ``DIAR_GAP`` (asserted), where two eigensolvers'
labels agree. The download is stubbed with a local WAV, as the JAX
package's tests stub it.

JAX's timestamp rules are read as the port's (openai-whisper's) through
``tests/test_torch_sequential.py``'s autouse fixture: JAX's own force a
second timestamp after the first, so every segment the handler would
merge is empty (ROADMAP, queue 3). The JAX scheduler's and openai
facade's segments that end at or before their start (begun past their
window's audio) are dropped from their output, as the port drops them.

The JAX side runs once, in module fixtures, at one shape: its scheduler
decodes batches of 1, as its openai facade does, so its encoder and
decode compile once each for both paths. The float fields that come from
probabilities (a segment's ``confidence``, 1 − its no-speech probability,
and the scores) are held within ``PROB_TOL`` (responses by
``chip_smoke.same_response``, as phase 5g holds the card's); everything
else is equal.
"""

import asyncio
import importlib
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_nemo_tpu.diarize.pipeline as jax_pipeline
import whisper_nemo_tpu_torch.diarize.pipeline as pipeline
from chip_smoke import DIAR_GAP, same_response, voices, write_word_vocab
from test_torch_diarize_models import TITANET, _one_blas_thread, _seeded_tree  # noqa: F401
from test_torch_diarize_pipeline import PORT_TITANET
from test_torch_sequential import _jax_rules_over_generated_tokens  # noqa: F401  (autouse)
from test_torch_slice import _one_torch_thread, built_decoder, speechlike  # noqa: F401
from whisper_nemo_tpu.asr.openai_api import OpenAIWhisperModel as JaxOpenAI
from whisper_nemo_tpu.audio import write_wav
from whisper_nemo_tpu.diarize import SpeakerDiarizationPipeline as JaxDiarization
from whisper_nemo_tpu.engine.checkpoint import save_params
from whisper_nemo_tpu.engine.transcribe import WhisperEngine as JaxEngine
from whisper_nemo_tpu.models import titanet as jax_titanet
from whisper_nemo_tpu.models import whisper as jw
from whisper_nemo_tpu.ops.mel import log_mel_spectrogram_batch as jax_mel_batch
from whisper_nemo_tpu.serving import download as jax_download
from whisper_nemo_tpu.serving import schemas as jax_schemas
from whisper_nemo_tpu.serving.scheduler import WindowScheduler as JaxScheduler
from whisper_nemo_tpu.text.tokenizer import WhisperTokenizer as JaxTokenizer
from whisper_nemo_tpu_torch.asr.openai_api import OpenAIWhisperModel
from whisper_nemo_tpu_torch.diarize import SpeakerDiarizationPipeline
from whisper_nemo_tpu_torch.engine import precision
from whisper_nemo_tpu_torch.engine.checkpoint import params_from_jax
from whisper_nemo_tpu_torch.engine.transcribe import WhisperEngine
from whisper_nemo_tpu_torch.models.whisper import WhisperDims
from whisper_nemo_tpu_torch.ops.mel import log_mel_spectrogram_batch
from whisper_nemo_tpu_torch.serving import download, schemas
from whisper_nemo_tpu_torch.serving.scheduler import WindowScheduler
from whisper_nemo_tpu_torch.text.tokenizer import WhisperTokenizer

jax_handler = importlib.import_module("whisper_nemo_tpu.serving.handler")
port_handler = importlib.import_module("whisper_nemo_tpu_torch.serving.handler")

SR = 16000
# n_mels, n_audio_ctx, n_audio_state, n_audio_head, n_audio_layer, n_vocab,
# n_text_ctx, n_text_state, n_text_head, n_text_layer
DIMS = (80, 1500, 64, 4, 1, 51865, 48, 64, 4, 1)
MAX_NEW, MIN_NEW = 8, 2  # the serving schedulers' token limits
AUDIO_SECONDS, AUDIO_SEED = 40.0, 61
# f32 probabilities of two implementations (XLA's and torch's sums)
PROB_TOL = 1e-4
JOB = {"audio_url": "https://example.com/call.wav", "language": "en", "max_speakers": 3}


@pytest.fixture(scope="module")
def models(tmp_path_factory, built_decoder):  # noqa: F811
    """Both packages' engines, openai facades and diarization pipelines on
    the shared trees, and the job's WAV."""
    tmp = tmp_path_factory.mktemp("serving_models")
    save_params(str(tmp / "titanet_large.npz"),
                _seeded_tree(jax_titanet.init_titanet_params, TITANET, seed=21))
    write_word_vocab(str(tmp), multilingual=True)
    wav = tmp / "call.wav"
    write_wav(str(wav), voices(AUDIO_SECONDS, AUDIO_SEED, 3))
    jparams = jax.jit(jw.init_whisper_params, static_argnums=1)(jax.random.PRNGKey(3),
                                                                jw.WhisperDims(*DIMS))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WNT_MODEL_DIR", str(tmp))
        mp.delenv("WNT_MESH", raising=False)
        for name in ("WNT_SERVING_SCHEDULER", "WNT_SERVING_BUCKETS", "WNT_SERVING_BUCKET_POLICY"):
            mp.delenv(name, raising=False)
        mp.setattr(jax_pipeline, "_TITANET_LARGE", TITANET)
        mp.setattr(pipeline, "_TITANET_LARGE", PORT_TITANET)
        jax_engine = JaxEngine("tiny", params=jparams, dims=jw.WhisperDims(*DIMS),
                               tokenizer=JaxTokenizer.from_dir(str(tmp)), mesh=False)
        engine = WhisperEngine("tiny", "default", device="cpu", params=params_from_jax(jparams),
                               dims=WhisperDims(*DIMS), tokenizer=WhisperTokenizer.from_dir(str(tmp)))
        jax_model = _facade_without_inverted_segments(JaxOpenAI.__new__(JaxOpenAI))
        jax_model.engine, jax_model.name = jax_engine, "tiny"
        model = OpenAIWhisperModel.__new__(OpenAIWhisperModel)
        model.engine, model.name = engine, "tiny"
        yield {"jax": (jax_model, JaxDiarization()),
               "port": (model, SpeakerDiarizationPipeline(device="cpu")), "wav": str(wav)}


def _without_padding_segments(sched):
    """``sched`` (a JAX scheduler) dropping, as the port's does, each
    timestamped segment that starts at or past its window's audio (over
    the zero padding); the JAX scheduler clips its end to the window's,
    so such a segment ends at or before its start, and at exactly the
    window's end the handler's merge divides by a zero duration."""
    transcribe = sched.transcribe
    sched.dropped = 0

    def kept(audio, language="en"):
        every = transcribe(audio, language)
        segments = [s for s in every if s.end > s.start]
        sched.dropped += len(every) - len(segments)
        for i, s in enumerate(segments):
            s.id = i
        return segments

    sched.transcribe = kept
    return sched


def _facade_without_inverted_segments(model):
    """``model`` (the JAX openai facade) dropping, as the port's
    sequential path does, each segment that ends at or before its start
    (an open segment begun past its window's audio), its ids and text
    taken over the rest."""
    transcribe = model.transcribe

    def kept(*args, **kwargs):
        out = transcribe(*args, **kwargs)
        segments = [s for s in out["segments"] if s["end"] > s["start"]]
        for i, s in enumerate(segments):
            s["id"] = i
        return {**out, "segments": segments, "text": "".join(s["text"] for s in segments)}

    model.transcribe = kept
    return model


def _wire(mp, module, model, diarization, scheduler, wav):
    """``module``'s handler on these models, its download a copy of
    ``wav`` (the handler deletes what it downloads)."""
    import shutil

    async def fake_download(url):
        path = f"{wav}.{threading.get_ident()}.{time.monotonic_ns()}.wav"
        shutil.copy(wav, path)
        return path

    mp.setattr(module, "whisper_model", model)
    mp.setattr(module, "diarization_pipeline", diarization)
    mp.setattr(module, "window_scheduler", scheduler)
    mp.setattr(module, "download_audio_file", fake_download)
    mp.setattr(module, "WHISPER_MODEL_NAME", "tiny")


def _jobs(module, mp):
    """The job table's responses: a full job, transcription only, the
    openai facade (``WNT_SERVING_SCHEDULER=0``) and an invalid input."""
    out = {
        "full": asyncio.run(module.handler({"id": "1", "input": JOB})),
        "transcription_only": asyncio.run(module.handler(
            {"input": {**JOB, "transcription_only": True}})),
        "invalid": asyncio.run(module.handler({"input": {"audio_url": "not-a-url"}})),
    }
    mp.setenv("WNT_SERVING_SCHEDULER", "0")
    out["facade"] = asyncio.run(module.handler({"input": {**JOB, "transcription_only": True}}))
    mp.delenv("WNT_SERVING_SCHEDULER")
    return out


@pytest.fixture(scope="module")
def served(models):
    """Each package's job responses, its scheduler's segments on the job's
    audio, and the port diarizer's stats."""
    stats = {}
    waveform_call = pipeline.NeuralDiarizer.diarize_waveform

    def diarize_waveform(self, audio, **kw):
        return waveform_call(self, audio, stats=stats, **kw)

    out = {"stats": stats}
    from whisper_nemo_tpu_torch.audio import read_wav

    audio = read_wav(models["wav"])[0]
    for name, module, make in (("jax", jax_handler, JaxScheduler), ("port", port_handler,
                                                                     WindowScheduler)):
        model, diarization = models[name]
        sched = make(model.engine, batch_size=1, without_timestamps=False,
                     max_new_tokens=MAX_NEW, min_new_tokens=MIN_NEW)
        if make is JaxScheduler:
            _without_padding_segments(sched)
        try:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(pipeline.NeuralDiarizer, "diarize_waveform", diarize_waveform)
                _wire(mp, module, model, diarization, sched, models["wav"])
                out[name] = _jobs(module, mp)
                out[name]["segments"] = sched.transcribe(audio, "en")
                out[name]["dropped"] = getattr(sched, "dropped", 0)
        finally:
            sched.shutdown()
    return out


def test_handler_jobs_match_jax(served):
    """The full job (the scheduler, diarization, merge, smoothing,
    formatting), transcription only, and the openai facade's branch give
    the JAX handler's responses."""
    assert served["stats"]["path"] == "dense" and served["stats"]["eigengap"] > DIAR_GAP
    full = served["port"]["full"]
    assert full["success"] is True, full.get("error")
    assert len(full["segments_detailles"]) > 2 and full["statistiques"]["speakers_detectes"] > 1
    assert full["transcription_brute"].strip()
    json.dumps(full)
    for name in ("full", "transcription_only", "facade"):
        assert served["port"][name]["success"] is True, served["port"][name].get("error")
        same_response(served["port"][name], served["jax"][name], PROB_TOL)
    assert served["port"]["transcription_only"]["transcription_formatee"] is None


def test_invalid_input_is_a_handler_error(served):
    got, want = served["port"]["invalid"], served["jax"]["invalid"]
    assert got["success"] is want["success"] is False
    assert set(got) == set(want) == {"success", "error"}
    assert got["error"].startswith("Handler error: ") and want["error"].startswith("Handler error: ")
    assert "audio_url" in got["error"]


def test_scheduler_segments_match_jax(served):
    """Timestamped windows split into the same segments: times, seek,
    text and tokens equal, scores within PROB_TOL. The JAX segments that
    start past their window's audio (``_without_padding_segments``) are
    dropped; the audio has some, and the port keeps none."""
    got, want = served["port"]["segments"], served["jax"]["segments"]
    assert len(got) == len(want) > 2 and served["jax"]["dropped"] > 0
    assert all(s.end > s.start for s in got)
    for g, w in zip(got, want):
        assert (g.id, g.seek, g.start, g.end, g.text, g.tokens) == (
            w.id, w.seek, w.start, w.end, w.text, w.tokens)
        assert abs(g.avg_logprob - w.avg_logprob) < PROB_TOL
        assert abs(g.no_speech_prob - w.no_speech_prob) < PROB_TOL


@pytest.mark.parametrize("min_new, max_new", [(0, None), (MIN_NEW, MAX_NEW), (12, MAX_NEW)])
def test_token_limits_match_jax(models, min_new, max_new):
    """``_decode_batch`` on one window, timestamped, with EOT favoured by
    +10 in the suppress mask and every text token but five suppressed, so
    that EOT comes as early as the rules allow: JAX's tokens, length and
    score at each ``min_new_tokens``/``max_new_tokens`` (the first two are
    the openai facade's and the serving scheduler's, whose JAX decodes
    are already compiled). The first token is a timestamp, the second
    text or EOT: EOT at the second step without a minimum, else at the
    minimum, never past ``min(max_new or 224, n_text_ctx - n_prompt)``."""
    jax_engine, engine = models["jax"][0].engine, models["port"][0].engine
    eot, ts = engine.tokenizer.eot, engine.tokenizer.timestamp_begin
    mask = np.zeros(DIMS[5], np.float32)
    mask[:ts] = -np.inf
    mask[[1000, 1001, 1002, 1003, 1004]] = 0.0
    mask[eot] = 10.0
    waves = speechlike(30.0, 5)[None, : 30 * SR]
    jfeats = jax_engine.encode_windows(jax_mel_batch(jnp.asarray(waves), 80))
    want = jax_engine._decode_batch(jfeats, "en", mask, False, 0.0,
                                    min_new_tokens=min_new, max_new_tokens=max_new)
    feats = engine.encode_windows(log_mel_spectrogram_batch(torch.from_numpy(waves), 80))
    got = engine._decode_batch(feats, "en", torch.from_numpy(mask), False, 0.0,
                               min_new_tokens=min_new, max_new_tokens=max_new)
    assert len(got) == 6
    tokens, lengths, sum_lp, _, n_prompt, steps = got
    cap = min(max_new or 224, DIMS[6] - n_prompt)
    assert n_prompt == want[4]
    assert list(lengths.numpy()) == list(np.asarray(want[1])) == [min(max(min_new, 1), cap)]
    width = n_prompt + int(lengths[0]) + 1
    np.testing.assert_array_equal(tokens[:, :width].numpy(), np.asarray(want[0])[:, :width])
    assert tokens[0, n_prompt] >= ts and (tokens[0, n_prompt + 1] < ts or cap == 1)
    np.testing.assert_allclose(sum_lp.numpy(), np.asarray(want[2]), atol=10 * PROB_TOL)
    assert steps == int(lengths[0]) - (int(lengths[0]) == cap)


def test_schema_table_matches_jax():
    """The request table, accepted and rejected alike: the same fields
    where pydantic accepts, a ``ValueError`` where it raises."""
    table = [
        {"audio_url": "https://example.com/a.mp3"},
        {"audio_url": "http://example.com"},
        {"audio_url": "HTTPS://EXAMPLE.com/Path?q=1#f", "language": "auto"},
        {"audio_url": "http://localhost:8000/x.wav", "num_speakers": "2", "min_speakers": 2.0},
        {"audio_url": "https://example.com:443/a b.wav", "transcription_only": "yes"},
        {"audio_url": "http://[::1]:8000/a", "max_speakers": None, "extra": 1},
        {"audio_url": "https://bücher.de/ä.wav", "transcription_only": 1},
        {"audio_url": "not-a-url"},
        {"audio_url": "ftp://example.com/a.mp3"},
        {"audio_url": "http://"},
        {"audio_url": ""},
        {"audio_url": "example.com/a.mp3"},
        {"audio_url": "http://example.com:99999/a"},
        {"audio_url": 123},
        {"audio_url": "https://example.com/a", "language": "zz"},
        {"audio_url": "https://example.com/a", "language": None},
        {"audio_url": "https://example.com/a", "num_speakers": 2.5},
        {"audio_url": "https://example.com/a", "transcription_only": "maybe"},
        {"language": "en"},
    ]
    fields = ("audio_url", "language", "num_speakers", "min_speakers", "max_speakers",
              "transcription_only")
    accepted = 0
    for data in table:
        try:
            want = jax_schemas.TranscriptionRequest(**data)
        except Exception:
            with pytest.raises(ValueError):
                schemas.TranscriptionRequest.from_input(data)
            continue
        got = schemas.TranscriptionRequest.from_input(data)
        accepted += 1
        assert [getattr(got, f) for f in fields] == [
            str(want.audio_url), *(getattr(want, f) for f in fields[1:])], data
    assert accepted == 7
    assert schemas.VALID_LANGUAGES == jax_schemas.VALID_LANGUAGES
    response = schemas.TranscriptionResponse(
        success=True, model="m", transcription_brute="", parametres={}, statistiques={},
        processing_time=1.0)
    assert (response.transcription_formatee, response.segments_detailles, response.error) == (
        None, None, None)


def test_suffix_for_content_type_matches_jax():
    for ctype in ("audio/mpeg", "audio/MP3", "audio/mp4", "audio/x-m4a", "audio/ogg",
                  "audio/flac", "video/webm", "application/octet-stream", "", None):
        assert download.suffix_for_content_type(ctype) == jax_download.suffix_for_content_type(ctype)


class _Idle:
    """A worker thread that never starts."""

    def __init__(self, *args, **kwargs):
        pass

    def start(self):
        pass

    def join(self, timeout=None):
        pass


@pytest.mark.parametrize("env", [{}, {"WNT_SERVING_BUCKETS": "2,99"},
                                 {"WNT_SERVING_BUCKETS": "x,3"},
                                 {"WNT_SERVING_BUCKET_POLICY": "never"},
                                 {"WNT_SERVING_BUCKET_POLICY": "always"},
                                 {"WNT_SERVING_BUCKET_POLICY": "bogus"}])
def test_bucket_logic_matches_jax(models, monkeypatch, env):
    """Buckets, pad targets and the two-tier load detector, called on the
    same arguments in both packages, on one clock, with no worker thread
    draining the queue."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    clock = [100.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    idle = type("threading", (), {"Event": threading.Event, "Thread": _Idle})
    answers = []
    for make, model in ((JaxScheduler, models["jax"][0]), (WindowScheduler, models["port"][0])):
        monkeypatch.setattr(importlib.import_module(make.__module__), "threading", idle)
        seen = []
        for kw in ({"batch_size": 6}, {"batch_size": 8, "load_cooldown_s": 0.2},
                   {"batch_size": 6, "bucket_sizes": [6]}, {"batch_size": 5, "bucket_sizes": [3, 1]}):
            clock[0] = 100.0
            sched = make(model.engine, **kw)
            seen.append((sched.bucket_policy, sched._buckets(),
                         [sched._bucket_for(n) for n in range(1, 10)],
                         [sched._pad_target(n, loaded) for n in range(1, 9)
                          for loaded in (False, True)]))
            loads = []
            for step, n in ((0.0, 1), (0.0, 8), (0.1, 1), (0.15, 1), (1.0, 1), (3.0, 1)):
                clock[0] += step
                loads.append(sched._loaded(n_collected=n))
            sched._queue.put(object())
            loads.append(sched._loaded(n_collected=1))
            seen.append(loads)
        answers.append(seen)
    assert answers[0] == answers[1]


def test_concurrent_jobs_share_a_batch_over_http(models, served, monkeypatch):
    """Two transcription-only jobs posted together to /run over aiohttp's
    test server on loopback ride one decode batch of the port's scheduler
    (batch 4), and each response is the JAX handler's; /stream takes 3 s
    of s16 PCM in chunks and answers NDJSON words and a final line, as
    ``ndjson_lines`` does on the same chunks; a bad format is a clean
    400."""
    from aiohttp import web
    from aiohttp.test_utils import TestClient, TestServer

    model, diarization = models["port"]
    sched = WindowScheduler(model.engine, batch_size=4, max_wait_s=0.3, without_timestamps=False,
                            max_new_tokens=MAX_NEW, min_new_tokens=MIN_NEW)
    _wire(monkeypatch, port_handler, model, diarization, sched, models["wav"])
    batches = []
    process = sched._process

    def spy(items, **kw):
        batches.append(len(items))
        return process(items, **kw)

    monkeypatch.setattr(sched, "_process", spy)
    rng = np.random.default_rng(1)
    pcm = [(rng.standard_normal(SR) * 3000).astype("<i2").tobytes() for _ in range(3)]

    async def chunks():
        for c in pcm:
            yield c

    async def run():
        app = web.Application()

        async def run_route(request):
            return web.json_response(await port_handler.handler(await request.json()))

        app.router.add_post("/run", run_route)
        app.router.add_post("/stream", port_handler.stream_route)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            job = {"input": {**JOB, "transcription_only": True}}
            r1, r2 = await asyncio.gather(client.post("/run", json=job),
                                          client.post("/run", json=job))
            jobs = [await r1.json(), await r2.json()]
            stream = await client.post("/stream?language=en", data=chunks())
            assert stream.status == 200
            assert stream.headers["Content-Type"].startswith("application/x-ndjson")
            streamed = await stream.text()
            bad = await client.post("/stream?format=mp3", data=b"xx")
            assert bad.status == 400 and "unknown format" in (await bad.json())["error"]
        finally:
            await client.close()
        direct = b"".join([line async for line in port_handler.ndjson_lines(chunks(), "s16", "en")])
        return jobs, streamed, direct.decode()

    try:
        jobs, streamed, direct = asyncio.run(run())
    finally:
        sched.shutdown()
    assert max(batches) >= 2, f"the jobs never shared a batch: {batches}"
    for got in jobs:
        assert got["success"] is True, got.get("error")
        same_response(got, served["jax"]["transcription_only"], PROB_TOL)
    # the route reads the body as it arrives, so its refreshes (and words)
    # may fall elsewhere than the direct call's: both are held to the form
    for text in (streamed, direct):
        lines = [json.loads(line) for line in text.splitlines()]
        assert lines[-1]["done"] is True and "text" in lines[-1]
        for word in lines[:-1]:
            assert set(word) == {"word", "start", "end"} and word["end"] >= word["start"] >= 0


def test_load_models_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port_handler.load_models(warm=False)
    assert port_handler._devices("cpu") == (torch.device("cpu"), torch.device("cpu"))


def test_full_f32_across_threads():
    """Two threads, ordered by barriers, enter and leave ``full_f32`` in
    the order enter A, enter B, leave A, leave B: TF32 stays off while
    either is inside (A's exit must not turn it back on under B), and
    both flags are the caller's after the last exit."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    steps = [threading.Barrier(2) for _ in range(4)]
    seen = {}

    def flags():
        return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32

    def a():
        with precision.full_f32():
            steps[0].wait()  # A inside
            steps[1].wait()  # B inside
            seen["both inside"] = flags()
        steps[2].wait()  # A left
        steps[3].wait()  # B left

    def b():
        steps[0].wait()
        with precision.full_f32():
            steps[1].wait()
            steps[2].wait()
            seen["B alone inside"] = flags()
        steps[3].wait()

    try:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = True, False
        threads = [threading.Thread(target=f) for f in (a, b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert seen == {"both inside": (False, False), "B alone inside": (False, False)}
        assert flags() == (True, False)
        assert precision._inside == 0
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

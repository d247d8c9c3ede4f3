"""The port's batched ASR slice against the JAX package, and the port's
independence from JAX.

The slice runs the faster-whisper facade of both packages on one seeded
waveform with one JAX param tree (converted array by array), at int8
compute and tiny dims. The JAX engine runs as its own tests run it on the
CPU: greedy decode over the einsum form of the int8 cross-KV, which has
the same quantization as the port's decode layout.
"""

import fcntl
import functools
import pathlib
import re
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_nemo_tpu.asr import faster_whisper_api as jax_api
from whisper_nemo_tpu.engine.decode import build_suppress_mask
from whisper_nemo_tpu.models import whisper as jw
from whisper_nemo_tpu.models import whisper_stacked as jws
from whisper_nemo_tpu.ops.mel import log_mel_spectrogram_batch as jax_mel_batch
from whisper_nemo_tpu.text.tokenizer import WhisperTokenizer as JaxTokenizer
from whisper_nemo_tpu.text.tokenizer import get_suppressed_tokens
from whisper_nemo_tpu.vad.energy import get_speech_timestamps as jax_speech_timestamps
from whisper_nemo_tpu_torch.asr import BatchedInferencePipeline, WhisperModel
from whisper_nemo_tpu_torch.engine.checkpoint import params_from_jax
from whisper_nemo_tpu_torch.models.whisper import WhisperDims
from whisper_nemo_tpu_torch.text.tokenizer import WhisperTokenizer
from whisper_nemo_tpu_torch.vad.energy import DEVICE_ENERGY_FRAMES, get_speech_timestamps

REPO = pathlib.Path(__file__).resolve().parent.parent
SR = 16000
DIMS = (80, 1500, 64, 4, 1, 51864, 64, 64, 4, 2)
BATCH = 2
# The random init's logits are nearly flat (top-2 margins near 1e-3), so
# greedy picks meet near-ties; int8 decode-step logits agree to 0.02
# (test_torch_whisper.py), so a differing pick must be that close.
TIE_TOL = 0.02
# JAX's init compiled once, where it runs op by op (its dims static)
jax_init_whisper = jax.jit(jw.init_whisper_params, static_argnums=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's small ops: the suite runs six
    workers on the machine's cores, where threads waiting for each other
    slowed the port's modules a hundredfold; restored afterwards. The
    other port modules that run torch import it, which makes it theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def speechlike(seconds: float, seed: int) -> np.ndarray:
    """Seeded bursts of modulated noise (1.5-8 s) between quiet gaps."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    audio = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    t = int(rng.uniform(0.2, 1.0) * SR)
    while t < n:
        m = min(int(rng.uniform(1.5, 8.0) * SR), n - t)
        ph = np.arange(m) / SR
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 6) * ph)
        tone = np.sin(2 * np.pi * rng.uniform(120, 300) * ph)
        audio[t : t + m] += (0.2 * env * (tone + 0.5 * rng.standard_normal(m))).astype(np.float32)
        t += m + int(rng.uniform(0.3, 1.5) * SR)
    return audio


def _first_difference(a, b, eot):
    a, b = list(a) + [eot], list(b) + [eot]
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


@functools.partial(jax.jit, static_argnums=(3, 4))
def _jax_prefill_logits(stacked, feats, tokens, dims, n_prompt):
    """JAX's int8 teacher-forced prefill logits from row ``n_prompt - 1``
    on, in one compile rather than one per operation."""
    ckv = jws.quantize_cross_kv_stacked(jws.cross_attention_kv_stacked(stacked, feats, dims))
    cache = jws.init_stacked_cache(tokens.shape[0], dims, jnp.bfloat16, cache_len=128)
    x, _ = jws.prefill_cache_stacked(stacked, tokens, cache, ckv, dims, jnp.bfloat16)
    return jw._vocab_logits(stacked["decoder"], x[:, n_prompt - 1 :])


def _jax_forced_logits(engine, audio, windows, hyps):
    """JAX's filtered f32 logits ``[BATCH, n, V]`` of each window's
    hypothesis ``hyps[i]`` (generated tokens), teacher-forced through one
    prefill of the batch of ``windows`` (the int8 cross-KV scales are
    taken over the batch): row ``t`` predicts generated token ``t``."""
    waves = np.zeros((BATCH, 480000), np.float32)
    for i, (s, e) in enumerate(windows):
        n = min(e - s, 480000)
        waves[i, :n] = audio[s : s + n]
    feats = engine.encode_windows(jax_mel_batch(jnp.asarray(waves), 80)).astype(jnp.bfloat16)
    opts = engine._make_opts()
    prompt = engine.tokenizer.sot_sequence(None, without_timestamps=True)
    n = len(prompt) + max(len(h) for h in hyps)
    tokens = jnp.asarray([(prompt + list(h) + [opts.eot] * n)[:n] for h in hyps])
    logits = np.array(_jax_prefill_logits(engine._params_stacked, feats, tokens, engine.dims,
                                          len(prompt)), np.float32)
    logits += build_suppress_mask(engine.dims.n_vocab, get_suppressed_tokens(engine.tokenizer, (-1,)))
    logits[..., opts.timestamp_begin :] = -np.inf
    logits[..., opts.no_timestamps] = -np.inf
    logits[:, 0, [opts.blank_token, opts.eot]] = -np.inf
    return logits


def _jax_step_logits(engine, audio, windows, row, generated):
    """JAX's filtered f32 logits for window ``windows[row]`` after the
    teacher-forced ``generated`` tokens, over the batch the window was
    decoded in."""
    return _jax_forced_logits(engine, audio, windows, [generated] * BATCH)[row, -1]


def test_batched_pipeline_matches_jax():
    """~70 s of audio in batches of 2 (the last one partial): VAD windows
    and segment bounds equal exactly; greedy tokens equal, or at the
    first differing token JAX's top-2 logit margin, and its logit gap
    between the two picks, are below TIE_TOL; text equal where tokens are; no-speech probabilities (f32
    softmax at the SOT position) and mean log-probs close."""
    jparams = jax_init_whisper(jax.random.PRNGKey(2), jw.WhisperDims(*DIMS))
    audio = speechlike(70.0, 0)

    # the JAX facade builds its engine by name only: hand it one built on the tree
    jmodel = jax_api.WhisperModel.__new__(jax_api.WhisperModel)
    jmodel.engine = jax_api.WhisperEngine(
        "tiny.en", "int8", params=jparams, dims=jw.WhisperDims(*DIMS),
        tokenizer=JaxTokenizer.byte_fallback(multilingual=False), mesh=False,
    )
    want, want_info = jax_api.BatchedInferencePipeline(jmodel).transcribe(
        audio, language="en", batch_size=BATCH, beam_size=1
    )
    want = list(want)

    model = WhisperModel(
        "tiny.en", device="cpu", compute_type="int8", params=params_from_jax(jparams),
        dims=WhisperDims(*DIMS), tokenizer=WhisperTokenizer.byte_fallback(multilingual=False),
    )
    got, info = BatchedInferencePipeline(model).transcribe(
        audio, language="en", batch_size=BATCH, beam_size=1
    )
    got = list(got)

    assert len(got) == len(want) >= 3 and len(got) % BATCH, "want a partial last batch"
    assert [(s.start, s.end, s.seek) for s in got] == [(s.start, s.end, s.seek) for s in want]
    assert info.duration == want_info.duration
    assert info.duration_after_vad == want_info.duration_after_vad
    eot = model.engine.tokenizer.eot
    windows = [(int(round(s.start * SR)), int(round(s.end * SR))) for s in want]
    for idx, (g, w) in enumerate(zip(got, want)):
        assert abs(g.no_speech_prob - w.no_speech_prob) < 1e-3
        j = _first_difference(g.tokens, w.tokens, eot)
        if j is None:
            assert g.text == w.text
            assert abs(g.avg_logprob - w.avg_logprob) < 0.02
            continue
        first = idx - idx % BATCH
        batch = windows[first : first + BATCH]
        batch += [(0, 0)] * (BATCH - len(batch))
        logits = _jax_step_logits(jmodel.engine, audio, batch, idx % BATCH, w.tokens[:j])
        top2 = np.sort(logits)[-2:]
        gap = logits[(w.tokens + [eot])[j]] - logits[(g.tokens + [eot])[j]]
        assert max(top2[1] - top2[0], gap) < TIE_TOL, (idx, j, top2, gap)


@pytest.mark.parametrize("seconds", [70.0, 420.0])
def test_speech_timestamps_match_jax(seconds):
    """Energy VAD spans equal exactly: 70 s takes the host cumsum, 420 s
    (20,999 frames) the frame energies on the tensors' device."""
    audio = speechlike(seconds, 3)
    n_frames = (len(audio) - 640) // 320 + 1
    assert (n_frames > DEVICE_ENERGY_FRAMES) == (seconds > 400)
    assert get_speech_timestamps(audio, device="cpu") == jax_speech_timestamps(audio)


@pytest.fixture(scope="session")
def built_decoder():
    """Whether the port's libav decoder loads, built at most once here.
    ``make`` writes the library in place into the port's
    ``audio/native``; a lock in the temp directory keeps test workers
    from building it at once (one could load the other's half-written
    file). Every test whose decode may reach the library takes this
    fixture first."""
    import whisper_nemo_tpu_torch.audio.decode as port_decode

    with open(pathlib.Path(tempfile.gettempdir()) / "wnt_torch_audio_build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return port_decode.native_decoder_available()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@pytest.fixture
def no_libav(monkeypatch):
    """The port's audio decoder as on a host without libav (the card):
    its library does not load."""
    import whisper_nemo_tpu_torch.audio.decode as port_decode

    def unloadable():
        raise OSError("libavformat.so: cannot open shared object file")

    monkeypatch.setattr(port_decode, "_load_library", unloadable)


def test_facade_refuses_what_the_port_lacks(tmp_path, no_libav):
    """Device "auto" raises instead of picking a device. A path decodes
    through ``audio.decode_audio``: without libav (as on the card) a PCM
    WAV reads and a compressed format raises naming libav, on both
    facade calls."""
    import whisper_nemo_tpu_torch.audio.decode as port_decode
    from whisper_nemo_tpu_torch.asr.faster_whisper_api import _waveform
    from whisper_nemo_tpu_torch.audio import read_wav, write_wav

    model = WhisperModel(
        "tiny.en", device="cpu", compute_type="int8",
        params=params_from_jax(jax_init_whisper(jax.random.PRNGKey(0), jw.WhisperDims(*DIMS))),
        dims=WhisperDims(*DIMS), tokenizer=WhisperTokenizer.byte_fallback(multilingual=False),
    )
    pipeline = BatchedInferencePipeline(model)
    (tmp_path / "speech.opus").write_bytes(b"OggS")
    with pytest.raises(port_decode.AudioDecodeError, match="libav"):
        pipeline.transcribe(str(tmp_path / "speech.opus"), language="en")
    with pytest.raises(port_decode.AudioDecodeError, match="libav"):
        model.transcribe(tmp_path / "speech.opus")
    wave = speechlike(2.0, 0)
    write_wav(str(tmp_path / "speech.wav"), wave)
    assert np.array_equal(_waveform(tmp_path / "speech.wav"), read_wav(str(tmp_path / "speech.wav"))[0])
    with pytest.raises(ValueError, match="explicit"):
        WhisperModel("tiny.en", device="auto")


def test_port_imports_no_jax():
    """A fresh interpreter imports every module of the port and loads
    neither jax, the JAX package nor nltk (``post/punkt.py`` is the port's
    copy of the Punkt predicate it needs), nor pydantic or aiohttp, on
    which the port does not depend (the serving schemas are dataclasses;
    aiohttp is imported by the calls that need it)."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "whisper_nemo_tpu_torch").rglob("*.py")
    )
    assert {"whisper_nemo_tpu_torch.align.segmented", "whisper_nemo_tpu_torch.ops.ctc",
            "whisper_nemo_tpu_torch.models.wav2vec2", "whisper_nemo_tpu_torch.asr.openai_api",
            "whisper_nemo_tpu_torch.engine.streaming", "whisper_nemo_tpu_torch.diarize.pipeline",
            "whisper_nemo_tpu_torch.diarize.clustering", "whisper_nemo_tpu_torch.models.msdd",
            "whisper_nemo_tpu_torch.models.titanet", "whisper_nemo_tpu_torch.models.marblenet",
            "whisper_nemo_tpu_torch.models.conv_asr", "whisper_nemo_tpu_torch.ops.features",
            "whisper_nemo_tpu_torch.config", "whisper_nemo_tpu_torch.audio.wav",
            "whisper_nemo_tpu_torch.audio.decode", "whisper_nemo_tpu_torch.post.punkt",
            "whisper_nemo_tpu_torch.post.speaker_map", "whisper_nemo_tpu_torch.models.punctuation",
            "whisper_nemo_tpu_torch.cli.flow", "whisper_nemo_tpu_torch.cli.__main__",
            "whisper_nemo_tpu_torch.compat.helpers", "whisper_nemo_tpu_torch.utils.logging",
            "whisper_nemo_tpu_torch.serving.__init__", "whisper_nemo_tpu_torch.serving.scheduler",
            "whisper_nemo_tpu_torch.serving.handler", "whisper_nemo_tpu_torch.serving.schemas",
            "whisper_nemo_tpu_torch.serving.download", "whisper_nemo_tpu_torch.utils.monitor",
            "whisper_nemo_tpu_torch.utils.profiling", "whisper_nemo_tpu_torch.parallel.branch",
            "whisper_nemo_tpu_torch.cli.parallel", "whisper_nemo_tpu_torch.cli.nemo_process",
            "whisper_nemo_tpu_torch.models.pyannet", "whisper_nemo_tpu_torch.models.ecapa",
            "whisper_nemo_tpu_torch.models.htdemucs", "whisper_nemo_tpu_torch.ops.resample"
            } <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m.removesuffix('.__init__'))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'whisper_nemo_tpu', 'nltk',\n"
        "                                    'pydantic', 'aiohttp'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_name_no_jax():
    """No line of the port imports jax or the JAX package."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|whisper_nemo_tpu)\b", re.M)
    offenders = [
        str(p.relative_to(REPO))
        for p in (REPO / "whisper_nemo_tpu_torch").rglob("*.py")
        if pattern.search(p.read_text())
    ]
    assert offenders == []


@pytest.mark.parametrize("name", [
    "text/tokenizer.py", "text/languages.py", "vad/binarize.py", "align/text.py",
    "align/uroman.py", "align/uroman_ext.py", "align/pinyin_data.py", "config.py",
    "diarize/rttm.py", "diarize/segments.py", "diarize/metrics.py", "audio/wav.py",
    "audio/__init__.py", "audio/decode.py", "utils/__init__.py", "utils/cleanup.py",
    "utils/logging.py", "post/__init__.py", "post/punctuate.py", "post/writers.py",
    "post/merge.py", "compat/__init__.py", "compat/helpers.py",
])
def test_carried_copies_match_the_jax_package(name):
    """The jax-free host modules the port carries are the JAX package's,
    apart from the note that says they are copies and the local checkout
    path of a reference file a docstring names."""
    ours = (REPO / "whisper_nemo_tpu_torch" / name).read_text()
    theirs = re.sub(r"\n/\w+/reference/", "\nreference ",
                    (REPO / "whisper_nemo_tpu" / name).read_text())
    note = re.compile(r"\nA copy of ``whisper_nemo_tpu/[^`]+``, carried so that the\n"
                      r"port imports nothing of the JAX package\.\n\n")
    # a module with no docstring, or a one-line one, carries the note as a comment
    comment = re.compile(r"(?m)^# A copy of ``whisper_nemo_tpu/[^`]+``, carried so that the\n"
                         r"# port imports nothing of the JAX package\.\n")
    assert comment.sub("", note.sub("\n", ours, count=1), count=1) == theirs


@pytest.mark.parametrize("name", ["decoder.cc", "Makefile"])
def test_native_decoder_sources_are_byte_copies(name):
    """The libav decoder the port builds into its own audio/native."""
    native = pathlib.Path("audio") / "native" / name
    assert (REPO / "whisper_nemo_tpu_torch" / native).read_bytes() == (
        REPO / "whisper_nemo_tpu" / native).read_bytes()


def test_speaker_map_differs_only_in_its_nltk_lines():
    """The port's post/speaker_map.py is the JAX module's but for its copy
    note and the two lines that reached nltk: the import and the Punkt
    predicate, both now ``post/punkt.py``'s."""
    import difflib

    ours = (REPO / "whisper_nemo_tpu_torch/post/speaker_map.py").read_text().splitlines()
    theirs = (REPO / "whisper_nemo_tpu/post/speaker_map.py").read_text().splitlines()
    changed = [line for line in difflib.unified_diff(theirs, ours, lineterm="", n=0)
               if line[:1] in "+-" and not line.startswith(("+++", "---"))]
    assert [line for line in changed if line.startswith("-")] == [
        "-import nltk",
        "-    has_break = nltk.tokenize.PunktSentenceTokenizer().text_contains_sentbreak",
    ]
    assert [line for line in changed if line.startswith("+")] == [
        "+",
        "+A copy of ``whisper_nemo_tpu/post/speaker_map.py``, carried so that the",
        "+port imports nothing of the JAX package, and not nltk either: the",
        "+sentence-break predicate is ``post/punkt.py``'s copy of an untrained",
        "+Punkt tokenizer's.",
        "+from .punkt import text_contains_sentbreak",
        "+    has_break = text_contains_sentbreak",
    ]


def test_download_differs_only_in_its_lazy_aiohttp_import():
    """The port's serving/download.py is the JAX module's but for its copy
    note and its aiohttp import, which moved into the download call (with
    an ImportError naming aiohttp where it is absent), so that the module
    imports on a card without aiohttp."""
    import difflib

    ours = (REPO / "whisper_nemo_tpu_torch/serving/download.py").read_text().splitlines()
    theirs = (REPO / "whisper_nemo_tpu/serving/download.py").read_text().splitlines()
    changed = [line for line in difflib.unified_diff(theirs, ours, lineterm="", n=0)
               if line[:1] in "+-" and not line.startswith(("+++", "---"))]
    assert [line for line in changed if line.startswith("-")] == ["-", "-import aiohttp"]
    assert [line for line in changed if line.startswith("+")] == [
        "+",
        "+A copy of ``whisper_nemo_tpu/serving/download.py``, carried so that the",
        "+port imports nothing of the JAX package, but for its aiohttp import,",
        "+which moved into ``download_audio_file``: the module imports where",
        "+aiohttp is absent, and the call raises an ImportError naming it.",
        "+    try:",
        "+        import aiohttp",
        "+    except ImportError as exc:",
        '+        raise ImportError("downloading a job\'s audio needs aiohttp") from exc',
        "+",
    ]


def test_download_without_aiohttp_names_it(monkeypatch):
    """Where aiohttp cannot be imported, the download raises an ImportError
    that names it, which the handler turns into a failed job."""
    import asyncio
    import builtins

    from whisper_nemo_tpu_torch.serving.download import download_audio_file

    real_import = builtins.__import__

    def no_aiohttp(name, *args, **kwargs):
        if name == "aiohttp":
            raise ImportError("No module named 'aiohttp'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_aiohttp)
    with pytest.raises(ImportError, match="aiohttp"):
        asyncio.run(download_audio_file("https://example.com/a.wav"))

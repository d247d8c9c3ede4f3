"""The port's stage 1 and stage 7 modules against the JAX package, on the CPU.

In porting order: the audio decoder (a copy of the JAX package's, built
into the port's own directory); the untrained Punkt predicate of
``post/punkt.py`` against nltk's (the JAX package's ``post/speaker_map``
calls nltk; the port carries its own copy); the XLM-R punctuation model
with the JAX param tree converted by ``params_from_jax`` (logits in f32
within 1e-5, labels equal, scores within 1e-5); and the CLI flow's
surface: flags, compute widths, the device rule and what it refuses.
"""

import argparse
import pathlib
import shutil

import jax
import jax.numpy as jnp
import nltk
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import test_golden_outputs as golden
import whisper_nemo_tpu.audio.decode as jax_decode
import whisper_nemo_tpu.cli.flow as jax_flow
import whisper_nemo_tpu.models.punctuation as jax_punct
import whisper_nemo_tpu_torch.audio.decode as port_decode
import whisper_nemo_tpu_torch.cli.flow as flow
import whisper_nemo_tpu_torch.post.speaker_map as speaker_map
from test_torch_diarize_models import _one_blas_thread  # noqa: F401  (autouse)
from test_torch_slice import _one_torch_thread, built_decoder, no_libav  # noqa: F401  (autouse; fixtures)
from whisper_nemo_tpu_torch.audio import write_wav
from whisper_nemo_tpu_torch.engine.checkpoint import params_from_jax
from whisper_nemo_tpu_torch.models import punctuation
from whisper_nemo_tpu_torch.post import punkt

REPO = pathlib.Path(__file__).resolve().parent.parent
OPUS = REPO / "tests" / "assets" / "test.opus"
LOGITS_TOL = 1e-5  # f32 logits and softmax scores: products summed in another order


@pytest.fixture(scope="module")
def port_decoder(built_decoder):
    """The port's libav decoder, built once under ``built_decoder``'s
    lock."""
    if not built_decoder or not jax_decode.native_decoder_available():
        pytest.skip("the libav decoder does not build here")
    return port_decode


# -- stage 1: the audio decoder ----------------------------------------------


def test_decode_matches_jax_bit_for_bit(port_decoder):
    got = port_decoder.decode_audio(str(OPUS))
    want = jax_decode.decode_audio(str(OPUS))
    assert got.dtype == np.float32 and got.shape == want.shape and len(got) > 16000
    assert np.array_equal(got, want)
    assert port_decoder.probe_duration(str(OPUS)) == jax_decode.probe_duration(str(OPUS))


def test_decode_without_libav_reads_wav_only(no_libav, tmp_path):
    """A PCM WAV is read and resampled as the JAX package's fallback does;
    any other format raises naming libav."""
    wave = np.sin(np.arange(8000) * 0.05).astype(np.float32) * 0.5
    path = str(tmp_path / "tone.wav")
    write_wav(path, wave, sample_rate=8000)
    got = port_decode.decode_audio(path)
    assert len(got) == 16000
    np.testing.assert_array_equal(got, jax_decode._decode_wav_fallback(path, 16000))
    assert port_decode.probe_duration(path) == 1.0
    shutil.copy(OPUS, tmp_path / "call.opus")
    with pytest.raises(port_decode.AudioDecodeError, match="libav"):
        port_decode.decode_audio(str(tmp_path / "call.opus"))


# -- stage 7: sentence breaks --------------------------------------------------

_NLTK_BREAK = nltk.tokenize.PunktSentenceTokenizer().text_contains_sentbreak

HARD_CASES = [
    "", " ", "Hello", "Hello.", "Hello. ", "Hello. World", "Hello. world", "hello.\nWorld",
    "J. Smith said so", "J. smith", "said J. Smith.", "the U.S.A. is big", "the U.S.A. Is",
    "it is 3.5. Next", "it is 3.5. next", "3.5.", "1. 2. 3.", "-3. Then", "wait... What",
    "wait... what", "...", "... and", "really?! Yes", "really?!", "Why? Because", "why ? no",
    'He said "Stop." Then', "He said (stop.) Then", "a [b.] C", "x.) y", "end. \"Quote\"",
    "Mr. Brown", "e.g. this", "done.\n\nNew para", "A. B. C.", "a.b.c. D", "Yes! no", "Oh. ",
    "one, two. Three, four.", "É. Élan", "fin. été", "x -- y. Z", "x--y. z", "'Tis. So",
]


def test_punkt_matches_nltk_on_hard_cases():
    assert nltk.__version__ == "3.10.0"
    for text in HARD_CASES:
        assert punkt.text_contains_sentbreak(text) == _NLTK_BREAK(text), text


def test_punkt_matches_nltk_on_the_golden_stream(monkeypatch):
    """Every text the sentence grouping tests on the golden conversation
    of ``tests/test_golden_outputs.py``; the sentences equal the JAX
    package's (``_pipeline_tail``)."""
    seen = []

    def recording(text):
        seen.append(text)
        return punkt.text_contains_sentbreak(text)

    monkeypatch.setattr(speaker_map, "text_contains_sentbreak", recording)
    wsm = speaker_map.get_words_speaker_mapping(golden.WORDS, golden.TURNS, "start")
    wsm = speaker_map.get_realigned_ws_mapping_with_punctuation(wsm)
    got = speaker_map.get_sentences_speaker_mapping(wsm, golden.TURNS)
    assert len(seen) == len(golden.WORDS) - 2  # a speaker change skips the predicate
    assert [_NLTK_BREAK(t) for t in seen] == [punkt.text_contains_sentbreak(t) for t in seen]
    assert got == golden._pipeline_tail()


PIECES = ["J.", "Smith", "U.S.A.", "3.5.", "42", "-7.", "...", "..", "?!", "?", "!", ".", ",",
          "hello", "World.", "end.", "a.", "B.", "Mr.", "e.g.", '"', "'", "(", ")", "[", "]",
          "--", "-", ";", ":", "é.", "É", "x", "Yes", "no!", "why?"]


@settings(max_examples=400, deadline=None, derandomize=True, database=None)
@given(st.lists(st.tuples(st.sampled_from(PIECES), st.sampled_from([" ", "", "  ", "\n"])),
                max_size=10))
def test_punkt_matches_nltk_on_generated_texts(parts):
    text = "".join(p + sep for p, sep in parts)
    assert punkt.text_contains_sentbreak(text) == _NLTK_BREAK(text)


# -- stage 7: the punctuation model --------------------------------------------

SMALL = jax_punct.XlmRobertaDims(**vars(punctuation.SMALL_DIMS))


@pytest.fixture(scope="module")
def punct_models(tmp_path_factory):
    """The JAX model (its random init at the small dims) and the port's,
    given the JAX tree through ``params_from_jax``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WNT_MODEL_DIR", str(tmp_path_factory.mktemp("no_punct_ckpt")))
        mp.setenv("WNT_TEST_SMALL_MODELS", "1")
        jm = jax_punct.PunctuationModel()
        pm = punctuation.PunctuationModel(device="cpu")
    assert jm.dims == SMALL and pm.dims == punctuation.SMALL_DIMS
    pm.params = params_from_jax(jax.device_get(jm.params))
    return jm, pm


def test_token_classifier_logits_match_jax(punct_models):
    """Three rows: full, a masked tail, and a padded row with no token."""
    jm, pm = punct_models
    rng = np.random.default_rng(0)
    ids = rng.integers(10, SMALL.vocab_size, (3, 40)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 23:] = 0
    mask[2, :] = 0
    ids[mask == 0] = 0
    want = np.asarray(jax.jit(lambda p, i, m: jax_punct.token_classifier_logits(p, i, m, SMALL))(
        jm.params, jnp.asarray(ids), jnp.asarray(mask)))
    got = punctuation.token_classifier_logits(
        pm.params, torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask.astype(np.int64)),
        pm.dims)
    assert got.dtype == torch.float32 and got.shape == (3, 40, 6)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGITS_TOL, rtol=0)


@pytest.mark.parametrize("n_words", [1, 230, 700])
def test_predict_matches_jax(punct_models, n_words):
    """One chunk, a full chunk, and four overlapping chunks (the edge rule)."""
    jm, pm = punct_models
    rng = np.random.default_rng(n_words)
    vocab = [f"w{i}" for i in range(300)]
    words = [vocab[i] for i in rng.integers(0, len(vocab), n_words)]
    want = jm.predict(words, chunk_size=230)
    got = pm.predict(words, chunk_size=230)
    assert [(w, lab) for w, lab, _ in got] == [(w, lab) for w, lab, _ in want]
    np.testing.assert_allclose([s for *_, s in got], [s for *_, s in want], atol=LOGITS_TOL, rtol=0)
    assert len({lab for _, lab, _ in got}) > 1 or n_words == 1


# -- the CLI flow's surface ---------------------------------------------------


def _surface(parser):
    return [(a.option_strings, a.dest, a.default, a.choices, a.required, a.type, type(a), a.nargs,
             a.const) for a in parser._actions]


@pytest.mark.parametrize("parallel", [False, True])
def test_arg_parser_matches_jax(parallel):
    """Option strings, dests, defaults, choices and actions equal; the help
    texts too, but for ``--device``'s."""
    ours, theirs = flow.build_arg_parser(parallel), jax_flow.build_arg_parser(parallel)
    assert _surface(ours) == _surface(theirs)
    helps = [(a.dest, a.help) for a in ours._actions]
    assert [h for h in helps if h[0] != "device"] == [
        (a.dest, a.help) for a in theirs._actions if a.dest != "device"]
    argv = ["-a", "x.wav", "--no-stem", "--batch-size", "0", "--language", "en", "--device", "cpu",
            "--domain", "meeting", "--num-speakers", "3"]
    assert ours.parse_args(argv) == theirs.parse_args(argv)
    assert flow.mtypes == jax_flow.mtypes


def _args(**kw):
    base = dict(audio="x.wav", stemming=False, suppress_numerals=False, model_name="tiny.en",
                batch_size=2, language="en", device="cpu", domain="telephonic", mesh=None,
                num_speakers=None, max_speakers=None)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("device", ["auto", "cuda", "cuda:1"])
def test_gpu_devices_refuse_without_cuda(monkeypatch, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        flow.run_sequential(_args(device=device))
    assert flow.resolve_device("cpu") == "cpu"
    with pytest.raises(ValueError, match="auto, cuda"):
        flow.resolve_device("tpu")


def test_what_the_flow_does_not_port_is_refused(monkeypatch, tmp_path):
    """A mesh (flag or WNT_MESH) names item 6b, in both flows, before any
    stage runs: the parallel flow itself runs (tests/test_torch_flow.py).
    Stemming without htdemucs.npz warns and keeps the original audio, as
    the JAX flow does; with an unreadable one it raises, where the JAX flow
    would keep the original audio on any error (the separator itself runs
    in tests/test_torch_separation.py and tests/test_torch_flow.py)."""
    monkeypatch.delenv("WNT_MESH", raising=False)
    for run in (flow.run_sequential, flow.run_parallel):
        with pytest.raises(NotImplementedError, match="item 6b"):
            run(_args(mesh="dp=2"))
    monkeypatch.setenv("WNT_MESH", "dp")
    for run in (flow.run_sequential, flow.run_parallel):
        with pytest.raises(NotImplementedError, match="item 6b"):
            run(_args())
    monkeypatch.setenv("WNT_MODEL_DIR", str(tmp_path))
    temp = str(tmp_path / "temp_outputs")
    assert flow.maybe_separate_vocals("a.wav", True, "cpu", temp) == "a.wav"
    assert flow.maybe_separate_vocals("a.wav", False, "cpu", temp) == "a.wav"
    (tmp_path / "htdemucs.npz").write_bytes(b"")
    with pytest.raises(EOFError):
        flow.maybe_separate_vocals("a.wav", True, "cpu", temp)
    assert flow.maybe_separate_vocals("a.wav", False, "cpu", temp) == "a.wav"


def test_punctuation_falls_back_only_when_the_model_cannot_be_read(monkeypatch, tmp_path):
    """An unreadable checkpoint keeps the original punctuation, as in the
    JAX flow; a fault while the model runs raises (the JAX flow would
    swallow it) and another language skips the model."""
    monkeypatch.setenv("WNT_MODEL_DIR", str(tmp_path))
    wsm = [{"word": "hello", "start_time": 0, "end_time": 1, "speaker": 0}]
    (tmp_path / "kredor_punctuate-all.npz").write_bytes(b"junk")
    assert flow.maybe_restore_punctuation([dict(w) for w in wsm], "en", "cpu") == wsm
    (tmp_path / "kredor_punctuate-all.npz").unlink()

    def fault(*_):
        raise RuntimeError("device fault")

    monkeypatch.setattr(punctuation, "token_classifier_logits", fault)
    with pytest.raises(RuntimeError, match="device fault"):
        flow.maybe_restore_punctuation([dict(w) for w in wsm], "en", "cpu")
    assert flow.maybe_restore_punctuation([dict(w) for w in wsm], "xx", "cpu") == wsm


def test_writers_keep_the_bom_and_the_golden_bytes(tmp_path):
    """write_outputs: txt and SRT beside the input, UTF-8 with a BOM, the
    golden conversation's bytes."""
    ssm = golden._pipeline_tail()
    flow.write_outputs(ssm, str(tmp_path / "call.opus"))
    assert (tmp_path / "call.srt").read_bytes() == b"\xef\xbb\xbf" + golden.GOLDEN_SRT.encode()
    assert (tmp_path / "call.txt").read_bytes() == b"\xef\xbb\xbf" + golden.GOLDEN_TXT.encode()

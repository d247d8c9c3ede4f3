"""The port's compute widths against the JAX package's, on the CPU.

The JAX package's engine runs "default" and "float32" as f32 with f32
weights and a float cross-attention KV (XLA einsums), and "float16" and
"bfloat16" as bf16 weights with the int8 cross-KV; "default" is the
width of its facades and of the CLI's ``--device auto``. Both packages
run here on one JAX param tree, converted array by array, at tiny
English-only dims whose ``n_text_ctx`` of 160 leaves room for the
conditioning block of the sequential path.

Tolerances: f32 on both sides differs only in the order of f32 sums, so
greedy picks may differ only where JAX's top-2 logits lie within
F32_TIE_TOL, and a beam hypothesis rescored by JAX keeps its mean
log-probability per token within F32_SCORE_TOL (JAX's best within
F32_TIE_TOL of it). At "float16" the bounds are those of the int8 tests
(tests/test_torch_slice.py, tests/test_torch_beam.py): bf16 products
round differently in the two frameworks.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sequential import (  # noqa: F401  (autouse: JAX's rules over generated tokens)
    _check_window, _jax_rules_over_generated_tokens, _replay, _vad_wave,
)
from test_torch_slice import (  # noqa: F401  (_one_torch_thread: autouse)
    SR, TIE_TOL, _first_difference, _one_torch_thread, speechlike,
)
from whisper_nemo_tpu.asr import faster_whisper_api as jax_api
from whisper_nemo_tpu.asr import openai_api as jax_openai
from whisper_nemo_tpu.engine.decode import build_suppress_mask
from whisper_nemo_tpu.models import whisper as jw
from whisper_nemo_tpu.models import whisper_stacked as jws
from whisper_nemo_tpu.ops import attention as ja
from whisper_nemo_tpu.ops.mel import log_mel_spectrogram_batch as jax_mel_batch
from whisper_nemo_tpu.text.tokenizer import WhisperTokenizer as JaxTokenizer
from whisper_nemo_tpu.text.tokenizer import get_suppressed_tokens
from whisper_nemo_tpu_torch.asr import BatchedInferencePipeline, WhisperModel, load_model
from whisper_nemo_tpu_torch.asr import openai_api
from whisper_nemo_tpu_torch.engine.checkpoint import params_from_jax
from whisper_nemo_tpu_torch.engine.transcribe import WhisperEngine
from whisper_nemo_tpu_torch.models import whisper as tw
from whisper_nemo_tpu_torch.models import whisper_stacked as tws
from whisper_nemo_tpu_torch.ops import attention as ta
from whisper_nemo_tpu_torch.text.tokenizer import WhisperTokenizer

DIMS = (80, 1500, 64, 4, 1, 51864, 160, 64, 4, 1)  # English-only: no detection runs
BATCH = 2
F32_TIE_TOL = 1e-3
F32_SCORE_TOL = 1e-4
INT8_SCORE_TOL, INT8_BEAM_TIE_TOL = 2e-3, 0.02  # tests/test_torch_beam.py's
BOUNDS = {  # width: (greedy tie, beam score, beam tie)
    "default": (F32_TIE_TOL, F32_SCORE_TOL, F32_TIE_TOL),
    "float16": (TIE_TOL, INT8_SCORE_TOL, INT8_BEAM_TIE_TOL),
}


@pytest.fixture(scope="module")
def jparams():
    init = jax.jit(jw.init_whisper_params, static_argnums=1)  # one compile, not one per op
    return init(jax.random.PRNGKey(3), jw.WhisperDims(*DIMS))


@pytest.fixture(scope="module")
def jax_engines(jparams):
    """``jax_engines(width)``: one JAX engine per width, shared by the
    module's tests, so that each engine's encoder compiles once."""
    engines = {}

    def get(width):
        if width not in engines:
            engines[width] = jax_api.WhisperEngine(
                "tiny.en", width, params=jparams, dims=jw.WhisperDims(*DIMS),
                tokenizer=JaxTokenizer.byte_fallback(multilingual=False), mesh=False)
        return engines[width]

    return get


def _port_model(jparams, width):
    return WhisperModel("tiny.en", device="cpu", compute_type=width,
                        params=params_from_jax(jparams), dims=tw.WhisperDims(*DIMS),
                        tokenizer=WhisperTokenizer.byte_fallback(multilingual=False))


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6))
def _jax_prefill_logits(stacked, feats, tokens, dims, dtype, kv_int8, n_prompt):
    """JAX's logits of a teacher-forced prefill of ``tokens`` from row
    ``n_prompt - 1`` on, at the engine's width, in one compile rather
    than one per operation and shape."""
    ckv = jws.cross_attention_kv_stacked(stacked, feats, dims)
    if kv_int8:
        ckv = jws.quantize_cross_kv_stacked(ckv)
    cache = jws.init_stacked_cache(tokens.shape[0], dims, dtype, cache_len=256)
    x, _ = jws.prefill_cache_stacked(stacked, tokens, cache, ckv, dims, dtype)
    return jw._vocab_logits(stacked["decoder"], x[:, n_prompt - 1 :])


def _jax_forced_logits(jeng, audio, windows, hyps):
    """JAX's filtered f32 logits ``[BATCH, n, V]`` of each window's
    hypothesis ``hyps[i]`` (generated tokens), teacher-forced through one
    prefill of the batch at the engine's width: row ``t`` predicts
    generated token ``t``."""
    waves = np.zeros((BATCH, 480000), np.float32)
    for i, (s, e) in enumerate(windows):
        n = min(e - s, 480000)
        waves[i, :n] = audio[s : s + n]
    feats = jeng.encode_windows(jax_mel_batch(jnp.asarray(waves), 80)).astype(jeng.dtype)
    opts = jeng._make_opts()
    prompt = jeng.tokenizer.sot_sequence(None, without_timestamps=True)
    n = len(prompt) + max(len(h) for h in hyps)
    tokens = jnp.asarray([(prompt + list(h) + [opts.eot] * n)[:n] for h in hyps])
    logits = np.array(_jax_prefill_logits(jeng._params_stacked, feats, tokens, jeng.dims,
                                          jeng.dtype, jeng.kv_int8, len(prompt)), np.float32)
    logits += build_suppress_mask(jeng.dims.n_vocab, get_suppressed_tokens(jeng.tokenizer, (-1,)))
    logits[..., opts.timestamp_begin :] = -np.inf
    logits[..., opts.no_timestamps] = -np.inf
    logits[:, 0, [opts.blank_token, opts.eot]] = -np.inf
    return logits


@pytest.mark.parametrize("mode", ["greedy", "beam5"])
@pytest.mark.parametrize("width", ["default", "float16"])
def test_batched_widths_match_jax(jparams, jax_engines, width, mode):
    """The batched facade at the JAX package's widths, one batch of two
    windows: the engines' widths agree (f32 weights and a float cross-KV
    at "default"; weights stored in bf16 and the int8 cross-KV at
    "float16"); segment bounds equal; tokens equal, or (greedy) at the
    first differing token JAX's top-2 margin and its gap between the two
    picks within the width's tie bound, or (beam 5) the port's hypothesis
    rescored by JAX within the width's score bound per token and JAX's
    best within its tie bound of it."""
    jeng, model = jax_engines(width), _port_model(jparams, width)
    teng = model.engine
    assert (teng.dtype == torch.float32) == (jeng.dtype == jnp.float32)
    assert jeng.kv_int8 == (width == "float16")
    assert teng.cross_kv_bits == (8 if jeng.kv_int8 else None)
    w_q = teng.params["decoder"]["layers"][0]["attn"]["q"]["w"]
    assert w_q.dtype == (torch.bfloat16 if width == "float16" else torch.float32)
    beam = 5 if mode == "beam5" else 1
    audio = speechlike(35.0, 5)
    jmodel = jax_api.WhisperModel.__new__(jax_api.WhisperModel)
    jmodel.engine = jeng
    want, _ = jax_api.BatchedInferencePipeline(jmodel).transcribe(
        audio, language="en", batch_size=BATCH, beam_size=beam)
    want = list(want)
    got, _ = BatchedInferencePipeline(model).transcribe(
        audio, language="en", batch_size=BATCH, beam_size=beam)
    got = list(got)
    assert len(got) == len(want) == BATCH, "want one full batch"
    assert [(s.start, s.end) for s in got] == [(s.start, s.end) for s in want]
    tie_tol, score_tol, beam_tie_tol = BOUNDS[width]
    eot = teng.tokenizer.eot
    windows = [(int(round(s.start * SR)), int(round(s.end * SR))) for s in want]
    if beam > 1:
        hyps = [list(s.tokens) for s in got]
        logprobs = np.asarray(jax.nn.log_softmax(
            jnp.asarray(_jax_forced_logits(jeng, audio, windows, hyps)), axis=-1))
        max_new = teng.dims.n_text_ctx - 3
    for row, (g, w) in enumerate(zip(got, want)):
        assert abs(g.no_speech_prob - w.no_speech_prob) < 1e-3
        j = _first_difference(g.tokens, w.tokens, eot)
        if j is None:
            assert g.text == w.text
        if beam > 1:
            target = list(g.tokens) + ([eot] if len(g.tokens) < max_new else [])
            r = float(logprobs[row, np.arange(len(target)), target].sum()) / (len(g.tokens) + 1)
            assert abs(g.avg_logprob - r) < score_tol, (row, g.avg_logprob, r)
            assert r > w.avg_logprob - beam_tie_tol, (row, r, w.avg_logprob)
        elif j is not None:
            logits = _jax_forced_logits(jeng, audio, windows, [list(w.tokens[:j])] * BATCH)
            logits = logits[row, -1]
            top2 = np.sort(logits)[-2:]
            gap = logits[(w.tokens + [eot])[j]] - logits[(g.tokens + [eot])[j]]
            assert max(top2[1] - top2[0], gap) < tie_tol, (row, j, top2, gap)


def test_sequential_float32_matches_jax(jparams, jax_engines):
    """The sequential facade at "float32" (the JAX package's alias of
    "default"): ``WhisperModel.transcribe(audio, "en", vad_filter=True)``
    at beam 5, temperature 0, timestamps and conditioning on the previous
    text, on 40 s of speech-like audio; two or more windows, the second
    conditioned. Each window is replayed by JAX's engine at "default" at
    the port's seek with the port's conditioning tail, and meets the
    window rule of tests/test_torch_sequential.py (tokens equal, or the
    port's hypothesis rescored by JAX at f32)."""
    jeng, model = jax_engines("default"), _port_model(jparams, "float32")
    teng = model.engine
    assert teng.dtype == torch.float32 and teng.cross_kv_bits is None
    audio = speechlike(40.0, 0)
    segs, info = model.transcribe(audio, "en", vad_filter=True, temperature=(0.0,))
    list(segs)
    windows = teng.last_windows
    assert len(windows) >= 2 and windows[1]["previous"], "the second window is conditioned"
    wave, _ = _vad_wave(audio)
    equal = sum(_check_window(jeng, replayed, 5) for replayed in _replay(jeng, teng, wave, 5, "en"))
    assert equal >= 1, "no window decoded JAX's tokens"


@pytest.fixture(scope="module")
def small_trees(jparams):
    """The f32 tree in both packages' stacked forms."""
    return jws.stack_decoder_blocks(jparams), tws.stack_decoder_blocks(params_from_jax(jparams))


# JAX's prefill and decode step compiled once each (their dims, dtype and
# cache shapes static), where the engine runs them op by op
_jax_prefill = jax.jit(jws.prefill_cache_stacked, static_argnums=(4, 5))
_jax_step = jax.jit(jws.decode_step_stacked, static_argnums=(5, 6))


def test_float_cross_kv_prefill_and_step_match_jax(small_trees):
    """The float cross-KV (the f32 widths) against JAX's float branch at
    f32: the projections (the port keeps K times D^-¼ and both
    transposed), a prefill over a left-padded prompt (``kv_valid``,
    ``pos_offset``), then one greedy step and one beam step from that
    cache, the beam's three lanes sharing their window's cross-KV where
    JAX repeats it. 1e-5 absolute on values of order 1 (f32 sums in
    another order)."""
    jstacked, tstacked = small_trees
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((2, 1500, 64)).astype(np.float32)
    jckv = jws.cross_attention_kv_stacked(jstacked, jnp.asarray(feats), jw.WhisperDims(*DIMS))
    tckv = tws.cross_kv_float(tstacked, torch.from_numpy(feats), tw.WhisperDims(*DIMS))
    np.testing.assert_allclose(tckv["k"].permute(0, 1, 4, 2, 3).numpy(),
                               np.asarray(jckv["k"]) * 16**-0.25, atol=1e-5)
    np.testing.assert_allclose(tckv["v"].transpose(2, 3).numpy(), np.asarray(jckv["v"]),
                               atol=1e-5)

    prompt = np.array([[50256, 50256, 50360, 7, 50257, 50362],
                       [50256, 50360, 9, 11, 50257, 50362]], np.int32)
    valid = prompt != 50256
    kv_valid = np.concatenate([valid, np.ones((2, 128 - 6), bool)], axis=1)
    pos_offset = (~valid).sum(axis=1).astype(np.int32)
    jcache = jws.init_stacked_cache(2, jw.WhisperDims(*DIMS), jnp.float32, cache_len=128)
    jx, jcache = _jax_prefill(
        jstacked, jnp.asarray(prompt), jcache, jckv, jw.WhisperDims(*DIMS), jnp.float32,
        kv_valid=jnp.asarray(kv_valid), pos_offset=jnp.asarray(pos_offset))
    tcache = tws.init_stacked_cache(2, tw.WhisperDims(*DIMS), torch.float32, 128, "cpu")
    tx, tcache = tws.prefill_cache_stacked(
        tstacked, torch.from_numpy(prompt).long(), tcache, tckv, tw.WhisperDims(*DIMS),
        torch.float32, kv_valid=torch.from_numpy(kv_valid), pos_offset=torch.from_numpy(pos_offset))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), atol=1e-5)

    token = np.array([100, 7000], np.int32)
    want, _ = _jax_step(
        jstacked, jnp.asarray(token), jnp.int32(6), jcache, jckv, jw.WhisperDims(*DIMS),
        jnp.float32, kv_valid=jnp.asarray(kv_valid), pos_offset=jnp.asarray(pos_offset))
    got, _ = tws.decode_step_stacked(
        tstacked, torch.from_numpy(token).long(), 6,
        {name: c.clone() for name, c in tcache.items()}, tckv, tw.WhisperDims(*DIMS),
        torch.float32, kv_valid=torch.from_numpy(kv_valid), pos_offset=torch.from_numpy(pos_offset))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    beam = 3
    anc = rng.integers(0, beam, (2, beam, 128)).astype(np.int32)
    anc[:, :, 6] = np.arange(beam)
    btoken = np.array([100, 5, 9, 7000, 3, 40], np.int32)
    jbcache = {n: jnp.repeat(c, beam, axis=1) for n, c in jcache.items()}
    jbckv = {n: jnp.repeat(c, beam, axis=1) for n, c in jckv.items()}
    rep = np.repeat
    want, _ = _jax_step(
        jstacked, jnp.asarray(btoken), jnp.int32(6), jbcache, jbckv, jw.WhisperDims(*DIMS),
        jnp.float32, anc=jnp.asarray(anc), kv_valid=jnp.asarray(rep(kv_valid, beam, axis=0)),
        pos_offset=jnp.asarray(rep(pos_offset, beam)))
    tbcache = {n: c.repeat_interleave(beam, dim=1) for n, c in tcache.items()}
    got, _ = tws.decode_step_stacked(
        tstacked, torch.from_numpy(btoken).long(), 6, tbcache, tckv, tw.WhisperDims(*DIMS),
        torch.float32, anc=torch.from_numpy(anc),
        kv_valid=torch.from_numpy(rep(kv_valid, beam, axis=0)),
        pos_offset=torch.from_numpy(rep(pos_offset, beam)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_attention_kt_ancestry_f32_matches_jax():
    """Kernel E's plain version at f32 (the cache of the f32 widths)
    against JAX's ``attention_kt_ancestry`` at f32, as the JAX beam step
    calls it: q, the weights and the output stay f32; 1e-6 absolute on
    outputs of order 1."""
    rng = np.random.default_rng(7)
    b, kk, h, d, s = 2, 5, 2, 64, 40
    q = rng.standard_normal((b * kk, 1, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b * kk, h, d, s)).astype(np.float32) for _ in range(2))
    anc = rng.integers(0, kk, (b, kk, s)).astype(np.int32)
    mask = np.where(np.arange(s) < 33, 0.0, -np.inf).astype(np.float32)[None, None, None]
    want = np.asarray(ja.attention_kt_ancestry(*(jnp.asarray(x) for x in (q, k, v, anc, mask))))
    got = ta.attention_kt_ancestry(*(torch.from_numpy(x) for x in (q, k, v, anc, mask)))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_facades_default_to_the_reference_width(jparams):
    """``WhisperModel(name)``, ``WhisperEngine(name)`` and
    ``load_model(non-large name)`` default to "default" (f32, float
    cross-KV), as the JAX package's facades and engine do;
    ``load_model`` of a large model runs bf16 as in JAX."""
    for port, ref in ((WhisperModel.__init__, jax_api.WhisperModel.__init__),
                      (WhisperEngine.__init__, jax_api.WhisperEngine.__init__)):
        assert (inspect.signature(port).parameters["compute_type"].default
                == inspect.signature(ref).parameters["compute_type"].default == "default")
    tree = params_from_jax(jparams)
    kw = dict(params=tree, dims=tw.WhisperDims(*DIMS),
              tokenizer=WhisperTokenizer.byte_fallback(multilingual=False))
    for engine in (WhisperModel("tiny.en", device="cpu", **kw).engine,
                   WhisperEngine("tiny.en", device="cpu", **kw),
                   load_model("tiny.en", "cpu", **kw).engine):
        assert engine.dtype == torch.float32 and engine.cross_kv_bits is None
    large = load_model("large-v3", "cpu", **kw).engine
    assert large.dtype == torch.bfloat16 and large.cross_kv_bits == 8
    src = inspect.getsource(jax_openai.OpenAIWhisperModel.__init__)
    assert '"bfloat16" if name.startswith("large") else "default"' in src
    assert isinstance(load_model("tiny.en", "cpu", **kw), openai_api.OpenAIWhisperModel)
    with pytest.raises(ValueError, match="compute_type"):
        WhisperEngine("tiny.en", "float64", device="cpu", **kw)
    assert WhisperEngine("tiny.en", "int8", device="cpu", kv_bits=4, **kw).cross_kv_bits == 4
    for width in ("default", "float32"):  # a float cross-KV takes no bits
        with pytest.raises(ValueError, match="kv_bits"):
            WhisperEngine("tiny.en", width, device="cpu", kv_bits=8, **kw)


@pytest.mark.parametrize("width", ["default", "int8"])
def test_full_f32_only_inside_f32_width_calls(jparams, width, monkeypatch):
    """An f32 engine's calls run with TF32 off and give the caller's
    settings back after; a reduced-width engine never touches them."""
    from whisper_nemo_tpu_torch.engine import transcribe as tt

    engine = WhisperEngine("tiny.en", width, device="cpu", params=params_from_jax(jparams),
                           dims=tw.WhisperDims(*DIMS),
                           tokenizer=WhisperTokenizer.byte_fallback(multilingual=False))
    seen = []

    def encode(*args):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return tw.encode(*args)

    monkeypatch.setattr(tt, "encode", encode)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        feats = engine.encode_windows(torch.zeros((1, 80, 3000)))
        assert feats.shape == (1, 1500, DIMS[2])
        assert seen == [(False, False) if width == "default" else (True, True)]
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_beam_past_the_kernels_refused_on_cuda():
    """Beams of 1-8 run on the card (kernels A and E); a larger beam is
    refused there with a message naming ROADMAP, while the CPU's plain
    versions take any beam."""
    from whisper_nemo_tpu_torch.engine import transcribe as tt

    for beam in (1, 5, 8):
        tt._check_beam(beam, torch.device("cuda"))
    tt._check_beam(9, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt._check_beam(9, torch.device("cuda"))
    with pytest.raises(ValueError, match="at least 1"):
        tt._check_beam(0, torch.device("cpu"))


"""The port's sequential long-form path against the JAX package, on the CPU.

Modules in porting order: the single-window mel (kernel C's plain
version); the timestamp rules; the host helpers that split a window into
segments and map VAD time back; greedy and beam decode over a
left-padded conditioning prefix with timestamps, at f32; sampling;
language detection; then the slice: the faster-whisper facade's
``WhisperModel.transcribe`` (beam 5, VAD, timestamps, conditioning),
``transcribe_batched`` with timestamps, the temperature ladder on both
facades, the openai facade on the serving handler's call, and streaming.

The dims are tiny but ``n_text_ctx`` is 160, so that the conditioning
block (``PREV_BLOCK``: ``min(65, n_text_ctx - len(sot) - 64)`` slots) is
really used. Random weights decode few tokens below 256, which the
byte-fallback tokenizer alone would decode to empty text (and the engine
drops segments with empty text), so both packages get a tokenizer whose
text names every token.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_align import _random_segments, _shared_emissions
from test_torch_slice import (  # noqa: F401  (_one_torch_thread: autouse)
    SR, TIE_TOL, _first_difference, _one_torch_thread, speechlike,
)
from whisper_nemo_tpu.align import api as jax_align_api
from whisper_nemo_tpu.asr import faster_whisper_api as jax_api
from whisper_nemo_tpu.asr import openai_api as jax_openai
from whisper_nemo_tpu.engine import decode as jd
from whisper_nemo_tpu.engine import streaming as jax_streaming
from whisper_nemo_tpu.engine import transcribe as jtr
from whisper_nemo_tpu.models import whisper as jw
from whisper_nemo_tpu.models import whisper_stacked as jws
from whisper_nemo_tpu.ops.mel import log_mel_spectrogram as jax_log_mel
from whisper_nemo_tpu.text.tokenizer import WhisperTokenizer as JaxTokenizer
from whisper_nemo_tpu.text.tokenizer import get_suppressed_tokens
from whisper_nemo_tpu.vad.energy import get_speech_timestamps as jax_speech_timestamps
from whisper_nemo_tpu_torch.asr import WhisperModel
from whisper_nemo_tpu_torch.asr import faster_whisper_api, openai_api
from whisper_nemo_tpu_torch.engine import decode as td
from whisper_nemo_tpu_torch.engine import streaming
from whisper_nemo_tpu_torch.engine import transcribe as ttr
from whisper_nemo_tpu_torch.engine.checkpoint import params_from_jax
from whisper_nemo_tpu_torch.models import whisper as tw
from whisper_nemo_tpu_torch.models import whisper_stacked as tws
from whisper_nemo_tpu_torch.ops import mel
from whisper_nemo_tpu_torch.text.tokenizer import WhisperTokenizer

# multilingual (so language detection runs), one decoder layer
DIMS = (80, 1500, 64, 4, 1, 51865, 160, 64, 4, 1)
# The beam rule of tests/test_torch_beam.py: the port's mean log-probability
# per token against JAX's teacher-forced rescoring of the same tokens, and
# JAX's best against that rescoring.
SCORE_TOL = 2e-3
BEAM_TIE_TOL = 0.02
# JAX's timestamp rules and language detection compiled once (their
# shapes and options static), where the engine runs them op by op
_jax_rules = jax.jit(jd._apply_timestamp_rules, static_argnums=(3, 4))
_jax_detect = jax.jit(jd.detect_language, static_argnums=(2, 3, 4, 5, 6))


def _hide_prompt_stamps(tokens, n_prompt, ts_begin):
    """``tokens`` ``[B, L]`` with the prompt's timestamps replaced by token
    0. JAX's timestamp rules read a history's prompt only for its latest
    timestamp, so over this history they read the generated tokens only,
    as the port's rules (openai-whisper's) do."""
    in_prompt = jnp.arange(tokens.shape[1])[None, :] < n_prompt
    return jnp.where(in_prompt & (tokens >= ts_begin), 0, tokens)


def _clear_jax_decode_caches():
    for fn in (jd.greedy_decode, jd.beam_decode, _jax_forced):
        fn.clear_cache()


def _first_stamp_as_pair(logits, filtered, tokens, pos, n_prompt, opts):
    """JAX's ``filtered`` logits with openai-whisper's second step: after
    the first generated token, a timestamp, only text or EOT
    (``<|notimestamps|>`` and every timestamp masked), where JAX's rules
    take that stamp for a lone one and allow only timestamps or EOT."""
    ts = opts.timestamp_begin
    after_first = (pos - n_prompt == 1) & (tokens[:, jnp.maximum(pos - 1, 0)] >= ts)
    ids = jnp.arange(logits.shape[1])[None, :]
    text_next = jnp.where((ids >= ts) | (ids == opts.no_timestamps), -jnp.inf, logits)
    return jnp.where(after_first[:, None], text_next, filtered)


@pytest.fixture(autouse=True, scope="module")
def _jax_rules_over_generated_tokens():
    """The reference for every decode with timestamps in this module: JAX's
    rules over the generated tokens only (``_hide_prompt_stamps``), with
    openai-whisper's second step (``_first_stamp_as_pair``), as the port's
    rules read them. JAX's own rules also read the conditioning prefix,
    which masks every token of a window's first step once the previous
    text holds a stamp past 1.0 s (test_timestamp_rules_ignore_the_prompt),
    and force a second timestamp after the first, which empties every
    segment of a timestamped window
    (test_timestamp_rules_take_text_after_the_first_stamp). JAX's compiled
    decodes are dropped on both sides of the patch, so that no trace is
    shared between the patched and the unpatched rules."""
    rules = jd._apply_timestamp_rules

    def over_generated(logits, tokens, pos, n_prompt, opts):
        hidden = _hide_prompt_stamps(tokens, n_prompt, opts.timestamp_begin)
        return _first_stamp_as_pair(logits, rules(logits, hidden, pos, n_prompt, opts), tokens,
                                    pos, n_prompt, opts)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jd, "_apply_timestamp_rules", over_generated)
        _clear_jax_decode_caches()
        yield
    _clear_jax_decode_caches()


@pytest.fixture(autouse=True)
def _jitted_jax_detection(monkeypatch):
    monkeypatch.setattr(jtr, "detect_language", _jax_detect)


def _named(base):
    class Named(base):
        def decode(self, ids):
            return "".join(f" w{i}" for i in ids if i < self.eot)

    return Named


JaxNamed, TorchNamed = _named(JaxTokenizer), _named(WhisperTokenizer)


@pytest.fixture(scope="module")
def engines():
    """A JAX engine and the port's CPU engine on one converted int8 tree,
    and the f32 JAX tree itself."""
    init = jax.jit(jw.init_whisper_params, static_argnums=1)  # one compile, not one per op
    jparams = init(jax.random.PRNGKey(2), jw.WhisperDims(*DIMS))
    jt, tt = (cls.byte_fallback(multilingual=True) for cls in (JaxTokenizer, WhisperTokenizer))
    jt.__class__, tt.__class__ = JaxNamed, TorchNamed
    jeng = jax_api.WhisperEngine("tiny", "int8", params=jparams, dims=jw.WhisperDims(*DIMS),
                                 tokenizer=jt, mesh=False)
    teng = ttr.WhisperEngine("tiny", "int8", device="cpu", params=params_from_jax(jparams),
                             dims=tw.WhisperDims(*DIMS), tokenizer=tt)
    return jeng, teng, jparams


# ---------------------------------------------------------------------------
# kernel C's plain version
# ---------------------------------------------------------------------------


def _mel_case(case):
    rng = np.random.default_rng(11)
    wave = np.zeros(480000, np.float32)
    if case == "window":
        wave[:] = speechlike(30.0, 4)
    elif case == "padded":
        n = int(7.3 * SR)
        wave[:n] = speechlike(7.3, 5) + 0.01 * rng.standard_normal(n).astype(np.float32)
    return wave


@pytest.mark.parametrize("case", ["window", "padded", "silence"])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_jax(n_mels, case):
    """The single-window mel (kernel C's plain version on the CPU) against
    JAX's Pallas tile in interpret mode and its XLA form: a 30 s window, a
    7.3 s one zero-padded to 30 s, and silence (every bin at the 1e-10
    clamp, so -1.5 after normalization, exactly). 1e-4 after whisper's
    normalization, values of order 1: the same f32 products summed in
    another order (as tests/test_torch_ops.py's batched mel)."""
    wave = _mel_case(case)
    got = mel.log_mel_spectrogram(torch.from_numpy(wave), n_mels).numpy()
    assert got.shape == (n_mels, 3000)
    for impl in ("pallas", "xla"):
        want = np.asarray(jax_log_mel(jnp.asarray(wave), n_mels=n_mels, impl=impl))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if case == "silence":
        assert bool((got == -1.5).all())


# ---------------------------------------------------------------------------
# the timestamp rules and the host helpers
# ---------------------------------------------------------------------------

V, TS = 51864, 50364  # the English-only vocab and its first timestamp


def _ts_case(case):
    """Seeded logits ``[4, V]`` and histories ``[4, 40]`` (prompt of 6,
    so the step is ``pos - 6``) for one rule of the grammar."""
    rng = np.random.default_rng(sum(map(ord, case)))
    logits = rng.standard_normal((4, V)).astype(np.float32) * 2
    tokens = rng.integers(0, 50000, (4, 40))
    tokens[:, :6] = [50361, 300, 301, 302, TS + 20, 50257]  # <|startofprev|>, text, a 0.4 s stamp, SOT
    pos = {"step0": 6, "lone": 10, "pair": 11, "rewind": 12, "forced": 9}[case]
    if case == "lone":
        tokens[:, 9] = TS + rng.integers(30, 200, 4)
    elif case == "pair":
        tokens[:, 9] = tokens[:, 10] = TS + 150
        tokens[1, 9] = 400  # text, then a stamp: a lone stamp
    elif case == "rewind":
        tokens[:, 8] = TS + 600  # the latest stamp; the last token is text
        tokens[2, 11] = TS + 300  # a lone stamp below it: the floor stays 600
    elif case == "forced":
        logits[:, TS:] += 6.0  # the stamps together beat every text token
        logits[3, TS:] -= 12.0
    return logits, tokens, pos


_RULE_OPTS = dict(without_timestamps=False, eot=50256, sot=50257, no_timestamps=50362,
                  timestamp_begin=TS)


@pytest.mark.parametrize("case", ["step0", "lone", "pair", "rewind", "forced"])
def test_timestamp_rules_match_jax(case):
    """The port's ``_apply_timestamp_rules`` against JAX's over the same
    history with the prompt's 0.4 s stamp hidden (``_hide_prompt_stamps``:
    the port reads the generated tokens only), on seeded logits: the
    first step (timestamps only, from 0.0 to 1.0 s), a lone timestamp, a
    pair, a rewind below the latest stamp, and the forced timestamp. The
    -inf positions are equal and the finite values within 1e-6."""
    logits, tokens, pos = _ts_case(case)
    hidden = _hide_prompt_stamps(jnp.asarray(tokens, jnp.int32), 6, TS)
    want = np.asarray(_jax_rules(jnp.asarray(logits), hidden, jnp.int32(pos), 6,
                                 jd.DecodeOptions(**_RULE_OPTS)))
    got = td._apply_timestamp_rules(torch.from_numpy(logits), torch.from_numpy(tokens), pos, 6,
                                    td.DecodeOptions(**_RULE_OPTS)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], atol=1e-6, rtol=0)
    if case == "forced":
        assert np.isinf(want[:3, :TS]).all() and np.isfinite(want[3, :100]).any()
    if case == "step0":
        for row in got:
            np.testing.assert_array_equal(np.flatnonzero(np.isfinite(row)), np.arange(TS, TS + 51))


def test_timestamp_rules_ignore_the_prompt(prefix_case):
    """A conditioning tail whose latest stamp is past 1.0 s (12.0 s here),
    as the previous window's text holds on trained weights. JAX's rules,
    which read the prompt for the latest stamp, mask every token of the
    first step (the pick is then token 0, with a NaN log-probability).
    The port's leave exactly the stamps from 0.0 to 1.0 s open, and a
    greedy decode over such a prefix picks one of them first and sums
    finite log-probabilities."""
    logits, tokens, pos = _ts_case("step0")
    tokens[:, 4] = TS + 600
    want = np.asarray(_jax_rules(jnp.asarray(logits), jnp.asarray(tokens, jnp.int32),
                                 jnp.int32(pos), 6, jd.DecodeOptions(**_RULE_OPTS)))
    assert np.isinf(want).all()
    got = td._apply_timestamp_rules(torch.from_numpy(logits), torch.from_numpy(tokens), pos, 6,
                                    td.DecodeOptions(**_RULE_OPTS)).numpy()
    for row in got:
        np.testing.assert_array_equal(np.flatnonzero(np.isfinite(row)), np.arange(TS, TS + 51))
    _, _, targs, valid = prefix_case
    prompt = targs[2].clone()
    prompt[prompt == TS + 20] = TS + 600
    out = td.greedy_decode(*targs[:2], prompt, *targs[3:], dtype=torch.float32,
                           prompt_valid=valid)
    first = out[0][:, 12]
    assert bool(((first >= TS) & (first <= TS + 50)).all())
    assert bool(torch.isfinite(out[2]).all())


def test_timestamp_rules_take_text_after_the_first_stamp():
    """The second generated token, after the first (a timestamp): the
    port's rules, openai-whisper's, open text and EOT and mask every
    timestamp, as ``_first_stamp_as_pair`` reads JAX's; JAX's own rules
    take the first stamp for a lone one and open only timestamps and
    EOT, so its windows decode a second stamp and the host's split
    (``_split_on_timestamps``) finds no text between them."""
    logits, tokens, _ = _ts_case("step0")
    tokens[:, 6] = TS + 15
    hidden = _hide_prompt_stamps(jnp.asarray(tokens, jnp.int32), 6, TS)
    opts = jd.DecodeOptions(**_RULE_OPTS)
    want = np.asarray(_jax_rules(jnp.asarray(logits), hidden, jnp.int32(7), 6, opts))
    assert np.isinf(want[:, :50256]).all() and np.isfinite(want[:, TS + 15:]).all()
    want = np.asarray(_first_stamp_as_pair(jnp.asarray(logits), jnp.asarray(want), hidden,
                                           jnp.int32(7), 6, opts))
    got = td._apply_timestamp_rules(torch.from_numpy(logits), torch.from_numpy(tokens), 7, 6,
                                    td.DecodeOptions(**_RULE_OPTS)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[np.isfinite(want)], want[np.isfinite(want)])
    for row in got:
        np.testing.assert_array_equal(np.flatnonzero(np.isfinite(row)),
                                      np.setdiff1d(np.arange(TS), [50362]))


def _token_lists(seed, n=60):
    rng = np.random.default_rng(seed)
    lists = []
    for _ in range(n):
        k = int(rng.integers(0, 14))
        toks = [int(TS + rng.integers(0, 1500)) if rng.random() < 0.4 else int(rng.integers(0, 500))
                for _ in range(k)]
        lists.append(toks)
    lists += [[], [TS], [TS, 5, TS + 100], [TS, 5, TS + 100, TS + 100, 7], [5, 6, 7]]
    return lists


def test_split_on_timestamps_matches_jax():
    """Segments and frames consumed equal JAX's exactly, on 65 generated
    token lists (stamps and text mixed, empty, open and closed segments)
    at full and partial windows."""
    for i, toks in enumerate(_token_lists(3)):
        frames = 3000 if i % 2 else 1234
        args = (toks, TS, 12.34 * (i % 3), frames * 0.01, frames)
        assert ttr._split_on_timestamps(*args) == jtr._split_on_timestamps(*args), toks


def test_restore_vad_time_matches_jax():
    """VAD time restoration equals JAX's exactly, inside, between and past
    the spans of generated time maps."""
    rng = np.random.default_rng(5)
    for _ in range(20):
        starts = np.cumsum(rng.uniform(0.5, 4.0, 6))
        durs = rng.uniform(0.2, 3.0, 6)
        offsets = np.concatenate([[0.0], np.cumsum(durs)[:-1]])
        time_map = list(zip(offsets.tolist(), starts.tolist(), durs.tolist()))
        for t in rng.uniform(0.0, durs.sum() + 2.0, 15).tolist() + [0.0, float(durs.sum())]:
            assert ttr._restore_vad_time(t, time_map) == jtr._restore_vad_time(t, time_map)


# ---------------------------------------------------------------------------
# decode over a conditioning prefix, f32; sampling
# ---------------------------------------------------------------------------

EOT_DONOR = 8605


@pytest.fixture(scope="module")
def prefix_case(engines):
    """Two windows of the fixture's f32 tree with left-padded prompts of 12
    slots: row 0 holds 4 pad slots, row 1 holds 9 (a tail shorter than
    the block less one), each tail with a 0.4 s stamp (which the rules do
    not read), then SOT. The
    embeddings are scaled as in tests/test_torch_beam.py, so that
    hypotheses score apart and one finishes early."""
    jparams = engines[2]
    emb = np.array(jparams["decoder"]["tok_emb"]) * 10
    emb[50257] = emb[EOT_DONOR] + 0.3 * emb[50257]
    jparams = {**jparams, "decoder": {**jparams["decoder"], "tok_emb": jnp.asarray(emb)}}
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 64, 64)).astype(np.float32)
    prompt = np.full((2, 12), 50257)
    prompt[0, 4:] = [50361, 11, 22, 33, TS + 20, 44, 55, 50258]
    prompt[1, 9:] = [50361, TS + 20, 50258]
    valid = prompt != 50257
    mask = jd.build_suppress_mask(DIMS[5], [220, 50256])
    opts = dict(max_new_tokens=30, without_timestamps=False)
    jargs = (jws.stack_decoder_blocks(jparams), jnp.asarray(feats), jnp.asarray(prompt, jnp.int32),
             jnp.asarray(mask), jw.WhisperDims(*DIMS), jd.DecodeOptions(**opts))
    jkw = dict(n_prompt=12, dtype=jnp.float32, kv_int8=True, prompt_valid=jnp.asarray(valid))
    targs = (tws.stack_decoder_blocks(params_from_jax(jparams)), torch.from_numpy(feats),
             torch.from_numpy(prompt), torch.from_numpy(mask), tw.WhisperDims(*DIMS),
             td.DecodeOptions(**opts))
    return jargs, jkw, targs, torch.from_numpy(valid)


@pytest.mark.parametrize("mode", ["greedy", "beam5"])
def test_decode_with_prefix_f32_matches_jax(prefix_case, mode):
    """``greedy_decode`` and ``beam_decode(beam_size=5)`` with
    ``prompt_valid`` and timestamps, f32, int8 cross-KV on both sides:
    tokens and lengths equal JAX's; ``sum_logprob`` within 1e-2 (kernel
    A's numerics round the query and weights to bf16, as in
    tests/test_torch_beam.py); ``no_speech_prob`` within 1e-3 relative."""
    jargs, jkw, targs, valid = prefix_case
    if mode == "greedy":
        want = jd.greedy_decode(*jargs, **jkw)
        got = td.greedy_decode(*targs, dtype=torch.float32, prompt_valid=valid)
    else:
        want = jd.beam_decode(*jargs, beam_size=5, **jkw)
        got = td.beam_decode(*targs, beam_size=5, dtype=torch.float32, prompt_valid=valid)
    want = [np.asarray(x) for x in want]
    gen = got[0][:, 12:].numpy()
    assert (gen >= TS).any(), "the case should decode timestamps"
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_allclose(got[2].numpy(), want[2], atol=1e-2, rtol=0)
    np.testing.assert_allclose(got[3].numpy(), want[3], rtol=1e-3, atol=1e-9)


def test_sampling_draws_from_the_tempered_softmax():
    """``_sample`` at T = 0.7 on one row of 8 logits, 40,000 draws: each
    token's frequency within 0.01 of ``softmax(filt / T)`` (the standard
    error is at most 0.0025, so 4 of them); the -inf token is never
    drawn; the same seed draws the same tokens and another seed others."""
    filt = torch.tensor([1.0, 0.5, -0.3, 2.0, float("-inf"), 0.0, 1.2, -1.0])
    rows = filt.expand(40000, -1)
    draws = td._sample(rows, 0.7, torch.Generator().manual_seed(3))
    freq = torch.bincount(draws, minlength=8).double() / 40000
    want = torch.softmax(filt.double() / 0.7, dim=0)
    assert float((freq - want).abs().max()) < 0.01
    assert int(freq[4]) == 0
    again = td._sample(rows, 0.7, torch.Generator().manual_seed(3))
    other = td._sample(rows, 0.7, torch.Generator().manual_seed(4))
    assert torch.equal(draws, again) and not torch.equal(draws, other)


def test_sampled_decode_obeys_the_rules(prefix_case, monkeypatch):
    """A sampled decode at T = 1.0 with the prefix and timestamps: every
    drawn token is finite under the step's filter (so no timestamp-rule
    token is ever drawn), the untempered log-probability is what is
    summed, and the same generator seed gives the same tokens."""
    _, _, targs, valid = prefix_case
    opts = td.DecodeOptions(max_new_tokens=30, without_timestamps=False, temperature=1.0)
    args = targs[:5] + (opts,)
    seen = []
    sample = td._sample

    def recording(filt, temperature, generator):
        nxt = sample(filt, temperature, generator)
        seen.append((filt.clone(), nxt))
        return nxt

    monkeypatch.setattr(td, "_sample", recording)
    out = td.greedy_decode(*args, dtype=torch.float32, prompt_valid=valid,
                           generator=torch.Generator().manual_seed(7))
    monkeypatch.setattr(td, "_sample", sample)
    again = td.greedy_decode(*args, dtype=torch.float32, prompt_valid=valid,
                             generator=torch.Generator().manual_seed(7))
    assert torch.equal(out[0], again[0])
    total = torch.zeros(2)
    finished = torch.zeros(2, dtype=torch.bool)
    for filt, nxt in seen:
        picked = filt[torch.arange(2), nxt]
        assert bool(torch.isfinite(picked[~finished]).all())
        total += torch.where(finished, 0.0, torch.log_softmax(filt, -1)[torch.arange(2), nxt])
        finished |= nxt == opts.eot
    torch.testing.assert_close(out[2], total, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# language detection
# ---------------------------------------------------------------------------


def test_detect_language_matches_jax(engines):
    """Multilingual tiny dims, int8: the engine's ``detect_language`` (one
    decoder step from SOT, float cross-attention) on a 12 s chunk gives
    JAX's probabilities over the 99 language tokens within 2e-4 (bf16
    activations; each probability is about 0.01), and JAX's top language
    unless JAX's top two are within that."""
    jeng, teng, _ = engines
    audio = speechlike(12.0, 6)
    want = jeng.detect_language(audio, return_all=True)
    got = teng.detect_language(audio, return_all=True)
    _check_languages(got, want)


def _check_languages(got, want):
    wp, gp = dict(want[2]), dict(got[2])
    assert wp.keys() == gp.keys() and len(gp) == 99
    assert max(abs(wp[c] - gp[c]) for c in wp) < 2e-4
    top2 = sorted(wp.values())[-2:]
    if top2[1] - top2[0] > 2e-4:
        assert got[0] == want[0]
    assert abs(got[1] - wp[got[0]]) < 2e-4
    assert [c for c, _ in got[2]][0] == got[0]


# ---------------------------------------------------------------------------
# the slice: replayed window by window
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(5, 6, 7, 8, 9))
def _jax_forced(stacked, feats, tokens, kv_valid, suppress_mask, dims, n_prompt, opts, dtype,
                kv_int8):
    """JAX's filtered f32 log-probabilities ``[n - n_prompt, V]`` of the
    tokens of the one row ``tokens`` ``[1, n]`` after its prompt,
    teacher-forced in one prefill at the engine's width (``dtype``; the
    int8 cross-KV or, without ``kv_int8``, the float one), with each
    step's rules (its history is the row itself)."""
    ckv = jws.cross_attention_kv_stacked(stacked, feats.astype(dtype), dims)
    if kv_int8:
        ckv = jws.quantize_cross_kv_stacked(ckv)
    pos_offset = jnp.sum(~kv_valid[:, :n_prompt], axis=1).astype(jnp.int32)
    cache = jws.init_stacked_cache(1, dims, dtype, cache_len=kv_valid.shape[1])
    x, _ = jws.prefill_cache_stacked(stacked, tokens, cache, ckv, dims, dtype,
                                     kv_valid=kv_valid, pos_offset=pos_offset)
    filt = jw._vocab_logits(stacked["decoder"], x[0, n_prompt - 1 : -1]) + suppress_mask[None]
    filt = filt.at[0, jnp.asarray([opts.blank_token, opts.eot])].set(-jnp.inf)

    def rule(row, t):
        return jd._apply_timestamp_rules(row[None], tokens, n_prompt + t, n_prompt, opts)[0]

    filt = jax.vmap(rule)(filt, jnp.arange(filt.shape[0]))
    return jax.nn.log_softmax(filt, axis=-1)


def _jax_forced_logprobs(jeng, jfeats, prompt, valid, hyp, opts, suppress_mask):
    """JAX's filtered log-probabilities of hypothesis ``hyp`` (generated
    tokens, then EOT unless it ran to the limit) after the prompt
    (left-padded, ``valid`` its real slots), and that target, at the
    engine's width. The row is padded to the token limit, so one compile
    serves every hypothesis of a prompt shape."""
    n_prompt = len(prompt)
    target = list(hyp) + ([opts.eot] if len(hyp) < opts.max_new_tokens else [])
    n = n_prompt + opts.max_new_tokens
    tokens = (list(prompt) + target + [opts.eot] * n)[:n]
    cache_len = min(jeng.dims.n_text_ctx, -(-n // 128) * 128)
    kv_valid = np.ones((1, cache_len), bool)
    kv_valid[0, :n_prompt] = valid
    logprobs = _jax_forced(jeng._params_stacked, jfeats, jnp.asarray([tokens], jnp.int32),
                           jnp.asarray(kv_valid), jnp.asarray(suppress_mask), jeng.dims, n_prompt,
                           opts, jeng.dtype, jeng.kv_int8)
    return np.asarray(logprobs)[: len(target)], target


def _replay(jeng, teng, wave, beam_size, language):
    """Each window the port decoded, replayed by JAX at the port's seek
    with the port's conditioning tail: (port record, JAX tokens, JAX mean
    log-prob, the window's JAX features, prompt, valid slots, options)."""
    wave_dev = jnp.asarray(wave)
    mask = jd.build_suppress_mask(jeng.dims.n_vocab, get_suppressed_tokens(jeng.tokenizer, (-1,)))
    out = []
    for rec in teng.last_windows:
        window = jtr._window_at(wave_dev, rec["seek"] * 160)
        jfeats = jeng.encode_windows(jax_log_mel(window, n_mels=jeng.dims.n_mels)[None])
        toks, lengths, sum_lp, _, n_prompt = jeng._decode_batch(
            jfeats, language, mask, False, 0.0, rng_seed=rec["seek"],
            previous_tokens=rec["previous"], beam_size=beam_size,
        )
        jt = toks[0, n_prompt : n_prompt + lengths[0]].tolist()
        # the port's prompt for the window, which must be JAX's length
        prompt, valid = teng._prompt(language, False, rec["previous"])
        assert len(prompt) == n_prompt
        prompt = prompt.tolist()
        valid = [True] * n_prompt if valid is None else valid.tolist()
        opts = jeng._make_opts(without_timestamps=False,
                               max_new_tokens=min(224, jeng.dims.n_text_ctx - n_prompt))
        out.append((rec, jt, float(sum_lp[0]) / (int(lengths[0]) + 1), jfeats, prompt, valid,
                    opts, mask))
    return out


def _check_window(jeng, replayed, beam_size):
    """The window rule: tokens equal JAX's, or (beam) the port's
    hypothesis rescored by JAX within SCORE_TOL per token and JAX's best
    within BEAM_TIE_TOL of it, or (greedy) at the first differing token
    JAX's top-2 margin and its gap between the picks below TIE_TOL.
    Returns whether the tokens were equal. A window whose log-probability
    is not finite (a step with every token masked) fails."""
    rec, jt, j_avg, jfeats, prompt, valid, opts, mask = replayed
    got = rec["tokens"]
    assert np.isfinite(rec["avg_logprob"]), (rec["seek"], rec["avg_logprob"])
    j = _first_difference(got, jt, opts.eot)
    if j is None:
        assert abs(rec["avg_logprob"] - j_avg) < SCORE_TOL
        return True
    logprobs, target = _jax_forced_logprobs(jeng, jfeats, prompt, valid, got, opts, mask)
    if beam_size > 1:
        r = float(logprobs[np.arange(len(target)), target].sum()) / (len(got) + 1)
        assert abs(rec["avg_logprob"] - r) < SCORE_TOL, (rec["seek"], rec["avg_logprob"], r)
        assert r > j_avg - BEAM_TIE_TOL, (rec["seek"], r, j_avg)
    else:
        row = logprobs[j]
        top2 = np.sort(row)[-2:]
        gap = row[(jt + [opts.eot])[j]] - row[(got + [opts.eot])[j]]
        assert max(top2[1] - top2[0], gap) < TIE_TOL, (rec["seek"], j, top2, gap)
    return False


def _vad_wave(audio):
    """JAX's VAD-concatenated audio and its time map."""
    spans = jax_speech_timestamps(audio)
    time_map, offset = [], 0.0
    for s in spans:  # the offsets summed in seconds, as the engines sum them
        dur = (s["end"] - s["start"]) / SR
        time_map.append((offset, s["start"] / SR, dur))
        offset += dur
    return np.concatenate([audio[s["start"] : s["end"]] for s in spans]), time_map


def test_sequential_facade_matches_jax(engines):
    """``WhisperModel.transcribe(audio, None, vad_filter=True)`` at beam 5,
    ``temperature=(0.0,)``, on 40 s of speech-like audio: the language is
    detected on the VAD-concatenated audio; two or more windows,
    the second conditioned on the first. Each window is replayed by JAX's
    ``_decode_batch`` at the port's seek with the port's conditioning
    tail and meets the window rule; where a window's tokens are equal,
    its segments (texts, times restored from the VAD map, tokens) and
    its seek advance are JAX's, but for the segments that end at or
    before their start (begun past the window's audio), which the port
    drops."""
    jeng, teng, _ = engines
    tmodel = WhisperModel.__new__(WhisperModel)
    tmodel.engine = teng
    audio = speechlike(40.0, 0)
    got, info = tmodel.transcribe(audio, None, vad_filter=True, temperature=(0.0,))
    got = list(got)
    wave, time_map = _vad_wave(audio)
    assert info.duration == 40.0 and info.duration_after_vad == len(wave) / SR
    # detection runs on the first 30 s of the VAD-concatenated audio
    # (test_detect_language_matches_jax holds it against JAX's)
    assert (info.language, info.language_probability, info.all_language_probs) == \
        teng.detect_language(wave[:480000], return_all=True)
    windows = teng.last_windows
    assert len(windows) >= 2 and windows[1]["previous"], "the second window is conditioned"
    assert all(w["temperatures"] == [0.0] for w in windows)
    content, ts = len(wave) // 160, jeng.tokenizer.timestamp_begin
    for replayed in _replay(jeng, teng, wave, 5, info.language):
        rec, jt = replayed[:2]
        if not _check_window(jeng, replayed, 5):
            continue
        # equal tokens: the window's segments are JAX's split of them, but
        # for a segment that ends at or before its start, which the port drops
        frames = min(3000, content - rec["seek"])
        want = [(jeng.tokenizer.decode(t), jtr._restore_vad_time(a, time_map),
                 jtr._restore_vad_time(b, time_map), t)
                for t, a, b in jtr._split_on_timestamps(jt, ts, rec["seek"] * 0.01, frames * 0.01,
                                                        frames)[0] if b > a]
        want = [w for w in want if w[0].strip()]
        assert [(s.text, s.start, s.end, s.tokens) for s in got if s.seek == rec["seek"]] == want
        assert rec["frames"] == jtr._split_on_timestamps(jt, ts, 0.0, frames * 0.01, frames)[1]


def test_batched_timestamps_match_jax(engines):
    """``transcribe_batched(language=None, without_timestamps=False)``,
    greedy, in batches of one window: the language detected on the first
    window as JAX detects it, windows and bounds equal, and each window's
    tokens (timestamps included) equal JAX's or meet the greedy tie rule
    (the beam path with timestamps is test_sequential_facade_matches_jax's)."""
    jeng, teng, _ = engines
    audio = speechlike(25.0, 0)
    kw = dict(batch_size=1, without_timestamps=False, beam_size=1)
    got, info = teng.transcribe_batched(audio, None, **kw)
    want, winfo = jeng.transcribe_batched(audio, None, **kw)
    _check_languages((info.language, info.language_probability, info.all_language_probs),
                     (winfo.language, winfo.language_probability, winfo.all_language_probs))
    if winfo.language != info.language:  # a tie: compare the decodes in one language
        want, winfo = jeng.transcribe_batched(audio, info.language, **kw)
    assert [(s.start, s.end) for s in got] == [(s.start, s.end) for s in want]
    mask = jd.build_suppress_mask(jeng.dims.n_vocab, get_suppressed_tokens(jeng.tokenizer, (-1,)))
    sot = jeng.tokenizer.sot_sequence(info.language, without_timestamps=False)
    opts = jeng._make_opts(without_timestamps=False,
                           max_new_tokens=min(224, jeng.dims.n_text_ctx - len(sot)))
    for g, w in zip(got, want):
        assert any(t >= jeng.tokenizer.timestamp_begin for t in g.tokens)
        rec = {"seek": g.seek, "tokens": g.tokens, "avg_logprob": g.avg_logprob}
        s0, e0 = int(round(g.start * SR)), int(round(g.end * SR))
        window = np.zeros(480000, np.float32)
        window[: min(480000, e0 - s0)] = audio[s0:e0]
        jfeats = jeng.encode_windows(jax_log_mel(jnp.asarray(window))[None])
        _check_window(jeng, (rec, w.tokens, w.avg_logprob, jfeats, sot, [True] * len(sot), opts,
                             mask), 1)


def _scripted(seek, temp, ts_begin):
    """A fixed decode result for the ladder test, by seek and temperature:
    (generated tokens, sum_logprob, no_speech_prob). At seek 0 the
    compression ratio fails at T 0, the log-prob at 0.2, and 0.4 passes;
    the second window fails every temperature (the last one is kept, and
    its T > 0.5 resets the conditioning); the third is silent."""
    text = [ts_begin, 300, 301, ts_begin + 500]  # <|0.00|> w300 w301 <|10.00|>
    if seek == 0:
        if temp == 0.0:
            return [ts_begin] + [300] * 120 + [ts_begin + 500], -10.0, 0.01
        if temp == 0.2:
            return text, -20.0, 0.01
        return text, -2.0, 0.01
    if seek == 1000:
        return [ts_begin, 302, ts_begin + 400], -20.0, 0.01
    return [303], -30.0, 0.9


def _stub_decode(engine, calls, port):
    def decode(feats, language, suppress_mask, without_timestamps=False, temperature=0.0,
               rng_seed=0, previous_tokens=None, **_):
        seek = next(s for s in (0, 1000, 1800, 2600, 3400) if 0 <= rng_seed - s < 6)
        calls.append((seek, temperature, None if previous_tokens is None else list(previous_tokens)))
        gen, sum_lp, no_speech = _scripted(seek, temperature, engine.tokenizer.timestamp_begin)
        out = (np.asarray([[engine.tokenizer.sot] + gen + [engine.tokenizer.eot]]),
               np.asarray([len(gen)]), np.asarray([sum_lp], np.float32),
               np.asarray([no_speech], np.float32))
        if port:
            return tuple(torch.from_numpy(x) for x in out) + (1, 0)
        return out + (1,)

    engine._decode_batch = decode


def test_segment_begun_past_the_window_is_dropped(engines):
    """A 4 s recording's window decodes a closed segment inside its audio,
    then an open one begun at 5.0 s, past it: JAX's split runs that one to
    the window's end, before its start, and the port drops it (the
    serving merge would divide by its duration)."""
    jeng, teng, _ = engines
    ts, word = teng.tokenizer.timestamp_begin, 1000
    gen = [ts, word, ts + 50, ts + 250, word + 1]

    def decode(*args, **kwargs):
        return (torch.tensor([[teng.tokenizer.sot] + gen + [teng.tokenizer.eot]]),
                torch.tensor([len(gen)]), torch.tensor([-1.0]), torch.tensor([0.1]), 1, 0)

    teng._decode_batch = decode
    try:
        got, _ = teng.transcribe_sequential(speechlike(4.0, 3), "en", temperatures=(0.0,))
    finally:
        del teng._decode_batch
    split = jtr._split_on_timestamps(gen, ts, 0.0, 4.0, 400)[0]
    assert [(a, b) for _, a, b in split] == [(0.0, 1.0), (5.0, 4.0)]
    assert [(s.start, s.end, s.tokens) for s in got] == [(0.0, 1.0, [word])]


@pytest.mark.parametrize("facade", ["faster_whisper", "openai"])
def test_temperature_ladder_matches_jax(engines, facade):
    """The default ladder (0.0 ... 1.0) on both facades, with the decode
    stubbed to fixed results on both sides (so no sampled tokens are
    compared): the temperatures tried in each window, the conditioning
    tail each decode receives, the gates (compression ratio > 2.4 or mean
    log-prob < -1 falls back; no-speech > 0.6 with a low log-prob skips
    the window) and the resulting segments equal JAX's."""
    jeng, teng, _ = engines
    audio = speechlike(34.0, 9)
    runs = []
    for engine, port in ((jeng, False), (teng, True)):
        calls = []
        _stub_decode(engine, calls, port)
        try:
            if facade == "openai":
                cls = openai_api.OpenAIWhisperModel if port else jax_openai.OpenAIWhisperModel
                model = cls.__new__(cls)
                model.engine = engine
                out = model.transcribe(audio, language="en")
                segs = [(s["seek"], s["start"], s["end"], s["text"], s["temperature"])
                        for s in out["segments"]]
            else:
                cls = WhisperModel if port else jax_api.WhisperModel
                model = cls.__new__(cls)
                model.engine = engine
                segs = [(s.seek, s.start, s.end, s.text, s.temperature)
                        for s in model.transcribe(audio, "en")[0]]
        finally:
            del engine._decode_batch
        runs.append((calls, segs))
    (jcalls, jsegs), (tcalls, tsegs) = runs
    ladder = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
    assert [c[:2] for c in jcalls] == [(0, 0.0), (0, 0.2), (0, 0.4)] + [
        (seek, t) for seek in (1000, 1800) for t in ladder]
    ts = jeng.tokenizer.timestamp_begin
    # the second window is conditioned on the first's kept tokens; its
    # T = 1.0 result resets the conditioning for the third
    assert jcalls[3][2] == [ts, 300, 301, ts + 500] and jcalls[9][2] is None
    assert tcalls == jcalls and tsegs == jsegs
    assert [(s[0], s[4]) for s in tsegs] == [(0, 0.4), (1000, 1.0)]  # the silent window skipped


def test_openai_facade_matches_jax(engines):
    """The serving handler's call (temperature 0.0, no conditioning,
    greedy) through ``OpenAIWhisperModel.transcribe``: the dict's keys,
    ``language`` and ``duration`` equal JAX's; each window, replayed by
    JAX, meets the greedy tie rule; where every window's tokens are equal,
    ``text`` and every segment's fields equal JAX's (log-probs and
    no-speech probabilities within 2e-3)."""
    jeng, teng, _ = engines
    kw = dict(language="en", temperature=0.0, condition_on_previous_text=False,
              no_speech_threshold=0.6, logprob_threshold=-1.0, compression_ratio_threshold=2.4)
    audio = speechlike(25.0, 1)
    jm = jax_openai.OpenAIWhisperModel.__new__(jax_openai.OpenAIWhisperModel)
    tm = openai_api.OpenAIWhisperModel.__new__(openai_api.OpenAIWhisperModel)
    jm.engine, tm.engine = jeng, teng
    got, want = tm.transcribe(audio, **kw), jm.transcribe(audio, **kw)
    assert got.keys() == want.keys() == {"text", "segments", "language", "duration"}
    assert (got["language"], got["duration"]) == (want["language"], want["duration"])
    assert all(w["previous"] is None for w in teng.last_windows)
    equal = [_check_window(jeng, r, 1) for r in _replay(jeng, teng, audio, 1, "en")]
    if all(equal):
        assert got["text"] == want["text"] and len(got["segments"]) == len(want["segments"])
        for g, w in zip(got["segments"], want["segments"]):
            assert g.keys() == w.keys()
            for k in g:
                if k in ("avg_logprob", "no_speech_prob"):
                    assert abs(g[k] - w[k]) < 2e-3
                else:
                    assert g[k] == w[k], k


def test_word_timestamps_match_jax(monkeypatch):
    """``word_timestamps=True``'s step, ``_attach_word_timestamps``, on
    seeded segments (one of them empty) with the same emissions fed to
    both packages' aligners (tests/test_torch_align.py's device): every
    segment's words, times and probabilities (within 1e-6) equal JAX's,
    and the empty segment gets none."""
    em, timed = _random_segments()
    _shared_emissions(monkeypatch, em)
    # JAX's aligner is never read (the emissions are shared): skip its init
    monkeypatch.setattr(jax_align_api, "load_alignment_model",
                        lambda *a, **k: (None, jax_align_api.AlignmentTokenizer()))
    audio = np.zeros(int(23 * SR), np.float32)
    segs = [([jtr.Segment, ttr.Segment][port](i, 0, t["start"], t["end"], t["text"], []))
            for port in (0, 1) for i, t in enumerate(timed)]
    jsegs, tsegs = segs[: len(timed)], segs[len(timed):]
    jax_api._attach_word_timestamps(jsegs, audio, "en")
    faster_whisper_api._attach_word_timestamps(tsegs, audio, "en", torch.device("cpu"))
    assert sum(len(s.words) for s in tsegs) == sum(len(t["text"].split()) for t in timed)
    for j, t in zip(jsegs, tsegs):
        assert len(t.words) == len(j.words) == len(t.text.split())
        for tw_, jw_ in zip(t.words, j.words):
            assert (tw_.word, tw_.start, tw_.end) == (jw_.word, jw_.start, jw_.end)
            assert abs(tw_.probability - jw_.probability) <= 1e-6


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------


class _Seg:
    def __init__(self, start, end, text):
        self.start, self.end, self.text = start, end, text


def _hypothesis(buffer):
    """A stub refresh: words that grow with the buffer, the newest one
    unstable (it changes with the buffer's length)."""
    n = len(buffer) // 8000
    words = [f"w{i}" for i in range(n)] + [f"tail{len(buffer) % 7}"]
    dur = len(buffer) / 16000
    return [_Seg(0.0, dur, " ".join(words))]


def test_streaming_matches_jax(engines):
    """``StreamingTranscriber`` with a stub refresh commits JAX's words at
    every push and at the flush (LocalAgreement-2, buffer trimming past
    28 s); one push through the port's CPU engine proves the wiring."""
    rng = np.random.default_rng(2)
    pushes = [rng.standard_normal(int(rng.uniform(0.3, 2.5) * 16000)).astype(np.float32) * 0.1
              for _ in range(30)]
    results = []
    for mod in (jax_streaming, streaming):
        st = mod.StreamingTranscriber(transcribe_fn=_hypothesis, min_refresh_s=1.0)
        per_push = [[(w.word, w.start, w.end) for w in st.push(p)] for p in pushes]
        per_push.append([(w.word, w.start, w.end) for w in st.flush()])
        results.append((per_push, st.text))
    assert results[0] == results[1] and len(results[1][1].split()) > 20
    st = streaming.StreamingTranscriber(engines[1], language="en", min_refresh_s=1.0)
    assert st.push(speechlike(1.5, 8)) == []  # the first hypothesis commits nothing
    assert len(st._hyp_history) == 1 and engines[1].last_windows[0]["temperatures"] == [0.0]

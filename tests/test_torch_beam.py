"""The port's beam search against the JAX package, on the CPU.

Modules in porting order: the plain ancestry attention (kernel E's
oracle) and the repaired f32 logits of ``attention_kt``; the cache
permute (kernel F's plain versions); the top-K tie rule; ``beam_decode``
in f32 on one converted param tree; and the slice, the faster-whisper
facade at its default beam 5 at int8. The JAX package's Pallas kernels
run in interpret mode, as its own tests run them on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import (  # noqa: F401  (_one_torch_thread: autouse)
    BATCH, DIMS, SR, _first_difference, _jax_forced_logits, _one_torch_thread, speechlike,
)
from whisper_nemo_tpu.asr import faster_whisper_api as jax_api
from whisper_nemo_tpu.engine import decode as jd
from whisper_nemo_tpu.models import whisper as jw
from whisper_nemo_tpu.models import whisper_stacked as jws
from whisper_nemo_tpu.ops import attention as ja
from whisper_nemo_tpu.ops.beam_permute import beam_permute_cache as jax_permute
from whisper_nemo_tpu.ops.beam_permute import beam_permute_cache_inplace as jax_permute_inplace
from whisper_nemo_tpu.ops.self_decode import self_attention_decode_ancestry_layered as jax_kernel_e
from whisper_nemo_tpu.text.tokenizer import WhisperTokenizer as JaxTokenizer
from whisper_nemo_tpu_torch.asr import BatchedInferencePipeline, WhisperModel
from whisper_nemo_tpu_torch.engine import decode as td
from whisper_nemo_tpu_torch.engine.checkpoint import params_from_jax
from whisper_nemo_tpu_torch.models import whisper as tw
from whisper_nemo_tpu_torch.models import whisper_stacked as tws
from whisper_nemo_tpu_torch.ops import attention as ta
from whisper_nemo_tpu_torch.ops import beam_permute as tp
from whisper_nemo_tpu_torch.text.tokenizer import WhisperTokenizer

# Beam search at int8 (bf16 activations) on random weights, whose
# logits are nearly flat: every hypothesis scores about -10 per token, so
# comparing the two searches' scores cannot tell a fault from a tie.
# Each hypothesis of the port is instead rescored by JAX, teacher-forced:
# the port's own mean log-probability per token must agree with JAX's
# score of the same tokens to SCORE_TOL (measured: at most 3.7e-4; a
# decode that ignores the ancestry map, or drops a lane's own position
# from it, misses by 3.5e-3 to 5.0e-2), and JAX must rank it within
# BEAM_TIE_TOL of its own best (measured: 0.0146; the frameworks' step
# logits agree to 0.02, tests/test_torch_whisper.py).
SCORE_TOL = 2e-3
BEAM_TIE_TOL = 0.02


def _bf16(x):
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_attention_kt_keeps_f32_logits_like_jax():
    """The repaired ``attention_kt`` takes f32 logits of the bf16
    operands, as the JAX package does: at bf16 it now matches JAX's to
    one bf16 ulp of the outputs (0 here), where the former bf16 logits
    were 2^-6 away (0.0156, outputs of order 3)."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((4, 1, 4, 64)).astype(np.float32) * 3
    k, v = (rng.standard_normal((4, 4, 64, 128)).astype(np.float32) for _ in range(2))
    mask = np.where(np.arange(128) < 100, 0.0, -np.inf).astype(np.float32)[None, None, None]
    (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
    want = _f32(ja.attention_kt(jq, jk, jv, jnp.asarray(mask)))
    got = ta.attention_kt(tq, tk, tv, torch.from_numpy(mask)).float().numpy()
    # the former formula, with the logits rounded to bf16
    logits = torch.matmul((tq * 64**-0.5).permute(0, 2, 1, 3), tk).float()
    logits = torch.where(torch.from_numpy(mask) >= 0, logits, ta._MASK_VALUE)
    w = torch.softmax(logits, dim=-1).bfloat16()
    old = torch.matmul(w, tv.transpose(-1, -2)).permute(0, 2, 1, 3).float().numpy()
    new_err, old_err = np.abs(got - want).max(), np.abs(old - want).max()
    assert new_err <= 2.0**-8 * np.abs(want).max() and new_err < old_err, (new_err, old_err)


def _ancestry_case(per_window_mask, seed, b=2, kk=3, h=2, d=16, s=24):
    rng = np.random.default_rng(seed)
    bk = b * kk
    q = rng.standard_normal((bk, 1, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((2, bk, h, d, s)).astype(np.float32) for _ in range(2))
    anc = rng.integers(0, kk, (b, kk, s)).astype(np.int32)
    if per_window_mask:
        valid = rng.random((b, s)) > 0.3
        valid[:, 0] = True
        mask = np.where(np.repeat(valid, kk, axis=0), 0.0, -np.inf)[:, None, None, :]
    else:
        mask = np.where(np.arange(s) < s - 5, 0.0, -np.inf)[None, None, None, :]
    return q, k, v, anc, mask.astype(np.float32)


@pytest.mark.parametrize("per_window_mask", [False, True], ids=["shared_mask", "per_window_mask"])
@pytest.mark.parametrize("reference", ["einsum", "masked", "kernel", "gathered"])
def test_attention_kt_ancestry_matches_jax(reference, per_window_mask):
    """The port's plain ancestry attention (layer 1 of a 2-layer cache)
    against: JAX's two one-hot formulations in f32 (1e-5, f32 summation
    order); the Pallas kernel E in interpret mode, which rounds q, the
    cache and the weights to bf16 (2e-2, as tests/test_self_decode.py);
    and JAX's ``attention_kt`` over the explicitly gathered cache at bf16
    (one bf16 ulp of the outputs: both take f32 logits of bf16 operands).
    The port's layered wrapper on CPU tensors is the plain version."""
    q, k, v, anc, mask = _ancestry_case(per_window_mask, seed=4 + per_window_mask)
    b, kk, s = anc.shape
    tq, tk, tv, tanc, tmask = (torch.from_numpy(x) for x in (q, k, v, anc, mask))
    if reference == "gathered":
        rows = (np.arange(b)[:, None, None] * kk + anc).reshape(b * kk, s)
        kg, vg = (np.take_along_axis(x[1], rows[:, None, None, :], axis=0) for x in (k, v))
        (jq, tq), (jkg, _), (jvg, _) = _bf16(q), _bf16(kg), _bf16(vg)
        want = _f32(ja.attention_kt(jq, jkg, jvg, jnp.asarray(mask)))
        tk, tv = torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()
        atol = 2.0**-8 * np.abs(want).max()
    elif reference == "kernel":
        want = _f32(jax_kernel_e(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(anc),
                                 jnp.asarray(mask), jnp.int32(1), beam=kk, interpret=True))
        atol = 2e-2
    else:
        want = _f32(ja.attention_kt_ancestry(jnp.asarray(q), jnp.asarray(k[1]), jnp.asarray(v[1]),
                                             jnp.asarray(anc), jnp.asarray(mask), select=reference))
        atol = 1e-5
    got = ta.attention_kt_ancestry(tq, tk[1], tv[1], tanc, tmask)
    assert got.shape == (b * kk, 1, 2, 16) and got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,beam", [((4, 6, 16, 2, 8), 3), ((3, 10, 8, 4, 16), 5),
                                        ((2, 6, 5, 3, 8), 3)])
def test_beam_permute_matches_jax(shape, beam, dtype):
    """Kernel F's plain versions against the JAX package's Pallas kernels
    in interpret mode, bit for bit: out of place and within windows in
    place, gather repeats included (the in-place call overwrites its
    inputs)."""
    rng = np.random.default_rng(sum(shape) + beam)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    src = rng.integers(0, beam, size=(shape[1] // beam, beam)).astype(np.int32)
    src[0] = 0  # one window all from lane 0: repeats
    idx = (np.arange(shape[1] // beam)[:, None] * beam + src).reshape(-1).astype(np.int32)
    jk, jv = (jnp.asarray(x).astype(dtype) for x in (k, v))
    tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (k, v))
    want = [_f32(x) for x in jax_permute(jk, jv, jnp.asarray(idx), interpret=True)]
    got = tp.beam_permute_cache(tk, tv, torch.from_numpy(idx))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(), w)
    want = [_f32(x) for x in jax_permute_inplace(jk, jv, jnp.asarray(src), beam=beam, interpret=True)]
    got = tp.beam_permute_cache_inplace(tk, tv, torch.from_numpy(src), beam)
    assert got[0] is tk and got[1] is tv
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(), w)


def test_top_k_ties_match_jax():
    """The beam's top-K orders as ``jax.lax.top_k``: ties to the lower
    index, +0.0 above -0.0, NaN above +inf; on a hand-made row and on
    rows drawn from four values."""
    rows = np.array([[-0.0, 0.0, 1.0, 1.0, -np.inf, -np.inf, np.nan, 2.0, 1.0, 0.0]], np.float32)
    rng = np.random.default_rng(7)
    drawn = rng.choice(np.array([-np.inf, -3.5, 0.25, 1.0], np.float32), size=(3, 50))
    for x, k in ((rows, 10), (rows, 4), (drawn, 5)):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = td.top_k_lowest_index(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# beam_decode in f32 on small dims. The random init's logits are flat, so
# the token embeddings are scaled by 10 to give the beams distinct scores,
# and EOT's embedding is moved next to a token the beams pick, so that a
# hypothesis finishes early and finished beams are carried.
DECODE_DIMS = (80, 64, 64, 4, 1, 51864, 64, 64, 4, 2)
EOT_DONOR = 8605


@pytest.fixture(scope="module")
def beam_case():
    jparams = jw.init_whisper_params(jax.random.PRNGKey(1), jw.WhisperDims(*DECODE_DIMS))
    emb = np.array(jparams["decoder"]["tok_emb"]) * 10
    emb[50257] = emb[EOT_DONOR] + 0.3 * emb[50257]
    jparams = {**jparams, "decoder": {**jparams["decoder"], "tok_emb": jnp.asarray(emb)}}
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 64, 64)).astype(np.float32)
    prompt = np.array([[50257, 50362]] * 2)
    mask = jd.build_suppress_mask(51864, [220, 50256])
    want = jd.beam_decode(
        jws.stack_decoder_blocks(jparams), jnp.asarray(feats), jnp.asarray(prompt, jnp.int32),
        jnp.asarray(mask), jw.WhisperDims(*DECODE_DIMS), jd.DecodeOptions(max_new_tokens=30),
        n_prompt=2, beam_size=5, dtype=jnp.float32, kv_int8=True,
    )
    args = (
        tws.stack_decoder_blocks(params_from_jax(jparams)), torch.from_numpy(feats),
        torch.from_numpy(prompt), torch.from_numpy(mask), tw.WhisperDims(*DECODE_DIMS),
        td.DecodeOptions(max_new_tokens=30),
    )
    return [np.asarray(x) for x in want], args


def test_beam_decode_f32_matches_jax(beam_case):
    """f32, beam 5: tokens and lengths equal JAX's (one window ends at
    EOT after 5 tokens, the other runs to the 30-token limit);
    ``sum_logprob`` within 1e-2 over 30 tokens (kernel A's numerics round
    the cross-attention query and weights to bf16 where JAX's CPU einsum
    form stays in f32); ``no_speech_prob`` within 1e-3 relative."""
    want, args = beam_case
    tokens, lengths, sum_lp, no_speech, steps = td.beam_decode(*args, beam_size=5, dtype=torch.float32)
    np.testing.assert_array_equal(tokens.numpy(), want[0])
    np.testing.assert_array_equal(lengths.numpy(), want[1])
    assert sorted(lengths.tolist()) == [5, 30] and steps == 29
    np.testing.assert_allclose(sum_lp.numpy(), want[2], atol=1e-2, rtol=0)
    np.testing.assert_allclose(no_speech.numpy(), want[3], rtol=1e-3, atol=1e-9)


def test_beam1_matches_greedy(beam_case):
    """Beam 1 is greedy: the port's ``beam_decode(beam_size=1)`` gives
    ``greedy_decode``'s tokens, lengths and steps, and its log-probability
    to 1e-4 (f32 sums in another order)."""
    _, args = beam_case
    got = td.beam_decode(*args, beam_size=1, dtype=torch.float32)
    want = td.greedy_decode(*args, dtype=torch.float32)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), atol=1e-4, rtol=0)
    assert got[4] == want[4]


def _jax_rescore(engine, audio, windows, hyps):
    """JAX's sum of filtered f32 log-probabilities of each row's
    hypothesis ``hyps[i]`` (its generated tokens, then EOT unless it ran
    to the token limit), teacher-forced in the batch of ``windows`` it
    was decoded in: the score JAX's beam search gives that hypothesis."""
    eot = engine._make_opts().eot
    prompt = engine.tokenizer.sot_sequence(None, without_timestamps=True)
    max_new = min(224, engine.dims.n_text_ctx - len(prompt))
    logprobs = np.asarray(jax.nn.log_softmax(
        jnp.asarray(_jax_forced_logits(engine, audio, windows, hyps)), axis=-1))
    scores = []
    for row, h in enumerate(hyps):
        target = h + [eot] if len(h) < max_new else h
        scores.append(float(logprobs[row, np.arange(len(target)), target].sum()))
    return scores


def test_batched_pipeline_beam5_matches_jax():
    """The slice at the facade's default beam 5, int8, on
    tests/test_torch_slice.py's dims and ~70 s of audio in batches of 2
    (the last one partial): segment bounds equal; each window's
    hypothesis, rescored by JAX, has the port's mean log-probability per
    token within SCORE_TOL and JAX's best within BEAM_TIE_TOL; text equal
    where tokens are; no-speech probabilities within 1e-3."""
    jparams = jw.init_whisper_params(jax.random.PRNGKey(2), jw.WhisperDims(*DIMS))
    audio = speechlike(70.0, 0)
    jmodel = jax_api.WhisperModel.__new__(jax_api.WhisperModel)
    jmodel.engine = jax_api.WhisperEngine(
        "tiny.en", "int8", params=jparams, dims=jw.WhisperDims(*DIMS),
        tokenizer=JaxTokenizer.byte_fallback(multilingual=False), mesh=False,
    )
    want, _ = jax_api.BatchedInferencePipeline(jmodel).transcribe(audio, language="en", batch_size=BATCH)
    want = list(want)
    model = WhisperModel(
        "tiny.en", device="cpu", compute_type="int8", params=params_from_jax(jparams),
        dims=tw.WhisperDims(*DIMS), tokenizer=WhisperTokenizer.byte_fallback(multilingual=False),
    )
    got, _ = BatchedInferencePipeline(model).transcribe(audio, language="en", batch_size=BATCH)
    got = list(got)

    assert len(got) == len(want) >= 3 and len(got) % BATCH, "want a partial last batch"
    assert [(s.start, s.end, s.seek) for s in got] == [(s.start, s.end, s.seek) for s in want]
    windows = [(int(round(s.start * SR)), int(round(s.end * SR))) for s in want]
    rescored = []
    for first in range(0, len(got), BATCH):
        batch = windows[first : first + BATCH]
        hyps = [list(s.tokens) for s in got[first : first + BATCH]]
        pad = BATCH - len(batch)
        scores = _jax_rescore(jmodel.engine, audio, batch + [(0, 0)] * pad, hyps + [[]] * pad)
        rescored += scores[: len(batch)]
    for g, w, r in zip(got, want, rescored):
        assert abs(g.no_speech_prob - w.no_speech_prob) < 1e-3
        if _first_difference(g.tokens, w.tokens, model.engine.tokenizer.eot) is None:
            assert g.text == w.text
        r /= len(g.tokens) + 1
        assert abs(g.avg_logprob - r) < SCORE_TOL, (g.avg_logprob, r)
        assert r > w.avg_logprob - BEAM_TIE_TOL, (r, w.avg_logprob)

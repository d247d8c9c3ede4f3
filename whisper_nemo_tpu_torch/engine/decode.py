"""Batched greedy, sampled and beam decode for Whisper.

Counterpart of ``whisper_nemo_tpu/engine/decode.py``: whisper's logit
rules (suppress list, blank suppression, the timestamp grammar), the
no-speech probability, temperature sampling for the
fallback ladder, a left-padded conditioning prefix, and language
detection. The JAX package's ``lax.while_loop`` is an eager loop here
that stops as soon as every window has emitted EOT. The cross-KV is the
int8 decode layout at ``kv_bits`` (kernel A on a CUDA tensor; the reduced
widths) or, with ``kv_bits=None``, the float form (the f32 widths); beam
search selects each lane's history through an ancestry map (kernel E).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.whisper import (
    WhisperDims,
    _layer_norm,
    _linear,
    _mlp,
    _self_attn,
    _split_heads,
    _vocab_logits,
    embed_tokens,
)
from ..models.whisper_stacked import (
    cross_kv_for_decode,
    decode_step_stacked,
    init_stacked_cache,
    prefill_cache_stacked,
)
from ..ops.attention import multihead_attention


@dataclass(frozen=True)
class DecodeOptions:
    """Decode configuration and the token ids the loop needs."""

    max_new_tokens: int = 224
    min_new_tokens: int = 0  # EOT suppressed below this generated count
    suppress_blank: bool = True
    without_timestamps: bool = True
    temperature: float = 0.0
    eot: int = 50257
    sot: int = 50258
    no_speech: int = 50362
    no_timestamps: int = 50363
    timestamp_begin: int = 50364
    blank_token: int = 220  # " " for the standard GPT-2 vocab


# the first generated timestamp is at most 1.0 s (whisper's default)
MAX_INITIAL_TIMESTAMP_INDEX = 50


def build_suppress_mask(vocab_size: int, suppress_tokens: Sequence[int]) -> np.ndarray:
    """``[V]`` additive f32 mask, -inf at the suppressed ids (out-of-range
    ids are ignored)."""
    mask = np.zeros((vocab_size,), np.float32)
    for t in suppress_tokens:
        if 0 <= t < vocab_size:
            mask[t] = -np.inf
    return mask


def _apply_timestamp_rules(logits, tokens, pos: int, n_prompt: int, opts: DecodeOptions):
    """Whisper's timestamp grammar as logit masking, on ``[B, V]`` f32
    logits for the token at ``pos`` after the history ``tokens[:, :pos]``
    (``[B, L]``, the prompt then the generated tokens): <|notimestamps|>
    never; after a timestamp pair only text, after a lone timestamp only
    timestamps or EOT; no timestamp below the latest generated one; the
    first generated token a timestamp of at most 1.0 s, which counts as a
    pair (text or EOT next); and a timestamp whenever the timestamps'
    total probability beats every text token's.

    The rules read the generated tokens only, as openai-whisper's
    ``ApplyTimestampRules`` does. The JAX package differs twice (ROADMAP,
    queue 3): it reads the prompt for the latest timestamp, so a
    conditioning tail with a stamp past 1.0 s masks every token of its
    first step; and it takes the first timestamp for a lone one, so a
    second timestamp follows it, and every segment the host splits from
    such a window is empty. Elsewhere the two agree."""
    inf = float("-inf")
    v = logits.shape[1]
    ts_begin = opts.timestamp_begin
    logits = logits.clone()
    logits[:, opts.no_timestamps] = inf
    step = pos - n_prompt  # tokens generated so far
    last = tokens[:, max(pos - 1, 0)]
    penult = tokens[:, max(pos - 2, 0)]
    last_was_ts = (last >= ts_begin) & (step >= 1)
    # openai-whisper: ``len(seq) < 2 or seq[-2] >= timestamp_begin``
    penult_was_ts = (penult >= ts_begin) | (step < 2)
    ids = torch.arange(v, device=logits.device)[None, :]
    is_ts = ids >= ts_begin
    is_text = ids < opts.eot
    # pairing
    suppress_ts = (last_was_ts & penult_was_ts)[:, None]
    suppress_text = (last_was_ts & ~penult_was_ts)[:, None]
    logits = logits.masked_fill((suppress_ts & is_ts) | (suppress_text & is_text), inf)
    if step == 0:
        init_cap = ts_begin + MAX_INITIAL_TIMESTAMP_INDEX
        logits = logits.masked_fill(~is_ts | (ids > init_cap), inf)
    else:
        # monotone: no timestamp below the latest generated one
        gen = tokens[:, n_prompt:pos]
        max_ts = torch.where(gen >= ts_begin, gen, ts_begin - 1).amax(dim=1)
        ts_floor = torch.where(last_was_ts & ~penult_was_ts, max_ts, max_ts + 1)
        logits = logits.masked_fill(is_ts & (ids < ts_floor[:, None]), inf)
    # a timestamp is forced when the timestamps together are likelier than
    # the best text token
    logprobs = torch.log_softmax(logits, dim=-1)
    ts_logprob = torch.logsumexp(logprobs.masked_fill(~is_ts, inf), dim=-1)
    max_text_logprob = logprobs.masked_fill(is_ts, inf).amax(dim=-1)
    force_ts = (ts_logprob > max_text_logprob)[:, None]
    return logits.masked_fill(force_ts & ~is_ts, inf)


def _static_filter(suppress_mask: torch.Tensor, opts: DecodeOptions, dev) -> torch.Tensor:
    """The part of the logit filter no step changes: the suppress list and,
    without timestamps, every timestamp and <|notimestamps|>."""
    static = suppress_mask.to(dev).clone()
    if opts.without_timestamps:
        static[opts.timestamp_begin:] = float("-inf")
        static[opts.no_timestamps] = float("-inf")
    return static


def _filter_logits(logits, static, tokens, pos: int, n_prompt: int, opts: DecodeOptions):
    """Filtered f32 logits of the token at ``pos``: the static filter,
    EOT below ``min_new_tokens`` generated tokens, blank and EOT at the
    first step, then the timestamp rules."""
    filt = logits + static
    if pos - n_prompt < opts.min_new_tokens:
        filt[:, opts.eot] = float("-inf")
    if opts.suppress_blank and pos == n_prompt:
        filt[:, opts.blank_token] = float("-inf")
        filt[:, opts.eot] = float("-inf")
    if not opts.without_timestamps:
        filt = _apply_timestamp_rules(filt, tokens, pos, n_prompt, opts)
    return filt


def _prefill(params, audio_features, prompt, dims, opts, dtype, kv_bits, prompt_valid):
    """What both decodes start from: the cross-KV (the int8 decode layout
    at ``kv_bits``, the float form at None), the prompt prefilled at width B into a fresh cache of ``cache_len``
    positions, the hidden state predicting the first new token, the
    no-speech probability (read at the SOT position's output), and the
    left-padding mask and position shift of a conditioning prefix
    (``None`` without ``prompt_valid``)."""
    b, n_prompt = prompt.shape
    dev = audio_features.device
    max_len = n_prompt + opts.max_new_tokens
    audio = audio_features.to(dtype)
    cache_len = min(dims.n_text_ctx, -(-max_len // 128) * 128)
    kv_valid = pos_offset = None
    if prompt_valid is not None:
        valid = prompt_valid.to(device=dev, dtype=torch.bool)
        kv_valid = torch.cat(
            [valid, torch.ones((b, cache_len - n_prompt), dtype=torch.bool, device=dev)], dim=1
        )
        pos_offset = (~valid).sum(dim=1)
    cross_kv = cross_kv_for_decode(params, audio, dims, kv_bits)
    cache = init_stacked_cache(b, dims, dtype, cache_len, dev)
    x_pf, cache = prefill_cache_stacked(
        params, prompt, cache, cross_kv, dims, dtype, kv_valid=kv_valid, pos_offset=pos_offset
    )
    sot_index = (prompt == opts.sot).long().argmax(dim=1)
    x_sot = x_pf[torch.arange(b, device=dev), sot_index]
    no_speech_prob = torch.softmax(_vocab_logits(params["decoder"], x_sot), dim=-1)[:, opts.no_speech]
    return cross_kv, cache, x_pf[:, -1, :], no_speech_prob, kv_valid, pos_offset


def _sample(filt: torch.Tensor, temperature: float, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from ``softmax(filt / temperature)``, by the
    Gumbel-max rule (as ``jax.random.categorical``): a token at -inf is
    never drawn, and a row that is all -inf draws token 0, as its argmax
    does."""
    u = torch.rand(filt.shape, generator=generator, device=filt.device)
    gumbel = -torch.log(-torch.log(u))
    return (filt / temperature + gumbel).argmax(dim=-1)


@torch.inference_mode()
def greedy_decode(
    params,  # stacked form (models.whisper_stacked.stack_decoder_blocks)
    audio_features: torch.Tensor,  # [B, n_audio_ctx, D]
    prompt: torch.Tensor,  # [B, n_prompt] int64
    suppress_mask: torch.Tensor,  # [V] additive f32
    dims: WhisperDims,
    opts: DecodeOptions,
    dtype=torch.bfloat16,
    kv_bits: Optional[int] = 8,  # None: the float cross-KV
    prompt_valid: Optional[torch.Tensor] = None,  # [B, n_prompt] bool
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Batched greedy decode, or sampled at ``opts.temperature > 0`` (from
    ``generator``, on the features' device; seed 0 if none is given).
    Returns (tokens ``[B, L]``, lengths ``[B]``, sum_logprob ``[B]``,
    no_speech_prob ``[B]``, steps): ``tokens`` holds the prompt then the
    generated tokens, ``lengths`` counts generated tokens before EOT,
    ``sum_logprob`` sums the untempered log-probabilities of the picks,
    ``steps`` counts the decode steps run. ``prompt_valid`` marks the real
    slots of a left-padded prompt."""
    b, n_prompt = prompt.shape
    dev = audio_features.device
    max_len = n_prompt + opts.max_new_tokens
    cross_kv, cache, hid, no_speech_prob, kv_valid, pos_offset = _prefill(
        params, audio_features, prompt, dims, opts, dtype, kv_bits, prompt_valid
    )
    if opts.temperature > 0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    static = _static_filter(suppress_mask, opts, dev)
    dec = params["decoder"]
    tokens = torch.zeros((b, max_len), dtype=torch.long, device=dev)
    tokens[:, :n_prompt] = prompt

    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    sum_logprob = torch.zeros(b, dtype=torch.float32, device=dev)
    length = torch.zeros(b, dtype=torch.int32, device=dev)
    rows = torch.arange(b, device=dev)
    steps = 0
    for pos in range(n_prompt, max_len):
        filt = _filter_logits(_vocab_logits(dec, hid), static, tokens, pos, n_prompt, opts)
        if opts.temperature > 0:
            nxt = _sample(filt, opts.temperature, generator)
        else:
            nxt = filt.argmax(dim=-1)
        step_logprob = torch.log_softmax(filt, dim=-1)[rows, nxt]
        nxt = torch.where(finished, opts.eot, nxt)
        sum_logprob += torch.where(finished, 0.0, step_logprob)
        length += (~finished & (nxt != opts.eot)).int()
        finished |= nxt == opts.eot
        tokens[:, pos] = nxt
        if pos + 1 == max_len or bool(finished.all()):
            break
        hid, cache = decode_step_stacked(
            params, nxt, pos, cache, cross_kv, dims, dtype, return_hidden=True,
            kv_valid=kv_valid, pos_offset=pos_offset,
        )  # hidden predicting pos + 1
        steps += 1
    return tokens, length, sum_logprob, no_speech_prob, steps


def top_k_lowest_index(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values of each row of f32 ``x`` ``[N, M]``, in
    descending order, ordered as ``jax.lax.top_k`` orders them: by the
    IEEE total order (+0.0 above -0.0, NaN above +inf), ties to the lower
    index (``torch.topk`` promises no order among ties). Each value maps
    to an int64 key in that order, with the complement of its index in
    the low 32 bits, so every key is distinct."""
    m = x.shape[1]
    bits = x.contiguous().view(torch.int32).long()
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF) * 2**32
    key |= 0xFFFFFFFF - torch.arange(m, device=x.device)
    idx = 0xFFFFFFFF - (torch.topk(key, k, dim=1).values & 0xFFFFFFFF)
    return torch.gather(x, 1, idx), idx


def beam_advance(filt, beam_scores, tokens, anc, finished, pos: int, eot_only, eot: int):
    """One beam selection on ``B·K`` rows: filtered logits ``filt``
    ``[B·K, V]``, scores ``[B, K]``, tokens ``[B·K, L]``, ancestry
    ``[B, K, S]``, finished ``[B·K]`` -> the same, advanced to ``pos``,
    and the new tokens ``[B·K]``. A finished row continues with EOT only,
    at no cost; the top ``K`` of each window's ``K·V`` candidates win."""
    b, k = beam_scores.shape
    n_vocab = filt.shape[1]
    logprobs = torch.where(finished[:, None], eot_only, torch.log_softmax(filt, dim=-1))
    cand = (beam_scores.reshape(b * k, 1) + logprobs).reshape(b, k * n_vocab)
    beam_scores, top_idx = top_k_lowest_index(cand, k)
    src_beam = top_idx // n_vocab  # [B, K]: the lane each winner extends
    new_tok = (top_idx % n_vocab).reshape(b * k)
    src_row = (torch.arange(b, device=filt.device)[:, None] * k + src_beam).reshape(b * k)
    tokens = tokens[src_row]
    tokens[:, pos] = new_tok
    # a lane inherits its source's ancestry; position pos is its own
    anc = torch.gather(anc, 1, src_beam[:, :, None].expand(-1, -1, anc.shape[2]))
    anc[:, :, pos] = torch.arange(k, dtype=anc.dtype, device=anc.device)
    finished = finished[src_row] | (new_tok == eot)
    return beam_scores, tokens, anc, finished, new_tok


@torch.inference_mode()
def beam_decode(
    params,  # stacked form (models.whisper_stacked.stack_decoder_blocks)
    audio_features: torch.Tensor,  # [B, n_audio_ctx, D]
    prompt: torch.Tensor,  # [B, n_prompt] int64
    suppress_mask: torch.Tensor,  # [V] additive f32
    dims: WhisperDims,
    opts: DecodeOptions,
    beam_size: int = 5,
    dtype=torch.bfloat16,
    kv_bits: Optional[int] = 8,  # None: the float cross-KV
    prompt_valid: Optional[torch.Tensor] = None,  # [B, n_prompt] bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Batched beam search (faster-whisper's default, beam 5). Returns
    what :func:`greedy_decode` returns, for the best hypothesis of each
    window: the highest ``sum_logprob / (length + 1)``, the first on
    ties.

    Beams ride the batch axis (``B·K`` rows). The prompt is prefilled
    once at width ``B`` and the cache is then repeated to ``B·K`` rows;
    the cross-KV stays at width ``B``, its window shared by the lanes.
    The cache is never reordered: each row writes its own position and
    ``anc [B, K, S]`` records which lane owns each position of each
    lane's history. Only beam 0 starts alive; a finished beam keeps its
    score and continues with EOT only. A left-padded prompt's mask and
    position shift (``prompt_valid``) repeat to the ``B·K`` rows, so
    kernel E reads one mask row per beam row. Beam search decodes at
    temperature 0 only, as in the JAX package."""
    if opts.temperature > 0:
        raise ValueError("beam search decodes at temperature 0; sampling runs greedy_decode")
    b, n_prompt = prompt.shape
    k = beam_size
    bk = b * k
    dev = audio_features.device
    max_len = n_prompt + opts.max_new_tokens
    cross_kv, cache, hid, no_speech_prob, kv_valid, pos_offset = _prefill(
        params, audio_features, prompt, dims, opts, dtype, kv_bits, prompt_valid
    )
    if kv_valid is not None:
        kv_valid = kv_valid.repeat_interleave(k, dim=0)
        pos_offset = pos_offset.repeat_interleave(k, dim=0)
    static = _static_filter(suppress_mask, opts, dev)
    dec = params["decoder"]
    hid = hid.repeat_interleave(k, dim=0)  # predicts the token at n_prompt
    cache = {name: c.repeat_interleave(k, dim=1) for name, c in cache.items()}
    cache_len = cache["k"].shape[-1]
    tokens = torch.zeros((bk, max_len), dtype=torch.long, device=dev)
    tokens[:, :n_prompt] = prompt.repeat_interleave(k, dim=0)
    beam_scores = torch.zeros((b, k), dtype=torch.float32, device=dev)
    beam_scores[:, 1:] = float("-inf")
    eot_only = torch.full_like(static, float("-inf"))
    eot_only[opts.eot] = 0.0

    finished = torch.zeros(bk, dtype=torch.bool, device=dev)
    anc = torch.arange(k, dtype=torch.int32, device=dev)[None, :, None].repeat(b, 1, cache_len)
    steps = 0
    for pos in range(n_prompt, max_len):
        # tokens holds each lane's own history: beam_advance reorders it
        filt = _filter_logits(_vocab_logits(dec, hid), static, tokens, pos, n_prompt, opts)
        beam_scores, tokens, anc, finished, new_tok = beam_advance(
            filt, beam_scores, tokens, anc, finished, pos, eot_only, opts.eot
        )
        if pos + 1 == max_len or bool(finished.all()):
            break
        hid, cache = decode_step_stacked(
            params, new_tok, pos, cache, cross_kv, dims, dtype, return_hidden=True, anc=anc,
            kv_valid=kv_valid, pos_offset=pos_offset,
        )  # hidden predicting pos + 1
        steps += 1

    # generated tokens before the first EOT; the best length-normalised score
    is_eot = tokens[:, n_prompt:] == opts.eot
    lengths = torch.where(is_eot.any(dim=1), is_eot.int().argmax(dim=1), is_eot.shape[1])
    best = (beam_scores / (lengths.reshape(b, k) + 1).float()).argmax(dim=1)
    pick = torch.arange(b, device=dev) * k + best
    return tokens[pick], lengths[pick].int(), beam_scores.reshape(bk)[pick], no_speech_prob, steps


@torch.inference_mode()
def detect_language(
    params,  # stacked form
    audio_features: torch.Tensor,  # [B, n_audio_ctx, D]
    dims: WhisperDims,
    sot: int,
    language_start: int,
    n_languages: int,
    dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder step from SOT at position 0 -> (language index ``[B]``,
    f32 probabilities ``[B, n_languages]`` over the language-token block).
    As in the JAX package, cross-attention reads float K/V projected from
    the features (no int8 decode layout), in plain torch."""
    dec = params["decoder"]
    b = audio_features.shape[0]
    dev = audio_features.device
    h = dims.n_text_head
    audio = audio_features.to(dtype)
    tok = torch.full((b, 1), sot, dtype=torch.long, device=dev)
    x = embed_tokens(dec, tok, torch.zeros((1, 1), dtype=torch.long, device=dev), dtype)
    for blk in dec["layers"]:
        # one position: self-attention sees only itself
        x = x + _self_attn(blk["attn"], _layer_norm(blk["ln1"], x), h)
        qc = _split_heads(_linear(blk["cross_attn"]["q"], _layer_norm(blk["ln_cross"], x)), h)
        kc = _split_heads(_linear(blk["cross_attn"]["k"], audio), h)
        vc = _split_heads(_linear(blk["cross_attn"]["v"], audio), h)
        cross = multihead_attention(qc, kc, vc).reshape(b, 1, -1)
        x = x + _linear(blk["cross_attn"]["o"], cross)
        x = x + _mlp(blk["mlp_in"], blk["mlp_out"], _layer_norm(blk["ln2"], x))
    logits = _vocab_logits(dec, _layer_norm(dec["ln"], x)[:, 0])
    probs = torch.softmax(logits[:, language_start : language_start + n_languages], dim=-1)
    return probs.argmax(dim=-1), probs

"""Batched greedy and beam decode for Whisper.

Counterpart of ``whisper_nemo_tpu/engine/decode.py`` for temperature-0
decoding without timestamps: the JAX package's ``lax.while_loop`` is an
eager loop here that stops as soon as every window has emitted EOT. The
cross-KV is the int8 decode layout (kernel A on a CUDA tensor); beam
search selects each lane's history through an ancestry map (kernel E).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.whisper import WhisperDims, _vocab_logits
from ..models.whisper_stacked import (
    cross_kv_decode_layout_fused,
    decode_step_stacked,
    init_stacked_cache,
    prefill_cache_stacked,
)


@dataclass(frozen=True)
class DecodeOptions:
    """Decode configuration and the token ids the loop needs."""

    max_new_tokens: int = 224
    suppress_blank: bool = True
    eot: int = 50257
    sot: int = 50258
    no_speech: int = 50362
    no_timestamps: int = 50363
    timestamp_begin: int = 50364
    blank_token: int = 220  # " " for the standard GPT-2 vocab


ROADMAP_NOTE = "not ported yet; see ROADMAP.md, queue 1"


def build_suppress_mask(vocab_size: int, suppress_tokens: Sequence[int]) -> np.ndarray:
    """``[V]`` additive f32 mask, -inf at the suppressed ids (out-of-range
    ids are ignored)."""
    mask = np.zeros((vocab_size,), np.float32)
    for t in suppress_tokens:
        if 0 <= t < vocab_size:
            mask[t] = -np.inf
    return mask


def _prefill(params, audio_features, prompt, suppress_mask, dims, opts, dtype, kv_bits):
    """What both decodes start from: the decode-layout cross-KV, the
    prompt prefilled at width B into a fresh cache of ``cache_len``
    positions, the hidden state predicting the first new token, the
    no-speech probability (read at the SOT position's output) and the
    logit filter that does not depend on the step (no timestamps)."""
    b, n_prompt = prompt.shape
    dev = audio_features.device
    max_len = n_prompt + opts.max_new_tokens
    audio = audio_features.to(dtype)
    cache_len = min(dims.n_text_ctx, -(-max_len // 128) * 128)
    cross_kv = cross_kv_decode_layout_fused(params, audio, dims, bits=kv_bits)
    cache = init_stacked_cache(b, dims, dtype, cache_len, dev)
    x_pf, cache = prefill_cache_stacked(params, prompt, cache, cross_kv, dims, dtype)
    sot_index = (prompt == opts.sot).long().argmax(dim=1)
    x_sot = x_pf[torch.arange(b, device=dev), sot_index]
    no_speech_prob = torch.softmax(_vocab_logits(params["decoder"], x_sot), dim=-1)[:, opts.no_speech]
    static = suppress_mask.to(dev).clone()
    static[opts.timestamp_begin:] = float("-inf")
    static[opts.no_timestamps] = float("-inf")
    return cross_kv, cache, x_pf[:, -1, :], no_speech_prob, static


@torch.inference_mode()
def greedy_decode(
    params,  # stacked form (models.whisper_stacked.stack_decoder_blocks)
    audio_features: torch.Tensor,  # [B, n_audio_ctx, D]
    prompt: torch.Tensor,  # [B, n_prompt] int64
    suppress_mask: torch.Tensor,  # [V] additive f32
    dims: WhisperDims,
    opts: DecodeOptions,
    dtype=torch.bfloat16,
    kv_bits: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Batched greedy decode. Returns (tokens ``[B, L]``, lengths ``[B]``,
    sum_logprob ``[B]``, no_speech_prob ``[B]``, steps): ``tokens`` holds
    the prompt then the generated tokens, ``lengths`` counts generated
    tokens before EOT, ``steps`` the decode steps run."""
    b, n_prompt = prompt.shape
    dev = audio_features.device
    max_len = n_prompt + opts.max_new_tokens
    cross_kv, cache, hid, no_speech_prob, static = _prefill(
        params, audio_features, prompt, suppress_mask, dims, opts, dtype, kv_bits
    )
    dec = params["decoder"]
    tokens = torch.zeros((b, max_len), dtype=torch.long, device=dev)
    tokens[:, :n_prompt] = prompt

    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    sum_logprob = torch.zeros(b, dtype=torch.float32, device=dev)
    length = torch.zeros(b, dtype=torch.int32, device=dev)
    rows = torch.arange(b, device=dev)
    steps = 0
    for pos in range(n_prompt, max_len):
        filt = _vocab_logits(dec, hid) + static
        if opts.suppress_blank and pos == n_prompt:
            filt[:, opts.blank_token] = float("-inf")
            filt[:, opts.eot] = float("-inf")
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
            params, nxt, pos, cache, cross_kv, dims, dtype, return_hidden=True
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
    kv_bits: int = 8,
    prompt_valid: Optional[torch.Tensor] = None,
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
    score and continues with EOT only."""
    if prompt_valid is not None:
        raise NotImplementedError(f"beam search over a conditioning prefix is {ROADMAP_NOTE}")
    b, n_prompt = prompt.shape
    k = beam_size
    bk = b * k
    dev = audio_features.device
    max_len = n_prompt + opts.max_new_tokens
    cross_kv, cache, hid, no_speech_prob, static = _prefill(
        params, audio_features, prompt, suppress_mask, dims, opts, dtype, kv_bits
    )
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
        filt = _vocab_logits(dec, hid) + static
        if opts.suppress_blank and pos == n_prompt:
            filt[:, opts.blank_token] = float("-inf")
            filt[:, opts.eot] = float("-inf")
        beam_scores, tokens, anc, finished, new_tok = beam_advance(
            filt, beam_scores, tokens, anc, finished, pos, eot_only, opts.eot
        )
        if pos + 1 == max_len or bool(finished.all()):
            break
        hid, cache = decode_step_stacked(
            params, new_tok, pos, cache, cross_kv, dims, dtype, return_hidden=True, anc=anc
        )  # hidden predicting pos + 1
        steps += 1

    # generated tokens before the first EOT; the best length-normalised score
    is_eot = tokens[:, n_prompt:] == opts.eot
    lengths = torch.where(is_eot.any(dim=1), is_eot.int().argmax(dim=1), is_eot.shape[1])
    best = (beam_scores / (lengths.reshape(b, k) + 1).float()).argmax(dim=1)
    pick = torch.arange(b, device=dev) * k + best
    return tokens[pick], lengths[pick].int(), beam_scores.reshape(bk)[pick], no_speech_prob, steps

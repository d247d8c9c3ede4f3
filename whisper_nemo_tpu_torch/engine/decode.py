"""Batched greedy decode for Whisper.

Counterpart of ``whisper_nemo_tpu/engine/decode.py`` for temperature-0
decoding without timestamps: the JAX package's ``lax.while_loop`` is an
eager loop here that stops as soon as every window has emitted EOT. The
cross-KV is the int8 decode layout (kernel A on a CUDA tensor).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

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


def build_suppress_mask(vocab_size: int, suppress_tokens: Sequence[int]) -> np.ndarray:
    """``[V]`` additive f32 mask, -inf at the suppressed ids (out-of-range
    ids are ignored)."""
    mask = np.zeros((vocab_size,), np.float32)
    for t in suppress_tokens:
        if 0 <= t < vocab_size:
            mask[t] = -np.inf
    return mask


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
    audio = audio_features.to(dtype)
    cache_len = min(dims.n_text_ctx, -(-max_len // 128) * 128)
    cross_kv = cross_kv_decode_layout_fused(params, audio, dims, bits=kv_bits)
    cache = init_stacked_cache(b, dims, dtype, cache_len, dev)

    tokens = torch.zeros((b, max_len), dtype=torch.long, device=dev)
    tokens[:, :n_prompt] = prompt
    x_pf, cache = prefill_cache_stacked(params, prompt, cache, cross_kv, dims, dtype)
    dec = params["decoder"]
    hid = x_pf[:, -1, :]

    # no-speech probability, read at the SOT position's output
    sot_index = (prompt == opts.sot).long().argmax(dim=1)
    x_sot = x_pf[torch.arange(b, device=dev), sot_index]
    no_speech_prob = torch.softmax(_vocab_logits(dec, x_sot), dim=-1)[:, opts.no_speech]

    # logit filters that do not depend on the step (no timestamps)
    static = suppress_mask.to(dev).clone()
    static[opts.timestamp_begin:] = float("-inf")
    static[opts.no_timestamps] = float("-inf")

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

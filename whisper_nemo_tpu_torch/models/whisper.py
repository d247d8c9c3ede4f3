"""Whisper encoder and shared layers, as functions over a parameter dict.

Counterpart of ``whisper_nemo_tpu/models/whisper.py``. Parameters are the
JAX package's nested dict (``engine/checkpoint.params_from_jax`` converts
a JAX tree array by array): linear weights ``[in, out]`` (``x @ w``), or
int8 ``w_q`` with per-output-channel ``scale``; conv weights in PyTorch's
``[out, in, k]``. Activations run in the compute ``dtype``: the int8
compute type keeps them bf16 (the JAX package's f32 conv bias promotes
its int8 encoder to f32 activations; the port does not follow that).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import multihead_attention

Params = Dict[str, Any]


@dataclass(frozen=True)
class WhisperDims:
    n_mels: int = 80
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4

    @property
    def head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head


# Standard model family dims (public openai-whisper model card values).
WHISPER_DIMS: Dict[str, WhisperDims] = {
    "tiny": WhisperDims(80, 1500, 384, 6, 4, 51865, 448, 384, 6, 4),
    "tiny.en": WhisperDims(80, 1500, 384, 6, 4, 51864, 448, 384, 6, 4),
    "base": WhisperDims(80, 1500, 512, 8, 6, 51865, 448, 512, 8, 6),
    "base.en": WhisperDims(80, 1500, 512, 8, 6, 51864, 448, 512, 8, 6),
    "small": WhisperDims(80, 1500, 768, 12, 12, 51865, 448, 768, 12, 12),
    "small.en": WhisperDims(80, 1500, 768, 12, 12, 51864, 448, 768, 12, 12),
    "medium": WhisperDims(80, 1500, 1024, 16, 24, 51865, 448, 1024, 16, 24),
    "medium.en": WhisperDims(80, 1500, 1024, 16, 24, 51864, 448, 1024, 16, 24),
    "large-v1": WhisperDims(80, 1500, 1280, 20, 32, 51865, 448, 1280, 20, 32),
    "large-v2": WhisperDims(80, 1500, 1280, 20, 32, 51865, 448, 1280, 20, 32),
    "large-v3": WhisperDims(128, 1500, 1280, 20, 32, 51866, 448, 1280, 20, 32),
    "large": WhisperDims(128, 1500, 1280, 20, 32, 51866, 448, 1280, 20, 32),
    "large-v3-turbo": WhisperDims(128, 1500, 1280, 20, 32, 51866, 448, 1280, 20, 4),
    "turbo": WhisperDims(128, 1500, 1280, 20, 32, 51866, 448, 1280, 20, 4),
}


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Sinusoidal position encoding (whisper's exact formulation)."""
    assert channels % 2 == 0
    log_timescale_increment = np.log(10000) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate(
        [np.sin(scaled_time), np.cos(scaled_time)], axis=1
    ).astype(np.float32)


# ---------------------------------------------------------------------------
# initialization (same distributions as the JAX package; different draws)
# ---------------------------------------------------------------------------


def init_whisper_params(
    dims: WhisperDims, device, generator: torch.Generator
) -> Params:
    """Seeded random f32 parameters made on ``device`` from ``generator``
    (which must live on that device)."""

    def uniform(shape, bound):
        x = torch.empty(shape, device=device)
        return x.uniform_(-bound, bound, generator=generator)

    def normal(shape, std):
        return torch.randn(shape, device=device, generator=generator) * std

    def zeros(n):
        return torch.zeros(n, device=device)

    def linear(d_in, d_out, bias=True):
        p = {"w": uniform((d_in, d_out), d_in**-0.5)}
        if bias:
            p["b"] = zeros(d_out)
        return p

    def ln(d):
        return {"g": torch.ones(d, device=device), "b": zeros(d)}

    def block(d, cross):
        p = {
            "ln1": ln(d),
            "attn": {"q": linear(d, d), "k": linear(d, d, bias=False),
                     "v": linear(d, d), "o": linear(d, d)},
            "ln2": ln(d),
            "mlp_in": linear(d, 4 * d),
            "mlp_out": linear(4 * d, d),
        }
        if cross:
            p["ln_cross"] = ln(d)
            p["cross_attn"] = {"q": linear(d, d), "k": linear(d, d, bias=False),
                               "v": linear(d, d), "o": linear(d, d)}
        return p

    d_a, d_t = dims.n_audio_state, dims.n_text_state
    encoder = {
        "conv1": {"w": normal((d_a, dims.n_mels, 3), 0.02), "b": zeros(d_a)},
        "conv2": {"w": normal((d_a, d_a, 3), 0.02), "b": zeros(d_a)},
        "pos": torch.from_numpy(sinusoids(dims.n_audio_ctx, d_a)).to(device),
        "blocks": [block(d_a, False) for _ in range(dims.n_audio_layer)],
        "ln_post": ln(d_a),
    }
    decoder = {
        "tok_emb": normal((dims.n_vocab, d_t), 0.02),
        "pos_emb": normal((dims.n_text_ctx, d_t), 0.01),
        "blocks": [block(d_t, True) for _ in range(dims.n_text_layer)],
        "ln": ln(d_t),
    }
    return {"encoder": encoder, "decoder": decoder}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _layer_norm(p, x, eps=1e-5):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * p["g"] + p["b"]).to(x.dtype)


def _linear(p, x):
    """``x @ w (+ b)``; int8 ``w_q`` dequantizes through its
    per-output-channel ``scale`` after the product. PyTorch returns a
    bf16 product in bf16 where the JAX package keeps an f32 epilogue."""
    if "w_q" in p:
        y = torch.matmul(x, p["w_q"].to(x.dtype)).float() * p["scale"]
    else:
        y = torch.matmul(x, p["w"].to(x.dtype)).float()
    if "b" in p:
        y = y + p["b"]
    return y.to(x.dtype)


def _split_heads(x, n_head):
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head)


def _self_attn(p, x, n_head, mask=None):
    b, t, d = x.shape
    q = _split_heads(_linear(p["q"], x), n_head)
    k = _split_heads(_linear(p["k"], x), n_head)
    v = _split_heads(_linear(p["v"], x), n_head)
    out = multihead_attention(q, k, v, mask).reshape(b, t, d)
    return _linear(p["o"], out)


def _mlp(p_in, p_out, x):
    return _linear(p_out, F.gelu(_linear(p_in, x)))


def _vocab_logits(dec, x):
    """Hidden states -> f32 vocab logits, through the int8 output
    projection when present, else the tied embeddings."""
    if "out_proj_q" in dec:
        q = dec["out_proj_q"]
        return torch.matmul(x, q["w_q"].to(x.dtype)).float() * q["scale"]
    return torch.matmul(x, dec["tok_emb"].t().to(x.dtype)).float()


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def _conv1d(p, x, stride):
    """``[B, C_in, T] -> [B, C_out, T']``; weights ``[C_out, C_in, k]``."""
    y = F.conv1d(x, p["w"].to(x.dtype), stride=stride, padding=1)
    return (y.float() + p["b"][:, None]).to(x.dtype)


def encode(
    params: Params,
    mel: torch.Tensor,
    dims: WhisperDims,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Mel ``[B, n_mels, 2*n_audio_ctx]`` -> audio features
    ``[B, n_audio_ctx, D]`` in ``dtype``."""
    enc = params["encoder"]
    x = mel.to(dtype)
    x = F.gelu(_conv1d(enc["conv1"], x, 1))
    x = F.gelu(_conv1d(enc["conv2"], x, 2)).transpose(1, 2)  # [B, T, D]
    x = x + enc["pos"][: x.shape[1]].to(dtype)
    for blk in enc["blocks"]:
        x = x + _self_attn(blk["attn"], _layer_norm(blk["ln1"], x), dims.n_audio_head)
        x = x + _mlp(blk["mlp_in"], blk["mlp_out"], _layer_norm(blk["ln2"], x))
    return _layer_norm(enc["ln_post"], x)


def causal_mask(n: int, device) -> torch.Tensor:
    """``[1, 1, n, n]`` additive 0 / -inf causal mask."""
    full = torch.full((n, n), float("-inf"), device=device)
    return torch.triu(full, diagonal=1)[None, None]


def embed_tokens(dec: Params, tokens: torch.Tensor, positions, dtype) -> torch.Tensor:
    """Token plus learned position embeddings, in ``dtype``."""
    return (dec["tok_emb"][tokens] + dec["pos_emb"][positions]).to(dtype)

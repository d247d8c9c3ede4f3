"""wav2vec2-style CTC acoustic model, as functions over a parameter dict.

Counterpart of ``whisper_nemo_tpu/models/wav2vec2.py``: the emissions
backbone of forced alignment (MMS-300M-sized at full width). Strided conv
feature extractor -> feature projection -> transformer encoder with a
grouped conv positional embedding -> linear CTC head, in the post-LN
("base") or pre-LN (``do_stable_layer_norm``, the MMS/large) layout.

Parameters are the JAX package's nested dict, converted array by array
(``engine/checkpoint.params_from_jax``): linear weights ``[in, out]``
(``x @ w``); conv weights in PyTorch's ``[out, in, k]`` and the grouped
positional conv's in ``[out, in/groups, k]``. The conv stack and the
linears are plain PyTorch; the encoder's self-attention goes through
``ops/attention.multihead_attention``, so kernel B runs on a CUDA tensor.
``convert_hf_wav2vec2_state_dict`` turns an HF ``Wav2Vec2ForCTC`` state
dict into the JAX package's tree of numpy arrays (``cli/convert.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..engine.readers import as_f32 as _t
from ..ops.attention import multihead_attention
from .whisper import _layer_norm as _ln
from .whisper import _linear

Params = Dict[str, Any]


@dataclass(frozen=True)
class Wav2Vec2Dims:
    vocab_size: int = 32
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Sequence[int] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    # large/MMS variant: pre-LN transformer + per-conv-layer LayerNorm
    # (HF do_stable_layer_norm=True, feat_extract_norm="layer")
    do_stable_layer_norm: bool = False

    @property
    def total_stride(self) -> int:
        s = 1
        for st in self.conv_stride:
            s *= st
        return s


def init_wav2vec2_params(dims: Wav2Vec2Dims, device, generator: torch.Generator) -> Params:
    """Seeded random f32 parameters in the shapes of the JAX package's
    ``init_wav2vec2_params`` (same distributions, different draws), made
    on ``device`` from ``generator`` (which must live on that device)."""
    d = dims.hidden_size

    def normal(shape, std):
        return torch.randn(shape, device=device, generator=generator) * std

    def zeros(n):
        return torch.zeros(n, device=device)

    def lin(d_in, d_out):
        return {"w": normal((d_in, d_out), d_in**-0.5), "b": zeros(d_out)}

    def ln(n):
        return {"g": torch.ones(n, device=device), "b": zeros(n)}

    conv_layers = []
    c_in = 1
    for i, (c_out, k) in enumerate(zip(dims.conv_dim, dims.conv_kernel)):
        layer = {"w": normal((c_out, c_in, k), 1.0 / np.sqrt(k * c_in))}
        if i == 0:
            layer["gn_g"] = torch.ones(c_out, device=device)
            layer["gn_b"] = zeros(c_out)
        conv_layers.append(layer)
        c_in = c_out
    g = dims.num_conv_pos_embedding_groups
    layers = [
        {
            "attn": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d)},
            "attn_ln": ln(d),
            "ff_in": lin(d, dims.intermediate_size),
            "ff_out": lin(dims.intermediate_size, d),
            "ff_ln": ln(d),
        }
        for _ in range(dims.num_layers)
    ]
    return {
        "fe": {"conv_layers": conv_layers},
        "enc": {
            "proj_ln": ln(dims.conv_dim[-1]),
            "proj": lin(dims.conv_dim[-1], d),
            "pos_conv": {"w": normal((d, d // g, dims.num_conv_pos_embeddings), 0.02),
                         "b": zeros(d)},
            "enc_ln": ln(d),
            "layers": layers,
        },
        "lm_head": lin(d, dims.vocab_size),
    }


def _frontend_norm_act(layer, x, first: bool):
    """Bias, then the per-layer LayerNorm over channels or the first
    layer's group norm with groups == channels (over time), then exact
    GELU; ``x`` is ``[B, C, T]``."""
    if "cb" in layer:
        x = x + layer["cb"][:, None]
    if "ln" in layer:
        x = _ln(layer["ln"], x.transpose(1, 2)).transpose(1, 2)
    elif first and "gn_g" in layer:
        x32 = x.float()
        mu = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, unbiased=False, keepdim=True)
        x = ((x32 - mu) * torch.rsqrt(var + 1e-5) * layer["gn_g"][:, None]
             + layer["gn_b"][:, None]).to(x.dtype)
    return F.gelu(x)


def feature_extractor(params, wave: torch.Tensor, dims: Wav2Vec2Dims) -> torch.Tensor:
    """``[B, T]`` raw audio -> ``[B, T', conv_dim[-1]]`` features."""
    x = wave[:, None, :]  # [B, 1, T]
    for i, s in enumerate(dims.conv_stride):
        layer = params["conv_layers"][i]
        x = F.conv1d(x, layer["w"].to(x.dtype), stride=s)
        x = _frontend_norm_act(layer, x, first=(i == 0))
    return x.transpose(1, 2)


def _conv_pos_embedding(p, x, dims: Wav2Vec2Dims) -> torch.Tensor:
    """Grouped conv positional embedding (kernel 128, groups 16) over
    ``[B, T, D]``, cropped by one frame for an even kernel, then GELU."""
    k = dims.num_conv_pos_embeddings
    y = F.conv1d(x.transpose(1, 2), p["w"].to(x.dtype), padding=k // 2,
                 groups=dims.num_conv_pos_embedding_groups)
    y = (y.float() + p["b"][:, None]).to(x.dtype)
    if k % 2 == 0:
        y = y[:, :, :-1]
    return F.gelu(y).transpose(1, 2)


def _mha(p, x, n_heads):
    b, t, d = x.shape
    hd = d // n_heads
    q = _linear(p["q"], x).reshape(b, t, n_heads, hd)
    k = _linear(p["k"], x).reshape(b, t, n_heads, hd)
    v = _linear(p["v"], x).reshape(b, t, n_heads, hd)
    out = multihead_attention(q, k, v).reshape(b, t, d)
    return _linear(p["o"], out)


def encoder(params, feats: torch.Tensor, dims: Wav2Vec2Dims) -> torch.Tensor:
    """Feature projection + transformer encoder, post-LN by default and
    pre-LN with one final norm when ``dims.do_stable_layer_norm``."""
    x = _ln(params["proj_ln"], feats)
    x = _linear(params["proj"], x)
    x = x + _conv_pos_embedding(params["pos_conv"], x, dims)
    if dims.do_stable_layer_norm:
        for blk in params["layers"]:
            x = x + _mha(blk["attn"], _ln(blk["attn_ln"], x), dims.num_heads)
            h = _ln(blk["ff_ln"], x)
            x = x + _linear(blk["ff_out"], F.gelu(_linear(blk["ff_in"], h)))
        return _ln(params["enc_ln"], x)
    x = _ln(params["enc_ln"], x)
    for blk in params["layers"]:
        x = _ln(blk["attn_ln"], x + _mha(blk["attn"], x, dims.num_heads))
        h = _linear(blk["ff_out"], F.gelu(_linear(blk["ff_in"], x)))
        x = _ln(blk["ff_ln"], x + h)
    return x


def ctc_logits(
    params: Params, wave: torch.Tensor, dims: Wav2Vec2Dims, dtype=torch.float32
) -> torch.Tensor:
    """Raw audio ``[B, T]`` -> CTC logits ``[B, T', vocab]`` in f32 (the
    head's product is taken in f32, as the JAX package's f32
    accumulation returns it)."""
    feats = feature_extractor(params["fe"], wave.to(dtype), dims)
    hidden = encoder(params["enc"], feats, dims)
    head = params["lm_head"]
    return torch.matmul(hidden.float(), head["w"].float()) + head["b"].float()


# -- the HF checkpoint converter (counterpart of the JAX module's) -------------


def convert_hf_wav2vec2_state_dict(
    sd: Mapping, dims: Wav2Vec2Dims
) -> Params:
    """HF ``Wav2Vec2ForCTC.state_dict()`` → our param tree."""
    pre = "wav2vec2."
    conv_layers = []
    for i in range(len(dims.conv_dim)):
        layer = {
            # HF conv: [out, in, k] -> [k, in, out]
            "w": _t(
                sd[f"{pre}feature_extractor.conv_layers.{i}.conv.weight"]
            ).transpose(2, 1, 0)
        }
        bkey = f"{pre}feature_extractor.conv_layers.{i}.conv.bias"
        if bkey in sd:
            layer["cb"] = _t(sd[bkey])
        gkey = f"{pre}feature_extractor.conv_layers.{i}.layer_norm.weight"
        if gkey in sd:
            g = _t(sd[gkey])
            b = _t(
                sd[f"{pre}feature_extractor.conv_layers.{i}.layer_norm.bias"]
            )
            if dims.do_stable_layer_norm:
                layer["ln"] = {"g": g, "b": b}
            else:
                layer["gn_g"] = g
                layer["gn_b"] = b
        conv_layers.append(layer)

    def lin(prefix):
        p = {"w": _t(sd[f"{prefix}.weight"]).T}
        if f"{prefix}.bias" in sd:
            p["b"] = _t(sd[f"{prefix}.bias"])
        return p

    def ln(prefix):
        return {
            "g": _t(sd[f"{prefix}.weight"]),
            "b": _t(sd[f"{prefix}.bias"]),
        }

    # conv pos embedding is stored weight-normalized (weight_g/weight_v
    # or parametrizations.* in newer torch)
    base = f"{pre}encoder.pos_conv_embed.conv"
    if f"{base}.weight_g" in sd:
        g = _t(sd[f"{base}.weight_g"])
        v = _t(sd[f"{base}.weight_v"])
    elif f"{base}.parametrizations.weight.original0" in sd:
        g = _t(sd[f"{base}.parametrizations.weight.original0"])
        v = _t(sd[f"{base}.parametrizations.weight.original1"])
    else:
        raise KeyError(f"no weight-normalised {base} (weight_g/weight_v or"
                       " parametrizations.weight.original0/1) in the state dict")
    norm = np.linalg.norm(v, axis=(0, 1), keepdims=True)
    w = g * v / np.maximum(norm, 1e-12)  # [out, in/g, k]
    pos_w = w.transpose(2, 1, 0)  # [k, in/g, out]

    layers = []
    for i in range(dims.num_layers):
        lp = f"{pre}encoder.layers.{i}"
        layers.append(
            {
                "attn": {
                    "q": lin(f"{lp}.attention.q_proj"),
                    "k": lin(f"{lp}.attention.k_proj"),
                    "v": lin(f"{lp}.attention.v_proj"),
                    "o": lin(f"{lp}.attention.out_proj"),
                },
                "attn_ln": ln(f"{lp}.layer_norm"),
                "ff_in": lin(f"{lp}.feed_forward.intermediate_dense"),
                "ff_out": lin(f"{lp}.feed_forward.output_dense"),
                "ff_ln": ln(f"{lp}.final_layer_norm"),
            }
        )
    return {
        "fe": {"conv_layers": conv_layers},
        "enc": {
            "proj_ln": ln(f"{pre}feature_projection.layer_norm"),
            "proj": lin(f"{pre}feature_projection.projection"),
            "pos_conv": {
                "w": pos_w,
                "b": _t(sd[f"{base}.bias"]),
            },
            "enc_ln": ln(f"{pre}encoder.layer_norm"),
            "layers": layers,
        },
        "lm_head": lin("lm_head"),
    }


def dims_from_hf_wav2vec2_config(cfg) -> Wav2Vec2Dims:
    return Wav2Vec2Dims(
        vocab_size=cfg.vocab_size,
        hidden_size=cfg.hidden_size,
        num_layers=cfg.num_hidden_layers,
        num_heads=cfg.num_attention_heads,
        intermediate_size=cfg.intermediate_size,
        conv_dim=tuple(cfg.conv_dim),
        conv_kernel=tuple(cfg.conv_kernel),
        conv_stride=tuple(cfg.conv_stride),
        num_conv_pos_embeddings=cfg.num_conv_pos_embeddings,
        num_conv_pos_embedding_groups=cfg.num_conv_pos_embedding_groups,
        do_stable_layer_norm=getattr(cfg, "do_stable_layer_norm", False),
    )

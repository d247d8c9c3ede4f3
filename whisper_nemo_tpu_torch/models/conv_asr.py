"""The exact Jasper block stack of a converted ``.nemo`` in PyTorch.

Counterpart of ``whisper_nemo_tpu/models/conv_asr.py``. A converted
NeMo VAD or speaker model carries its ``encoder.jasper`` block list in a
``<name>.cfg.json`` sidecar beside the ``.npz``; this module evaluates
that list (dilation, separable convs, squeeze-excite, residuals), so real
weights run the architecture they were trained with. Features are
channel-first, ``[B, n_mels, T]``, and the frame mask ``[B, 1, T]``;
conv weights are PyTorch's ``[out, in/groups, k]``. Batch norm is folded
into a per-channel scale ``g`` and shift ``b``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from .titanet import frame_mask

Params = Dict[str, Any]


@dataclass(frozen=True)
class JasperBlockCfg:
    """One entry of the .nemo ``encoder.jasper`` list."""

    filters: int
    repeat: int = 1
    kernel: int = 1
    dilation: int = 1
    separable: bool = False
    residual: bool = False
    se: bool = False
    se_reduction: int = 8


def _conv1d(unit: Params, x: torch.Tensor, kernel: int, dilation: int = 1,
            groups: int = 1) -> torch.Tensor:
    """'same'-padded conv with the folded batch norm."""
    y = F.conv1d(x, unit["w"], padding=dilation * (kernel - 1) // 2, dilation=dilation,
                 groups=groups)
    return torch.addcmul(unit["b"][:, None], y, unit["g"][:, None])


def _conv_layer(layer: Params, x: torch.Tensor, cfg: JasperBlockCfg) -> torch.Tensor:
    if "dw" in layer:
        x = _conv1d(layer["dw"], x, cfg.kernel, cfg.dilation, groups=x.shape[1])
        return _conv1d(layer["pw"], x, 1)
    return _conv1d(layer["pw"], x, cfg.kernel, cfg.dilation)


def _squeeze_excite(se: Params, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    pooled = (x * mask).sum(dim=-1) / mask.sum(dim=-1).clamp(min=1.0)  # [B, C]
    h = pooled @ se["w1"]
    if "b1" in se:
        h = h + se["b1"]
    g = torch.relu(h) @ se["w2"]
    if "b2" in se:
        g = g + se["b2"]
    return x * torch.sigmoid(g)[:, :, None]


def encode(params: Params, cfgs: Sequence[JasperBlockCfg], feats: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """``[B, n_mels, T]`` -> ``[B, filters[-1], T]``: per block, repeat x
    (conv, batch norm, ReLU) with the last repeat's ReLU after the
    squeeze-excite and the residual, masked after each."""
    x = feats * mask
    for cfg, block in zip(cfgs, params["blocks"]):
        y = x
        layers = block["layers"]
        for layer in layers[:-1]:
            y = torch.relu(_conv_layer(layer, y, cfg)) * mask
        y = _conv_layer(layers[-1], y, cfg)
        if "se" in block:
            y = _squeeze_excite(block["se"], y * mask, mask)
        if "res" in block:
            y = y + _conv1d(block["res"], x, 1)
        x = torch.relu(y) * mask
    return x


def vad_logits(params: Params, cfgs: Sequence[JasperBlockCfg], feats: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Frame classification: ``[B, n_mels, T]`` -> ``[B, T, n_classes]``
    (NeMo's frame-VAD decoder is one 1x1 conv)."""
    if mask is None:
        mask = feats.new_ones((feats.shape[0], 1, feats.shape[2]))
    x = encode(params, cfgs, feats, mask)
    return x.transpose(1, 2) @ params["head"]["w"] + params["head"]["b"]


def speech_probs(params: Params, cfgs: Sequence[JasperBlockCfg], feats: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[B, n_mels, T]`` -> ``[B, T]`` per-frame speech probability."""
    return torch.softmax(vad_logits(params, cfgs, feats, mask), dim=-1)[..., 1]


def attentive_pool(pool: Params, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """NeMo TitaNet's attentive statistics pooling with global context:
    the attention sees ``[x, mean, std]``; ``[B, C, T]`` -> ``[B, 2C]``."""
    denom = mask.sum(dim=-1, keepdim=True).clamp(min=1.0)
    mean = (x * mask).sum(dim=-1, keepdim=True) / denom
    std = (((x - mean).square() * mask).sum(dim=-1, keepdim=True) / denom).clamp(min=1e-10).sqrt()
    ctx = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=1)  # [B, 3C, T]
    a1 = pool["attn1"]
    # the conv keeps its own bias "cb": the ReLU sits between it and the batch norm
    a = torch.relu(torch.matmul(a1["w"][:, :, 0], ctx) + a1["cb"][:, None])
    a = torch.tanh(torch.addcmul(a1["b"][:, None], a, a1["g"][:, None]))
    a = torch.matmul(pool["attn2"]["w"].t(), a) + pool["attn2"]["b"][:, None]  # [B, C, T]
    attn = torch.softmax(a.masked_fill(mask == 0, float("-inf")), dim=-1)
    mu = (attn * x).sum(dim=-1)
    var = (attn * x.square()).sum(dim=-1) - mu.square()
    return torch.cat([mu, var.clamp(min=1e-10).sqrt()], dim=-1)


def speaker_embed(params: Params, cfgs: Sequence[JasperBlockCfg], feats: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """TitaNet's embedding path: encoder, attentive pool, batch norm,
    linear (NeMo's ``emb_layers`` output); ``[B, emb_dim]`` f32."""
    mask = frame_mask(lengths, feats.shape[-1])
    x = encode(params, cfgs, feats.float(), mask)
    pool = params["pool"]
    pooled = attentive_pool(pool, x, mask)
    pooled = torch.addcmul(pool["emb_bn"]["b"], pooled, pool["emb_bn"]["g"])
    emb = pooled @ pool["emb"]["w"]
    if "b" in pool["emb"]:
        emb = emb + pool["emb"]["b"]
    return emb

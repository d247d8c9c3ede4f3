"""ECAPA-TDNN speaker embeddings in PyTorch.

Counterpart of ``whisper_nemo_tpu/models/ecapa.py``: a prologue conv,
three SE-Res2Blocks at dilations 2, 3 and 4, multi-layer feature
aggregation (the blocks' outputs concatenated, a 1x1 conv), context-aware
attentive statistics pooling and a linear embedding. Windows of several
lengths share one padded batch under a frame mask, applied again after
every conv stack, as TitaNet's. Features are channel-first, ``[B, n_mels,
T]``; conv weights are PyTorch's ``[out, in, k]``; batch norm is folded
into a per-channel scale and shift.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F

from .titanet import _masked_mean, _squeeze_excite, frame_mask

Params = Dict[str, Any]


@dataclass(frozen=True)
class EcapaDims:
    n_mels: int = 80
    channels: int = 512
    res2net_scale: int = 8
    se_reduction: int = 8
    dilations: Sequence[int] = (2, 3, 4)
    agg_channels: int = 1536
    attn_hidden: int = 128
    emb_dim: int = 192


def _conv(p: Params, x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """'same' conv with folded batch norm on ``[B, C, T]``."""
    k = p["w"].shape[-1]
    y = F.conv1d(x, p["w"], padding=(k - 1) * dilation // 2, dilation=dilation)
    return torch.addcmul(p["bn_b"][:, None], y, p["bn_g"][:, None])


def _res2net(p: Params, x: torch.Tensor, dilation: int, scale: int) -> torch.Tensor:
    """Channels in ``scale`` groups; each group's conv also sees the
    previous group's output."""
    groups = x.chunk(scale, dim=1)
    outs = [groups[0]]
    for i in range(1, scale):
        outs.append(torch.relu(_conv(p["convs"][i - 1], groups[i] + outs[-1], dilation)))
    return torch.cat(outs, dim=1)


def _se_res2block(p: Params, x: torch.Tensor, mask: torch.Tensor, dilation: int,
                  scale: int) -> torch.Tensor:
    y = torch.relu(_conv(p["in"], x)) * mask
    y = _res2net(p["res2"], y, dilation, scale) * mask
    y = torch.relu(_conv(p["out"], y)) * mask
    return (x + _squeeze_excite(p["se"], y, mask)) * mask


def embed(params: Params, feats: torch.Tensor, lengths: torch.Tensor,
          dims: EcapaDims) -> torch.Tensor:
    """``[B, n_mels, T]`` features with ``[B]`` valid frame counts ->
    ``[B, emb_dim]`` speaker embeddings."""
    mask = frame_mask(lengths, feats.shape[-1])
    x = torch.relu(_conv(params["prologue"], feats * mask)) * mask
    block_outs = []
    for block, dilation in zip(params["blocks"], dims.dilations):
        x = _se_res2block(block, x, mask, dilation, dims.res2net_scale)
        block_outs.append(x)
    agg = torch.relu(_conv(params["agg"], torch.cat(block_outs, dim=1))) * mask

    # context-aware attention: each frame's features beside the utterance's
    # mean and std; the context's third of the first layer is applied once
    # per utterance instead of once per frame
    mu = _masked_mean(agg, mask)
    sd = _masked_mean(((agg - mu[:, :, None]) * mask).square(), mask).clamp(min=1e-8).sqrt()
    attn = params["attn"]
    c = agg.shape[1]
    w1 = attn["w1"]
    context = torch.cat([mu, sd], dim=1) @ w1[c:] + attn["b1"]  # [B, hidden]
    h = torch.tanh(torch.matmul(w1[:c].t(), agg) + context[:, :, None])
    scores = torch.matmul(attn["w2"].t(), h) + attn["b2"][:, None]
    weights = torch.softmax(scores.masked_fill(mask == 0, float("-inf")), dim=-1)
    mean = (weights * agg).sum(dim=-1)
    std = (weights * (agg - mean[:, :, None]).square()).sum(dim=-1).clamp(min=1e-8).sqrt()
    return torch.cat([mean, std], dim=-1) @ params["emb"]["w"] + params["emb"]["b"]


def init_ecapa_params(dims: EcapaDims, device, generator: torch.Generator) -> Params:
    """Seeded random f32 parameters on ``device`` from ``generator``
    (which must live on that device), at the JAX package's shapes and
    scales (conv weights in PyTorch's layout)."""

    def normal(shape, fan_in):
        return torch.randn(shape, device=device, generator=generator) / fan_in**0.5

    def zeros(n):
        return torch.zeros(n, device=device)

    def conv(k, c_in, c_out):
        return {"w": normal((c_out, c_in, k), k * c_in),
                "bn_g": torch.ones(c_out, device=device), "bn_b": zeros(c_out)}

    def lin(c_in, c_out):
        return normal((c_in, c_out), c_in), zeros(c_out)

    c = dims.channels
    group = c // dims.res2net_scale
    blocks = []
    for _ in dims.dilations:
        w1, b1 = lin(c, c // dims.se_reduction)
        w2, b2 = lin(c // dims.se_reduction, c)
        blocks.append({"in": conv(1, c, c),
                       "res2": {"convs": [conv(3, group, group)
                                          for _ in range(dims.res2net_scale - 1)]},
                       "out": conv(1, c, c),
                       "se": {"w1": w1, "b1": b1, "w2": w2, "b2": b2}})
    aw1, ab1 = lin(3 * dims.agg_channels, dims.attn_hidden)
    aw2, ab2 = lin(dims.attn_hidden, dims.agg_channels)
    ew, eb = lin(2 * dims.agg_channels, dims.emb_dim)
    return {"prologue": conv(5, dims.n_mels, c), "blocks": blocks,
            "agg": conv(1, len(dims.dilations) * c, dims.agg_channels),
            "attn": {"w1": aw1, "b1": ab1, "w2": aw2, "b2": ab2},
            "emb": {"w": ew, "b": eb}}

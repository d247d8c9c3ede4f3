"""TitaNet-style speaker embeddings in PyTorch.

Counterpart of ``whisper_nemo_tpu/models/titanet.py``: a prologue
separable conv, mega-blocks of separable convs with squeeze-excite and a
projected residual, an epilogue conv, attentive statistics pooling and a
linear projection. Windows of several lengths share one padded batch
under a frame mask; the activations are masked again after every conv
stack, so a window's embedding does not depend on its padding. Features
are channel-first, ``[B, n_mels, T]``; conv weights are PyTorch's
``[out, in/groups, k]``. Batch norm is folded into a per-channel scale
and shift.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


@dataclass(frozen=True)
class TitaNetDims:
    n_mels: int = 80
    filters: Sequence[int] = (1024, 1024, 1024, 1024, 3072)
    kernels: Sequence[int] = (3, 7, 11, 15, 1)
    repeat: int = 3
    se_reduction: int = 16
    attn_hidden: int = 128
    emb_dim: int = 192


def _conv(p: Params, x: torch.Tensor, kernel: int, groups: int = 1) -> torch.Tensor:
    y = F.conv1d(x, p["w"], padding=kernel // 2, groups=groups)
    return torch.addcmul(p["bn_b"][:, None], y, p["bn_g"][:, None])


def _sep_conv_block(p: Params, x: torch.Tensor, kernel: int) -> torch.Tensor:
    return _conv(p["pw"], _conv(p["dw"], x, kernel, groups=x.shape[1]), 1)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``[B, C, T]`` -> ``[B, C]`` mean over the frames ``mask`` keeps."""
    return (x * mask).sum(dim=-1) / mask.sum(dim=-1).clamp(min=1.0)


def _squeeze_excite(p: Params, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    h = torch.relu(_masked_mean(x, mask) @ p["w1"] + p["b1"])
    return x * torch.sigmoid(h @ p["w2"] + p["b2"])[:, :, None]


def encoder(params: Params, feats: torch.Tensor, mask: torch.Tensor,
            dims: TitaNetDims) -> torch.Tensor:
    """``[B, n_mels, T]``, ``[B, 1, T]`` mask -> ``[B, filters[-1], T]``."""
    x = torch.relu(_sep_conv_block(params["prologue"], feats, dims.kernels[0])) * mask
    for bi, block in enumerate(params["blocks"]):
        residual = _conv(block["res"], x, 1)
        y = x
        for layer in block["layers"]:
            y = torch.relu(_sep_conv_block(layer, y, dims.kernels[bi + 1])) * mask
        x = torch.relu(_squeeze_excite(block["se"], y, mask) + residual)
    return torch.relu(_conv(params["epilogue"], x, dims.kernels[-1])) * mask


def attentive_stats_pool(p: Params, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Attention-weighted mean and std over the valid frames, one
    attention per channel: ``[B, C, T]`` -> ``[B, 2C]``."""
    h = torch.tanh(torch.matmul(p["w1"].t(), x) + p["b1"][:, None])
    scores = torch.matmul(p["w2"].t(), h) + p["b2"][:, None]
    attn = torch.softmax(scores.masked_fill(mask == 0, float("-inf")), dim=-1)
    mean = (attn * x).sum(dim=-1)
    var = (attn * (x - mean[:, :, None]).square()).sum(dim=-1)
    return torch.cat([mean, var.clamp(min=1e-8).sqrt()], dim=-1)


def frame_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """``[B]`` valid frame counts -> ``[B, 1, t]`` f32 mask."""
    return (torch.arange(t, device=lengths.device) < lengths[:, None]).float()[:, None]


def embed(params: Params, feats: torch.Tensor, lengths: torch.Tensor,
          dims: TitaNetDims) -> torch.Tensor:
    """Speaker embeddings ``[B, emb_dim]`` of windows ``[B, n_mels, T]``
    whose first ``lengths`` frames are valid; f32."""
    feats = feats.float()
    mask = frame_mask(lengths, feats.shape[-1])
    x = encoder(params, feats * mask, mask, dims)
    pooled = attentive_stats_pool(params["pool"], x, mask)
    return pooled @ params["emb"]["w"] + params["emb"]["b"]


def init_titanet_params(dims: TitaNetDims, device, generator: torch.Generator) -> Params:
    """Seeded random f32 parameters on ``device`` from ``generator``
    (which must live on that device), scaled as the JAX package's."""

    def normal(shape, fan_in):
        return torch.randn(shape, device=device, generator=generator) / fan_in**0.5

    def zeros(n):
        return torch.zeros(n, device=device)

    def conv(c_in, c_out, k, groups=1):
        return {"w": normal((c_out, c_in // groups, k), k * c_in / groups),
                "bn_g": torch.ones(c_out, device=device), "bn_b": zeros(c_out)}

    def sep(c_in, c_out, k):
        return {"dw": conv(c_in, c_in, k, groups=c_in), "pw": conv(c_in, c_out, 1)}

    c = dims.filters[0]
    prologue = sep(dims.n_mels, c, dims.kernels[0])
    blocks = []
    for bi, c_out in enumerate(dims.filters[1:-1], start=1):
        layers = [sep(c if i == 0 else c_out, c_out, dims.kernels[bi])
                  for i in range(dims.repeat)]
        r = c_out // dims.se_reduction
        se = {"w1": normal((c_out, r), c_out), "b1": zeros(r),
              "w2": normal((r, c_out), r), "b2": zeros(c_out)}
        blocks.append({"layers": layers, "se": se, "res": conv(c, c_out, 1)})
        c = c_out
    epilogue = conv(c, dims.filters[-1], dims.kernels[-1])
    c = dims.filters[-1]
    pool = {"w1": normal((c, dims.attn_hidden), c), "b1": zeros(dims.attn_hidden),
            "w2": normal((dims.attn_hidden, c), dims.attn_hidden), "b2": zeros(c)}
    emb = {"w": normal((2 * c, dims.emb_dim), 2 * c), "b": zeros(dims.emb_dim)}
    return {"prologue": prologue, "blocks": blocks, "epilogue": epilogue,
            "pool": pool, "emb": emb}

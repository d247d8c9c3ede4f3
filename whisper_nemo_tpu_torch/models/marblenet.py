"""MarbleNet-style frame VAD in PyTorch.

Counterpart of ``whisper_nemo_tpu/models/marblenet.py``: a prologue
separable conv, blocks of separable convs with a residual where the
widths match, an epilogue, and a per-frame two-class head, over the whole
utterance in one pass. Features are channel-first, ``[B, n_mels, T]``;
conv weights are PyTorch's ``[out, in/groups, k]``
(``engine/checkpoint.params_from_jax``). Batch norm is folded into a
per-channel scale and shift.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


@dataclass(frozen=True)
class MarbleNetDims:
    n_mels: int = 64
    filters: Sequence[int] = (128, 64, 64, 64)
    kernels: Sequence[int] = (11, 13, 15, 17)
    repeat: int = 2
    head_hidden: int = 128


def _sep_conv(p: Params, x: torch.Tensor, kernel: int) -> torch.Tensor:
    """Depthwise (time) then pointwise (channel) conv, 'same' padding,
    folded batch norm."""
    y = F.conv1d(x, p["dw"], padding=kernel // 2, groups=x.shape[1])
    y = F.conv1d(y, p["pw"])
    return torch.addcmul(p["bn_b"][:, None], y, p["bn_g"][:, None])


def frame_logits(params: Params, feats: torch.Tensor, dims: MarbleNetDims) -> torch.Tensor:
    """``[B, n_mels, T]`` log-mel features -> ``[B, T, 2]`` frame logits."""
    x = torch.relu(_sep_conv(params["prologue"], feats, dims.kernels[0]))
    for bi, block in enumerate(params["blocks"]):
        residual = x
        for layer in block["layers"]:
            x = torch.relu(_sep_conv(layer, x, dims.kernels[bi + 1]))
        if residual.shape[1] == x.shape[1]:
            x = x + residual
    x = torch.relu(_sep_conv(params["epilogue"], x, dims.kernels[-1]))
    head = params["head"]
    h = torch.relu(x.transpose(1, 2) @ head["w1"] + head["b1"])
    return h @ head["w2"] + head["b2"]


def speech_probs(params: Params, feats: torch.Tensor, dims: MarbleNetDims) -> torch.Tensor:
    """``[B, n_mels, T]`` -> ``[B, T]`` per-frame speech probability."""
    return torch.softmax(frame_logits(params, feats, dims), dim=-1)[..., 1]


def init_marblenet_params(dims: MarbleNetDims, device, generator: torch.Generator) -> Params:
    """Seeded random f32 parameters on ``device`` from ``generator``
    (which must live on that device), scaled as the JAX package's."""

    def normal(shape, fan_in):
        return torch.randn(shape, device=device, generator=generator) / fan_in**0.5

    def sep(c_in, c_out, k):
        return {"dw": normal((c_in, 1, k), k), "pw": normal((c_out, c_in, 1), c_in),
                "bn_g": torch.ones(c_out, device=device),
                "bn_b": torch.zeros(c_out, device=device)}

    c = dims.filters[0]
    prologue = sep(dims.n_mels, c, dims.kernels[0])
    blocks = []
    for bi, c_out in enumerate(dims.filters[1:], start=1):
        layers = []
        for _ in range(dims.repeat):
            layers.append(sep(c, c_out, dims.kernels[bi]))
            c = c_out
        blocks.append({"layers": layers})
    head = {"w1": normal((c, dims.head_hidden), c),
            "b1": torch.zeros(dims.head_hidden, device=device),
            "w2": normal((dims.head_hidden, 2), dims.head_hidden),
            "b2": torch.zeros(2, device=device)}
    return {"prologue": prologue, "blocks": blocks,
            "epilogue": sep(c, c, dims.kernels[-1]), "head": head}

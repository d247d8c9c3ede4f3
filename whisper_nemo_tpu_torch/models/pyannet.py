"""PyanNet (pyannote segmentation) in PyTorch.

Counterpart of ``whisper_nemo_tpu/models/pyannet.py``: a SincNet front end
(a band-pass filter bank, materialized by the converter into an ordinary
conv weight, then a conv stack with instance norms and max pools), a
stacked bidirectional LSTM, a linear stack and a per-frame powerset
classifier over local speakers. Conv weights are PyTorch's ``[out, in,
k]`` (``engine/checkpoint.params_from_jax``); everything else keeps the
converter's layout:

  {"wav_norm": {"g", "b"}, "convs": [{"w", "b"?}, ...], "norms": [{"g", "b"}, ...],
   "lstm": [{"fwd": {"wx", "wh", "b"}, "bwd": {...}}, ...],
   "linear": [{"w", "b"}, ...], "classifier": {"w", "b"}}

An LSTM direction's ``wx`` is ``[in, 4H]`` and ``wh`` ``[H, 4H]``, gates in
the order i, f, g, o with one bias: the order of ``torch.lstm`` (cuDNN's
on the card), which takes them transposed with a zero second bias.
"""

from __future__ import annotations

from itertools import combinations
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]

# SincNet geometry (pyannote.audio's default: stride 10, kernel 251, 80
# filters; conv1 and conv2 are 5 wide, each stage max-pools by 3)
SINC_KERNEL = 251
SINC_STRIDE = 10
POOL = 3


def _instance_norm(p: Params, x: torch.Tensor) -> torch.Tensor:
    """InstanceNorm1d (affine, no running statistics) on ``[B, C, T]``."""
    return F.instance_norm(x, weight=p["g"], bias=p["b"], eps=1e-5)


def sincnet(params: Params, waveform: torch.Tensor) -> torch.Tensor:
    """``[B, T]`` samples -> ``[B, 60, T']`` frame features (270-sample hop)."""
    x = _instance_norm(params["wav_norm"], waveform[:, None, :])
    for i, (conv, norm) in enumerate(zip(params["convs"], params["norms"])):
        x = F.conv1d(x, conv["w"], conv.get("b"), stride=SINC_STRIDE if i == 0 else 1)
        if i == 0:  # SincNet takes the magnitude of the filter bank's response
            x = x.abs()
        x = F.max_pool1d(x, POOL)
        x = F.leaky_relu(_instance_norm(norm, x))
    return x


def lstm_weights(layers: List[Params]) -> List[torch.Tensor]:
    """The converter's BiLSTM layers -> ``torch.lstm``'s flat weight list:
    per layer, forward then backward, ``w_ih [4H, in]``, ``w_hh [4H, H]``,
    ``b_ih``, ``b_hh`` (zero). Both take the gates as i, f, g, o."""
    out = []
    for layer in layers:
        for d in (layer["fwd"], layer["bwd"]):
            out += [d["wx"].t().contiguous(), d["wh"].t().contiguous(), d["b"],
                    torch.zeros_like(d["b"])]
    return out


def _bilstm(layers: List[Params], x: torch.Tensor) -> torch.Tensor:
    """Stacked bidirectional LSTM: ``[B, T, F]`` -> ``[B, T, 2H]``, each
    layer's forward and backward outputs concatenated in that order."""
    h0 = x.new_zeros((2 * len(layers), x.shape[0], layers[0]["fwd"]["wh"].shape[0]))
    out, _, _ = torch.lstm(x, (h0, h0), lstm_weights(layers), True, len(layers), 0.0, False,
                           True, True)
    return out


def frame_logits(params: Params, waveform: torch.Tensor) -> torch.Tensor:
    """``[B, T]`` samples -> ``[B, T', n_classes]`` powerset logits."""
    x = _bilstm(params["lstm"], sincnet(params, waveform).transpose(1, 2))
    for lin in params["linear"]:
        x = F.leaky_relu(x @ lin["w"] + lin["b"])
    return x @ params["classifier"]["w"] + params["classifier"]["b"]


def powerset_table(n_speakers: int = 3, max_simultaneous: int = 2) -> np.ndarray:
    """Powerset class -> speaker multilabel map ``[n_classes, n_speakers]``,
    classes in pyannote's order (by set size, then lexicographic): for
    (3, 2) the empty set, {0}, {1}, {2}, {0,1}, {0,2}, {1,2}."""
    rows = []
    for size in range(max_simultaneous + 1):
        for combo in combinations(range(n_speakers), size):
            row = np.zeros(n_speakers, np.float32)
            row[list(combo)] = 1.0
            rows.append(row)
    return np.stack(rows)


def speaker_activity(params: Params, waveform: torch.Tensor, n_speakers: int = 3,
                     max_simultaneous: int = 2) -> torch.Tensor:
    """``[B, T]`` samples -> ``[B, T', n_speakers]``: the most likely
    powerset class of each frame as speaker activity."""
    table = torch.from_numpy(powerset_table(n_speakers, max_simultaneous)).to(waveform.device)
    return table[frame_logits(params, waveform).argmax(dim=-1)]


def speech_probs(params: Params, waveform: torch.Tensor) -> torch.Tensor:
    """``[B, T]`` samples -> ``[B, T']`` probability that any speaker is
    active: the posterior mass off the empty class (class 0)."""
    return 1.0 - torch.softmax(frame_logits(params, waveform), dim=-1)[..., 0]


def frames_per_second(sample_rate: int = 16000) -> float:
    """The front end's frame rate: stride 10 and three pools of 3, a hop
    of 270 samples."""
    return sample_rate / (SINC_STRIDE * POOL**3)


def init_pyannet_params(device, generator: torch.Generator, n_classes: int = 7,
                        lstm_layers: int = 4, hidden: int = 128) -> Params:
    """Seeded random f32 parameters on ``device`` from ``generator``
    (which must live on that device), at the JAX package's shapes and
    scales (conv weights in PyTorch's layout)."""

    def normal(shape, scale):
        return torch.randn(shape, device=device, generator=generator) * scale

    def zeros(n):
        return torch.zeros(n, device=device)

    def lin(i, o):
        return {"w": normal((i, o), i**-0.5), "b": zeros(o)}

    def lstm_dir(i, h):
        return {"wx": normal((i, 4 * h), i**-0.5), "wh": normal((h, 4 * h), h**-0.5),
                "b": zeros(4 * h)}

    convs = [{"w": normal((80, 1, SINC_KERNEL), 0.02)},
             {"w": normal((60, 80, 5), 1 / 20.0), "b": zeros(60)},
             {"w": normal((60, 60, 5), 1 / 17.0), "b": zeros(60)}]
    norms = [{"g": torch.ones(c, device=device), "b": zeros(c)} for c in (80, 60, 60)]
    lstm, f_in = [], 60
    for _ in range(lstm_layers):
        lstm.append({"fwd": lstm_dir(f_in, hidden), "bwd": lstm_dir(f_in, hidden)})
        f_in = 2 * hidden
    return {"wav_norm": {"g": torch.ones(1, device=device), "b": zeros(1)},
            "convs": convs, "norms": norms, "lstm": lstm,
            "linear": [lin(2 * hidden, hidden), lin(hidden, hidden)],
            "classifier": lin(hidden, n_classes)}

"""pyannote segmentation checkpoint -> models/pyannet param trees.

Counterpart of ``whisper_nemo_tpu/engine/pyannote_weights.py``, array for
array. pyannote ships ``pyannote/segmentation-3.0`` as a torch/lightning
checkpoint (``pytorch_model.bin``: a dict wrapping ``state_dict``), read
by ``engine/readers.load_pickled`` (lightning's and pyannote's classes
stay stubs). The PyanNet weights map mechanically (conv layout
transpose, LSTM gate transpose) except the SincConv front-end, whose
parameters are per-filter corner frequencies (``low_hz_``,
``band_hz_``), not a conv weight. At inference the filters are a fixed
function of those frequencies, so ``materialize_sinc_filters`` evaluates
the SincNet band-pass formula (Ravanelli & Bengio, "Speaker Recognition
from Raw Waveform with SincNet", as asteroid-filterbanks' ParamSincFB)
once at conversion time, in numpy as the JAX package does, and stores an
ordinary [k, 1, n] conv weight.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from .readers import load_pickled, state_dict_of

Params = Dict[str, Any]


def materialize_sinc_filters(
    low_hz: np.ndarray,  # [n_filters, 1]
    band_hz: np.ndarray,  # [n_filters, 1]
    kernel_size: int = 251,
    sample_rate: int = 16000,
    min_low_hz: float = 50.0,
    min_band_hz: float = 50.0,
) -> np.ndarray:
    """SincNet parameters → conv weight [kernel, 1, n_filters]."""
    low = min_low_hz + np.abs(low_hz)  # [N, 1]
    high = np.clip(
        low + min_band_hz + np.abs(band_hz), min_low_hz, sample_rate / 2
    )
    band = (high - low)[:, 0]  # [N]

    n_lin = np.linspace(0, kernel_size / 2 - 1, kernel_size // 2)
    window = 0.54 - 0.46 * np.cos(2 * np.pi * n_lin / kernel_size)
    n = (kernel_size - 1) / 2.0
    n_ = 2 * np.pi * np.arange(-n, 0)[None, :] / sample_rate  # [1, k//2]

    f_low = low @ n_  # [N, k//2]
    f_high = high @ n_
    left = ((np.sin(f_high) - np.sin(f_low)) / (n_ / 2)) * window[None, :]
    center = 2 * band[:, None]
    filters = np.concatenate(
        [left, center, np.flip(left, axis=1)], axis=1
    ) / (2 * band[:, None])
    # [N, k] → WIO [k, 1, N]
    return np.ascontiguousarray(filters.T[:, None, :]).astype(np.float32)


def extract_pyannote(path: str) -> Dict[str, np.ndarray]:
    """Load a pyannote checkpoint and return a flat numpy state dict
    (unwraps the lightning ``state_dict`` and any ``model.`` prefix)."""
    sd = state_dict_of(load_pickled(path))
    out = {}
    for k, v in sd.items():
        if k.startswith("model."):
            k = k[len("model.") :]
        out[k] = v.detach().cpu().float().numpy()
    return out


def _t_conv(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))


def _t_lin(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def _lstm_dir(sd: Dict[str, np.ndarray], layer: int, suffix: str) -> Params:
    return {
        "wx": _t_lin(sd[f"lstm.weight_ih_l{layer}{suffix}"]),
        "wh": _t_lin(sd[f"lstm.weight_hh_l{layer}{suffix}"]),
        "b": sd[f"lstm.bias_ih_l{layer}{suffix}"]
        + sd[f"lstm.bias_hh_l{layer}{suffix}"],
    }


def convert_pyannet(sd: Dict[str, np.ndarray]) -> Params:
    """pyannote PyanNet state dict → models/pyannet param tree."""
    # SincConv frequencies live under the asteroid Encoder; accept both
    # the pyannote 3.x layout and a bare SincNet one
    low = band = None
    for prefix in ("sincnet.conv1d.0.filterbank.",
                   "sincnet.conv1d.0.", "sincnet.sinc."):
        if f"{prefix}low_hz_" in sd:
            low = sd[f"{prefix}low_hz_"]
            band = sd[f"{prefix}band_hz_"]
            break
    if low is None:
        raise ValueError(
            "no SincConv low_hz_/band_hz_ tensors found (keys: "
            + ", ".join(sorted(k for k in sd if "sinc" in k)[:8]) + ")"
        )
    convs: List[Params] = [{"w": materialize_sinc_filters(low, band)}]
    for i in (1, 2):
        convs.append(
            {"w": _t_conv(sd[f"sincnet.conv1d.{i}.weight"]),
             "b": sd[f"sincnet.conv1d.{i}.bias"]}
        )
    norms = [
        {"g": sd[f"sincnet.norm1d.{i}.weight"],
         "b": sd[f"sincnet.norm1d.{i}.bias"]}
        for i in range(3)
    ]

    lstm = []
    layer = 0
    while f"lstm.weight_ih_l{layer}" in sd:
        lstm.append(
            {"fwd": _lstm_dir(sd, layer, ""),
             "bwd": _lstm_dir(sd, layer, "_reverse")}
        )
        layer += 1
    if not lstm:
        raise ValueError("no lstm.weight_ih_l0 tensor in state dict")

    linear = []
    li = 0
    while f"linear.{li}.weight" in sd:
        linear.append(
            {"w": _t_lin(sd[f"linear.{li}.weight"]),
             "b": sd[f"linear.{li}.bias"]}
        )
        li += 1

    return {
        "wav_norm": {"g": sd["sincnet.wav_norm1d.weight"],
                     "b": sd["sincnet.wav_norm1d.bias"]},
        "convs": convs,
        "norms": norms,
        "lstm": lstm,
        "linear": linear,
        "classifier": {"w": _t_lin(sd["classifier.weight"]),
                       "b": sd["classifier.bias"]},
    }

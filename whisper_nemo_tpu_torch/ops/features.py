"""NeMo-style log-mel features for the diarization models.

Counterpart of ``whisper_nemo_tpu/ops/features.py``: frames of 400
samples (25 ms) at a hop of 160 (10 ms) over the signal reflect-padded by
200, a periodic Hann window of 400 at the start of a 512-point DFT, the
power spectrum through the slaney mel bank, a natural log floored at
2^-24, and optionally a per-feature mean/variance normalization over the
utterance. Frame ``i`` starts at padded sample ``160·i``, so the
power spectrum is the JAX package's frame by frame. The JAX package cuts
long signals into blocks of 100,000 frames for the TPU's memory; the
result does not depend on the cut, and the card takes an hour in one call.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .framing import frame_signal
from .mel import mel_filter_bank

SAMPLE_RATE = 16000
WIN_LENGTH = 400  # 25 ms
HOP_LENGTH = 160  # 10 ms
N_FFT = 512


@functools.lru_cache(maxsize=8)
def _constants(n_mels: int, device: torch.device):
    """(the Hann window [400], the mel bank [257, n_mels]) on ``device``."""
    hann = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(WIN_LENGTH) / WIN_LENGTH))
    fb = mel_filter_bank(N_FFT // 2 + 1, n_mels, SAMPLE_RATE)
    return (torch.from_numpy(hann.astype(np.float32)).to(device),
            torch.from_numpy(fb).to(device))


def log_mel_features(
    waveform: torch.Tensor, n_mels: int = 80, normalize: bool = True
) -> torch.Tensor:
    """``[T]`` or ``[B, T]`` f32 waveform -> ``[B?, n_frames, n_mels]``
    log-mel features on the waveform's device, with
    ``n_frames = T // 160 + 1``."""
    squeeze = waveform.ndim == 1
    x = waveform.float()
    if squeeze:
        x = x[None]
    pad = WIN_LENGTH // 2
    if x.shape[-1] > pad:
        x = torch.nn.functional.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    else:  # reflected again at each end, as numpy's reflect pad does
        idx = np.pad(np.arange(x.shape[-1]), pad, mode="reflect")
        x = x[:, torch.from_numpy(idx).to(x.device)]
    window, fb = _constants(n_mels, x.device)
    n_frames = (x.shape[-1] - WIN_LENGTH) // HOP_LENGTH + 1
    frames = frame_signal(x, n_frames, WIN_LENGTH, HOP_LENGTH) * window
    spec = torch.fft.rfft(frames, n=N_FFT)
    power = spec.real.square() + spec.imag.square()
    feats = torch.log(torch.clamp(power @ fb, min=2.0**-24))
    if normalize:
        mu = feats.mean(dim=1, keepdim=True)
        sd = feats.std(dim=1, keepdim=True, unbiased=False)
        feats = (feats - mu) / (sd + 1e-5)
    return feats[0] if squeeze else feats

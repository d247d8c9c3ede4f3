"""Whisper log-mel front end in PyTorch.

Counterpart of ``whisper_nemo_tpu/ops/mel.py``: the windowed DFT and the
mel filter bank as two matrix products with an elementwise square in
between, then whisper's dynamic-range compression (n_fft 400, hop 160,
periodic Hann, slaney mel). The batched form is plain tensor work, as it
was XLA work in the JAX package; the JAX package's single-window Pallas
tile (``_log_mel_pallas``) is not ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000


def _hz_to_mel_slaney(freq):
    freq = np.asarray(freq, dtype=np.float64)
    mels = freq * 3.0 / 200.0
    log_region = freq >= 1000.0
    return np.where(
        log_region,
        15.0 + np.log(np.maximum(freq, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
        mels,
    )


def _mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    freq = mels * 200.0 / 3.0
    log_region = mels >= 15.0
    return np.where(
        log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (mels - 15.0)), freq
    )


@functools.lru_cache(maxsize=8)
def mel_filter_bank(
    n_freqs: int = N_FFT // 2 + 1,
    n_mels: int = 80,
    sample_rate: int = SAMPLE_RATE,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular mel filter bank
    ``[n_freqs, n_mels]``, matching whisper/librosa defaults."""
    fmax = fmax if fmax is not None else sample_rate / 2.0
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(
        _hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2
    )
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]  # [n_mels+2, n_freqs]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))  # [n_mels, n_freqs]
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.T.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _dft_mel_constants(n_fft: int, n_mels: int):
    """Hann-windowed DFT matrices C, S ``[n_fft, n_freqs]`` and the mel
    bank ``[n_freqs, n_mels]`` as numpy constants:
    C[j, k] = w[j]·cos(2πjk/n), S[j, k] = -w[j]·sin(2πjk/n)."""
    n_freqs = n_fft // 2 + 1
    j = np.arange(n_fft)[:, None]
    k = np.arange(n_freqs)[None, :]
    angle = 2.0 * np.pi * j * k / n_fft
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    cos_m = (window[:, None] * np.cos(angle)).astype(np.float32)
    sin_m = (window[:, None] * -np.sin(angle)).astype(np.float32)
    return cos_m, sin_m, mel_filter_bank(n_freqs, n_mels)


def _finalize(logmel: torch.Tensor) -> torch.Tensor:
    """Whisper dynamic-range compression: clamp to (max − 8), scale;
    the max is taken per leading (window) index."""
    maxval = logmel.amax(dim=(-2, -1), keepdim=True)
    return (torch.maximum(logmel, maxval - 8.0) + 4.0) / 4.0


def log_mel_spectrogram_batch(
    waveforms: torch.Tensor, n_mels: int = 80
) -> torch.Tensor:
    """``[B, T]`` equal-length waveforms -> ``[B, n_mels, T // hop]`` f32
    log-mel, normalized per window, on the waveforms' device."""
    dev = waveforms.device
    cos_m, sin_m, fb = (
        torch.from_numpy(c).to(dev) for c in _dft_mel_constants(N_FFT, n_mels)
    )
    w = waveforms.float()
    n_frames = w.shape[-1] // HOP_LENGTH
    padded = torch.nn.functional.pad(
        w[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect"
    )[:, 0]
    frames = padded.unfold(-1, N_FFT, HOP_LENGTH)[:, :n_frames]
    re = frames @ cos_m
    im = frames @ sin_m
    mel = (re * re + im * im) @ fb
    logmel = torch.log10(torch.clamp(mel, min=1e-10))
    return _finalize(logmel).transpose(-1, -2)

"""Whisper log-mel front end in PyTorch.

Counterpart of ``whisper_nemo_tpu/ops/mel.py``: the windowed DFT and the
mel filter bank as two matrix products with an elementwise square in
between, then whisper's dynamic-range compression (n_fft 400, hop 160,
periodic Hann, slaney mel). The batched form is plain tensor work, as it
was XLA work in the JAX package.

Kernel C (``csrc/log_mel.cu``) replaces the TPU kernel
``whisper_nemo_tpu/ops/mel.py:_log_mel_pallas``, which the single-window
:func:`log_mel_spectrogram` runs (the sequential path's window, language
detection). The function needs little: a 400-point real FFT a frame and
a bank that touches each bin at most twice, so it is bound by its bytes
(the waveform in and the mel out, 2.9 MB a 30 s window at 80 mels). This
kernel runs the DFT as two dense f32 products instead (1.06 GFLOP a
window), with TF32 off, as the JAX reference on the CPU is full f32; an
FFT is work for later. One CTA per tile of 32 frames reads the frames
straight from the waveform, reflect padding by index, so the ``[3000,
400]`` frame matrix is never built; the cosine and sine bases stream through shared
memory in chunks of 8 rows, ``re`` and ``im`` accumulate in registers
with f32 FMAs, and the power spectrum goes to shared memory for the mel
product and ``log10``. ``_log_mel_plain`` is its plain version: the CPU
path and the kernel's oracle. ``_finalize`` stays plain torch, as it is
XLA outside the Pallas call in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

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


@functools.lru_cache(maxsize=8)
def _device_constants(device: torch.device, n_mels: int):
    """C, S and the mel bank as contiguous f32 tensors on ``device``,
    made once (the numpy mel bank is a transpose)."""
    return tuple(
        torch.from_numpy(np.ascontiguousarray(c)).to(device) for c in _dft_mel_constants(N_FFT, n_mels)
    )


def _log_mel_plain(waveforms: torch.Tensor, n_mels: int) -> torch.Tensor:
    """``[B, T]`` waveforms -> un-normalized ``log10(max(mel, 1e-10))``
    ``[B, T // hop, n_mels]`` f32: reflect-pad by ``n_fft / 2``, frames at
    hop 160, ``frames·C``, ``frames·S``, ``re² + im²``, ``· fb``."""
    cos_m, sin_m, fb = _device_constants(waveforms.device, n_mels)
    w = waveforms.float()
    n_frames = w.shape[-1] // HOP_LENGTH
    padded = torch.nn.functional.pad(
        w[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect"
    )[:, 0]
    frames = padded.unfold(-1, N_FFT, HOP_LENGTH)[:, :n_frames]
    re = frames @ cos_m
    im = frames @ sin_m
    mel = (re * re + im * im) @ fb
    return torch.log10(torch.clamp(mel, min=1e-10))


@functools.lru_cache(maxsize=1)
def _kernel():
    fn = _build.load("log_mel").wnt_log_mel
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _log_mel_cuda(waveforms: torch.Tensor, n_mels: int) -> torch.Tensor:
    """Launch kernel C on ``[B, T]`` f32 CUDA waveforms: the contract of
    :func:`_log_mel_plain`."""
    if waveforms.device.type != "cuda":
        raise ValueError(f"kernel C takes a waveform on a CUDA device, got {waveforms.device}")
    if waveforms.dtype != torch.float32:
        raise TypeError(f"kernel C takes an f32 waveform, got {waveforms.dtype}")
    if not waveforms.is_contiguous():
        raise ValueError("kernel C takes a contiguous waveform")
    if waveforms.ndim != 2 or not 0 < waveforms.shape[0] <= 65535 or waveforms.shape[1] <= N_FFT // 2:
        raise ValueError(
            f"kernel C takes [B, T] waveforms with 0 < B <= 65535 and T > {N_FFT // 2}"
            f" (reflect padding), got {tuple(waveforms.shape)}"
        )
    if not 0 < n_mels <= 1024:
        raise ValueError(f"kernel C takes 1 to 1024 mel bands, got {n_mels}")
    cos_m, sin_m, fb = _device_constants(waveforms.device, n_mels)
    b, t = waveforms.shape
    n_frames = t // HOP_LENGTH
    out = torch.empty((b, n_frames, n_mels), dtype=torch.float32, device=waveforms.device)
    rc = _kernel()(
        waveforms.data_ptr(), cos_m.data_ptr(), sin_m.data_ptr(), fb.data_ptr(), out.data_ptr(),
        b, t, n_frames, n_mels, _build.stream(waveforms.device),
    )
    _build.check(rc, "log_mel")
    log_mel_raw.launches += 1
    return out


def log_mel_raw(waveforms: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """Un-normalized log10 mel ``[B, T // hop, n_mels]`` f32 of ``[B, T]``
    f32 waveforms: kernel C on a CUDA tensor, the plain version on a CPU
    tensor."""
    if waveforms.device.type == "cpu":
        return _log_mel_plain(waveforms, n_mels)
    return _log_mel_cuda(waveforms, n_mels)


log_mel_raw.launches = 0


def log_mel_spectrogram(waveform: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """Log-mel features ``[n_mels, T // hop]`` of one 16 kHz waveform
    ``[T]`` (already padded or trimmed, whisper's 30 s = 480000), on the
    waveform's device: kernel C on a CUDA tensor, then whisper's
    dynamic-range compression."""
    logmel = log_mel_raw(waveform.float().contiguous()[None], n_mels)
    return _finalize(logmel)[0].transpose(0, 1)


def log_mel_spectrogram_batch(
    waveforms: torch.Tensor, n_mels: int = 80
) -> torch.Tensor:
    """``[B, T]`` equal-length waveforms -> ``[B, n_mels, T // hop]`` f32
    log-mel, normalized per window, on the waveforms' device (plain
    tensor work on every device)."""
    return _finalize(_log_mel_plain(waveforms, n_mels)).transpose(-1, -2)

"""Whisper log-mel front end in PyTorch.

Counterpart of ``whisper_nemo_tpu/ops/mel.py``: a Hann-windowed spectrum
of 400-sample frames at hop 160, the power, the slaney mel bank, then
whisper's dynamic-range compression. The JAX package computes it as two
matrix products with an elementwise square in between; the plain
version here, ``_log_mel_plain``, does the same: it is the CPU path and
the oracle of kernel C.

Kernel C (``csrc/log_mel.cu``) replaces the TPU kernel
``whisper_nemo_tpu/ops/mel.py:_log_mel_pallas``. On a CUDA tensor both
forms run it: the single-window :func:`log_mel_spectrogram` (the
sequential path's window, language detection) and the batched
:func:`log_mel_spectrogram_batch` (the batched path's windows), which the
JAX package runs as XLA products. The function needs little: a 400-point
real FFT a frame and a bank that touches each bin at most twice, so it
is bound by its bytes (the waveform in and the mel out, 2.9 MB a 30 s
window at 80 mels). The kernel runs that FFT as a 200-point complex FFT
and a real split, the 200 points as 8 x 25 on a team of 8 threads a
frame (each thread's 25-point DFT in registers), with the window and
twiddles from :func:`_fft_tables`, then sums each band's nonzero run of
the bank only (:func:`_mel_bands`). ``_finalize`` stays plain torch,
as it is XLA outside the Pallas call in the JAX package.
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
def _dft_mel_constants(n_fft: int, n_mels: int, dtype=np.float32):
    """Hann-windowed DFT matrices C, S ``[n_fft, n_freqs]`` and the mel
    bank ``[n_freqs, n_mels]`` as numpy constants of ``dtype``, computed
    in float64: C[j, k] = w[j]·cos(2πjk/n), S[j, k] = -w[j]·sin(2πjk/n)."""
    n_freqs = n_fft // 2 + 1
    j = np.arange(n_fft)[:, None]
    k = np.arange(n_freqs)[None, :]
    angle = 2.0 * np.pi * j * k / n_fft
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    cos_m = (window[:, None] * np.cos(angle)).astype(dtype)
    sin_m = (window[:, None] * -np.sin(angle)).astype(dtype)
    return cos_m, sin_m, mel_filter_bank(n_freqs, n_mels).astype(dtype)


def _finalize(logmel: torch.Tensor) -> torch.Tensor:
    """Whisper dynamic-range compression: clamp to (max − 8), scale;
    the max is taken per leading (window) index."""
    maxval = logmel.amax(dim=(-2, -1), keepdim=True)
    return (torch.maximum(logmel, maxval - 8.0) + 4.0) / 4.0


@functools.lru_cache(maxsize=8)
def _device_constants(device: torch.device, n_mels: int, dtype=torch.float32):
    """C, S and the mel bank as contiguous tensors of ``dtype`` (f32 or
    float64) on ``device``, made once (the numpy mel bank is a
    transpose)."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return tuple(
        torch.from_numpy(np.ascontiguousarray(c)).to(device)
        for c in _dft_mel_constants(N_FFT, n_mels, np_dtype)
    )


@functools.lru_cache(maxsize=1)
def _fft_tables():
    """Kernel C's periodic Hann window ``[n_fft]`` and twiddles
    ``[n_fft, 2]`` = (cos, -sin)(2πk/n_fft), computed in float64 and
    rounded once to f32. Every twiddle the kernel takes is one of these,
    with W_n = exp(-2πi/n): W_25^(bc) inside its 25-point DFTs is entry
    16bc, W_200^(nk) between the 25- and the 8-point DFTs entry 2nk, the
    real split's W_400^k entry k."""
    k = np.arange(N_FFT, dtype=np.float64)
    angle = 2.0 * np.pi * k / N_FFT
    window = (0.5 * (1.0 - np.cos(angle))).astype(np.float32)
    twiddles = np.stack([np.cos(angle), -np.sin(angle)], axis=-1).astype(np.float32)
    return window, twiddles


@functools.lru_cache(maxsize=8)
def _mel_bands(n_mels: int):
    """The mel bank by its nonzero runs: ``bands`` int32 ``[n_mels, 2]``,
    band m's first nonzero bin ``lo`` and its end ``hi`` (``lo = hi = 0``
    for a band with none), and ``weights`` f32 ``[n_mels, width]``, band
    m's run ``fb[lo:hi, m]`` from column 0, zeros after it (``width`` the
    longest run, at least 1). A slaney band is a triangle, so its
    nonzeros are one run and the weights are the bank's own."""
    fb = mel_filter_bank(N_FFT // 2 + 1, n_mels).T  # [n_mels, n_freqs]
    nonzero = fb != 0
    has = nonzero.any(axis=1)
    lo = np.where(has, nonzero.argmax(axis=1), 0)
    hi = np.where(has, fb.shape[1] - nonzero[:, ::-1].argmax(axis=1), 0)
    weights = np.zeros((n_mels, max(1, int((hi - lo).max()))), np.float32)
    for m in range(n_mels):
        weights[m, : hi[m] - lo[m]] = fb[m, lo[m] : hi[m]]
    return np.stack([lo, hi], axis=1).astype(np.int32), weights


@functools.lru_cache(maxsize=8)
def _kernel_constants(device: torch.device, n_mels: int):
    """Kernel C's tables on ``device``, made once: the window, the
    twiddles, the band table and the band weights transposed to
    ``[width, n_mels]`` (a warp's lanes, on neighbouring bands, then read
    neighbouring weights)."""
    bands, weights = _mel_bands(n_mels)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(c)).to(device)
        for c in (*_fft_tables(), bands, weights.T)
    )


def _log_mel_plain(waveforms: torch.Tensor, n_mels: int, dtype=torch.float32) -> torch.Tensor:
    """``[B, T]`` waveforms -> un-normalized ``log10(max(mel, 1e-10))``
    ``[B, T // hop, n_mels]`` f32: reflect-pad by ``n_fft / 2``, frames at
    hop 160, ``frames·C``, ``frames·S``, ``re² + im²``, ``· fb``. With
    ``dtype=torch.float64`` the same formula in float64, over bases
    computed in float64 and the bank's f32 weights: a near-exact
    reference for the checks (its result is float64)."""
    cos_m, sin_m, fb = _device_constants(waveforms.device, n_mels, dtype)
    w = waveforms.to(dtype)
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
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
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
    window, twiddles, bands, weights = _kernel_constants(waveforms.device, n_mels)
    b, t = waveforms.shape
    n_frames = t // HOP_LENGTH
    out = torch.empty((b, n_frames, n_mels), dtype=torch.float32, device=waveforms.device)
    rc = _kernel()(
        waveforms.data_ptr(), window.data_ptr(), twiddles.data_ptr(), bands.data_ptr(),
        weights.data_ptr(), out.data_ptr(), b, t, n_frames, n_mels, _build.stream(waveforms.device),
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
    log-mel, normalized per window, on the waveforms' device: one launch
    of kernel C on a CUDA tensor, the plain version on a CPU tensor."""
    logmel = log_mel_raw(waveforms.float().contiguous(), n_mels)
    return _finalize(logmel).transpose(-1, -2)

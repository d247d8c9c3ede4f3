"""Minimal host-side WAV read/write.

A copy of ``whisper_nemo_tpu/audio/wav.py``, carried so that the
port imports nothing of the JAX package.

Replaces ``torchaudio.save`` in the mono handoff to the diarization
branch (reference diarize.py:188-196: 16 kHz mono float tensor written as
``temp_outputs/mono_file.wav``). Uses the stdlib ``wave`` module with
16-bit PCM, which every downstream consumer (including the reference
NeMo stack) accepts.
"""

from __future__ import annotations

import wave

import numpy as np


def write_wav(path: str, waveform: np.ndarray, sample_rate: int = 16000) -> None:
    """Write a mono float32 waveform in [-1, 1] as 16-bit PCM WAV."""
    data = np.asarray(waveform, dtype=np.float32).reshape(-1)
    pcm = np.clip(data, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a PCM WAV into a mono float32 waveform in [-1, 1].

    Multi-channel input is averaged down to mono. Supports 16/32-bit int
    and 8-bit unsigned PCM.
    """
    with wave.open(path, "rb") as w:
        n_channels = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width: {width}")
    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    return data, rate

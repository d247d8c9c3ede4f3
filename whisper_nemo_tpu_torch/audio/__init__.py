"""Audio input: PCM WAV files.

The JAX package decodes every format through its native libav decoder
(``whisper_nemo_tpu/audio/decode.py``), which the port does not carry
yet (ROADMAP.md queue 1, item 3). Until then a path must name a PCM
``.wav``; it is read with ``audio/wav.read_wav`` and resampled linearly,
as the JAX package's decoder does for WAV without libav.
"""

from __future__ import annotations

import os

import numpy as np

from .wav import read_wav, write_wav

__all__ = ["decode_audio", "read_wav", "write_wav"]


def decode_audio(path: str, sampling_rate: int = 16000) -> np.ndarray:
    """A PCM ``.wav`` file -> mono float32 waveform at ``sampling_rate``;
    any other extension raises ``NotImplementedError``."""
    if os.path.splitext(str(path))[1].lower() != ".wav":
        raise NotImplementedError(
            f"{path}: the port reads PCM .wav files only; other formats need the"
            " libav decoder, which is not ported yet (ROADMAP.md queue 1, item 3)"
        )
    wave, rate = read_wav(str(path))
    if rate != sampling_rate:
        n_out = int(round(len(wave) * sampling_rate / rate))
        x_out = np.arange(n_out, dtype=np.float64) * (rate / sampling_rate)
        wave = np.interp(x_out, np.arange(len(wave), dtype=np.float64), wave).astype(np.float32)
    return wave

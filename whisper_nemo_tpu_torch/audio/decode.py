"""Audio decode front door (ctypes binding to the C++ libav decoder).

A copy of ``whisper_nemo_tpu/audio/decode.py``, carried so that the
port imports nothing of the JAX package.

``decode_audio(path)`` keeps the faster-whisper contract the reference
relies on (diarize.py:125): float32 mono waveform at 16 kHz as a numpy
array. The heavy lifting happens in ``native/decoder.cc`` (libavformat/
libavcodec/swresample in-process — no ffmpeg subprocess). The shared
library is built on demand with the Makefile next to the source.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libwnt_audio.so")

_lib = None
_lib_lock = threading.Lock()


class AudioDecodeError(RuntimeError):
    pass


def _build_library() -> None:
    subprocess.run(
        ["make", "-C", _NATIVE_DIR],
        check=True,
        capture_output=True,
    )


def _load_library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH):
            _build_library()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.wnt_decode_audio.restype = ctypes.c_int
        lib.wnt_decode_audio.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_char_p,
            ctypes.c_int,
        ]
        lib.wnt_free.restype = None
        lib.wnt_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.wnt_probe_duration.restype = ctypes.c_double
        lib.wnt_probe_duration.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_int,
        ]
        _lib = lib
        return lib


def native_decoder_available() -> bool:
    """True when the libav shared library is loadable (built on demand).

    Platforms without the libav toolchain (e.g. Windows CI) fall back
    to the pure-python PCM-WAV path; non-WAV inputs then raise."""
    try:
        _load_library()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def _decode_wav_fallback(path: str, sampling_rate: int) -> np.ndarray:
    """PCM-WAV decode + linear resample without the native library."""
    from .wav import read_wav

    wave, rate = read_wav(path)
    if rate != sampling_rate:
        n_out = int(round(len(wave) * sampling_rate / rate))
        x_out = np.arange(n_out, dtype=np.float64) * (rate / sampling_rate)
        wave = np.interp(
            x_out, np.arange(len(wave), dtype=np.float64), wave
        ).astype(np.float32)
    return wave


def decode_audio(path: str, sampling_rate: int = 16000) -> np.ndarray:
    """Decode any supported audio file to mono float32.

    Contract of ``faster_whisper.decode_audio`` (reference diarize.py:125)
    and of pydub's mono conversion (nemo_process.py:24-28): returns a 1-D
    ``np.float32`` waveform resampled to ``sampling_rate``.
    """
    try:
        lib = _load_library()
    except (OSError, subprocess.CalledProcessError) as exc:
        if path.lower().endswith(".wav"):
            return _decode_wav_fallback(path, sampling_rate)
        raise AudioDecodeError(
            f"native audio decoder unavailable ({exc}) and {path!r} is "
            "not a PCM WAV — install libav dev libraries to decode "
            "compressed formats"
        ) from exc
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    errbuf = ctypes.create_string_buffer(512)
    rc = lib.wnt_decode_audio(
        os.fsencode(path),
        sampling_rate,
        ctypes.byref(out),
        ctypes.byref(n),
        errbuf,
        len(errbuf),
    )
    if rc != 0:
        raise AudioDecodeError(
            f"decoding {path!r} failed (rc={rc}):"
            f" {errbuf.value.decode(errors='replace')}"
        )
    try:
        samples = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    finally:
        lib.wnt_free(out)
    return samples


def probe_duration(path: str) -> float:
    """Container-reported duration in seconds (−1.0 if unknown)."""
    try:
        lib = _load_library()
    except (OSError, subprocess.CalledProcessError):
        if path.lower().endswith(".wav"):
            import wave as wave_mod

            with wave_mod.open(path, "rb") as w:
                return w.getnframes() / w.getframerate()
        return -1.0
    errbuf = ctypes.create_string_buffer(512)
    return lib.wnt_probe_duration(os.fsencode(path), errbuf, len(errbuf))

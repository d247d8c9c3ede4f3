# A copy of ``whisper_nemo_tpu/audio/__init__.py``, carried so that the
# port imports nothing of the JAX package.
from .decode import AudioDecodeError, decode_audio, probe_duration
from .wav import read_wav, write_wav

__all__ = [
    "AudioDecodeError",
    "decode_audio",
    "probe_duration",
    "read_wav",
    "write_wav",
]

# A copy of ``whisper_nemo_tpu/utils/__init__.py``, carried so that the
# port imports nothing of the JAX package.
from .cleanup import cleanup
from .logging import get_logger

__all__ = ["cleanup", "get_logger"]

# A copy of ``whisper_nemo_tpu/compat/__init__.py``, carried so that the
# port imports nothing of the JAX package.

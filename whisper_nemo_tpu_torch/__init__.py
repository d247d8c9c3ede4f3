"""whisper_nemo_tpu_torch — the PyTorch/CUDA port of whisper_nemo_tpu.

It mirrors the JAX package's layout (``ops/cross_decode.py`` beside
``whisper_nemo_tpu/ops/cross_decode.py``, and so on) and is held against
it in ``tests/test_torch_*.py``. It imports ``torch`` and nothing of JAX
or of the JAX package; the few jax-free host modules it needs
(``text/``, ``vad/binarize.py``, the host text modules of ``align/``) are
carried as copies (as are ``config.py``, ``audio/wav.py`` and
``diarize/{rttm,segments,metrics}.py``).

What runs: Whisper ASR through the faster-whisper facade
(``asr.faster_whisper_api``), batched or sequential (timestamps, the
temperature ladder, conditioning on the previous text, language
detection), beam 5 by default or greedy; the openai-whisper facade
(``asr.openai_api``) and streaming (``engine.streaming``) over the
sequential path; word alignment of the segments (``align``: wav2vec2
emissions, batched CTC Viterbi); and NeMo-style diarization
(``diarize``: VAD, multiscale TitaNet embeddings, NME-SC spectral
clustering, MSDD; plain torch, no kernel). Six hand-written CUDA kernels for Hopper
build from ``csrc/`` at first use (``ops/_build.py``): decode-step
cross-attention (``ops/cross_decode.py``), encoder self-attention
(``ops/attention.py``), the single-window log-mel (``ops/mel.py``), the
batched Viterbi (``ops/ctc.py``), beam decode self-attention over an
ancestry map (``ops/self_decode.py``) and the beam cache permute
(``ops/beam_permute.py``, an op no path calls).
"""

__version__ = "0.1.0"

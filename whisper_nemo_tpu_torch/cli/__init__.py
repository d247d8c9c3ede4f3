"""The diarized-transcription CLI flow (``cli/flow.py``); run it with
``python -m whisper_nemo_tpu_torch.cli -a <audio> [flags]``."""

"""Checkpoints, quantization, greedy decode and batched long-form transcription."""

"""Kernels and tensor ops: attention, cross- and self-attention decode, beam permute,
mel, framing, CTC, and the diarization models' log-mel features."""

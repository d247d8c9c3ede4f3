"""Kernels and tensor ops: attention, cross- and self-attention decode, beam permute,
mel, framing, CTC, the diarization models' log-mel features, and the polyphase
resample."""

"""Kernels and tensor ops: attention, cross-attention decode, mel, framing."""

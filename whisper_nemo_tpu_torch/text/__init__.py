"""Whisper tokenizer and language tables (copies of the JAX package's)."""

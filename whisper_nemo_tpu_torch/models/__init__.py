"""Whisper encoder and the layer-stacked decoder."""

"""Whisper encoder and the layer-stacked decoder; the wav2vec2 aligner; the
diarization models (MarbleNet, TitaNet, the Jasper stacks of converted
.nemo checkpoints, MSDD)."""

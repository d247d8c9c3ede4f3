"""ctc-forced-aligner–compatible API over the port's alignment stack.

Counterpart of ``whisper_nemo_tpu/align/api.py``. The six functions the
reference CLI consumes:

    model, tokenizer = load_alignment_model(device, dtype)
    emissions, stride = generate_emissions(model, waveform, batch_size)
    tokens_starred, text_starred = preprocess_text(text, romanize, language)
    segments, scores, blank_token = get_alignments(emissions,
                                                   tokens_starred, tokenizer)
    spans = get_spans(tokens_starred, segments, blank_token)
    word_timestamps = postprocess_results(text_starred, spans,
                                          stride, scores)

``word_timestamps`` rows carry ``text``/``start``/``end``/``score`` in
seconds. The model lives on an explicit device ("cuda", "cuda:N" or
"cpu"); the waveform goes to it once per call.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..engine.checkpoint import cast_floats, resolve_aligner
from ..models.wav2vec2 import Wav2Vec2Dims, ctc_logits
from ..ops.ctc import add_star_column, forced_align, label_segments
from .text import preprocess_text  # noqa: F401  (re-exported API surface)

logger = logging.getLogger(__name__)

SAMPLE_RATE = 16000
CHUNK_SECONDS = 30


def default_vocab() -> dict:
    """Character CTC vocabulary: blank + lowercase letters + digits +
    apostrophe + word-boundary + ``<star>`` wildcard (last index)."""
    symbols = ["<blank>"] + list("abcdefghijklmnopqrstuvwxyz") + list(
        "0123456789"
    ) + ["'", "|"]
    vocab = {s: i for i, s in enumerate(symbols)}
    vocab["<star>"] = len(vocab)  # matches the appended star column
    return vocab


class AlignmentTokenizer:
    """Maps words to character label ids for the CTC head."""

    def __init__(self, vocab: Optional[dict] = None):
        self.vocab = vocab or default_vocab()
        self.blank_id = self.vocab["<blank>"]
        self.star_id = self.vocab["<star>"]

    def word_to_ids(self, word: str) -> List[int]:
        if word == "<star>":
            return [self.star_id]
        ids = [self.vocab[c] for c in word if c in self.vocab]
        return ids if ids else [self.star_id]

    def get_vocab(self) -> dict:
        return dict(self.vocab)


@dataclass
class AlignmentModel:
    params: dict
    dims: Wav2Vec2Dims
    dtype: torch.dtype
    device: torch.device


def load_alignment_model(
    device="cuda", dtype=None, seed: int = 1
) -> Tuple[AlignmentModel, AlignmentTokenizer]:
    """Resolve the aligner acoustic model (MMS-style wav2vec2 CTC) on
    ``device`` ("cuda", "cuda:N" or "cpu"; there is no "auto").

    Checkpoint: ``<cache>/ctc_aligner.npz``; otherwise a random init from
    ``seed`` made on the device (logged). ``dtype`` "bfloat16" or
    "float16" stores the weights and runs the model in bf16, anything
    else in f32."""
    if device == "auto":
        raise ValueError('device must be explicit: "cuda", "cuda:N" or "cpu"')
    device = torch.device(device)
    tokenizer = AlignmentTokenizer()
    vocab_size = len(tokenizer.vocab) - 1  # star column appended at runtime
    if os.environ.get("WNT_TEST_SMALL_MODELS"):
        dims = Wav2Vec2Dims(
            vocab_size=vocab_size,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            intermediate_size=128,
            conv_dim=(32,) * 7,
        )
    else:
        # MMS-300M-scale acoustic model (the reference aligner's size):
        # 24-layer / 1024-wide wav2vec2 in the large/MMS layout (pre-LN
        # encoder)
        dims = Wav2Vec2Dims(
            vocab_size=vocab_size,
            hidden_size=1024,
            num_layers=24,
            num_heads=16,
            intermediate_size=4096,
            do_stable_layer_norm=True,
        )
    generator = torch.Generator(device=device).manual_seed(seed)
    params = resolve_aligner(dims, device, generator)
    tdtype = torch.bfloat16 if dtype in ("float16", "bfloat16") else torch.float32
    if tdtype == torch.bfloat16:
        # the weights are stored in the compute dtype
        params = cast_floats(params, torch.bfloat16)
    return AlignmentModel(params, dims, tdtype, device), tokenizer


@torch.inference_mode()
def generate_emissions(
    model: AlignmentModel,
    waveform,
    batch_size: int = 8,
    device: bool = False,
):
    """Waveform -> (log-prob emissions [T, V], stride in ms per frame).

    Audio is processed as batched 30 s chunks; the trailing chunk is
    zero-padded and its emissions trimmed proportionally. Chunk rows are
    padded up to the batch multiple, so every batch has one shape.
    ``device=True`` returns the emissions as a tensor on the model's
    device; otherwise as host numpy.
    """
    chunk = CHUNK_SECONDS * SAMPLE_RATE
    wave = torch.as_tensor(waveform).to(model.device, torch.float32)
    n_samples = wave.shape[0]
    n_chunks = max(1, int(np.ceil(n_samples / chunk)))
    n_rows = int(np.ceil(n_chunks / batch_size)) * batch_size
    chunks = F.pad(wave, (0, n_rows * chunk - n_samples)).reshape(n_rows, chunk)
    pieces = [
        torch.log_softmax(ctc_logits(model.params, chunks[i : i + batch_size],
                                     model.dims, model.dtype), dim=-1)
        for i in range(0, n_rows, batch_size)
    ]
    emissions = torch.cat(pieces, dim=0)  # [>= n_chunks, T_c, V]
    t_per_chunk = emissions.shape[1]
    emissions = emissions[:n_chunks].reshape(-1, emissions.shape[-1])

    total_frames = (
        int(round(n_samples / chunk * t_per_chunk))
        if n_samples % chunk
        else emissions.shape[0]
    )
    emissions = emissions[: max(total_frames, 1)]
    stride_ms = n_samples / emissions.shape[0] / SAMPLE_RATE * 1000
    if not device:
        emissions = emissions.cpu().numpy()
    return emissions, stride_ms


def get_alignments(
    emissions: np.ndarray,
    tokens_starred: Sequence[str],
    tokenizer: AlignmentTokenizer,
    device="cuda",
) -> Tuple[List[dict], List[float], int]:
    """Viterbi-align the starred token stream against host ``emissions``
    on ``device``.

    Returns (per-label segments with frame spans, per-label scores, the
    blank label id)."""
    labels: List[int] = []
    for tok in tokens_starred:
        labels.extend(tokenizer.word_to_ids(tok))
    labels_arr = np.asarray(labels, np.int32)

    emissions_star = add_star_column(np.asarray(emissions, np.float32), tokenizer.blank_id)
    frame_labels, _score = forced_align(
        emissions_star, labels_arr, tokenizer.blank_id, device=device
    )
    segments = label_segments(frame_labels, emissions_star, labels_arr)
    scores = [seg["score"] for seg in segments]
    return segments, scores, tokenizer.blank_id


def get_spans(
    tokens_starred: Sequence[str],
    segments: List[dict],
    blank_token: int,
) -> List[List[dict]]:
    """Group per-label segments back into per-starred-token spans."""
    spans: List[List[dict]] = []
    cursor = 0
    tokenizer = AlignmentTokenizer()
    for tok in tokens_starred:
        n = len(tokenizer.word_to_ids(tok))
        spans.append(segments[cursor : cursor + n])
        cursor += n
    return spans


def postprocess_results(
    text_starred: Sequence[str],
    spans: List[List[dict]],
    stride: float,
    scores: Sequence[float],
) -> List[dict]:
    """Spans -> word timestamps in seconds.

    Skips ``<star>`` wildcards; each word's time range covers its first
    to last aligned character.
    """
    results: List[dict] = []
    for word, span in zip(text_starred, spans):
        if word == "<star>" or not span:
            continue
        start_frame = span[0]["start"]
        end_frame = span[-1]["end"]
        score = float(np.mean([s["score"] for s in span]))
        results.append(
            {
                "text": word,
                "start": start_frame * stride / 1000.0,
                "end": end_frame * stride / 1000.0,
                "score": score,
            }
        )
    return results

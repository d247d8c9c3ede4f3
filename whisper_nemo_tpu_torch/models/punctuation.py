"""Punctuation restoration: an XLM-RoBERTa token classifier in PyTorch.

Counterpart of ``whisper_nemo_tpu/models/punctuation.py``, the
replacement for the reference's ``deepmultilingualpunctuation``: word
chunks in, one of ``0 . , ? - :`` a word out.
``PunctuationModel.predict(words, chunk_size=230)`` returns ``(word,
label, score)`` rows; the CLI flow reads the label at index 1.

The encoder is XLM-R's (learned positions counted from 2 over the real
tokens, post-LN blocks, exact GELU) with a linear tag head, as functions
over the JAX package's param tree (linear weights ``[in, out]``), f32
throughout with TF32 off within the call. Attention and the GEMMs are
plain torch: the JAX package computes them through XLA, not a Pallas
kernel. Tokens: a HF ``tokenizer.json`` beside the checkpoint when there
is one, else one token a word by Python's ``hash()``, as in the JAX
package (so both give the same ids within one process).
``convert_hf_xlmr_state_dict`` and ``dims_from_hf_xlmr_config`` turn an HF
``XLMRobertaForTokenClassification`` checkpoint into that tree
(``cli/convert.py``).
"""

from __future__ import annotations

import logging
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..engine.checkpoint import load_params, model_cache_dir
from ..engine.precision import full_f32
from ..engine.readers import as_f32
from .whisper import _layer_norm as _ln
from .whisper import _linear

logger = logging.getLogger(__name__)

Params = Dict[str, Any]

PUNCT_LABELS = ["0", ".", ",", "?", "-", ":"]


@dataclass(frozen=True)
class XlmRobertaDims:
    vocab_size: int = 250002
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_positions: int = 514
    pad_token_id: int = 1
    num_labels: int = 6


# the random init's dims under $WNT_TEST_SMALL_MODELS
SMALL_DIMS = XlmRobertaDims(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4,
                            intermediate_size=128)


def token_classifier_logits(params: Params, input_ids: torch.Tensor,
                            attention_mask: torch.Tensor, dims: XlmRobertaDims) -> torch.Tensor:
    """``[B, T]`` token ids and 0/1 mask -> ``[B, T, num_labels]`` f32 logits."""
    b, t = input_ids.shape
    # pad tokens keep the pad position; the others count from pad + 1 = 2
    positions = torch.cumsum(attention_mask, dim=1) * attention_mask + dims.pad_token_id
    x = params["tok_emb"][input_ids] + params["pos_emb"][positions] + params["type_emb"]
    x = _ln(params["emb_ln"], x)
    bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9)

    h = dims.num_heads
    hd = dims.hidden_size // h
    for blk in params["layers"]:
        q, k, v = (_linear(blk["attn"][n], x).reshape(b, t, h, hd) for n in "qkv")
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd) + bias
        w = torch.softmax(logits, dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, t, -1)
        x = _ln(blk["attn_ln"], x + _linear(blk["attn"]["o"], attn))
        ff = _linear(blk["ff_out"], F.gelu(_linear(blk["ff_in"], x), approximate="none"))
        x = _ln(blk["ff_ln"], x + ff)
    return _linear(params["head"], x).float()


def init_xlmr_params(dims: XlmRobertaDims, device, generator: torch.Generator) -> Params:
    """Seeded random f32 parameters in the shapes and distributions of the
    JAX package's ``init_xlmr_params`` (different draws), made on
    ``device`` from ``generator`` (which must live on that device)."""
    d = dims.hidden_size

    def normal(*shape):
        return torch.randn(shape, device=device, generator=generator)

    def lin(d_in, d_out):
        return {"w": normal(d_in, d_out) * d_in**-0.5, "b": torch.zeros(d_out, device=device)}

    def ln():
        return {"g": torch.ones(d, device=device), "b": torch.zeros(d, device=device)}

    layers = [
        {
            "attn": {n: lin(d, d) for n in "qkvo"},
            "attn_ln": ln(),
            "ff_in": lin(d, dims.intermediate_size),
            "ff_out": lin(dims.intermediate_size, d),
            "ff_ln": ln(),
        }
        for _ in range(dims.num_layers)
    ]
    return {
        "tok_emb": normal(dims.vocab_size, d) * 0.02,
        "pos_emb": normal(dims.max_positions, d) * 0.02,
        "type_emb": torch.zeros(d, device=device),
        "emb_ln": ln(),
        "layers": layers,
        "head": lin(d, dims.num_labels),
    }


def convert_hf_xlmr_state_dict(sd: Mapping, dims: XlmRobertaDims) -> Dict:
    """HF ``XLMRobertaForTokenClassification.state_dict()`` → params."""
    t = as_f32

    def lin(prefix):
        return {"w": t(sd[f"{prefix}.weight"]).T, "b": t(sd[f"{prefix}.bias"])}

    def ln(prefix):
        return {"g": t(sd[f"{prefix}.weight"]), "b": t(sd[f"{prefix}.bias"])}

    pre = "roberta."
    layers = []
    for i in range(dims.num_layers):
        lp = f"{pre}encoder.layer.{i}"
        layers.append(
            {
                "attn": {
                    "q": lin(f"{lp}.attention.self.query"),
                    "k": lin(f"{lp}.attention.self.key"),
                    "v": lin(f"{lp}.attention.self.value"),
                    "o": lin(f"{lp}.attention.output.dense"),
                },
                "attn_ln": ln(f"{lp}.attention.output.LayerNorm"),
                "ff_in": lin(f"{lp}.intermediate.dense"),
                "ff_out": lin(f"{lp}.output.dense"),
                "ff_ln": ln(f"{lp}.output.LayerNorm"),
            }
        )
    return {
        "tok_emb": t(sd[f"{pre}embeddings.word_embeddings.weight"]),
        "pos_emb": t(sd[f"{pre}embeddings.position_embeddings.weight"]),
        "type_emb": t(sd[f"{pre}embeddings.token_type_embeddings.weight"])[0],
        "emb_ln": ln(f"{pre}embeddings.LayerNorm"),
        "layers": layers,
        "head": lin("classifier"),
    }


def dims_from_hf_xlmr_config(raw: Mapping) -> XlmRobertaDims:
    """An HF ``config.json`` (as a dict) -> :class:`XlmRobertaDims`, as the
    JAX package's converter takes them (``tools/convert_checkpoint.py``)."""
    return XlmRobertaDims(
        vocab_size=raw["vocab_size"],
        hidden_size=raw["hidden_size"],
        num_layers=raw["num_hidden_layers"],
        num_heads=raw["num_attention_heads"],
        intermediate_size=raw["intermediate_size"],
        max_positions=raw["max_position_embeddings"],
        num_labels=len(raw.get("id2label", {})) or 6,
    )


class _HashTokenizer:
    """One token a word, its id from Python's ``hash()``: keeps predict()
    running on random weights. The hash of a string is salted per process
    unless ``PYTHONHASHSEED`` is set, so the ids, and a random-weight
    model's labels, change between processes, as in the JAX package."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode_words(self, words: Sequence[str]) -> Tuple[List[int], List[int]]:
        ids = [(hash(w) % (self.vocab_size - 10)) + 10 for w in words]
        return ids, list(range(len(words)))


class _JsonTokenizer:
    """HF ``tokenizers`` subword tokenizer; each word's label is read at
    its first subtoken. ``tokenizers`` is imported only here."""

    def __init__(self, path: str):
        from tokenizers import Tokenizer

        self.tok = Tokenizer.from_file(path)

    def encode_words(self, words: Sequence[str]) -> Tuple[List[int], List[int]]:
        ids: List[int] = []
        first: List[int] = []
        for w in words:
            enc = self.tok.encode(w, add_special_tokens=False)
            first.append(len(ids))
            ids.extend(enc.ids if enc.ids else [3])  # <unk>
        return ids, first


class PunctuationModel:
    """deepmultilingualpunctuation's facade (contract: diarize.py:222-226)
    on ``device`` ("cuda", "cuda:N" or "cpu"; there is no "auto").

    Weights: ``<cache>/<model with / as _>.npz`` at XLM-R base's dims, else
    a random init from ``seed`` (the small dims under
    ``$WNT_TEST_SMALL_MODELS``, logged)."""

    def __init__(self, model: str = "kredor/punctuate-all", device="cuda", seed: int = 3):
        if device == "auto":
            raise ValueError('device must be explicit: "cuda", "cuda:N" or "cpu"')
        self.device = torch.device(device)
        safe = model.replace("/", "_")
        cache = model_cache_dir()
        ckpt = os.path.join(cache, f"{safe}.npz")
        tok_json = os.path.join(cache, f"{safe}.tokenizer.json")
        if os.path.exists(ckpt):
            self.params = load_params(ckpt, self.device)
            self.dims = XlmRobertaDims()
        else:
            logger.warning("no punctuation checkpoint at %s; using random init", ckpt)
            self.dims = SMALL_DIMS if os.environ.get("WNT_TEST_SMALL_MODELS") else XlmRobertaDims()
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.params = init_xlmr_params(self.dims, self.device, gen)
        if os.path.exists(tok_json):
            self.tokenizer = _JsonTokenizer(tok_json)
        else:
            self.tokenizer = _HashTokenizer(self.dims.vocab_size)

    def predict(self, words: Sequence[str], chunk_size: int = 230,
                overlap: int = 5) -> List[Tuple[str, str, float]]:
        """Per-word punctuation labels over overlapping word chunks.

        Long transcripts step by ``chunk_size - 2·overlap``, and each word
        takes its label from the chunk where it sits away from the chunk's
        edge (deepmultilingualpunctuation's scheme: edge words lack right
        context). All chunks run as one batch padded to the longest; a
        padded key gets weight exactly 0 under the -1e9 bias, so padding
        changes no result."""
        words = list(words)
        if not words:
            return []
        if len(words) <= chunk_size:
            starts = [0]
        else:
            overlap = min(overlap, (chunk_size - 1) // 2)
            step = chunk_size - 2 * overlap
            starts = list(range(0, len(words) - overlap, step))
        chunks = [words[s : s + chunk_size] for s in starts]
        encoded = [self.tokenizer.encode_words(c) for c in chunks]

        arr = np.zeros((len(encoded), max(len(ids) for ids, _ in encoded)), np.int64)
        mask = np.zeros_like(arr)
        for i, (ids, _) in enumerate(encoded):
            arr[i, : len(ids)] = ids
            mask[i, : len(ids)] = 1
        with full_f32(), torch.inference_mode():
            logits = token_classifier_logits(
                self.params, torch.from_numpy(arr).to(self.device),
                torch.from_numpy(mask).to(self.device), self.dims,
            ).cpu().numpy()

        out: List[Optional[Tuple[str, str, float]]] = [None] * len(words)
        for ci, (start, chunk, (ids, first)) in enumerate(zip(starts, chunks, encoded)):
            lg = logits[ci]
            probs = np.exp(lg - lg.max(axis=-1, keepdims=True))
            probs /= probs.sum(axis=-1, keepdims=True)
            lo = 0 if start == 0 else overlap
            hi = len(chunk) if start + len(chunk) >= len(words) else max(lo, len(chunk) - overlap)
            for j in range(lo, hi):
                gi = start + j
                if gi < len(words) and out[gi] is None:
                    fi = first[j]
                    li = int(np.argmax(probs[fi]))
                    out[gi] = (chunk[j], PUNCT_LABELS[li], float(probs[fi, li]))
        if any(o is None for o in out):
            raise RuntimeError("punctuation chunking left words without a label")
        return out  # type: ignore[return-value]

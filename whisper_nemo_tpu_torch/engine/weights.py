"""Checkpoint conversion: Whisper state dicts (HF and OpenAI ``.pt``) ->
the JAX package's param tree of numpy arrays.

Counterpart of ``whisper_nemo_tpu/engine/weights.py``, array for array:
the tree is the one ``engine/checkpoint.save_tree`` writes as the shared
``.npz`` format, which ``engine/checkpoint.load_params`` reads (linear
weights ``[in, out]``, conv weights ``[k, in, out]``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from ..models.whisper import WhisperDims
from .readers import as_f32 as _t


def _linear_from_hf(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    p = {"w": _t(sd[f"{prefix}.weight"]).T}  # [out,in] -> [in,out]
    if f"{prefix}.bias" in sd:
        p["b"] = _t(sd[f"{prefix}.bias"])
    return p


def _ln_from_hf(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {"g": _t(sd[f"{prefix}.weight"]), "b": _t(sd[f"{prefix}.bias"])}


def _attn_from_hf(sd: Mapping, prefix: str) -> Dict[str, Any]:
    return {
        "q": _linear_from_hf(sd, f"{prefix}.q_proj"),
        "k": _linear_from_hf(sd, f"{prefix}.k_proj"),
        "v": _linear_from_hf(sd, f"{prefix}.v_proj"),
        "o": _linear_from_hf(sd, f"{prefix}.out_proj"),
    }


def _block_from_hf(sd: Mapping, prefix: str, cross: bool) -> Dict[str, Any]:
    p = {
        "ln1": _ln_from_hf(sd, f"{prefix}.self_attn_layer_norm"),
        "attn": _attn_from_hf(sd, f"{prefix}.self_attn"),
        "ln2": _ln_from_hf(sd, f"{prefix}.final_layer_norm"),
        "mlp_in": _linear_from_hf(sd, f"{prefix}.fc1"),
        "mlp_out": _linear_from_hf(sd, f"{prefix}.fc2"),
    }
    if cross:
        p["ln_cross"] = _ln_from_hf(sd, f"{prefix}.encoder_attn_layer_norm")
        p["cross_attn"] = _attn_from_hf(sd, f"{prefix}.encoder_attn")
    return p


def convert_hf_whisper_state_dict(
    sd: Mapping, dims: WhisperDims
) -> Dict[str, Any]:
    """HF ``WhisperForConditionalGeneration.state_dict()`` → param tree.

    Accepts either ``model.``-prefixed (full model) or bare
    (``WhisperModel``) key layouts.
    """
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}

    encoder = {
        # HF conv weight: [out, in, k] -> ours [k, in, out]
        "conv1": {
            "w": _t(sd["encoder.conv1.weight"]).transpose(2, 1, 0),
            "b": _t(sd["encoder.conv1.bias"]),
        },
        "conv2": {
            "w": _t(sd["encoder.conv2.weight"]).transpose(2, 1, 0),
            "b": _t(sd["encoder.conv2.bias"]),
        },
        "pos": _t(sd["encoder.embed_positions.weight"]),
        "blocks": [
            _block_from_hf(sd, f"encoder.layers.{i}", cross=False)
            for i in range(dims.n_audio_layer)
        ],
        "ln_post": _ln_from_hf(sd, "encoder.layer_norm"),
    }
    decoder = {
        "tok_emb": _t(sd["decoder.embed_tokens.weight"]),
        "pos_emb": _t(sd["decoder.embed_positions.weight"]),
        "blocks": [
            _block_from_hf(sd, f"decoder.layers.{i}", cross=True)
            for i in range(dims.n_text_layer)
        ],
        "ln": _ln_from_hf(sd, "decoder.layer_norm"),
    }
    return {"encoder": encoder, "decoder": decoder}


def dims_from_hf_config(cfg) -> WhisperDims:
    """HF ``WhisperConfig`` → :class:`WhisperDims`."""
    return WhisperDims(
        n_mels=cfg.num_mel_bins,
        n_audio_ctx=cfg.max_source_positions,
        n_audio_state=cfg.d_model,
        n_audio_head=cfg.encoder_attention_heads,
        n_audio_layer=cfg.encoder_layers,
        n_vocab=cfg.vocab_size,
        n_text_ctx=cfg.max_target_positions,
        n_text_state=cfg.d_model,
        n_text_head=cfg.decoder_attention_heads,
        n_text_layer=cfg.decoder_layers,
    )


# -- OpenAI whisper .pt layout (what openai-whisper's load_model reads) ---------


def dims_from_openai_dims(d: Mapping) -> WhisperDims:
    """The ``dims`` dict stored inside an OpenAI whisper ``.pt``."""
    return WhisperDims(
        n_mels=d["n_mels"],
        n_audio_ctx=d["n_audio_ctx"],
        n_audio_state=d["n_audio_state"],
        n_audio_head=d["n_audio_head"],
        n_audio_layer=d["n_audio_layer"],
        n_vocab=d["n_vocab"],
        n_text_ctx=d["n_text_ctx"],
        n_text_state=d["n_text_state"],
        n_text_head=d["n_text_head"],
        n_text_layer=d["n_text_layer"],
    )


def _attn_from_openai(sd: Mapping, prefix: str) -> Dict[str, Any]:
    # OpenAI names: query/key/value/out; the key projection has no bias
    return {
        "q": _linear_from_hf(sd, f"{prefix}.query"),
        "k": _linear_from_hf(sd, f"{prefix}.key"),
        "v": _linear_from_hf(sd, f"{prefix}.value"),
        "o": _linear_from_hf(sd, f"{prefix}.out"),
    }


def _block_from_openai(sd: Mapping, prefix: str, cross: bool) -> Dict[str, Any]:
    p = {
        "ln1": _ln_from_hf(sd, f"{prefix}.attn_ln"),
        "attn": _attn_from_openai(sd, f"{prefix}.attn"),
        "ln2": _ln_from_hf(sd, f"{prefix}.mlp_ln"),
        "mlp_in": _linear_from_hf(sd, f"{prefix}.mlp.0"),
        "mlp_out": _linear_from_hf(sd, f"{prefix}.mlp.2"),
    }
    if cross:
        p["ln_cross"] = _ln_from_hf(sd, f"{prefix}.cross_attn_ln")
        p["cross_attn"] = _attn_from_openai(sd, f"{prefix}.cross_attn")
    return p


def convert_openai_whisper_state_dict(
    sd: Mapping, dims: WhisperDims
) -> Dict[str, Any]:
    """OpenAI whisper ``.pt`` ``model_state_dict`` → param tree.

    The layout openai-whisper's ``load_model`` consumes:
    ``encoder.blocks.N.attn.query``-style names, fused ``mlp.0/mlp.2``
    sequentials, ``positional_embedding`` buffers. Produces the exact
    same tree as :func:`convert_hf_whisper_state_dict` does for the
    equivalent HF checkpoint.
    """
    encoder = {
        "conv1": {
            "w": _t(sd["encoder.conv1.weight"]).transpose(2, 1, 0),
            "b": _t(sd["encoder.conv1.bias"]),
        },
        "conv2": {
            "w": _t(sd["encoder.conv2.weight"]).transpose(2, 1, 0),
            "b": _t(sd["encoder.conv2.bias"]),
        },
        "pos": _t(sd["encoder.positional_embedding"]),
        "blocks": [
            _block_from_openai(sd, f"encoder.blocks.{i}", cross=False)
            for i in range(dims.n_audio_layer)
        ],
        "ln_post": _ln_from_hf(sd, "encoder.ln_post"),
    }
    decoder = {
        "tok_emb": _t(sd["decoder.token_embedding.weight"]),
        "pos_emb": _t(sd["decoder.positional_embedding"]),
        "blocks": [
            _block_from_openai(sd, f"decoder.blocks.{i}", cross=True)
            for i in range(dims.n_text_layer)
        ],
        "ln": _ln_from_hf(sd, "decoder.ln"),
    }
    return {"encoder": encoder, "decoder": decoder}

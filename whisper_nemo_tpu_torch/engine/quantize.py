"""Weight-only int8 quantization for inference.

Counterpart of ``whisper_nemo_tpu/engine/quantize.py``: every transformer
linear and the vocabulary output projection are stored per-output-channel
symmetric int8 and dequantized after the product (``(x @ w_q) * scale``).
Embeddings, norms and biases stay f32. The arithmetic runs on the
weights' device.
"""

from __future__ import annotations

from typing import Any, Dict

import torch


def quantize_linear(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``[in, out]`` float -> int8 ``w_q`` + per-out-channel f32 ``scale``:
    ``round(w / (amax / 127))`` clipped to ±127, scale 1.0 where amax is 0
    (round half to even, as ``jnp.round``). The scale is ``amax * (1/127)``
    in f32, as XLA compiles the JAX package's ``amax / 127.0``."""
    w = w.float()
    scale = w.abs().amax(dim=0) * (1.0 / 127.0)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"w_q": q, "scale": scale}


def _quantize_linear_dict(p: Dict[str, Any]) -> Dict[str, Any]:
    out = quantize_linear(p["w"])
    if "b" in p:
        out["b"] = p["b"]
    return out


def _quantize_block(block: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(block)
    for attn_key in ("attn", "cross_attn"):
        if attn_key in block:
            out[attn_key] = {
                k: _quantize_linear_dict(v) for k, v in block[attn_key].items()
            }
    for mlp_key in ("mlp_in", "mlp_out"):
        out[mlp_key] = _quantize_linear_dict(block[mlp_key])
    return out


def quantize_whisper_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """int8-quantize every encoder and decoder linear plus the output
    projection ``tok_emb.T`` (stored as ``decoder.out_proj_q``; the token
    embedding gather stays dense)."""
    enc = dict(params["encoder"])
    enc["blocks"] = [_quantize_block(b) for b in params["encoder"]["blocks"]]
    dec = dict(params["decoder"])
    dec["blocks"] = [_quantize_block(b) for b in params["decoder"]["blocks"]]
    dec["out_proj_q"] = quantize_linear(params["decoder"]["tok_emb"].t())
    return {"encoder": enc, "decoder": dec}

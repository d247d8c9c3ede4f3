"""Layer-stacked Whisper decoder: prefill and the decode step.

Counterpart of ``whisper_nemo_tpu/models/whisper_stacked.py``. The
cross-KV takes one of two forms, as in the JAX package: at the reduced
widths (int8, bf16) the fused int8 ``[L, B, H, 2D, Kp]`` decode layout of
``ops/cross_decode.py`` (kernel A on a CUDA tensor), at the f32 widths
float K and V projected from the features, attended in plain torch (the
JAX package's XLA einsums). The self-attention cache is ``[L, B, H, D,
S]`` (positions last), in the compute dtype. The layer loop is a Python
loop; kernels A and E receive the whole stack and the layer index. The
cache is updated in place. Beam search runs the same step on ``B·K``
rows with an ancestry map (kernel E) and the window's cross-KV shared by
its ``K`` lanes. A left-padded conditioning prompt is masked per row and
position-shifted (``kv_valid``, ``pos_offset``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..ops.attention import attention_kt, multihead_attention
from ..ops.cross_decode import (
    cross_attention_decode_layered,
    quantize_decode_layout,
    split_unpack,
)
from ..ops.self_decode import self_attention_decode_ancestry_layered
from .whisper import (
    WhisperDims,
    _layer_norm,
    _linear,
    _mlp,
    _split_heads,
    _vocab_logits,
    causal_mask,
    embed_tokens,
)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def stack_decoder_blocks(params: Dict[str, Any]) -> Dict[str, Any]:
    """Per-layer decoder block dicts -> ``layers``: per-layer views (no
    copies) of ``[n_layers]``-leading stacked tensors, one storage per
    leaf, for the Python layer loop."""
    out = dict(params["decoder"])
    stacked = _stack(out.pop("blocks"))
    out["layers"] = [
        _index(stacked, i) for i in range(stacked["ln1"]["g"].shape[0])
    ]
    return {"encoder": params["encoder"], "decoder": out}


def _proj_layer(p: Dict[str, Any], audio: torch.Tensor, h: int) -> torch.Tensor:
    """``[B, T, D]`` audio x one layer's projection -> ``[1, B, T, H, Dh]``,
    with the JAX package's rounding order (product in the compute dtype,
    then the int8 scale, then an f32 bias)."""
    if "w_q" in p:
        y = torch.matmul(audio, p["w_q"].to(audio.dtype)) * p["scale"].to(audio.dtype)
    else:
        y = torch.matmul(audio, p["w"].to(audio.dtype))
    if "b" in p:
        y = y + p["b"]
    b, t, d = y.shape
    return y.reshape(1, b, t, h, d // h)


def cross_kv_decode_layout_fused(
    params: Dict[str, Any], audio: torch.Tensor, dims: WhisperDims, bits: int = 8
) -> dict:
    """Cross-attention K/V projection fused with decode-layout
    quantization, one layer at a time (the scales are per layer, head and
    channel, so this equals projecting all layers first), into one
    preallocated ``[L, B, H, 2D, Kp]`` int8 stack."""
    h = dims.n_text_head
    kv_dec = k_scales = v_scales = None
    for li, blk in enumerate(params["decoder"]["layers"]):
        ca = blk["cross_attn"]
        k_q, k_s = quantize_decode_layout(_proj_layer(ca["k"], audio, h), bits)
        v_q, v_s = quantize_decode_layout(_proj_layer(ca["v"], audio, h), bits)
        if kv_dec is None:
            n_layers = dims.n_text_layer
            shape = (n_layers,) + k_q.shape[1:3] + (2 * k_q.shape[3], k_q.shape[4])
            kv_dec = torch.empty(shape, dtype=torch.int8, device=audio.device)
            k_scales = torch.empty((n_layers,) + k_s.shape[1:], device=audio.device)
            v_scales = torch.empty_like(k_scales)
        half = k_q.shape[3]
        kv_dec[li, :, :, :half] = k_q[0]
        kv_dec[li, :, :, half:] = v_q[0]
        k_scales[li], v_scales[li] = k_s[0], v_s[0]
    return {
        "kv_dec": kv_dec,
        "k_dec_scale": k_scales,
        "v_dec_scale": v_scales,
        "_k_len": audio.shape[1],
        "_bits": bits,
    }


def cross_kv_float(params: Dict[str, Any], audio: torch.Tensor, dims: WhisperDims) -> dict:
    """Cross-attention K and V of every layer in the compute dtype, the
    float form (the f32 widths): ``k`` ``[L, B, H, D, T]``, already times
    D^-¼ (the JAX einsum path scales q and k by D^-¼ each; this does k's
    product once instead of at every step, the same rounding), and ``v``
    ``[L, B, H, T, D]``, each transposed once for the step's products."""
    h = dims.n_text_head
    d = dims.n_text_state // h
    ks, vs = [], []
    for blk in params["decoder"]["layers"]:
        ca = blk["cross_attn"]
        k = _proj_layer(ca["k"], audio, h)[0] * d**-0.25  # [B, T, H, D]
        ks.append(k.permute(0, 2, 3, 1))
        vs.append(_proj_layer(ca["v"], audio, h)[0].permute(0, 2, 1, 3))
    return {"k": torch.stack(ks), "v": torch.stack(vs), "_k_len": audio.shape[1]}


def _cross_attention_float(qc: torch.Tensor, cross_kv: dict, layer: int, beam: int = 1):
    """``[B·beam, P, H, D]`` queries over one layer of the float cross-KV
    of ``B`` windows, the ``beam`` lanes of a window sharing its K and V:
    the JAX package's einsum path (``ops/attention._xla_attention``): q
    times D^-¼, f32 logits, f32 softmax, weights in q's dtype."""
    bk, p, h, d = qc.shape
    w = bk // beam
    q = (qc * d**-0.25).reshape(w, beam * p, h, d).transpose(1, 2)  # [B, H, beam·P, D]
    logits = torch.matmul(q.float(), cross_kv["k"][layer].float())  # [B, H, beam·P, T]
    weights = torch.softmax(logits, dim=-1).to(qc.dtype)
    out = torch.matmul(weights, cross_kv["v"][layer])  # [B, H, beam·P, D]
    return out.transpose(1, 2).reshape(bk, p, h, d)


def cross_kv_for_decode(
    params: Dict[str, Any], audio: torch.Tensor, dims: WhisperDims, kv_bits: Optional[int]
) -> dict:
    """The decode's cross-KV: the int8 decode layout at ``kv_bits`` (8 or
    4; the reduced widths), or the float form when ``kv_bits`` is None
    (the f32 widths)."""
    if kv_bits is None:
        return cross_kv_float(params, audio, dims)
    return cross_kv_decode_layout_fused(params, audio, dims, bits=kv_bits)


def init_stacked_cache(
    batch: int, dims: WhisperDims, dtype, cache_len: int, device
) -> dict:
    """Self-attention cache ``[L, B, H, D, S]`` of zeros (positions last)."""
    h = dims.n_text_head
    shape = (dims.n_text_layer, batch, h, dims.n_text_state // h, cache_len)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _cross_prefill_declayout(qc, kv_layer, k_scale, v_scale, cross_len: int, bits: int):
    """Prefill cross-attention of ``[B, P, H, D]`` queries over one layer's
    fused decode-layout KV ``[B, H, R, Kp]``: the plain dequantizing
    einsums, with f32 logits as in the JAX package."""
    k_dec, vt_dec = split_unpack(kv_layer, bits)  # [B, H, D, Kp]
    scale = qc.shape[-1] ** -0.5
    qs = qc * (k_scale[None, None] * scale).to(qc.dtype)
    logits = torch.einsum("bqhd,bhdt->bhqt", qs.float(), k_dec.float())
    pos = torch.arange(logits.shape[-1], device=logits.device)
    logits = logits.masked_fill(pos >= cross_len, float("-inf"))
    w = torch.softmax(logits, dim=-1).to(qc.dtype)
    cross = torch.einsum("bhqt,bhdt->bqhd", w.float(), vt_dec.float()).to(qc.dtype)
    return cross * v_scale[None, None].to(qc.dtype)


def prefill_cache_stacked(
    params: Dict[str, Any],
    prompt: torch.Tensor,  # [B, P]
    cache: dict,
    cross_kv: dict,
    dims: WhisperDims,
    dtype,
    kv_valid: Optional[torch.Tensor] = None,  # [B, S] bool
    pos_offset: Optional[torch.Tensor] = None,  # [B] int
) -> Tuple[torch.Tensor, dict]:
    """All prompt positions in one teacher-forced pass: writes the cache at
    positions ``[0, P)`` and returns the final-norm hidden states
    ``[B, P, D]``. A left-padded prompt passes ``kv_valid`` (its pad slots
    False), which hides those slots from self-attention, and
    ``pos_offset`` (each row's pad count), which shifts the row's learned
    positions so that its first real token reads position 0."""
    dec = params["decoder"]
    b, p_len = prompt.shape
    positions = torch.arange(p_len, device=prompt.device)[None]
    if pos_offset is not None:
        positions = torch.clamp(positions - pos_offset[:, None], min=0)
    x = embed_tokens(dec, prompt, positions, dtype)
    mask = causal_mask(p_len, prompt.device)
    if kv_valid is not None:
        mask = mask.masked_fill(~kv_valid[:, None, None, :p_len], float("-inf"))
    n_head = dims.n_text_head
    for li, blk in enumerate(dec["layers"]):
        xn = _layer_norm(blk["ln1"], x)
        q = _split_heads(_linear(blk["attn"]["q"], xn), n_head)
        k_new = _split_heads(_linear(blk["attn"]["k"], xn), n_head)
        v_new = _split_heads(_linear(blk["attn"]["v"], xn), n_head)
        cache["k"][li, ..., :p_len] = k_new.permute(0, 2, 3, 1)
        cache["v"][li, ..., :p_len] = v_new.permute(0, 2, 3, 1)
        attn = multihead_attention(q, k_new, v_new, mask).reshape(b, p_len, -1)
        x = x + _linear(blk["attn"]["o"], attn)

        xq = _layer_norm(blk["ln_cross"], x)
        qc = _split_heads(_linear(blk["cross_attn"]["q"], xq), n_head)
        if "kv_dec" in cross_kv:
            cross = _cross_prefill_declayout(
                qc, cross_kv["kv_dec"][li], cross_kv["k_dec_scale"][li],
                cross_kv["v_dec_scale"][li], cross_kv["_k_len"], cross_kv["_bits"],
            )
        else:
            cross = _cross_attention_float(qc, cross_kv, li)
        x = x + _linear(blk["cross_attn"]["o"], cross.reshape(b, p_len, -1))
        x = x + _mlp(blk["mlp_in"], blk["mlp_out"], _layer_norm(blk["ln2"], x))
    return _layer_norm(dec["ln"], x), cache


def decode_step_stacked(
    params: Dict[str, Any],
    token: torch.Tensor,  # [B]
    pos: int,
    cache: dict,
    cross_kv: dict,
    dims: WhisperDims,
    dtype,
    return_hidden: bool = False,
    anc: Optional[torch.Tensor] = None,
    kv_valid: Optional[torch.Tensor] = None,  # [B, S] bool
    pos_offset: Optional[torch.Tensor] = None,  # [B] int
) -> Tuple[torch.Tensor, dict]:
    """One decode step at position ``pos``: f32 logits ``[B, V]`` (or the
    final-norm hidden ``[B, D]`` with ``return_hidden``) and the cache,
    updated in place. Cross-attention runs kernel A on a CUDA tensor over
    the int8 decode layout, plain torch over the float form. Beam search
    passes ``anc`` (``[W, K, S]`` int32, ``B = W·K`` rows): self-attention
    then selects each position's lane through it (kernel E) over the
    never-reordered cache, and a window's ``K`` lanes share its cross-KV. ``kv_valid`` and ``pos_offset`` serve a left-padded
    prompt, as in :func:`prefill_cache_stacked`: the mask becomes one row
    per batch row."""
    dec = params["decoder"]
    b = token.shape[0]
    position = pos if pos_offset is None else torch.clamp(pos - pos_offset, min=0)
    x = embed_tokens(dec, token, position, dtype)[:, None, :]
    cache_len = cache["k"].shape[-1]
    visible = torch.arange(cache_len, device=token.device) <= pos
    if kv_valid is None:
        mask = torch.where(visible, 0.0, float("-inf"))[None, None, None, :]
    else:
        mask = torch.where(visible[None] & kv_valid, 0.0, float("-inf"))[:, None, None, :]
    quantized = "kv_dec" in cross_kv
    beam = 1 if anc is None else anc.shape[1]
    n_head = dims.n_text_head
    for li, blk in enumerate(dec["layers"]):
        xn = _layer_norm(blk["ln1"], x)
        q = _split_heads(_linear(blk["attn"]["q"], xn), n_head)
        k_new = _split_heads(_linear(blk["attn"]["k"], xn), n_head)
        v_new = _split_heads(_linear(blk["attn"]["v"], xn), n_head)
        cache["k"][li, ..., pos] = k_new[:, 0]
        cache["v"][li, ..., pos] = v_new[:, 0]
        if anc is None:
            attn = attention_kt(q, cache["k"][li], cache["v"][li], mask)
        else:
            attn = self_attention_decode_ancestry_layered(
                q, cache["k"], cache["v"], anc, mask, li, beam, n_visible=pos + 1
            )
        x = x + _linear(blk["attn"]["o"], attn.reshape(b, 1, -1))

        xq = _layer_norm(blk["ln_cross"], x)
        qc = _split_heads(_linear(blk["cross_attn"]["q"], xq), n_head)
        if quantized:
            cross = cross_attention_decode_layered(
                qc, cross_kv["kv_dec"], cross_kv["k_dec_scale"][li], cross_kv["v_dec_scale"][li],
                li, cross_kv["_k_len"], bits=cross_kv["_bits"], beam=beam,
            ).to(qc.dtype)
        else:
            cross = _cross_attention_float(qc, cross_kv, li, beam)
        x = x + _linear(blk["cross_attn"]["o"], cross.reshape(b, 1, -1))
        x = x + _mlp(blk["mlp_in"], blk["mlp_out"], _layer_norm(blk["ln2"], x))
    x = _layer_norm(dec["ln"], x)
    if return_hidden:
        return x[:, 0, :], cache
    return _vocab_logits(dec, x[:, 0, :]), cache

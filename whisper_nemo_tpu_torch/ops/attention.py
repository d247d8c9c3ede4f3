"""Multi-head attention: plain PyTorch forms and the encoder kernel.

Counterpart of ``whisper_nemo_tpu/ops/attention.py``. Operands keep the
JAX package's layouts: ``[B, T, H, D]`` for attention and ``[B, H, D, S]``
for the decode self-attention cache.

Kernel B (``csrc/encoder_attention.cu``) replaces the TPU kernel
``whisper_nemo_tpu/ops/attention.py:_flash_attention`` (the library Pallas
flash attention it wraps). It serves unmasked self-attention, the Whisper
encoder's and the wav2vec2 aligner's, at every head dim D that is a
multiple of 8 up to 128 (instantiated at 64 and at 128, with the columns
past a smaller D zero-filled by TMA); a larger D raises. It is bound by
tensor-core FLOPs (576 MFLOP per (batch, head) at T = 1500). One CTA per
192-query tile: a producer warp streams 128-key K and V tiles by TMA into
a two-stage ring, and three consumer warpgroups run both products on
wgmma with an online f32 softmax, so the ``[B, H, T, T]`` scores (4.6 GB
in f32 at B = 32) that the plain version materializes never exist. bf16
operands run as they are. f32 operands (the f32 widths' encoder) are
computed to f32 accuracy: the kernel splits each into two bf16 parts and
runs three products per product on the tensor cores (within about 1e-5
of the f32 computation), and writes f32. ``_xla_attention`` is its plain
version: the CPU path and the kernel's oracle.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

_MASK_VALUE = -0.7 * 3.4e38  # finite "-inf": fully masked rows stay finite


def _xla_attention(q, k, v, mask=None):
    """``[B, Tq, H, D] x [B, Tk, H, D] -> [B, Tq, H, D]`` with an f32
    softmax, as the JAX package's einsum path computes it: q and k are
    each scaled by D^-¼ in their own dtype, the logits are f32, masked
    positions (``mask < 0``) are replaced by a large finite negative, and
    the weights return to q's dtype before the mix."""
    scale = q.shape[-1] ** -0.25
    logits = torch.einsum(
        "bqhd,bkhd->bhqk", (q * scale).float(), (k * scale).float()
    )
    if mask is not None:
        logits = torch.where(mask >= 0.0, logits, _MASK_VALUE)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


@functools.lru_cache(maxsize=1)
def _kernel():
    fn = _build.load("encoder_attention").wnt_encoder_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _encoder_attention_cuda(q, k, v):
    """Launch kernel B on ``[B, T, H, D]`` bf16 or f32 CUDA tensors, D a
    multiple of 8 up to 128; the output has the inputs' dtype. At f32 the
    kernel's bf16 parts of q, k and v go to a scratch buffer allocated
    here."""
    b, t, h, d = q.shape
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"encoder attention needs equal shapes: {q.shape}, {k.shape}, {v.shape}")
    if d > 128:
        raise NotImplementedError(
            f"kernel B takes head dims up to 128, got {d}: not served; see ROADMAP.md,"
            " queue 3 (known differences)"
        )
    if d % 8:
        raise ValueError(f"kernel B takes a head dim that is a multiple of 8, got {d}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"encoder attention takes bf16 or f32, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.device.type != "cuda" or not (q.device == k.device == v.device):
        raise ValueError(f"kernel B takes q, k and v on one CUDA device, got {q.device}, {k.device}, {v.device}")
    q, k, v = (x.contiguous() for x in (q, k, v))
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("kernel B's tensor maps need q, k and v 16-byte aligned")
    out = torch.empty_like(q)
    parts = None
    if q.dtype == torch.float32:  # hi and lo bf16 parts of q, k and v
        parts = torch.empty((6, b, t, h, d), dtype=torch.bfloat16, device=q.device)
    rc = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, t, h, d, _DTYPES[q.dtype], None if parts is None else parts.data_ptr(),
        _build.stream(q.device),
    )
    _build.check(rc, "encoder_attention")
    encoder_attention.launches += 1
    return out


def encoder_attention(q, k, v):
    """Unmasked non-causal self-attention ``[B, T, H, D]``: kernel B on a
    CUDA tensor, the plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return _xla_attention(q, k, v)
    return _encoder_attention_cuda(q, k, v)


encoder_attention.launches = 0


def attention_kt(q, k_t, v_t, mask=None):
    """Decode-step attention over a transposed KV cache:
    ``[B, Tq, H, D] x K^T/V^T [B, H, D, S] -> [B, Tq, H, D]``. The softmax
    scale folds into q, which is rounded to the cache's dtype. The logits
    are f32 products of those operands (exact for bf16, summed in f32, as
    the JAX package's ``preferred_element_type``), the softmax is f32,
    and the weights return to q's dtype for the product with V."""
    scale = q.shape[-1] ** -0.5
    qq = (q * scale).to(k_t.dtype).permute(0, 2, 1, 3)  # [B, H, Tq, D]
    logits = torch.matmul(qq.float(), k_t.float())  # [B, H, Tq, S]
    if mask is not None:
        logits = torch.where(mask >= 0.0, logits, _MASK_VALUE)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(weights, v_t.transpose(-1, -2)).permute(0, 2, 1, 3)


def attention_kt_ancestry(q, k_t, v_t, anc, mask=None):
    """Beam decode-step attention over a cache that is never reordered:
    query lane ``j`` of window ``b`` reads position ``s`` from row
    ``b·K + anc[b, j, s]``. q ``[B·K, 1, H, D]``, k_t/v_t
    ``[B·K, H, D, S]``, anc ``[B, K, S]`` int in ``[0, K)``, mask
    ``[1|B·K, 1, 1, S]`` -> ``[B·K, 1, H, D]``.

    The plain version of kernel E (``ops/self_decode.py``): the
    explicit gather of each lane's history, then :func:`attention_kt`.
    The JAX package's one-hot formulations compute the same function."""
    b, kk, s = anc.shape
    rows = (torch.arange(b, device=anc.device)[:, None, None] * kk + anc).reshape(b * kk, 1, 1, s)
    idx = rows.long().expand(-1, k_t.shape[1], k_t.shape[2], -1)
    return attention_kt(q, torch.gather(k_t, 0, idx), torch.gather(v_t, 0, idx), mask)


def multihead_attention(q, k, v, mask: Optional[torch.Tensor] = None):
    """Unmasked self-attention (equal query and key lengths above 1) goes
    to :func:`encoder_attention`; masked or cross-attention stays on the
    plain path."""
    if mask is None and q.shape[1] > 1 and q.shape[1] == k.shape[1]:
        return encoder_attention(q, k, v)
    return _xla_attention(q, k, v, mask)

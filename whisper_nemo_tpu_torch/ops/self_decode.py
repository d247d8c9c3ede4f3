"""Beam decode-step self-attention over a cache that is never reordered.

Counterpart of ``whisper_nemo_tpu/ops/self_decode.py``. Beam search keeps
each beam row writing its own K/V at its own cache row; an ancestry map
``anc [B, K, S]`` names, for query lane ``j`` of window ``b``, the lane
whose row holds position ``s`` of its history. So the ``[L, B·K, H, D, S]``
cache is never permuted between steps.

Kernel E (``csrc/self_decode.cu``) replaces the TPU kernels
``self_attention_decode_ancestry`` and ``…_layered`` of the JAX package.
It is bound by device memory: each launch reads the visible K and V of
every row once for 1 FLOP a byte. One CTA per (head, row) reads each
position at the lane ``anc`` names (the gather the TPU could not do, and
replaced by one-hot selections), keeps the logits in shared memory, and
takes the layer as an offset into the full cache, so no per-layer copy is
made. ``ops.attention.attention_kt_ancestry`` is its plain version: the
CPU path and the kernel's oracle.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .attention import attention_kt_ancestry


@functools.lru_cache(maxsize=1)
def _kernel():
    fn = _build.load("self_decode").wnt_self_decode
    fn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _self_decode_cuda(q, k_full, v_full, anc, mask, layer, beam, n_visible):
    """Launch kernel E: same contract as the plain version of layer
    ``layer``, reading no position at or past ``n_visible``."""
    n_layers, bk, h, d, s = k_full.shape
    tensors = (q, k_full, v_full, anc, mask)
    if any(x.device.type != "cuda" or x.device != q.device for x in tensors):
        raise ValueError(
            f"kernel E takes its operands on one CUDA device, got {[str(x.device) for x in tensors]}"
        )
    if not (q.dtype == k_full.dtype == v_full.dtype == torch.bfloat16):
        raise TypeError(f"kernel E takes bf16 q and cache, got {q.dtype}, {k_full.dtype}, {v_full.dtype}")
    if anc.dtype != torch.int32 or mask.dtype != torch.float32:
        raise TypeError(f"kernel E takes int32 anc and an f32 mask, got {anc.dtype}, {mask.dtype}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("kernel E takes contiguous q, cache, anc and mask")
    mask_rows = mask.numel() // s
    if (
        v_full.shape != k_full.shape or q.shape != (bk, 1, h, d) or bk % beam
        or anc.shape != (bk // beam, beam, s) or mask.numel() != mask_rows * s
        or mask.shape[-1] != s or mask_rows not in (1, bk)
        or not 0 <= layer < n_layers or not 0 < n_visible <= s
    ):
        raise ValueError(
            f"self decode shapes: q {tuple(q.shape)}, cache {tuple(k_full.shape)}, anc"
            f" {tuple(anc.shape)}, mask {tuple(mask.shape)}, beam {beam}, layer {layer},"
            f" n_visible {n_visible}"
        )
    out = torch.empty((bk, 1, h, d), dtype=torch.bfloat16, device=q.device)
    rc = _kernel()(
        q.data_ptr(), k_full.data_ptr(), v_full.data_ptr(), anc.data_ptr(),
        mask.data_ptr(), out.data_ptr(),
        n_layers, bk, h, d, s, layer, beam, mask_rows, n_visible, d**-0.5,
        _build.stream(q.device),
    )
    _build.check(rc, "self_decode")
    self_attention_decode_ancestry_layered.launches += 1
    return out


def self_attention_decode_ancestry_layered(
    q: torch.Tensor,  # [B·beam, 1, H, D]
    k_full: torch.Tensor,  # [L, B·beam, H, D, S]: the full cache
    v_full: torch.Tensor,  # [L, B·beam, H, D, S]
    anc: torch.Tensor,  # [B, beam, S] int32
    mask: torch.Tensor,  # [1|B·beam, 1, 1, S] f32, additive (0 / -inf)
    layer: int,
    beam: int,
    n_visible: Optional[int] = None,
) -> torch.Tensor:
    """Ancestry-selected self-attention of layer ``layer`` ->
    ``[B·beam, 1, H, D]``: kernel E on a CUDA tensor, the plain version on
    a CPU tensor. ``n_visible`` promises that ``mask`` hides every
    position from it on, so the kernel reads none of them (default: all
    ``S``)."""
    if q.device.type == "cpu":
        return attention_kt_ancestry(q, k_full[layer], v_full[layer], anc, mask)
    n_visible = k_full.shape[-1] if n_visible is None else n_visible
    return _self_decode_cuda(q, k_full, v_full, anc, mask, layer, beam, n_visible)


self_attention_decode_ancestry_layered.launches = 0


def self_attention_decode_ancestry(q, k_t, v_t, anc, mask, beam: int, n_visible=None):
    """:func:`self_attention_decode_ancestry_layered` on one layer's
    cache ``[B·beam, H, D, S]``."""
    return self_attention_decode_ancestry_layered(
        q, k_t[None], v_t[None], anc, mask, 0, beam, n_visible
    )

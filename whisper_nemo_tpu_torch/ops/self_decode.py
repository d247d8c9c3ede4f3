"""Beam decode-step self-attention over a cache that is never reordered.

Counterpart of ``whisper_nemo_tpu/ops/self_decode.py``. Beam search keeps
each beam row writing its own K/V at its own cache row; an ancestry map
``anc [B, K, S]`` names, for query lane ``j`` of window ``b``, the lane
whose row holds position ``s`` of its history. So the ``[L, B·K, H, D, S]``
cache is never permuted between steps.

Kernel E (``csrc/self_decode.cu``) replaces the TPU kernels
``self_attention_decode_ancestry`` and ``…_layered`` of the JAX package,
for bf16 and f32 caches. It is bound by device memory: each launch reads
the visible K and V of every row once for 1 FLOP a byte. The window, not
the row, is its work unit: a thread-block cluster of CTAs per (window,
head) splits the visible positions, TMA brings each tile of all the
window's lanes into shared memory once, the logits of every lane are
gathered there at the lane ``anc`` names (the gather the TPU could not do,
and replaced by one-hot selections), the softmax stays exact across the
cluster, and every (lane, channel) sums its weighted V in parallel. The
layer is an offset into the full cache, so no per-layer copy is made.
``ops.attention.attention_kt_ancestry`` is its plain version: the CPU path
and the kernel's oracle.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .attention import attention_kt_ancestry
from .cross_decode import _sms


@functools.lru_cache(maxsize=1)
def _kernel():
    fn = _build.load("self_decode").wnt_self_decode
    fn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _cluster_size(windows: int, heads: int, n_visible: int, sms: int) -> int:
    """CTAs that split one (window, head): enough for about two CTAs per
    SM across the ``windows · heads`` pairs on a card of ``sms`` SMs, at
    most 8 (the portable cluster), and at least 16 visible positions a
    CTA. On the H100 (132 SMs) one window (16 heads) takes 8 from 128
    positions on; the batched decode's 32 windows take 1 (``chip_smoke.py``
    phases 3c and 3f time 1, 2, 4 and 8)."""
    c = min(8, -(-2 * sms // (windows * heads)))
    return max(1, min(c, -(-n_visible // 16)))


def _self_decode_cuda(q, k_full, v_full, anc, mask, layer, beam, n_visible, cluster=None):
    """Launch kernel E: same contract as the plain version of layer
    ``layer``, reading no position at or past ``n_visible``; the output
    has q's dtype. ``cluster`` overrides :func:`_cluster_size` (1-8) for
    measurement and tests only (``chip_smoke.py``'s sweeps, the ``cuda``
    tests): the port's callers leave it unset. The checks are written for
    the host's time: at one window a call's Python outlasts the kernel."""
    n_layers, bk, h, d, s = k_full.shape
    dev = q.get_device()  # -1 off CUDA devices
    if dev < 0 or not (k_full.get_device() == v_full.get_device() == anc.get_device()
                       == mask.get_device() == dev):
        tensors = (q, k_full, v_full, anc, mask)
        raise ValueError(
            f"kernel E takes its operands on one CUDA device, got {[str(x.device) for x in tensors]}"
        )
    dtype = q.dtype
    if dtype not in _DTYPES or k_full.dtype != dtype or v_full.dtype != dtype:
        raise TypeError(
            f"kernel E takes bf16 or f32 q and cache of one dtype, got {dtype},"
            f" {k_full.dtype}, {v_full.dtype}"
        )
    if anc.dtype != torch.int32 or mask.dtype != torch.float32:
        raise TypeError(f"kernel E takes int32 anc and an f32 mask, got {anc.dtype}, {mask.dtype}")
    if not (q.is_contiguous() and k_full.is_contiguous() and v_full.is_contiguous()
            and anc.is_contiguous() and mask.is_contiguous()):
        raise ValueError("kernel E takes contiguous q, cache, anc and mask")
    mask_rows = mask.numel() // s
    if cluster is None and 1 <= beam <= 8:
        cluster = _cluster_size(bk // beam, h, n_visible, _sms(dev))
    k_ptr, v_ptr = k_full.data_ptr(), v_full.data_ptr()
    if (
        v_full.shape != k_full.shape or q.shape != (bk, 1, h, d) or not 1 <= beam <= 8
        or bk % beam or anc.shape != (bk // beam, beam, s) or mask.numel() != mask_rows * s
        or mask.shape[-1] != s or mask_rows not in (1, bk) or d > 128
        or (s * k_full.element_size()) % 16 or k_ptr % 16 or v_ptr % 16
        or not 0 <= layer < n_layers or not 0 < n_visible <= s or not 1 <= cluster <= 8
    ):
        raise ValueError(
            f"self decode shapes: q {tuple(q.shape)}, cache {tuple(k_full.shape)}, anc"
            f" {tuple(anc.shape)}, mask {tuple(mask.shape)}, beam {beam}, layer {layer},"
            f" n_visible {n_visible}, cluster {cluster} (beam 1-8, head dim up to 128, cache"
            " rows of a multiple of 16 bytes, 16-byte aligned)"
        )
    out = torch.empty((bk, 1, h, d), dtype=dtype, device=q.device)
    rc = _kernel()(
        q.data_ptr(), k_ptr, v_ptr, anc.data_ptr(), mask.data_ptr(), out.data_ptr(),
        n_layers, bk, h, d, s, layer, beam, mask_rows, n_visible, _DTYPES[dtype], cluster,
        d**-0.5, _build.stream(q.device),
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

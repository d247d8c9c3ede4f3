"""Decode-step cross-attention over the int8 decode-layout cross-KV.

Counterpart of ``whisper_nemo_tpu/ops/cross_decode.py``. The layout is
the same: K and V transposed interleave in one ``[L, B, H, 2D, Kp]`` int8
array (rows ``0:D`` K, rows ``D:2D`` V^T, audio positions padded to a
multiple of 128 along ``Kp``), or ``[L, B, H, D, Kp]`` with split-half
int4 packing for ``bits=4``. Per-(layer, head, channel) scales fold into
the query (K) and the output (V), so nothing is dequantized in memory.

Kernel A (``csrc/cross_decode.cu``) replaces the TPU kernel
``whisper_nemo_tpu/ops/cross_decode.py:cross_attention_decode_layered``.
It is bound by device memory: each step reads every window's K|V^T block
once (2.4 GB at medium.en, batch 32) for 2 FLOPs a byte. One CTA per
(head, window) streams its block in two coalesced passes, shares it
between the window's beam lanes, keeps the logits in shared memory, and
takes the layer as an offset into the full stack, so no per-layer copy
is made. ``_cross_attention_decode_plain`` is the same function in plain
PyTorch: the CPU path and the kernel's oracle.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_LANE = 128


def pack_int4(q: torch.Tensor, dim: int) -> torch.Tensor:
    """Split-half int4 packing along ``dim`` (even-sized): byte ``i``
    holds value ``i`` in its low nibble and value ``i + n/2`` in its high
    nibble. Values must be in [-7, 7]."""
    n = q.shape[dim]
    lo = q.narrow(dim, 0, n // 2).to(torch.int32)
    hi = q.narrow(dim, n // 2, n // 2).to(torch.int32)
    return ((lo & 0xF) | (hi << 4)).to(torch.int8)


def unpack_int4(packed: torch.Tensor, dim: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: int8 bytes -> int32 values in
    [-7, 7], doubling ``dim``."""
    p = packed.to(torch.int32)
    return torch.cat([(p << 28) >> 28, p >> 4], dim=dim)


def quantize_decode_layout(x: torch.Tensor, bits: int = 8):
    """``[l, B, T, H, D]`` K or V -> (``[l, B, H, D(/2), Kp]`` int8 in the
    decode layout, ``[l, H, D]`` f32 scales); per-(layer, head, channel)
    symmetric quantization, scale ``amax * (1/qmax)`` in f32 (as XLA
    compiles the JAX package's jitted ``amax / qmax``), 1.0 where amax is 0."""
    qmax = 127.0 if bits == 8 else 7.0
    xf = x.float()
    amax = xf.abs().amax(dim=(1, 2))  # [l, H, D]
    scale = torch.where(amax > 0, amax * (1.0 / qmax), torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[:, None, None]), -qmax, qmax)
    q = q.to(torch.int8).permute(0, 1, 3, 4, 2)  # [l, B, H, D, T]
    t = x.shape[2]
    q = torch.nn.functional.pad(q, (0, -t % _LANE))
    if bits == 4:
        q = pack_int4(q, dim=3)
    return q.contiguous(), scale


def quantize_cross_kv_decode(cross_kv_k, cross_kv_v, bits: int = 8) -> dict:
    """``[L, B, T, H, D]`` K and V -> fused decode-layout dict (``kv_dec``
    ``[L, B, H, 2D, Kp]``, or ``[L, B, H, D, Kp]`` for bits=4)."""
    k_q, k_scale = quantize_decode_layout(cross_kv_k, bits)
    v_q, v_scale = quantize_decode_layout(cross_kv_v, bits)
    return {
        "kv_dec": torch.cat([k_q, v_q], dim=3),
        "k_dec_scale": k_scale,
        "v_dec_scale": v_scale,
        "k_len": cross_kv_k.shape[2],
        "bits": bits,
    }


def split_unpack(blk: torch.Tensor, bits: int):
    """Fused block(s) ``[..., R, Kp]`` -> (K, V^T) ``[..., D, Kp]`` as
    integer tensors (int8 for bits=8, int32 for bits=4)."""
    half = blk.shape[-2] // 2
    k, vt = blk[..., :half, :], blk[..., half:, :]
    if bits == 4:
        return unpack_int4(k, dim=-2), unpack_int4(vt, dim=-2)
    return k, vt


def _cross_attention_decode_plain(qs, kv_dec, layer, k_len, bits, beam):
    """Plain PyTorch version of kernel A, with the TPU kernel's numerics:
    q and the softmax weights rounded to bf16, f32 sums.
    ``qs``: [W·beam, H, D] f32 with k_scale·D^-½ folded in ->
    [W·beam, H, D] f32 before the v_scale."""
    bq, h, d = qs.shape
    k, vt = split_unpack(kv_dec[layer], bits)  # [W, H, D, Kp]
    q = qs.to(torch.bfloat16).float().reshape(bq // beam, beam, h, d)
    logits = torch.einsum("wmhd,whdt->whmt", q, k.float())
    pos = torch.arange(logits.shape[-1], device=logits.device)
    logits = logits.masked_fill(pos >= k_len, float("-inf"))
    w = torch.softmax(logits, dim=-1).to(torch.bfloat16).float()
    out = torch.einsum("whmt,whdt->wmhd", w, vt.float())
    return out.reshape(bq, h, d)


@functools.lru_cache(maxsize=1)
def _kernel():
    fn = _build.load("cross_decode").wnt_cross_decode
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _cross_attention_decode_cuda(qs, kv_dec, layer, k_len, bits, beam):
    """Launch kernel A: same contract as ``_cross_attention_decode_plain``."""
    bq, h, d = qs.shape
    n_layers, n_windows, kh, rows, kp = kv_dec.shape
    if qs.dtype != torch.float32 or kv_dec.dtype != torch.int8:
        raise TypeError(f"cross decode takes f32 q and int8 KV, got {qs.dtype}, {kv_dec.dtype}")
    if qs.device.type != "cuda" or kv_dec.device != qs.device:
        raise ValueError(f"kernel A takes q and KV on one CUDA device, got {qs.device}, {kv_dec.device}")
    if not (qs.is_contiguous() and kv_dec.is_contiguous()) or kv_dec.data_ptr() % 4:
        raise ValueError("cross decode takes contiguous q and KV, the KV 4-byte aligned")
    if (
        bq != n_windows * beam or kh != h
        or rows != (2 * d if bits == 8 else d) or kp % 4 or d % 4
        or not 0 <= layer < n_layers or not 0 < k_len <= kp
    ):
        raise ValueError(
            f"cross decode shapes: q {tuple(qs.shape)}, KV {tuple(kv_dec.shape)},"
            f" beam {beam}, bits {bits}, layer {layer}, k_len {k_len}"
        )
    out = torch.empty((bq, h, d), dtype=torch.float32, device=qs.device)
    rc = _kernel()(
        qs.data_ptr(), kv_dec.data_ptr(), out.data_ptr(),
        n_layers, n_windows, h, d, kp, k_len, layer, beam, bits,
        torch.cuda.current_stream(qs.device).cuda_stream,
    )
    _build.check(rc, "cross_decode")
    cross_attention_decode_layered.launches += 1
    return out


def cross_attention_decode_layered(
    q: torch.Tensor,  # [B·beam, 1, H, D]
    kv_dec: torch.Tensor,  # [L, B, H, 2D, Kp] int8: the full stack
    k_scale: torch.Tensor,  # [H, D] f32, this layer's
    v_scale: torch.Tensor,  # [H, D] f32, this layer's
    layer: int,
    k_len: int,
    bits: int = 8,
    beam: int = 1,
) -> torch.Tensor:
    """Single-query quantized cross-attention of layer ``layer`` ->
    ``[B·beam, 1, H, D]`` f32. Kernel A on a CUDA tensor, the plain
    version on a CPU tensor. The ``beam`` lanes of a window (row-major,
    ``[w0 lanes.., w1 lanes..]``) share its K/V."""
    d = q.shape[-1]
    qs = (q[:, 0].float() * (k_scale * d**-0.5)[None]).contiguous()
    if q.device.type == "cpu":
        out = _cross_attention_decode_plain(qs, kv_dec, layer, k_len, bits, beam)
    else:
        out = _cross_attention_decode_cuda(qs, kv_dec, layer, k_len, bits, beam)
    return (out * v_scale[None])[:, None]


cross_attention_decode_layered.launches = 0

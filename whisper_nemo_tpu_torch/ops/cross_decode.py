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
once (2.4 GB at medium.en, batch 32) for 2 FLOPs a byte. A thread-block
cluster of CTAs per (head, window) splits the positions, each CTA issuing
all its bytes at once; the softmax stays exact across the split through
two exchanges of per-lane maxima and sums in distributed shared memory,
and the partial outputs are summed across the cluster in rank order. The
beam lanes of a window share the reads, the scale fold (q by k_scale and
D^-½, the output by v_scale) runs in the kernel, so a call is one launch,
and the layer is an offset into the full stack, so no per-layer copy is
made. ``_cross_attention_decode_plain`` is the same function in plain
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


def fold_q(q, k_scale):
    """The query as the plain version takes it: ``q [W·beam, 1, H, D]``
    in f32 times ``k_scale · D^-½`` (``[W·beam, H, D]``)."""
    return (q[:, 0].float() * (k_scale * q.shape[-1] ** -0.5)[None]).contiguous()


@functools.lru_cache(maxsize=1)
def _kernel():
    fn = _build.load("cross_decode").wnt_cross_decode
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_Q_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _cluster_size(windows: int, heads: int, kp: int, sms: int) -> int:
    """CTAs that split one (head, window): enough for about two CTAs per
    SM across the ``windows · heads`` pairs on a card of ``sms`` SMs,
    between 2 and 8 (the portable cluster), and enough that a CTA holds at
    most 1024 positions. On the H100 (132 SMs) one window (16 pairs) takes
    8; the batched decode's 32 windows take 2 (``chip_smoke.py`` phase 3
    times 2, 4 and 8 at both)."""
    c = min(8, max(2, -(-2 * sms // (windows * heads))))
    return max(c, -(-kp // 1024))


def _cross_attention_decode_cuda(q, kv_dec, k_scale, v_scale, layer, k_len, bits, beam,
                                 cluster=None):
    """Launch kernel A: ``q [W·beam, 1, H, D]`` (bf16 or f32), this
    layer's ``k_scale``/``v_scale`` ``[H, D]`` f32 -> ``[W·beam, H, D]``
    f32, v_scale applied; the same function as
    ``_cross_attention_decode_plain(fold_q(q, k_scale), ...) · v_scale``.
    ``cluster`` overrides :func:`_cluster_size` (1-8) for measurement and
    tests only (``chip_smoke.py``'s sweeps, the ``cuda`` tests): the
    port's callers leave it unset."""
    bq, _, h, d = q.shape
    n_layers, n_windows, kh, rows, kp = kv_dec.shape
    if q.dtype not in _Q_DTYPES or kv_dec.dtype != torch.int8:
        raise TypeError(f"cross decode takes bf16 or f32 q and int8 KV, got {q.dtype}, {kv_dec.dtype}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError(f"cross decode takes f32 scales, got {k_scale.dtype}, {v_scale.dtype}")
    if q.device.type != "cuda" or any(x.device != q.device for x in (kv_dec, k_scale, v_scale)):
        raise ValueError(
            f"kernel A takes q, KV and scales on one CUDA device, got {q.device}, {kv_dec.device},"
            f" {k_scale.device}, {v_scale.device}"
        )
    if not all(x.is_contiguous() for x in (q, kv_dec, k_scale, v_scale)) or kv_dec.data_ptr() % 16:
        raise ValueError("cross decode takes contiguous q, KV and scales, the KV 16-byte aligned")
    if cluster is None:
        cluster = _cluster_size(n_windows, h, kp, _sms(q.device.index))
    if (
        bq != n_windows * beam or kh != h or q.shape[1] != 1
        or rows != (2 * d if bits == 8 else d) or kp % 32 or d != 64
        or k_scale.shape != (h, d) or v_scale.shape != (h, d)
        or not 0 <= layer < n_layers or not 0 < k_len <= kp or not 1 <= beam <= 8
        or not 1 <= cluster <= 8
    ):
        raise ValueError(
            f"cross decode shapes: q {tuple(q.shape)}, KV {tuple(kv_dec.shape)}, scales"
            f" {tuple(k_scale.shape)}, beam {beam}, bits {bits}, layer {layer}, k_len {k_len},"
            f" cluster {cluster}"
        )
    out = torch.empty((bq, h, d), dtype=torch.float32, device=q.device)
    rc = _kernel()(
        q.data_ptr(), kv_dec.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(),
        n_layers, n_windows, h, d, kp, k_len, layer, beam, bits, _Q_DTYPES[q.dtype], cluster,
        _build.stream(q.device),
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
    ``[B·beam, 1, H, D]`` f32. Kernel A on a CUDA tensor (one launch), the
    plain version on a CPU tensor. The ``beam`` lanes of a window
    (row-major, ``[w0 lanes.., w1 lanes..]``) share its K/V."""
    if q.device.type == "cpu":
        out = _cross_attention_decode_plain(fold_q(q, k_scale), kv_dec, layer, k_len, bits, beam)
        return (out * v_scale[None])[:, None]
    return _cross_attention_decode_cuda(q, kv_dec, k_scale, v_scale, layer, k_len, bits, beam)[:, None]


cross_attention_decode_layered.launches = 0

"""Row permute of a beam-search KV cache, out of place or in place.

Counterpart of ``whisper_nemo_tpu/ops/beam_permute.py``: new beam ``j``
inherits the history of its source row. The port's beam search keeps an
ancestry map instead and never permutes its cache (``ops/self_decode.py``),
so nothing on its path calls this; it serves a decoder that reorders its
cache, as CTranslate2's beam search does.

Kernel F (``csrc/beam_permute.cu``) replaces the TPU kernels
``beam_permute_cache`` and ``beam_permute_cache_inplace``. It is bound by
device memory: each byte is read once and written once. Out of place, one
CTA per (layer, output row, chunk) copies 16-byte vectors from the source
row; in place, one CTA per (layer, window, chunk) stages that chunk of the
window's lanes in shared memory before writing them back permuted.
``_beam_permute_plain`` and ``_beam_permute_inplace_plain`` are the plain
versions: the CPU path and the kernel's oracle, bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from . import _build


def _beam_permute_plain(k, v, idx):
    return k[:, idx], v[:, idx]


def _window_rows(src: torch.Tensor, beam: int) -> torch.Tensor:
    """``[W, beam]`` source lanes -> ``[W·beam]`` source rows."""
    return (torch.arange(src.shape[0], device=src.device)[:, None] * beam + src).reshape(-1)


def _beam_permute_inplace_plain(k, v, src, beam):
    idx = _window_rows(src.long(), beam)
    k.copy_(k[:, idx])
    v.copy_(v[:, idx])
    return k, v


@functools.lru_cache(maxsize=1)
def _kernels():
    lib = _build.load("beam_permute")
    copy, inplace = lib.wnt_beam_permute, lib.wnt_beam_permute_inplace
    copy.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    inplace.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    copy.restype = inplace.restype = ctypes.c_int
    return copy, inplace


def _check(k, v, index, what):
    """Device, shape and layout checks; -> (L, rows, row_bytes, vector
    bytes, index as contiguous int32)."""
    if k.device.type != "cuda" or v.device != k.device or index.device != k.device:
        raise ValueError(
            f"kernel F takes k, v and {what} on one CUDA device, got {k.device}, {v.device},"
            f" {index.device}"
        )
    if k.shape != v.shape or k.dtype != v.dtype or k.dim() < 3:
        raise ValueError(f"kernel F takes k and v of one shape and dtype, rank >= 3: {k.shape}, {v.shape}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("kernel F takes contiguous k and v")
    row_bytes = math.prod(k.shape[2:]) * k.element_size()
    vec = next(n for n in (16, 8, 4, 2, 1)
               if row_bytes % n == 0 and k.data_ptr() % n == 0 and v.data_ptr() % n == 0)
    return k.shape[0], k.shape[1], row_bytes, vec, index.to(torch.int32).contiguous()


def beam_permute_cache(
    k: torch.Tensor,  # [L, R, ...]
    v: torch.Tensor,  # [L, R, ...]
    idx: torch.Tensor,  # [R] int: output row j <- input row idx[j]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(k[:, idx], v[:, idx])`` for any rank >= 3 with leading (layers,
    rows) axes: kernel F on a CUDA tensor, the plain version on a CPU
    tensor."""
    if k.device.type == "cpu":
        return _beam_permute_plain(k, v, idx)
    n_layers, rows, row_bytes, vec, idx32 = _check(k, v, idx, "idx")
    if idx32.shape != (rows,):
        raise ValueError(f"beam permute: idx {tuple(idx.shape)} for {rows} rows")
    k_out, v_out = torch.empty_like(k), torch.empty_like(v)
    rc = _kernels()[0](
        k.data_ptr(), v.data_ptr(), idx32.data_ptr(), k_out.data_ptr(), v_out.data_ptr(),
        n_layers, rows, row_bytes, vec, _build.stream(k.device),
    )
    _build.check(rc, "beam_permute")
    beam_permute_cache.launches += 1
    return k_out, v_out


beam_permute_cache.launches = 0


def beam_permute_cache_inplace(
    k: torch.Tensor,  # [L, W·beam, ...], overwritten
    v: torch.Tensor,  # [L, W·beam, ...], overwritten
    src: torch.Tensor,  # [W, beam] int: new lane j <- window lane src[w, j]
    beam: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Permutes each window's ``beam`` lanes within ``k`` and ``v``
    themselves, gather repeats included, and returns them: kernel F on a
    CUDA tensor, the plain version on a CPU tensor."""
    if k.shape[1] % beam:
        raise ValueError(f"rows {k.shape[1]} not a multiple of beam {beam}")
    if k.device.type == "cpu":
        return _beam_permute_inplace_plain(k, v, src, beam)
    n_layers, rows, row_bytes, vec, src32 = _check(k, v, src, "src")
    if src32.shape != (rows // beam, beam):
        raise ValueError(f"beam permute: src {tuple(src.shape)} for {rows} rows of beam {beam}")
    rc = _kernels()[1](
        k.data_ptr(), v.data_ptr(), src32.data_ptr(), n_layers, rows // beam, beam,
        row_bytes, vec, _build.stream(k.device),
    )
    _build.check(rc, "beam_permute_inplace")
    beam_permute_cache_inplace.launches += 1
    return k, v


beam_permute_cache_inplace.launches = 0

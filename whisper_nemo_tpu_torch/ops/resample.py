"""Polyphase resampling on the device.

Counterpart of ``whisper_nemo_tpu/ops/resample.py``: the
``scipy.signal.resample_poly`` sum (insert ``up - 1`` zeros between
samples, low-pass with a Kaiser-windowed sinc, keep every ``down``-th
sample) in its polyphase form. Each block of ``up`` consecutive outputs
reads one window of ``W`` input samples, so the signal is framed at hop
``down`` as a strided view (``unfold``) and contracted with a dense
``[up, W]`` polyphase matrix in one GEMM, in f32.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from .framing import frame_signal


@lru_cache(maxsize=32)
def _design_filter(up: int, down: int) -> np.ndarray:
    """``scipy.signal.resample_poly``'s default low-pass: half length
    ``10 * max(up, down)``, cutoff at the tighter of the two Nyquists,
    Kaiser beta 5.0, gain ``up`` (the zeros inserted lose that much)."""
    max_rate = max(up, down)
    half = 10 * max_rate
    n = np.arange(-half, half + 1, dtype=np.float64)
    cutoff = 1.0 / max_rate  # a fraction of the upsampled Nyquist
    h = cutoff * np.sinc(cutoff * n)
    h *= np.kaiser(2 * half + 1, 5.0)
    h *= up
    return h.astype(np.float32)


@lru_cache(maxsize=32)
def _polyphase_matrix(up: int, down: int):
    """``(G, off, W)``: the ``[up, W]`` polyphase matrix. Output
    ``k = m * up + p`` is ``sum_i h[i] * x_up[k * down - half + i]``; every
    tap that lands on a real sample reads input ``m * down - off + j``
    for some ``j`` in ``[0, W)``, with ``off = half // up``, so
    ``G[p, j] = h[(j - off) * up - p * down + half]`` (0 where that tap
    lies outside the filter)."""
    h = _design_filter(up, down).astype(np.float64)
    half = (len(h) - 1) // 2
    off = half // up
    width = off + (2 * half + (up - 1) * down) // up + 1
    j = np.arange(width)
    p = np.arange(up)
    i = (j[None, :] - off) * up - p[:, None] * down + half
    valid = (i >= 0) & (i <= 2 * half)
    mat = np.where(valid, h[np.clip(i, 0, 2 * half)], 0.0)
    return mat.astype(np.float32), off, width


def resample_poly(x: torch.Tensor, orig_sr: int, target_sr: int) -> torch.Tensor:
    """``[..., T]`` at ``orig_sr`` -> ``[..., ceil(T * up / down)]`` at
    ``target_sr``, on ``x``'s device; output sample ``k`` lies at input
    time ``k * down / up``, as scipy's does. The input is zero beyond its
    ends. Computed in f32 and returned in ``x``'s dtype."""
    g = math.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    if up == 1 and down == 1:
        return x
    t = x.shape[-1]
    out_len = -(-t * up // down)
    mat, off, width = _polyphase_matrix(up, down)
    n_blocks = -(-out_len // up)
    flat = x.reshape(-1, t).float()
    # block m's window starts at input m * down - off: ``off`` zeros on the
    # left put it at m * down; frame_signal pads the right end with zeros
    frames = frame_signal(torch.nn.functional.pad(flat, (off, 0)), n_blocks, width, down)
    g_mat = torch.from_numpy(mat).to(x.device)
    y = torch.matmul(frames, g_mat.t()).reshape(flat.shape[0], n_blocks * up)[:, :out_len]
    return y.reshape(*x.shape[:-1], out_len).to(x.dtype)

"""Signal framing and per-frame energy in PyTorch.

Counterpart of ``whisper_nemo_tpu/ops/framing.py``. Frames are a strided
view of the signal (``unfold``); the JAX package builds them from shifted
reshapes because element gathers are slow on the TPU. A frame's energy is
a sum over whole hop blocks plus part of the next one, so only the
``[T / hop]`` block sums of the squared signal are formed, never the
``[n_frames, win]`` frame matrix.
"""

from __future__ import annotations

import torch


def frame_signal(x: torch.Tensor, n_frames: int, win: int, hop: int) -> torch.Tensor:
    """``[B, T]`` (or ``[T]``) -> ``[B, n_frames, win]`` frames at stride
    ``hop``, a view where the signal reaches the last frame; a shorter one
    is zero-padded first."""
    need = (n_frames - 1) * hop + win
    if x.shape[-1] < need:
        x = torch.nn.functional.pad(x, (0, need - x.shape[-1]))
    return x.unfold(-1, win, hop)[..., :n_frames, :]


def frame_energy(x: torch.Tensor, n_frames: int, win: int, hop: int) -> torch.Tensor:
    """``[B, T]`` (or ``[T]``) -> ``[B, n_frames]`` per-frame mean-square
    energy, f32, on ``x``'s device."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    k, rem = divmod(win, hop)
    need = ((win - 1) // hop) * hop + n_frames * hop
    if x.shape[-1] < need:
        x = torch.nn.functional.pad(x, (0, need - x.shape[-1]))
    total_blocks = x.shape[-1] // hop
    blocks = x[:, : total_blocks * hop].float().square()
    blocks = blocks.reshape(x.shape[0], total_blocks, hop)
    block_sums = blocks.sum(dim=-1)  # [B, total_blocks]
    acc = torch.zeros((x.shape[0], n_frames), dtype=torch.float32, device=x.device)
    for q in range(k):
        acc = acc + block_sums[:, q : q + n_frames]
    if rem:
        acc = acc + blocks[:, k : k + n_frames, :rem].sum(dim=-1)
    energy = acc / win
    return energy[0] if squeeze else energy

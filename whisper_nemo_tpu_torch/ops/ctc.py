"""CTC Viterbi forced alignment: the batched trellis sweep and its callers.

Counterpart of ``whisper_nemo_tpu/ops/ctc.py``. The CTC trellis has
``L = 2N + 1`` blank-interleaved label states; emissions are gathered
into state space once (``[R, T, L]``), then a max-plus recurrence runs
over time with one backpointer per state and step (0 stay, 1 prev,
2 skip), and a backtrack turns the backpointers into the state path.

Kernel D (``csrc/viterbi.cu``) replaces the TPU kernel
``whisper_nemo_tpu/ops/viterbi_pallas.py:viterbi_forward_pallas``, batched
over rows: the JAX package runs the segmented path's rows through a
vmapped ``lax.scan`` and only the global aligner through the Pallas
kernel; here one kernel serves both. It is bound by latency, not bytes:
T dependent steps. At the segmented main bucket (R = 48, T = 2560,
L = 1025) its traffic, about 504 MB of emissions read and 126 MB of
backpointers written, takes 0.19 ms at 3.35 TB/s, while the sweep is
2,559 steps in sequence. Since the recurrence only looks left, a row's
states are cut into segments of one warp each (lane ``l`` holds states
``s0 + l + 32i`` in registers and takes its left neighbours by shuffle),
and each segment hands its last two states of every step to the next
through shared memory, or distributed shared memory across the CTAs of
a cluster: a wavefront with no block-wide barrier. A trellis wider than
one cluster's 65,536 states is swept in passes, each handing its right
edge to the next through a small global buffer. Emissions load into
registers a few steps ahead, backpointers leave as coalesced 32-byte
rows, and the same launch backtracks. ``_viterbi_forward_states`` and
``_viterbi_backtrack`` are its plain version: the CPU path and the
kernel's oracle. All three agree bit for bit: one f32 add per state and
step, an exact max, ties to stay, then prev, then skip (``argmax``'s
first maximum).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

NEG_INF = -1e30  # finite: sums with it stay ordered


def _gather_state_emissions(emissions: torch.Tensor, state_labels: torch.Tensor) -> torch.Tensor:
    """``[R, T, V]`` emissions and ``[R, L]`` state labels -> contiguous
    ``[R, T, L]`` (one gather; the index is broadcast over time, not
    materialized)."""
    r, t, _ = emissions.shape
    index = state_labels.to(torch.int64)[:, None, :].expand(r, t, state_labels.shape[-1])
    return torch.gather(emissions, 2, index).contiguous()


def _trellis_arrays(labels: np.ndarray, blank: int):
    """(state labels, skip permissions) of the blank-interleaved trellis
    of ``labels``: a label state may be entered by a skip when its label
    differs from the previous one."""
    ll = 2 * len(labels) + 1
    state_labels = np.full((ll,), blank, np.int32)
    state_labels[1::2] = labels
    allow_skip = np.zeros((ll,), bool)
    allow_skip[3::2] = labels[1:] != labels[:-1]
    return state_labels, allow_skip


def _viterbi_forward_states(
    e_states: torch.Tensor, allow_skip: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain trellis sweep: ``[R, T, L]`` f32 state emissions and
    ``[R, L]`` bool skip permissions -> (final alpha ``[R, L]`` f32,
    backpointers ``[R, T-1, L]`` int8)."""
    r, t, n_states = e_states.shape
    states = torch.arange(n_states, device=e_states.device)
    alpha = torch.where(states < 2, e_states[:, 0], NEG_INF)
    bps = torch.empty((r, max(t - 1, 0), n_states), dtype=torch.int8, device=e_states.device)
    skip_ok = allow_skip.to(torch.bool)
    for step in range(1, t):
        prev = F.pad(alpha, (1, 0), value=NEG_INF)[:, :n_states]
        skip = F.pad(alpha, (2, 0), value=NEG_INF)[:, :n_states]
        skip = torch.where(skip_ok, skip, NEG_INF)
        bp = (prev > alpha).to(torch.int8)
        best = torch.maximum(alpha, prev)
        bp = torch.where(skip > best, 2, bp).to(torch.int8)
        best = torch.maximum(best, skip)
        alpha = e_states[:, step] + best
        bps[:, step - 1] = bp
    return alpha, bps


def _viterbi_backtrack(alpha: torch.Tensor, bps: torch.Tensor) -> torch.Tensor:
    """Plain backtrack: start in the last state unless the one before it
    scores higher, then ``s -= bps[t][s]`` backwards -> paths ``[R, T]``
    int32."""
    r, n_states = alpha.shape
    t = bps.shape[1] + 1
    rows = torch.arange(r, device=alpha.device)
    s = torch.where(
        alpha[:, n_states - 1] >= alpha[:, max(n_states - 2, 0)], n_states - 1, n_states - 2
    ).to(torch.int64)
    path = torch.empty((r, t), dtype=torch.int64, device=alpha.device)
    path[:, t - 1] = s
    for step in range(t - 2, -1, -1):
        s = s - bps[rows, step, s].to(torch.int64)
        path[:, step] = s
    return path.to(torch.int32)


@functools.lru_cache(maxsize=1)
def _kernel():
    lib = _build.load("viterbi")
    fn = lib.wnt_viterbi
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.wnt_viterbi_pass_states.restype = ctypes.c_int
    return fn, lib.wnt_viterbi_pass_states()


def _viterbi_cuda(e_states: torch.Tensor, allow_skip: torch.Tensor):
    """Launch kernel D: same contract as the plain forward sweep plus
    backtrack, at any number of states (a trellis wider than one pass
    takes an edge buffer of ``[R, 2, T, 2]`` f32)."""
    if e_states.device.type != "cuda" or allow_skip.device != e_states.device:
        raise ValueError(
            f"kernel D takes emissions and skips on one CUDA device, got"
            f" {e_states.device}, {allow_skip.device}"
        )
    if e_states.dtype != torch.float32 or allow_skip.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"kernel D takes f32 emissions and bool skips, got {e_states.dtype}, {allow_skip.dtype}")
    if e_states.dim() != 3 or allow_skip.shape != (e_states.shape[0], e_states.shape[2]):
        raise ValueError(f"kernel D shapes: emissions {tuple(e_states.shape)}, skips {tuple(allow_skip.shape)}")
    if not (e_states.is_contiguous() and allow_skip.is_contiguous()):
        raise ValueError("kernel D takes contiguous emissions and skips")
    r, t, n_states = e_states.shape
    launch, pass_states = _kernel()
    if r == 0 or t == 0 or n_states == 0 or r > 65535:
        raise ValueError(
            f"kernel D takes a non-empty trellis of at most 65535 rows, got {tuple(e_states.shape)}"
        )
    dev = e_states.device
    alpha = torch.empty((r, n_states), dtype=torch.float32, device=dev)
    bps = torch.empty((r, t - 1, n_states), dtype=torch.int8, device=dev)
    path = torch.empty((r, t), dtype=torch.int32, device=dev)
    edge = torch.empty((r, 2, t, 2), dtype=torch.float32, device=dev) if n_states > pass_states else None
    rc = launch(
        e_states.data_ptr(), allow_skip.view(torch.uint8).data_ptr(),
        alpha.data_ptr(), bps.data_ptr(), path.data_ptr(),
        None if edge is None else edge.data_ptr(), r, t, n_states, _build.stream(dev),
    )
    _build.check(rc, "viterbi")
    viterbi_batch.launches += 1
    return alpha, bps, path


def viterbi_batch(
    e_states: torch.Tensor, allow_skip: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched CTC Viterbi over ``[R, T, L]`` f32 state emissions with
    ``[R, L]`` bool skip permissions -> (final alpha ``[R, L]`` f32,
    backpointers ``[R, T-1, L]`` int8, state paths ``[R, T]`` int32).
    Kernel D on a CUDA tensor, the plain version on a CPU tensor."""
    if e_states.device.type == "cpu":
        alpha, bps = _viterbi_forward_states(e_states, allow_skip)
        return alpha, bps, _viterbi_backtrack(alpha, bps)
    return _viterbi_cuda(e_states, allow_skip)


viterbi_batch.launches = 0


def forced_align(
    emissions,  # [T, V] log-probs, star column at index V-1
    labels: np.ndarray,  # [N] int label ids into the emission columns
    blank_id: int = 0,
    device="cuda",
) -> Tuple[np.ndarray, float]:
    """Viterbi-align ``labels`` to ``emissions`` (numpy, or a tensor,
    which is moved to ``device``).

    Returns (frame_labels [T] — the label *state index* path encoded as
    -1 for blank frames and the label position 0..N-1 otherwise — and
    the path log-score)."""
    em = torch.as_tensor(emissions, dtype=torch.float32).to(device)
    T = em.shape[0]
    N = len(labels)
    if N == 0:
        return np.full((T,), -1, np.int32), float(em[:, blank_id].cpu().numpy().sum())
    state_labels, allow_skip = _trellis_arrays(np.asarray(labels), blank_id)
    e_states = _gather_state_emissions(em[None], torch.from_numpy(state_labels).to(em.device)[None])
    alpha, _, path = viterbi_batch(e_states, torch.from_numpy(allow_skip).to(em.device)[None])
    path = path[0].cpu().numpy()
    score = float(alpha[0, int(path[-1])])

    frame_labels = np.where(path % 2 == 1, (path - 1) // 2, -1)
    return frame_labels.astype(np.int32), score


def label_segments(
    frame_labels: np.ndarray,
    emissions: np.ndarray,
    labels: np.ndarray,
) -> List[dict]:
    """Per-label (start, end) frame spans and mean-probability scores.

    A label occupies the contiguous run of frames Viterbi assigned to
    it; labels squeezed to zero frames inherit a point span at their
    neighbor boundary.
    """
    N = len(labels)
    out: List[dict] = []
    starts = np.full(N, -1, np.int64)
    ends = np.full(N, -1, np.int64)
    for t, li in enumerate(frame_labels):
        if li >= 0:
            if starts[li] < 0:
                starts[li] = t
            ends[li] = t + 1
    prev_end = 0
    for i in range(N):
        s, e = starts[i], ends[i]
        if s < 0:  # label got no frames: zero-width at previous boundary
            s = e = prev_end
        score = (
            float(np.exp(emissions[s:e, labels[i]]).mean()) if e > s else 0.0
        )
        out.append(
            {"label": int(labels[i]), "start": int(s), "end": int(e),
             "score": score}
        )
        prev_end = e
    return out


def add_star_column(
    emissions: np.ndarray, blank_id: int = 0, discount: float = float(np.log(0.5))
) -> np.ndarray:
    """Append a wildcard emission column: per-frame max over non-blank
    symbols, discounted by ``discount`` (log-space) so a true label
    always beats the wildcard on its own frames while the wildcard still
    absorbs audio no label explains."""
    masked = emissions.copy()
    masked[:, blank_id] = NEG_INF
    star = masked.max(axis=1, keepdims=True) + discount
    return np.concatenate([emissions, star], axis=1)

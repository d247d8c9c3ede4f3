"""Multiscale diarization decoder (MSDD) in PyTorch.

Counterpart of ``whisper_nemo_tpu/models/msdd.py``. Given multiscale
segment embeddings and each speaker's cluster-average embedding, an LSTM
per speaker pair over the scale-similarity features gives each speaker a
sigmoid speech probability per segment, so two speakers can be active at
once. Pairs run as one batch, windows of ``diar_window`` seconds ride the
batch axis, and the remainder window runs at its exact length.

The LSTM's gates are in the order i, f, g, o with one bias. The input
products of every step are one GEMM before the time loop; the loop
multiplies only the hidden state, the same sums in the same order as a
step that does both.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

Params = Dict[str, Any]


@dataclass(frozen=True)
class MsddDims:
    n_scales: int = 5
    emb_dim: int = 192
    hidden: int = 256
    proj: int = 96


def _lstm(p: Params, xs: torch.Tensor) -> torch.Tensor:
    """``[B, T, F]`` -> ``[B, T, H]``, one direction."""
    b, t, _ = xs.shape
    xw = xs @ p["wx"]  # [B, T, 4H]
    h = xs.new_zeros((b, p["wh"].shape[0]))
    c = torch.zeros_like(h)
    hs = []
    for s in range(t):
        i, f, g, o = (xw[:, s] + h @ p["wh"] + p["b"]).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-8)


def pair_features(seg_embs: torch.Tensor, spk_avg: torch.Tensor,
                  scale_weights: torch.Tensor) -> torch.Tensor:
    """Scale-similarity features of one speaker pair, ``[T, 2S+2]``: per
    scale the cosine similarity of each segment to both speakers'
    averages, then their scale-weighted sums. ``seg_embs`` is
    ``[S, T, D]``, ``spk_avg`` ``[S, 2, D]``."""
    return _window_features(seg_embs[:, None], spk_avg[None], scale_weights)[0, 0]


def _window_features(seg_win: torch.Tensor, avg_pairs: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """``[S, n_win, Tc, D]`` windows x ``[P, S, 2, D]`` pair averages ->
    ``[P, n_win, Tc, 2S+2]``."""
    sims = torch.einsum("swtd,pskd->pwtsk", _unit(seg_win), _unit(avg_pairs))
    weighted = (sims * (w / w.sum())[:, None]).sum(dim=3)  # [P, n_win, Tc, 2]
    return torch.cat([sims.flatten(3), weighted], dim=-1)


def msdd_logits(params: Params, feats: torch.Tensor) -> torch.Tensor:
    """Pair features ``[B, T, 2S+2]`` -> per-speaker logits ``[B, T, 2]``.
    A converted checkpoint may lack the input projection ``in`` and carry
    a reverse-direction LSTM ``lstm_rev``."""
    x = feats
    if "in" in params:
        x = torch.tanh(x @ params["in"]["w"] + params["in"]["b"])
    h = _lstm(params["lstm"], x)
    if "lstm_rev" in params:
        h = torch.cat([h, _lstm(params["lstm_rev"], x.flip(1)).flip(1)], dim=-1)
    return h @ params["out"]["w"] + params["out"]["b"]


def init_msdd_params(dims: MsddDims, device, generator: torch.Generator) -> Params:
    """Seeded random f32 parameters on ``device`` from ``generator``
    (which must live on that device), scaled as the JAX package's."""

    def normal(shape, fan_in):
        return torch.randn(shape, device=device, generator=generator) / fan_in**0.5

    f_in = 2 * dims.n_scales + 2
    return {
        "in": {"w": normal((f_in, dims.proj), f_in),
               "b": torch.zeros(dims.proj, device=device)},
        "lstm": {"wx": normal((dims.proj, 4 * dims.hidden), dims.proj),
                 "wh": normal((dims.hidden, 4 * dims.hidden), dims.hidden),
                 "b": torch.zeros(4 * dims.hidden, device=device)},
        "out": {"w": normal((dims.hidden, 2), dims.hidden),
                "b": torch.zeros(2, device=device)},
    }


def _window_probs(params: Params, seg_win: torch.Tensor, avg_pairs: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """``[S, n_win, Tc, D]`` x ``[P, S, 2, D]`` -> sigmoid probabilities
    ``[P, n_win * Tc, 2]``."""
    feats = _window_features(seg_win, avg_pairs, w)
    p, n_win, tc, f = feats.shape
    logits = msdd_logits(params, feats.reshape(p * n_win, tc, f))
    return torch.sigmoid(logits).reshape(p, n_win * tc, 2)


def msdd_mean_sigmoids(
    params: Params,
    seg_embs: torch.Tensor,  # [n_scales, T, D]
    cluster_labels: np.ndarray,  # [T] from spectral clustering
    scale_weights: Sequence[float],
    diar_window: int = 50,
    seg_duration: float = 0.5,
    infer_batch_size: int = 25,
    overlap_infer_spk_limit: int = 5,
    split_infer: bool = True,
    stats: Optional[dict] = None,
):
    """Pair-averaged per-speaker sigmoids ``[T, n_spk]`` (numpy float64)
    and the sorted speaker labels; ``None`` in place of the sigmoids when
    MSDD does not apply (one speaker, or more than
    ``overlap_infer_spk_limit``). ``split_infer=False`` runs the whole
    sequence as one window. Runs on ``seg_embs``' device. ``stats``, where
    given, receives the pairs and windows run (``msdd_pairs``,
    ``msdd_windows``)."""
    seg = seg_embs.float()
    n_scales, t_total, d = seg.shape
    speakers = np.unique(np.asarray(cluster_labels))
    n_spk = len(speakers)
    if stats is not None:
        stats.update(msdd_pairs=0, msdd_windows=0)
    if n_spk == 1 or n_spk > overlap_infer_spk_limit:
        return None, speakers

    label_idx = torch.from_numpy(np.searchsorted(speakers, np.asarray(cluster_labels)))
    onehot = torch.nn.functional.one_hot(label_idx.to(seg.device), n_spk).float()  # [T, K]
    avg = torch.einsum("tk,std->skd", onehot, seg) / onehot.sum(dim=0).clamp(min=1.0)[None, :, None]

    w = torch.tensor(scale_weights, dtype=torch.float32, device=seg.device)
    window_t = max(1, int(diar_window / max(seg_duration, 1e-6))) if split_infer else t_total
    window_t = min(window_t, t_total)

    pairs = list(combinations(range(n_spk), 2))
    avg_pairs = avg[:, torch.tensor(pairs, device=seg.device)].movedim(1, 0)  # [P, S, 2, D]
    nw_full, rem = divmod(t_total, window_t)
    body = seg[:, : nw_full * window_t].reshape(n_scales, nw_full, window_t, d) if nw_full else None
    tail = seg[:, nw_full * window_t:][:, None] if rem else None
    if stats is not None:
        stats.update(msdd_pairs=len(pairs), msdd_windows=nw_full + (rem > 0))

    prob_parts = []
    for bstart in range(0, len(pairs), infer_batch_size):
        bpairs = avg_pairs[bstart: bstart + infer_batch_size]
        parts = [_window_probs(params, win, bpairs, w) for win in (body, tail) if win is not None]
        prob_parts.append(torch.cat(parts, dim=1))
    probs = torch.cat(prob_parts, dim=0).cpu().numpy()  # [P, t_total, 2]

    sig_sum = np.zeros((t_total, n_spk), np.float64)
    for pi, (a, b) in enumerate(pairs):
        sig_sum[:, a] += probs[pi, :, 0]
        sig_sum[:, b] += probs[pi, :, 1]
    sig_cnt = np.array([sum(1 for p in pairs if k in p) for k in range(n_spk)], np.float64)
    return sig_sum / np.maximum(sig_cnt[None, :], 1.0), speakers


def _binarize(mean_sig, speakers, cluster_labels, threshold: float):
    """Threshold mean sigmoids; empty segments fall back to the
    clustering label."""
    activity = mean_sig > threshold
    empty = ~activity.any(axis=1)
    for i, spk in enumerate(speakers):
        activity[empty & (cluster_labels == spk), i] = True
    return activity


def msdd_infer_multi(
    params: Params,
    seg_embs: torch.Tensor,  # [n_scales, T, D]
    cluster_labels: np.ndarray,  # [T] from spectral clustering
    scale_weights: Sequence[float],
    sigmoid_thresholds: Sequence[float] = (0.7,),
    diar_window: int = 50,
    seg_duration: float = 0.5,
    infer_batch_size: int = 25,
    overlap_infer_spk_limit: int = 5,
    split_infer: bool = True,
    stats: Optional[dict] = None,
) -> Dict[float, np.ndarray]:
    """Overlap-aware speaker activity ``{threshold: [T, n_spk] bool}`` at
    every threshold of the config's list: the pair LSTMs run once and
    each threshold binarizes the shared mean sigmoids."""
    mean_sig, speakers = msdd_mean_sigmoids(
        params, seg_embs, cluster_labels, scale_weights,
        diar_window=diar_window, seg_duration=seg_duration,
        infer_batch_size=infer_batch_size,
        overlap_infer_spk_limit=overlap_infer_spk_limit, split_infer=split_infer, stats=stats,
    )
    if mean_sig is None:
        activity = np.zeros((seg_embs.shape[1], len(speakers)), bool)
        for i, spk in enumerate(speakers):
            activity[:, i] = cluster_labels == spk
        return {float(th): activity for th in sigmoid_thresholds}
    return {float(th): _binarize(mean_sig, speakers, cluster_labels, float(th))
            for th in sigmoid_thresholds}


def msdd_infer(params: Params, seg_embs: torch.Tensor, cluster_labels: np.ndarray,
               scale_weights: Sequence[float], sigmoid_threshold: float = 0.7,
               **kwargs) -> np.ndarray:
    """Per-segment speaker activity ``[T, n_spk]`` bool at one threshold;
    the keywords are ``msdd_infer_multi``'s."""
    th = float(sigmoid_threshold)
    return msdd_infer_multi(params, seg_embs, cluster_labels, scale_weights,
                            sigmoid_thresholds=(th,), **kwargs)[th]

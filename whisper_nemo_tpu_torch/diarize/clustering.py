"""NME-SC spectral clustering for speaker diarization, in PyTorch.

Counterpart of ``whisper_nemo_tpu/diarize/clustering.py``: cosine
affinity over speaker embeddings, per-row top-p binarization with the
Normalized Maximum Eigengap (NME) criterion choosing p, the speaker count
from the Laplacian's eigengap, a spectral embedding and k-means, and the
long-form path that over-clusters chunks and reclusters their means.

An affinity given as a tensor stays on its device: the multiscale
affinity, the binarization, the Laplacian, the dense ``eigh`` (up to
``_NYSTROM_THRESHOLD`` segments), the Nyström blocks and extension, the
NME search's probes (one batched ``eigvalsh`` of every probe's
Laplacian) and the k-means of long-form chunks given as tensors. A numpy
affinity up to ``_NYSTROM_THRESHOLD`` segments takes the host path, numpy
code equal to the JAX package's, as do the small k-means of the spectral
embedding, of numpy chunks and the enhanced speaker count, so they
replay its draws exactly; past the threshold it becomes a tensor on the
host and takes the tensor path. The long-form k-means draws from a seeded
CPU ``torch.Generator``, the same on every device and not
``jax.random``'s: its partitions match the JAX package's up to
relabeling.

``stats``, where a caller passes a dict, gathers under
``stats["seconds"]`` the seconds of the stages it names (``nme_search``,
``eigen``, ``kmeans``), each timed after the device finished it, the path
taken (``path``: ``dense``,
``nystrom`` or ``longform``), the NME search's neighbour count
(``p_neighbors``, of the last clustering it ran) and the spectral
embedding's ``eigengap``:
the gap between the k-th and (k+1)-th smallest Laplacian eigenvalues, or
on the Nyström path the k-th and (k+1)-th largest of the anchors'. Where
it is 0 the k eigenvectors are any basis of a larger eigenspace, and two
eigensolvers (LAPACK's, cuSOLVER's) pick different ones, and so labels.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

_NYSTROM_THRESHOLD = 4096
_NYSTROM_ANCHORS = 1024


class _Stage:
    """Adds the seconds of a block to ``stats["seconds"][name]``, after the
    device finished its work; does nothing when ``stats`` is None."""

    def __init__(self, stats: Optional[dict], name: str, device=None):
        self.stats, self.name, self.device = stats, name, device

    def __enter__(self):
        if self.stats is not None:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.stats is not None:
            if self.device is not None and torch.device(self.device).type == "cuda":
                torch.cuda.synchronize(self.device)
            seconds = self.stats.setdefault("seconds", {})
            seconds[self.name] = seconds.get(self.name, 0.0) + time.perf_counter() - self.t0
        return False


def cosine_affinity(embeddings) -> np.ndarray:
    """``[N, D]`` -> ``[N, N]`` cosine similarity, f32, on the host."""
    if isinstance(embeddings, torch.Tensor):
        embeddings = embeddings.float().cpu().numpy()
    embs = np.asarray(embeddings, np.float32)
    unit = embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True), 1e-8)
    return unit @ unit.T


def multiscale_affinity(stacked_embs: torch.Tensor, weights) -> torch.Tensor:
    """``[S, N, D]`` per-scale embeddings -> the scale-weighted ``[N, N]``
    cosine affinity, on their device."""
    x = stacked_embs.float()
    unit = x / x.norm(dim=2, keepdim=True).clamp(min=1e-8)
    w = torch.as_tensor(np.asarray(weights), dtype=torch.float32, device=x.device)
    return torch.einsum("snd,smd->nm", unit * w[:, None, None], unit)


def _binarize_threshold(affinity: torch.Tensor, p: int) -> torch.Tensor:
    """Per-row top-p by the row's p-th largest value (ties at it keep
    more than p), symmetrized by 0.5·(B + Bᵀ)."""
    kth = torch.topk(affinity, p, dim=1).values[:, -1:]
    binarized = (affinity >= kth).float()
    return 0.5 * (binarized + binarized.T)


def binarize_top_p(affinity: np.ndarray, p_neighbors: int) -> np.ndarray:
    """Keep each row's top-p entries (as 1s), symmetrize by average."""
    n = affinity.shape[0]
    p = int(np.clip(p_neighbors, 1, n))
    idx = np.argpartition(-affinity, p - 1, axis=1)[:, :p]
    binarized = np.zeros_like(affinity)
    np.put_along_axis(binarized, idx, 1.0, axis=1)
    return 0.5 * (binarized + binarized.T)


def laplacian(affinity_bin: np.ndarray) -> np.ndarray:
    degree = np.diag(affinity_bin.sum(axis=1))
    return degree - affinity_bin


def eigen_decompose(lap: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Ascending eigenvalues and eigenvectors of a symmetric host matrix."""
    return np.linalg.eigh(np.asarray(lap, np.float32))


def estimate_num_speakers(evals: np.ndarray, max_num_speakers: int) -> Tuple[int, float]:
    """(speaker count, eigengap) from the largest gap among the smallest
    Laplacian eigenvalues."""
    evals = np.sort(np.maximum(evals, 0.0))
    bound = min(max_num_speakers, len(evals) - 1)
    gaps = evals[1: bound + 1] - evals[:bound]
    k = int(np.argmax(gaps)) + 1
    return k, float(gaps[k - 1])


def _nme_ratio(affinity: np.ndarray, p: int, max_num_speakers: int) -> Tuple[float, int]:
    lap = laplacian(binarize_top_p(affinity, p))
    evals = np.linalg.eigvalsh(np.asarray(lap, np.float32))
    n_spk, gap = estimate_num_speakers(evals, max_num_speakers)
    g = gap / (p + 1e-10)
    return (p / max(g, 1e-10)), n_spk


def _probe_evals(affinity: torch.Tensor, candidates: np.ndarray) -> np.ndarray:
    """Eigenvalues ``[len(candidates), m]`` of the Laplacian of every
    probe's top-p binarization (exactly p per row, the host rule), as one
    batched ``eigvalsh`` on the affinity's device, in float64."""
    m = affinity.shape[0]
    top = torch.topk(affinity, int(candidates.max()), dim=1).indices  # [m, p_max]
    ps = torch.as_tensor(candidates, device=affinity.device)
    keep = (torch.arange(top.shape[1], device=affinity.device)[None] < ps[:, None])
    binarized = torch.zeros((len(candidates), m, m), dtype=torch.float64, device=affinity.device)
    binarized.scatter_(2, top.expand(len(candidates), m, -1),
                       keep[:, None, :].expand(-1, m, -1).double())
    binarized = 0.5 * (binarized + binarized.transpose(1, 2))
    lap = torch.diag_embed(binarized.sum(dim=2)) - binarized
    return torch.linalg.eigvalsh(lap).cpu().numpy()


def nmesc_search(
    affinity,
    max_num_speakers: int = 8,
    max_rp_threshold: float = 0.25,
    sparse_search_volume: int = 30,
    search_subsample: int = 512,
    maj_vote_spk_count: bool = False,
) -> Tuple[int, int]:
    """(best p, estimated speaker count): the neighbour count p that
    minimizes the NME ratio, over up to ``sparse_search_volume`` values of
    p <= N·``max_rp_threshold``. Past ``search_subsample`` segments the
    search runs on an evenly strided subsample and the chosen ratio scales
    back to N. ``maj_vote_spk_count`` takes the mode of the probes'
    counts (ties to the smaller). A tensor runs its probes on its device,
    a numpy array on the host."""
    n = affinity.shape[0]
    scale = 1.0
    if n > search_subsample:
        idx = np.linspace(0, n - 1, search_subsample).astype(int)
        if isinstance(affinity, torch.Tensor):
            sel = torch.from_numpy(idx).to(affinity.device)
            search_aff = affinity[sel][:, sel]
        else:
            search_aff = affinity[idx][:, idx]
        scale = n / len(idx)
    else:
        search_aff = affinity
    m = search_aff.shape[0]
    p_max = max(2, int(np.floor(m * max_rp_threshold)))
    candidates = np.unique(
        np.linspace(1, p_max, num=min(sparse_search_volume, p_max)).astype(int)
    )

    best = (np.inf, 2, 1)  # (nme, p, n_spk)
    estimates = []
    if isinstance(search_aff, torch.Tensor):
        for p, evals in zip(candidates, _probe_evals(search_aff, candidates)):
            n_spk, gap = estimate_num_speakers(evals, max_num_speakers)
            nme = p / max(gap / (p + 1e-10), 1e-10)
            estimates.append(n_spk)
            if nme < best[0]:
                best = (nme, int(p), n_spk)
    else:
        for p in candidates:
            nme, n_spk = _nme_ratio(search_aff, int(p), max_num_speakers)
            estimates.append(n_spk)
            if nme < best[0]:
                best = (nme, int(p), n_spk)
    est = best[2]
    if maj_vote_spk_count and estimates:
        est = int(np.argmax(np.bincount(np.asarray(estimates))))
    return max(1, int(round(best[1] * scale))), est


def enhanced_speaker_count(
    embeddings,
    random_test_count: int = 5,
    anchor_spk_n: int = 3,
    anchor_sample_n: int = 10,
    anchor_spread: float = 0.1,
) -> int:
    """Anchor-augmented speaker counting for short recordings: ``anchor_spk_n``
    synthetic tight clusters are appended before counting, over
    ``random_test_count`` seeds; the mode of the counts less the anchors
    (at least 1). On the host, numpy's draws as in the JAX package."""
    if isinstance(embeddings, torch.Tensor):
        embeddings = embeddings.float().cpu().numpy()
    emb = np.asarray(embeddings, np.float32)
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-8)
    emb_dim = emb.shape[1]
    n_anchor = anchor_spk_n * anchor_sample_n
    estimates = []
    for seed in range(random_test_count):
        rng = np.random.default_rng(seed)
        new_embs = []
        for _ in range(anchor_spk_n):
            center = rng.standard_normal(emb_dim)
            center /= max(np.linalg.norm(center), 1e-8)
            noise = rng.standard_normal((anchor_sample_n, emb_dim))
            noise /= np.maximum(np.linalg.norm(noise, axis=1, keepdims=True), 1e-8)
            samples = center[None, :] + anchor_spread * noise
            samples /= np.linalg.norm(samples, axis=1, keepdims=True)
            new_embs.append(samples)
        aug = np.vstack(new_embs + [emb]).astype(np.float32)
        _, est = nmesc_search(
            cosine_affinity(aug),
            max_num_speakers=min(aug.shape[0] - 1, n_anchor + emb.shape[0] // 2),
            max_rp_threshold=0.15,
            sparse_search_volume=10,
            maj_vote_spk_count=True,
        )
        estimates.append(est)
    mode = int(np.argmax(np.bincount(np.asarray(estimates))))
    return max(mode - anchor_spk_n, 1)


def _kmeans(points: np.ndarray, k: int, seed: int = 0, iters: int = 50) -> np.ndarray:
    """k-means with k-means++ seeding from numpy's ``default_rng(seed)``,
    distances by the ``|x|² + |c|² − 2x·c`` expansion."""
    rng = np.random.default_rng(seed)
    n = len(points)
    if k >= n:
        return np.arange(n)
    pts = np.ascontiguousarray(points, np.float32)
    x2 = np.einsum("nd,nd->n", pts, pts)
    centers = np.empty((k, pts.shape[1]), np.float32)
    c = pts[rng.integers(n)]
    centers[0] = c
    d2 = np.maximum(x2 + float(c @ c) - 2.0 * (pts @ c), 0.0)
    for j in range(1, k):
        total = d2.sum()
        if total <= 1e-12:
            c = pts[rng.integers(n)]
        else:
            c = pts[rng.choice(n, p=d2 / total)]
        centers[j] = c
        d2 = np.minimum(d2, np.maximum(x2 + float(c @ c) - 2.0 * (pts @ c), 0.0))

    labels = np.zeros(n, np.int32)
    for _ in range(iters):
        c2 = np.einsum("kd,kd->k", centers, centers)
        dists = x2[:, None] + c2[None, :] - 2.0 * (pts @ centers.T)
        new_labels = dists.argmin(axis=1).astype(np.int32)
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
        for j in range(k):
            mask = labels == j
            if mask.any():
                centers[j] = pts[mask].mean(axis=0)
    return labels


def _kmeans_device(p: torch.Tensor, k: int, seed: int, n_iters: int = 50):
    """(labels [n], means [k, d]): k-means++ seeding and ``n_iters`` Lloyd
    steps on ``p``'s device with no host round trip. Each center is a
    Gumbel-max draw over log d² (an exact draw ∝ d²; the first one
    uniform). The ``[k, n]`` Gumbel noise comes from a CPU
    ``torch.Generator`` seeded with ``seed`` and reaches the device in one
    copy, so every device draws the same centers from the same points.
    The means are those of the final assignment; an empty cluster takes
    the global mean."""
    p = p.float()
    n = p.shape[0]
    gen = torch.Generator().manual_seed(seed)
    gumbel = (-torch.empty((k, n)).exponential_(generator=gen).log()).to(p.device)
    x2 = (p * p).sum(dim=1)
    d2 = None
    centers = []
    for j in range(k):
        logits = torch.zeros_like(x2) if d2 is None else d2.clamp(min=1e-30).log()
        c = p[torch.argmax(logits + gumbel[j])]
        dc = (x2 + c @ c - 2.0 * (p @ c)).clamp(min=0.0)
        d2 = dc if d2 is None else torch.minimum(d2, dc)
        centers.append(c)
    c = torch.stack(centers)

    def assign(c):
        return torch.argmin(x2[:, None] + (c * c).sum(dim=1)[None] - 2.0 * (p @ c.T), dim=1)

    def sums_counts(labels):
        onehot = torch.nn.functional.one_hot(labels, k).float()
        return onehot.T @ p, onehot.sum(dim=0)[:, None]

    for _ in range(n_iters):
        sums, counts = sums_counts(assign(c))
        c = torch.where(counts > 0, sums / counts.clamp(min=1.0), c)
    labels = assign(c)
    sums, counts = sums_counts(labels)
    means = torch.where(counts > 0, sums / counts.clamp(min=1.0), p.mean(dim=0)[None])
    return labels, means


def _overcluster_chunk(chunk, k: int, seed: int, iters: int = 50):
    """(labels [n], means [k, d]) for one long-form chunk: the tensor
    k-means on a tensor's device, the numpy one on a numpy chunk."""
    n = chunk.shape[0]
    if k >= n:
        if isinstance(chunk, torch.Tensor):
            chunk = chunk.float().cpu().numpy()
        return np.arange(n), np.asarray(chunk, np.float32)
    if isinstance(chunk, torch.Tensor):
        labels, means = _kmeans_device(chunk, k, seed, iters)
        return labels.cpu().numpy().astype(np.int64), means.cpu().numpy()
    labels = _kmeans(chunk, k, seed=seed, iters=iters)
    means = np.stack([
        chunk[labels == j].mean(axis=0) if (labels == j).any() else chunk.mean(axis=0)
        for j in range(k)
    ])
    return labels, means


def _record_path(stats: Optional[dict], n: int) -> None:
    if stats is not None:
        stats["path"] = "nystrom" if n > _NYSTROM_THRESHOLD else "dense"


def _record_gap(stats: Optional[dict], evals, k: int) -> None:
    """``evals[k] - evals[k - 1]`` of ascending eigenvalues into ``stats``."""
    if stats is not None and 0 < k < len(evals):
        stats["eigengap"] = float(evals[k] - evals[k - 1])


def _normalize_rows(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-8)


def spectral_cluster(affinity_bin: np.ndarray, n_speakers: int, seed: int = 0,
                     stats: Optional[dict] = None) -> np.ndarray:
    """Host path, up to ``_NYSTROM_THRESHOLD`` segments: rows of the k
    smallest-eigenvalue eigenvectors of the binarized affinity's
    Laplacian, k-means'd."""
    _record_path(stats, affinity_bin.shape[0])
    with _Stage(stats, "eigen"):
        evals, evecs = eigen_decompose(laplacian(affinity_bin))
        _record_gap(stats, evals, n_speakers)
        embedding = evecs[:, :n_speakers]
    with _Stage(stats, "kmeans"):
        return _kmeans(_normalize_rows(embedding), n_speakers, seed)


def spectral_cluster_device(affinity: torch.Tensor, p_neighbors: int, n_speakers: int,
                            seed: int = 0, stats: Optional[dict] = None) -> np.ndarray:
    """``spectral_cluster`` for an affinity tensor: the threshold
    binarization, the Laplacian and its ``eigh`` (or, past
    ``_NYSTROM_THRESHOLD``, the Nyström blocks, the anchors' ``eigh`` in
    float64 and the extension) on its device; only the ``[n, k]`` spectral
    embedding comes to the host for the k-means."""
    n = affinity.shape[0]
    p = int(np.clip(p_neighbors, 1, n))
    _record_path(stats, n)
    with _Stage(stats, "eigen", affinity.device):
        binarized = _binarize_threshold(affinity, p)
        if n > _NYSTROM_THRESHOLD:
            m = min(_NYSTROM_ANCHORS, n)
            idx = torch.from_numpy(np.linspace(0, n - 1, m).astype(int)).to(affinity.device)
            d_inv_sqrt = 1.0 / binarized.sum(dim=1).clamp(min=1e-8).sqrt()
            c = binarized[:, idx] * d_inv_sqrt[:, None] * d_inv_sqrt[idx][None, :]
            evals, evecs = torch.linalg.eigh(c[idx].double())
            _record_gap(stats, evals, m - n_speakers)
            lam = evals[m - n_speakers:].flip(0).clamp(min=1e-8)
            u = evecs[:, m - n_speakers:].flip(1)
            emb = c @ (u / lam[None, :]).float()
            embedding = (emb / emb.norm(dim=1, keepdim=True).clamp(min=1e-8)).cpu().numpy()
        else:
            lap = torch.diag_embed(binarized.sum(dim=1)) - binarized
            evals, evecs = torch.linalg.eigh(lap)
            _record_gap(stats, evals, n_speakers)
            embedding = _normalize_rows(evecs[:, :n_speakers].cpu().numpy())
    with _Stage(stats, "kmeans"):
        return _kmeans(embedding, n_speakers, seed)


def nme_spectral_clustering(
    embeddings,
    num_speakers: Optional[int] = None,
    max_num_speakers: int = 8,
    min_num_speakers: int = 1,
    max_rp_threshold: float = 0.25,
    sparse_search_volume: int = 30,
    affinity=None,
    seed: int = 0,
    enhanced_count_thres: int = 0,
    maj_vote_spk_count: bool = False,
    stats: Optional[dict] = None,
) -> np.ndarray:
    """Embeddings (or a precomputed multiscale affinity) -> per-segment
    speaker labels. ``num_speakers`` forces the count; otherwise it is
    estimated and clamped to [min, max]; below ``enhanced_count_thres``
    segments the enhanced count decides it. An affinity tensor keeps the
    work on its device; without one the cosine affinity is built on the
    host and the host path runs, or past ``_NYSTROM_THRESHOLD`` segments
    the tensor path on the host."""
    if affinity is None:
        affinity = cosine_affinity(embeddings)
    n = affinity.shape[0]
    if not isinstance(affinity, torch.Tensor) and n > _NYSTROM_THRESHOLD:
        affinity = torch.from_numpy(np.asarray(affinity, np.float32))
    if n == 1:
        return np.zeros(1, np.int32)
    if n == 2:
        same = float(affinity[0, 1]) > 0.5
        if num_speakers == 1 or (num_speakers is None and same):
            return np.zeros(2, np.int32)
        return np.arange(2, dtype=np.int32)

    on_device = isinstance(affinity, torch.Tensor)
    with _Stage(stats, "nme_search", affinity.device if on_device else None):
        best_p, est = nmesc_search(affinity, max_num_speakers, max_rp_threshold,
                                   sparse_search_volume, maj_vote_spk_count=maj_vote_spk_count)
        if num_speakers is None and embeddings is not None and 0 < n < enhanced_count_thres:
            est = enhanced_speaker_count(embeddings)
    n_spk = num_speakers if num_speakers is not None else est
    n_spk = int(np.clip(n_spk, min_num_speakers, max_num_speakers))
    if stats is not None:
        stats["p_neighbors"] = best_p
    if on_device:
        return spectral_cluster_device(affinity, best_p, n_spk, seed, stats=stats)
    return spectral_cluster(binarize_top_p(affinity, best_p), n_spk, seed, stats=stats)


def longform_cluster(
    embeddings,
    num_speakers: Optional[int] = None,
    max_num_speakers: int = 8,
    chunk_cluster_count: int = 50,
    embeddings_per_chunk: int = 10000,
    **kwargs,
) -> np.ndarray:
    """Past ``embeddings_per_chunk`` segments: over-cluster each chunk into
    ``chunk_cluster_count`` clusters, recluster the clusters' means on the
    host, and give each segment its cluster's label. Otherwise NME-SC of
    the whole."""
    n = embeddings.shape[0]
    if n <= embeddings_per_chunk:
        return nme_spectral_clustering(
            embeddings, num_speakers=num_speakers, max_num_speakers=max_num_speakers, **kwargs)
    # the chunks' affinities come from their embeddings: a full one no longer applies
    kwargs.pop("affinity", None)
    stats = kwargs.get("stats")
    chunk_labels = np.zeros(n, np.int64)
    means = []
    offset = 0
    with _Stage(stats, "kmeans", embeddings.device if isinstance(embeddings, torch.Tensor) else None):
        for start in range(0, n, embeddings_per_chunk):
            chunk = embeddings[start: start + embeddings_per_chunk]
            k = min(chunk_cluster_count, chunk.shape[0])
            labels, chunk_means = _overcluster_chunk(chunk, k, seed=start)
            chunk_labels[start: start + chunk.shape[0]] = labels + offset
            means.append(chunk_means)
            offset += k
    meta_labels = nme_spectral_clustering(
        np.concatenate(means, axis=0), num_speakers=num_speakers,
        max_num_speakers=max_num_speakers, **kwargs)
    if stats is not None:
        stats["path"] = "longform"
    return meta_labels[chunk_labels].astype(np.int32)

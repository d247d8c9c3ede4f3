"""Per-segment forced alignment (the fast path).

Counterpart of ``whisper_nemo_tpu/align/segmented.py``. When the ASR has
produced segments with time bounds, each segment's text is aligned
against its own audio span only: Σ tᵢ·lᵢ work instead of T·L, and the
segments batch.

Segments are grouped by (emission length, label count) buckets; a group
runs as one batched Viterbi (kernel D on the card). Padding is sound,
not approximate: two dedicated pad-label columns score 0 only in the
padded "free" frames appended after the real emissions (real labels
score −∞ there, pad labels score −∞ in real frames), so the optimal path
aligns every real label inside real audio and walks the pad labels
afterwards. The emissions stay on the device; each group's blocks are
sliced from them there, and only the paths and per-frame scores come
back to the host.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.ctc import NEG_INF, _gather_state_emissions, _trellis_arrays, viterbi_batch
from .api import AlignmentModel, AlignmentTokenizer, generate_emissions
from .text import preprocess_text

_T_BUCKETS = (128, 256, 512, 1024, 2048, 4096)
_L_BUCKETS = (32, 64, 128, 256, 512, 1024)

# Device-memory budget per dispatched Viterbi group: the batched trellis
# holds e_states (f32) and backpointers (int8) at [rows, t_b + l_b,
# 2*l_b + 1], ~13 MB a row at the (2048, 512) bucket; 12 bytes an element
# leaves room for the blocks and the gather. Larger groups dispatch in
# chunks of at most this many bytes.
_GROUP_BYTES_BUDGET = 2.0e9


def _bucket(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


def _add_star_device(emissions: torch.Tensor, blank_id: int,
                     discount: float = float(np.log(0.5))) -> torch.Tensor:
    """Tensor twin of ops.ctc.add_star_column."""
    masked = emissions.clone()
    masked[:, blank_id] = NEG_INF
    star = masked.amax(dim=1, keepdim=True) + discount
    return torch.cat([emissions, star], dim=1)


def _viterbi_group_device(em_pad, t0s, t_effs, state_labels, allow_skip,
                          t_b: int, l_b: int):
    """One bucket group on the emissions' device: slice each segment's
    span out of the resident emissions, assemble the padded block that
    :func:`_prepare_item` specifies (that host function remains the
    readable layout reference and the test oracle), run the batched
    Viterbi, and return the state paths ``[R, t_b + l_b]`` int32 and the
    per-frame emission score of the chosen state ``[R, t_b + l_b]`` f32."""
    dev = em_pad.device
    v = em_pad.shape[1]
    t0s = torch.as_tensor(t0s, dtype=torch.int64).to(dev)
    t_effs = torch.as_tensor(t_effs, dtype=torch.int64).to(dev)
    rows = torch.arange(t_b, device=dev)
    raw = em_pad[t0s[:, None] + rows[None]]  # [R, t_b, v]
    real = rows[None] < t_effs[:, None]  # [R, t_b]
    blocks = torch.full((len(t0s), t_b + l_b, v + 2), NEG_INF, device=dev)
    blocks[:, :t_b, :v] = torch.where(real[..., None], raw, NEG_INF)
    # idle frames between t_eff and the bucket edge: blank-certain
    blocks[:, :t_b, 0] = torch.where(real, raw[..., 0], 0.0)
    # free frames: only blank and the two pad labels are admissible
    blocks[:, t_b:, 0] = 0.0
    blocks[:, t_b:, v:] = 0.0

    state_labels = torch.as_tensor(state_labels).to(dev)
    e_states = _gather_state_emissions(blocks, state_labels)
    _, _, paths = viterbi_batch(e_states, torch.as_tensor(allow_skip).to(dev))
    scores = torch.gather(e_states, 2, paths.to(torch.int64)[..., None])[..., 0]
    return paths, scores


def _extend_labels(labels: np.ndarray, l_bucket: int, v: int) -> np.ndarray:
    """Pad a label row to ``l_bucket`` with alternating pad-label ids
    (``v`` and ``v+1`` — the two columns appended past the vocabulary)."""
    l = min(len(labels), l_bucket)
    labels_ext = np.empty((l_bucket,), np.int32)
    labels_ext[:l] = labels[:l]
    labels_ext[l:] = np.where(np.arange(l_bucket - l) % 2 == 0, v, v + 1)
    return labels_ext


def _prepare_item(
    em_star: np.ndarray,  # [t, V] emissions incl. star column
    labels: np.ndarray,  # [l] ids into V
    t_bucket: int,
    l_bucket: int,
):
    """Pad one segment into (emissions [t_bucket + l_bucket, V+2],
    labels [l_bucket], n_real_labels).

    Host reference for the block builder in :func:`_viterbi_group_device`
    (kept as the test oracle)."""
    t, v = em_star.shape
    t = min(t, t_bucket)  # oversize segments clip to the largest bucket
    l = len(labels)
    pad0, pad1 = v, v + 1
    total_t = t_bucket + l_bucket

    em = np.full((total_t, v + 2), NEG_INF, np.float32)
    em[:t, :v] = em_star[:t]
    # real frames beyond t (within the bucket): blank-certain idling
    em[t:t_bucket, 0] = 0.0
    # free frames: only blank and the pad labels are admissible
    em[t_bucket:, 0] = 0.0
    em[t_bucket:, pad0] = 0.0
    em[t_bucket:, pad1] = 0.0

    l = min(l, l_bucket)  # a 30 s segment never carries >1024 char labels
    labels_ext = _extend_labels(labels, l_bucket, v)
    return em, labels_ext, l


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def align_segments(
    model: AlignmentModel,
    tokenizer: AlignmentTokenizer,
    audio: np.ndarray,
    segments: Sequence[dict],  # {'start','end','text'} seconds
    language: str = "eng",
    batch_size: int = 8,
    margin_s: float = 0.5,
    device="cuda",
    stats: Optional[dict] = None,
) -> List[dict]:
    """Word timestamps for ASR segments via per-segment batched Viterbi
    on ``device`` ("cuda", "cuda:N" or "cpu"), which must be the model's.

    Returns the same rows as ``postprocess_results``:
    ``{"text", "start", "end", "score"}`` in global seconds, plus a
    ``"segment"`` key carrying the index of the input segment each word
    was aligned under.

    ``stats``, when given, receives the stage times in seconds
    (``emissions_s``, ``items_s``, ``viterbi_s``, ``post_s``; the device
    is synchronised between stages for them) and ``groups``: each
    (t_b, l_b) bucket with its rows per dispatched chunk.
    """
    dev = torch.device(device)
    if model is not None and model.device.type != dev.type:
        raise ValueError(f"align_segments on {dev}, but the model lives on {model.device}")
    t_start = time.perf_counter()
    emissions, stride = generate_emissions(model, audio, batch_size, device=True)
    if stats is not None:
        _sync(dev)
        stats["emissions_s"] = time.perf_counter() - t_start
    return align_emissions(emissions, stride, tokenizer, segments, language, margin_s,
                           device, stats)


@torch.inference_mode()
def align_emissions(
    emissions,  # [T, V] log-probs, a tensor or numpy
    stride: float,  # ms per frame
    tokenizer: AlignmentTokenizer,
    segments: Sequence[dict],
    language: str = "eng",
    margin_s: float = 0.5,
    device="cuda",
    stats: Optional[dict] = None,
) -> List[dict]:
    """The Viterbi half of :func:`align_segments`, on emissions already
    computed; they are moved to ``device`` once."""
    dev = torch.device(device)
    t_start = time.perf_counter()
    emissions = torch.as_tensor(emissions).to(dev)
    t_total = emissions.shape[0]
    em_star_full = _add_star_device(emissions, tokenizer.blank_id)
    # headroom rows so every bucket's slice stays in bounds
    em_pad = F.pad(em_star_full, (0, 0, 0, _T_BUCKETS[-1]), value=NEG_INF)

    # per-segment work items: text and labels on the host; the emissions
    # stay on the device and items carry only [t0, t1) frame indices
    items = []
    for seg_index, seg in enumerate(segments):
        text = seg["text"].strip()
        if not text:
            continue
        tokens_starred, text_starred = preprocess_text(
            text, romanize=True, language=language
        )
        labels: List[int] = []
        token_label_counts: List[int] = []
        for tok in tokens_starred:
            ids = tokenizer.word_to_ids(tok)
            labels.extend(ids)
            token_label_counts.append(len(ids))
        t0 = max(0, int((seg["start"] - margin_s) * 1000 / stride))
        t1 = min(t_total, int(np.ceil((seg["end"] + margin_s) * 1000 / stride)))
        if t1 <= t0:
            continue
        items.append(
            {
                "t0": t0,
                "t1": t1,
                "labels": np.asarray(labels, np.int32),
                "counts": token_label_counts,
                "tokens_starred": tokens_starred,
                "text_starred": text_starred,
                "seg_index": seg_index,
            }
        )

    groups: Dict[tuple, List[int]] = {}
    for i, item in enumerate(items):
        key = (
            _bucket(item["t1"] - item["t0"], _T_BUCKETS),
            _bucket(len(item["labels"]), _L_BUCKETS),
        )
        groups.setdefault(key, []).append(i)
    t_items = time.perf_counter()

    # launch every group before collecting any
    dispatched = []
    for (t_b, l_b), idxs in groups.items():
        t0s, t_effs, slabels, skips = [], [], [], []
        for i in idxs:
            item = items[i]
            t0s.append(item["t0"])
            t_effs.append(min(item["t1"] - item["t0"], t_b))
            labels_ext = _extend_labels(item["labels"], l_b, em_star_full.shape[1])
            sl, sk = _trellis_arrays(labels_ext, tokenizer.blank_id)
            slabels.append(sl)
            skips.append(sk)
        slabels = np.stack(slabels)
        skips = np.stack(skips)

        row_bytes = 12.0 * (t_b + l_b) * (2 * l_b + 1)
        rows_cap = max(1, int(_GROUP_BYTES_BUDGET / row_bytes))
        for c0 in range(0, len(idxs), rows_cap):
            c1 = min(c0 + rows_cap, len(idxs))
            paths, scores = _viterbi_group_device(
                em_pad, t0s[c0:c1], t_effs[c0:c1], slabels[c0:c1], skips[c0:c1],
                t_b=t_b, l_b=l_b,
            )
            dispatched.append(((t_b, l_b), idxs[c0:c1], paths, scores))
    if stats is not None:
        _sync(dev)
    t_viterbi = time.perf_counter()

    results: List[dict] = []
    for (t_b, l_b), idxs, paths, scores in dispatched:
        paths = paths.cpu().numpy()
        frame_scores = scores.cpu().numpy()
        for row, i in enumerate(idxs):
            item = items[i]
            n_real = len(item["labels"])
            t_real = min(item["t1"] - item["t0"], t_b)
            path = paths[row][:t_real]
            frame_labels = np.where(path % 2 == 1, (path - 1) // 2, -1)
            frame_labels = np.where(
                frame_labels < n_real, frame_labels, -1
            ).astype(np.int32)
            results.extend(
                _words_from_frames(
                    item, frame_labels, frame_scores[row][:t_real], stride
                )
            )
    results.sort(key=lambda w: w["start"])
    if stats is not None:
        stats.update(
            items_s=t_items - t_start,
            viterbi_s=t_viterbi - t_items,
            post_s=time.perf_counter() - t_viterbi,
            groups={key: [len(d[1]) for d in dispatched if d[0] == key] for key in groups},
        )
    return results


def _label_segments_from_scores(
    frame_labels: np.ndarray,
    frame_scores: np.ndarray,
    labels: np.ndarray,
) -> List[dict]:
    """ops.ctc.label_segments computed from the per-frame path scores
    the device Viterbi returns instead of the full emissions matrix.

    Identical values: the CTC state path is monotonic, so every frame
    inside a label's [start, end) run has that label as its path state,
    and ``frame_scores[t] == emissions[t, labels[i]]`` there.
    """
    n = len(labels)
    frame_labels = np.asarray(frame_labels)
    frame_scores = np.asarray(frame_scores, np.float64)

    # per-label [start, end) runs: CTC paths are monotonic, so each
    # label's frames are one contiguous run and min/max scatter
    # reductions recover it exactly
    starts = np.full(n, -1, np.int64)
    ends = np.full(n, -1, np.int64)
    idx = np.flatnonzero(frame_labels >= 0)
    lab = frame_labels[idx]
    if len(idx):
        first = np.full(n, np.iinfo(np.int64).max, np.int64)
        np.minimum.at(first, lab, idx)
        np.maximum.at(ends, lab, idx + 1)
        got = ends >= 0
        starts[got] = first[got]

    # zero-width fallback: a label with no frames sits at the previous
    # label's end (ends are monotone over assigned labels, so a
    # forward-fill of assigned ends IS the running prev_end)
    got = starts >= 0
    filled_ends = np.where(got, ends, 0)
    prev_ends = np.maximum.accumulate(
        np.concatenate([[0], filled_ends[:-1]])
    )
    starts = np.where(got, starts, prev_ends)
    ends = np.where(got, ends, prev_ends)

    # per-label mean of exp(score) over the run's frames
    scores = np.zeros(n, np.float64)
    if len(idx):
        np.add.at(scores, lab, np.exp(frame_scores[idx]))
        counts = np.zeros(n, np.int64)
        np.add.at(counts, lab, 1)
        scores = np.where(counts > 0, scores / np.maximum(counts, 1), 0.0)

    return [
        {
            "label": int(labels[i]),
            "start": int(starts[i]),
            "end": int(ends[i]),
            "score": float(scores[i]),
        }
        for i in range(n)
    ]


def _words_from_frames(item, frame_labels, frame_scores, stride) -> List[dict]:
    """Per-token spans → word rows with global-time conversion."""
    segs = _label_segments_from_scores(
        frame_labels, frame_scores, item["labels"]
    )
    words = []
    cursor = 0
    for tok, text, count in zip(
        item["tokens_starred"], item["text_starred"], item["counts"]
    ):
        span = segs[cursor : cursor + count]
        cursor += count
        if tok == "<star>" or not span:
            continue
        start_f = item["t0"] + span[0]["start"]
        end_f = item["t0"] + span[-1]["end"]
        words.append(
            {
                "text": text,
                "start": start_f * stride / 1000.0,
                "end": end_f * stride / 1000.0,
                "score": float(np.mean([s["score"] for s in span])),
                "segment": item["seg_index"],
            }
        )
    return words

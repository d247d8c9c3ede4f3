#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (whisper_nemo_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, one line each:
  1. device: name, power limit, versions; fails without CUDA;
  2. build: the port's CUDA kernels from whisper_nemo_tpu_torch/csrc, one
     nvcc per source, all started together;
  3. kernel A (cross-attention decode) against its plain version at
     medium.en decode shapes, bits 8 and 4, beam 1 and 5;
  3b. kernel D (batched CTC Viterbi) against its plain version, bit for
     bit: the segmented aligner's main bucket, a global forced_align of
     5 minutes of speech, and a trellis whose alpha exceeds shared memory;
  4. kernel B (encoder attention) against its plain version at the
     medium.en encoder shape and the wav2vec2 aligner's, with SDPA timed
     beside it as a yardstick;
  5. slice parity: the batched pipeline at small dims on the GPU (the
     kernels) against the same pipeline on the CPU (the plain versions);
  5b. alignment parity: wav2vec2 emissions at small dims on the GPU
     against the CPU, then the segmented aligner on both fed the same
     emissions;
  6. the main path, as the CLI flow runs it: WhisperModel("medium.en",
     compute_type="int8") and BatchedInferencePipeline.transcribe(
     batch_size=32, beam_size=1) on two requests of 20 minutes of
     synthetic speech, then align_segments with the full-width
     (MMS-300M-sized) aligner in bf16 on a synthetic 150 wpm transcript,
     warm and timed; the kernels' launch counts are checked against the
     decode steps, encoder batches, emission batches and Viterbi groups;
  6b. stage times of both stages, measured apart;
  7. the card's name and power limit, the kernels' JSON line, and last
     {"ok": true, "device": {...}}.
Any phase that fails raises, and the script exits non-zero without the
last line. Weights are random from --seed unless $WNT_MODEL_DIR holds
medium.en.npz and ctc_aligner.npz.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes.util
import json
import math
import subprocess
import sys
import time

import numpy as np

SR = 16000
BOUND_A = 5e-3  # |kernel - plain|: outputs are O(1); f32 sums in another order
BOUND_B = 1e-2  # bf16 P in the PV product vs bf16 normalized weights; bf16 output
BOUND_D = 0.0  # one f32 add per state and step and an exact max: bit-equal
# Phase 5b, f32 emissions of a 2-layer wav2vec2 (log-probs of order 1-10):
# kernel B rounds its f32 operands to bf16 for the tensor cores (2^-8
# relative), and the conv stack and linears sum in another order
EMISSIONS_TOL = 0.05
# The card's peaks (H100 SXM data sheet, dense): bytes/s of device memory,
# bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BYTES_S, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
# Phase 5, logits: the GPU slice (kernels, cuBLAS) and the CPU slice
# (plain versions) round bf16 products in other orders; on the CPU the
# port's int8 step logits agree with the JAX package's to 0.02
# (tests/test_torch_whisper.py), and kernel B adds its bf16 P.
TIE_TOL = 0.05


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def speechlike(seconds: float, seed: int) -> np.ndarray:
    """Seeded bursts of modulated noise (1.5-8 s) between quiet gaps."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    audio = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    t = int(rng.uniform(0.2, 1.0) * SR)
    while t < n:
        m = min(int(rng.uniform(1.5, 8.0) * SR), n - t)
        ph = np.arange(m) / SR
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 6) * ph)
        tone = np.sin(2 * np.pi * rng.uniform(120, 300) * ph)
        burst = 0.2 * env * (tone + 0.5 * rng.standard_normal(m))
        audio[t : t + m] += burst.astype(np.float32)
        t += m + int(rng.uniform(0.3, 1.5) * SR)
    return audio


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        import regex  # noqa: F401

        has_regex = True
    except ImportError:
        has_regex = False
    # the JAX package's native audio decoder links libav; the port's
    # slice takes waveforms and does not build it yet
    libav = ctypes.util.find_library("avformat") or "absent"
    print(
        f"[1 device] {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | devices {torch.cuda.device_count()} | regex {has_regex}"
        f" | libavformat {libav} (the native decoder is not part of the port yet)"
    )
    return smi


def phase_build():
    from whisper_nemo_tpu_torch.ops import _build

    t0 = time.time()
    names = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    check(names == ["cross_decode", "encoder_attention", "viterbi"],
          f"unexpected kernel sources {names}")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.load, names))
    secs = time.time() - t0
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name}: {line.strip()}")
    print(f"[2 build] kernels built and loaded in {secs:.1f} s into {_build.BUILD_DIR}")


def phase_kernel_a(seed: int) -> dict:
    import torch

    from whisper_nemo_tpu_torch.ops import cross_decode as cd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    L, W, H, D, T = 24, 32, 16, 64, 1500
    kp = T + (-T % 128)
    k_scale = torch.full((H, D), 0.03, device=dev)
    v_scale = torch.full((H, D), 1.0 / 127, device=dev)
    worst, timing = 0.0, {}
    for bits in (8, 4):
        rows = 2 * D if bits == 8 else D
        kv = torch.randint(-127, 128, (L, W, H, rows, kp), device=dev, generator=g,
                           dtype=torch.int8)
        for beam in (1, 5):
            q = torch.randn((W * beam, 1, H, D), device=dev, generator=g).to(torch.bfloat16)
            qs = (q[:, 0].float() * (k_scale * D**-0.5)[None]).contiguous()
            err = 0.0
            for layer in (0, L - 1):
                got = cd._cross_attention_decode_cuda(qs, kv, layer, T, bits, beam) * v_scale
                ref = cd._cross_attention_decode_plain(qs, kv, layer, T, bits, beam) * v_scale
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()), "kernel A gave non-finite values")
                err = max(err, float((got - ref).abs().max()))
            ms = cuda_ms(lambda i=0: cd._cross_attention_decode_cuda(qs, kv, i % L, T, bits, beam), 48)
            plain_ms = cuda_ms(lambda i=0: cd._cross_attention_decode_plain(qs, kv, i % L, T, bits, beam), 6)
            print(
                f"[3 kernel A] bits {bits} beam {beam}: max|err| {err:.3e} (bound {BOUND_A:g})"
                f" | kernel {ms:.4f} ms/layer, plain {plain_ms:.4f} ms/layer"
                f" | {W * H * rows * kp / ms / 1e6:.0f} GB/s of KV"
            )
            check(err <= BOUND_A, f"kernel A bits {bits} beam {beam}: max|err| {err} > {BOUND_A}")
            worst = max(worst, err)
            timing[(bits, beam)] = (ms, plain_ms)
        del kv
    ms, plain_ms = timing[(8, 1)]
    # least time for one layer launch at bits 8, beam 1: the K|V^T bytes
    # of the T real positions, q and the output, at the memory rate
    bound_ms = (W * H * 2 * D * T + 2 * W * H * D * 4) / HBM_BYTES_S * 1e3
    print(f"[3 kernel A] bound at bits 8 beam 1: {bound_ms:.4f} ms/layer (bytes);"
          f" kernel at {bound_ms / ms:.0%} of it")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None}


def _viterbi_inputs(r: int, t: int, n: int, seed: int, star_every: int = 0):
    """Seeded Dirichlet log-probs over 40 columns gathered through seeded
    labels into ``[r, t, 2n+1]`` state emissions on the card, with the CTC
    skip rule (every ``star_every``-th label the wildcard column 39)."""
    import torch

    from whisper_nemo_tpu_torch.ops import ctc

    rng = np.random.default_rng(seed)
    v = 40
    em = np.log(rng.dirichlet(np.ones(v), size=(r, t)).astype(np.float32))
    labels = rng.integers(1, v - 1, size=(r, n))
    if star_every:
        labels[:, ::star_every] = v - 1
    state_labels = np.zeros((r, 2 * n + 1), np.int64)
    state_labels[:, 1::2] = labels
    allow = np.zeros((r, 2 * n + 1), bool)
    allow[:, 3::2] = labels[:, 1:] != labels[:, :-1]
    dev = torch.device("cuda")
    e_states = ctc._gather_state_emissions(
        torch.from_numpy(em).to(dev), torch.from_numpy(state_labels).to(dev))
    return e_states, torch.from_numpy(allow).to(dev)


def viterbi_bound_ms(r: int, t: int, n_states: int) -> tuple:
    """(least time in ms, what bounds it) for kernel D's work: emissions
    and skips read once, alpha, backpointers and paths written once, at
    the memory rate; 5 f32 operations per state and step (two compares,
    two selects, one add) at the f32 rate."""
    bytes_ = r * t * n_states * 4 + r * n_states * 5 + r * (t - 1) * n_states + r * t * 4
    ops = 5.0 * r * (t - 1) * n_states
    by_bytes, by_ops = bytes_ / HBM_BYTES_S * 1e3, ops / F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def phase_kernel_d(seed: int) -> dict:
    import torch

    from whisper_nemo_tpu_torch.ops import ctc

    def plain(e, a):
        alpha, bps = ctc._viterbi_forward_states(e, a)
        return alpha, bps, ctc._viterbi_backtrack(alpha, bps)

    out = {}
    # (a) the segmented main bucket (2048, 512): 48 segments of 25 s;
    # (b) a global forced_align: 5 min at 20 ms frames, 150 wpm of
    #     5-character words each after a <star>; (c) L = 30001 states,
    #     whose two alpha buffers exceed the opt-in shared memory
    for case, (r, t, n, star, reps) in {
        "a": (48, 2560, 512, 0, 20), "b": (1, 15000, 4600, 6, 5), "c": (2, 1500, 15000, 0, 3),
    }.items():
        e, a = _viterbi_inputs(r, t, n, seed + ord(case), star)
        got = ctc._viterbi_cuda(e, a)
        want = plain(e, a)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("alpha", "bps", "path")):
            check(g.dtype == w.dtype and torch.equal(g, w),
                  f"kernel D case ({case}): {what} differs from the plain version")
        err = float((got[0] - want[0]).abs().max())
        ms = cuda_ms(lambda i=0: ctc._viterbi_cuda(e, a), reps)
        plain_ms = cuda_ms(lambda i=0: plain(e, a), 1)
        bound_ms, bound_by = viterbi_bound_ms(r, t, 2 * n + 1)
        print(f"[3b kernel D] ({case}) R={r} T={t} L={2 * n + 1}: alpha, bps, path bit-equal"
              f" (max|err| {err:g}, bound {BOUND_D:g}) | kernel {ms:.3f} ms"
              f" ({ms * 1e3 / (t - 1):.2f} us/step), plain {plain_ms:.1f} ms | bound"
              f" {bound_ms:.4f} ms ({bound_by})")
        out[case] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None}
        del e, a, got, want
    return out


def phase_kernel_b(seed: int) -> dict:
    """Kernel B at the Whisper encoder's shape (bf16 B=32, and f32 B=4)
    and the wav2vec2 aligner's (bf16 B=8, T=1499); SDPA on the same
    operands, as ``[B, H, T, D]``, is timed beside each bf16 shape as the
    yardstick (it never runs on the port's path)."""
    import torch
    import torch.nn.functional as F

    from whisper_nemo_tpu_torch.ops import attention as at

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    out = {}
    for name, dtype, B, T in (("whisper", torch.bfloat16, 32, 1500), ("whisper", torch.float32, 4, 1500),
                              ("wav2vec2", torch.bfloat16, 8, 1499)):
        H, D = 16, 64
        q, k, v = (torch.randn((B, T, H, D), device=dev, generator=g).to(dtype) for _ in range(3))
        got = at._encoder_attention_cuda(q, k, v)
        ref = at._xla_attention(q, k, v)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "kernel B gave non-finite values")
        err = float((got.float() - ref.float()).abs().max())
        ms = cuda_ms(lambda i=0: at._encoder_attention_cuda(q, k, v), 10)
        plain_ms = cuda_ms(lambda i=0: at._xla_attention(q, k, v), 3)
        flops = 4 * B * H * T * T * D
        bound_ms = flops / BF16_FLOPS * 1e3
        sdpa = ""
        lib_ms = None
        if dtype == torch.bfloat16:
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib_ms = cuda_ms(lambda i=0: F.scaled_dot_product_attention(qt, kt, vt), 10)
            sdpa = f", SDPA {lib_ms:.3f} ms (kernel/SDPA {ms / lib_ms:.2f}x)"
            del qt, kt, vt
        print(
            f"[4 kernel B] {name} {str(dtype)[6:]} B={B} T={T} H={H} D={D}: max|err| {err:.3e}"
            f" (bound {BOUND_B:g}) | kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s),"
            f" plain {plain_ms:.3f} ms{sdpa} | bound {bound_ms:.3f} ms (operations at the"
            f" bf16 peak), kernel at {bound_ms / ms:.0%} of it"
        )
        check(err <= BOUND_B, f"kernel B {name} {dtype}: max|err| {err} > {BOUND_B}")
        if dtype == torch.bfloat16:
            out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": "operations", "library_ms": lib_ms}
        del q, k, v, got, ref
    return out


def _step_logits(engine, audio, windows, row, prompt, generated, suppress_mask):
    """Filtered f32 logits of window ``windows[row]`` after ``generated``
    tokens, teacher-forced through the port's prefill with the window's
    whole batch (the cross-KV scales are taken over the batch)."""
    import torch

    from whisper_nemo_tpu_torch.models.whisper import _vocab_logits
    from whisper_nemo_tpu_torch.models.whisper_stacked import (
        cross_kv_decode_layout_fused,
        init_stacked_cache,
        prefill_cache_stacked,
    )
    from whisper_nemo_tpu_torch.ops import mel

    p, dims, dev = engine.params, engine.dims, engine.device
    waves = torch.zeros((len(windows), mel.N_SAMPLES), device=dev)
    for i, (s, e) in enumerate(windows):
        n = min(e - s, mel.N_SAMPLES)
        waves[i, :n] = torch.from_numpy(audio[s : s + n]).to(dev)
    with torch.inference_mode():
        feats = engine.encode_windows(mel.log_mel_spectrogram_batch(waves, dims.n_mels))
        ckv = cross_kv_decode_layout_fused(p, feats, dims, bits=engine.kv_bits)
        prefix = torch.tensor([prompt + generated], device=dev).repeat(len(windows), 1)
        cache = init_stacked_cache(len(windows), dims, engine.dtype, 128, dev)
        x, _ = prefill_cache_stacked(p, prefix, cache, ckv, dims, engine.dtype)
        opts = engine._make_opts()
        logits = _vocab_logits(p["decoder"], x[row, -1]) + suppress_mask.to(dev)
        logits[opts.timestamp_begin:] = float("-inf")
        logits[opts.no_timestamps] = float("-inf")
        if not generated:
            logits[opts.blank_token] = logits[opts.eot] = float("-inf")
    return logits


def first_difference(a, b, eot):
    """Index of the first differing token of two EOT-terminated lists, or
    None when they are equal."""
    a, b = list(a) + [eot], list(b) + [eot]
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def phase_slice_parity(seed: int, devices=("cuda", "cpu")) -> None:
    import torch

    from whisper_nemo_tpu_torch.engine.decode import build_suppress_mask
    from whisper_nemo_tpu_torch.engine.transcribe import WhisperEngine
    from whisper_nemo_tpu_torch.models.whisper import WhisperDims, init_whisper_params
    from whisper_nemo_tpu_torch.text.tokenizer import WhisperTokenizer, get_suppressed_tokens

    dims = WhisperDims(80, 1500, 128, 2, 2, 51864, 64, 128, 2, 2)  # head dim 64
    params = init_whisper_params(dims, "cpu", torch.Generator().manual_seed(seed))
    tok = WhisperTokenizer.byte_fallback(multilingual=False)
    audio = speechlike(70.0, seed)
    runs = []
    for dev in devices:
        eng = WhisperEngine("tiny.en", "int8", device=dev, params=params, dims=dims, tokenizer=tok)
        segs, _ = eng.transcribe_batched(audio, language="en", batch_size=2)
        runs.append((eng, segs))
    (gpu, gsegs), (cpu, csegs) = runs
    check([(s.start, s.end) for s in gsegs] == [(s.start, s.end) for s in csegs],
          "slice parity: VAD windows differ between GPU and CPU")
    check(len(gsegs) >= 3, f"slice parity: expected a partial last batch, got {len(gsegs)} windows")
    mask = torch.from_numpy(build_suppress_mask(
        dims.n_vocab, get_suppressed_tokens(tok, (-1,)))).float()
    prompt = tok.sot_sequence(None, without_timestamps=True)
    windows = [(int(round(s.start * SR)), int(round(s.end * SR))) for s in csegs]
    first = [_step_logits(eng, audio, windows[:2], 0, prompt, list(csegs[0].tokens[:8]), mask)
             for eng in (gpu, cpu)]
    logit_err = float((first[0].cpu() - first[1]).abs().nan_to_num(0.0).max())
    check(logit_err < TIE_TOL, f"slice parity: GPU and CPU logits differ by {logit_err}")
    equal = ties = 0
    for idx, (gs, cs) in enumerate(zip(gsegs, csegs)):
        j = first_difference(gs.tokens, cs.tokens, tok.eot)
        if j is None:
            check(gs.text == cs.text, f"slice parity: window at {gs.start}s: text differs")
            equal += 1
            continue
        # tie rule: at the first differing step, the CPU's logits rank
        # the two picks within TIE_TOL of each other
        batch = windows[idx - idx % 2 : idx - idx % 2 + 2]
        batch += [(0, 0)] * (2 - len(batch))
        logits = _step_logits(cpu, audio, batch, idx % 2, prompt, cs.tokens[:j], mask)
        g_tok, c_tok = (list(gs.tokens) + [tok.eot])[j], (list(cs.tokens) + [tok.eot])[j]
        gap = float(logits[c_tok] - logits[g_tok])
        top2 = torch.topk(logits, 2).values
        margin = float(top2[0] - top2[1])
        print(f"  window {idx} ({gs.start:.2f} s): token {j} differs, GPU {g_tok} CPU {c_tok};"
              f" CPU logit gap {gap:.4f}, CPU top-2 margin {margin:.4f}")
        check(max(gap, margin) < TIE_TOL, f"slice parity: token {j} of window {gs.start}s"
              f" differs beyond the tie tolerance {TIE_TOL}")
        ties += 1
    print(f"[5 slice parity] {len(gsegs)} windows in {len(gpu.last_decode_steps)} batches"
          f" (decode steps {gpu.last_decode_steps}): {equal} token-equal, {ties} differ"
          f" at a tie (CPU logit gap and top-2 margin < {TIE_TOL}); GPU vs CPU logits of"
          f" window 0 after 8 tokens: max|err| {logit_err:.4f} (bound {TIE_TOL})")


def synthetic_transcript(audio_seconds: int, seg_len_s: int = 25, wpm: int = 150) -> list:
    """bench.py's stand-in for the ASR text (random weights give unusable
    text): about ``wpm`` words a minute, one timed segment per
    ``seg_len_s`` span."""
    words = ("hello world this is a benchmark transcript " * 250).split()
    n_words = audio_seconds * wpm // 60
    transcript = (words * (n_words // len(words) + 1))[:n_words]
    wps = len(transcript) / audio_seconds
    return [
        {"start": float(s), "end": float(min(s + seg_len_s, audio_seconds)),
         "text": " ".join(transcript[int(s * wps) : int((s + seg_len_s) * wps)])}
        for s in range(0, audio_seconds, seg_len_s)
    ]


def phase_align_parity(seed: int, devices=("cuda", "cpu")) -> None:
    """wav2vec2 emissions on the card against the CPU (same f32 weights),
    then the segmented aligner on both devices fed the CPU's emissions."""
    import torch

    from whisper_nemo_tpu_torch.align.api import AlignmentModel, AlignmentTokenizer, generate_emissions
    from whisper_nemo_tpu_torch.align.segmented import align_emissions
    from whisper_nemo_tpu_torch.engine.checkpoint import to_device
    from whisper_nemo_tpu_torch.models.wav2vec2 import Wav2Vec2Dims, init_wav2vec2_params

    # the small test dims with the head dim raised to 64, which kernel B takes
    dims = Wav2Vec2Dims(vocab_size=39, hidden_size=128, num_layers=2, num_heads=2,
                        intermediate_size=256, conv_dim=(32,) * 7)
    params = init_wav2vec2_params(dims, "cpu", torch.Generator().manual_seed(seed))
    audio = speechlike(70.0, seed + 3)
    tok = AlignmentTokenizer()
    ems = []
    for dev in devices:
        model = AlignmentModel(to_device(params, torch.device(dev)), dims, torch.float32,
                               torch.device(dev))
        em, stride = generate_emissions(model, audio, batch_size=2)
        ems.append(em)
    check(ems[0].shape == ems[1].shape and bool(np.isfinite(ems[0]).all()),
          "alignment parity: emissions shape or values")
    err = float(np.abs(ems[0] - ems[1]).max())
    check(err <= EMISSIONS_TOL, f"alignment parity: GPU and CPU emissions differ by {err}")
    segments = synthetic_transcript(70)
    rows = [align_emissions(ems[1], stride, tok, segments, device=dev) for dev in devices]
    check(len(rows[0]) == len(rows[1]) == sum(len(s["text"].split()) for s in segments),
          "alignment parity: word counts")
    score_err = 0.0
    for g, c in zip(*rows):
        check((g["text"], g["start"], g["end"], g["segment"])
              == (c["text"], c["start"], c["end"], c["segment"]),
              f"alignment parity: word rows differ: {g} vs {c}")
        score_err = max(score_err, abs(g["score"] - c["score"]))
    check(score_err <= 1e-6, f"alignment parity: word scores differ by {score_err}")
    print(f"[5b align parity] wav2vec2 2 layers width 128 f32, 70 s: emissions {ems[0].shape},"
          f" GPU vs CPU max|err| {err:.2e} (bound {EMISSIONS_TOL:g}); segmented Viterbi on"
          f" the CPU's emissions: {len(rows[0])} words, rows equal, scores max|err|"
          f" {score_err:.1e} (bound 1e-6)")


def phase_main_path(seed: int) -> dict:
    import torch

    from whisper_nemo_tpu_torch.align.api import CHUNK_SECONDS, load_alignment_model
    from whisper_nemo_tpu_torch.align.segmented import align_segments
    from whisper_nemo_tpu_torch.asr import BatchedInferencePipeline, WhisperModel
    from whisper_nemo_tpu_torch.ops import attention as at
    from whisper_nemo_tpu_torch.ops import cross_decode as cd
    from whisper_nemo_tpu_torch.ops import ctc

    t0 = time.time()
    model = WhisperModel("medium.en", device="cuda", compute_type="int8", seed=seed)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    t0 = time.time()
    aligner, align_tok = load_alignment_model("cuda", dtype="bfloat16", seed=seed + 1)
    torch.cuda.synchronize()
    align_setup_s = time.time() - t0
    eng = model.engine
    pipeline = BatchedInferencePipeline(model)
    audio_seconds = 20 * 60
    audio = speechlike(float(audio_seconds), seed + 2)
    timed_segments = synthetic_transcript(audio_seconds)
    L_dec, L_enc = eng.dims.n_text_layer, eng.dims.n_audio_layer

    cd.cross_attention_decode_layered.launches = 0
    at.encoder_attention.launches = 0
    ctc.viterbi_batch.launches = 0
    results = []
    for req in range(2):
        torch.cuda.synchronize()
        t1 = time.time()
        segments, info = pipeline.transcribe(audio, language="en", batch_size=32, beam_size=1)
        segments = list(segments)
        torch.cuda.synchronize()
        results.append((time.time() - t1, segments, info, list(eng.last_decode_steps)))
    launches_a = cd.cross_attention_decode_layered.launches
    launches_b = at.encoder_attention.launches
    # stage 5 of the flow: the ASR segments' words aligned (here on the
    # synthetic transcript); the warm request records stage times
    stats = {}
    aligned = []
    for req in range(2):
        torch.cuda.synchronize()
        t1 = time.time()
        words = align_segments(aligner, align_tok, audio, timed_segments, language="eng",
                               batch_size=8, device="cuda", stats=None if req else stats)
        torch.cuda.synchronize()
        aligned.append((time.time() - t1, words))
    launches_b_align = at.encoder_attention.launches - launches_b
    launches_d = ctc.viterbi_batch.launches

    steps = [s for r in results for s in r[3]]
    batches = sum(len(r[3]) for r in results)
    check(launches_a > 0 and launches_b > 0, "a kernel of the main path never launched")
    check(launches_a == sum(steps) * L_dec,
          f"kernel A launched {launches_a} times, expected {sum(steps)} steps x {L_dec} layers")
    check(launches_b == batches * L_enc,
          f"kernel B launched {launches_b} times, expected {batches} batches x {L_enc} layers")
    for wall, segs, info, st in results:
        check(len(segs) >= 33, f"expected >= 33 windows (a full and a partial batch), got {len(segs)}")
        check(len(st) == -(-len(segs) // 32), "one decode per batch of 32 windows")
        for s in segs:
            check(np.isfinite(s.avg_logprob) and 0.0 <= s.no_speech_prob <= 1.0,
                  f"segment {s.id}: non-finite log-prob or no-speech prob out of range")
            check(0.0 <= s.start < s.end <= info.duration + 1e-6, f"segment {s.id}: bad span")
            check(len(s.tokens) <= 224, f"segment {s.id}: {len(s.tokens)} tokens")
    check([s.tokens for s in results[0][1]] == [s.tokens for s in results[1][1]],
          "the two requests gave different tokens")
    n_chunks = math.ceil(audio_seconds / CHUNK_SECONDS)
    emission_batches = math.ceil(n_chunks / 8)
    groups = stats["groups"]
    dispatched = sum(len(rows) for rows in groups.values())
    check(launches_d > 0, "kernel D never launched on the main path")
    check(launches_b_align == 2 * emission_batches * aligner.dims.num_layers,
          f"kernel B launched {launches_b_align} times in alignment, expected 2 requests x"
          f" {emission_batches} batches x {aligner.dims.num_layers} layers")
    check(launches_d == 2 * dispatched,
          f"kernel D launched {launches_d} times, expected 2 requests x {dispatched} groups")
    n_words = sum(len(s["text"].split()) for s in timed_segments)
    for _, words in aligned:
        check(len(words) == n_words, f"aligned {len(words)} words of {n_words}")
        for w in words:
            check(0.0 <= w["start"] <= w["end"] <= audio_seconds + 1e-6
                  and 0.0 <= w["score"] <= 1.0 and 0 <= w["segment"] < len(timed_segments),
                  f"word row out of range: {w}")
        check([w["start"] for w in words] == sorted(w["start"] for w in words),
              "word rows out of order")
    check(aligned[0][1] == aligned[1][1], "the two alignment requests gave different words")
    wall, segs, info, st = results[1]
    print(
        f"[6 main path] medium.en int8 b32 greedy: setup {setup_s:.1f} s | audio"
        f" {info.duration:.0f} s, after VAD {info.duration_after_vad:.1f} s | windows"
        f" {len(segs)}, segments {len(segs)}, decode steps per batch {st} | launches"
        f" A {launches_a} (= {sum(steps)} steps x {L_dec}), B {launches_b} (= {batches}"
        f" batches x {L_enc}) over both requests | warm request {results[0][0]:.2f} s,"
        f" timed request {wall:.2f} s ({wall / info.duration * 3600:.1f} s per audio hour,"
        f" {wall * 1e3 / sum(st):.2f} ms per decode step, whole request)"
    )
    align_wall = aligned[1][0]
    print(
        f"[6 main path] alignment, wav2vec2 {aligner.dims.num_layers} layers width"
        f" {aligner.dims.hidden_size} bf16, batch 8: setup {align_setup_s:.1f} s |"
        f" {len(timed_segments)} segments, {n_words} words aligned | groups (t_b, l_b): rows"
        f" per launch {groups} | launches B {launches_b_align} (= 2 x {emission_batches}"
        f" batches x {aligner.dims.num_layers}), D {launches_d} (= 2 x {dispatched} groups)"
        f" | warm request {aligned[0][0]:.2f} s (emissions {stats['emissions_s']:.3f} s,"
        f" items {stats['items_s']:.3f} s, Viterbi {stats['viterbi_s']:.3f} s, post"
        f" {stats['post_s']:.3f} s, stages synchronised), timed request {align_wall:.2f} s"
        f" ({align_wall / audio_seconds * 3600:.1f} s per audio hour)"
    )
    return {"launches_a": launches_a, "launches_b": launches_b + launches_b_align,
            "launches_d": launches_d, "engine": eng, "audio": audio, "aligner": aligner,
            "align_tok": align_tok, "segments": timed_segments}


def phase_stage_times(main: dict) -> None:
    """Encoder ms per batch of 32 windows and decode ms per step at b32,
    measured after the main path (these launches are not counted)."""
    import torch

    from whisper_nemo_tpu_torch.models.whisper_stacked import (
        cross_kv_decode_layout_fused,
        decode_step_stacked,
        init_stacked_cache,
    )
    from whisper_nemo_tpu_torch.ops import mel

    eng, audio = main["engine"], main["audio"]
    waves = torch.from_numpy(audio[: 32 * mel.N_SAMPLES].reshape(32, mel.N_SAMPLES)).cuda()
    with torch.inference_mode():
        mels = mel.log_mel_spectrogram_batch(waves, eng.dims.n_mels)
        enc_ms = cuda_ms(lambda i=0: eng.encode_windows(mels), 3)
        mel_ms = cuda_ms(lambda i=0: mel.log_mel_spectrogram_batch(waves, eng.dims.n_mels), 3)
        feats = eng.encode_windows(mels)
        ckv_ms = cuda_ms(lambda i=0: cross_kv_decode_layout_fused(
            eng.params, feats, eng.dims, bits=8), 3)
        ckv = cross_kv_decode_layout_fused(eng.params, feats, eng.dims, bits=8)
        cache = init_stacked_cache(32, eng.dims, eng.dtype, 256, feats.device)
        tok = torch.full((32,), 220, device=feats.device)
        step_ms = cuda_ms(lambda i=0: decode_step_stacked(
            eng.params, tok, 2 + i % 200, cache, ckv, eng.dims, eng.dtype, return_hidden=True), 50)
        # the host's share: time to enqueue 50 steps, against the time
        # until the device has run them
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(50):
            decode_step_stacked(eng.params, tok, 2 + i, cache, ckv, eng.dims, eng.dtype,
                                return_hidden=True)
        enqueue_ms = (time.perf_counter() - t0) * 1e3 / 50
        torch.cuda.synchronize()
        done_ms = (time.perf_counter() - t0) * 1e3 / 50
    print(f"[6b stages] b32 medium.en int8: mel {mel_ms:.2f} ms, encoder {enc_ms:.2f} ms,"
          f" cross-KV projection+quantization {ckv_ms:.2f} ms, decode step {step_ms:.3f} ms"
          f" (CUDA events); host enqueues a step in {enqueue_ms:.3f} ms, device done"
          f" {done_ms:.3f} ms after the first enqueue, per step")


def phase_align_stage_times(main: dict, d_case_a: dict) -> None:
    """The aligner's stages apart, after the main path (these launches are
    not counted): emissions per batch of 8 chunks (CUDA events), then the
    Viterbi half on resident emissions with the device synchronised
    between its stages; kernel D's time per group is phase 3b case (a),
    the same shape."""
    import torch

    from whisper_nemo_tpu_torch.align.api import CHUNK_SECONDS, generate_emissions
    from whisper_nemo_tpu_torch.align.segmented import align_emissions
    from whisper_nemo_tpu_torch.models.wav2vec2 import ctc_logits

    aligner, audio = main["aligner"], main["audio"]
    chunk = CHUNK_SECONDS * SR
    waves = torch.from_numpy(audio[: 8 * chunk].reshape(8, chunk)).cuda()
    with torch.inference_mode():
        em_ms = cuda_ms(lambda i=0: torch.log_softmax(
            ctc_logits(aligner.params, waves, aligner.dims, aligner.dtype), dim=-1), 3)
        emissions, stride = generate_emissions(aligner, audio, 8, device=True)
    torch.cuda.synchronize()  # the stages below wait for none of the emissions' work
    stats = {}
    align_emissions(emissions, stride, main["align_tok"], main["segments"], device="cuda",
                    stats=stats)
    print(f"[6b stages] alignment: emissions {em_ms:.1f} ms per batch of 8 x 30 s (CUDA"
          f" events) | on resident emissions: items (host text and labels)"
          f" {stats['items_s'] * 1e3:.1f} ms, Viterbi groups {stats['viterbi_s'] * 1e3:.1f} ms"
          f" (block build, state gather, kernel D; kernel D alone {d_case_a['ms']:.2f} ms per"
          f" group of 48), paths to host and words {stats['post_s'] * 1e3:.1f} ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    smi = phase_device()
    phase_build()
    a = phase_kernel_a(args.seed)
    d = phase_kernel_d(args.seed)
    b = phase_kernel_b(args.seed)
    phase_slice_parity(args.seed)
    phase_align_parity(args.seed)
    main_run = phase_main_path(args.seed)
    phase_stage_times(main_run)
    phase_align_stage_times(main_run, d["a"])

    import torch

    kernels = [
        {"name": "cross_attention_decode_layered", "route": "cuda",
         "source": "whisper_nemo_tpu_torch/csrc/cross_decode.cu",
         "replaces": "whisper_nemo_tpu/ops/cross_decode.py:261",
         "launches": main_run["launches_a"], **a},
        {"name": "encoder_attention", "route": "cuda",
         "source": "whisper_nemo_tpu_torch/csrc/encoder_attention.cu",
         "replaces": "whisper_nemo_tpu/ops/attention.py:91",
         "launches": main_run["launches_b"], **b["whisper"]},
        {"name": "viterbi_batch", "route": "cuda",
         "source": "whisper_nemo_tpu_torch/csrc/viterbi.cu",
         "replaces": "whisper_nemo_tpu/ops/viterbi_pallas.py:101",
         "launches": main_run["launches_d"], **d["a"]},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

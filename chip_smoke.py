#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (whisper_nemo_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, one line each:
  1. device: name, power limit, versions; fails without CUDA;
  2. build: the port's CUDA kernels from whisper_nemo_tpu_torch/csrc;
  3. kernel A (cross-attention decode) against its plain version at
     medium.en decode shapes, bits 8 and 4, beam 1 and 5;
  4. kernel B (encoder attention) against its plain version at the
     medium.en encoder shape;
  5. slice parity: the batched pipeline at small dims on the GPU (the
     kernels) against the same pipeline on the CPU (the plain versions);
  6. the main path: WhisperModel("medium.en", compute_type="int8") and
     BatchedInferencePipeline.transcribe(batch_size=32, beam_size=1) on two
     requests of 20 minutes of synthetic speech, with the kernels' launch
     counts checked against the decode steps and encoder batches;
  7. the card's name and power limit, the kernels' JSON line, and last
     {"ok": true, "device": {...}}.
Any phase that fails raises, and the script exits non-zero without the
last line. Weights are random from --seed unless $WNT_MODEL_DIR holds
medium.en.npz.
"""

from __future__ import annotations

import argparse
import ctypes.util
import json
import subprocess
import sys
import time

import numpy as np

SR = 16000
BOUND_A = 5e-3  # |kernel - plain|: outputs are O(1); f32 sums in another order
BOUND_B = 1e-2  # bf16 P in the PV product vs bf16 normalized weights; bf16 output
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
    for name in ("cross_decode", "encoder_attention"):
        _build.load(name)
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
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_kernel_b(seed: int) -> dict:
    import torch

    from whisper_nemo_tpu_torch.ops import attention as at

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    out = {}
    for dtype, b in ((torch.bfloat16, 32), (torch.float32, 4)):
        B, T, H, D = b, 1500, 16, 64
        q, k, v = (torch.randn((B, T, H, D), device=dev, generator=g).to(dtype) for _ in range(3))
        got = at._encoder_attention_cuda(q, k, v)
        ref = at._xla_attention(q, k, v)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "kernel B gave non-finite values")
        err = float((got.float() - ref.float()).abs().max())
        ms = cuda_ms(lambda i=0: at._encoder_attention_cuda(q, k, v), 10)
        plain_ms = cuda_ms(lambda i=0: at._xla_attention(q, k, v), 3)
        flops = 4 * B * H * T * T * D
        print(
            f"[4 kernel B] {str(dtype)[6:]} B={B} T={T} H={H} D={D}: max|err| {err:.3e}"
            f" (bound {BOUND_B:g}) | kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s),"
            f" plain {plain_ms:.3f} ms"
        )
        check(err <= BOUND_B, f"kernel B {dtype}: max|err| {err} > {BOUND_B}")
        if dtype == torch.bfloat16:
            out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
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


def phase_main_path(seed: int) -> dict:
    import torch

    from whisper_nemo_tpu_torch.asr import BatchedInferencePipeline, WhisperModel
    from whisper_nemo_tpu_torch.ops import attention as at
    from whisper_nemo_tpu_torch.ops import cross_decode as cd

    t0 = time.time()
    model = WhisperModel("medium.en", device="cuda", compute_type="int8", seed=seed)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    eng = model.engine
    pipeline = BatchedInferencePipeline(model)
    audio = speechlike(20 * 60.0, seed + 2)
    L_dec, L_enc = eng.dims.n_text_layer, eng.dims.n_audio_layer

    cd.cross_attention_decode_layered.launches = 0
    at.encoder_attention.launches = 0
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
    return {"launches_a": launches_a, "launches_b": launches_b, "engine": eng, "audio": audio}


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    smi = phase_device()
    phase_build()
    a = phase_kernel_a(args.seed)
    b = phase_kernel_b(args.seed)
    phase_slice_parity(args.seed)
    main_run = phase_main_path(args.seed)
    phase_stage_times(main_run)

    import torch

    kernels = [
        {"name": "cross_attention_decode_layered", "route": "cuda",
         "source": "whisper_nemo_tpu_torch/csrc/cross_decode.cu",
         "replaces": "whisper_nemo_tpu/ops/cross_decode.py:261",
         "launches": main_run["launches_a"], **a},
        {"name": "encoder_attention", "route": "cuda",
         "source": "whisper_nemo_tpu_torch/csrc/encoder_attention.cu",
         "replaces": "whisper_nemo_tpu/ops/attention.py:91",
         "launches": main_run["launches_b"], **b},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

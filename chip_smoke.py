#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (whisper_nemo_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, one line each:
  1. device: name, power limit, versions, whether libav, nltk,
     tokenizers, pydantic and aiohttp are present (the port needs none of
     them); fails without CUDA;
  2. build: the port's CUDA kernels from whisper_nemo_tpu_torch/csrc, one
     nvcc per source, all started together;
  3. kernel A (cross-attention decode) against its plain version at
     medium.en decode shapes (32 windows), bits 8 and 4, beam 1 and 5,
     with its cluster size and CTAs, its time (CUDA events over
     back-to-back calls), its device time (torch.profiler) and share of
     its bound, and bits 8 timed at cluster sizes 2, 4 and 8;
  3b. kernel D (batched CTC Viterbi) against its plain version, bit for
     bit: the segmented aligner's main bucket, a global forced_align of
     5 minutes of speech, and a trellis of 30,001 states (a cluster of 8
     CTAs); its ptxas registers, and a check that it spills none;
  3c. kernel E (beam-ancestry self-attention) against its plain version
     on the beam-5 decode cache of medium.en at batch 32, bf16 and f32, at
     positions 2, 127 and 225 with a shared mask, and at 127 with one mask
     row per beam row, each with a random ancestry map and with a beam's
     runs (long shared prefixes); CUDA events and the profiler's device
     time; position 225 at cluster sizes 1, 2, 4 and 8;
  3d. kernel F (beam cache permute) against its plain versions, bit for
     bit, out of place and in place, on the same cache, with
     index_select timed beside it as a yardstick;
  3e. kernel C (log-mel: a real FFT a frame and the bank's nonzero runs)
     against its plain version and against a float64 evaluation of the
     same formula at 80 and 128 mel bands: a 30 s window, a 7.3 s one
     zero-padded to 30 s, silence and a batch of 32 windows; one window
     and the batch timed by CUDA events and the profiler's device time,
     with torch.stft (the STFT alone) timed beside them as a yardstick;
     then 32 windows of white noise, printed and not held to the bounds;
  3f. kernels A, B and E at the sequential path's batch-1 shapes: A at
     one window, beam 5 and 1 (and at cluster sizes 2, 4 and 8); B at one
     window; E at B·K = 5 with a 384-position cache, one mask row per
     beam row and 40 left-padded slots, bf16 and f32, both ancestry maps,
     and at cluster sizes 1, 2, 4 and 8;
  4. kernel B (encoder attention) against its plain version at the
     shapes the paths give it (the medium.en encoder at B=32 and B=1 in
     bf16; f32, split into bf16 parts, at medium.en's B=4 and B=8 and
     large-v2's B=4 with 20 heads, within 1e-4 and no slower than SDPA at
     f32 with TF32 off; the wav2vec2 aligner at T=1499 in bf16, and in f32
     at phase 5b's 2 heads) and at head dims 32, 48, 80 and 128 (128 also
     at f32), with SDPA timed beside each shape (in the inputs' dtype) as
     a yardstick, the f32 FMA bound beside the f32 rows, and its stages,
     tile and registers;
  5. slice parity: the batched pipeline at small dims on the GPU (the
     kernels) against the same pipeline on the CPU (the plain versions),
     greedy and at beam 5;
  5b. alignment parity: wav2vec2 emissions at small dims on the GPU
     against the CPU, then the segmented aligner on both fed the same
     emissions;
  5c. sequential parity: WhisperModel.transcribe at small multilingual
     dims (language detection, VAD, beam 5, timestamps, conditioning) on
     the GPU, each window replayed on the CPU at the GPU's seek with the
     GPU's conditioning tail;
  5d. widths parity: phase 5 at "default" (f32 with the float cross-KV,
     the CLI's --device auto), greedy and at beam 5, and at "float16"
     (the CLI's --device cuda), greedy; kernel E's launches counted at
     beam 5 and kernel A's held at 0 over the float cross-KV;
  5e. diarization parity: NeuralDiarizer at small widths (energy VAD,
     TitaNet small, MSDD, a seeded tree saved to a temporary
     $WNT_MODEL_DIR) on the GPU against the CPU, eight audios of 60 s
     of three voices at the telephonic preset: embeddings within 1e-4;
     dense labels equal wherever the eigengap determines them (on at
     least one audio), elsewhere the eigenvectors checked as
     eigenvectors; long-form (chunks of 100) partitions equal on every
     audio and Nyström (threshold lowered to 128) partitions on at least
     half; MSDD's mean sigmoids within 1e-5 and turns equal on an audio
     with the dense gap;
  5f. flow parity: the CLI flow (cli/flow.run_sequential, --device auto)
     at small dims on the GPU against its tail on the CPU from the same
     AsrResult, on the first of eight seeded audios of 60 s of three
     voices with the eigengap: the aligned words' texts and segments
     equal and their times within FLOW_MOVE_TOL (two emission frames),
     the speaker turns equal, and the .txt and .srt bytes of the CPU's
     diarization, punctuation and writers over the card's words equal to
     the card's;
  5j. converted checkpoints: seeded sources in the published layouts at
     the published dims (an OpenAI medium.en .pt in f16; .nemo tars of
     vad_multilingual_marblenet, titanet_large and diar_msdd_telephonic;
     pyannote segmentation-3.0's lightning pytorch_model.bin; an htdemucs
     .th whose klass is a class of a module no process here imports; HF
     directories of MMS-300M and XLM-R base cut to 2 layers, written by
     write_safetensors), each converted by `python -m
     whisper_nemo_tpu_torch.cli.convert` in a new process (seconds,
     bytes, peak RSS; jax, the JAX package, transformers, safetensors and
     demucs never imported; without PyYAML the .nemo kinds must raise
     naming it and convert in process from the config dict); then, the
     counts zeroed just before: medium.en "float16" greedy from the
     converted .npz and from the converter's tree in memory on 60 s of
     four voices, tokens equal, kernels C, B and A launched; the converted
     aligner's emissions (B) and punctuation labels; the diarizer on the
     converted NeMo stack (models/conv_asr.py), PyanNet and htdemucs on
     the card against the CPU within 5e's, 6m's and 5i's bounds; A, B and
     C held against their plain versions at the shapes it launched;
  6. the main path, as the CLI flow runs it: WhisperModel("medium.en",
     compute_type="int8") and BatchedInferencePipeline.transcribe(
     batch_size=32) at its default beam 5 on two requests of 20 minutes
     of synthetic speech (warm and timed), one greedy request (beam_size=1,
     bench.py's), then align_segments with the full-width (MMS-300M-sized)
     aligner in bf16 on a synthetic 150 wpm transcript, warm and timed;
     the kernels' launch counts are checked against the decode steps,
     encoder batches (kernel C's batched mel and B), emission batches and
     Viterbi groups of each;
  6b. stage times of both stages, measured apart, and the beam step's
     parts;
  6c. the sequential main path, the CLI's --batch-size 0 call:
     WhisperModel("medium.en", compute_type="int8").transcribe(audio,
     None, suppress_tokens=[-1], vad_filter=True) at its defaults (beam
     5, the temperature ladder, timestamps; conditioning on the previous
     text is on, but one seek window has no earlier text, so only 5c
     decodes a conditioned window, at small dims), one warm request of one window (temperatures 0 and 0.2
     only) and one timed request of 25 s (one seek window); then the
     openai facade on the same audio with the serving handler's
     arguments; launches of C, B, A
     and E checked against the windows and decode steps; then the
     sequential request's stage times;
  6d. the main path at the default width: WhisperModel("medium.en",
     compute_type="default") (f32, float cross-KV) and the batched
     pipeline at beam 5 on one batch of windows (10 minutes of audio),
     kernel E's launches checked against the steps, kernel C's at one
     (the batch's mel) and kernel A's at 0;
     then the f32 beam step's device time;
  6e. the diarization main path at full width, bench.py's call:
     NeuralDiarizer(create_config(tmp, "telephonic"),
     force_large_models=True) (TitaNet-large, the full MarbleNet forward,
     the telephonic MSDD; no kernel of the port lies on it), a warm
     request of 2 minutes of four voices, then 15, 30 and 60 minutes with
     num_speakers=4, which take the dense eigh, the Nyström and the
     long-form paths (asserted); per request its counts, wall time, stage
     times and peak device memory;
  6f. the CLI flow at full width: run_sequential with --whisper-model
     medium.en --batch-size 8 --device auto --domain telephonic --no-stem
     (medium.en "default", beam 5; the MMS-300M-sized aligner in bf16;
     TitaNet-large and the telephonic MSDD from seeded checkpoints; XLM-R
     base) on 5 minutes of four voices: the wall, each stage's seconds,
     the counts, the peak device memory, launches of B, C, D and E against
     the batches, steps and Viterbi groups (A and F at 0), the outputs
     checked; then the same in process with the user's command's
     arguments, `-a <60 s wav> --device cuda --no-stem` (medium.en
     "float16": the int8 cross-KV, A's launches against the steps too);
     then that command, `python3 -m whisper_nemo_tpu_torch.cli`, as a
     subprocess (exit 0, both files well formed);
  6g. kernels A to E against their plain versions at every shape 6f's
     two in-process runs launched them at (recorded per launch): B on
     the f32 and bf16 encoders and the aligner at batch 8, C at batch 8,
     D at each Viterbi group's trellis, E at each cluster split its
     wrapper chose (at the largest visible length with it), A at the
     int8 cross-KV of 8 windows at beam 5; the flow's JSON entries come
     from these, one a shape, with its launches in 6f;
  5g. serving parity: the window scheduler (batch 4, timestamped, buckets
     1, 2 and 4 each dispatched, the token limits) and the handler's jobs
     (full, transcription only, the openai facade's branch, the NDJSON
     stream, and /run and /stream over aiohttp on loopback where it
     imports) at small dims, int8, on the GPU against the CPU: each
     dispatch's windows equal, each window's tokens equal or parted at a
     tie, the full and transcription-only responses equal apart from
     processing_time (from the GPU's transcription where a window parted
     at a tie), every job successful;
  6h. the serverless handler at full width: load_models() with its
     defaults (Whisper large-v2 int8, batch 16, the general-preset
     diarizer on TitaNet-large), the scheduler rebuilt with bench.py's
     token limits (64-96), warmup, single-window latency, one 10-minute
     job alone and four together, with walls, dispatches by pad size,
     peak memory and each kernel's launches by shape;
  6i. kernels A, B and C against their plain versions at every shape 6h
     launched them at (H=20), SDPA timed beside B;
  5h. parallel parity: the parallel CLI flow (cli/flow.run_parallel) at
     small dims on the card, in process (two threads, each on a CUDA
     stream of its own) and with --subprocess-diarization (the diarizer in
     a child process), each run's .txt and .srt bytes equal to the card's
     run_sequential at the same arguments;
  6j. the parallel CLI flow at full width: diarize_parallel.py's defaults
     (large-v2 at its published dims, "default", beam 5, batch 4; the
     aligner in bf16; TitaNet-large and the telephonic MSDD from seeded
     checkpoints; XLM-R base) at --device auto --no-stem --language en on
     6f's 5 minutes of four voices: run_sequential (the control), then
     run_parallel in process (counts zeroed just before and read just
     after, launches held to the ASR branch's batches, steps and groups),
     with walls, each branch's stage times, the diarization time the
     overlap hid, peak memory, launches by shape and whether the bytes
     equal the control's; then `python3 -m
     whisper_nemo_tpu_torch.cli.parallel ... --subprocess-diarization` on
     60 s as a new process; then B (f32 and the bf16 aligner), C, D and E
     against their plain versions at the shapes both runs launched;
  5i. separation and pyannote parity: htdemucs at small dims (the
     forward, and apply_segments over 8 windows 3 a batch), resample_poly
     44.1 kHz -> 16 kHz, PyanNet's speech probabilities and ECAPA's
     embeddings on the GPU against the CPU, f32; then 5f's flow with a
     small seeded htdemucs.npz and its sidecar, stemming on: the card's
     vocals.wav within 1.5 PCM steps of the CPU's separation, the rest
     held as in 5f but the aligned words' times (printed);
  6k. BASELINE config 3 through the CLI flow at full width: run_sequential
     with --whisper-model large-v3 --domain meeting --language en and the
     CLI's defaults (stemming on: a seeded full-size htdemucs.npz; --device
     auto, "default", beam 5, batch 8; TitaNet-large and the meeting
     preset's MSDD from seeded checkpoints) on 6f's 5 minutes: the wall,
     each stage's seconds (separation apart), peak memory and launches by
     shape; then bench.py's device handoff (apply_segments of the stereo
     mix at 44.1 kHz, vocals only, left on the card; mono; resample_poly
     to 16 kHz) timed alone, and the resample beside its bound;
  6l. kernels B, C, D and E against their plain versions at every shape
     6k launched them at (B f32 at H=20, C at 128 mels, E f32 at H=20);
  6m. the diarizer with PyanNet (a seeded full-size
     pyannote_segmentation.npz) and ECAPA-TDNN under force_large_models
     on 15 minutes of four voices: wall, stages, peak memory, the speech
     share; the VAD's probabilities over the 15 minutes and, on the first
     2, the embeddings and turns held against the CPU;
  7. the card's name and power limit, the kernels' JSON line, and last
     {"ok": true, "device": {...}}.
Any phase that fails raises, and the script exits non-zero without the
last line. Weights are random from --seed unless $WNT_MODEL_DIR holds
medium.en.npz, ctc_aligner.npz and (for 6e) the diarization checkpoints;
phases 5f, 5g, 5h, 5j, 6f, 6h, 6j, 6k and 6m make their own model
directories, 5f-6k with a vocabulary whose tokens are words
(``word_vocab``).
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import ctypes.util
import dataclasses
import functools
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

SR = 16000
BOUND_A = 5e-3  # |kernel - plain|: outputs are O(1); f32 sums in another order
BOUND_B = 1e-2  # bf16 P in the PV product vs bf16 normalized weights; bf16 output
# f32 in and out: split bf16 products drop terms of order 2^-16 of each
# product, against the plain version's f32 (TF32 off)
BOUND_B_F32 = 1e-4
# kernel B's tiling, as the constants of csrc/encoder_attention.cu set it
KERNEL_B_DESIGN = ("bf16, D <= 64: 192-query CTAs of 1 producer warp and 3 consumer warpgroups of"
                   " 64 query rows; bf16 64 < D <= 128 and every f32 instantiation: 128-query"
                   " CTAs of 2 consumer warpgroups at 240 registers; 128-key tiles, 2 TMA"
                   " stages (1 at f32 D = 128); f32 as split bf16, hi and lo parts of q, k, v"
                   " and P, three products per product")


def bound_b(dtype) -> float:
    """Kernel B's bound against its plain version for inputs of ``dtype``."""
    import torch

    return BOUND_B_F32 if dtype == torch.float32 else BOUND_B
BOUND_D = 0.0  # one f32 add per state and step and an exact max: bit-equal
# Kernel E against its plain version: both round the output to bf16 once
# and sum in f32, in another order; a weight near a bf16 rounding boundary
# may round the other way. Outputs are of order 1.
BOUND_E = (1e-2, 1e-2)  # |kernel - plain| <= atol + rtol * |plain|
# At f32 (the default width's cache) q, the weights and the output stay f32
# on both sides: only the order of the f32 sums differs.
BOUND_E_F32 = (1e-4, 1e-4)
BOUND_F = 0.0  # a copy: bit-equal
# Kernel C against its plain version, after whisper's normalization (values
# of order 1): an f32 FFT against f32 dense products, each with its own
# rounding (at 128 mels the plain version's own distance from float64 is of
# the same order)
BOUND_C = 1e-4
# Kernel C against the same formula evaluated in float64, after whisper's
# normalization: the f32 FFT's own rounding (the CPU tests hold a numpy
# model of its factorization to the same bound)
BOUND_C_F64 = 5e-5
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
# (tests/test_torch_whisper.py), and kernel B adds its bf16 P. At beam 5
# the CPU rescores each GPU hypothesis, teacher-forced: the GPU's mean
# log-probability per token must agree with it to SCORE_TOL (at these
# dims the CPU's own beam decode is at most 1.05e-3 from its rescoring;
# a decode that ignores the ancestry map, or drops a lane's own position
# from it, misses by 5e-2 or more), and the CPU's best may lead it by
# less than TIE_TOL.
TIE_TOL = 0.05
SCORE_TOL = 5e-3
# The main path's beam decode: medium.en's decoder at batch 32, beam 5,
# cache of 256 positions (224 new tokens after the prompt)
L_DEC, WINDOWS, BEAM, HEADS, HEAD_DIM, CACHE_LEN = 24, 32, 5, 16, 64, 256


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


# (pitch Hz, formant Hz) of the synthetic voices of the diarization phases
VOICES = ((110.0, 500.0), (190.0, 1200.0), (300.0, 2500.0), (150.0, 1800.0))


def voices(seconds: float, seed: int, n_speakers: int = 3) -> np.ndarray:
    """Seeded turns of 1.5-4 s by ``n_speakers`` voices taking turns in
    rotation, with gaps of 0.2-0.8 s. A voice is its pitch's harmonics
    shaped by a formant band, under a 3 Hz envelope, plus noise."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    audio = (rng.standard_normal(n) * 1e-4).astype(np.float32)
    ph = np.arange(4 * SR) / SR
    tones = []
    for pitch, formant in VOICES[:n_speakers]:
        wave = sum(np.sin(2 * np.pi * h * pitch * ph) * np.exp(-((h * pitch - formant) / 600.0) ** 2)
                   for h in range(1, 20))
        tones.append((wave / np.abs(wave).max() * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * ph)))
                     .astype(np.float32))
    t0, turn = int(0.3 * SR), 0
    while t0 < n:
        m = min(int(rng.uniform(1.5, 4.0) * SR), n - t0)
        noise = rng.standard_normal(m).astype(np.float32)
        audio[t0: t0 + m] += 0.3 * (tones[turn % n_speakers][:m] + 0.05 * noise)
        t0 += m + int(rng.uniform(0.2, 0.8) * SR)
        turn += 1
    return audio


@contextlib.contextmanager
def env_var(name: str, value: str):
    """The environment variable ``name`` set to ``value`` within the block."""
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield value
    finally:
        if saved is None:
            del os.environ[name]
        else:
            os.environ[name] = saved


def model_dir(path: str):
    """$WNT_MODEL_DIR set to ``path`` within the block."""
    return env_var("WNT_MODEL_DIR", path)


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


def profiled_device_ms(fn, reps: int) -> dict:
    """Device ms per call of each kernel, by name, from a torch.profiler
    trace of ``reps`` calls: the device-side events only (an operator's
    event repeats the time of the kernels it launched). Empty where the
    profiler saw no device time. A trace that comes back with no device
    event at all is taken again, up to twice: after many traces in one
    process the profiler has returned one without its device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                fn(i)
            torch.cuda.synchronize()
        out = {ev.key: ev.self_device_time_total / 1e3 / reps for ev in prof.key_averages()
               if ev.device_type != DeviceType.CPU and ev.self_device_time_total > 0}
        if out:
            return out
    return out


def fmt_profile(kernels: dict) -> str:
    """Total device ms per step, kernels A and E, and the six largest."""
    if not kernels:
        return "device time not measured (the profiler saw no device activity)"
    share = {k: sum(ms for name, ms in kernels.items() if f"{k}_kernel" in name)
             for k in ("cross_decode", "self_decode")}
    top = sorted(kernels.items(), key=lambda kv: kv[1], reverse=True)[:6]
    short = [(name.replace("void ", "").replace("(anonymous namespace)::", "")
              .replace("at::native::", "")[:70], ms) for name, ms in top]
    return (f"device time {sum(kernels.values()):.3f} ms per step (kernel A"
            f" {share['cross_decode']:.3f}, kernel E {share['self_decode']:.3f}), largest: "
            + "; ".join(f"{name} {ms:.3f}" for name, ms in short))


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
    # the port's audio decoder links libav where it builds (else it reads
    # PCM WAV only); the JAX package's punctuation reads nltk and
    # tokenizers, which the port does not need
    libav = ctypes.util.find_library("avformat") or "absent"
    present = {name: importlib.util.find_spec(name) is not None
               for name in ("nltk", "tokenizers", "pydantic", "aiohttp")}
    print(
        f"[1 device] {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | devices {torch.cuda.device_count()} | regex {has_regex}"
        f" | libavformat {libav} (without it the port's decoder reads PCM WAV only)"
        f" | nltk {present['nltk']}, tokenizers {present['tokenizers']} (the port needs neither)"
        f" | pydantic {present['pydantic']}, aiohttp {present['aiohttp']} (the serving layer"
        " needs neither; aiohttp only for its HTTP front end and downloads)"
    )
    return smi


def phase_build():
    from whisper_nemo_tpu_torch.ops import _build

    t0 = time.time()
    names = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    check(names == ["beam_permute", "cross_decode", "encoder_attention", "log_mel", "self_decode",
                    "viterbi"], f"unexpected kernel sources {names}")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.load, names))
    secs = time.time() - t0
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name}: {line.strip()}")
    print(f"[2 build] kernels built and loaded in {secs:.1f} s into {_build.BUILD_DIR}")


def kernel_a_bound_ms(windows: int, beam: int, bits: int, H=HEADS, D=HEAD_DIM, T=1500) -> float:
    """Least time of one kernel A layer launch: the K|V^T bytes of the T
    real positions (read once for all beam lanes; bits 4 packs two values
    a byte), q and the output, at the memory rate."""
    rows = 2 * D if bits == 8 else D
    return (windows * H * rows * T + 2 * windows * beam * H * D * 4) / HBM_BYTES_S * 1e3


def kernel_e_kv_bytes(anc, n_vis: int, H=HEADS, D=HEAD_DIM, esize=2) -> int:
    """The K and V bytes kernel E's function needs: at each visible
    position of each window only the rows ``anc`` names there, so one
    ``2·H·D·esize`` for each distinct (window, source lane, position)."""
    import torch

    a = anc[:, :, :n_vis].long()
    seen = torch.zeros(a.shape, dtype=torch.bool, device=a.device).scatter_(1, a, True)
    return int(seen.sum()) * 2 * H * D * esize


def kernel_e_bound(anc, n_vis: int, mask_rows: int, H=HEADS, D=HEAD_DIM, esize=2) -> tuple:
    """(least time, what bounds it) of one kernel E layer launch: the K
    and V rows ``anc`` names up to ``n_vis`` (``kernel_e_kv_bytes``), q
    and the output (``esize`` bytes an element: bf16 or f32), anc and the
    mask, each read or written once; 4 FLOPs a visible channel of each
    query lane at the f32 rate."""
    bk = anc.shape[0] * anc.shape[1]
    bytes_ = (kernel_e_kv_bytes(anc, n_vis, H, D, esize) + 2 * bk * H * D * esize
              + bk * n_vis * 4 + mask_rows * n_vis * 4)
    by_bytes = bytes_ / HBM_BYTES_S * 1e3
    by_ops = 4.0 * bk * H * D * n_vis / F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def ptxas_summary(name: str) -> str:
    """Registers, spills and shared memory per compiled function of kernel
    ``name`` from the ptxas log ``_build.build_logs`` keeps."""
    from whisper_nemo_tpu_torch.ops import _build

    lines = [ln.strip() for ln in _build.build_logs.get(name, "").splitlines()]
    regs = [ln.split("Used ")[1].split(",")[0] for ln in lines if "Used " in ln and "registers" in ln]
    spills = [ln.split(", ")[1] for ln in lines if "spill stores" in ln]
    return f"ptxas: {'; '.join(regs) or 'not in this process log'} ({'; '.join(sorted(set(spills)))})"


def kernel_a_times(cd, q, kv, k_scale, v_scale, k_len, bits, beam, reps, cluster=None) -> tuple:
    """(CUDA-event ms, device ms) per kernel A layer launch, walking the
    layers: the events time back-to-back calls, as every kernel's ``ms``
    here (at one window the host's enqueue of a call outlasts the kernel,
    so they time the host); torch.profiler gives the kernel's own device
    time."""
    L = kv.shape[0]

    def launch(i=0):
        return cd._cross_attention_decode_cuda(q, kv, k_scale, v_scale, i % L, k_len, bits, beam,
                                               cluster)

    event_ms = cuda_ms(launch, reps)
    device_ms = sum(v for k, v in profiled_device_ms(launch, reps).items()
                    if "cross_decode_kernel" in k)
    check(device_ms > 0, "torch.profiler saw no cross_decode kernel")
    return event_ms, device_ms


def kernel_a_case(cd, q, kv, k_scale, v_scale, k_len, bits, beam, reps) -> dict:
    """Kernel A against its plain version at both ends of the layer stack,
    then its times per layer launch (``kernel_a_times``) and the plain
    version's; outputs include v_scale."""
    import torch

    L, W = kv.shape[0], kv.shape[1]
    err = 0.0
    for layer in (0, L - 1):
        got = cd._cross_attention_decode_cuda(q, kv, k_scale, v_scale, layer, k_len, bits, beam)
        ref = cd._cross_attention_decode_plain(cd.fold_q(q, k_scale), kv, layer, k_len, bits,
                                               beam) * v_scale
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "kernel A gave non-finite values")
        err = max(err, float((got - ref).abs().max()))
    ms, device_ms = kernel_a_times(cd, q, kv, k_scale, v_scale, k_len, bits, beam, reps)
    plain_ms = cuda_ms(lambda i=0: cd._cross_attention_decode_plain(
        cd.fold_q(q, k_scale), kv, i % L, k_len, bits, beam) * v_scale, max(reps // 8, 4))
    c = cd._cluster_size(W, q.shape[2], kv.shape[-1], cd._sms(q.device.index))
    return {"max_abs_err": err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": kernel_a_bound_ms(W, beam, bits, H=q.shape[2], D=q.shape[3], T=k_len),
            "bound_by": "bytes",
            "library_ms": None, "cluster": c, "ctas": c * W * q.shape[2]}


def fmt_a(r: dict) -> str:
    return (f"max|err| {r['max_abs_err']:.3e} (bound {BOUND_A:g}) | kernel {r['ms']:.4f} ms/layer"
            f" (CUDA events over back-to-back calls), {r['device_ms']:.4f} ms of device time"
            f" (torch.profiler) (cluster {r['cluster']}, {r['ctas']} CTAs), plain"
            f" {r['plain_ms']:.4f} ms | bound {r['bound_ms']:.4f} ms (bytes), kernel at"
            f" {r['bound_ms'] / r['ms']:.0%} of it ({r['bound_ms'] / r['device_ms']:.0%} by device"
            " time)")


def fmt_sweep(sweep: dict) -> str:
    return ", ".join(f"{c}: {ev:.4f} ({dev:.4f})" for c, (ev, dev) in sweep.items())


def phase_kernel_a(seed: int) -> dict:
    """Kernel A at the batched decode's shape (W=32), bits 8 and 4, beam 1
    and 5, at the wrapper's cluster size, then bits 8 at cluster sizes 2,
    4 and 8 beside it (the rule of ``_cluster_size``)."""
    import torch

    from whisper_nemo_tpu_torch.ops import cross_decode as cd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    L, W, H, D, T = L_DEC, WINDOWS, HEADS, HEAD_DIM, 1500
    kp = T + (-T % 128)
    k_scale = 0.02 + 0.02 * torch.rand((H, D), device=dev, generator=g)
    v_scale = (0.5 + torch.rand((H, D), device=dev, generator=g)) / 127
    out = {}
    print(f"  {ptxas_summary('cross_decode')}")
    for bits in (8, 4):
        rows = 2 * D if bits == 8 else D
        kv = torch.randint(-127, 128, (L, W, H, rows, kp), device=dev, generator=g,
                           dtype=torch.int8)
        for beam in (1, 5):
            q = torch.randn((W * beam, 1, H, D), device=dev, generator=g).to(torch.bfloat16)
            r = kernel_a_case(cd, q, kv, k_scale, v_scale, T, bits, beam, 48)
            print(f"[3 kernel A] W={W} bits {bits} beam {beam}: {fmt_a(r)}"
                  f" | {W * H * rows * kp / r['ms'] / 1e6:.0f} GB/s of KV")
            check(r["max_abs_err"] <= BOUND_A,
                  f"kernel A bits {bits} beam {beam}: max|err| {r['max_abs_err']} > {BOUND_A}")
            if bits == 8:
                out[beam] = r
                sweep = {c: kernel_a_times(cd, q, kv, k_scale, v_scale, T, bits, beam, 48, c)
                         for c in (2, 4, 8)}
                print(f"[3 kernel A] W={W} bits 8 beam {beam}, ms/layer by cluster size, CUDA"
                      f" events (device time): {fmt_sweep(sweep)}")
        del kv
    return out


def kernel_c_bound(n_windows: int, n_mels: int) -> tuple:
    """(least time, what bounds it) of the function kernel C computes, the
    un-normalized log10 mel of ``n_windows`` 30 s windows: the larger of
    the bytes it must move (each waveform read once, the nonzero weights
    of this run's mel bank once, the output written once) over the memory
    rate, and the f32 operations it needs over the f32 rate outside the
    tensor cores. Per frame those are the Hann window (400 products), a
    400-point real FFT (2.5·N·log2 N, half of a complex FFT's 5·N·log2 N),
    re^2 + im^2 (3 a bin), one multiply-add for each nonzero weight of the
    bank (the Slaney bank touches each bin at most twice), and the clamp
    and log10 (2 an output)."""
    from whisper_nemo_tpu_torch.ops import mel

    frames, n_fft = mel.N_FRAMES, mel.N_FFT
    bins = n_fft // 2 + 1
    nnz = int(np.count_nonzero(mel.mel_filter_bank(bins, n_mels)))
    ops = n_windows * frames * (n_fft + 2.5 * n_fft * math.log2(n_fft) + 3 * bins + 2 * nnz
                                + 2 * n_mels)
    bytes_ = 4 * (n_windows * mel.N_SAMPLES + nnz + n_windows * frames * n_mels)
    by_ops, by_bytes = ops / F32_FLOPS * 1e3, bytes_ / HBM_BYTES_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def kernel_c_design_ops(n_mels: int) -> float:
    """The f32 operations kernel C's design runs on one 30 s window, beside
    what the function needs (``kernel_c_bound``). Per frame: the window
    (400 products); the 200-point complex FFT as 8 x 25: eight 25-point
    DFTs, each ten radix-5 butterflies (52 operations) and 40 twiddle
    products (6), then 25 radix-8 butterflies (56); the real split and the
    power, 24 a pair of bins over 101 pairs; one multiply-add for each
    nonzero weight of the bank; the clamp and log10 (2 an output)."""
    from whisper_nemo_tpu_torch.ops import mel

    nnz = int(np.count_nonzero(mel.mel_filter_bank(mel.N_FFT // 2 + 1, n_mels)))
    return mel.N_FRAMES * (mel.N_FFT + 8 * (10 * 52 + 40 * 6) + 25 * 56 + 101 * 24 + 2 * nnz
                           + 2 * n_mels)


def _kernel_ms(prof: dict, name: str) -> float:
    """Device ms per call of the kernels whose name holds ``name``, from
    ``profiled_device_ms``; NaN where the profiler saw none."""
    hits = [ms for k, ms in prof.items() if name in k]
    return sum(hits) if hits else float("nan")


def kernel_c_case(waves, n_mels: int, case: str, timed: bool, tag: str = "3e kernel C") -> dict:
    """Kernel C on ``waves [n, 480000]`` against its plain version (cuBLAS
    f32, TF32 off) and against the same formula in float64, after
    whisper's normalization (bounds BOUND_C and BOUND_C_F64); times per
    call (CUDA events; where ``timed``, the profiler's device time) beside
    the plain version and torch.stft: cuFFT's STFT alone, not the whole
    function, which no single PyTorch call computes (the port never calls
    it). Prints one line under ``tag``."""
    import torch

    from whisper_nemo_tpu_torch.ops import mel

    n = waves.shape[0]
    hann = torch.hann_window(mel.N_FFT, periodic=True, device=waves.device)
    got = mel._log_mel_cuda(waves, n_mels)
    want = mel._log_mel_plain(waves, n_mels)
    exact = mel._log_mel_plain(waves, n_mels, torch.float64)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "kernel C gave non-finite values")
    err = float((mel._finalize(got) - mel._finalize(want)).abs().max())
    err64 = float((mel._finalize(got.double()) - mel._finalize(exact)).abs().max())
    plain_err64 = float((mel._finalize(want.double()) - mel._finalize(exact)).abs().max())
    raw_err = float((got - want).abs().max())
    if case == "silence":
        check(bool((got == -10.0).all()), "kernel C: silence is not at the clamp")
    reps = 50 if n == 1 else 20
    ms = cuda_ms(lambda i=0: mel._log_mel_cuda(waves, n_mels), reps)
    plain_ms = cuda_ms(lambda i=0: mel._log_mel_plain(waves, n_mels), reps // 2)
    stft_ms = cuda_ms(lambda i=0: torch.stft(
        waves, mel.N_FFT, hop_length=mel.HOP_LENGTH, window=hann, center=True,
        pad_mode="reflect", return_complex=True), reps)
    device_ms = (_kernel_ms(profiled_device_ms(
        lambda i=0: mel._log_mel_cuda(waves, n_mels), 10), "log_mel_kernel")
        if timed else float("nan"))
    bound_ms, bound_by = kernel_c_bound(n, n_mels)
    design = kernel_c_design_ops(n_mels) * n
    print(f"[{tag}] {n_mels} mels, {case}: max|err| {err:.3e} against the plain"
          f" version (bound {BOUND_C:g}), {err64:.3e} against float64 (bound"
          f" {BOUND_C_F64:g}; the plain version's own {plain_err64:.3e}), normalized;"
          f" un-normalized log10 against the plain version {raw_err:.3e} | kernel"
          f" {ms:.4f} ms a call of {n} window(s) by CUDA events, device"
          f" {device_ms:.4f} ms (profiler) | plain {plain_ms:.4f} ms | torch.stft"
          f" {stft_ms:.4f} ms (the STFT alone, not the whole function) | bound"
          f" {bound_ms:.5f} ms ({bound_by}), kernel at {bound_ms / ms:.2%} of it by"
          f" events | the design's FFT and banded mel: {design / 1e9:.4f} GFLOP,"
          f" {design / F32_FLOPS * 1e3:.5f} ms at the f32 rate,"
          f" {design / ms / 1e9:.2f} TFLOP/s run")
    check(err <= BOUND_C, f"kernel C {n_mels} mels, {case}: max|err| {err} against the"
          f" plain version > {BOUND_C} (against float64: kernel {err64}, plain"
          f" {plain_err64})")
    check(err64 <= BOUND_C_F64, f"kernel C {n_mels} mels, {case}: max|err| {err64}"
          f" against float64 > {BOUND_C_F64}")
    return {"max_abs_err": err, "max_abs_err_f64": err64, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": stft_ms}


def phase_kernel_c(seed: int) -> dict:
    """Kernel C (``kernel_c_case``) at 80 and 128 mel bands, on one 30 s
    window, a 7.3 s one zero-padded to 30 s, silence (every bin at the
    clamp, exactly) and a batch of 32 windows; one window and the batch
    also by the profiler's device time."""
    import torch

    from whisper_nemo_tpu_torch.ops import mel

    dev = torch.device("cuda")
    padded = np.zeros(mel.N_SAMPLES, np.float32)
    padded[: int(7.3 * SR)] = speechlike(7.3, seed + 6)
    cases = {
        "window": speechlike(30.0, seed + 5)[None],
        "padded 7.3 s": padded[None],
        "silence": np.zeros((1, mel.N_SAMPLES), np.float32),
        "batch of 32": speechlike(32 * 30.0, seed + 7).reshape(32, mel.N_SAMPLES),
    }
    out = {}
    for n_mels in (80, 128):
        for case, waves_np in cases.items():
            timed = case in ("window", "batch of 32")
            r = kernel_c_case(torch.from_numpy(waves_np).to(dev), n_mels, case, timed)
            if timed:
                out[(n_mels, waves_np.shape[0])] = r
    # White noise, printed and not held to the bounds: its largest error
    # after normalization sits in a few near-zero bins of one-bin bands (at
    # 128 mels), where every f32 evaluation, the plain version's too, loses
    # digits; speech-like windows keep such bins below the clamp.
    rng = np.random.default_rng(seed + 8)
    noise = torch.from_numpy(
        (0.1 * rng.standard_normal((32, mel.N_SAMPLES))).astype(np.float32)).to(dev)
    for n_mels in (80, 128):
        got = mel._finalize(mel._log_mel_cuda(noise, n_mels)).double()
        want = mel._finalize(mel._log_mel_plain(noise, n_mels)).double()
        exact = mel._finalize(mel._log_mel_plain(noise, n_mels, torch.float64))
        err64, plain_err64, err = (float((x - y).abs().max())
                                   for x, y in ((got, exact), (want, exact), (got, want)))
        print(f"[3e kernel C] {n_mels} mels, white noise (0.1 rms), 32 windows, printed and not"
              f" held to the bounds: max|err| against float64: kernel {err64:.3e}, plain version"
              f" {plain_err64:.3e}; kernel against the plain version {err:.3e}")
    return out


def phase_sequential_shapes(seed: int) -> dict:
    """Kernels A, B and E at the sequential path's shapes, beside their
    plain versions: A on one window (W=1) at beam 5 and beam 1, B on one
    window (the encoder at B=1), E at B·K=5 with medium.en's 384-position
    cache at pos 100, one mask row per beam row and 40 left-padded slots,
    on bf16 and f32 caches, with a random ancestry map and a beam's runs,
    and at cluster sizes 1, 2, 4 and 8."""
    import torch

    from whisper_nemo_tpu_torch.ops import attention as at
    from whisper_nemo_tpu_torch.ops import cross_decode as cd
    from whisper_nemo_tpu_torch.ops import self_decode as sd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    L, H, D, T = L_DEC, HEADS, HEAD_DIM, 1500
    kp = T + (-T % 128)
    out = {}
    kv = torch.randint(-127, 128, (L, 1, H, 2 * D, kp), device=dev, generator=g, dtype=torch.int8)
    k_scale = 0.02 + 0.02 * torch.rand((H, D), device=dev, generator=g)
    v_scale = (0.5 + torch.rand((H, D), device=dev, generator=g)) / 127
    for beam in (5, 1):
        q = torch.randn((beam, 1, H, D), device=dev, generator=g).to(torch.bfloat16)
        r = kernel_a_case(cd, q, kv, k_scale, v_scale, T, 8, beam, 96)
        print(f"[3f kernel A] W=1 beam {beam} bits 8: {fmt_a(r)}")
        check(r["max_abs_err"] <= BOUND_A, f"kernel A at W=1 beam {beam}: max|err| {r['max_abs_err']} > {BOUND_A}")
        sweep = {c: kernel_a_times(cd, q, kv, k_scale, v_scale, T, 8, beam, 96, c)
                 for c in (2, 4, 8)}
        print(f"[3f kernel A] W=1 beam {beam}, ms/layer by cluster size, CUDA events (device"
              f" time): {fmt_sweep(sweep)}")
        out[f"A beam {beam}"] = r
    del kv

    r = kernel_b_case(at, 1, T, H, torch.bfloat16, g)
    print(f"[3f kernel B] B=1 T={T} H={H} D={D} bf16: {fmt_b(r)}")
    check(r["max_abs_err"] <= BOUND_B, f"kernel B at B=1: max|err| {r['max_abs_err']} > {BOUND_B}")
    out["B"] = r

    bk, s_len, pos, pad = BEAM, 384, 100, 40
    positions = torch.arange(s_len, device=dev)
    keep = (positions >= pad) & (positions <= pos)
    mask = torch.where(keep, 0.0, float("-inf"))[None, None, None, :].repeat(bk, 1, 1, 1).contiguous()
    maps = {"random ancestry": torch.randint(0, BEAM, (1, BEAM, s_len), device=dev, generator=g,
                                             dtype=torch.int32),
            "a beam's runs": beam_runs_anc(1, BEAM, s_len, g)}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        kc, vc = (torch.randn((L, bk, H, D, s_len), device=dev, generator=g).to(dtype)
                  for _ in range(2))
        q = torch.randn((bk, 1, H, D), device=dev, generator=g).to(dtype)
        for anc_name, anc in maps.items():
            r = kernel_e_case(sd, at, q, kc, vc, anc, mask, pos + 1, 96)
            print(f"[3f kernel E] {name} B·K={bk} S={s_len} pos {pos}, one mask row per beam row,"
                  f" {pad} pad slots, {anc_name}: {fmt_e(r)}")
            if anc_name == "random ancestry":
                out[f"E {name}"] = r
        sweep = {c: kernel_e_times(sd, q, kc, vc, maps["random ancestry"], mask, pos + 1, 96, c)
                 for c in (1, 2, 4, 8)}
        print(f"[3f kernel E] {name} B·K={bk}, ms/layer by cluster size, CUDA events (device"
              f" time): {fmt_sweep(sweep)}")
    return out


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
    from whisper_nemo_tpu_torch.ops import _build

    spills = [ln.strip() for ln in _build.build_logs.get("viterbi", "").splitlines()
              if "spill stores" in ln and " 0 bytes spill stores, 0 bytes spill loads" not in ln]
    print(f"  kernel D: {ptxas_summary('viterbi')}")
    check(not spills, f"kernel D spills registers: {spills}")
    out = {}
    # (a) the segmented main bucket (2048, 512): 48 segments of 25 s;
    # (b) a global forced_align: 5 min at 20 ms frames, 150 wpm of
    #     5-character words each after a <star>; (c) L = 30001 states,
    #     a cluster of 8 CTAs
    for case, (r, t, n, star, reps) in {
        "a": (48, 2560, 512, 0, 20), "b": (1, 15000, 4600, 6, 5), "c": (2, 1500, 15000, 0, 3),
    }.items():
        out[case] = kernel_d_case(r, t, n, seed + ord(case), star, reps, f"({case})")
    return out


def kernel_d_case(r: int, t: int, n: int, seed: int, star: int, reps: int, what: str,
                  tag: str = "3b kernel D") -> dict:
    """Kernel D on ``_viterbi_inputs(r, t, n)`` against its plain version,
    alpha, backpointers and path bit for bit; its time, the plain
    version's and the bound. Prints one line under ``tag``."""
    import torch

    from whisper_nemo_tpu_torch.ops import ctc

    def plain(e, a):
        alpha, bps = ctc._viterbi_forward_states(e, a)
        return alpha, bps, ctc._viterbi_backtrack(alpha, bps)

    e, a = _viterbi_inputs(r, t, n, seed, star)
    got = ctc._viterbi_cuda(e, a)
    want = plain(e, a)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("alpha", "bps", "path")):
        check(g.dtype == w.dtype and torch.equal(g, w),
              f"kernel D {what}: {name} differs from the plain version")
    err = float((got[0] - want[0]).abs().max())
    ms = cuda_ms(lambda i=0: ctc._viterbi_cuda(e, a), reps)
    plain_ms = cuda_ms(lambda i=0: plain(e, a), 1)
    bound_ms, bound_by = viterbi_bound_ms(r, t, 2 * n + 1)
    print(f"[{tag}] {what} R={r} T={t} L={2 * n + 1}: alpha, bps, path bit-equal"
          f" (max|err| {err:g}, bound {BOUND_D:g}) | kernel {ms:.3f} ms"
          f" ({ms * 1e3 / (t - 1):.3f} us per each of the {t - 1} dependent steps), plain"
          f" {plain_ms:.1f} ms | bound {bound_ms:.4f} ms ({bound_by}), kernel at"
          f" {bound_ms / ms:.1%} of it")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def _beam_cache(seed: int, dtype=None):
    """The beam decode's self-attention cache at the main path's shape,
    ``[24, 160, 16, 64, 256]`` for K and for V (4.0 GB in bf16, the
    default; 8.1 GB in f32), seeded."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (L_DEC, WINDOWS * BEAM, HEADS, HEAD_DIM, CACHE_LEN)
    return g, [torch.randn(shape, device=dev, generator=g, dtype=dtype or torch.bfloat16)
               for _ in range(2)]


def beam_runs_anc(windows: int, beam: int, s_len: int, g):
    """An ancestry map ``[windows, beam, s_len]`` with the runs of a real
    beam: at each position every lane extends a source lane (lane 0 with
    probability 0.6, else one drawn at random) and inherits its history,
    so the lanes share long prefixes, as a beam's hypotheses do."""
    import torch

    dev = g.device
    lanes = torch.arange(beam, device=dev, dtype=torch.int32)
    anc = lanes[None, :, None].repeat(windows, 1, s_len)
    for pos in range(s_len):
        src = torch.randint(0, beam, (windows, beam), device=dev, generator=g)
        src = torch.where(torch.rand((windows, beam), device=dev, generator=g) < 0.6, 0, src)
        anc = torch.gather(anc, 1, src[:, :, None].expand(-1, -1, s_len))
        anc[:, :, pos] = lanes
    return anc.contiguous()


def kernel_e_times(sd, q, k, v, anc, mask, n_vis, reps, cluster=None) -> tuple:
    """(CUDA-event ms, device ms) per kernel E layer launch, walking the
    layers: events over back-to-back calls (at one window the host's
    enqueue of a call outlasts the kernel, so they time the host), the
    kernel's own device time from torch.profiler."""
    L, beam = k.shape[0], anc.shape[1]

    def launch(i=0):
        return sd._self_decode_cuda(q, k, v, anc, mask, i % L, beam, n_vis, cluster)

    event_ms = cuda_ms(launch, reps)
    device_ms = sum(t for name, t in profiled_device_ms(launch, reps).items()
                    if "self_decode_kernel" in name)
    check(device_ms > 0, "torch.profiler saw no self_decode kernel")
    return event_ms, device_ms


def kernel_e_case(sd, at, q, k, v, anc, mask, n_vis, reps) -> dict:
    """Kernel E against its plain version at both ends of the layer stack
    (bound BOUND_E in bf16, BOUND_E_F32 in f32), then its times per layer
    launch (``kernel_e_times``), the plain version's and the bound."""
    import torch

    L, s_len, beam = k.shape[0], k.shape[-1], anc.shape[1]
    atol, rtol = BOUND_E if k.dtype == torch.bfloat16 else BOUND_E_F32
    err = excess = 0.0
    for layer in (0, L - 1):
        got = sd._self_decode_cuda(q, k, v, anc, mask, layer, beam, n_vis).float()
        ref = at.attention_kt_ancestry(q, k[layer], v[layer], anc, mask).float()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "kernel E gave non-finite values")
        diff = (got - ref).abs()
        err = max(err, float(diff.max()))
        excess = max(excess, float((diff - rtol * ref.abs()).max()))
    check(excess <= atol, f"kernel E, {tuple(k.shape)} {k.dtype}: |err| exceeds {atol} +"
          f" {rtol}·|plain| by {excess - atol:.3e}")
    ms, device_ms = kernel_e_times(sd, q, k, v, anc, mask, n_vis, reps)
    plain_ms = cuda_ms(lambda i=0: at.attention_kt_ancestry(q, k[i % L], v[i % L], anc, mask),
                       max(reps // 8, 4))
    bk, h = q.shape[0], q.shape[2]
    bound_ms, bound_by = kernel_e_bound(anc, n_vis, mask.numel() // s_len, H=h,
                                        esize=k.element_size())
    kv_bytes = kernel_e_kv_bytes(anc, n_vis, H=h, esize=k.element_size())
    c = sd._cluster_size(bk // beam, h, n_vis, sd._sms(q.device.index))
    return {"max_abs_err": err, "bound": (atol, rtol), "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "cluster": c, "ctas": c * (bk // beam) * h,
            "kv_share": kv_bytes / (2 * bk * h * HEAD_DIM * n_vis * k.element_size()),
            "gbs": kv_bytes / device_ms / 1e6}


def fmt_e(r: dict) -> str:
    atol, rtol = r["bound"]
    return (f"max|err| {r['max_abs_err']:.3e} (bound {atol:g} + {rtol:g}·|plain|) | kernel"
            f" {r['ms']:.4f} ms/layer (CUDA events over back-to-back calls), {r['device_ms']:.4f}"
            f" ms of device time (torch.profiler; {r['gbs']:.0f} GB/s of the K/V the map names,"
            f" {r['kv_share']:.0%} of every row's visible K/V) (cluster"
            f" {r['cluster']}, {r['ctas']} CTAs), plain {r['plain_ms']:.4f} ms | bound"
            f" {r['bound_ms']:.5f} ms ({r['bound_by']}), kernel at {r['bound_ms'] / r['ms']:.0%} of"
            f" it ({r['bound_ms'] / r['device_ms']:.0%} by device time)")


def phase_kernel_e(seed: int) -> dict:
    """Kernel E at medium.en's beam-5 decode shape, on bf16 and f32 caches
    (the reduced widths' and the default width's), at positions 2, 127
    and 225 with the decode step's shared mask and at 127 with a mask row
    per beam row, each with a random ancestry map and with the runs of a
    real beam; then at position 225 at cluster sizes 1, 2, 4 and 8 beside
    the wrapper's choice. The bound counts the K and V rows the map names
    at each visible position (``kernel_e_kv_bytes``: fewer under a beam's
    runs than under a random map), q, the output, anc and the mask, each
    once."""
    import torch

    from whisper_nemo_tpu_torch.ops import attention as at
    from whisper_nemo_tpu_torch.ops import self_decode as sd

    print(f"  kernel E: {ptxas_summary('self_decode')}")
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        g, (k, v) = _beam_cache(seed + 2, dtype)
        dev, bk = k.device, WINDOWS * BEAM
        q = torch.randn((bk, 1, HEADS, HEAD_DIM), device=dev, generator=g).to(dtype)
        maps = {"random ancestry": torch.randint(0, BEAM, (WINDOWS, BEAM, CACHE_LEN), device=dev,
                                                 generator=g, dtype=torch.int32),
                "a beam's runs": beam_runs_anc(WINDOWS, BEAM, CACHE_LEN, g)}
        for pos, per_row in ((2, False), (127, False), (225, False), (127, True)):
            n_vis = pos + 1
            visible = torch.arange(CACHE_LEN, device=dev) < n_vis
            if per_row:
                keep = torch.rand((bk, CACHE_LEN), device=dev, generator=g) > 0.2
                keep[:, 0] = True
                mask = torch.where(keep & visible, 0.0, float("-inf"))[:, None, None, :].contiguous()
            else:
                mask = torch.where(visible, 0.0, float("-inf"))[None, None, None, :]
            for anc_name, anc in maps.items():
                r = kernel_e_case(sd, at, q, k, v, anc, mask, n_vis, 48)
                case = f"pos {pos}, {'one mask row per beam row' if per_row else 'shared mask'}"
                print(f"[3c kernel E] {name} B·K={bk} H={HEADS} D={HEAD_DIM} S={CACHE_LEN} {case},"
                      f" {anc_name}: {fmt_e(r)}")
                if anc_name == "random ancestry":
                    out[(name, pos, per_row)] = r
        mask = torch.where(torch.arange(CACHE_LEN, device=dev) < 226, 0.0,
                           float("-inf"))[None, None, None, :]
        sweep = {c: kernel_e_times(sd, q, k, v, maps["random ancestry"], mask, 226, 48, c)
                 for c in (1, 2, 4, 8)}
        print(f"[3c kernel E] {name} pos 225, ms/layer by cluster size, CUDA events (device time):"
              f" {fmt_sweep(sweep)}")
        del k, v
        torch.cuda.empty_cache()
    return out


def phase_kernel_f(seed: int) -> dict:
    """Kernel F on the same cache shape: out of place (index_select on
    the row axis timed beside it) and in place within windows, bit for
    bit against the plain versions. The bound reads and writes K and V
    once."""
    import torch

    from whisper_nemo_tpu_torch.ops import beam_permute as bp

    g, (k, v) = _beam_cache(seed + 3)
    dev = k.device
    src = torch.randint(0, BEAM, (WINDOWS, BEAM), device=dev, generator=g)
    src[0] = 0  # repeats
    idx = bp._window_rows(src, BEAM)

    def max_err(got, want):
        return max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))

    got = bp.beam_permute_cache(k, v, idx)
    want = bp._beam_permute_plain(k, v, idx)
    torch.cuda.synchronize()
    err = {"out of place": max_err(got, want)}
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "kernel F out of place differs from the plain version")
    del got
    kk, vv = k.clone(), v.clone()
    bp.beam_permute_cache_inplace(kk, vv, src, BEAM)
    want = bp._beam_permute_inplace_plain(k.clone(), v.clone(), src, BEAM)
    torch.cuda.synchronize()
    err["in place"] = max_err((kk, vv), want)
    check(torch.equal(kk, want[0]) and torch.equal(vv, want[1]),
          "kernel F in place differs from the plain version")
    del want
    moved = 2 * (k.numel() + v.numel()) * k.element_size()
    bound_ms = moved / HBM_BYTES_S * 1e3
    out = {}
    for name, fn, plain, lib in (
        ("out of place", lambda i=0: bp.beam_permute_cache(k, v, idx),
         lambda i=0: bp._beam_permute_plain(k, v, idx),
         lambda i=0: (k.index_select(1, idx), v.index_select(1, idx))),
        ("in place", lambda i=0: bp.beam_permute_cache_inplace(kk, vv, src, BEAM),
         lambda i=0: bp._beam_permute_inplace_plain(kk, vv, src, BEAM), None),
    ):
        ms = cuda_ms(fn, 5)
        plain_ms = cuda_ms(plain, 3)
        lib_ms = cuda_ms(lib, 3) if lib else None
        yard = f", index_select {lib_ms:.3f} ms" if lib else ""
        print(f"[3d kernel F] {name}, K and V {tuple(k.shape)} bf16 ({moved / 2e9:.2f} GB each"
              f" way): bit-equal (max|err| {err[name]:g}, bound {BOUND_F:g}) | kernel {ms:.3f} ms"
              f" ({moved / ms / 1e6:.0f} GB/s), plain {plain_ms:.3f} ms{yard} | bound"
              f" {bound_ms:.3f} ms (bytes), kernel at {bound_ms / ms:.0%} of it")
        out[name] = {"max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes", "library_ms": lib_ms}
    del k, v, kk, vv
    torch.cuda.empty_cache()
    return out


def kernel_b_bound(B: int, T: int, H: int, esize: int, D: int = HEAD_DIM) -> tuple:
    """(least time, what bounds it) of one kernel B launch on inputs of
    ``esize`` bytes an element: 4·B·H·T²·D operations on the bf16 tensor
    cores, three times over at f32 (``esize`` 4: the split bf16 products),
    against q, k and v read once and the output written once."""
    passes = 3 if esize == 4 else 1
    by_ops = passes * 4.0 * B * H * T * T * D / BF16_FLOPS * 1e3
    by_bytes = B * T * H * D * 4 * esize / HBM_BYTES_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def kernel_b_case(at, B: int, T: int, H: int, dtype, g, D: int = HEAD_DIM) -> dict:
    """Kernel B against its plain version on seeded ``[B, T, H, D]``
    inputs of ``dtype``, then its time, the plain version's and SDPA's on
    the same operands as ``[B, H, T, D]`` (the yardstick, in the inputs'
    dtype; it never runs on the port's path). At f32 the plain version
    and SDPA run with TF32 off, as the f32 widths compute, and the f32
    FMA bound (67 TFLOP/s) is returned beside the split bound."""
    import torch
    import torch.nn.functional as F

    from whisper_nemo_tpu_torch.engine.precision import full_f32

    dev = torch.device("cuda")
    q, k, v = (torch.randn((B, T, H, D), device=dev, generator=g).to(dtype) for _ in range(3))
    with full_f32():
        got = at._encoder_attention_cuda(q, k, v)
        ref = at._xla_attention(q, k, v)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()) and got.dtype == dtype,
              "kernel B gave non-finite values")
        err = float((got.float() - ref.float()).abs().max())
        del ref
        reps = max(10, min(200, int(3e4 // B)))
        ms = cuda_ms(lambda i=0: at._encoder_attention_cuda(q, k, v), reps)
        plain_ms = cuda_ms(lambda i=0: at._xla_attention(q, k, v), 3)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib_ms = cuda_ms(lambda i=0: F.scaled_dot_product_attention(qt, kt, vt), reps)
    bound_ms, bound_by = kernel_b_bound(B, T, H, got.element_size(), D)
    r = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": lib_ms, "bound": bound_b(dtype),
         "tflops": 4.0 * B * H * T * T * D / ms / 1e9}
    if dtype == torch.float32:
        r["f32_fma_ms"] = 4.0 * B * H * T * T * D / F32_FLOPS * 1e3
    return r


def fmt_b(r: dict) -> str:
    sdpa = (f", SDPA {r['library_ms']:.4f} ms (kernel/SDPA {r['ms'] / r['library_ms']:.2f}x)"
            if r["library_ms"] is not None else "")
    fma = (f"; the f32 FMA bound {r['f32_fma_ms']:.4f} ms (kernel at"
           f" {r['f32_fma_ms'] / r['ms']:.0%} of it)" if "f32_fma_ms" in r else "")
    return (f"max|err| {r['max_abs_err']:.3e} (bound {r['bound']:g}) | kernel {r['ms']:.4f} ms"
            f" ({r['tflops']:.1f} TFLOP/s), plain {r['plain_ms']:.4f} ms{sdpa} | bound"
            f" {r['bound_ms']:.4f} ms ({r['bound_by']}"
            f"{', three bf16 passes' if 'f32_fma_ms' in r else ''}), kernel at"
            f" {r['bound_ms'] / r['ms']:.0%} of it{fma}")


def phase_kernel_b(seed: int) -> dict:
    """Kernel B at the shapes the paths give it: the Whisper encoder's (bf16
    B=32 and B=1 for the sequential window; f32, the CLI's and the
    facades' default width, at medium.en's B=4 and B=8 with 16 heads and
    large-v2's B=4 with 20, the parallel CLI flow's) and the wav2vec2
    aligner's (bf16 B=8, T=1499; f32 at phase 5b's 2 heads); then at head
    dims 32 and 48 (the 64-column instantiation, columns past D filled
    with zeros) and 80 and 128 (the 128-column one), bf16 B=8 T=1500 H=16,
    and f32 at 128. bf16 within BOUND_B, f32 within BOUND_B_F32; at f32
    the kernel must not be slower than SDPA (TF32 off)."""
    import torch

    from whisper_nemo_tpu_torch.ops import attention as at

    g = torch.Generator(device=torch.device("cuda")).manual_seed(seed + 1)
    print(f"  kernel B design: {KERNEL_B_DESIGN} | {ptxas_summary('encoder_attention')}")
    out = {}
    for name, dtype, B, T, H, D in (("whisper", torch.bfloat16, 32, 1500, HEADS, HEAD_DIM),
                                    ("whisper", torch.float32, 4, 1500, HEADS, HEAD_DIM),
                                    ("whisper", torch.float32, 8, 1500, HEADS, HEAD_DIM),
                                    ("large-v2", torch.float32, 4, 1500, 20, HEAD_DIM),
                                    ("whisper", torch.bfloat16, 1, 1500, HEADS, HEAD_DIM),
                                    ("wav2vec2", torch.bfloat16, 8, 1499, HEADS, HEAD_DIM),
                                    ("wav2vec2", torch.float32, 8, 1499, 2, HEAD_DIM),
                                    ("head dim", torch.bfloat16, 8, 1500, HEADS, 32),
                                    ("head dim", torch.bfloat16, 8, 1500, HEADS, 48),
                                    ("head dim", torch.bfloat16, 8, 1500, HEADS, 80),
                                    ("head dim", torch.bfloat16, 8, 1500, HEADS, 128),
                                    ("head dim", torch.float32, 8, 1500, HEADS, 128)):
        r = kernel_b_case(at, B, T, H, dtype, g, D)
        print(f"[4 kernel B] {name} {str(dtype)[6:]} B={B} T={T} H={H} D={D}: {fmt_b(r)}")
        check(r["max_abs_err"] <= r["bound"], f"kernel B {name} {dtype} B={B} H={H} D={D}:"
              f" max|err| {r['max_abs_err']} > {r['bound']}")
        if dtype == torch.float32:
            check(r["ms"] <= r["library_ms"], f"kernel B {name} f32 B={B} H={H} D={D}:"
                  f" {r['ms']:.4f} ms, slower than SDPA at f32 ({r['library_ms']:.4f} ms)")
        if name != "head dim" and dtype == torch.bfloat16 and B > 1:
            out[name] = r
    torch.cuda.empty_cache()
    return out


def _forced_logits(engine, audio, windows, hyps, prompt, suppress_mask):
    """Filtered f32 logits ``[len(windows), n, V]`` of each window's
    hypothesis ``hyps[i]`` (generated tokens), teacher-forced through the
    port's prefill with the windows' whole batch, over the engine's
    cross-KV (an int8 one's scales are taken over the batch): row ``t``
    predicts generated token ``t``."""
    import torch

    from whisper_nemo_tpu_torch.models.whisper import _vocab_logits
    from whisper_nemo_tpu_torch.models.whisper_stacked import (
        cross_kv_for_decode,
        init_stacked_cache,
        prefill_cache_stacked,
    )
    from whisper_nemo_tpu_torch.ops import mel

    p, dims, dev = engine.params, engine.dims, engine.device
    opts = engine._make_opts()
    waves = torch.zeros((len(windows), mel.N_SAMPLES), device=dev)
    for i, (s, e) in enumerate(windows):
        n = min(e - s, mel.N_SAMPLES)
        waves[i, :n] = torch.from_numpy(audio[s : s + n]).to(dev)
    n = len(prompt) + max(len(h) for h in hyps)
    with torch.inference_mode():
        feats = engine.encode_windows(mel.log_mel_spectrogram_batch(waves, dims.n_mels))
        ckv = cross_kv_for_decode(p, feats.to(engine.dtype), dims, engine.cross_kv_bits)
        tokens = torch.tensor([(prompt + list(h) + [opts.eot] * n)[:n] for h in hyps], device=dev)
        cache = init_stacked_cache(len(windows), dims, engine.dtype, 128, dev)
        x, _ = prefill_cache_stacked(p, tokens, cache, ckv, dims, engine.dtype)
        logits = _vocab_logits(p["decoder"], x[:, len(prompt) - 1 :]) + suppress_mask.to(dev)
        logits[..., opts.timestamp_begin:] = float("-inf")
        logits[..., opts.no_timestamps] = float("-inf")
        logits[:, 0, [opts.blank_token, opts.eot]] = float("-inf")
    return logits


def _step_logits(engine, audio, windows, row, prompt, generated, suppress_mask):
    """Filtered f32 logits of window ``windows[row]`` after ``generated``
    tokens, teacher-forced with the window's whole batch."""
    hyps = [generated] * len(windows)
    return _forced_logits(engine, audio, windows, hyps, prompt, suppress_mask)[row, -1]


def _rescore(engine, audio, windows, hyps, prompt, suppress_mask, max_new):
    """The sum of filtered f32 log-probabilities of each window's
    hypothesis (its generated tokens, then EOT unless it ran to
    ``max_new``), teacher-forced: the score beam search gives it."""
    import torch

    eot = engine._make_opts().eot
    logprobs = torch.log_softmax(
        _forced_logits(engine, audio, windows, hyps, prompt, suppress_mask), dim=-1)
    scores = []
    for row, h in enumerate(hyps):
        target = list(h) + [eot] if len(h) < max_new else list(h)
        idx = torch.arange(len(target), device=logprobs.device)
        scores.append(float(logprobs[row, idx, torch.tensor(target, device=logprobs.device)].sum()))
    return scores


def first_difference(a, b, eot):
    """Index of the first differing token of two EOT-terminated lists, or
    None when they are equal."""
    a, b = list(a) + [eot], list(b) + [eot]
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def phase_slice_parity(seed: int, devices=("cuda", "cpu"), beam_size: int = 1,
                       compute_type: str = "int8") -> None:
    """The batched pipeline at small dims (head dim 64) at
    ``compute_type`` on the first device (the kernels) against the second
    (the plain versions): greedy at the first differing token, beam 5 by
    the second device's teacher-forced rescoring. On a CUDA device the
    kernels' launches are counted: kernel A runs over the int8 cross-KV
    only, never at the f32 widths' float one; kernel E runs at beam 5;
    kernel C once per encoder batch (the batched mel)."""
    import torch

    from whisper_nemo_tpu_torch.engine.decode import build_suppress_mask
    from whisper_nemo_tpu_torch.engine.transcribe import WhisperEngine
    from whisper_nemo_tpu_torch.models.whisper import WhisperDims, init_whisper_params
    from whisper_nemo_tpu_torch.ops import cross_decode as cd
    from whisper_nemo_tpu_torch.ops import mel
    from whisper_nemo_tpu_torch.ops import self_decode as sd
    from whisper_nemo_tpu_torch.text.tokenizer import WhisperTokenizer, get_suppressed_tokens

    dims = WhisperDims(80, 1500, 128, 2, 2, 51864, 64, 128, 2, 2)  # head dim 64
    params = init_whisper_params(dims, "cpu", torch.Generator().manual_seed(seed))
    tok = WhisperTokenizer.byte_fallback(multilingual=False)
    audio = speechlike(70.0, seed)
    runs = []
    counters = (cd.cross_attention_decode_layered, sd.self_attention_decode_ancestry_layered,
                mel.log_mel_raw)
    launches = "no CUDA device in this run"
    for dev in devices:
        eng = WhisperEngine("tiny.en", compute_type, device=dev, params=params, dims=dims,
                            tokenizer=tok)
        for fn in counters:
            fn.launches = 0
        segs, _ = eng.transcribe_batched(audio, language="en", batch_size=2, beam_size=beam_size)
        runs.append((eng, segs))
        if dev != "cpu":
            a, e, c = (fn.launches for fn in counters)
            batches = len(eng.last_decode_steps)
            steps = sum(eng.last_decode_steps) * dims.n_text_layer
            check(a == (0 if compute_type in ("default", "float32") else steps),
                  f"slice parity at {compute_type}: kernel A launched {a} times for {steps} layer"
                  " steps")
            check(e == (steps if beam_size > 1 else 0), f"slice parity at {compute_type} beam"
                  f" {beam_size}: kernel E launched {e} times for {steps} layer steps")
            check(c == batches, f"slice parity at {compute_type}: kernel C launched {c} times for"
                  f" {batches} encoder batches")
            launches = (f"launches on {dev}: A {a}, E {e} ({steps} layer steps), C {c} ({batches}"
                        " batches)")
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
    if beam_size > 1:
        # each GPU hypothesis rescored by the CPU, teacher-forced, in its batch
        max_new = min(224, dims.n_text_ctx - len(prompt))
        rescored = []
        for start in range(0, len(gsegs), 2):
            batch = windows[start : start + 2]
            hyps = [s.tokens for s in gsegs[start : start + 2]]
            pad = 2 - len(batch)
            rescored += _rescore(cpu, audio, batch + [(0, 0)] * pad, hyps + [[]] * pad, prompt,
                                 mask, max_new)[: len(batch)]
    equal = ties = 0
    score_err = tie_gap = 0.0
    for idx, (gs, cs) in enumerate(zip(gsegs, csegs)):
        j = first_difference(gs.tokens, cs.tokens, tok.eot)
        if beam_size > 1:
            # beam rule (tests/test_torch_beam.py's): the GPU scores its
            # hypothesis as the CPU does, and the CPU ranks it within
            # TIE_TOL of its own best
            r = rescored[idx] / (len(gs.tokens) + 1)
            score_err = max(score_err, abs(gs.avg_logprob - r))
            tie_gap = max(tie_gap, cs.avg_logprob - r)
            print(f"  window {idx} ({gs.start:.2f} s): first differing token {j}; mean"
                  f" log-probability per token GPU {gs.avg_logprob:.6f}, CPU's rescoring of the"
                  f" GPU hypothesis {r:.6f}, CPU's best {cs.avg_logprob:.6f}")
            check(abs(gs.avg_logprob - r) < SCORE_TOL, f"slice parity: the GPU scores its beam"
                  f" hypothesis of window {gs.start}s {gs.avg_logprob - r:+.2e} from the CPU's"
                  f" rescoring, beyond {SCORE_TOL}")
            check(r > cs.avg_logprob - TIE_TOL, f"slice parity: the CPU ranks the GPU's beam"
                  f" hypothesis of window {gs.start}s {cs.avg_logprob - r:.4f} below its best,"
                  f" beyond {TIE_TOL}")
        if j is None:
            check(gs.text == cs.text, f"slice parity: window at {gs.start}s: text differs")
            equal += 1
            continue
        ties += 1
        if beam_size > 1:
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
    rule = (f"GPU score vs CPU rescoring max {score_err:.2e} < {SCORE_TOL:g}, CPU best minus"
            f" rescoring max {tie_gap:.4f}" if beam_size > 1 else "CPU logit gap and top-2 margin")
    print(f"[5 slice parity] {compute_type} beam {beam_size}: {len(gsegs)} windows in"
          f" {len(gpu.last_decode_steps)} batches (decode steps {gpu.last_decode_steps}):"
          f" {equal} token-equal, {ties} differ at a tie ({rule} < {TIE_TOL}); GPU vs CPU"
          f" logits of window 0 after 8 tokens: max|err| {logit_err:.4f} (bound {TIE_TOL})"
          f" | {launches}")


def _rescore_window(engine, feats, prompt, valid, hyp, suppress_mask, language):
    """The sum of filtered f32 log-probabilities of one window's
    hypothesis ``hyp`` (its generated tokens, then EOT unless it ran to
    the limit) after its (left-padded) prompt, teacher-forced in one
    prefill with each step's timestamp rules: the score beam search gives
    it."""
    import torch

    from whisper_nemo_tpu_torch.engine.decode import _filter_logits, _static_filter
    from whisper_nemo_tpu_torch.models.whisper import _vocab_logits
    from whisper_nemo_tpu_torch.models.whisper_stacked import (
        cross_kv_for_decode,
        init_stacked_cache,
        prefill_cache_stacked,
    )

    p, dims, dev = engine.params, engine.dims, feats.device
    n_prompt = len(prompt)
    opts = engine._make_opts(without_timestamps=False,
                             max_new_tokens=min(224, dims.n_text_ctx - n_prompt))
    target = list(hyp) + ([opts.eot] if len(hyp) < opts.max_new_tokens else [])
    tokens = torch.tensor([list(prompt) + target], device=dev)
    n = tokens.shape[1]
    cache_len = min(dims.n_text_ctx, -(-n // 128) * 128)
    kv_valid = torch.ones((1, cache_len), dtype=torch.bool, device=dev)
    kv_valid[0, :n_prompt] = torch.from_numpy(np.asarray(valid, bool)).to(dev)
    with torch.inference_mode():
        ckv = cross_kv_for_decode(p, feats.to(engine.dtype), dims, engine.cross_kv_bits)
        cache = init_stacked_cache(1, dims, engine.dtype, cache_len, dev)
        x, _ = prefill_cache_stacked(p, tokens, cache, ckv, dims, engine.dtype, kv_valid=kv_valid,
                                     pos_offset=(~kv_valid[:, :n_prompt]).sum(dim=1))
        logits = _vocab_logits(p["decoder"], x[0, n_prompt - 1 : n - 1])
        static = _static_filter(suppress_mask, opts, dev)
        total = 0.0
        for t, tok in enumerate(target):
            filt = _filter_logits(logits[t : t + 1], static, tokens, n_prompt + t, n_prompt, opts)
            total += float(torch.log_softmax(filt, dim=-1)[0, tok])
    return total


def phase_sequential_parity(seed: int, devices=("cuda", "cpu")) -> None:
    """The sequential facade at small multilingual dims (head dim 64,
    medium.en's n_text_ctx of 448, so the conditioning block is full and
    the beam cache holds 384 positions) on the first device, language
    detected, VAD, beam 5, temperature 0: then on the second device the
    detection on the same audio, and each window decoded again at the
    first device's seek with its conditioning tail. Tokens equal, or the
    beam rule of phase 5: the first device's mean log-probability per
    token within SCORE_TOL of the second's teacher-forced rescoring, and
    the second's best within TIE_TOL of it."""
    import torch

    from whisper_nemo_tpu_torch.asr import WhisperModel
    from whisper_nemo_tpu_torch.engine.transcribe import WhisperEngine, _window_at
    from whisper_nemo_tpu_torch.models.whisper import WhisperDims, init_whisper_params
    from whisper_nemo_tpu_torch.ops import mel
    from whisper_nemo_tpu_torch.text.tokenizer import WhisperTokenizer
    from whisper_nemo_tpu_torch.vad.energy import get_speech_timestamps

    dims = WhisperDims(80, 1500, 128, 2, 2, 51865, 448, 128, 2, 2)
    params = init_whisper_params(dims, "cpu", torch.Generator().manual_seed(seed))
    tok = WhisperTokenizer.byte_fallback(multilingual=True)
    audio = speechlike(40.0, seed + 4)
    model = WhisperModel("tiny", device=devices[0], compute_type="int8", params=params, dims=dims,
                         tokenizer=tok)
    cpu = WhisperEngine("tiny", "int8", device=devices[1], params=params, dims=dims, tokenizer=tok)
    mel.log_mel_raw.launches = 0
    segs, info = model.transcribe(audio, None, vad_filter=True, temperature=(0.0,))
    segs = list(segs)
    windows = model.engine.last_windows
    launches_c = mel.log_mel_raw.launches
    check(len(windows) >= 2 and windows[1]["previous"] is not None,
          "sequential parity: expected two or more windows, the second conditioned")
    if devices[0] != "cpu":
        check(launches_c == len(windows) + 1, f"sequential parity: kernel C launched {launches_c}"
              f" times, expected {len(windows)} windows + 1 language detection")
    spans = get_speech_timestamps(audio, device=devices[1])
    wave = torch.from_numpy(np.concatenate([audio[s["start"] : s["end"]] for s in spans]))
    lang, prob, ranked = cpu.detect_language(wave, return_all=True)
    probs = dict(ranked)
    lang_err = max(abs(p - probs[c]) for c, p in info.all_language_probs)
    top2 = sorted(probs.values())[-2:]
    check(lang_err < 1e-3 and (info.language == lang or top2[1] - top2[0] < 1e-3),
          f"sequential parity: language {info.language} vs {lang}, probabilities {lang_err}")
    mask = cpu._suppress_mask((-1,))
    equal = ties = 0
    score_err = tie_gap = 0.0
    for rec in windows:
        with torch.inference_mode():
            feats = cpu.encode_windows(mel.log_mel_spectrogram(
                _window_at(wave, rec["seek"] * mel.HOP_LENGTH), dims.n_mels)[None])
        toks, lengths, sum_lp, _, n_prompt, _ = cpu._decode_batch(
            feats, info.language, mask, False, 0.0, rng_seed=rec["seek"],
            previous_tokens=rec["previous"], beam_size=BEAM)
        c_toks = toks[0, n_prompt : n_prompt + int(lengths[0])].tolist()
        c_avg = float(sum_lp[0]) / (int(lengths[0]) + 1)
        g_avg = rec["avg_logprob"]
        # a step with every token masked gives a NaN score: a fault
        check(math.isfinite(g_avg) and math.isfinite(c_avg), f"sequential parity: window at seek"
              f" {rec['seek']} scores {g_avg} on the first device, {c_avg} on the second")
        if first_difference(rec["tokens"], c_toks, tok.eot) is None:
            equal += 1
            continue
        ties += 1
        prompt, valid = cpu._prompt(info.language, False, rec["previous"])
        r = _rescore_window(cpu, feats, prompt.tolist(),
                            [True] * n_prompt if valid is None else valid.tolist(),
                            rec["tokens"], mask, info.language) / (len(rec["tokens"]) + 1)
        score_err = max(score_err, abs(g_avg - r))
        tie_gap = max(tie_gap, c_avg - r)
        print(f"  window at seek {rec['seek']}: first device {g_avg:.6f}, second's rescoring"
              f" {r:.6f}, second's best {c_avg:.6f}")
        check(abs(g_avg - r) < SCORE_TOL, f"sequential parity: seek {rec['seek']}: score"
              f" {g_avg - r:+.2e} from the rescoring, beyond {SCORE_TOL}")
        check(r > c_avg - TIE_TOL, f"sequential parity: seek {rec['seek']}: the second device's"
              f" best leads by {c_avg - r:.4f}, beyond {TIE_TOL}")
    print(f"[5c sequential parity] {devices[0]} vs {devices[1]}: language {info.language}"
          f" ({info.language_probability:.5f}; probabilities max|err| {lang_err:.2e}, bound 1e-3)"
          f" | windows {[(w['seek'], w['frames'], w['steps']) for w in windows]} (seek, frames"
          f" consumed, decode steps) | {equal} token-equal, {ties} at a tie (score vs rescoring max"
          f" {score_err:.2e} < {SCORE_TOL:g}, best minus rescoring max {tie_gap:.4f} < {TIE_TOL})"
          f" | kernel C launches {launches_c}"
          f" ({len(windows)} windows + 1 detection) | {len(segs)} segments")


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
    from whisper_nemo_tpu_torch.ops import beam_permute as bp
    from whisper_nemo_tpu_torch.ops import cross_decode as cd
    from whisper_nemo_tpu_torch.ops import ctc, mel
    from whisper_nemo_tpu_torch.ops import self_decode as sd

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

    # kernel F is on no path: its counters are read to show it stays off
    counters = (cd.cross_attention_decode_layered, at.encoder_attention,
                sd.self_attention_decode_ancestry_layered, ctc.viterbi_batch, mel.log_mel_raw,
                bp.beam_permute_cache, bp.beam_permute_cache_inplace)

    def zero_counts():
        for fn in counters:
            fn.launches = 0

    def run_asr(n_requests, **kw):
        runs = []
        for _ in range(n_requests):
            torch.cuda.synchronize()
            t1 = time.time()
            segments, info = pipeline.transcribe(audio, language="en", batch_size=32, **kw)
            segments = list(segments)
            torch.cuda.synchronize()
            runs.append((time.time() - t1, segments, info, list(eng.last_decode_steps)))
        return runs, [fn.launches for fn in counters]

    def check_asr(runs, a, b, c, what):
        steps = [s for r in runs for s in r[3]]
        batches = sum(len(r[3]) for r in runs)
        check(a > 0 and b > 0 and c > 0, f"{what}: a kernel of the main path never launched")
        check(c == batches,
              f"{what}: kernel C launched {c} times, expected one a batch ({batches} batches)")
        check(a == sum(steps) * L_dec,
              f"{what}: kernel A launched {a} times, expected {sum(steps)} steps x {L_dec} layers")
        check(b == batches * L_enc,
              f"{what}: kernel B launched {b} times, expected {batches} batches x {L_enc} layers")
        for wall, segs, info, st in runs:
            check(len(segs) >= 33, f"{what}: expected >= 33 windows (a full and a partial batch),"
                  f" got {len(segs)}")
            check(len(st) == -(-len(segs) // 32), f"{what}: one decode per batch of 32 windows")
            for s in segs:
                check(np.isfinite(s.avg_logprob) and 0.0 <= s.no_speech_prob <= 1.0,
                      f"{what}, segment {s.id}: non-finite log-prob or no-speech prob out of range")
                check(0.0 <= s.start < s.end <= info.duration + 1e-6,
                      f"{what}, segment {s.id}: bad span")
                check(len(s.tokens) <= 224, f"{what}, segment {s.id}: {len(s.tokens)} tokens")
        check(all([s.tokens for s in r[1]] == [s.tokens for s in runs[0][1]] for r in runs),
              f"{what}: the requests gave different tokens")
        return steps, batches

    # the CLI's call: the facade's default beam 5, warm and timed
    zero_counts()
    beam_runs, (a_beam, b_beam, e_beam, d_beam, c_beam, *f_beam) = run_asr(2)
    beam_steps, beam_batches = check_asr(beam_runs, a_beam, b_beam, c_beam, "beam 5")
    check(e_beam == sum(beam_steps) * L_dec and e_beam == a_beam,
          f"beam 5: kernel E launched {e_beam} times, expected {sum(beam_steps)} steps x {L_dec}"
          f" layers, as kernel A ({a_beam})")
    check(d_beam == 0, "beam 5: kernel D launched during ASR")
    # bench.py's call: greedy, one timed request
    zero_counts()
    greedy_runs, (a_greedy, b_greedy, e_greedy, _, c_greedy, *f_greedy) = run_asr(1, beam_size=1)
    greedy_steps, greedy_batches = check_asr(greedy_runs, a_greedy, b_greedy, c_greedy, "greedy")
    check(e_greedy == 0, f"greedy: kernel E launched {e_greedy} times")
    # stage 5 of the flow: the ASR segments' words aligned (here on the
    # synthetic transcript); the warm request records stage times
    zero_counts()
    stats = {}
    aligned = []
    for req in range(2):
        torch.cuda.synchronize()
        t1 = time.time()
        words = align_segments(aligner, align_tok, audio, timed_segments, language="eng",
                               batch_size=8, device="cuda", stats=None if req else stats)
        torch.cuda.synchronize()
        aligned.append((time.time() - t1, words))
    launches_b_align = at.encoder_attention.launches
    launches_d = ctc.viterbi_batch.launches
    check(mel.log_mel_raw.launches == 0,
          f"alignment launched kernel C {mel.log_mel_raw.launches} times")
    f_align = [bp.beam_permute_cache.launches, bp.beam_permute_cache_inplace.launches]
    launches_f = [x + y + z for x, y, z in zip(f_beam, f_greedy, f_align)]
    check(launches_f == [0, 0], f"kernel F launched {launches_f} times (out of place, in place)"
          " on the main path, which has no caller of it")

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
    wall, segs, info, st = beam_runs[1]
    print(
        f"[6 main path] medium.en int8 b32 beam 5 (the facade's default): setup {setup_s:.1f} s"
        f" | audio {info.duration:.0f} s, after VAD {info.duration_after_vad:.1f} s | windows"
        f" {len(segs)}, decode steps per batch {st} | launches A {a_beam} and E {e_beam} (each"
        f" = {sum(beam_steps)} steps x {L_dec}), B {b_beam} (= {beam_batches} batches x"
        f" {L_enc}), C {c_beam} (one a batch) over both requests | warm request"
        f" {beam_runs[0][0]:.2f} s, timed request {wall:.2f} s"
        f" ({wall / info.duration * 3600:.1f} s per audio hour,"
        f" {wall * 1e3 / sum(st):.2f} ms per decode step, whole request)"
    )
    wall, segs, info, st = greedy_runs[0]
    print(
        f"[6 main path] medium.en int8 b32 greedy (beam_size=1): windows {len(segs)}, decode"
        f" steps per batch {st} | launches A {a_greedy} (= {sum(greedy_steps)} steps x {L_dec}),"
        f" B {b_greedy} (= {greedy_batches} batches x {L_enc}), C {c_greedy}, E 0 | timed"
        f" request {wall:.2f} s ({wall / info.duration * 3600:.1f} s per audio hour,"
        f" {wall * 1e3 / sum(st):.2f} ms per decode step, whole request)"
    )
    align_wall = aligned[1][0]
    print(
        f"[6 main path] alignment, wav2vec2 {aligner.dims.num_layers} layers width"
        f" {aligner.dims.hidden_size} bf16, batch 8: setup {align_setup_s:.1f} s |"
        f" {len(timed_segments)} segments, {n_words} words aligned | groups (t_b, l_b): rows"
        f" per launch {groups} | launches B {launches_b_align} (= 2 x {emission_batches}"
        f" batches x {aligner.dims.num_layers}), D {launches_d} (= 2 x {dispatched} groups), C 0"
        f" | warm request {aligned[0][0]:.2f} s (emissions {stats['emissions_s']:.3f} s,"
        f" items {stats['items_s']:.3f} s, Viterbi {stats['viterbi_s']:.3f} s, post"
        f" {stats['post_s']:.3f} s, stages synchronised), timed request {align_wall:.2f} s"
        f" ({align_wall / audio_seconds * 3600:.1f} s per audio hour)"
    )
    print(f"[6 main path] kernel F launches over the three runs: out of place {launches_f[0]},"
          f" in place {launches_f[1]} (no path calls it)")
    return {"launches_a": a_greedy, "launches_a_beam": a_beam, "launches_f": launches_f,
            "launches_c": c_greedy,
            "launches_b": b_beam + b_greedy + launches_b_align, "launches_d": launches_d,
            "launches_e": e_beam, "engine": eng, "model": model, "audio": audio,
            "aligner": aligner, "align_tok": align_tok, "segments": timed_segments}


def phase_widths_parity(seed: int, devices=("cuda", "cpu")) -> None:
    """Phase 5's GPU-against-CPU rules at the JAX package's other widths:
    "default" (f32, float cross-KV: the CLI's --device auto and the
    facades' default) greedy and at beam 5, and "float16" (the CLI's
    --device cuda: bf16 weights, int8 cross-KV) greedy."""
    phase_slice_parity(seed, devices, beam_size=1, compute_type="default")
    phase_slice_parity(seed, devices, beam_size=BEAM, compute_type="default")
    phase_slice_parity(seed, devices, beam_size=1, compute_type="float16")


def phase_default_main(seed: int) -> dict:
    """The main path at the CLI's default width (--device auto runs
    "default"): WhisperModel("medium.en", compute_type="default") at f32
    with the float cross-KV, and BatchedInferencePipeline.transcribe(
    batch_size=32) at its default beam 5, one request of 10 minutes of
    speech-like audio (one batch of windows). Kernel E runs on the f32
    cache (24 launches per beam step), kernel A never (the float
    cross-KV), kernel B 24 per batch, kernel C one. Then the f32 beam
    step alone at B·K=160 (CUDA events; torch.profiler's device time)."""
    import torch

    from whisper_nemo_tpu_torch.asr import BatchedInferencePipeline, WhisperModel
    from whisper_nemo_tpu_torch.models.whisper_stacked import (
        cross_kv_float,
        decode_step_stacked,
        init_stacked_cache,
    )
    from whisper_nemo_tpu_torch.ops import attention as at
    from whisper_nemo_tpu_torch.ops import cross_decode as cd
    from whisper_nemo_tpu_torch.ops import mel
    from whisper_nemo_tpu_torch.ops import self_decode as sd

    t0 = time.time()
    model = WhisperModel("medium.en", device="cuda", compute_type="default", seed=seed)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    eng = model.engine
    check(eng.dtype == torch.float32 and eng.cross_kv_bits is None,
          "medium.en at \"default\" is not f32 with the float cross-KV")
    L_dec, L_enc = eng.dims.n_text_layer, eng.dims.n_audio_layer
    audio = speechlike(600.0, seed + 8)
    counters = (cd.cross_attention_decode_layered, at.encoder_attention,
                sd.self_attention_decode_ancestry_layered, mel.log_mel_raw)
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t1 = time.time()
    segs, info = BatchedInferencePipeline(model).transcribe(audio, language="en", batch_size=32)
    segs = list(segs)
    torch.cuda.synchronize()
    wall = time.time() - t1
    a, b, e, c = (fn.launches for fn in counters)
    steps = list(eng.last_decode_steps)
    check(len(steps) == 1, f"default width: expected one batch of windows, got {len(steps)}")
    check(c == 1, f"default width: kernel C launched {c} times for one batch")
    check(e > 0 and e == sum(steps) * L_dec, f"default width: kernel E launched {e} times,"
          f" expected {sum(steps)} steps x {L_dec} layers")
    check(a == 0, f"default width: kernel A launched {a} times over the float cross-KV")
    check(b == len(steps) * L_enc, f"default width: kernel B launched {b} times, expected"
          f" {len(steps)} batches x {L_enc} layers")
    for sg in segs:
        check(np.isfinite(sg.avg_logprob) and 0.0 <= sg.no_speech_prob <= 1.0
              and 0.0 <= sg.start < sg.end <= info.duration + 1e-6 and len(sg.tokens) <= 224,
              f"default width, segment {sg.id}: out of range")
    print(f"[6d default width] medium.en \"default\" (f32, float cross-KV) b32 beam 5: setup"
          f" {setup_s:.1f} s | audio {info.duration:.0f} s, after VAD"
          f" {info.duration_after_vad:.1f} s | windows {len(segs)}, decode steps {steps} |"
          f" launches E {e} (= {sum(steps)} steps x {L_dec}, f32 cache), A {a}, B {b}, C {c} |"
          f" request {wall:.2f} s ({wall / info.duration * 3600:.1f} s per audio hour,"
          f" {wall * 1e3 / sum(steps):.2f} ms per decode step, whole request)")

    # the f32 beam step at B·K = 160 rows over the window-shared float cross-KV
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    bk = WINDOWS * BEAM
    with torch.inference_mode():
        feats = torch.randn((WINDOWS, 1500, eng.dims.n_text_state), device=dev, generator=g)
        ckv = cross_kv_float(eng.params, feats, eng.dims)
        cache = init_stacked_cache(bk, eng.dims, torch.float32, CACHE_LEN, dev)
        anc = torch.randint(0, BEAM, (WINDOWS, BEAM, CACHE_LEN), device=dev, generator=g,
                            dtype=torch.int32)
        tok = torch.full((bk,), 220, device=dev)

        def beam_step(i=0):
            return decode_step_stacked(eng.params, tok, 2 + i % 200, cache, ckv, eng.dims,
                                       torch.float32, return_hidden=True, anc=anc)

        step_ms = cuda_ms(beam_step, 20)
        prof = profiled_device_ms(lambda i=0: beam_step(100 + i), 5)
    print(f"[6d default width] f32 beam step, B·K={bk} medium.en, cache {CACHE_LEN}: decode step"
          f" {step_ms:.3f} ms (CUDA events, positions 2-21) | torch.profiler at positions"
          f" 100-104: {fmt_profile(prof)}")
    del model, ckv, cache
    torch.cuda.empty_cache()
    return {"launches_e": e, "wall": wall}


def phase_sequential_main(main: dict, seed: int) -> dict:
    """The CLI's --batch-size 0 call on medium.en int8 (the main path's
    model): beam 5, the default ladder, timestamps, VAD (conditioning is
    on, but a single seek window has no earlier text to condition on;
    phase 5c decodes the conditioned windows). One warm request of one window on the ladder's first two temperatures (the
    beam decode and the sampled one), one timed request of 25 s (one seek
    window); then the serving handler's call through the openai facade
    (load_model, int8,
    temperature 0, no conditioning, greedy) on the same audio. Each run's
    kernel launches are checked against its windows and decode steps: C
    one per seek window (medium.en is English-only: no detection runs the
    model), B 24 per window, A 24 per decode step, E 24 per beam step."""
    import torch

    from whisper_nemo_tpu_torch.asr import load_model
    from whisper_nemo_tpu_torch.ops import attention as at
    from whisper_nemo_tpu_torch.ops import cross_decode as cd
    from whisper_nemo_tpu_torch.ops import mel
    from whisper_nemo_tpu_torch.ops import self_decode as sd

    model, eng = main["model"], main["engine"]
    L_dec, L_enc = eng.dims.n_text_layer, eng.dims.n_audio_layer
    counters = (mel.log_mel_raw, at.encoder_attention, cd.cross_attention_decode_layered,
                sd.self_attention_decode_ancestry_layered)

    def run(what, call, engine, audio, beam: bool):
        for fn in counters:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        segments = call(audio)
        torch.cuda.synchronize()
        wall = time.time() - t0
        c, b, a, e = (fn.launches for fn in counters)
        windows = [dict(w) for w in engine.last_windows]
        beam_steps = sum(w["steps"][0] for w in windows if beam and w["temperatures"][0] == 0.0)
        steps = sum(sum(w["steps"]) for w in windows)
        check(c > 0 and b > 0 and a > 0, f"{what}: a kernel of the path never launched")
        check(all(math.isfinite(w["avg_logprob"]) for w in windows), f"{what}: a window scored"
              f" {[w['avg_logprob'] for w in windows]}: a step with every token masked")
        check(c == len(windows), f"{what}: kernel C launched {c} times for {len(windows)} windows")
        check(b == L_enc * len(windows), f"{what}: kernel B launched {b} times, expected"
              f" {len(windows)} windows x {L_enc}")
        check(a == L_dec * steps, f"{what}: kernel A launched {a} times, expected {steps} steps x"
              f" {L_dec}")
        check(e == L_dec * beam_steps, f"{what}: kernel E launched {e} times, expected"
              f" {beam_steps} beam steps x {L_dec}")
        for seg in segments:
            check(np.isfinite(seg["start"]) and 0.0 <= seg["start"] <= seg["end"]
                  and 0.0 <= seg["no_speech_prob"] <= 1.0, f"{what}: a segment out of range: {seg}")
        per_window = "; ".join(
            f"seek {w['seek']} +{w['frames']} frames, T {w['temperatures']} steps {w['steps']},"
            f" kept {w['avg_logprob']:.3f} a token"
            for w in windows)
        print(f"[6c sequential] {what}: {len(windows)} windows ({per_window}) | decode steps"
              f" {steps} ({beam_steps} beam) | launches C {c}, B {b}, A {a}, E {e} | wall"
              f" {wall:.2f} s ({wall / (len(audio) / SR) * 3600:.0f} s per audio hour,"
              f" {wall * 1e3 / steps:.2f} ms per decode step, whole request) | {len(segments)}"
              " segments")
        return {"wall": wall, "windows": windows, "steps": steps, "beam_steps": beam_steps,
                "launches": (c, b, a, e), "audio_s": len(audio) / SR}

    def cli(audio, **kw):
        segments, info = model.transcribe(audio, None, suppress_tokens=[-1], vad_filter=True,
                                          **kw)
        check(info.language == "en", f"6c: language {info.language}")
        return [{"start": s.start, "end": s.end, "no_speech_prob": s.no_speech_prob}
                for s in segments]

    audio = speechlike(25.0, seed + 8)
    run("warm request, 25 s, temperatures 0 and 0.2",
        lambda a: cli(a, temperature=(0.0, 0.2)), eng, speechlike(25.0, seed + 9), True)
    timed = run("timed request, 25 s (the CLI's --batch-size 0 call)", cli, eng, audio, True)
    t0 = time.time()
    handler_model = load_model("medium.en", "cuda", compute_type="int8", seed=seed)
    torch.cuda.synchronize()
    print(f"[6c sequential] openai facade: load_model('medium.en', 'cuda', compute_type='int8')"
          f" {time.time() - t0:.1f} s")

    def handler(audio):
        out = handler_model.transcribe(audio, language="en", temperature=0.0, fp16=True,
                                       condition_on_previous_text=False, no_speech_threshold=0.6,
                                       logprob_threshold=-1.0, compression_ratio_threshold=2.4)
        check(set(out) == {"text", "segments", "language", "duration"}, "6c: openai dict keys")
        return out["segments"]

    handler_run = run("openai facade, the serving handler's call, 25 s", handler,
                      handler_model.engine, audio, False)
    handler_model.engine.unload()
    return {"timed": timed, "handler": handler_run}


def phase_sequential_stage_times(main: dict, seq: dict, c: dict) -> None:
    """The sequential request's stages apart, after 6c (these launches are
    not counted): kernel C per window (phase 3e), the encoder at B=1, the
    beam step at B·K=5 over a 384-position cache with the conditioning
    mask, the greedy step at B=1, the step's logit filter with the
    timestamp rules (CUDA events, and the host's enqueue time); the host's
    share of a window is what the timed request's wall time leaves."""
    import torch

    from whisper_nemo_tpu_torch.engine.decode import _filter_logits, _sample, _static_filter
    from whisper_nemo_tpu_torch.engine.transcribe import _window_at
    from whisper_nemo_tpu_torch.models.whisper_stacked import (
        cross_kv_decode_layout_fused,
        decode_step_stacked,
        init_stacked_cache,
    )
    from whisper_nemo_tpu_torch.ops import mel

    eng, dev = main["engine"], torch.device("cuda")
    wave = torch.from_numpy(speechlike(30.0, 3)).to(dev)
    with torch.inference_mode():
        m = mel.log_mel_spectrogram(_window_at(wave, 0), eng.dims.n_mels)[None]
        enc_ms = cuda_ms(lambda i=0: eng.encode_windows(m), 5)
        feats = eng.encode_windows(m)
        ckv_ms = cuda_ms(lambda i=0: cross_kv_decode_layout_fused(eng.params, feats, eng.dims), 5)
        ckv = cross_kv_decode_layout_fused(eng.params, feats, eng.dims)
        s_len, n_prompt = 384, 66
        valid = torch.ones((BEAM, s_len), dtype=torch.bool, device=dev)
        valid[:, :40] = False
        offset = torch.full((BEAM,), 40, device=dev)
        anc = torch.randint(0, BEAM, (1, BEAM, s_len), device=dev, dtype=torch.int32)

        def timed_step(rows, **kw):
            cache = init_stacked_cache(rows, eng.dims, eng.dtype, s_len, dev)
            tok = torch.full((rows,), 220, device=dev)

            def step(i=0):
                return decode_step_stacked(eng.params, tok, n_prompt + i % 200, cache, ckv, eng.dims,
                                           eng.dtype, return_hidden=True, **kw)

            ms = cuda_ms(step, 30)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(30):
                step(i)
            enqueue = (time.perf_counter() - t0) * 1e3 / 30
            torch.cuda.synchronize()
            device = sum(profiled_device_ms(lambda i=0: step(100 + i), 5).values())
            return ms, enqueue, device

        beam_ms, beam_enq, beam_dev = timed_step(BEAM, anc=anc, kv_valid=valid, pos_offset=offset)
        greedy_ms, greedy_enq, greedy_dev = timed_step(1, kv_valid=valid[:1], pos_offset=offset[:1])
        opts = eng._make_opts(without_timestamps=False, max_new_tokens=224, temperature=0.2)
        static = _static_filter(eng._suppress_mask((-1,)), opts, dev)
        g = torch.Generator(device=dev).manual_seed(0)
        logits = torch.randn((BEAM, eng.dims.n_vocab), device=dev, generator=g)
        tokens = torch.randint(0, 50000, (BEAM, n_prompt + 224), device=dev, generator=g)
        filt_ms = cuda_ms(lambda i=0: _filter_logits(logits, static, tokens, n_prompt + 5 + i % 100,
                                                     n_prompt, opts), 30)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(30):
            _sample(_filter_logits(logits[:1], static, tokens[:1], n_prompt + 5 + i, n_prompt, opts),
                    0.2, g)
        filt_enq = (time.perf_counter() - t0) * 1e3 / 30
        torch.cuda.synchronize()
    t = seq["timed"]
    n_win = len(t["windows"])
    other_steps = t["steps"] - t["beam_steps"]
    n_decodes = sum(len(w["temperatures"]) for w in t["windows"])
    device_s = (n_win * (c[(80, 1)]["ms"] + enc_ms) + n_decodes * ckv_ms
                + t["beam_steps"] * beam_dev + other_steps * greedy_dev) / 1e3
    print(f"[6c stages] per window: mel (kernel C) {c[(80, 1)]['ms']:.4f} ms, encoder at B=1"
          f" {enc_ms:.2f} ms, cross-KV projection {ckv_ms:.2f} ms a decode (CUDA events) | beam"
          f" step (B·K=5, S=384, per-row mask): {beam_ms:.3f} ms a step by CUDA events, host"
          f" enqueue {beam_enq:.3f} ms, device time {beam_dev:.3f} ms (torch.profiler) | greedy"
          f" step (B=1): {greedy_ms:.3f} ms, host enqueue {greedy_enq:.3f} ms, device time"
          f" {greedy_dev:.3f} ms | logit filter with the timestamp rules at B·K=5 {filt_ms:.3f}"
          f" ms; filter and sampling at B=1, host enqueue {filt_enq:.3f} ms | timed request:"
          f" {t['wall']:.2f} s for {n_win} windows, {n_decodes} decodes, {t['beam_steps']} beam and"
          f" {other_steps} sampled steps; an estimate of their device time, these parts measured"
          f" apart times their counts in the request (not a trace of it): {device_s:.2f} s"
          f" ({device_s / t['wall']:.0%} of the wall time)")


def phase_stage_times(main: dict, a: dict, e: dict) -> None:
    """Encoder ms per batch of 32 windows and decode ms per step at b32,
    greedy and beam 5, measured after the main path (these launches are
    not counted); then the beam step's parts: kernels E and A (24 layer
    launches each, from phases 3c and 3), the vocabulary projection and
    the selection (top-K over 5 x 51864 candidates a window, token and
    ancestry gathers)."""
    import torch

    from whisper_nemo_tpu_torch.engine.decode import beam_advance, top_k_lowest_index
    from whisper_nemo_tpu_torch.models.whisper import _vocab_logits
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
        mel_ms = cuda_ms(lambda i=0: mel.log_mel_spectrogram_batch(waves, eng.dims.n_mels), 10)
        mel_plain_ms = cuda_ms(lambda i=0: mel._finalize(
            mel._log_mel_plain(waves, eng.dims.n_mels)).transpose(-1, -2), 10)
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
        greedy_prof = profiled_device_ms(lambda i=0: decode_step_stacked(
            eng.params, tok, 2 + i, cache, ckv, eng.dims, eng.dtype, return_hidden=True), 5)
        print(f"[6b stages] b32 medium.en int8: mel {mel_ms:.4f} ms (kernel C; the plain version"
              f" {mel_plain_ms:.4f} ms), encoder {enc_ms:.2f} ms,"
              f" cross-KV projection+quantization {ckv_ms:.2f} ms, greedy decode step"
              f" {step_ms:.3f} ms (CUDA events); host enqueues a step in {enqueue_ms:.3f} ms,"
              f" device done {done_ms:.3f} ms after the first enqueue, per step |"
              f" torch.profiler: {fmt_profile(greedy_prof)}")
        del cache

        # the beam step at B·K = 160 rows over the window-shared cross-KV
        bk, dev = WINDOWS * BEAM, feats.device
        g = torch.Generator(device=dev).manual_seed(7)
        cache = init_stacked_cache(bk, eng.dims, eng.dtype, CACHE_LEN, dev)
        anc = torch.randint(0, BEAM, (WINDOWS, BEAM, CACHE_LEN), device=dev, generator=g,
                            dtype=torch.int32)
        tok = torch.full((bk,), 220, device=dev)

        def beam_step(i=0):
            return decode_step_stacked(eng.params, tok, 2 + i % 200, cache, ckv, eng.dims,
                                       eng.dtype, return_hidden=True, anc=anc)

        beam_ms = cuda_ms(beam_step, 30)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(30):
            beam_step(i)
        beam_enqueue_ms = (time.perf_counter() - t0) * 1e3 / 30
        torch.cuda.synchronize()
        beam_done_ms = (time.perf_counter() - t0) * 1e3 / 30
        beam_prof = profiled_device_ms(lambda i=0: beam_step(100 + i), 5)
        hid, _ = beam_step()
        vocab_ms = cuda_ms(lambda i=0: _vocab_logits(eng.params["decoder"], hid), 20)
        opts = eng._make_opts()
        filt = torch.randn((bk, eng.dims.n_vocab), device=dev, generator=g)
        scores = torch.zeros((WINDOWS, BEAM), device=dev)
        tokens = torch.zeros((bk, 226), dtype=torch.long, device=dev)
        finished = torch.zeros(bk, dtype=torch.bool, device=dev)
        eot_only = torch.full((eng.dims.n_vocab,), float("-inf"), device=dev)
        eot_only[opts.eot] = 0.0
        select_ms = cuda_ms(lambda i=0: beam_advance(
            filt, scores, tokens, anc, finished, 100, eot_only, opts.eot), 20)
        cand = torch.randn((WINDOWS, BEAM * eng.dims.n_vocab), device=dev, generator=g)
        topk_ms = cuda_ms(lambda i=0: top_k_lowest_index(cand, BEAM), 20)
        lib_topk_ms = cuda_ms(lambda i=0: torch.topk(cand, BEAM, dim=1), 20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            beam_advance(filt, scores, tokens, anc, finished, 100, eot_only, opts.eot)
        select_enqueue_ms = (time.perf_counter() - t0) * 1e3 / 20
        torch.cuda.synchronize()
    e_ms, a_ms = e[("bfloat16", 127, False)]["device_ms"] * L_DEC, a[5]["device_ms"] * L_DEC
    print(f"[6b stages] beam step, B·K={bk} medium.en int8, cache {CACHE_LEN}: decode step"
          f" {beam_ms:.3f} ms (CUDA events, positions 2-201); host enqueues a step in"
          f" {beam_enqueue_ms:.3f} ms, device done {beam_done_ms:.3f} ms after the first"
          f" enqueue, per step | torch.profiler at positions 100-104: {fmt_profile(beam_prof)}"
          f" | of the device time: kernel E {e_ms:.3f} ms (24 x phase 3c's device time at"
          f" pos 127), kernel A {a_ms:.3f} ms (24 x phase 3's device time at beam 5) | per"
          f" selection: vocab projection {vocab_ms:.3f} ms, beam_advance {select_ms:.3f} ms (host enqueue"
          f" {select_enqueue_ms:.3f} ms), of it the tie-ordered top-K {topk_ms:.3f} ms"
          f" (torch.topk alone {lib_topk_ms:.3f} ms)")


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


DIAR_EMB_TOL = 1e-4  # TitaNet embeddings, GPU against CPU (f32, TF32 off)
DIAR_MSDD_TOL = 1e-5  # MSDD mean sigmoids on the same embeddings
DIAR_GAP = 1e-3  # dense eigengap at or below which the k eigenvectors are not determined
DIAR_EIG_TOL = 1e-3  # there, |L·V − V·Λ| and the eigenvalues' difference between devices
DIAR_AUDIOS = 8  # phase 5e's audios


def same_partition(a: np.ndarray, b: np.ndarray) -> bool:
    """Equal labels up to relabeling."""
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def phase_diar_parity(seed: int, devices=("cuda", "cpu")) -> None:
    """5e: the diarizer at small widths (energy VAD, TitaNet small, MSDD)
    on ``devices[0]`` against the same on ``devices[1]``, from one seeded
    param tree saved to a temporary $WNT_MODEL_DIR, at the telephonic
    preset, over DIAR_AUDIOS audios of 60 s of three voices (seeds
    ``seed + 21`` on): speech regions equal; every scale's embeddings
    within DIAR_EMB_TOL; then the two devices' labels on each clustering
    path. Dense: equal where the Laplacian's k-th and (k + 1)-th smallest
    eigenvalues are more than DIAR_GAP apart on both devices. Where they
    are not, the k eigenvectors are any basis of a larger eigenspace,
    which cuSOLVER and LAPACK pick differently: there the neighbour counts
    must be equal and each device's k vectors eigenvectors of its
    Laplacian, with its k + 1 lowest eigenvalues those of the other
    device, within DIAR_EIG_TOL. With random weights about half the audios
    have the gap; at least one must. Long-form (chunks of 100): equal up
    to relabeling on every audio (only its chunks' k-means runs on the
    device; the reclustering of their means is the host's on both).
    Nyström (threshold lowered to 128, 64 anchors): equal up to relabeling
    on at least half the audios. At this size many segments have no
    anchor among their neighbours and the embedding's top eigenvalues lie
    close together, so its k-means moves with rounding whatever the gap
    (a perturbation of the affinity at 1e-6 on the CPU alone moves it at
    times). The shares are printed. On the first audio with the dense
    gap: MSDD's mean sigmoids on the same embeddings within DIAR_MSDD_TOL
    and the turns of diarize_waveform equal."""
    import torch

    from whisper_nemo_tpu_torch.config import create_config
    from whisper_nemo_tpu_torch.diarize import NeuralDiarizer
    from whisper_nemo_tpu_torch.diarize import clustering as cl
    from whisper_nemo_tpu_torch.diarize.pipeline import _TITANET_SMALL
    from whisper_nemo_tpu_torch.diarize.segments import multiscale_segmentation
    from whisper_nemo_tpu_torch.engine.checkpoint import save_params
    from whisper_nemo_tpu_torch.engine.precision import full_f32
    from whisper_nemo_tpu_torch.models import msdd, titanet

    k = 3
    with tempfile.TemporaryDirectory() as tmp, model_dir(tmp), full_f32(), torch.inference_mode():
        g = torch.Generator().manual_seed(seed + 22)
        save_params(os.path.join(tmp, "titanet_large.npz"),
                    titanet.init_titanet_params(_TITANET_SMALL, "cpu", g))
        save_params(os.path.join(tmp, "diar_msdd_telephonic.npz"),
                    msdd.init_msdd_params(msdd.MsddDims(), "cpu", g))
        cfg = create_config(tmp, "telephonic")
        diars = [NeuralDiarizer(cfg, device=dev, seed=seed) for dev in devices]
        for d in diars:
            d.spk_dims = _TITANET_SMALL  # the saved tree's widths
            check(d.msdd_params is not None and d.vad_params is None, "5e: the saved trees")
        emb_cfg = cfg.diarizer.speaker_embeddings.parameters
        weights = np.asarray(emb_cfg.multiscale_weights, np.float64)

        def labels(path, mapped, **clustering):
            """[(labels, stats)] of each device on ``path``."""
            params = cfg.diarizer.clustering.parameters
            saved = {name: getattr(params, name) for name in clustering}
            for name, v in clustering.items():
                setattr(params, name, v)
            try:
                out = []
                for d, embs in zip(diars, mapped):
                    stats = {}
                    out.append((d._cluster_labels([e.to(d.device) for e in embs], k, stats=stats),
                                stats))
                    check(stats["path"] == path, f"5e: took the {stats['path']} path, not {path}")
                return out
            finally:
                for name, v in saved.items():
                    setattr(params, name, v)

        def eigenspace(d, embs, p):
            """(the k + 1 lowest eigenvalues, max|L·V − V·Λ| of the k lowest
            eigenvectors) of the dense path's Laplacian on d's device, by
            the calls of spectral_cluster_device."""
            affinity = cl.multiscale_affinity(torch.stack([e.to(d.device) for e in embs]),
                                              weights / weights.sum())
            binarized = cl._binarize_threshold(affinity, p)
            lap = torch.diag_embed(binarized.sum(dim=1)) - binarized
            evals, evecs = torch.linalg.eigh(lap)
            v = evecs[:, :k]
            return evals[: k + 1].cpu().numpy(), float((lap @ v - v * evals[:k]).abs().max())

        emb_err, eig_err, first = 0.0, 0.0, None
        held = {"dense": 0, "nystrom": 0}
        n_base = []
        for i in range(DIAR_AUDIOS):
            audio = voices(60.0, seed + 21 + i, 3)
            waves = [torch.from_numpy(audio).to(d.device) for d in diars]
            regions = [d._speech_regions(audio, w) for d, w in zip(diars, waves)]
            check(regions[0] == regions[1], f"5e: the speech regions differ (audio {i})")
            scales = multiscale_segmentation(regions[1], emb_cfg.window_length_in_sec,
                                             emb_cfg.shift_length_in_sec)
            n_base.append(len(scales[-1]))
            mapped = [[e.cpu() for e in d._mapped_embeddings(w, scales)]
                      for d, w in zip(diars, waves)]
            emb_err = max(emb_err, *(float((a - b).abs().max()) for a, b in zip(*mapped)))
            check(emb_err <= DIAR_EMB_TOL, f"5e: embeddings differ by {emb_err:.2e} > {DIAR_EMB_TOL}")
            runs = {"dense": labels("dense", mapped)}
            saved_nystrom = cl._NYSTROM_THRESHOLD, cl._NYSTROM_ANCHORS
            cl._NYSTROM_THRESHOLD, cl._NYSTROM_ANCHORS = 128, 64
            try:
                runs["nystrom"] = labels("nystrom", mapped)
            finally:
                cl._NYSTROM_THRESHOLD, cl._NYSTROM_ANCHORS = saved_nystrom
            (a, _), (b, _) = labels("longform", mapped, embeddings_per_chunk=100)
            check(same_partition(a, b), f"5e: partitions differ on the long-form path (audio {i})")
            (a, _), (b, _) = runs["nystrom"]
            held["nystrom"] += same_partition(a, b)
            (a, sa), (b, sb) = runs["dense"]
            if min(sa["eigengap"], sb["eigengap"]) > DIAR_GAP:
                held["dense"] += 1
                check(np.array_equal(a, b), f"5e: labels differ on the dense path (audio {i})")
            else:
                p = sa["p_neighbors"]
                check(p == sb["p_neighbors"], f"5e: neighbour counts differ (audio {i})")
                (ea, ra), (eb, rb) = [eigenspace(d, m, p) for d, m in zip(diars, mapped)]
                eig_err = max(eig_err, ra, rb, float(np.abs(ea - eb).max()))
                check(eig_err <= DIAR_EIG_TOL, f"5e: eigenvectors or eigenvalues off by"
                      f" {eig_err:.2e} > {DIAR_EIG_TOL} (audio {i})")
            if first is None and held["dense"]:
                first = (i, audio, mapped, b)
        check(held["dense"] > 0, f"5e: the dense eigengap was at most {DIAR_GAP} on all"
              f" {DIAR_AUDIOS} audios (choose another --seed)")
        check(2 * held["nystrom"] >= DIAR_AUDIOS, f"5e: Nyström partitions equal on only"
              f" {held['nystrom']} of {DIAR_AUDIOS} audios")
        i, audio, mapped, cpu_labels = first
        seg = torch.stack(mapped[1])
        sig = [msdd.msdd_mean_sigmoids(d.msdd_params, seg.to(d.device), cpu_labels,
                                       emb_cfg.multiscale_weights)[0] for d in diars]
        sig_err = float(np.abs(sig[0] - sig[1]).max())
        check(sig_err <= DIAR_MSDD_TOL, f"5e: MSDD mean sigmoids differ by {sig_err:.2e}")
        turns = [d.diarize_waveform(audio, num_speakers=k) for d in diars]
        check(turns[0] == turns[1] and len({s for _, _, s in turns[0]}) == k,
              "5e: the turns differ between the devices")
    print(f"[5e diarization parity] {devices[0]} against {devices[1]}, TitaNet small + MSDD,"
          f" {DIAR_AUDIOS} audios of 60 s of 3 voices, n_base {n_base} | embeddings max|err|"
          f" {emb_err:.2e} (<= {DIAR_EMB_TOL}) | dense labels equal on the {held['dense']}/"
          f"{DIAR_AUDIOS} with an eigengap > {DIAR_GAP}, elsewhere the eigenvectors' residual and"
          f" the eigenvalues' difference max {eig_err:.2e} (<= {DIAR_EIG_TOL}) | Nyström"
          f" (threshold 128) partitions equal on {held['nystrom']}/{DIAR_AUDIOS} (>= half) |"
          f" on audio {i}: MSDD mean sigmoids max|err| {sig_err:.2e} (<= {DIAR_MSDD_TOL}), turns"
          f" equal ({len(turns[0])})"
          f" | long-form (chunks of 100) partitions equal on {DIAR_AUDIOS}/{DIAR_AUDIOS}")


# -- the CLI flow (phases 5f and 6f) -----------------------------------------

# 5f: the largest shift of a word's start or end between the card's aligner
# (bf16 emissions) and the CPU's (f32) on the same words: two of the
# aligner's 20 ms emission frames. Random weights leave Viterbi near-ties
# that rounding may tip by a frame (0.020 s on the card, NVIDIA H100 80GB
# HBM3 at 700 W); a fault of the card's path moves words by far more.
FLOW_MOVE_TOL = 0.04

SRT_CUE = re.compile(r"(\d+)\n(\d\d):(\d\d):(\d\d),(\d\d\d) --> (\d\d):(\d\d):(\d\d),(\d\d\d)\n"
                     r"Speaker (\d+): (.*)")


def word_vocab(multilingual: bool = False) -> dict:
    """A Whisper ``vocab.json`` whose tokens are words: the 256 byte
    symbols, then for each id up to 50,255 (the ``.en`` models) or 50,256
    (the multilingual ones, whose specials start one id later) a
    letters-only name, every 5th capitalised, every 7th ending in "." and
    every 11th in ",". Random weights decode tokens of every id, which the
    byte-fallback tokenizer turns into almost no text; this vocabulary
    turns them into words to align, punctuate and split into sentences."""
    from whisper_nemo_tpu_torch.text.tokenizer import bytes_to_unicode

    vocab = {c: b for b, c in bytes_to_unicode().items()}
    for i in range(256, 50257 if multilingual else 50256):
        word, v = "", i
        while True:
            v, r = divmod(v, 26)
            word += chr(ord("a") + r)
            if not v:
                break
        word = word.capitalize() if i % 5 == 0 else word
        vocab["Ġ" + word + ("." if i % 7 == 0 else "," if i % 11 == 0 else "")] = i
    return vocab


def write_word_vocab(directory: str, multilingual: bool = False) -> None:
    with open(os.path.join(directory, "vocab.json"), "w") as f:
        json.dump(word_vocab(multilingual), f)
    with open(os.path.join(directory, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")


@contextlib.contextmanager
def patched(obj, name: str, value):
    """``obj.name`` set to ``value`` within the block."""
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def recording(stack: contextlib.ExitStack, obj, name: str, calls: list, sync=None):
    """Wraps ``obj.name`` within ``stack``: each call appends (its
    seconds, its result, its positional arguments) to ``calls``; ``sync``
    (a device synchronise) runs before the clock stops."""
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        t0 = time.time()
        out = fn(*args, **kwargs)
        if sync is not None:
            sync()
        calls.append((time.time() - t0, out, args))
        return out

    stack.enter_context(patched(obj, name, wrapper))


def check_outputs(base: str, duration: float, what: str) -> dict:
    """``<base>.txt`` and ``<base>.srt`` as the writers make them: UTF-8
    with a BOM, cues numbered 1..n, ``HH:MM:SS,mmm --> HH:MM:SS,mmm``,
    start <= end <= the audio's length, one ``Speaker k: text`` line a
    cue; the text file holds the same speakers. Returns the counts."""
    raw = {ext: open(f"{base}.{ext}", "rb").read() for ext in ("txt", "srt")}
    check(all(b.startswith(b"\xef\xbb\xbf") for b in raw.values()), f"{what}: no UTF-8 BOM")
    blocks = raw["srt"].decode("utf-8-sig").strip().split("\n\n")
    cues = [SRT_CUE.fullmatch(b) for b in blocks]
    bad = [b for b, c in zip(blocks, cues) if c is None]
    check(not bad, f"{what}: malformed cues {bad[:2]!r}")
    check([int(c.group(1)) for c in cues] == list(range(1, len(cues) + 1)),
          f"{what}: cues not numbered 1..n")
    for c in cues:
        h0, m0, s0, ms0, h1, m1, s1, ms1 = (int(x) for x in c.groups()[1:9])
        start, end = h0 * 3600 + m0 * 60 + s0 + ms0 / 1e3, h1 * 3600 + m1 * 60 + s1 + ms1 / 1e3
        check(0.0 <= start <= end <= duration + 1e-3, f"{what}: cue {c.group(1)} spans"
              f" {start}-{end} s of a {duration:.3f} s audio")
    speakers = {int(c.group(10)) for c in cues}
    txt = raw["txt"].decode("utf-8-sig")
    check({int(s) for s in re.findall(r"^Speaker (\d+):", txt, re.M)} == speakers,
          f"{what}: the text file's speakers differ from the SRT's")
    return {"cues": len(cues), "speakers": speakers,
            "words": sum(len(c.group(11).split()) for c in cues), "raw": raw}


def flow_trees(directory: str, seed: int) -> None:
    """5f's seeded small trees, saved by the port into ``directory``: the
    aligner at the WNT_TEST_SMALL_MODELS dims, TitaNet small as
    ``titanet_large.npz``, the telephonic MSDD, the punctuation model at
    its small dims, and the word vocabulary."""
    import torch

    from whisper_nemo_tpu_torch.align.api import load_alignment_model
    from whisper_nemo_tpu_torch.diarize.pipeline import _TITANET_SMALL
    from whisper_nemo_tpu_torch.engine.checkpoint import save_params
    from whisper_nemo_tpu_torch.models import msdd, punctuation, titanet

    g = torch.Generator().manual_seed(seed + 50)
    aligner, _ = load_alignment_model("cpu", seed=seed + 51)
    save_params(os.path.join(directory, "ctc_aligner.npz"), aligner.params)
    save_params(os.path.join(directory, "titanet_large.npz"),
                titanet.init_titanet_params(_TITANET_SMALL, "cpu", g))
    save_params(os.path.join(directory, "diar_msdd_telephonic.npz"),
                msdd.init_msdd_params(msdd.MsddDims(), "cpu", g))
    save_params(os.path.join(directory, "kredor_punctuate-all.npz"),
                punctuation.init_xlmr_params(punctuation.SMALL_DIMS, "cpu", g))
    write_word_vocab(directory)


def install_small_htdemucs(directory: str, seed: int) -> None:
    """A seeded htdemucs at DEMUCS_SMALL saved by the port into
    ``directory`` with the sidecar the JAX package's converter writes."""
    import torch

    from whisper_nemo_tpu_torch.engine.checkpoint import save_params
    from whisper_nemo_tpu_torch.models import htdemucs

    dims = htdemucs.HTDemucsDims(**DEMUCS_SMALL)
    save_params(os.path.join(directory, "htdemucs.npz"), htdemucs.init_htdemucs_params(
        dims, "cpu", torch.Generator().manual_seed(seed + 55)))
    with open(os.path.join(directory, "htdemucs.cfg.json"), "w") as f:
        json.dump({"sources": list(dims.sources), "segment": dims.segment,
                   "samplerate": dims.samplerate}, f)


def phase_flow_parity(seed: int, devices=("cuda", "cpu"), stem: bool = False) -> None:
    """5f: the CLI flow on ``devices[0]`` against its tail on
    ``devices[1]``, at small dims: tiny.en (random, seeded on the device),
    the aligner, TitaNet small and the punctuation model at their small
    dims, the telephonic MSDD, seeded trees saved into a temporary
    $WNT_MODEL_DIR with the word vocabulary; with ``stem`` (5i's flow)
    also htdemucs at DEMUCS_SMALL with its sidecar, and the flow stems.
    The audio is the first of DIAR_AUDIOS seeded 60 s of three voices
    whose Laplacian (with ``stem``: that of its vocals, as the separator
    gives them on ``devices[1]``) has an eigengap above DIAR_GAP on
    ``devices[1]`` (where the gap is smaller, two eigensolvers' labels
    may differ, phase 5e). ``run_sequential`` on a WAV of it at
    ``--device auto`` (``devices[0]``), ``--no-stem`` unless ``stem``,
    where its vocals.wav must be the CPU's within 1.5 steps of 16-bit PCM;
    then, from the same AsrResult on ``devices[1]``: ``run_alignment``,
    whose words must have the same texts and segments and, without
    ``stem``, times within FLOW_MOVE_TOL (the card's aligner runs bf16,
    the CPU's f32, and random weights give the Viterbi near-ties, so times
    may move, as phase 5b holds only on shared emissions; on the random
    separator's vocals they moved by 0.12 s on an H100, so with ``stem``
    they are printed and not held); ``run_diarization``, whose
    turns must equal the card's; and ``_merge_and_write`` of the card's
    words and these turns, whose ``.txt`` and ``.srt`` bytes must equal
    the card's. The bytes of the tail on its own words are printed beside
    them. ASR is held GPU against CPU by phases 5, 5c and 5d."""
    import torch

    from whisper_nemo_tpu_torch.audio import read_wav, write_wav
    from whisper_nemo_tpu_torch.cli import flow
    from whisper_nemo_tpu_torch.config import create_config
    from whisper_nemo_tpu_torch.diarize import NeuralDiarizer, pipeline
    from whisper_nemo_tpu_torch.models import punctuation

    gpu, cpu = devices
    sync = torch.cuda.synchronize if torch.device(gpu).type == "cuda" else None
    small_xlmr = functools.partial(punctuation.XlmRobertaDims, **vars(punctuation.SMALL_DIMS))
    with contextlib.ExitStack() as stack:
        tmp = stack.enter_context(tempfile.TemporaryDirectory())
        models = os.path.join(tmp, "models")
        os.makedirs(models)
        stack.enter_context(model_dir(models))
        stack.enter_context(env_var("WNT_TEST_SMALL_MODELS", "1"))
        stack.enter_context(patched(pipeline, "_TITANET_LARGE", pipeline._TITANET_SMALL))
        stack.enter_context(patched(punctuation, "XlmRobertaDims", small_xlmr))
        flow_trees(models, seed)
        if stem:
            install_small_htdemucs(models, seed)
        tag = "5i flow" if stem else "5f"

        probe = NeuralDiarizer(create_config(os.path.join(tmp, "probe"), "telephonic"),
                               device=cpu)
        gaps = []
        for i in range(DIAR_AUDIOS):
            audio = cpu_vocals = voices(60.0, seed + 60 + i, 3)
            if stem:
                path = os.path.join(tmp, f"probe_{i}.wav")
                write_wav(path, audio)
                cpu_vocals = read_wav(flow.maybe_separate_vocals(
                    path, True, cpu, os.path.join(tmp, "probe_sep")))[0]
            stats = {}
            probe.diarize_waveform(cpu_vocals, stats=stats)
            gaps.append(stats.get("eigengap", 0.0))
            if gaps[-1] > DIAR_GAP:
                break
        check(gaps[-1] > DIAR_GAP, f"{tag}: no audio of {DIAR_AUDIOS} has an eigengap above"
              f" {DIAR_GAP} (gaps {gaps}; choose another --seed)")
        del probe

        runs = {name: os.path.join(tmp, name) for name in ("card", "tail", "tail_own")}
        for path in runs.values():
            os.makedirs(path)
            write_wav(os.path.join(path, "call.wav"), audio)
        asr, words, turns, card_stats, card_vocals = [], [], [], {}, []
        waveform_call = NeuralDiarizer.diarize_waveform
        separate = flow.separate_vocals

        def separate_and_keep(*args):
            out = separate(*args)
            card_vocals.append(read_wav(out)[0])
            return out

        with contextlib.ExitStack() as card:
            card.enter_context(patched(flow, "separate_vocals", separate_and_keep))
            recording(card, flow, "run_asr", asr, sync)
            recording(card, flow, "run_alignment", words, sync)
            recording(card, flow, "run_diarization", turns, sync)
            card.enter_context(patched(NeuralDiarizer, "diarize_waveform", lambda self, a, **kw:
                                       waveform_call(self, a, stats=card_stats, **kw)))
            card.enter_context(contextlib.chdir(runs["card"]))
            t0 = time.time()
            flow.run_sequential(flow.build_arg_parser().parse_args(
                ["-a", os.path.join(runs["card"], "call.wav"), "--whisper-model", "tiny.en",
                 "--device", "auto" if torch.device(gpu).type == "cuda" else gpu]
                + ([] if stem else ["--no-stem"])))
            card_s = time.time() - t0
        if stem:
            vocals_err = float(np.abs(card_vocals[0] - cpu_vocals).max())
            check(len(card_vocals) == 1 and card_vocals[0].shape == cpu_vocals.shape
                  and vocals_err <= 1.5 / 32767, f"{tag}: the card's vocals.wav is"
                  f" {vocals_err * 32767:.1f} PCM steps from the CPU's")
        else:
            check(not card_vocals, f"{tag}: the flow separated with --no-stem")
        check(card_stats["eigengap"] > DIAR_GAP, f"{tag}: the eigengap on {gpu} is"
              f" {card_stats['eigengap']:.2e}")
        result, card_words, card_turns = asr[0][1], words[0][1], turns[0][1]
        check(len(card_words) > 20, f"{tag}: the card's flow aligned {len(card_words)} words")

        with contextlib.chdir(runs["tail"]):
            cpu_words = flow.run_alignment(result.audio, result.full_transcript, result.language,
                                           8, cpu, timed_segments=result.segments)
            cpu_turns = flow.run_diarization(result.audio, os.path.join(runs["tail"], "temp"),
                                             device=cpu)
        check([(w["text"], w["segment"]) for w in cpu_words]
              == [(w["text"], w["segment"]) for w in card_words],
              f"{tag}: the aligned words' texts or segments differ between the devices")
        moved = max(max(abs(a["start"] - b["start"]), abs(a["end"] - b["end"]))
                    for a, b in zip(cpu_words, card_words))
        check(stem or moved <= FLOW_MOVE_TOL, f"{tag}: the card's aligner moved a word by"
              f" {moved:.3f} s from the CPU's (limit {FLOW_MOVE_TOL} s)")
        check(cpu_turns == card_turns, f"{tag}: the speaker turns differ between the devices")
        tails = {}
        for name, tail_words in (("tail", card_words), ("tail_own", cpu_words)):
            flow._merge_and_write([dict(w) for w in tail_words], cpu_turns, result.language,
                                  os.path.join(runs[name], "call.wav"), cpu)
            tails[name] = check_outputs(os.path.join(runs[name], "call"), 60.0, f"{tag} {name}")
        got = check_outputs(os.path.join(runs["card"], "call"), 60.0, f"{tag} card")
        check(got["raw"] == tails["tail"]["raw"],
              f"{tag}: the card's .txt or .srt bytes differ from the CPU tail's")
        check(not os.path.exists(os.path.join(runs["card"], "temp_outputs")),
              f"{tag}: temp_outputs was left behind")
    separation = (f" (htdemucs at small dims: stemming on, vocals.wav within"
                  f" {vocals_err * 32767:.1f} PCM steps of the CPU's separation)" if stem else
                  " --no-stem")
    print(f"[{tag} parity] run_sequential (tiny.en random, the aligner, TitaNet small, MSDD,"
          f" the punctuation model at small dims){separation} --device auto on {gpu} in"
          f" {card_s:.1f} s,"
          f" against the flow's tail on {cpu} from the same AsrResult, audio {i} of 60 s of 3"
          f" voices (eigengaps {', '.join(f'{g:.4f}' for g in gaps)}; on {gpu}"
          f" {card_stats['eigengap']:.4f}) | {len(card_words)} words, texts and segments equal,"
          f" times moved by up to {moved:.3f} s"
          f" ({'not held' if stem else f'limit {FLOW_MOVE_TOL} s'}; the aligner"
          f" {'bf16' if sync else 'f32'} against f32) | turns equal"
          f" ({len(card_turns)}, {len(got['speakers'])} speakers) | .txt and .srt bytes equal"
          f" ({got['cues']} cues) | the tail on its own words: bytes"
          f" {'equal' if tails['tail_own']['raw'] == got['raw'] else 'differ'}")


def phase_diar_main(seed: int) -> dict:
    """6e: the diarization main path at full width, as bench.py drives it:
    NeuralDiarizer(create_config(tmp, "telephonic"), force_large_models=True)
    (TitaNet-large, the full MarbleNet forward, the telephonic MSDD, random
    weights from --seed unless $WNT_MODEL_DIR holds them) on four voices:
    one warm request of 2 minutes, then 15, 30 and 60 minutes with
    num_speakers=4, which take the dense eigh, the Nyström and the long-form
    paths. Each prints its counts, its wall time, its stage times (each
    after a device synchronise) and its peak device memory; no kernel of
    the port lies on this path, and none launches."""
    import torch

    from whisper_nemo_tpu_torch.config import create_config
    from whisper_nemo_tpu_torch.diarize import NeuralDiarizer
    from whisper_nemo_tpu_torch.diarize.pipeline import _TITANET_LARGE
    from whisper_nemo_tpu_torch.engine.precision import full_f32
    from whisper_nemo_tpu_torch.ops import attention, beam_permute, cross_decode, ctc, mel, self_decode

    counters = (cross_decode.cross_attention_decode_layered, attention.encoder_attention,
                mel.log_mel_raw, ctc.viterbi_batch, self_decode.self_attention_decode_ancestry_layered,
                beam_permute.beam_permute_cache, beam_permute.beam_permute_cache_inplace)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        diar = NeuralDiarizer(create_config(tmp, "telephonic"), force_large_models=True,
                              device="cuda", seed=seed)
        torch.cuda.synchronize()
        setup_s = time.time() - t0
        check(diar.spk_dims == _TITANET_LARGE and diar.msdd_params is not None
              and (diar.vad_params is not None or diar._bench_vad_params is not None),
              "6e: not TitaNet-large with MSDD and MarbleNet")
        t0 = time.time()
        diar.diarize_waveform(voices(120.0, seed + 30, 4), num_speakers=4)
        torch.cuda.synchronize()
        print(f"[6e diarization] telephonic, TitaNet-large + MarbleNet + MSDD, f32 (TF32 off):"
              f" setup {setup_s:.1f} s, warm request (2 min) {time.time() - t0:.2f} s")
        for minutes, path in ((15, "dense"), (30, "nystrom"), (60, "longform")):
            audio = voices(minutes * 60.0, seed + 31 + minutes, 4)
            for fn in counters:
                fn.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()  # the models and what earlier phases keep
            stats = {}
            t1 = time.time()
            turns = diar.diarize_waveform(audio, num_speakers=4, stats=stats)
            torch.cuda.synchronize()
            wall = time.time() - t1
            peak = torch.cuda.max_memory_allocated() / 2**30
            peak_own = peak - held / 2**30
            launches = [fn.launches for fn in counters]
            duration = len(audio) / SR
            check(stats["path"] == path, f"6e {minutes} min: n_base {stats['n_base']} took the"
                  f" {stats['path']} path, not {path}")
            check(stats["msdd_pairs"] == 6 and stats["speakers"] == 4,
                  f"6e {minutes} min: {stats['speakers']} speakers, {stats['msdd_pairs']} MSDD pairs")
            check(bool(turns) and all(0.0 <= s < e <= duration + 1e-6 and 0 <= k < 4
                                      for s, e, k in turns), f"6e {minutes} min: turns out of range")
            check(sum(e - s for s, e, _ in turns) > 0.5 * duration,
                  f"6e {minutes} min: the turns cover under half the audio")
            check(launches == [0] * len(counters), f"6e: a kernel launched on the diarization path"
                  f" {launches}")
            seconds = stats["seconds"]
            embed_s = sum(v for k, v in seconds.items() if k.startswith("embed_"))
            frames = sum(n * (int(w * SR) // 160 + 1) for n, w in zip(
                stats["windows"], diar.cfg.diarizer.speaker_embeddings.parameters.window_length_in_sec))
            tflop = titanet_flops_per_frame(diar.spk_dims) * frames / 1e12
            stages = " ".join(f"{k} {v:.3f}" for k, v in seconds.items())
            print(f"[6e diarization] {minutes} min: n_base {stats['n_base']}, windows per scale"
                  f" {stats['windows']}, path {stats['path']} (eigengap"
                  f" {stats.get('eigengap', float('nan')):.4f}), speakers {stats['speakers']}, MSDD"
                  f" {stats['msdd_pairs']} pairs x {stats['msdd_windows']} windows, turns"
                  f" {len(turns)} | wall {wall:.3f} s ({wall / duration * 3600:.2f} s per audio"
                  f" hour; stages {sum(seconds.values()):.3f} s of it) | embeddings {embed_s:.3f} s:"
                  f" {frames} window-frames, {tflop:.1f} TFLOP, {tflop / embed_s:.1f} TFLOP/s"
                  f" ({tflop * 1e12 / embed_s / F32_FLOPS:.0%} of the f32 peak) | stages (s): {stages} |"
                  f" peak device memory {peak:.2f} GiB ({peak_own:.2f} above the {held / 2**30:.2f}"
                  f" held before the request)")
            out[minutes] = {"wall": wall, "peak_gib": peak, "peak_own_gib": peak_own, **stats}

        # one embedding batch of the 1.5 s scale (256 windows of 151 frames), timed apart
        g = torch.Generator(device=diar.device).manual_seed(seed + 40)
        feats = torch.randn((256, diar.spk_dims.n_mels, 151), device=diar.device, generator=g)
        lens = torch.full((256,), 151, device=diar.device)
        with full_f32(), torch.inference_mode():
            batch_ms = cuda_ms(lambda i=0: diar._embed(feats, lens), 5)
            prof = profiled_device_ms(lambda i=0: diar._embed(feats, lens), 3)
        tflop = titanet_flops_per_frame(diar.spk_dims) * 256 * 151 / 1e12
        print(f"[6e diarization] one TitaNet-large batch, 256 windows x 151 frames: {batch_ms:.2f} ms"
              f" (CUDA events), {tflop * 1e3:.1f} GFLOP, {tflop / batch_ms * 1e3:.1f} TFLOP/s; bound"
              f" {tflop * 1e12 / F32_FLOPS * 1e3:.2f} ms (operations at the f32 peak) | {fmt_top(prof)}")
    del diar
    torch.cuda.empty_cache()
    return out


FLOW_SECONDS = 300.0  # 6f's audio: five minutes of four voices
CLI_SECONDS = 60.0  # the --device cuda run's audio and the CLI subprocess's


def recording_launches(stack: contextlib.ExitStack) -> dict:
    """Wraps the launchers of kernels A to E within ``stack``: each launch
    adds one to the count of its shape, ``{letter: Counter(key)}``, keyed
    by what ``phase_flow_kernels`` rebuilds the inputs from (kernel E's
    key holds the visible length, which sets its cluster split)."""
    from whisper_nemo_tpu_torch.ops import attention, cross_decode, ctc, mel, self_decode

    seen = {letter: collections.Counter() for letter in "ABCDE"}
    keys = {
        "A": (cross_decode, "_cross_attention_decode_cuda",
              lambda q, kv, k_scale, v_scale, layer, k_len, bits, beam, *_:
              (q.dtype, tuple(kv.shape), k_len, bits, beam)),
        "B": (attention, "_encoder_attention_cuda", lambda q, *_: (q.dtype, tuple(q.shape))),
        "C": (mel, "_log_mel_cuda", lambda waves, n_mels, *_: (tuple(waves.shape), n_mels)),
        "D": (ctc, "_viterbi_cuda", lambda e_states, *_: tuple(e_states.shape)),
        "E": (self_decode, "_self_decode_cuda",
              lambda q, k, v, anc, mask, layer, beam, n_vis, *_:
              (q.dtype, tuple(k.shape), beam, mask.numel() // k.shape[-1], n_vis)),
    }
    for letter, (module, name, key) in keys.items():
        def wrapper(*args, _fn=getattr(module, name), _key=key, _seen=seen[letter]):
            out = _fn(*args)
            _seen[_key(*args)] += 1
            return out

        stack.enter_context(patched(module, name, wrapper))
    return seen


def run_flow(argv: list, audio_path: str, seconds: float, work: str, what: str,
             parallel: bool = False) -> dict:
    """``run_sequential`` (``run_parallel`` with ``parallel``, its parser's
    defaults) on ``argv`` in process from ``work``: every kernel's count
    set to 0 just before and read just after, each launch's shape recorded
    (``recording_launches``), each stage (the separation too, where the
    flow stems) timed after a synchronise of the
    stream it ran on (a branch's own in the parallel flow, so that timing
    one branch does not wait for the other). Checks what every width
    shares: the outputs
    (``check_outputs``), C one launch a batch, E each decode step's
    decoder layers, B each batch's encoder layers and each emission
    batch's aligner layers, D one a Viterbi group, F none, the recorded
    shapes adding up to the counts, every speaker of the SRT in the RTTM,
    the punctuation model labelling every word, temp_outputs gone."""
    import torch

    from whisper_nemo_tpu_torch import asr as fw
    from whisper_nemo_tpu_torch.align import segmented
    from whisper_nemo_tpu_torch.align.api import CHUNK_SECONDS
    from whisper_nemo_tpu_torch.cli import flow
    from whisper_nemo_tpu_torch.ops import attention, beam_permute, cross_decode, ctc, mel, self_decode

    counters = (cross_decode.cross_attention_decode_layered, attention.encoder_attention,
                mel.log_mel_raw, ctc.viterbi_batch, self_decode.self_attention_decode_ancestry_layered,
                beam_permute.beam_permute_cache, beam_permute.beam_permute_cache_inplace)
    def sync():
        torch.cuda.current_stream().synchronize()

    calls = {name: [] for name in ("separate", "decode", "asr", "align", "diarize", "punct",
                                   "merge", "labels", "model", "aligner")}
    with contextlib.ExitStack() as timing:
        recording(timing, flow, "maybe_separate_vocals", calls["separate"], sync)
        recording(timing, fw, "decode_audio", calls["decode"], sync)
        recording(timing, fw, "WhisperModel", calls["model"], sync)
        recording(timing, flow, "load_alignment_model", calls["aligner"], sync)
        recording(timing, flow, "run_asr", calls["asr"], sync)
        recording(timing, flow, "run_alignment", calls["align"], sync)
        recording(timing, flow, "run_diarization", calls["diarize"], sync)
        recording(timing, flow, "maybe_restore_punctuation", calls["punct"], sync)
        recording(timing, flow, "_merge_and_write", calls["merge"], sync)
        recording(timing, flow, "apply_punctuation_labels", calls["labels"])
        shapes = recording_launches(timing)
        align_call = segmented.align_segments
        align_stats = {}
        timing.enter_context(patched(segmented, "align_segments", lambda *a, **kw:
                                     align_call(*a, stats=align_stats, **kw)))
        timing.enter_context(contextlib.chdir(work))
        args = flow.build_arg_parser(parallel).parse_args(argv)
        for fn in counters:
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.time()
        (flow.run_parallel if parallel else flow.run_sequential)(args)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = [fn.launches for fn in counters]
        peak = torch.cuda.max_memory_allocated() / 2**30
    a, b, c, d, e, *f = launches
    eng = calls["model"][0][1].engine
    steps = list(eng.last_decode_steps)
    aligner_layers = calls["aligner"][0][1][0].dims.num_layers
    words = calls["align"][0][1]
    turns = calls["diarize"][0][1]
    wsm, labeled = calls["labels"][0][2]
    out = check_outputs(os.path.splitext(audio_path)[0], seconds, what)
    check(f == [0, 0], f"{what}: kernel F launched {f}")
    check(c == len(steps) and e == sum(steps) * eng.dims.n_text_layer and e > 0,
          f"{what}: kernels C {c} and E {e} against {len(steps)} batches of steps {steps}")
    emission_batches = math.ceil(math.ceil(seconds / CHUNK_SECONDS) / args.batch_size)
    dispatched = sum(len(rows) for rows in align_stats["groups"].values())
    check(b == len(steps) * eng.dims.n_audio_layer + emission_batches * aligner_layers,
          f"{what}: kernel B launched {b} times, expected {len(steps)} batches x"
          f" {eng.dims.n_audio_layer} + {emission_batches} emission batches x {aligner_layers}")
    check(d == dispatched > 0, f"{what}: kernel D launched {d} times for {dispatched} groups")
    check([sum(shapes[k].values()) for k in "ABCDE"] == [a, b, c, d, e],
          f"{what}: the recorded launches {[sum(shapes[k].values()) for k in 'ABCDE']} are not"
          f" the counts {[a, b, c, d, e]}")
    check(out["speakers"] <= {s for _, _, s in turns}, f"{what}: speakers {out['speakers']} of"
          f" the SRT have no turn in the RTTM")
    check(len(wsm) == len(labeled) == len(words) > 0 and len(calls["labels"]) == 1,
          f"{what}: punctuation labelled {len(labeled)} of {len(words)} words")
    check(not os.path.exists(os.path.join(work, "temp_outputs")), f"{what}: temp_outputs left")
    check(not args.stemming or calls["separate"][0][1] != args.audio,
          f"{what}: the flow went on without separating the vocals")
    check(out["words"] == len(words) and out["cues"] > 1,
          f"{what}: the SRT holds {out['words']} of the {len(words)} aligned words")
    secs = {k: sum(t for t, *_ in calls[k]) for k in calls}
    # the parallel flow decodes once before its branches, and run_asr once more
    stages = {"separation": secs["separate"]} if args.stemming else {}
    stages |= {"decode": secs["decode"], "ASR": secs["asr"] - calls["decode"][-1][0],
              "of it the model's set-up": secs["model"], "alignment": secs["align"],
              "diarization": secs["diarize"], "punctuation": secs["punct"],
              "mapping and writers": secs["merge"] - secs["punct"]}
    return {"wall": wall, "launches": dict(zip("abcde", (a, b, c, d, e))), "stages": stages,
            "steps": steps, "dtype": eng.dtype, "kv_bits": eng.cross_kv_bits,
            "layers": (eng.dims.n_audio_layer, eng.dims.n_text_layer, aligner_layers),
            "emission_batches": emission_batches, "groups": dispatched, "words": len(words),
            "turns": len(turns), "out": out, "peak": peak, "held": held, "shapes": shapes}


def fmt_flow(r: dict, seconds: float) -> str:
    enc, dec, aligner = r["layers"]
    n, steps, (a, b, c, d, e) = len(r["steps"]), sum(r["steps"]), r["launches"].values()
    return (f"wall {r['wall']:.2f} s ({r['wall'] / seconds * 3600:.1f} s per audio hour, set-up"
            f" of every model included) | stages (s): "
            + ", ".join(f"{k} {v:.3f}" for k, v in r["stages"].items())
            + f" | {r['words']} words, {r['out']['cues']} sentences = cues,"
            f" {len(r['out']['speakers'])} speakers ({r['turns']} turns) | peak device memory"
            f" {r['peak']:.2f} GiB ({r['held'] / 2**30:.2f} held before) | launches A {a}, B {b}"
            f" (= {n} batches x {enc} + {r['emission_batches']} emission batches x {aligner}),"
            f" C {c} (one a batch), D {d} (= {r['groups']} Viterbi groups), E {e} (= {steps}"
            f" steps x {dec}), F 0")


def phase_flow_main(seed: int, smi: str) -> dict:
    """6f: the CLI flow at full width, in process (``run_flow``):
    ``run_sequential`` with ``--whisper-model medium.en --batch-size 8
    --device auto --domain telephonic --no-stem`` (medium.en at
    "default": f32, the float cross-KV, kernel A held at 0; beam 5, the
    facade's default) on a WAV of FLOW_SECONDS of four voices, from a
    temporary working directory. $WNT_MODEL_DIR holds seeded full-width
    ``titanet_large.npz`` and ``diar_msdd_telephonic.npz`` and the word
    vocabulary; Whisper, the MMS-300M-sized aligner (bf16) and XLM-R base
    are seeded random inits. Then the same flow with the user's command's
    arguments, ``-a <CLI_SECONDS wav> --device cuda --no-stem`` (medium.en
    at "float16": bf16 weights, the int8 cross-KV), in process, with A's
    launches held to the decode steps' decoder layers; then that command,
    ``python3 -m whisper_nemo_tpu_torch.cli``, as a subprocess: exit 0 and
    both files well formed. Returns both in-process runs."""
    import torch

    from whisper_nemo_tpu_torch.audio import write_wav
    from whisper_nemo_tpu_torch.diarize import pipeline
    from whisper_nemo_tpu_torch.engine.checkpoint import save_params
    from whisper_nemo_tpu_torch.models import msdd, titanet

    with contextlib.ExitStack() as stack:
        tmp = stack.enter_context(tempfile.TemporaryDirectory())
        models = os.path.join(tmp, "models")
        work = os.path.join(tmp, "work")
        os.makedirs(models)
        os.makedirs(work)
        stack.enter_context(model_dir(models))
        g = torch.Generator().manual_seed(seed + 70)
        save_params(os.path.join(models, "titanet_large.npz"),
                    titanet.init_titanet_params(pipeline._TITANET_LARGE, "cpu", g))
        save_params(os.path.join(models, "diar_msdd_telephonic.npz"),
                    msdd.init_msdd_params(msdd.MsddDims(), "cpu", g))
        write_word_vocab(models)
        audio_path = os.path.join(work, "call.wav")
        write_wav(audio_path, voices(FLOW_SECONDS, seed + 71, 4))

        auto = run_flow(["-a", audio_path, "--whisper-model", "medium.en", "--batch-size", "8",
                         "--device", "auto", "--domain", "telephonic", "--no-stem"],
                        audio_path, FLOW_SECONDS, work, "6f")
        check(auto["dtype"] == torch.float32 and auto["kv_bits"] is None,
              "6f: --device auto did not run medium.en at \"default\"")
        check(auto["launches"]["a"] == 0, f"6f: kernel A launched {auto['launches']['a']} times"
              f" over the float cross-KV")
        print(f"[6f flow] {smi} | run_sequential --whisper-model medium.en --batch-size 8 --device"
              f" auto --domain telephonic --no-stem on {FLOW_SECONDS:.0f} s of four voices:"
              f" {fmt_flow(auto, FLOW_SECONDS)}")
        torch.cuda.empty_cache()

        cli_path = os.path.join(work, "cli.wav")
        write_wav(cli_path, voices(CLI_SECONDS, seed + 72, 4))
        cuda = run_flow(["-a", cli_path, "--device", "cuda", "--no-stem"], cli_path, CLI_SECONDS,
                        work, "6f --device cuda")
        check(cuda["dtype"] == torch.bfloat16 and cuda["kv_bits"] == 8,
              "6f: --device cuda did not run medium.en at \"float16\" (bf16, int8 cross-KV)")
        check(cuda["launches"]["a"] == sum(cuda["steps"]) * cuda["layers"][1],
              f"6f --device cuda: kernel A launched {cuda['launches']['a']} times for"
              f" {sum(cuda['steps'])} steps x {cuda['layers'][1]} decoder layers")
        print(f"[6f flow] {smi} | run_sequential -a <{CLI_SECONDS:.0f} s wav> --device cuda"
              f" --no-stem (the user's command's arguments; medium.en \"float16\": bf16 weights,"
              f" int8 cross-KV, kernel A) on four voices: {fmt_flow(cuda, CLI_SECONDS)}")
        torch.cuda.empty_cache()

        user = os.path.join(tmp, "user")
        os.makedirs(user)
        user_path = os.path.join(user, "cli.wav")
        write_wav(user_path, voices(CLI_SECONDS, seed + 72, 4))
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "whisper_nemo_tpu_torch.cli", "-a", user_path, "--device",
             "cuda", "--no-stem"], cwd=user, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))})
        cli_s = time.time() - t0
        check(proc.returncode == 0, f"6f: the CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        cli = check_outputs(os.path.splitext(user_path)[0], CLI_SECONDS, "6f CLI")
    print(f"[6f flow] {smi} | python3 -m whisper_nemo_tpu_torch.cli -a <{CLI_SECONDS:.0f} s wav>"
          f" --device cuda --no-stem: exit 0 in {cli_s:.1f} s (a new process: imports, every"
          f" model's set-up and the kernels' loads included) | {cli['cues']} cues,"
          f" {len(cli['speakers'])} speakers")
    return {"auto": auto, "cuda": cuda}


def hold_launched_shape(letter: str, shape: tuple, g, seed: int, where: str, tag: str) -> tuple:
    """Kernel A, B or C against its plain version, timed, on seeded inputs
    of a launch's recorded ``shape`` (``recording_launches``' key), within
    BOUND_A, BOUND_B (BOUND_B_F32 at f32) or BOUND_C and BOUND_C_F64. Prints one line under
    ``[{tag} kernel X]`` with ``where`` it was launched; returns (a
    description of the shape, the case's numbers)."""
    import torch

    from whisper_nemo_tpu_torch.ops import attention as at
    from whisper_nemo_tpu_torch.ops import cross_decode as cd

    dev = torch.device("cuda")
    if letter == "A":
        dtype, (L, W, H, rows, kp), k_len, bits, beam = shape
        D = rows // 2 if bits == 8 else rows
        kv = torch.randint(-127, 128, (L, W, H, rows, kp), device=dev, generator=g,
                           dtype=torch.int8)
        k_scale = 0.02 + 0.02 * torch.rand((H, D), device=dev, generator=g)
        v_scale = (0.5 + torch.rand((H, D), device=dev, generator=g)) / 127
        q = torch.randn((W * beam, 1, H, D), device=dev, generator=g).to(dtype)
        r = kernel_a_case(cd, q, kv, k_scale, v_scale, k_len, bits, beam, 48)
        desc = f"{str(dtype)[6:]} q, W={W} H={H} beam {beam} bits {bits} k_len {k_len}"
        print(f"[{tag} kernel A] {desc} ({where}): {fmt_a(r)}")
        check(r["max_abs_err"] <= BOUND_A, f"{tag} kernel A {desc}: max|err|"
              f" {r['max_abs_err']} > {BOUND_A}")
        del kv
    elif letter == "B":
        dtype, (B, T, H, D) = shape
        r = kernel_b_case(at, B, T, H, dtype, g, D)
        desc = f"{str(dtype)[6:]} B={B} T={T} H={H} D={D}"
        print(f"[{tag} kernel B] {desc} ({where}): {fmt_b(r)}")
        check(r["max_abs_err"] <= r["bound"], f"{tag} kernel B {desc}: max|err|"
              f" {r['max_abs_err']} > {r['bound']}")
    else:
        (n, samples), n_mels = shape
        waves = torch.from_numpy(speechlike(n * samples / SR, seed).reshape(n, samples))
        desc = f"batch of {n}"
        r = kernel_c_case(waves.to(dev), n_mels, f"{desc} ({where})", True,
                          tag=f"{tag} kernel C")
        desc = f"{n_mels} mels, {desc}"
    torch.cuda.empty_cache()
    return desc, r


def phase_flow_kernels(runs: dict, seed: int, tag: str = "6g",
                       entry=lambda run, letter: (run == "auto") != (letter == "A"),
                       label=lambda run: f"the CLI flow, 6f --device {run}") -> list:
    """6g: kernels A to E held against their plain versions at every shape
    the in-process runs of 6f launched them at (``recording_launches``),
    on seeded inputs of those shapes: A, B and E within BOUND_A, BOUND_B
    (BOUND_B_F32 at f32) and BOUND_E/BOUND_E_F32, C within BOUND_C and
    BOUND_C_F64, D bit for bit. Kernel E is held once for each cluster
    split its wrapper chose, at the largest visible length launched with
    it and with a beam's runs as the ancestry map; its split is checked to
    be the one the flow got. Prints each shape's launches in each run and
    returns the JSON entries of the flow's kernels (those ``entry`` picks:
    by default B, C, D and E of the --device auto run and A of the
    --device cuda run, as kernel A does not run at auto), one a shape,
    each with its launches in that run, named by ``label``. Phase 6j's
    runs take the same holds under its own ``tag``."""
    import torch

    from whisper_nemo_tpu_torch.ops import attention as at
    from whisper_nemo_tpu_torch.ops import self_decode as sd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 73)
    sms = sd._sms(dev.index or 0)

    def e_group(key):  # kernel E's launches grouped by their cluster split
        dtype, shape, beam, mask_rows, n_vis = key
        return dtype, shape, beam, mask_rows, sd._cluster_size(shape[1] // beam, shape[2], n_vis,
                                                               sms)

    launches = {}  # (run, letter, shape) -> launches; E's shape is its group
    widest = {}  # E's group -> its largest visible length
    for run, r in runs.items():
        for letter, seen in r["shapes"].items():
            for key, n in seen.items():
                shape = e_group(key) if letter == "E" else key
                launches[(run, letter, shape)] = launches.get((run, letter, shape), 0) + n
                if letter == "E":
                    widest[shape] = max(widest.get(shape, 0), key[-1])

    def where(letter, shape):
        return ", ".join(f"{launches[(run, letter, shape)]} launches in the {run} run"
                         for run in runs if (run, letter, shape) in launches)

    held = {}
    for letter, shape in sorted({k[1:] for k in launches}, key=str):
        if letter in "ABC":
            desc, r = hold_launched_shape(letter, shape, g, seed + 74, where(letter, shape), tag)
        elif letter == "D":
            rows, t, n_states = shape
            check(n_states % 2 == 1, f"{tag} kernel D: a trellis of {n_states} states")
            desc = f"R={rows} T={t} L={n_states}"
            r = kernel_d_case(rows, t, (n_states - 1) // 2, seed + 75, 0, 20,
                              f"({where(letter, shape)})", tag=f"{tag} kernel D")
        else:
            dtype, (L, bk, H, D, S), beam, mask_rows, cluster = shape
            n_vis = widest[shape]
            k, v = (torch.randn((L, bk, H, D, S), device=dev, generator=g, dtype=dtype)
                    for _ in range(2))
            q = torch.randn((bk, 1, H, D), device=dev, generator=g).to(dtype)
            anc = beam_runs_anc(bk // beam, beam, S, g)
            visible = torch.arange(S, device=dev) < n_vis
            if mask_rows == 1:
                mask = torch.where(visible, 0.0, float("-inf"))[None, None, None, :]
            else:
                keep = torch.rand((bk, S), device=dev, generator=g) > 0.2
                keep[:, 0] = True
                mask = torch.where(keep & visible, 0.0, float("-inf"))[:, None, None, :].contiguous()
            r = kernel_e_case(sd, at, q, k, v, anc, mask, n_vis, 48)
            desc = (f"{str(dtype)[6:]} B·K={bk} S={S} beam {beam}, {mask_rows} mask row(s),"
                    f" cluster {cluster}, at n_visible {n_vis}")
            print(f"[{tag} kernel E] {desc}, a beam's runs ({where(letter, shape)}): {fmt_e(r)}")
            check(r["cluster"] == cluster, f"{tag} kernel E {desc}: held at cluster {r['cluster']}")
            del k, v
        held[(letter, shape)] = (desc, r)
        torch.cuda.empty_cache()

    entries = []
    for (run, letter, shape), n in launches.items():
        if not entry(run, letter):
            continue
        desc, r = held[(letter, shape)]
        entries.append(kernel_entry(letter, f"{label(run)}: {desc}", n, r))
    return entries


# each kernel's wrapper, source and the TPU kernel it replaces
KERNELS = {"A": ("cross_attention_decode_layered", "cross_decode.cu", "cross_decode.py:261"),
           "B": ("encoder_attention", "encoder_attention.cu", "attention.py:91"),
           "C": ("log_mel_raw", "log_mel.cu", "mel.py:149"),
           "D": ("viterbi_batch", "viterbi.cu", "viterbi_pallas.py:101"),
           "E": ("self_attention_decode_ancestry_layered", "self_decode.cu", "self_decode.py:198")}


def kernel_entry(letter: str, what: str, launches: int, r: dict) -> dict:
    """One entry of the kernels' JSON line: kernel ``letter`` held at the
    shape ``what`` names (``r``: its numbers), with its ``launches``."""
    name, source, replaces = KERNELS[letter]
    return {"name": f"{name} ({what})", "route": "cuda",
            "source": f"whisper_nemo_tpu_torch/csrc/{source}",
            "replaces": f"whisper_nemo_tpu/ops/{replaces}", "launches": launches, **r}


# -- serving (phases 5g, 6h and 6i) ------------------------------------------

# 5g: multilingual small dims (head dim 64), the handler at int8 (kernel A),
# batches of 4 padded to buckets 1, 2 and 4, and its token limits
SERVE_DIMS = (80, 1500, 128, 2, 2, 51865, 64, 128, 2, 2)
SERVE_MIN_NEW, SERVE_MAX_NEW = 4, 24
# 6h: bench.py's token limits (random weights never emit EOT) and a job's audio
HANDLER_MIN_NEW, HANDLER_MAX_NEW = 64, 96
JOB_SECONDS = 600.0
# 5g: a segment's confidence (1 - its no-speech probability) GPU against CPU,
# both at bf16 activations, their products summed in other orders
CONF_TOL = 2e-3
SERVE_JOB = {"audio_url": "https://example.com/call.wav", "language": "en", "max_speakers": 3}


def same_response(got: dict, want: dict, tol: float) -> None:
    """Two handler responses equal apart from ``processing_time``, with
    each segment's ``confidence`` within ``tol``. Each formatted
    transcript must be what the formatter writes from its own segments,
    which are equal apart from those confidences, and the mean confidence
    within 100·tol percent (and its rounding). Raises AssertionError."""
    from whisper_nemo_tpu_torch.post import create_readable_transcript_improved

    got, want = dict(got), dict(want)
    assert got.pop("processing_time") > 0 and want.pop("processing_time") > 0
    assert set(got) == set(want), (sorted(got), sorted(want))
    segs, want_segs = got.pop("segments_detailles", None), want.pop("segments_detailles", None)
    if want_segs is not None:
        assert len(segs) == len(want_segs) > 0, (len(segs), len(want_segs))
        for s, w in zip(segs, want_segs):
            assert abs(s["confidence"] - w["confidence"]) < tol, (s, w)
            assert {**s, "confidence": 0} == {**w, "confidence": 0}, (s, w)
        mixed = [{**w, "confidence": s["confidence"]} for s, w in zip(segs, want_segs)]
        assert got.pop("transcription_formatee") == create_readable_transcript_improved(mixed)
        assert want.pop("transcription_formatee") == create_readable_transcript_improved(want_segs)
        stats, want_stats = dict(got.pop("statistiques")), dict(want.pop("statistiques"))
        mean = [float(s.pop("confiance_moyenne").rstrip("%")) for s in (stats, want_stats)]
        assert abs(mean[0] - mean[1]) <= 100 * tol + 0.05, mean
        assert stats == want_stats, (stats, want_stats)
    assert got == want, (got, want)


def record_dispatches(sched, log: list) -> None:
    """Wraps ``sched``'s batch processing: each dispatch appends to
    ``log`` its windows' starts and audio, its pad size (bucket), and from
    its decode the steps, tokens, lengths and prompt length."""
    process, decode = sched._process, sched.engine._decode_batch
    inside = threading.local()  # the dispatch this thread is processing

    def spy_decode(*args, **kwargs):
        out = decode(*args, **kwargs)
        entry = getattr(inside, "entry", None)
        if entry is not None:  # not the openai facade's or the stream's decode
            entry.update(tokens=out[0].cpu(), lengths=out[1].cpu(), n_prompt=out[4],
                         steps=out[5])
        return out

    def spy(items, loaded=False):
        inside.entry = {"starts": [round(it.start_s, 4) for it in items],
                        "audio": [it.audio for it in items], "language": items[0].language,
                        "bucket": sched._pad_target(len(items), loaded)}
        log.append(inside.entry)
        try:
            return process(items, loaded=loaded)
        finally:
            inside.entry = None

    sched._process = spy
    sched.engine._decode_batch = spy_decode


def served_step(engine, waves: np.ndarray, row: int, generated: list, suppress, language: str,
                min_new: int) -> tuple:
    """The port's decode rules at the token after ``generated`` in row
    ``row`` of the batch ``waves`` (as the scheduler dispatched it: an
    int8 cross-KV's scales are taken over the batch), teacher-forced
    through one prefill on ``engine``: (the filtered f32 logits, the
    logits before the timestamp rules' last one, which forces a timestamp
    where the timestamps' total probability beats every text token's, and
    that rule's margin: the timestamps' log-probability minus the best
    text token's; None where the history leaves text masked)."""
    import torch

    from whisper_nemo_tpu_torch.engine.decode import _filter_logits, _static_filter
    from whisper_nemo_tpu_torch.models.whisper import _vocab_logits
    from whisper_nemo_tpu_torch.models.whisper_stacked import (
        cross_kv_for_decode,
        init_stacked_cache,
        prefill_cache_stacked,
    )
    from whisper_nemo_tpu_torch.ops import mel

    dev, dims = engine.device, engine.dims
    prompt = engine._prompt(language, False, None)[0].tolist()
    opts = engine._make_opts(without_timestamps=False, min_new_tokens=min_new)
    n_prompt, pos = len(prompt), len(prompt) + len(generated)
    b = waves.shape[0]
    with torch.inference_mode():
        feats = engine.encode_windows(mel.log_mel_spectrogram_batch(
            torch.from_numpy(waves).to(dev), dims.n_mels))
        ckv = cross_kv_for_decode(engine.params, feats.to(engine.dtype), dims, engine.cross_kv_bits)
        tokens = torch.tensor([prompt + list(generated)] * b, device=dev)
        cache = init_stacked_cache(b, dims, engine.dtype, 128, dev)
        x, _ = prefill_cache_stacked(engine.params, tokens, cache, ckv, dims, engine.dtype)
        logits = _vocab_logits(engine.params["decoder"], x[:, -1])
        history = torch.cat([tokens, tokens[:, :1]], dim=1)
        static = _static_filter(suppress, opts, dev)
        filt = _filter_logits(logits.clone(), static, history, pos, n_prompt, opts)[row].cpu()
        plain = _filter_logits(logits.clone(), static, history, pos, n_prompt,
                               dataclasses.replace(opts, without_timestamps=True))[row].cpu()
    ts = opts.timestamp_begin
    is_ts = torch.arange(filt.shape[0]) >= ts
    step = len(generated)
    lone = step >= 2 and generated[-1] >= ts and generated[-2] < ts
    if step == 0 or lone or torch.isinf(plain[~is_ts]).all():
        return filt, filt, None
    # before the forcing rule: the text tokens as the other rules leave them
    # (none of them masks text here), the timestamps as all rules do
    before = torch.where(is_ts, filt, plain)
    lp = torch.log_softmax(before, dim=-1)
    margin = float(torch.logsumexp(lp[is_ts], 0) - lp[~is_ts].max())
    return filt, before, margin


def served_tie(engine, dispatch: dict, row: int, mine: list, other: list, suppress,
               min_new: int) -> str:
    """Why ``other`` (another device's tokens for window ``row`` of
    ``dispatch``) may part from ``mine`` (this engine's): at the first
    differing token, on this engine's logits over the shared history,
    either both picks are open and within TIE_TOL of each other and of
    the best, or the forcing rule's margin is within TIE_TOL (the devices
    may force a timestamp or not) and the other's pick is within TIE_TOL
    of the best of its kind. Raises SmokeFailure otherwise."""
    import torch

    eot = engine.tokenizer.eot
    j = first_difference(mine, other, eot)
    waves = np.zeros((dispatch["bucket"], len(dispatch["audio"][0])), np.float32)
    waves[: len(dispatch["audio"])] = np.stack(dispatch["audio"])
    filt, before, margin = served_step(engine, waves, row, mine[:j], suppress,
                                       dispatch["language"], min_new)
    a, b = (list(mine) + [eot])[j], (list(other) + [eot])[j]
    ts = engine.tokenizer.timestamp_begin
    top2 = torch.topk(filt, 2).values
    gap, spread = float(filt[a] - filt[b]), float(top2[0] - top2[1])
    if math.isfinite(gap) and max(gap, spread) < TIE_TOL:
        return f"token {j}: logit gap {gap:.4f}, top-2 margin {spread:.4f}"
    check(margin is not None and abs(margin) < TIE_TOL and math.isfinite(float(before[b])),
          f"5g: window {row} at {dispatch['starts'][row]} s parts at token {j} ({a} against"
          f" {b}) beyond the tie tolerance {TIE_TOL}: logit gap {gap}, top-2 margin {spread},"
          f" the timestamp rule's margin {margin}")
    kind = torch.arange(before.shape[0]) >= ts if b >= ts else torch.arange(before.shape[0]) < ts
    best = float(before[kind].max())
    check(best - float(before[b]) < TIE_TOL, f"5g: window {row} at {dispatch['starts'][row]} s:"
          f" token {j} ({b}) is {best - float(before[b]):.4f} below the best of its kind")
    return (f"token {j}: the timestamp rule's margin {margin:.4f}, the pick"
            f" {best - float(before[b]):.4f} below the best of its kind")


def serving_trees(directory: str, seed: int, titanet_dims) -> None:
    """A seeded TitaNet tree of ``titanet_dims`` saved by the port as
    ``titanet_large.npz`` (made on the CPU, so every device loads the same
    one) and the multilingual word vocabulary, in ``directory``."""
    import torch

    from whisper_nemo_tpu_torch.engine.checkpoint import save_params
    from whisper_nemo_tpu_torch.models import titanet

    save_params(os.path.join(directory, "titanet_large.npz"), titanet.init_titanet_params(
        titanet_dims, "cpu", torch.Generator().manual_seed(seed)))
    write_word_vocab(directory, multilingual=True)


def wire_handler(stack: contextlib.ExitStack, H, model, diarization, sched, wav: str,
                 name: str) -> None:
    """The handler module ``H`` on these models within ``stack``, its
    download a fresh hard link to ``wav`` per job (the handler deletes what
    it downloads; concurrent jobs must not delete each other's input)."""
    async def fake_download(url):
        path = f"{wav}.{os.getpid()}.{time.monotonic_ns()}.wav"
        os.link(wav, path)
        return path

    for attr, value in (("whisper_model", model), ("diarization_pipeline", diarization),
                        ("window_scheduler", sched), ("download_audio_file", fake_download),
                        ("WHISPER_MODEL_NAME", name)):
        stack.enter_context(patched(H, attr, value))


async def serve_over_loopback(H, chunks) -> tuple:
    """POST /run (a transcription-only ``SERVE_JOB``) and POST /stream (the
    PCM of ``chunks()``) of the handler module ``H``, each over aiohttp's
    test server on a loopback port; (the job's JSON, the stream's
    bytes)."""
    from aiohttp import web
    from aiohttp.test_utils import TestClient, TestServer

    async def run_route(request):
        return web.json_response(await H.handler(await request.json()))

    app = web.Application()
    app.router.add_post("/run", run_route)
    app.router.add_post("/stream", H.stream_route)
    client = TestClient(TestServer(app, host="127.0.0.1"))
    await client.start_server()
    try:
        job = await client.post("/run", json={"input": {**SERVE_JOB, "transcription_only": True}})
        stream = await client.post("/stream?language=en", data=chunks())
        check(job.status == stream.status == 200, f"5g: /run {job.status}, /stream {stream.status}")
        return await job.json(), await stream.read()
    finally:
        await client.close()


def phase_serving_parity(seed: int, devices=("cuda", "cpu")) -> None:
    """5g: the serving layer at small dims (``SERVE_DIMS``, multilingual,
    "int8": kernel A on the card) on ``devices[0]`` against ``devices[1]``,
    one seeded tree on both. A ``WindowScheduler`` (batch 4, timestamped,
    ``bucket_policy="always"``, the token limits SERVE_MIN_NEW and
    SERVE_MAX_NEW) transcribes three requests in turn, sized so that
    buckets 1, 2 and 4 are each dispatched; on a CUDA device the launches
    of C (one a dispatch), B (one a dispatch and encoder layer) and A (one
    a step and decoder layer) are held to the dispatches. Then the handler
    (``serving.handler``, on the same scheduler, with the
    ``"general"``-preset diarizer on a seeded small TitaNet saved as
    ``titanet_large.npz`` and the word vocabulary in a temporary
    $WNT_MODEL_DIR) runs a full job and a transcription-only one on 60 s
    of three voices whose Laplacian has an eigengap above DIAR_GAP, the
    download stubbed with a local WAV; then the openai facade's branch
    (``WNT_SERVING_SCHEDULER=0``) and ``ndjson_lines`` on 3 s of s16 PCM;
    then, where aiohttp imports, POST /run and /stream over its test
    server on loopback (``serve_over_loopback``): /run must answer the
    transcription-only job's response. Every job must succeed. Every dispatch must hold the same windows on
    both devices and each window's tokens be equal, or part at a tie
    (``served_tie``). A job whose windows' tokens are equal must give
    responses equal apart from ``processing_time`` (``same_response``,
    CONF_TOL); a job with a window parted at a tie is run again on
    ``devices[1]`` from ``devices[0]``'s transcription, and those
    responses must be equal. The facade's and the stream's outputs are
    printed, equal or not, and held to their form."""
    import asyncio
    import importlib

    import torch

    from whisper_nemo_tpu_torch.asr.openai_api import OpenAIWhisperModel
    from whisper_nemo_tpu_torch.audio import write_wav
    from whisper_nemo_tpu_torch.diarize import SpeakerDiarizationPipeline, pipeline
    from whisper_nemo_tpu_torch.engine.transcribe import WhisperEngine
    from whisper_nemo_tpu_torch.models.whisper import WhisperDims, init_whisper_params
    from whisper_nemo_tpu_torch.ops import attention, cross_decode, mel, self_decode
    from whisper_nemo_tpu_torch.serving.scheduler import WindowScheduler
    from whisper_nemo_tpu_torch.text.tokenizer import WhisperTokenizer

    H = importlib.import_module("whisper_nemo_tpu_torch.serving.handler")
    counters = (cross_decode.cross_attention_decode_layered, attention.encoder_attention,
                mel.log_mel_raw, self_decode.self_attention_decode_ancestry_layered)
    dims = WhisperDims(*SERVE_DIMS)
    params = init_whisper_params(dims, "cpu", torch.Generator().manual_seed(seed + 90))
    requests = [voices(s, seed + 91 + i, 3) for i, s in enumerate((20.0, 50.0, 110.0))]
    rng = np.random.default_rng(seed + 95)
    pcm = [(rng.standard_normal(SR) * 3000).astype("<i2").tobytes() for _ in range(3)]
    runs = {}
    with contextlib.ExitStack() as stack:
        tmp = stack.enter_context(tempfile.TemporaryDirectory())
        stack.enter_context(model_dir(tmp))
        stack.enter_context(patched(pipeline, "_TITANET_LARGE", pipeline._TITANET_SMALL))
        serving_trees(tmp, seed + 96, pipeline._TITANET_SMALL)
        tok = WhisperTokenizer.from_dir(tmp)

        probe = SpeakerDiarizationPipeline(device=devices[1]).diarizer
        gaps = []
        for i in range(DIAR_AUDIOS):
            audio = voices(60.0, seed + 100 + i, 3)
            stats = {}
            probe.diarize_waveform(audio, max_speakers=SERVE_JOB["max_speakers"], stats=stats)
            gaps.append(stats.get("eigengap", 0.0))
            if gaps[-1] > DIAR_GAP:
                break
        check(gaps[-1] > DIAR_GAP, f"5g: no audio of {DIAR_AUDIOS} has an eigengap above"
              f" {DIAR_GAP} (gaps {gaps}; choose another --seed)")
        del probe
        wav = os.path.join(tmp, "call.wav")
        write_wav(wav, audio)

        for dev in devices:
            engine = WhisperEngine("tiny", "int8", device=dev, params=params, dims=dims,
                                   tokenizer=tok)
            sched = WindowScheduler(engine, batch_size=4, max_wait_s=0.2,
                                    without_timestamps=False, min_new_tokens=SERVE_MIN_NEW,
                                    max_new_tokens=SERVE_MAX_NEW, bucket_policy="always")
            log = []
            record_dispatches(sched, log)
            run = runs[dev] = {"log": log, "engine": engine, "sched": sched}
            cuda = torch.device(dev).type == "cuda"
            try:
                for fn in counters:
                    fn.launches = 0
                run["segments"] = [sched.transcribe(a, "en") for a in requests]
                if cuda:
                    torch.cuda.synchronize()
                    a, b, c, e = (fn.launches for fn in counters)
                    steps = sum(d["steps"] for d in log)
                    check((a, b, c, e) == (steps * dims.n_text_layer, len(log) * dims.n_audio_layer,
                                           len(log), 0),
                          f"5g: launches A {a}, B {b}, C {c}, E {e} for {len(log)} dispatches of"
                          f" {steps} steps")
                    run["launches"] = (a, b, c)
                run["sizing"] = len(log)
                model = OpenAIWhisperModel.__new__(OpenAIWhisperModel)
                model.engine, model.name = engine, "tiny"
                diar = SpeakerDiarizationPipeline(device=dev)
                stats = {}
                waveform_call = diar.diarizer.diarize_waveform
                diar.diarizer.diarize_waveform = lambda a, **kw: waveform_call(a, stats=stats, **kw)
                transcripts = run["transcripts"] = []
                for fn in counters:
                    fn.launches = 0
                with contextlib.ExitStack() as wired:
                    wire_handler(wired, H, model, diar, sched, wav, "tiny")
                    recording(wired, H, "_transcribe_via_scheduler", transcripts)
                    marks = [len(log)]
                    run["full"] = asyncio.run(H.handler({"id": "5g", "input": SERVE_JOB}))
                    marks.append(len(log))
                    run["transcription_only"] = asyncio.run(H.handler(
                        {"input": {**SERVE_JOB, "transcription_only": True}}))
                    marks.append(len(log))
                    with env_var("WNT_SERVING_SCHEDULER", "0"):
                        run["facade"] = asyncio.run(H.handler(
                            {"input": {**SERVE_JOB, "transcription_only": True}}))

                    async def chunks():
                        for c in pcm:
                            yield c

                    async def stream():
                        return [line async for line in H.ndjson_lines(chunks(), "s16", "en")]

                    run["stream"] = asyncio.run(stream())
                    run["marks"] = marks
                    if importlib.util.find_spec("aiohttp") is not None:
                        run["http"] = asyncio.run(serve_over_loopback(H, chunks))
                run["eigengap"] = stats.get("eigengap", 0.0)
                for name in ("full", "transcription_only", "facade"):
                    check(run[name]["success"] is True, f"5g on {dev}: the {name} job failed:"
                          f" {run[name].get('error')}")
                streams = [b"".join(run["stream"])]
                if "http" in run:
                    job, streamed = run["http"]
                    check(job["success"] is True, f"5g on {dev}: POST /run failed: {job}")
                    same_response(job, run["transcription_only"], CONF_TOL)
                    run["stream_http"] = streamed == streams[0]
                    streams.append(streamed)
                for text in streams:
                    lines = [json.loads(line) for line in text.splitlines()]
                    check(bool(lines) and lines[-1].get("done") is True and "text" in lines[-1]
                          and all(set(w) == {"word", "start", "end"}
                                  and w["end"] >= w["start"] >= 0 for w in lines[:-1]),
                          f"5g on {dev}: malformed NDJSON {lines[-3:]}")
                if cuda:
                    check(all(fn.launches > 0 for fn in counters[:3]),
                          f"5g: the handler's jobs launched A, B, C {[fn.launches for fn in counters[:3]]}")
            finally:
                sched.shutdown()

        gpu, cpu = (runs[d] for d in devices)
        check(gpu["eigengap"] > DIAR_GAP and cpu["eigengap"] > DIAR_GAP,
              f"5g: eigengaps {gpu['eigengap']}, {cpu['eigengap']}")
        check([(d["starts"], d["bucket"]) for d in gpu["log"]]
              == [(d["starts"], d["bucket"]) for d in cpu["log"]],
              "5g: the schedulers dispatched other batches on the two devices")
        buckets = collections.Counter(d["bucket"] for d in gpu["log"][: gpu["sizing"]])
        check({1, 2, 4} <= set(buckets), f"5g: the requests dispatched buckets {dict(buckets)},"
              " not 1, 2 and 4 (choose another --seed)")
        parted = set()
        equal = ties = 0
        notes = []
        for k, (gd, cd_) in enumerate(zip(gpu["log"], cpu["log"])):
            check(gd["n_prompt"] == cd_["n_prompt"], "5g: prompts differ")
            for row in range(len(gd["starts"])):
                n = gd["n_prompt"]
                gt = gd["tokens"][row, n: n + int(gd["lengths"][row])].tolist()
                ct = cd_["tokens"][row, n: n + int(cd_["lengths"][row])].tolist()
                check(len(gt) >= SERVE_MIN_NEW and len(ct) >= SERVE_MIN_NEW,
                      f"5g: a window decoded {len(gt)} / {len(ct)} tokens, under the minimum")
                if gt == ct:
                    equal += 1
                    continue
                ties += 1
                parted.add(k)
                notes.append(f"dispatch {k} window {row}: " + served_tie(
                    cpu["engine"], cd_, row, ct, gt, cpu["sched"]._suppress, SERVE_MIN_NEW))
        for note in notes:
            print(f"  {note}")
        held = []
        for i, (name, (lo, hi)) in enumerate((("full", gpu["marks"][:2]),
                                              ("transcription_only", gpu["marks"][1:]))):
            if not parted & set(range(lo, hi)):
                same_response(gpu[name], cpu[name], CONF_TOL)
                held.append(f"{name} equal")
                continue
            # a window parted at a tie: the CPU's diarization and post-processing from the
            # GPU's transcription
            with contextlib.ExitStack() as wired:
                model = OpenAIWhisperModel.__new__(OpenAIWhisperModel)
                model.engine, model.name = cpu["engine"], "tiny"
                wire_handler(wired, H, model, SpeakerDiarizationPipeline(device=devices[1]),
                             None, wav, "tiny")
                transcript = gpu["transcripts"][i][1]
                wired.enter_context(patched(H, "_transcribe_via_scheduler",
                                            lambda *a: transcript))
                wired.enter_context(patched(H, "window_scheduler", cpu["sched"]))
                again = asyncio.run(H.handler(
                    {"input": {**SERVE_JOB, "transcription_only": name != "full"}}))
            check(again["success"] is True, f"5g: the {name} job failed again: {again}")
            same_response(gpu[name], again, CONF_TOL)
            held.append(f"{name} equal from the GPU's transcription (a window parted at a tie)")
    full = gpu["full"]
    launches = (f"launches A {gpu['launches'][0]}, B {gpu['launches'][1]}, C {gpu['launches'][2]}"
                if "launches" in gpu else "no CUDA device in this run")
    print(f"[5g serving parity] WindowScheduler batch 4, \"always\", timestamped, tokens"
          f" {SERVE_MIN_NEW}-{SERVE_MAX_NEW}, int8 at small dims, {devices[0]} against"
          f" {devices[1]}: {len(gpu['log'])} dispatches (buckets {dict(sorted(buckets.items()))}"
          f" for the three requests), {equal} windows token-equal, {ties} parted at a tie |"
          f" {launches} over the three requests | handler: {'; '.join(held)} ("
          f"{len(full['segments_detailles'])} segments, {full['statistiques']['speakers_detectes']}"
          f" speakers, eigengaps {', '.join(f'{g:.4f}' for g in gaps)}) | facade branch"
          f" {'equal' if _drop_time(gpu['facade']) == _drop_time(cpu['facade']) else 'differs'}"
          f" | NDJSON over 3 s of s16 PCM: {len(gpu['stream'])} lines,"
          f" {'equal' if gpu['stream'] == cpu['stream'] else 'differ'} between the devices |"
          + (f" over aiohttp on loopback: /run as the direct job, /stream"
             f" {'equal to' if gpu['stream_http'] else 'other than'} the direct call (the route"
             " regroups the PCM as it arrives)"
             if "http" in gpu else " aiohttp absent: /run and /stream not served"))


def _drop_time(response: dict) -> dict:
    return {k: v for k, v in response.items() if k != "processing_time"}


def phase_serving_main(seed: int, smi: str) -> dict:
    """6h: the serverless handler at full width, its defaults: a temporary
    $WNT_MODEL_DIR holds a seeded TitaNet-large tree and the multilingual
    word vocabulary; ``serving.handler.load_models(warm=False)`` loads
    Whisper large-v2 at ``WNT_SERVING_COMPUTE``'s default, int8 (int8
    linears, the int8 cross-KV: kernel A), a seeded random init on the
    card, and the ``"general"``-preset diarizer; the scheduler is rebuilt
    at ``WNT_SERVING_BATCH``'s default, 16, timestamped, two-tier, with
    bench.py's token limits HANDLER_MIN_NEW-HANDLER_MAX_NEW (random
    weights never emit EOT); then ``warmup()`` (timed), four requests of
    one 30 s window (the first and the steady latency), one job of
    JOB_SECONDS of four voices alone, then four such jobs submitted
    together (``asyncio.gather`` of ``handler(job)``), the download
    stubbed with a hard link to a local WAV. Every kernel's count is set
    to 0 just before the lone job and read just after the four; C must
    launch once a dispatch, B once a dispatch and encoder layer, A once a
    decode step and decoder layer, D, E and F never; each launch's shape
    is recorded (``recording_launches``). Prints the walls, seconds per
    audio hour, windows, dispatches by pad size, the diarization's share,
    the peak device memory and the launches by shape."""
    import asyncio
    import importlib

    import torch

    from whisper_nemo_tpu_torch.audio import write_wav
    from whisper_nemo_tpu_torch.diarize import pipeline
    from whisper_nemo_tpu_torch.models.whisper import WHISPER_DIMS
    from whisper_nemo_tpu_torch.ops import attention, beam_permute, cross_decode, ctc, mel, self_decode
    from whisper_nemo_tpu_torch.serving.scheduler import WindowScheduler

    H = importlib.import_module("whisper_nemo_tpu_torch.serving.handler")
    counters = (cross_decode.cross_attention_decode_layered, attention.encoder_attention,
                mel.log_mel_raw, ctc.viterbi_batch, self_decode.self_attention_decode_ancestry_layered,
                beam_permute.beam_permute_cache, beam_permute.beam_permute_cache_inplace)
    knobs = ("WNT_SERVING_COMPUTE", "WNT_SERVING_BATCH", "WNT_SERVING_BUCKETS",
             "WNT_SERVING_BUCKET_POLICY", "WNT_SERVING_SCHEDULER")
    check(not any(k in os.environ for k in knobs), f"6h runs the handler's defaults: unset {knobs}")
    sync = torch.cuda.synchronize
    out = {}
    with contextlib.ExitStack() as stack:
        tmp = stack.enter_context(tempfile.TemporaryDirectory())
        models = os.path.join(tmp, "models")
        os.makedirs(models)
        stack.enter_context(model_dir(models))
        t0 = time.time()
        serving_trees(models, seed + 80, pipeline._TITANET_LARGE)
        trees_s = time.time() - t0
        stack.enter_context(patched(H, "WHISPER_MODEL_NAME", "large-v2"))
        t0 = time.time()
        H.load_models(warm=False)
        sync()
        load_s = time.time() - t0
        eng = H.whisper_model.engine
        try:
            check(eng.dims == WHISPER_DIMS["large-v2"] and eng.dtype == torch.bfloat16
                  and eng.cross_kv_bits == 8 and "out_proj_q" in eng.params["decoder"],
                  "6h: the handler did not load large-v2 at int8")
            check(H.diarization_pipeline.diarizer.spk_dims == pipeline._TITANET_LARGE
                  and H.diarization_pipeline.diarizer.cfg.diarizer.msdd_model.model_path is None,
                  "6h: the diarizer is not the general preset on TitaNet-large")
            check(H.window_scheduler.batch_size == 16, "6h: the scheduler's batch is not 16")
            H.window_scheduler.shutdown()
            sched = H.window_scheduler = WindowScheduler(
                eng, batch_size=16, without_timestamps=False, min_new_tokens=HANDLER_MIN_NEW,
                max_new_tokens=HANDLER_MAX_NEW)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            H.warmup()
            sync()
            warm_s = time.time() - t0

            request = voices(30.0, seed + 81, 4)
            latency = []
            for _ in range(4):
                t0 = time.time()
                check(bool(sched.transcribe(request, "en")), "6h: a 30 s request gave no segment")
                latency.append(time.time() - t0)

            wav = os.path.join(tmp, "job.wav")
            write_wav(wav, voices(JOB_SECONDS, seed + 82, 4))
            log, asr, diar = [], [], []
            record_dispatches(sched, log)
            recording(stack, H, "_transcribe_via_scheduler", asr)
            recording(stack, H, "_diarization_turns", diar)
            wire_handler(stack, H, H.whisper_model, H.diarization_pipeline, sched, wav,
                         "large-v2")
            shapes = recording_launches(stack)

            async def jobs(n):
                return await asyncio.gather(*(H.handler({"id": f"6h-{i}", "input": {
                    **SERVE_JOB, "max_speakers": 4}}) for i in range(n)))

            for fn in counters:
                fn.launches = 0
            sync()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.time()
            alone = asyncio.run(jobs(1))
            sync()
            alone_s = time.time() - t0
            lone_log = len(log)
            t0 = time.time()
            four = asyncio.run(jobs(4))
            sync()
            four_s = time.time() - t0
            launches = [fn.launches for fn in counters]
            peak = torch.cuda.max_memory_allocated() / 2**30
            shapes = {k: collections.Counter(v) for k, v in shapes.items()}
            step = decode_step_times(eng, request, sched.batch_size,
                                     len(eng._prompt("en", False, None)[0]) + HANDLER_MAX_NEW)
        finally:
            H.window_scheduler.shutdown()
            eng.unload()
    H.whisper_model = H.diarization_pipeline = H.window_scheduler = None
    torch.cuda.empty_cache()

    for r in alone + four:
        check(r["success"] is True, f"6h: a job failed: {r.get('error')}")
        check(len(r["segments_detailles"]) > 0 and r["statistiques"]["speakers_detectes"] > 0,
              "6h: a job's response holds no segment or no speaker")
    a, b, c, d, e, *f = launches
    steps = sum(x["steps"] for x in log)
    check((c, b, a) == (len(log), len(log) * eng.dims.n_audio_layer, steps * eng.dims.n_text_layer)
          and d == e == 0 and f == [0, 0],
          f"6h: launches {launches} for {len(log)} dispatches of {steps} steps")
    check([sum(shapes[k].values()) for k in "ABCDE"] == [a, b, c, d, e],
          "6h: the recorded launches are not the counts")
    windows = sum(len(x["starts"]) for x in log[:lone_log])
    pads = [collections.Counter(x["bucket"] for x in part) for part in (log[:lone_log],
                                                                        log[lone_log:])]
    diar_alone = diar[0][0]
    r = alone[0]
    print(f"[6h serving] {smi} | load_models(warm=False): Whisper large-v2 int8 (seeded random"
          f" init on the card; the trees and vocabulary written in {trees_s:.1f} s) and the"
          f" general-preset diarizer on TitaNet-large in {load_s:.1f} s; scheduler batch 16,"
          f" timestamped, two-tier, tokens {HANDLER_MIN_NEW}-{HANDLER_MAX_NEW} | warmup()"
          f" {warm_s:.2f} s (buckets {sched._buckets()} and a 1 s request) | one 30 s window:"
          f" first {latency[0]:.3f} s, steady {min(latency[1:]):.3f} s"
          f" ({', '.join(f'{x:.3f}' for x in latency)})")
    print(f"[6h serving] one job of {JOB_SECONDS:.0f} s of four voices alone: wall {alone_s:.2f} s"
          f" ({alone_s / JOB_SECONDS * 3600:.1f} s per audio hour; processing_time"
          f" {r['processing_time']:.2f} s), {windows} windows in {lone_log} dispatches (pad sizes"
          f" {dict(sorted(pads[0].items()))}), ASR {asr[0][0]:.2f} s, diarization"
          f" {diar_alone:.2f} s ({diar_alone / alone_s:.0%} of the wall),"
          f" {len(r['segments_detailles'])} segments, {r['statistiques']['speakers_detectes']}"
          f" speakers")
    print(f"[6h serving] four such jobs together: wall {four_s:.2f} s ({four_s / 4:.2f} s a job,"
          f" {four_s / (4 * JOB_SECONDS) * 3600:.1f} s per audio hour; processing_time"
          f" {', '.join(f'{x['processing_time']:.2f}' for x in four)} s), {len(log) - lone_log}"
          f" dispatches (pad sizes {dict(sorted(pads[1].items()))}), diarizations"
          f" {', '.join(f'{t:.2f}' for t, *_ in diar[1:])} s | peak device memory {peak:.2f} GiB"
          f" ({held / 2**30:.2f} held before the jobs) | launches over the five jobs: A {a}"
          f" (= {steps} steps x {eng.dims.n_text_layer}), B {b}, C {c} (= {len(log)} dispatches),"
          f" D, E, F 0")
    for letter in "ABC":
        for key, n in sorted(shapes[letter].items(), key=str):
            print(f"  6h kernel {letter}: {n} launches at {key}")
    print(f"[6h serving] a full dispatch, measured apart: encoder {step['encoder_ms']:.2f} ms"
          f" (B=16), greedy decode step {step['step_ms']:.3f} ms (CUDA events); host enqueues a"
          f" step in {step['enqueue_ms']:.3f} ms, device done {step['done_ms']:.3f} ms after the"
          f" first enqueue, per step (the decoder alone: the serving step also filters its"
          f" logits by the timestamp rules) | torch.profiler: {fmt_profile(step['profile'])}")
    out.update(shapes=shapes, launches=launches, alone_s=alone_s, four_s=four_s,
               latency=latency, warm_s=warm_s, peak=peak, step=step)
    return out


def decode_step_times(eng, audio: np.ndarray, batch: int, cache_positions: int) -> dict:
    """The encoder's ms on ``batch`` copies of the 30 s ``audio``, and a
    greedy decoder step's over their int8 cross-KV (``decode_step_stacked``
    alone, as phase 6b measures it): CUDA events, the host's time to
    enqueue 50 steps against the device's to finish them, and the
    profiler's device time by kernel. These launches are not counted."""
    import torch

    from whisper_nemo_tpu_torch.models.whisper_stacked import (
        cross_kv_for_decode,
        decode_step_stacked,
        init_stacked_cache,
    )
    from whisper_nemo_tpu_torch.ops import mel

    dev = eng.device
    waves = torch.from_numpy(np.stack([audio[: mel.N_SAMPLES]] * batch)).to(dev)
    with torch.inference_mode():
        mels = mel.log_mel_spectrogram_batch(waves, eng.dims.n_mels)
        encoder_ms = cuda_ms(lambda i=0: eng.encode_windows(mels), 3)
        ckv = cross_kv_for_decode(eng.params, eng.encode_windows(mels), eng.dims,
                                  eng.cross_kv_bits)
        cache_len = -(-cache_positions // 128) * 128
        cache = init_stacked_cache(batch, eng.dims, eng.dtype, cache_len, dev)
        tok = torch.full((batch,), 220, device=dev)

        def step(i=0):
            return decode_step_stacked(eng.params, tok, 4 + i % (cache_len - 8), cache, ckv,
                                       eng.dims, eng.dtype, return_hidden=True)

        step_ms = cuda_ms(step, 50)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(50):
            step(i)
        enqueue_ms = (time.perf_counter() - t0) * 1e3 / 50
        torch.cuda.synchronize()
        done_ms = (time.perf_counter() - t0) * 1e3 / 50
        profile = profiled_device_ms(step, 5)
    return {"encoder_ms": encoder_ms, "step_ms": step_ms, "enqueue_ms": enqueue_ms,
            "done_ms": done_ms, "profile": profile}


def phase_serving_kernels(run: dict, seed: int) -> list:
    """6i: kernels A, B and C held against their plain versions at every
    shape 6h launched them at (``hold_launched_shape``), timed, with SDPA
    beside B; returns their JSON entries, one a shape, with 6h's launches."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed + 83)
    entries = []
    for letter in "ABC":
        for shape, n in sorted(run["shapes"][letter].items(), key=str):
            desc, r = hold_launched_shape(letter, shape, g, seed + 84, f"{n} launches in 6h",
                                          "6i")
            entries.append(kernel_entry(letter, f"the serving handler, 6h: {desc}", n, r))
    return entries


# -- the parallel CLI flow (phases 5h and 6j) ---------------------------------

def phase_parallel_parity(seed: int, devices=("cuda",)) -> None:
    """5h: the parallel CLI flow against the sequential one on
    ``devices[0]`` at the same arguments and small dims: tiny.en (random,
    seeded on the device) at ``--device auto`` ("default"; ``--device cpu``
    for a CPU rehearsal), batch 4, the aligner and the punctuation model at
    their small dims, the compact seeded TitaNet (no checkpoint, so the
    child process makes the same one from the same seed), the telephonic
    MSDD, in a temporary $WNT_MODEL_DIR with the word vocabulary, on 60 s
    of three voices. ``run_sequential``, then ``run_parallel`` in process
    (two threads, on the card each on a CUDA stream of its own), then
    ``run_parallel --subprocess-diarization`` (the diarizer in ``python -m
    whisper_nemo_tpu_torch.cli.nemo_process``): each parallel run's .txt
    and .srt bytes must equal the sequential run's. Where they differ,
    look first for a race between the two streams."""
    import torch

    from whisper_nemo_tpu_torch.audio import write_wav
    from whisper_nemo_tpu_torch.cli import flow
    from whisper_nemo_tpu_torch.models import punctuation

    dev = devices[0]
    device_flag = "auto" if torch.device(dev).type == "cuda" else dev
    small_xlmr = functools.partial(punctuation.XlmRobertaDims, **vars(punctuation.SMALL_DIMS))
    audio = voices(60.0, seed + 60, 3)
    got, walls = {}, {}
    with contextlib.ExitStack() as stack:
        tmp = stack.enter_context(tempfile.TemporaryDirectory())
        models = os.path.join(tmp, "models")
        os.makedirs(models)
        stack.enter_context(model_dir(models))
        stack.enter_context(env_var("WNT_TEST_SMALL_MODELS", "1"))
        stack.enter_context(patched(punctuation, "XlmRobertaDims", small_xlmr))
        flow_trees(models, seed)
        os.remove(os.path.join(models, "titanet_large.npz"))
        for name, parallel, extra in (("sequential", False, []), ("in process", True, []),
                                      ("child diarizer", True, ["--subprocess-diarization"])):
            work = os.path.join(tmp, name.replace(" ", "_"))
            os.makedirs(work)
            path = os.path.join(work, "call.wav")
            write_wav(path, audio)
            args = flow.build_arg_parser(parallel).parse_args(
                ["-a", path, "--whisper-model", "tiny.en", "--batch-size", "4", "--no-stem",
                 "--device", device_flag, *extra])
            with contextlib.chdir(work):
                t0 = time.time()
                (flow.run_parallel if parallel else flow.run_sequential)(args)
                walls[name] = time.time() - t0
            got[name] = check_outputs(os.path.join(work, "call"), 60.0, f"5h {name}")
            check(not os.path.exists(os.path.join(work, "temp_outputs")),
                  f"5h {name}: temp_outputs was left behind")
    check(got["sequential"]["words"] > 20 and len(got["sequential"]["speakers"]) > 1,
          f"5h: the sequential run wrote {got['sequential']['words']} words of"
          f" {len(got['sequential']['speakers'])} speakers")
    for name in ("in process", "child diarizer"):
        check(got[name]["raw"] == got["sequential"]["raw"],
              f"5h: the {name} run's .txt or .srt bytes differ from the sequential run's")
    print(f"[5h parallel parity] tiny.en (random) --batch-size 4 --no-stem --device {device_flag}"
          f" on {dev}, 60 s of 3 voices: run_sequential {walls['sequential']:.1f} s, run_parallel"
          f" in process {walls['in process']:.1f} s, with --subprocess-diarization"
          f" {walls['child diarizer']:.1f} s | .txt and .srt bytes of both parallel runs equal"
          f" to the sequential run's ({got['sequential']['cues']} cues,"
          f" {got['sequential']['words']} words, {len(got['sequential']['speakers'])} speakers)")


def fmt_shapes(shapes: dict) -> str:
    """Each kernel's recorded launches by shape (``recording_launches``);
    kernel E's summed over the visible lengths of one cache shape."""
    parts = []
    for letter, seen in shapes.items():
        if letter == "E":
            groups = collections.Counter()
            for key, n in seen.items():
                groups[key[:-1]] += n
            seen = groups
        if seen:
            parts.append(f"{letter}: " + ", ".join(f"{key} x {n}" for key, n in seen.items()))
    return "; ".join(parts)


# 6j: diarize_parallel.py's defaults (large-v2, batch 4) at --device auto and
# --no-stem; English named, as random weights detect an arbitrary language
PARALLEL_ARGV = ["--no-stem", "--device", "auto", "--language", "en"]


def phase_parallel_main(seed: int, smi: str) -> tuple:
    """6j: the parallel CLI flow at full width, diarize_parallel.py's
    defaults at ``--device auto --no-stem`` (Whisper large-v2 at its
    published dims, "default": f32, the float cross-KV, kernel B's split
    f32 path on every encoder layer; beam 5, batch 4; the MMS-300M-sized
    aligner in bf16; TitaNet-large and the telephonic MSDD from seeded
    checkpoints; XLM-R base), ``--language en`` (random weights), on phase
    6f's audio (FLOW_SECONDS of four voices). Three runs, each from its
    own directory: ``run_sequential`` at the same arguments, the control;
    ``run_parallel`` in process (``run_flow``: counts zeroed just before
    and read just after, each launch's shape recorded, the launches held
    to the ASR branch's batches, steps and groups, so the diarizer
    launched none); then ``python3 -m whisper_nemo_tpu_torch.cli.parallel
    -a <CLI_SECONDS wav> --no-stem --language en --subprocess-diarization``
    as a new process (exit 0, both files well formed). Prints the walls
    and seconds per audio hour, each branch's stage times, the
    diarization time the overlap hid (the control's stage sum minus the
    parallel wall), peak device memory, each kernel's launches by shape,
    and whether the parallel run's bytes equal the control's. Then the
    kernels at the shapes both runs launched (``phase_flow_kernels``
    under 6j). Returns (both runs, the JSON entries of the parallel run's
    kernels)."""
    import torch

    from whisper_nemo_tpu_torch.audio import write_wav
    from whisper_nemo_tpu_torch.diarize import pipeline
    from whisper_nemo_tpu_torch.engine.checkpoint import save_params
    from whisper_nemo_tpu_torch.models import msdd, titanet

    runs = {}
    with contextlib.ExitStack() as stack:
        tmp = stack.enter_context(tempfile.TemporaryDirectory())
        models = os.path.join(tmp, "models")
        os.makedirs(models)
        stack.enter_context(model_dir(models))
        g = torch.Generator().manual_seed(seed + 70)
        save_params(os.path.join(models, "titanet_large.npz"),
                    titanet.init_titanet_params(pipeline._TITANET_LARGE, "cpu", g))
        save_params(os.path.join(models, "diar_msdd_telephonic.npz"),
                    msdd.init_msdd_params(msdd.MsddDims(), "cpu", g))
        write_word_vocab(models, multilingual=True)
        audio = voices(FLOW_SECONDS, seed + 71, 4)
        for name, parallel, argv in (
                ("sequential", False, ["--whisper-model", "large-v2", "--batch-size", "4"]),
                ("in process", True, [])):
            work = os.path.join(tmp, name.replace(" ", "_"))
            os.makedirs(work)
            path = os.path.join(work, "call.wav")
            write_wav(path, audio)
            r = runs[name] = run_flow(["-a", path, *argv, *PARALLEL_ARGV], path, FLOW_SECONDS,
                                      work, f"6j {name}", parallel=parallel)
            check(r["dtype"] == torch.float32 and r["kv_bits"] is None
                  and r["layers"][:2] == (32, 32), f"6j {name}: not large-v2 at \"default\"")
            check(r["launches"]["a"] == 0, f"6j {name}: kernel A launched {r['launches']['a']}"
                  f" times over the float cross-KV")
            torch.cuda.empty_cache()
        seq, par = runs["sequential"], runs["in process"]
        check(par["launches"] == seq["launches"] and par["shapes"] == seq["shapes"],
              f"6j: the parallel run launched {par['launches']}, the control {seq['launches']}")

        user = os.path.join(tmp, "user")
        os.makedirs(user)
        user_path = os.path.join(user, "cli.wav")
        write_wav(user_path, voices(CLI_SECONDS, seed + 72, 4))
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "whisper_nemo_tpu_torch.cli.parallel", "-a", user_path,
             "--no-stem", "--language", "en", "--subprocess-diarization"], cwd=user,
            capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))})
        cli_s = time.time() - t0
        check(proc.returncode == 0, f"6j: the parallel CLI exited {proc.returncode}:"
              f" {proc.stderr[-2000:]}")
        cli = check_outputs(os.path.splitext(user_path)[0], CLI_SECONDS, "6j CLI")
        check(not os.path.exists(os.path.join(user, "temp_outputs")),
              "6j CLI: temp_outputs was left behind")

    stage_sum = sum(v for k, v in seq["stages"].items() if k != "of it the model's set-up")
    st = par["stages"]
    setup = st["of it the model's set-up"]
    asr_branch = st["ASR"] + st["alignment"]
    print(f"[6j parallel flow] {smi} | run_sequential --whisper-model large-v2 --batch-size 4"
          f" {' '.join(PARALLEL_ARGV)} on {FLOW_SECONDS:.0f} s of four voices (the control):"
          f" {fmt_flow(seq, FLOW_SECONDS)}")
    print(f"[6j parallel flow] {smi} | run_parallel {' '.join(PARALLEL_ARGV)} (its defaults:"
          f" large-v2, batch 4) in process: {fmt_flow(par, FLOW_SECONDS)}")
    print(f"[6j parallel flow] walls: control {seq['wall']:.2f} s"
          f" ({seq['wall'] / FLOW_SECONDS * 3600:.1f} s per audio hour), parallel"
          f" {par['wall']:.2f} s ({par['wall'] / FLOW_SECONDS * 3600:.1f}) | the ASR branch:"
          f" ASR {st['ASR']:.3f} s (model set-up {setup:.3f})"
          f" + alignment {st['alignment']:.3f} = {asr_branch:.3f} s; the diarization branch"
          f" {st['diarization']:.3f} s (control {seq['stages']['diarization']:.3f}) | hidden by"
          f" the overlap: control stage sum {stage_sum:.3f} - parallel wall {par['wall']:.3f} ="
          f" {stage_sum - par['wall']:.3f} s | peak device memory {par['peak']:.2f} GiB"
          f" (control {seq['peak']:.2f}) | .txt and .srt bytes"
          f" {'equal to' if par['out']['raw'] == seq['out']['raw'] else 'differ from'} the"
          f" control's | launches by shape: {fmt_shapes(par['shapes'])}")
    print(f"[6j parallel flow] {smi} | python3 -m whisper_nemo_tpu_torch.cli.parallel -a"
          f" <{CLI_SECONDS:.0f} s wav> --no-stem --language en --subprocess-diarization: exit 0"
          f" in {cli_s:.1f} s (a new process and its diarizer child: imports, every model's"
          f" set-up and the kernels' loads included) | {cli['cues']} cues,"
          f" {len(cli['speakers'])} speakers")
    entries = phase_flow_kernels(runs, seed + 5, tag="6j",
                                 entry=lambda run, letter: run == "in process",
                                 label=lambda run: "the parallel CLI flow, 6j in process")
    return runs, entries


# -- config 3 and the pyannote stages (phases 5i, 6k, 6l and 6m) --------------

# htdemucs at small dims (5f, 5i; tests/test_torch_separation.py's)
DEMUCS_SMALL = dict(channels=4, depth=4, nfft=512, bottom_channels=32, t_layers=3, segment=0.5,
                    samplerate=16000)
DEMUCS_TOL = 1e-4  # htdemucs' outputs, relative to the largest: f32 sums in other orders
RESAMPLE_TOL = 1e-5  # the polyphase resample's outputs
PROB_TOL = 1e-5  # PyanNet's speech probabilities
# 5i: PyanNet and ECAPA at tests/test_torch_pyannote_ecapa.py's widths (80 mel bands)
PYANNET_SMALL = dict(lstm_layers=2, hidden=16)
ECAPA_SMALL = dict(channels=32, agg_channels=48, res2net_scale=4, se_reduction=4, attn_hidden=16,
                   emb_dim=20)
# 6k: BASELINE config 3 (bench.py --model large-v3 --demucs --domain meeting) through the
# CLI: stemming on, --device auto ("default"), beam 5, batch 8; English named, as random
# weights detect an arbitrary language
CONFIG3_ARGV = ["--whisper-model", "large-v3", "--domain", "meeting", "--language", "en"]
PYANNOTE_SECONDS = 900.0  # 6m's audio: fifteen minutes of four voices
PYANNOTE_CPU_SECONDS = 120.0  # 6m's turns, held against the CPU on its first two minutes


def rel_err(got, want) -> float:
    """max|got - want| over max|want|, on the CPU."""
    got, want = got.detach().cpu().float(), want.detach().cpu().float()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def phase_separation_parity(seed: int, devices=("cuda", "cpu")) -> None:
    """5i: the new modules of config 3 and the pyannote stages at small
    dims, ``devices[0]`` against ``devices[1]`` on the same seeded trees
    and inputs, f32 with TF32 off: htdemucs at DEMUCS_SMALL (the forward
    on two mixes of 8,000 samples, and ``apply_segments`` over 47,500
    samples in 8 windows, 3 a batch, the last zero-padded) within
    DEMUCS_TOL; ``resample_poly`` 44.1 kHz -> 16 kHz on 10 s within
    RESAMPLE_TOL; PyanNet's ``speech_probs`` on two 3 s waveforms within
    PROB_TOL; ECAPA's embeddings of windows of 1, 23 and 40 valid frames
    within DIAR_EMB_TOL of the largest. Phase 5f runs the separator inside
    the CLI flow."""
    import torch

    from whisper_nemo_tpu_torch.engine.checkpoint import to_device
    from whisper_nemo_tpu_torch.engine.precision import full_f32
    from whisper_nemo_tpu_torch.models import ecapa, htdemucs, pyannet
    from whisper_nemo_tpu_torch.ops.resample import resample_poly

    g = torch.Generator().manual_seed(seed + 80)
    ddims, edims = htdemucs.HTDemucsDims(**DEMUCS_SMALL), ecapa.EcapaDims(**ECAPA_SMALL)
    trees = {"htdemucs": htdemucs.init_htdemucs_params(ddims, "cpu", g),
             "pyannet": pyannet.init_pyannet_params("cpu", g, **PYANNET_SMALL),
             "ecapa": ecapa.init_ecapa_params(edims, "cpu", g)}
    rng = np.random.default_rng(seed + 81)
    inputs = {"mix": 0.2 * rng.standard_normal((2, 2, 8000)),
              "long_mix": 0.2 * rng.standard_normal((2, 47_500)),
              "wave44": rng.standard_normal(441_000),
              "waves": voices(6.0, seed + 82).reshape(2, -1),
              "feats": rng.standard_normal((3, edims.n_mels, 40))}
    lengths = [1, 23, 40]
    outs = {}
    for dev in devices:
        t = to_device(trees, dev)
        x = {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev) for k, v in inputs.items()}
        with full_f32(), torch.inference_mode():
            outs[dev] = {
                "htdemucs_forward": htdemucs.htdemucs_forward(t["htdemucs"], x["mix"], ddims),
                "apply_segments": htdemucs.apply_segments(t["htdemucs"], x["long_mix"], ddims,
                                                          batch_size=3, device_out=True),
                "resample_poly": resample_poly(x["wave44"], 44100, 16000),
                "speech_probs": pyannet.speech_probs(t["pyannet"], x["waves"]),
                "ecapa": ecapa.embed(t["ecapa"], x["feats"], torch.tensor(lengths, device=dev),
                                     edims)}
    gpu, cpu = (outs[d] for d in devices)
    relative = ("htdemucs_forward", "apply_segments", "ecapa")
    errs = {k: rel_err(gpu[k], cpu[k]) for k in relative}
    errs |= {k: float((gpu[k].cpu() - cpu[k]).abs().max()) for k in ("resample_poly",
                                                                       "speech_probs")}
    bounds = {"htdemucs_forward": DEMUCS_TOL, "apply_segments": DEMUCS_TOL,
              "ecapa": DIAR_EMB_TOL, "resample_poly": RESAMPLE_TOL, "speech_probs": PROB_TOL}
    for k, err in errs.items():
        check(gpu[k].shape == cpu[k].shape and bool(torch.isfinite(gpu[k]).all()),
              f"5i {k}: shape {tuple(gpu[k].shape)} against {tuple(cpu[k].shape)}, or not finite")
        check(err <= bounds[k], f"5i {k}: {err:.3e} between {devices[0]} and {devices[1]}"
              f" (limit {bounds[k]})")
    print(f"[5i separation and pyannote parity] {devices[0]} against {devices[1]}, f32 (TF32 off):"
          + "; ".join(f" {k} {tuple(gpu[k].shape)} {err:.2e}"
                      f" ({'relative' if k in relative else 'absolute'},"
                      f" limit {bounds[k]})" for k, err in errs.items()))


def phase_config3_main(seed: int, smi: str) -> dict:
    """6k: BASELINE config 3 through the CLI flow at full width, in process
    (``run_flow``): ``run_sequential`` with CONFIG3_ARGV and the CLI's
    other defaults (stemming on, ``--device auto``: large-v3 at "default",
    f32 with the float cross-KV, kernel A held at 0; beam 5, batch 8) on a
    WAV of FLOW_SECONDS of four voices. $WNT_MODEL_DIR holds a seeded
    full-size ``htdemucs.npz`` (``HTDemucsDims()``: 48 channels, depth 4,
    nfft 4096, 5 transformer layers, 44.1 kHz) with its sidecar,
    TitaNet-large, the meeting preset's MSDD (6 scales) and the word
    vocabulary; Whisper, the aligner and XLM-R are seeded random inits.
    Prints the wall, each stage's seconds (separation apart), peak device
    memory and every kernel's launches by shape. Then bench.py's device
    handoff on the same audio: ``apply_segments`` of the stereo mix at
    44.1 kHz with ``source_indices=(vocals,)`` left on the card, its mono
    mix and ``resample_poly`` to 16 kHz, timed alone after a synchronise;
    and the resample alone by CUDA events beside its bound. Returns the
    flow's run (``phase_flow_kernels`` holds its kernels' shapes, 6l)."""
    import torch

    from whisper_nemo_tpu_torch.audio import decode_audio, write_wav
    from whisper_nemo_tpu_torch.diarize import pipeline
    from whisper_nemo_tpu_torch.engine.checkpoint import save_params
    from whisper_nemo_tpu_torch.engine.precision import full_f32
    from whisper_nemo_tpu_torch.models import htdemucs, msdd, titanet
    from whisper_nemo_tpu_torch.ops.resample import _polyphase_matrix, resample_poly

    with contextlib.ExitStack() as stack:
        tmp = stack.enter_context(tempfile.TemporaryDirectory())
        models = os.path.join(tmp, "models")
        work = os.path.join(tmp, "work")
        os.makedirs(models)
        os.makedirs(work)
        stack.enter_context(model_dir(models))
        ddims = htdemucs.HTDemucsDims()
        save_params(os.path.join(models, "htdemucs.npz"), htdemucs.init_htdemucs_params(
            ddims, "cpu", torch.Generator().manual_seed(seed + 90)))
        with open(os.path.join(models, "htdemucs.cfg.json"), "w") as f:
            json.dump({"sources": list(ddims.sources), "segment": ddims.segment,
                       "samplerate": ddims.samplerate}, f)
        g = torch.Generator().manual_seed(seed + 70)
        save_params(os.path.join(models, "titanet_large.npz"),
                    titanet.init_titanet_params(pipeline._TITANET_LARGE, "cpu", g))
        save_params(os.path.join(models, "diar_msdd_telephonic.npz"),
                    msdd.init_msdd_params(msdd.MsddDims(n_scales=6), "cpu", g))
        write_word_vocab(models, multilingual=True)
        audio_path = os.path.join(work, "call.wav")
        write_wav(audio_path, voices(FLOW_SECONDS, seed + 71, 4))

        run = run_flow(["-a", audio_path, *CONFIG3_ARGV], audio_path, FLOW_SECONDS, work, "6k")
        check(run["dtype"] == torch.float32 and run["kv_bits"] is None
              and run["layers"][:2] == (32, 32), "6k: not large-v3 at \"default\"")
        check(run["launches"]["a"] == 0, f"6k: kernel A launched {run['launches']['a']} times"
              f" over the float cross-KV")
        print(f"[6k config 3] {smi} | run_sequential {' '.join(CONFIG3_ARGV)} (stemming on,"
              f" --device auto: \"default\", beam 5, batch 8) on {FLOW_SECONDS:.0f} s of four voices:"
              f" {fmt_flow(run, FLOW_SECONDS)} | launches by shape: {fmt_shapes(run['shapes'])}")
        torch.cuda.empty_cache()

        params, dims = htdemucs.load_htdemucs(models, "cuda")
        check(dims == ddims, f"6k: the checkpoint reads as {dims}")
        mix44 = decode_audio(audio_path, sampling_rate=dims.samplerate)
        stereo = torch.from_numpy(np.stack([mix44] * dims.audio_channels)).cuda()
        seg = int(dims.segment * dims.samplerate)
        windows = math.ceil(max(stereo.shape[-1] - seg, 0) / int(0.75 * seg)) + 1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with full_f32(), torch.inference_mode():
            vocals = htdemucs.apply_segments(params, stereo, dims,
                                             source_indices=(dims.sources.index("vocals"),),
                                             device_out=True)
            mono = vocals[0].mean(dim=0)
            v16 = resample_poly(mono, dims.samplerate, 16000)
            torch.cuda.synchronize()
            handoff_s = time.time() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            resample_ms = cuda_ms(lambda i=0: resample_poly(mono, dims.samplerate, 16000), 10)
        check(tuple(v16.shape) == (int(FLOW_SECONDS * 16000),) and bool(torch.isfinite(v16).all()),
              f"6k: the handoff gave {tuple(v16.shape)} samples, or not finite")
        mat, _, width = _polyphase_matrix(160, 441)
        blocks = math.ceil(v16.shape[0] / 160)
        flops = 2.0 * blocks * width * 160
        bound_ms = max(4.0 * (mono.numel() + v16.numel()) / HBM_BYTES_S,
                       flops / F32_FLOPS) * 1e3
        print(f"[6k config 3] {smi} | bench.py's device handoff on the same {FLOW_SECONDS:.0f} s:"
              f" apply_segments(stereo mix at {dims.samplerate} Hz, {windows} windows of"
              f" {dims.segment} s, batch 8, source_indices=(vocals,)) + mono + resample_poly ->"
              f" 16 kHz on the card: {handoff_s:.3f} s ({handoff_s / FLOW_SECONDS * 3600:.1f} s per"
              f" audio hour), peak device memory {peak:.2f} GiB | resample_poly alone"
              f" ({mono.numel()} -> {v16.numel()} samples, a [{blocks}, {width}] x [{width}, 160]"
              f" f32 GEMM, {flops / 1e9:.2f} GFLOP): {resample_ms:.3f} ms (CUDA events), bound"
              f" {bound_ms:.3f} ms")
        del params, stereo, vocals, mono, v16
    torch.cuda.empty_cache()
    return run


def ecapa_flops_per_frame(dims) -> float:
    """Multiply-adds x 2 of ECAPA-TDNN a frame: the prologue, each block's
    two 1x1 convs and Res2Net convs, the aggregation and the frame part
    of the attention."""
    c, s = dims.channels, dims.res2net_scale
    block = 2 * c * c + (s - 1) * 3 * (c // s) ** 2
    return 2.0 * (5 * dims.n_mels * c + len(dims.dilations) * block
                  + len(dims.dilations) * c * dims.agg_channels
                  + 2 * dims.agg_channels * dims.attn_hidden)


def phase_pyannote_ecapa_main(seed: int, smi: str) -> None:
    """6m: the diarizer with PyanNet and ECAPA at full dims:
    NeuralDiarizer(create_config(tmp, "telephonic") naming ``ecapa_tdnn``,
    force_large_models=True) with a seeded full-size
    ``pyannote_segmentation.npz`` (SincNet 80, 4 BiLSTM layers of 128, 7
    powerset classes) in $WNT_MODEL_DIR and no MarbleNet: PyanNet is the
    VAD; ECAPA-TDNN (``EcapaDims()``) and the telephonic MSDD are seeded
    inits. A warm request of 60 s, then PYANNOTE_SECONDS of four voices
    with num_speakers=4: wall, stage times, peak device memory, the speech
    share (random PyanNet weights may mark all or none of it as speech)
    and ECAPA's rate. Held against the CPU (the same trees, moved): the
    VAD's probabilities over the whole audio within PROB_TOL, and on its
    first PYANNOTE_CPU_SECONDS the mapped embeddings within DIAR_EMB_TOL of
    the largest and the turns equal where the CPU's eigengap exceeds
    DIAR_GAP."""
    import copy

    import torch

    from whisper_nemo_tpu_torch.config import create_config
    from whisper_nemo_tpu_torch.diarize import NeuralDiarizer
    from whisper_nemo_tpu_torch.engine.checkpoint import save_params
    from whisper_nemo_tpu_torch.engine.precision import full_f32
    from whisper_nemo_tpu_torch.models import ecapa, pyannet

    with contextlib.ExitStack() as stack:
        tmp = stack.enter_context(tempfile.TemporaryDirectory())
        models = os.path.join(tmp, "models")
        os.makedirs(models)
        stack.enter_context(model_dir(models))
        save_params(os.path.join(models, "pyannote_segmentation.npz"), pyannet.init_pyannet_params(
            "cpu", torch.Generator().manual_seed(seed + 95)))
        cfg = create_config(os.path.join(tmp, "run"), "telephonic")
        cfg.diarizer.speaker_embeddings.model_path = "ecapa_tdnn"
        t0 = time.time()
        gd = NeuralDiarizer(cfg, force_large_models=True, device="cuda", seed=seed)
        torch.cuda.synchronize()
        setup_s = time.time() - t0
        check(gd.pyannet_params is not None and gd.vad_params is None
              and gd._bench_vad_params is None and gd.spk_dims == ecapa.EcapaDims()
              and gd.msdd_params is not None, "6m: not PyanNet with ECAPA-TDNN and MSDD")
        # a generator on the card draws other numbers than one on the CPU: move the trees
        cd = copy.deepcopy(gd).to("cpu")
        seen = {}
        for name, d in (("gpu", gd), ("cpu", cd)):
            for attr in ("_frame_speech_probs", "_mapped_embeddings"):
                def keep(*a, _f=getattr(d, attr), _k=(name, attr), **kw):
                    seen[_k] = _f(*a, **kw)
                    return seen[_k]
                setattr(d, attr, keep)
        gd.diarize_waveform(voices(60.0, seed + 96, 4), num_speakers=4)
        audio = voices(PYANNOTE_SECONDS, seed + 97, 4)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        t0 = time.time()
        turns = gd.diarize_waveform(audio, num_speakers=4, stats=stats)
        torch.cuda.synchronize()
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        probs = seen[("gpu", "_frame_speech_probs")]
        onset = cfg.diarizer.vad.parameters.onset
        with full_f32(), torch.inference_mode():
            cpu_probs = cd._frame_speech_probs(audio, torch.from_numpy(audio))
        prob_err = float(np.abs(probs - cpu_probs).max())
        check(probs.shape == cpu_probs.shape == (int(PYANNOTE_SECONDS * 100),),
              f"6m: VAD probabilities of {probs.shape} frames on the card, {cpu_probs.shape} on"
              f" the CPU")
        check(prob_err <= PROB_TOL, f"6m: the VAD's probabilities {prob_err:.2e} from the CPU's"
              f" (limit {PROB_TOL})")
        seconds = stats.get("seconds", {})
        embed_s = sum(v for k, v in seconds.items() if k.startswith("embed_"))
        windows = cfg.diarizer.speaker_embeddings.parameters.window_length_in_sec
        frames = sum(n * (int(w * SR) // 160 + 1)
                     for n, w in zip(stats.get("windows", []), windows))
        tflop = ecapa_flops_per_frame(gd.spk_dims) * frames / 1e12
        rate = (f"{frames} window-frames, {tflop:.2f} TFLOP in {embed_s:.3f} s,"
                f" {tflop / embed_s:.1f} TFLOP/s ({tflop * 1e12 / embed_s / F32_FLOPS:.0%} of the"
                f" f32 peak)" if embed_s else "not run (no speech)")
        print(f"[6m pyannote + ECAPA] {smi} | telephonic, PyanNet VAD (SincNet 80, 4 BiLSTM layers"
              f" of 128, 7 classes) + ECAPA-TDNN (512 channels, 1536 aggregated) + MSDD, f32"
              f" (TF32 off): setup {setup_s:.1f} s | {PYANNOTE_SECONDS / 60:.0f} min, num_speakers"
              f" 4: wall {wall:.3f} s ({wall / PYANNOTE_SECONDS * 3600:.2f} s per audio hour),"
              f" speech share {(probs > onset).mean():.3f} of {len(probs)} 10 ms frames (onset"
              f" {onset}), turns cover {sum(e - s for s, e, _ in turns) / PYANNOTE_SECONDS:.3f}"
              f" of the audio, n_base {stats.get('n_base', 0)}, path {stats.get('path', '-')},"
              f" speakers {stats.get('speakers', 0)}, {len(turns)} turns | ECAPA {rate} | stages"
              f" (s): {' '.join(f'{k} {v:.3f}' for k, v in seconds.items())} | peak device memory"
              f" {peak:.2f} GiB | VAD probabilities on the CPU within {prob_err:.2e} (limit"
              f" {PROB_TOL})")

        head = audio[: int(PYANNOTE_CPU_SECONDS * SR)]
        got, cpu_stats = gd.diarize_waveform(head, num_speakers=4), {}
        want = cd.diarize_waveform(head, num_speakers=4, stats=cpu_stats)
        if not want:
            check(got == [], f"6m: {len(got)} turns on the card where the CPU found no speech")
            verdict = "no speech on either device"
        else:
            emb_err = max(rel_err(a, b) for a, b in zip(seen[("gpu", "_mapped_embeddings")],
                                                        seen[("cpu", "_mapped_embeddings")]))
            check(emb_err <= DIAR_EMB_TOL, f"6m: ECAPA's embeddings {emb_err:.2e} from the CPU's")
            gap = cpu_stats.get("eigengap", 0.0)
            if gap > DIAR_GAP:
                check(got == want, "6m: the turns differ between the devices")
            verdict = (f"embeddings within {emb_err:.2e} of the largest (limit {DIAR_EMB_TOL}),"
                       f" eigengap {gap:.4f}: turns "
                       + (f"equal ({len(want)})" if gap > DIAR_GAP else
                          f"not held (the gap is at or below {DIAR_GAP}; {len(got)} and"
                          f" {len(want)} turns)"))
        print(f"[6m pyannote + ECAPA] the first {PYANNOTE_CPU_SECONDS:.0f} s on the card against"
              f" the CPU: {verdict}")
        del gd, cd
    torch.cuda.empty_cache()


# -- converted checkpoints (phase 5j) -------------------------------------------

CONVERTED_SECONDS = 60.0  # 5j's audio for Whisper, the diarizer and PyanNet
DEMUCS_CONVERTED_SECONDS = 10.0  # 5j's mix for htdemucs
# the modules a conversion must not import: the card has none but torch's
CONVERT_BANNED = ("jax", "jaxlib", "whisper_nemo_tpu", "transformers", "safetensors", "demucs")


class SeededTensors:
    """Seeded float32 tensors on ``device``, returned on the CPU: weights
    normal over the square root of their fan-in, scales 1 ± 0.25, shifts
    ±0.1 (a generator on the card draws fast; its numbers are its own)."""

    def __init__(self, seed: int, device):
        import torch

        self.device = torch.device(device)
        self.g = torch.Generator(device=self.device).manual_seed(seed)

    def w(self, *shape):
        import torch

        fan_in = int(np.prod(shape[1:])) or 1
        return (torch.randn(shape, device=self.device, generator=self.g) / fan_in**0.5).cpu()

    def shift(self, n):
        import torch

        return (0.1 * torch.randn(n, device=self.device, generator=self.g)).cpu()

    def scale(self, n):
        import torch

        return (0.75 + 0.5 * torch.rand(n, device=self.device, generator=self.g)).cpu()


def write_safetensors(path: str, tensors: dict) -> None:
    """A ``model.safetensors`` of float32 tensors: an 8-byte little-endian
    header length, the JSON header (dtype, shape, byte offsets), the
    bytes."""
    header, offset = {}, 0
    arrays = {k: np.ascontiguousarray(v.numpy(), "<f4") for k, v in tensors.items()}
    for k, v in arrays.items():
        header[k] = {"dtype": "F32", "shape": list(v.shape),
                     "data_offsets": [offset, offset + v.nbytes]}
        offset += v.nbytes
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for v in arrays.values():
            f.write(v.tobytes())


@contextlib.contextmanager
def foreign_class(module: str, name: str):
    """A class ``module.name`` of a package no process here can import.
    Pickle imports a global's module while saving, so within the block
    the module stands in ``sys.modules``; after it, the entries are gone."""
    import types

    parts = module.split(".")
    names = [".".join(parts[: i + 1]) for i in range(len(parts))]
    cls = type(name, (), {"__module__": module, "__qualname__": name})
    mods = {n: types.ModuleType(n) for n in names}
    setattr(mods[module], name, cls)
    saved = {n: sys.modules.get(n) for n in names}
    sys.modules.update(mods)
    try:
        yield cls
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


def openai_whisper_state(dims, t: SeededTensors) -> dict:
    """An OpenAI whisper ``model_state_dict`` at ``dims`` (f16 as OpenAI
    ships it): ``encoder.blocks.N.attn.query`` names, ``mlp.0``/``mlp.2``,
    ``positional_embedding``, no key-projection bias."""
    sd, d = {}, dims.n_audio_state

    def lin(p, o, i, bias=True):
        sd[f"{p}.weight"] = t.w(o, i)
        if bias:
            sd[f"{p}.bias"] = t.shift(o)

    def ln(p):
        sd[f"{p}.weight"], sd[f"{p}.bias"] = t.scale(d), t.shift(d)

    def attn(p):
        lin(f"{p}.query", d, d)
        lin(f"{p}.key", d, d, bias=False)
        lin(f"{p}.value", d, d)
        lin(f"{p}.out", d, d)

    def block(p, cross):
        attn(f"{p}.attn")
        ln(f"{p}.attn_ln")
        if cross:
            attn(f"{p}.cross_attn")
            ln(f"{p}.cross_attn_ln")
        lin(f"{p}.mlp.0", 4 * d, d)
        lin(f"{p}.mlp.2", d, 4 * d)
        ln(f"{p}.mlp_ln")

    sd["encoder.conv1.weight"], sd["encoder.conv1.bias"] = t.w(d, dims.n_mels, 3), t.shift(d)
    sd["encoder.conv2.weight"], sd["encoder.conv2.bias"] = t.w(d, d, 3), t.shift(d)
    sd["encoder.positional_embedding"] = t.w(dims.n_audio_ctx, d)
    for i in range(dims.n_audio_layer):
        block(f"encoder.blocks.{i}", cross=False)
    ln("encoder.ln_post")
    sd["decoder.token_embedding.weight"] = t.w(dims.n_vocab, d)
    sd["decoder.positional_embedding"] = t.w(dims.n_text_ctx, d)
    for i in range(dims.n_text_layer):
        block(f"decoder.blocks.{i}", cross=True)
    ln("decoder.ln")
    return {k: v.half() for k, v in sd.items()}


def _bn(sd: dict, t: SeededTensors, p: str, c: int) -> None:
    import torch

    sd[f"{p}.weight"], sd[f"{p}.bias"] = t.scale(c), t.shift(c)
    sd[f"{p}.running_mean"], sd[f"{p}.running_var"] = t.shift(c), t.scale(c)
    sd[f"{p}.num_batches_tracked"] = torch.tensor(1000)


def jasper_state(cfgs, n_in: int, t: SeededTensors) -> dict:
    """NeMo ConvASREncoder tensors: ``mconv.<i>.conv`` convs, bare batch
    norms, activations and dropout holding none, squeeze-excite ``fc`` at
    a block's tail, the residual under ``res.0``."""
    sd = {}
    for bi, cfg in enumerate(cfgs):
        base, i, c_in = f"encoder.encoder.{bi}.mconv", 0, n_in
        for r in range(cfg.repeat):
            if cfg.separable:
                sd[f"{base}.{i}.conv.weight"] = t.w(c_in, 1, cfg.kernel)
                i += 1
            sd[f"{base}.{i}.conv.weight"] = t.w(cfg.filters, c_in,
                                                1 if cfg.separable else cfg.kernel)
            _bn(sd, t, f"{base}.{i + 1}", cfg.filters)
            i += 2 if r == cfg.repeat - 1 else 4
            c_in = cfg.filters
        if cfg.se:
            sd[f"{base}.{i}.fc.0.weight"] = t.w(cfg.filters // cfg.se_reduction, cfg.filters)
            sd[f"{base}.{i}.fc.2.weight"] = t.w(cfg.filters, cfg.filters // cfg.se_reduction)
        if cfg.residual:
            sd[f"encoder.encoder.{bi}.res.0.0.conv.weight"] = t.w(cfg.filters, n_in, 1)
            _bn(sd, t, f"encoder.encoder.{bi}.res.0.1", cfg.filters)
        n_in = cfg.filters
    return sd


def jasper_config(cfgs) -> dict:
    return {"jasper": [{"filters": c.filters, "repeat": c.repeat, "kernel": [c.kernel],
                        "stride": [1], "dilation": [c.dilation], "dropout": 0.0,
                        "residual": c.residual, "separable": c.separable, "se": c.se,
                        "se_reduction_ratio": c.se_reduction} for c in cfgs]}


def write_nemo(path: str, config_dict: dict, sd: dict, yaml_module) -> None:
    """A .nemo (a gzipped tar): ``model_config.yaml`` (JSON, which is YAML,
    where PyYAML is absent) and ``model_weights.ckpt``."""
    import io
    import tarfile

    import torch

    text = yaml_module.safe_dump(config_dict) if yaml_module else json.dumps(config_dict)
    buf = io.BytesIO()
    torch.save(sd, buf)
    with tarfile.open(path, "w:gz") as tar:
        for name, blob in (("./model_config.yaml", text.encode()),
                           ("./model_weights.ckpt", buf.getvalue())):
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))


def nemo_weights_of(path: str) -> dict:
    """A .nemo's state dict as float32 numpy (``extract_nemo`` less its
    yaml read)."""
    import io
    import tarfile

    import torch

    from whisper_nemo_tpu_torch.engine.nemo_weights import _to_numpy

    with tarfile.open(path, "r:*") as tar:
        member = next(m for m in tar.getmembers() if m.name.endswith(".ckpt"))
        state = torch.load(io.BytesIO(tar.extractfile(member).read()), map_location="cpu",
                           weights_only=True)
    return {k: _to_numpy(v) for k, v in state.items()}


# 5j's sources at the published dims, the HF models' depth cut to 2 layers:
# MarbleNet 3x2x64's blocks (NeMo's marblenet_3x2x64 config; the port's
# MarbleNetDims widths and kernels), TitaNet-large's (models/titanet.TitaNetDims),
# the telephonic MSDD (MsddDims()), pyannote segmentation-3.0, the released
# htdemucs (HTDemucsDims()), MMS-300M and XLM-R base. A CPU rehearsal patches a
# smaller copy in.
CONVERTED = {
    "whisper": "medium.en",
    "marblenet": dict(n_mels=64, blocks=[
        dict(filters=128, kernel=11, separable=True),
        *(dict(filters=64, repeat=2, kernel=k, separable=True, residual=True)
          for k in (13, 15, 17)),
        dict(filters=128, kernel=29, dilation=2, separable=True), dict(filters=128, kernel=1)]),
    "titanet": dict(n_mels=80, attention=128, emb=192, blocks=[
        dict(filters=1024, kernel=3, separable=True),
        *(dict(filters=1024, repeat=3, kernel=k, separable=True, residual=True, se=True,
               se_reduction=16) for k in (7, 11, 15)),
        dict(filters=3072, kernel=1)]),
    "msdd": {},
    "pyannet": dict(sinc=80, conv=60, hidden=128, layers=4, classes=7),
    "demucs": {},
    "mms": dict(width=1024, heads=16, conv=512, pos=128, groups=16, layers=2),
    "xlmr": dict(vocab=250002, width=768, heads=12, positions=514, layers=2),
}


def write_converted_sources(src: str, seed: int, device) -> dict:
    """5j's sources in the published layouts at the published dims, from
    ``seed`` (the depth of the HF aligner and punctuation models cut to 2
    layers): kind -> (path, the CLI's extra arguments, the .nemo kinds'
    config dict)."""
    import fractions

    import torch

    from whisper_nemo_tpu_torch.align.api import AlignmentTokenizer
    from whisper_nemo_tpu_torch.engine.demucs_weights import _DCONV_RENAME
    from whisper_nemo_tpu_torch.models import htdemucs, msdd
    from whisper_nemo_tpu_torch.models.conv_asr import JasperBlockCfg
    from whisper_nemo_tpu_torch.models.whisper import WHISPER_DIMS

    try:
        import yaml
    except ImportError:
        yaml = None
    t = SeededTensors(seed + 110, device)
    out = {}

    name = CONVERTED["whisper"]
    dims = WHISPER_DIMS[name]
    path = os.path.join(src, f"{name}.pt")
    torch.save({"dims": dataclasses.asdict(dims), "model_state_dict": openai_whisper_state(dims, t)},
               path)
    out["whisper-pt"] = (path, ["--name", name], None)

    marblenet, titanet = CONVERTED["marblenet"], CONVERTED["titanet"]
    vad_cfgs = [JasperBlockCfg(**b) for b in marblenet["blocks"]]
    sd = jasper_state(vad_cfgs, marblenet["n_mels"], t)
    # the frame-VAD head (one 1x1 conv) leans to speech, so that the 0.8
    # onset keeps the voices (random logits sit near 0.5)
    sd["decoder.decoder_layers.0.weight"] = 0.05 * t.w(2, vad_cfgs[-1].filters, 1)
    sd["decoder.decoder_layers.0.bias"] = torch.tensor([0.0, 4.0])
    config = {"preprocessor": {"features": marblenet["n_mels"]},
              "encoder": jasper_config(vad_cfgs)}
    out["vad"] = (os.path.join(src, "vad_multilingual_marblenet.nemo"), [], config)

    spk_cfgs = [JasperBlockCfg(**b) for b in titanet["blocks"]]
    c, att, emb = spk_cfgs[-1].filters, titanet["attention"], titanet["emb"]
    sd_spk = jasper_state(spk_cfgs, titanet["n_mels"], t)
    p = "decoder._pooling.attention_layer"
    sd_spk[f"{p}.0.conv_layer.weight"] = t.w(att, 3 * c, 1)
    sd_spk[f"{p}.0.conv_layer.bias"] = t.shift(att)
    _bn(sd_spk, t, f"{p}.0.bn", att)
    sd_spk[f"{p}.2.weight"], sd_spk[f"{p}.2.bias"] = t.w(c, att, 1), t.shift(c)
    _bn(sd_spk, t, "decoder.emb_layers.0.0", 2 * c)
    sd_spk["decoder.emb_layers.0.1.weight"] = t.w(emb, 2 * c, 1)
    sd_spk["decoder.emb_layers.0.1.bias"] = t.shift(emb)
    config_spk = {"preprocessor": {"features": titanet["n_mels"]},
                  "encoder": jasper_config(spk_cfgs),
                  "decoder": {"attention_channels": att, "emb_sizes": emb}}
    out["titanet"] = (os.path.join(src, "titanet_large.nemo"), [], config_spk)

    m = msdd.MsddDims(**CONVERTED["msdd"])
    sd_msdd, n_feat = {}, 2 * m.n_scales + 2
    for sfx in ("", "_reverse"):
        sd_msdd[f"msdd.lstm.weight_ih_l0{sfx}"] = t.w(4 * m.hidden, m.proj)
        sd_msdd[f"msdd.lstm.weight_hh_l0{sfx}"] = t.w(4 * m.hidden, m.hidden)
        sd_msdd[f"msdd.lstm.bias_ih_l0{sfx}"] = t.shift(4 * m.hidden)
        sd_msdd[f"msdd.lstm.bias_hh_l0{sfx}"] = t.shift(4 * m.hidden)
    sd_msdd["msdd.hidden_to_spks.weight"] = t.w(2, 2 * m.hidden)
    sd_msdd["msdd.hidden_to_spks.bias"] = t.shift(2)
    sd_msdd["msdd.dist_to_emb.weight"] = t.w(m.proj, n_feat)
    sd_msdd["msdd.dist_to_emb.bias"] = t.shift(m.proj)
    config_msdd = {"msdd_module": {"num_lstm_layers": 1, "hidden_size": m.hidden}}
    out["msdd"] = (os.path.join(src, "diar_msdd_telephonic.nemo"), [], config_msdd)
    for kind, state in (("vad", sd), ("titanet", sd_spk), ("msdd", sd_msdd)):
        write_nemo(out[kind][0], out[kind][2], state, yaml)

    # pyannote segmentation-3.0 (SincNet 80, 4 BiLSTM layers of 128, 7 classes) in a
    # lightning checkpoint whose hyper-parameters are an object of lightning's
    py = CONVERTED["pyannet"]
    n, ch, h = py["sinc"], py["conv"], py["hidden"]
    g = torch.Generator().manual_seed(seed + 111)
    sd_py = {"sincnet.wav_norm1d.weight": t.scale(1), "sincnet.wav_norm1d.bias": t.shift(1),
             "sincnet.conv1d.0.filterbank.low_hz_": 2000 * torch.rand((n, 1), generator=g),
             "sincnet.conv1d.0.filterbank.band_hz_": 1000 * torch.rand((n, 1), generator=g)}
    for i, c_in in ((1, n), (2, ch)):
        sd_py[f"sincnet.conv1d.{i}.weight"] = t.w(ch, c_in, 5)
        sd_py[f"sincnet.conv1d.{i}.bias"] = t.shift(ch)
    for i, c_out in enumerate((n, ch, ch)):
        sd_py[f"sincnet.norm1d.{i}.weight"] = t.scale(c_out)
        sd_py[f"sincnet.norm1d.{i}.bias"] = t.shift(c_out)
    for layer in range(py["layers"]):
        for sfx in ("", "_reverse"):
            sd_py[f"lstm.weight_ih_l{layer}{sfx}"] = t.w(4 * h, ch if layer == 0 else 2 * h)
            sd_py[f"lstm.weight_hh_l{layer}{sfx}"] = t.w(4 * h, h)
            sd_py[f"lstm.bias_ih_l{layer}{sfx}"] = t.shift(4 * h)
            sd_py[f"lstm.bias_hh_l{layer}{sfx}"] = t.shift(4 * h)
    for key, (o, c_in) in (("linear.0", (h, 2 * h)), ("linear.1", (h, h)),
                           ("classifier", (py["classes"], h))):
        sd_py[f"{key}.weight"], sd_py[f"{key}.bias"] = t.w(o, c_in), t.shift(o)
    path = os.path.join(src, "pytorch_model.bin")
    with foreign_class("pytorch_lightning.utilities.parsing", "AttributeDict") as hparams:
        torch.save({"state_dict": {"model." + k: v for k, v in sd_py.items()},
                    "pyannote.audio": {"versions": {"torch": torch.__version__}},
                    "hyper_parameters": hparams()}, path)
    out["pyannote"] = (path, [], None)

    # htdemucs at the released model's dims, demucs' serialize_model dict
    ddims = htdemucs.HTDemucsDims(**CONVERTED["demucs"])
    tree = htdemucs.init_htdemucs_params(ddims, t.device, t.g)
    inverse = {v: k for k, v in _DCONV_RENAME.items()}
    state = {}

    def walk(node, parts):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, parts + [k])
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, parts + [str(i)])
        else:
            if "dconv" in parts:
                i = parts.index("dconv") + 3
                parts = parts[:i] + (["6", "scale"] if parts[i] == "scale"
                                     else [inverse[parts[i]]] + parts[i + 1:])
            state[".".join(parts)] = node.cpu()

    walk(tree, [])
    path = os.path.join(src, "htdemucs.th")
    with foreign_class("demucs.htdemucs", "HTDemucs") as klass:
        torch.save({"klass": klass, "args": (), "state": state,
                    "kwargs": {"sources": list(ddims.sources), "audio_channels": 2,
                               "samplerate": 44100, "segment": fractions.Fraction(39, 5)}}, path)
    out["demucs"] = (path, [], None)

    # HF directories at MMS-300M's and XLM-R base's widths, 2 layers each
    mms, xlmr = CONVERTED["mms"], CONVERTED["xlmr"]
    vocab = len(AlignmentTokenizer().vocab) - 1
    d, cw, pre, sd_w2v = mms["width"], mms["conv"], "wav2vec2.", {}
    conv_kernel, conv_stride = (10, 3, 3, 3, 3, 2, 2), (5, 2, 2, 2, 2, 2, 2)
    c_in = 1
    for i, k in enumerate(conv_kernel):
        q = f"{pre}feature_extractor.conv_layers.{i}"
        sd_w2v[f"{q}.conv.weight"], sd_w2v[f"{q}.conv.bias"] = t.w(cw, c_in, k), t.shift(cw)
        sd_w2v[f"{q}.layer_norm.weight"], sd_w2v[f"{q}.layer_norm.bias"] = t.scale(cw), t.shift(cw)
        c_in = cw

    def lin(sd_, q, o, i):
        sd_[f"{q}.weight"], sd_[f"{q}.bias"] = t.w(o, i), t.shift(o)

    def ln(sd_, q, n):
        sd_[f"{q}.weight"], sd_[f"{q}.bias"] = t.scale(n), t.shift(n)

    ln(sd_w2v, f"{pre}feature_projection.layer_norm", cw)
    lin(sd_w2v, f"{pre}feature_projection.projection", d, cw)
    q = f"{pre}encoder.pos_conv_embed.conv"
    sd_w2v[f"{q}.parametrizations.weight.original0"] = t.scale(mms["pos"]).reshape(1, 1, -1)
    sd_w2v[f"{q}.parametrizations.weight.original1"] = t.w(d, d // mms["groups"], mms["pos"])
    sd_w2v[f"{q}.bias"] = t.shift(d)
    ln(sd_w2v, f"{pre}encoder.layer_norm", d)
    for i in range(mms["layers"]):
        q = f"{pre}encoder.layers.{i}"
        for n in ("q", "k", "v", "out"):
            lin(sd_w2v, f"{q}.attention.{n}_proj", d, d)
        ln(sd_w2v, f"{q}.layer_norm", d)
        lin(sd_w2v, f"{q}.feed_forward.intermediate_dense", 4 * d, d)
        lin(sd_w2v, f"{q}.feed_forward.output_dense", d, 4 * d)
        ln(sd_w2v, f"{q}.final_layer_norm", d)
    lin(sd_w2v, "lm_head", vocab, d)
    cfg_w2v = {"model_type": "wav2vec2", "vocab_size": vocab, "hidden_size": d,
               "num_hidden_layers": mms["layers"], "num_attention_heads": mms["heads"],
               "intermediate_size": 4 * d, "conv_dim": [cw] * 7, "conv_kernel": list(conv_kernel),
               "conv_stride": list(conv_stride), "num_conv_pos_embeddings": mms["pos"],
               "num_conv_pos_embedding_groups": mms["groups"], "do_stable_layer_norm": True,
               "feat_extract_norm": "layer", "conv_bias": True}
    d, sd_x = xlmr["width"], {}
    sd_x["roberta.embeddings.word_embeddings.weight"] = t.w(xlmr["vocab"], d)
    sd_x["roberta.embeddings.position_embeddings.weight"] = t.w(xlmr["positions"], d)
    sd_x["roberta.embeddings.token_type_embeddings.weight"] = t.w(1, d)
    ln(sd_x, "roberta.embeddings.LayerNorm", d)
    for i in range(xlmr["layers"]):
        q = f"roberta.encoder.layer.{i}"
        for n in ("query", "key", "value"):
            lin(sd_x, f"{q}.attention.self.{n}", d, d)
        lin(sd_x, f"{q}.attention.output.dense", d, d)
        ln(sd_x, f"{q}.attention.output.LayerNorm", d)
        lin(sd_x, f"{q}.intermediate.dense", 4 * d, d)
        lin(sd_x, f"{q}.output.dense", d, 4 * d)
        ln(sd_x, f"{q}.output.LayerNorm", d)
    lin(sd_x, "classifier", 6, d)
    cfg_x = {"model_type": "xlm-roberta", "vocab_size": xlmr["vocab"], "hidden_size": d,
             "num_hidden_layers": xlmr["layers"], "num_attention_heads": xlmr["heads"],
             "intermediate_size": 4 * d, "max_position_embeddings": xlmr["positions"],
             "id2label": {str(i): lab for i, lab in enumerate("0.,?-:")}}
    for kind, name, cfg, sd_ in (("aligner", "mms-300m", cfg_w2v, sd_w2v),
                                 ("punctuation", "punctuate-all", cfg_x, sd_x)):
        directory = os.path.join(src, name)
        os.makedirs(directory)
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(cfg, f)
        write_safetensors(os.path.join(directory, "model.safetensors"), sd_)
        out[kind] = (directory, [], None)
    return out


# runs its arguments as a command and reports the command's peak RSS: a
# process that forks from this small one inherits few pages, where one forked
# from the smoke itself would count the smoke's pages in its maximum
_PEAK_RSS = ("import resource, subprocess, sys; rc = subprocess.call(sys.argv[1:]); "
             "print('peak RSS KiB', resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss,"
             " file=sys.stderr); sys.exit(rc)")


def convert_in_children(sources: dict, work: str) -> dict:
    """``python -m whisper_nemo_tpu_torch.cli.convert`` on each source, in
    new processes started together, each into ``work/<kind>``
    (``-X importtime``: its stderr lists every module it imported): per
    kind its exit code, seconds, peak RSS (``_PEAK_RSS``), the files it
    wrote and their bytes, and the banned modules it imported."""
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    jobs = {}
    with contextlib.ExitStack() as stack:
        for kind, (path, extra, _) in sources.items():
            out_dir = os.path.join(work, kind)
            os.makedirs(out_dir)
            out, err = (stack.enter_context(tempfile.TemporaryFile("w+")) for _ in range(2))
            cmd = [sys.executable, "-c", _PEAK_RSS, sys.executable, "-X", "importtime", "-m",
                   "whisper_nemo_tpu_torch.cli.convert", kind, path, "--out-dir", out_dir, *extra]
            jobs[kind] = {"proc": subprocess.Popen(cmd, stdout=out, stderr=err, env=env),
                          "t0": time.time(), "out": out, "err": err, "dir": out_dir}
        running = set(jobs)
        while running:
            for kind in sorted(running):
                if jobs[kind]["proc"].poll() is not None:
                    jobs[kind]["seconds"] = time.time() - jobs[kind]["t0"]
                    running.discard(kind)
            time.sleep(0.02)
        results = {}
        for kind, job in jobs.items():
            job["out"].seek(0)
            job["err"].seek(0)
            lines = job["err"].read().splitlines()
            imported = {line.split("|")[-1].strip() for line in lines
                        if line.startswith("import time:")}
            rss = [int(line.split()[-1]) for line in lines if line.startswith("peak RSS KiB")]
            files = sorted(os.listdir(job["dir"]))
            results[kind] = {
                "rc": job["proc"].returncode, "seconds": job["seconds"],
                "rss_gib": rss[-1] / 2**20, "dir": job["dir"], "files": files,
                "bytes": sum(os.path.getsize(os.path.join(job["dir"], f)) for f in files),
                "banned": sorted(m for m in imported if m.split(".")[0] in CONVERT_BANNED),
                "stdout": job["out"].read(),
                "errors": "\n".join(line for line in lines if not line.startswith(
                    ("import time:", "peak RSS KiB")))[-2000:]}
    return results


def phase_converted(seed: int, smi: str, devices=("cuda", "cpu")) -> list:
    """5j: the published checkpoint layouts through the port's converters
    and loaders, on the card. Seeded sources at the published dims
    (``write_converted_sources``) each go through ``python -m
    whisper_nemo_tpu_torch.cli.convert`` in a new process into one model
    directory (seconds, bytes written, peak RSS; none of CONVERT_BANNED
    imported). Where PyYAML is absent the .nemo kinds must raise naming it,
    and their ``convert_*`` run in process on the config dict. Then on
    ``devices[0]``, every kernel count set to 0 just before and read just
    after: medium.en from the converted file through the batched facade
    at "float16", greedy, on CONVERTED_SECONDS of four voices (kernels C,
    B, A), and the same run on the tree ``params_from_jax`` builds in
    memory from the converter's output: the tokens equal; the converted
    MMS-sized aligner's emissions (kernel B). Against ``devices[1]``:
    NeuralDiarizer on the converted MarbleNet, TitaNet and MSDD (the
    conv_asr path) on the same audio, MarbleNet's probabilities within
    PROB_TOL, embeddings within DIAR_EMB_TOL, MSDD's mean sigmoids within
    DIAR_MSDD_TOL, the turns equal where the eigengap exceeds DIAR_GAP;
    PyanNet's probabilities within PROB_TOL; htdemucs on
    DEMUCS_CONVERTED_SECONDS within DEMUCS_TOL of the largest output; the
    punctuation model's labels. Returns the kernels' JSON entries at the
    shapes the converted runs launched them at (held as 6g holds them)."""
    import torch

    from whisper_nemo_tpu_torch.align.api import generate_emissions, load_alignment_model
    from whisper_nemo_tpu_torch.asr import BatchedInferencePipeline, WhisperModel
    from whisper_nemo_tpu_torch.cli import convert
    from whisper_nemo_tpu_torch.config import create_config
    from whisper_nemo_tpu_torch.diarize import NeuralDiarizer
    from whisper_nemo_tpu_torch.diarize.segments import multiscale_segmentation
    from whisper_nemo_tpu_torch.engine import nemo_weights
    from whisper_nemo_tpu_torch.engine.checkpoint import load_params, params_from_jax
    from whisper_nemo_tpu_torch.engine.precision import full_f32
    from whisper_nemo_tpu_torch.engine.weights import (convert_openai_whisper_state_dict,
                                                       dims_from_openai_dims)
    from whisper_nemo_tpu_torch.models import htdemucs, msdd, pyannet
    from whisper_nemo_tpu_torch.models.punctuation import PUNCT_LABELS, PunctuationModel
    from whisper_nemo_tpu_torch.ops import attention as at
    from whisper_nemo_tpu_torch.ops import cross_decode as cd
    from whisper_nemo_tpu_torch.ops import mel

    gpu, cpu = devices
    t_phase = time.time()
    has_yaml = importlib.util.find_spec("yaml") is not None
    with contextlib.ExitStack() as stack:
        tmp = stack.enter_context(tempfile.TemporaryDirectory())
        src, models = os.path.join(tmp, "src"), os.path.join(tmp, "models")
        os.makedirs(src)
        os.makedirs(models)
        stack.enter_context(model_dir(models))
        t0 = time.time()
        sources = write_converted_sources(src, seed, gpu)
        src_s = time.time() - t0
        src_bytes = sum(e.stat().st_size for e in os.scandir(src) if e.is_file()) + sum(
            os.path.getsize(os.path.join(src, d, f)) for d in ("mms-300m", "punctuate-all")
            for f in os.listdir(os.path.join(src, d)))
        print(f"[5j converted checkpoints] {smi} | sources written from the seed in {src_s:.1f} s,"
              f" {src_bytes / 2**30:.2f} GiB: {CONVERTED['whisper']}.pt (OpenAI's layout, f16),"
              f" .nemo tars of"
              f" vad_multilingual_marblenet (MarbleNet 3x2x64), titanet_large and"
              f" diar_msdd_telephonic, pyannote segmentation-3.0's lightning pytorch_model.bin,"
              f" htdemucs.th (demucs' klass a stub of a module no process here imports), HF"
              f" directories of MMS-300M and XLM-R base at 2 layers | PyYAML"
              f" {'present' if has_yaml else 'absent'}")

        t0 = time.time()
        results = convert_in_children(sources, os.path.join(tmp, "conv"))
        conv_s = time.time() - t0
        rows = []
        for kind, r in results.items():
            path, _, config = sources[kind]
            check(not r["banned"], f"5j {kind}: the conversion imported {r['banned']}")
            if kind in ("vad", "titanet", "msdd") and not has_yaml:
                check(r["rc"] != 0 and "PyYAML" in r["errors"], f"5j {kind}: without PyYAML the"
                      f" .nemo read did not raise naming it (rc {r['rc']}): {r['errors']}")
                sd = nemo_weights_of(path)
                with patched(nemo_weights, "extract_nemo", lambda p, c=config, s=sd: (c, s)):
                    t0 = time.time()
                    convert.convert_nemo(kind, path, os.path.splitext(os.path.basename(path))[0],
                                         r["dir"])
                    r["seconds"] = time.time() - t0
                r["files"] = sorted(os.listdir(r["dir"]))
                r["bytes"] = sum(os.path.getsize(os.path.join(r["dir"], f)) for f in r["files"])
                note = ("the tar's YAML read not run: PyYAML absent (the child raised naming it);"
                        " convert_* ran in process on the config dict")
            else:
                check(r["rc"] == 0, f"5j {kind}: the conversion exited {r['rc']}: {r['errors']}")
                note = "exit 0"
            for name in r["files"]:
                os.replace(os.path.join(r["dir"], name), os.path.join(models, name))
            rows.append(f"{kind} {r['seconds']:.1f} s, {r['bytes'] / 2**20:.1f} MiB"
                        f" ({', '.join(r['files'])}), peak RSS {r['rss_gib']:.2f} GiB ({note})")
        print(f"[5j conversions] python -m whisper_nemo_tpu_torch.cli.convert, the {len(rows)}"
              f" started together as new processes, {conv_s:.1f} s in all, none importing"
              f" {', '.join(CONVERT_BANNED)}: " + "; ".join(rows))

        # Whisper: the converted file, and the converter's tree in memory
        pt = torch.load(sources["whisper-pt"][0], map_location="cpu", weights_only=True)
        w_dims = dims_from_openai_dims(pt["dims"])
        tree = convert_openai_whisper_state_dict(pt["model_state_dict"], w_dims)
        del pt
        audio = voices(CONVERTED_SECONDS, seed + 112, 4)
        counters = (cd.cross_attention_decode_layered, at.encoder_attention, mel.log_mel_raw)
        for fn in counters:
            fn.launches = 0
        shapes = recording_launches(stack)
        runs = {}
        for what in ("file", "memory"):
            t0 = time.time()
            if what == "file":
                model = WhisperModel(CONVERTED["whisper"], device=gpu, compute_type="float16",
                                     seed=seed)
            else:
                model = WhisperModel(CONVERTED["whisper"], device=gpu, compute_type="float16",
                                     seed=seed,
                                     params=params_from_jax(tree, gpu), dims=w_dims)
            load_s = time.time() - t0
            before = [fn.launches for fn in counters]
            t0 = time.time()
            segments, _ = BatchedInferencePipeline(model).transcribe(audio, language="en",
                                                                      batch_size=8, beam_size=1)
            segments = list(segments)
            torch.cuda.synchronize()
            runs[what] = ([s.tokens for s in segments], load_s, time.time() - t0,
                          [fn.launches - b for fn, b in zip(counters, before)])
            model.engine.unload()
            del model
        del tree
        torch.cuda.empty_cache()
        check(runs["file"][0] == runs["memory"][0] and runs["file"][0],
              "5j: medium.en's tokens from the converted file differ from those of the"
              " converter's tree in memory")
        for what, (toks, load_s, wall, (a, b, c)) in runs.items():
            check(a > 0 and b > 0 and c > 0, f"5j: a kernel of the converted medium.en's path"
                  f" never launched ({what}: A {a}, B {b}, C {c})")
        a_w, b_w, c_w = (x + y for x, y in zip(runs["file"][3], runs["memory"][3]))

        # the aligner (bf16, as the flow runs it on the card) and the punctuation model
        aligner, _ = load_alignment_model(gpu, dtype="bfloat16")
        check(len(aligner.params["enc"]["layers"]) == CONVERTED["mms"]["layers"],
              "5j: the aligner is not the converted one")
        b0 = at.encoder_attention.launches
        emissions, stride = generate_emissions(aligner, audio)
        b_align = at.encoder_attention.launches - b0
        check(b_align > 0 and np.isfinite(emissions).all() and emissions.shape[1] ==
              len(aligner.params["lm_head"]["b"]), f"5j: the aligner's emissions"
              f" {emissions.shape}, kernel B launched {b_align} times")
        launches = [fn.launches for fn in counters]
        punct = PunctuationModel(device=gpu)
        check(len(punct.params["layers"]) == CONVERTED["xlmr"]["layers"],
              "5j: the punctuation model is not the converted one")
        words = "the converted model reads these words and labels each one of them".split()
        labels = punct.predict(words * 4)
        check(len(labels) == 4 * len(words) and all(lab in PUNCT_LABELS for _, lab, _ in labels),
              "5j: punctuation labels")
        del aligner, punct
        print(f"[5j converted medium.en] \"float16\" (bf16 weights, the int8 cross-KV), batch 8,"
              f" greedy, {CONVERTED_SECONDS:.0f} s of four voices: tokens equal between the"
              f" converted file and the converter's tree in memory ({len(runs['file'][0])}"
              f" windows, {sum(map(len, runs['file'][0]))} tokens) | load {runs['file'][1]:.1f} s"
              f" from the .npz, {runs['memory'][1]:.1f} s from memory; transcribe"
              f" {runs['file'][2]:.2f} / {runs['memory'][2]:.2f} s | launches, both runs: A {a_w},"
              f" B {b_w}, C {c_w} | the aligner (2 layers, bf16) on the same audio: emissions"
              f" {emissions.shape}, {stride:.2f} ms a frame, kernel B {b_align} launches | the"
              f" punctuation model (XLM-R base widths, 2 layers): {len(labels)} labels | kernels,"
              f" the whole of 5j: A {launches[0]}, B {launches[1]}, C {launches[2]}")

        # NeMo: the conv_asr path on both devices
        cfg = create_config(os.path.join(tmp, "run"), "telephonic")
        diars = [NeuralDiarizer(cfg, device=dev, seed=seed) for dev in devices]
        for d in diars:
            check(d._vad_cfgs is not None and d._spk_cfgs is not None
                  and d.spk_dims.emb_dim == CONVERTED["titanet"]["emb"]
                  and {"in", "lstm", "lstm_rev", "out"} <= set(d.msdd_params),
                  "5j: the diarizer did not take the converted Jasper stacks and MSDD")
        seen = {}
        for d in diars:
            for attr in ("_frame_speech_probs", "_mapped_embeddings"):
                def keep(*args, _f=getattr(d, attr), _k=(str(d.device), attr), **kw):
                    seen[_k] = _f(*args, **kw)
                    return seen[_k]
                setattr(d, attr, keep)
        turns, stats, walls = [], [], []
        for d in diars:
            st = {}
            t0 = time.time()
            turns.append(d.diarize_waveform(audio, num_speakers=4, stats=st))
            if d.device.type == "cuda":
                torch.cuda.synchronize()
            walls.append(time.time() - t0)
            stats.append(st)
        keys = [str(d.device) for d in diars]
        probs = [seen[(k, "_frame_speech_probs")] for k in keys]
        prob_err = float(np.abs(probs[0] - probs[1]).max())
        check(prob_err <= PROB_TOL, f"5j: MarbleNet's probabilities {prob_err:.2e} apart")
        speech = float((probs[1] > cfg.diarizer.vad.parameters.onset).mean())
        check(speech > 0.2, f"5j: the converted VAD found speech in {speech:.0%} of the frames")
        mapped = [seen[(k, "_mapped_embeddings")] for k in keys]
        emb_err = max(float((a.cpu() - b.cpu()).abs().max()) for a, b in zip(*mapped))
        check(emb_err <= DIAR_EMB_TOL, f"5j: TitaNet's embeddings {emb_err:.2e} apart")
        weights = cfg.diarizer.speaker_embeddings.parameters.multiscale_weights
        seg = torch.stack([e.cpu() for e in mapped[1]])
        with full_f32(), torch.inference_mode():
            cpu_labels = diars[1]._cluster_labels(list(mapped[1]), 4)
            sig = [msdd.msdd_mean_sigmoids(d.msdd_params, seg.to(d.device), cpu_labels,
                                           weights)[0] for d in diars]
        sig_err = float(np.abs(sig[0] - sig[1]).max())
        check(sig_err <= DIAR_MSDD_TOL, f"5j: MSDD's mean sigmoids {sig_err:.2e} apart")
        gap = stats[1].get("eigengap", 0.0)
        if gap > DIAR_GAP:
            check(turns[0] == turns[1], "5j: the turns differ between the devices")
        print(f"[5j converted NeMo] NeuralDiarizer, telephonic, the converted MarbleNet 3x2x64,"
              f" TitaNet-large and MSDD through models/conv_asr.py, {CONVERTED_SECONDS:.0f} s of"
              f" four voices, num_speakers 4, {devices[0]} against {devices[1]}: wall"
              f" {walls[0]:.2f} / {walls[1]:.2f} s | speech share {speech:.3f} | MarbleNet"
              f" probabilities max|err| {prob_err:.2e} (<= {PROB_TOL}) | embeddings max|err|"
              f" {emb_err:.2e} (<= {DIAR_EMB_TOL}), n_base {stats[1].get('n_base')} | MSDD mean"
              f" sigmoids max|err| {sig_err:.2e} (<= {DIAR_MSDD_TOL}) | eigengap {gap:.4f}: turns "
              + (f"equal ({len(turns[1])})" if gap > DIAR_GAP else
                 f"not held (the gap is at or below {DIAR_GAP}; {len(turns[0])} and"
                 f" {len(turns[1])} turns)"))
        del diars, seen

        # PyanNet and htdemucs, both devices
        pyannote_npz = os.path.join(models, "pyannote_segmentation.npz")
        demucs_mix = 0.2 * np.random.default_rng(seed + 113).standard_normal(
            (2, int(DEMUCS_CONVERTED_SECONDS * htdemucs.NATIVE_SAMPLE_RATE)))
        outs = {}
        for dev in devices:
            params = load_params(pyannote_npz, dev)
            sep, ddims = htdemucs.load_htdemucs(models, dev)
            with full_f32(), torch.inference_mode():
                outs[dev] = (pyannet.speech_probs(params, torch.from_numpy(audio).to(dev)[None]),
                             htdemucs.apply_segments(sep, demucs_mix.astype(np.float32), ddims,
                                                     device_out=True))
            del params, sep
        check(ddims.segment == 7.8 and ddims == htdemucs.HTDemucsDims(**CONVERTED["demucs"]),
              f"5j: htdemucs' dims from the converted file and sidecar {ddims}")
        py_err = float((outs[gpu][0].cpu() - outs[cpu][0]).abs().max())
        sep_err = rel_err(outs[gpu][1], outs[cpu][1])
        check(py_err <= PROB_TOL, f"5j: PyanNet's probabilities {py_err:.2e} apart")
        check(sep_err <= DEMUCS_TOL and bool(torch.isfinite(outs[gpu][1]).all()),
              f"5j: htdemucs' outputs {sep_err:.2e} apart (relative)")
        print(f"[5j converted pyannote and htdemucs] {devices[0]} against {devices[1]}: PyanNet"
              f" (segmentation-3.0 dims) on {CONVERTED_SECONDS:.0f} s, probabilities"
              f" {tuple(outs[cpu][0].shape)} max|err| {py_err:.2e} (<= {PROB_TOL}) | htdemucs"
              f" (released dims, segment {ddims.segment} s from the .th's kwargs) on"
              f" {DEMUCS_CONVERTED_SECONDS:.0f} s at 44.1 kHz, sources"
              f" {tuple(outs[cpu][1].shape)} within {sep_err:.2e} of the largest (<= {DEMUCS_TOL})"
              f" | the phase took {time.time() - t_phase:.1f} s")
        del outs
        seen_shapes = {letter: counter for letter, counter in shapes.items() if counter}
    torch.cuda.empty_cache()
    return phase_flow_kernels({"5j": {"shapes": seen_shapes}}, seed + 114, tag="5j kernels",
                              entry=lambda run, letter: True,
                              label=lambda run: "converted checkpoints, 5j")


def titanet_flops_per_frame(dims) -> float:
    """Multiply-adds x 2 of TitaNet's convs and pooling GEMMs per frame."""
    c = dims.filters
    flops = 2 * dims.n_mels * (dims.kernels[0] + c[0])  # prologue: depthwise + pointwise
    for bi, c_out in enumerate(c[1:-1], start=1):
        c_in = c[bi - 1]
        flops += 2 * c_in * c_out  # the residual's 1x1
        for r in range(dims.repeat):
            cin = c_in if r == 0 else c_out
            flops += 2 * cin * (dims.kernels[bi] + c_out)
    flops += 2 * c[-2] * c[-1] * dims.kernels[-1]  # epilogue
    return flops + 4 * c[-1] * dims.attn_hidden  # attention's two GEMMs


def fmt_top(prof: dict, n: int = 6) -> str:
    """Total device ms per call, split by kernel name into convolutions,
    other GEMMs and the rest, and the ``n`` largest kernels."""
    if not prof:
        return "device time not measured (the profiler saw no device activity)"
    total = sum(prof.values())
    is_conv = {k: "conv" in k.lower() or "implicit" in k.lower() for k in prof}
    conv = sum(ms for k, ms in prof.items() if is_conv[k])
    gemm = sum(ms for k, ms in prof.items() if not is_conv[k] and "gemm" in k.lower())
    top = sorted(prof.items(), key=lambda kv: kv[1], reverse=True)[:n]
    short = "; ".join(f"{k.replace('void ', '')[:60]} {ms:.3f}" for k, ms in top)
    return (f"device time {total:.3f} ms per call (names with conv {conv:.3f}, gemm {gemm:.3f},"
            f" other {total - conv - gemm:.3f}); largest: {short}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    smi = phase_device()
    phase_build()
    a = phase_kernel_a(args.seed)
    d = phase_kernel_d(args.seed)
    e = phase_kernel_e(args.seed)
    f = phase_kernel_f(args.seed)
    c = phase_kernel_c(args.seed)
    s3 = phase_sequential_shapes(args.seed)
    b = phase_kernel_b(args.seed)
    phase_slice_parity(args.seed)
    phase_slice_parity(args.seed, beam_size=BEAM)
    phase_align_parity(args.seed)
    phase_sequential_parity(args.seed)
    phase_widths_parity(args.seed)
    phase_diar_parity(args.seed)
    phase_flow_parity(args.seed)
    phase_serving_parity(args.seed)
    phase_parallel_parity(args.seed)
    phase_separation_parity(args.seed)
    phase_flow_parity(args.seed, stem=True)
    converted_entries = phase_converted(args.seed, smi)
    main_run = phase_main_path(args.seed)
    phase_stage_times(main_run, a, e)
    phase_align_stage_times(main_run, d["a"])
    seq = phase_sequential_main(main_run, args.seed)
    phase_sequential_stage_times(main_run, seq, c)
    default = phase_default_main(args.seed)
    phase_diar_main(args.seed)
    flow_entries = phase_flow_kernels(phase_flow_main(args.seed, smi), args.seed)
    serving_entries = phase_serving_kernels(phase_serving_main(args.seed, smi), args.seed)
    _, parallel_entries = phase_parallel_main(args.seed, smi)
    config3_entries = phase_flow_kernels(
        {"config 3": phase_config3_main(args.seed, smi)}, args.seed + 6, tag="6l",
        entry=lambda run, letter: True, label=lambda run: "BASELINE config 3, 6k")
    phase_pyannote_ecapa_main(args.seed, smi)

    import torch

    kernels = [
        {"name": "cross_attention_decode_layered", "route": "cuda",
         "source": "whisper_nemo_tpu_torch/csrc/cross_decode.cu",
         "replaces": "whisper_nemo_tpu/ops/cross_decode.py:261",
         "launches": main_run["launches_a"], **a[1]},
        {"name": "cross_attention_decode_layered (beam 5)", "route": "cuda",
         "source": "whisper_nemo_tpu_torch/csrc/cross_decode.cu",
         "replaces": "whisper_nemo_tpu/ops/cross_decode.py:261",
         "launches": main_run["launches_a_beam"], **a[5]},
        {"name": "encoder_attention", "route": "cuda",
         "source": "whisper_nemo_tpu_torch/csrc/encoder_attention.cu",
         "replaces": "whisper_nemo_tpu/ops/attention.py:91",
         "launches": main_run["launches_b"], **b["whisper"]},
        {"name": "viterbi_batch", "route": "cuda",
         "source": "whisper_nemo_tpu_torch/csrc/viterbi.cu",
         "replaces": "whisper_nemo_tpu/ops/viterbi_pallas.py:101",
         "launches": main_run["launches_d"], **d["a"]},
        {"name": "self_attention_decode_ancestry_layered", "route": "cuda",
         "source": "whisper_nemo_tpu_torch/csrc/self_decode.cu",
         "replaces": "whisper_nemo_tpu/ops/self_decode.py:198",
         "launches": main_run["launches_e"], **e[("bfloat16", 127, False)]},
        # the CLI's default width (6d): kernel E on the f32 cache
        {"name": "self_attention_decode_ancestry_layered (f32, the default width)",
         "route": "cuda", "source": "whisper_nemo_tpu_torch/csrc/self_decode.cu",
         "replaces": "whisper_nemo_tpu/ops/self_decode.py:198",
         "launches": default["launches_e"], **e[("float32", 127, False)]},
        # kernel F lies on no path of the port (nor of the JAX package)
        {"name": "beam_permute_cache", "route": "cuda",
         "source": "whisper_nemo_tpu_torch/csrc/beam_permute.cu",
         "replaces": "whisper_nemo_tpu/ops/beam_permute.py:48",
         "launches": main_run["launches_f"][0], **f["out of place"]},
        {"name": "beam_permute_cache_inplace", "route": "cuda",
         "source": "whisper_nemo_tpu_torch/csrc/beam_permute.cu",
         "replaces": "whisper_nemo_tpu/ops/beam_permute.py:120",
         "launches": main_run["launches_f"][1], **f["in place"]},
        # the sequential path (6c, the timed request): kernel C, and A, B
        # and E at its batch-1 shapes
        {"name": "log_mel_raw", "route": "cuda", "source": "whisper_nemo_tpu_torch/csrc/log_mel.cu",
         "replaces": "whisper_nemo_tpu/ops/mel.py:149",
         "launches": seq["timed"]["launches"][0], **c[(80, 1)]},
        # the batched path's mel (6, the greedy request: one launch a batch)
        {"name": "log_mel_raw (batched, B=32)", "route": "cuda",
         "source": "whisper_nemo_tpu_torch/csrc/log_mel.cu",
         "replaces": "whisper_nemo_tpu/ops/mel.py:149",
         "launches": main_run["launches_c"], **c[(80, 32)]},
        {"name": "encoder_attention (sequential, B=1)", "route": "cuda",
         "source": "whisper_nemo_tpu_torch/csrc/encoder_attention.cu",
         "replaces": "whisper_nemo_tpu/ops/attention.py:91",
         "launches": seq["timed"]["launches"][1], **s3["B"]},
        {"name": "cross_attention_decode_layered (sequential, W=1 beam 5 and sampled)",
         "route": "cuda", "source": "whisper_nemo_tpu_torch/csrc/cross_decode.cu",
         "replaces": "whisper_nemo_tpu/ops/cross_decode.py:261",
         "launches": seq["timed"]["launches"][2], **s3["A beam 5"]},
        {"name": "self_attention_decode_ancestry_layered (sequential, B·K=5 S=384)",
         "route": "cuda", "source": "whisper_nemo_tpu_torch/csrc/self_decode.cu",
         "replaces": "whisper_nemo_tpu/ops/self_decode.py:198",
         "launches": seq["timed"]["launches"][3], **s3["E bfloat16"]},
        # the CLI flow at full width (6f): each kernel at each shape the flow launched it at
        # (6g), with its launches there
        *flow_entries,
        # the serving handler at full width (6h): A, B and C at each shape it launched them at
        # (6i), with their launches there
        *serving_entries,
        # the parallel CLI flow at full width (6j, in process): B (f32 split and the bf16
        # aligner), C, D and E at each shape it launched them at, with their launches there
        *parallel_entries,
        # BASELINE config 3 through the CLI (6k: large-v3 "default", stemming): B, C, D and E
        # at each shape it launched them at (6l), with their launches there
        *config3_entries,
        # the converted checkpoints (5j: medium.en "float16" greedy from the converted .pt, the
        # converted aligner): A, B and C at each shape they launched them at, with their launches
        *converted_entries,
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    # kernels A, C and E also carry their profiler device time beside the events' ms, and
    # kernel C its error against float64
    kernels = [{k: entry[k] for k in keys + ("device_ms", "max_abs_err_f64") if k in entry}
               for entry in kernels]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

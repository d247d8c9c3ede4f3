"""The sequential diarized-transcription flow, stage by stage.

Counterpart of ``whisper_nemo_tpu/cli/flow.py``, the flow behind
``diarize.py`` (reference diarize.py:93-261): optional source separation
-> Whisper ASR -> forced alignment -> mono WAV handoff -> diarization ->
word/speaker mapping -> punctuation -> realignment -> sentences -> txt
and SRT writers -> cleanup. Same flags, defaults and compute widths
(``mtypes``, keyed on the ``--device`` string). What differs:

- ``--device``: ``auto`` and ``cuda`` run on the GPU (``cuda:N`` on that
  one) and raise without CUDA, naming ``--device cpu``; ``cpu`` runs on
  the host. The resolved device is passed to every model.
- Stemming: without ``htdemucs.npz`` the flow warns and goes on with the
  original audio, as the JAX flow does; any other error of the separator
  raises, where the JAX flow catches every exception (on the card that
  would hide a CUDA fault).
- Punctuation: only a model that cannot be read (``tokenizers`` missing,
  an unreadable checkpoint) falls back to the original punctuation; any
  other error raises, where the JAX flow catches every exception.
- ``--mesh`` / ``WNT_MESH`` raise: a device mesh needs more than one
  GPU. ``run_parallel`` runs on one card, its two branches on streams of
  their own (``parallel/branch.py``), or with ``--subprocess-diarization``
  the diarizer in a child process (``cli/nemo_process.py``).
"""

from __future__ import annotations

import argparse
import logging
import os
import subprocess
import sys
import tempfile
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .. import asr as fw
from ..align import (
    generate_emissions,
    get_alignments,
    get_spans,
    load_alignment_model,
    postprocess_results,
    preprocess_text,
)
from ..audio import write_wav
from ..config import create_config
from ..engine.checkpoint import model_cache_dir
from ..models.htdemucs import separate_vocals
from ..models.punctuation import PunctuationModel
from ..post import (
    apply_punctuation_labels,
    get_realigned_ws_mapping_with_punctuation,
    get_sentences_speaker_mapping,
    get_speaker_aware_transcript,
    get_words_speaker_mapping,
    write_srt,
)
from ..text.languages import langs_to_iso, process_language_arg, punct_model_langs, whisper_langs
from ..text.tokenizer import find_numeral_symbol_tokens
from ..utils import cleanup, get_logger
from ..utils.logging import stage_timer

logger = get_logger(__name__)

# compute width by the user's --device string: the JAX flow's table, kept
# whole ("tpu" is never read here, since resolve_device refuses that device)
mtypes = {"cpu": "int8", "cuda": "float16", "tpu": "int8", "auto": "default"}

_MULTI_DEVICE = "not ported yet (ROADMAP.md queue 1, item 6b: it needs more than one GPU)"


def build_arg_parser(parallel: bool = False) -> argparse.ArgumentParser:
    """The reference CLI's flag surface (diarize.py:39-92; divergent
    defaults of the parallel variant at diarize_parallel.py:62,70)."""
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "-a", "--audio", help="name of the target audio file", required=True
    )
    parser.add_argument(
        "--no-stem",
        action="store_false",
        dest="stemming",
        default=True,
        help="Disables source separation. "
        "This helps with long files that don't contain a lot of music.",
    )
    parser.add_argument(
        "--suppress_numerals",
        action="store_true",
        dest="suppress_numerals",
        default=False,
        help="Suppresses Numerical Digits. "
        "This helps the diarization accuracy but converts all digits into "
        "written text.",
    )
    parser.add_argument(
        "--whisper-model",
        dest="model_name",
        default="large-v2" if parallel else "medium.en",
        help="name of the Whisper model to use",
    )
    parser.add_argument(
        "--batch-size",
        type=int,
        dest="batch_size",
        default=4 if parallel else 8,
        help="Batch size for batched inference, reduce if you run out of "
        "memory, set to 0 for original whisper longform inference",
    )
    parser.add_argument(
        "--language",
        type=str,
        default=None,
        choices=whisper_langs,
        help="Language spoken in the audio, specify None to perform "
        "language detection",
    )
    parser.add_argument(
        "--device",
        dest="device",
        default="auto",
        help="'auto' and 'cuda' run on the GPU ('cuda:N' on GPU N) and fail "
        "without one; 'cpu' forces host execution",
    )
    parser.add_argument(
        "--mesh",
        dest="mesh",
        default=None,
        help="device mesh for the ASR branch, e.g. 'dp=4,tp=2' "
        "('dp' = all-device data parallelism; defaults to the WNT_MESH "
        "environment variable; unset = single device)",
    )
    parser.add_argument(
        "--domain",
        dest="domain",
        default="telephonic",
        choices=["telephonic", "meeting", "general"],
        help="diarizer domain preset (the reference hardcodes telephonic)",
    )
    parser.add_argument(
        "--num-speakers",
        type=int,
        dest="num_speakers",
        default=None,
        help="force an exact speaker count (default: estimate)",
    )
    parser.add_argument(
        "--max-speakers",
        type=int,
        dest="max_speakers",
        default=None,
        help="cap the estimated speaker count",
    )
    if parallel:
        parser.add_argument(
            "--subprocess-diarization",
            action="store_true",
            dest="subprocess_diarization",
            default=False,
            help="run the diarization branch in a child OS process "
            "(the reference's isolation mechanism) instead of an "
            "in-process thread",
        )
    return parser


def resolve_device(choice: str) -> str:
    """``--device`` -> the torch device every stage runs on."""
    if choice in ("auto", "cuda") or choice.startswith("cuda:"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--device {choice}: no CUDA device is available; pass --device cpu"
                " to run on the CPU"
            )
        return "cuda" if choice == "auto" else choice
    if choice == "cpu":
        return "cpu"
    raise ValueError(f"--device {choice!r}: expected auto, cuda, cuda:N or cpu")


def _refuse_mesh(args) -> None:
    mesh = getattr(args, "mesh", None) or os.environ.get("WNT_MESH", "")
    if mesh:
        raise NotImplementedError(f"--mesh / WNT_MESH ({mesh!r}): a device mesh is {_MULTI_DEVICE}")


def maybe_separate_vocals(audio_path: str, stemming: bool, device: str, temp_dir: str) -> str:
    """Source separation (reference diarize.py:95-116) on ``device``:
    ``temp_dir/htdemucs/<track>/vocals.wav``. With no ``htdemucs.npz`` the
    flow warns and goes on with the original audio, as the JAX flow does;
    any other failure raises."""
    if not stemming:
        return audio_path
    ckpt = os.path.join(model_cache_dir(), "htdemucs.npz")
    if not os.path.exists(ckpt):
        logging.warning(
            "Source splitting failed, using original audio file. "
            "Use --no-stem argument to disable it. (%s)",
            f"no separator checkpoint at {ckpt}; skipping source separation",
        )
        return audio_path
    return separate_vocals(audio_path, temp_dir, device)


@dataclass
class AsrResult:
    full_transcript: str
    language: str
    audio: np.ndarray
    segments: Optional[list] = None  # timed segments (batched path)


def run_asr(
    vocal_target: str,
    model_name: str,
    batch_size: int,
    language: Optional[str],
    suppress_numerals: bool,
    device: str,
    compute_type: str = "default",
) -> AsrResult:
    """Whisper stage (reference diarize.py:119-151) on ``device`` at
    ``compute_type``; the facade's default beam 5."""
    model = fw.WhisperModel(model_name, device=device, compute_type=compute_type)
    pipeline = fw.BatchedInferencePipeline(model)
    audio = fw.decode_audio(vocal_target)
    suppress = (
        find_numeral_symbol_tokens(model.hf_tokenizer)
        if suppress_numerals
        else [-1]
    )
    if batch_size > 0:
        segments, info = pipeline.transcribe(
            audio, language, suppress_tokens=suppress, batch_size=batch_size
        )
    else:
        # the engine maps the sequential path's segment times from the
        # VAD-concatenated audio back to the recording's, so the
        # per-segment alignment serves this path too
        segments, info = model.transcribe(
            audio, language, suppress_tokens=suppress, vad_filter=True
        )
    segments = list(segments)
    timed = [{"start": s.start, "end": s.end, "text": s.text} for s in segments]
    text = "".join(s.text for s in segments)
    return AsrResult(text, info.language, audio, timed)


def run_alignment(
    audio: np.ndarray,
    full_transcript: str,
    language: str,
    batch_size: int,
    device: str,
    timed_segments: Optional[list] = None,
) -> List[dict]:
    """Forced-alignment stage (reference diarize.py:153-184), the aligner
    in bf16 off the CPU. With timed ASR segments, each segment aligns
    against its own audio span; otherwise the whole transcript aligns
    globally."""
    if not full_transcript.strip():
        logging.warning("empty transcript; skipping forced alignment")
        return []
    model, tokenizer = load_alignment_model(
        device, dtype="bfloat16" if device != "cpu" else None
    )
    iso = langs_to_iso.get(language, "eng")
    if timed_segments:
        from ..align.segmented import align_segments

        return align_segments(
            model,
            tokenizer,
            audio,
            timed_segments,
            language=iso,
            batch_size=max(batch_size, 1),
            device=device,
        )
    emissions, stride = generate_emissions(
        model, audio, batch_size=max(batch_size, 1)
    )
    tokens_starred, text_starred = preprocess_text(
        full_transcript, romanize=True, language=iso
    )
    segments, scores, blank = get_alignments(emissions, tokens_starred, tokenizer, device=device)
    spans = get_spans(tokens_starred, segments, blank)
    return postprocess_results(text_starred, spans, stride, scores)


def run_diarization(
    audio: np.ndarray,
    temp_path: str,
    domain: str = "telephonic",
    num_speakers: Optional[int] = None,
    max_speakers: Optional[int] = None,
    device: str = "cuda",
) -> List[List[int]]:
    """Diarization stage (reference diarize.py:186-216): the mono WAV
    handoff, ``NeuralDiarizer`` on ``device``, the RTTM read back. The
    speaker-count flags take the waveform call (main.py:144-161)."""
    from ..diarize import NeuralDiarizer, read_speaker_timestamps
    from ..diarize.rttm import write_rttm

    os.makedirs(temp_path, exist_ok=True)
    write_wav(os.path.join(temp_path, "mono_file.wav"), audio)
    diarizer = NeuralDiarizer(create_config(temp_path, domain), device=device)
    if num_speakers is None and max_speakers is None:
        diarizer.diarize()
    else:
        turns = diarizer.diarize_waveform(
            audio, num_speakers=num_speakers, max_speakers=max_speakers
        )
        out_dir = os.path.join(temp_path, "pred_rttms")
        os.makedirs(out_dir, exist_ok=True)
        write_rttm(os.path.join(out_dir, "mono_file.rttm"), turns)
    rttm = os.path.join(temp_path, "pred_rttms", "mono_file.rttm")
    return read_speaker_timestamps(rttm)


def maybe_restore_punctuation(wsm: List[dict], language: str, device: str = "cuda") -> List[dict]:
    """Punctuation stage with the reference's language gate
    (diarize.py:220-250). A model that cannot be read leaves the original
    punctuation; an error while it runs raises."""
    if language not in punct_model_langs:
        logging.warning(
            f"Punctuation restoration is not available for {language} "
            "language. Using the original punctuation."
        )
        return wsm
    try:
        model = PunctuationModel(model="kredor/punctuate-all", device=device)
    except (ImportError, OSError, ValueError, KeyError) as exc:
        logging.warning("Punctuation restoration unavailable (%s)", exc)
        return wsm
    labeled = model.predict([w["word"] for w in wsm], chunk_size=230)
    return apply_punctuation_labels(wsm, labeled)


def write_outputs(ssm: List[dict], audio_path: str) -> None:
    """txt + SRT next to the input (reference diarize.py:255-259)."""
    base = os.path.splitext(audio_path)[0]
    with open(f"{base}.txt", "w", encoding="utf-8-sig") as f:
        get_speaker_aware_transcript(ssm, f)
    with open(f"{base}.srt", "w", encoding="utf-8-sig") as srt:
        write_srt(ssm, srt)


def run_sequential(args) -> None:
    """The full sequential CLI flow (reference diarize.py)."""
    _refuse_mesh(args)
    device = resolve_device(args.device)
    compute = mtypes.get(args.device, "default")
    language = process_language_arg(args.language, args.model_name)
    temp_path = os.path.join(os.getcwd(), "temp_outputs")

    vocal_target = maybe_separate_vocals(args.audio, args.stemming, device, temp_path)

    with stage_timer("asr", logger):
        asr = run_asr(
            vocal_target,
            args.model_name,
            args.batch_size,
            language,
            args.suppress_numerals,
            device,
            compute,
        )
    with stage_timer("alignment", logger):
        word_timestamps = run_alignment(
            asr.audio, asr.full_transcript, asr.language,
            args.batch_size, device, timed_segments=asr.segments,
        )
    with stage_timer("diarization", logger):
        speaker_ts = run_diarization(
            asr.audio, temp_path, args.domain,
            num_speakers=getattr(args, "num_speakers", None),
            max_speakers=getattr(args, "max_speakers", None),
            device=device,
        )

    _merge_and_write(word_timestamps, speaker_ts, asr.language, args.audio, device)
    cleanup(temp_path)


def _merge_and_write(word_timestamps, speaker_ts, language, audio_path, device="cuda"):
    if not speaker_ts:
        speaker_ts = [[0, int(1e10), 0]]  # silence-only: single speaker
    wsm = get_words_speaker_mapping(word_timestamps, speaker_ts, "start")
    wsm = maybe_restore_punctuation(wsm, language, device)
    wsm = get_realigned_ws_mapping_with_punctuation(wsm)
    ssm = get_sentences_speaker_mapping(wsm, speaker_ts)
    write_outputs(ssm, audio_path)


def run_parallel(args) -> None:
    """The branch-parallel flow (reference diarize_parallel.py): the
    diarization branch runs beside ASR and alignment. In process, the two
    branches run in threads through ``parallel.branch.asr_and_diarization``
    (on one card each on a CUDA stream of its own; with more cards,
    diarization on the last). With ``--subprocess-diarization``, a child
    process (``python -m whisper_nemo_tpu_torch.cli.nemo_process``, the
    reference's mechanism) diarizes while the parent runs ASR and
    alignment; the join checks its exit code and reads its RTTM. Then the
    mapping, punctuation and writers, as ``run_sequential``."""
    _refuse_mesh(args)
    device = resolve_device(args.device)
    compute = mtypes.get(args.device, "default")
    language = process_language_arg(args.language, args.model_name)
    temp_path = os.path.join(os.getcwd(), "temp_outputs")

    vocal_target = maybe_separate_vocals(args.audio, args.stemming, device, temp_path)
    audio = fw.decode_audio(vocal_target)

    def asr_branch(devices):
        dev = str(devices[0])
        with stage_timer("asr", logger):
            asr = run_asr(vocal_target, args.model_name, args.batch_size, language,
                          args.suppress_numerals, dev, compute)
        with stage_timer("alignment", logger):
            word_timestamps = run_alignment(audio, asr.full_transcript, asr.language,
                                            args.batch_size, dev, timed_segments=asr.segments)
        return asr, word_timestamps

    if getattr(args, "subprocess_diarization", False):
        package_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (package_root, env.get("PYTHONPATH")) if p)
        # the child's stderr goes to a file: a pipe left unread while ASR
        # runs would stall the child once its buffer fills
        with tempfile.TemporaryFile() as err:
            child = subprocess.Popen(
                [sys.executable, "-m", "whisper_nemo_tpu_torch.cli.nemo_process",
                 "-a", vocal_target, "--device", args.device, "--domain", args.domain],
                stderr=err, env=env,
            )
            try:
                asr, word_timestamps = asr_branch([torch.device(device)])
            except BaseException:
                child.kill()
                raise
            finally:
                child.wait()
            if child.returncode != 0:
                err.seek(0)
                raise RuntimeError(
                    "Diarization branch (child process) failed:\n"
                    + err.read().decode(errors="replace")
                )
        from ..diarize import read_speaker_timestamps

        speaker_ts = read_speaker_timestamps(
            os.path.join(temp_path, "pred_rttms", "mono_file.rttm"))
    else:
        from ..parallel.branch import asr_and_diarization

        def diar_branch(devices):
            with stage_timer("diarization", logger):
                return run_diarization(
                    audio, temp_path, args.domain,
                    num_speakers=getattr(args, "num_speakers", None),
                    max_speakers=getattr(args, "max_speakers", None),
                    device=str(devices[0]),
                )

        # "cuda" spreads the branches over every visible card; a named
        # device holds both
        (asr, word_timestamps), speaker_ts = asr_and_diarization(
            asr_branch, diar_branch,
            devices=None if device == "cuda" else [torch.device(device)])

    _merge_and_write(word_timestamps, speaker_ts, asr.language, args.audio, device)
    cleanup(temp_path)

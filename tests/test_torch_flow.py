"""The port's CLI flow against the JAX package's, end to end on the CPU.

Both flows run ``run_sequential`` in one process on ``tests/assets/test.opus``
(22.6 s) with ``stemming=False``, ``batch_size=2``, ``language="en"`` and
``device="cpu"``, each on its own copy of the audio in its own working
directory (the writers put the outputs beside the input), and their
``.txt`` and ``.srt`` bytes must be equal.

Both read one ``$WNT_MODEL_DIR``, saved once by the JAX package's
``save_params``: the Whisper tree at the small dims of
``tests/test_torch_slice.py`` under the name ``tiny.en``, the small
aligner, a small TitaNet as ``titanet_large.npz``, the telephonic MSDD, and
the punctuation model at the small dims; and ``chip_smoke.word_vocab``, a
``vocab.json`` whose tokens are words, some capitalised or ending in "."
or ",", so that the random decode gives words to align, punctuate and
split into sentences. Without
the trees each package would draw its own random init, and ``jax.random``
draws cannot be replayed in torch. Both packages take the full widths for
``tiny.en``, for TitaNet-large and for a punctuation checkpoint, so the
test points those at the small trees' dims in both.

Both flows' ``mtypes["cpu"]`` are set to ``"default"``: at ``"int8"`` the
port's step logits agree with JAX only to 0.02 (``tests/test_torch_whisper.py``),
which can flip a near-tie among the random weights' steps; at f32 they
agree to about 1e-4. The dense labels of two eigensolvers agree only where
the Laplacian's eigengap is clear, so the port's ``stats["eigengap"]`` is
asserted above 1e-3 first (0.41 on this audio at these widths).

The port's ``run_parallel`` runs twice at the same arguments. In process
(its two branches in threads) it must write the JAX sequential flow's
bytes: the JAX package's parallel flow on one device computes what its
sequential flow computes. With ``--subprocess-diarization`` the diarizer
runs in a child process, which the monkeypatches of this process do not
reach: its model directory holds TitaNet as a converted Jasper stack
(``conv_asr``) with the ``titanet_large.cfg.json`` sidecar that both
packages read, so the child builds it at the test's dims. Its reference
is the JAX flow on that directory: the JAX sequential run's words (ASR
and alignment read no diarizer checkpoint) with the JAX diarizer's turns
on that directory, through the JAX flow's ``_merge_and_write``. The
child runs on one torch thread (``OMP_NUM_THREADS``), as this process.
"""

import argparse
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys

import pytest

import whisper_nemo_tpu.cli.flow as jax_flow
import whisper_nemo_tpu.diarize.pipeline as jax_pipeline
import whisper_nemo_tpu.models.punctuation as jax_punct
import whisper_nemo_tpu_torch.cli.flow as flow
import whisper_nemo_tpu_torch.diarize.pipeline as pipeline
import whisper_nemo_tpu_torch.models.punctuation as punctuation
from chip_smoke import DIAR_GAP, write_word_vocab
from test_torch_diarize_models import (  # noqa: F401  (_one_blas_thread: autouse)
    JASPER, MSDD, N_MELS, TITANET, _one_blas_thread, _seeded_tree)
from test_torch_diarize_pipeline import PORT_TITANET
from test_torch_post import OPUS, REPO, port_decoder  # noqa: F401  (a fixture)
from test_torch_slice import DIMS, _one_torch_thread, built_decoder  # noqa: F401  (autouse; a fixture)
from whisper_nemo_tpu.engine.checkpoint import save_params
from whisper_nemo_tpu.models import conv_asr as jax_conv_asr
from whisper_nemo_tpu.models import msdd as jax_msdd
from whisper_nemo_tpu.models import titanet as jax_titanet
from whisper_nemo_tpu.models import wav2vec2 as jax_w2v
from whisper_nemo_tpu.models import whisper as jw
from whisper_nemo_tpu_torch.models import whisper as tw

BOM = b"\xef\xbb\xbf"



@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("flow_models")
    small_whisper = jw.WhisperDims(*DIMS)
    save_params(str(tmp / "tiny.en.npz"), _seeded_tree(jw.init_whisper_params, small_whisper, seed=1))
    save_params(str(tmp / "ctc_aligner.npz"), _seeded_tree(
        jax_w2v.init_wav2vec2_params, jax_w2v.Wav2Vec2Dims(
            vocab_size=39, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
            conv_dim=(32,) * 7), seed=2))
    save_params(str(tmp / "titanet_large.npz"),
                _seeded_tree(jax_titanet.init_titanet_params, TITANET, seed=11))
    save_params(str(tmp / "diar_msdd_telephonic.npz"), _seeded_tree(
        jax_msdd.init_msdd_params, jax_msdd.MsddDims(n_scales=5, emb_dim=TITANET.emb_dim,
                                                     hidden=MSDD.hidden, proj=MSDD.proj), seed=12))
    small_xlmr = vars(punctuation.SMALL_DIMS)
    save_params(str(tmp / "kredor_punctuate-all.npz"), _seeded_tree(
        jax_punct.init_xlmr_params, jax_punct.XlmRobertaDims(**small_xlmr), seed=13))
    write_word_vocab(str(tmp))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WNT_MODEL_DIR", str(tmp))
        mp.setenv("WNT_TEST_SMALL_MODELS", "1")
        mp.delenv("WNT_MESH", raising=False)
        mp.setitem(jw.WHISPER_DIMS, "tiny.en", small_whisper)
        mp.setitem(tw.WHISPER_DIMS, "tiny.en", tw.WhisperDims(*DIMS))
        mp.setattr(jax_pipeline, "_TITANET_LARGE", TITANET)
        mp.setattr(pipeline, "_TITANET_LARGE", PORT_TITANET)
        mp.setattr(jax_punct, "XlmRobertaDims", functools.partial(jax_punct.XlmRobertaDims, **small_xlmr))
        mp.setattr(punctuation, "XlmRobertaDims",
                   functools.partial(punctuation.XlmRobertaDims, **small_xlmr))
        mp.setitem(jax_flow.mtypes, "cpu", "default")
        mp.setitem(flow.mtypes, "cpu", "default")
        yield tmp


@pytest.fixture(scope="module")
def flows(model_dir, port_decoder, tmp_path_factory):  # noqa: F811
    """Each flow's output bytes and working directory, and the port's
    diarizer stats and punctuation rows."""
    stats, rows, jax_words = {}, [], []
    out = {"stats": stats, "rows": rows, "jax_words": jax_words}
    waveform_call = pipeline.NeuralDiarizer.diarize_waveform
    apply_labels = flow.apply_punctuation_labels
    jax_alignment = jax_flow.run_alignment

    def run_alignment(audio, transcript, language, *args, **kw):
        jax_words.append((jax_alignment(audio, transcript, language, *args, **kw), language))
        return jax_words[-1][0]

    def diarize_waveform(self, audio, **kw):
        return waveform_call(self, audio, stats=stats, **kw)

    def apply_punctuation_labels(wsm, labeled):
        rows.append((len(wsm), len(labeled)))
        return apply_labels(wsm, labeled)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline.NeuralDiarizer, "diarize_waveform", diarize_waveform)
        mp.setattr(flow, "apply_punctuation_labels", apply_punctuation_labels)
        mp.setattr(jax_flow, "run_alignment", run_alignment)
        for name, module in (("port", flow), ("jax", jax_flow)):
            work = tmp_path_factory.mktemp(f"flow_{name}")
            shutil.copy(OPUS, work / "call.opus")
            mp.chdir(work)
            module.run_sequential(argparse.Namespace(
                audio=str(work / "call.opus"), stemming=False, suppress_numerals=False,
                model_name="tiny.en", batch_size=2, language="en", device="cpu",
                domain="telephonic"))
            out[name] = {"txt": (work / "call.txt").read_bytes(),
                         "srt": (work / "call.srt").read_bytes(), "work": work}
    return out


def _args(audio, **kw):
    return argparse.Namespace(
        audio=str(audio), stemming=False, suppress_numerals=False, model_name="tiny.en",
        batch_size=2, language="en", device="cpu", domain="telephonic", **kw)


def _jasper_dir(model_dir, tmp):
    """``model_dir``'s checkpoints with TitaNet as a seeded converted Jasper
    stack at the test's dims and its ``.cfg.json`` sidecar."""
    for name in os.listdir(model_dir):
        if name != "titanet_large.npz":
            os.symlink(model_dir / name, tmp / name)
    save_params(str(tmp / "titanet_large.npz"), _seeded_tree(
        lambda key: jax_conv_asr.init_conv_asr_params(key, JASPER, N_MELS, emb_dim=20,
                                                      attn_hidden=16), seed=14))
    (tmp / "titanet_large.cfg.json").write_text(json.dumps(
        {"blocks": [dataclasses.asdict(c) for c in JASPER], "n_mels": N_MELS, "emb_dim": 20}))
    return tmp


@pytest.fixture(scope="module")
def parallel_flows(model_dir, flows, tmp_path_factory):
    """The bytes of the port's ``run_parallel`` in process (on
    ``model_dir``) and with ``--subprocess-diarization`` (on the Jasper
    directory), the JAX reference of the latter, and the port's eigengap
    on that directory."""
    out = {}
    jasper = _jasper_dir(model_dir, tmp_path_factory.mktemp("flow_jasper_models"))
    with pytest.MonkeyPatch.context() as mp:
        for name, directory, child in (("in_process", model_dir, False),
                                       ("subprocess", jasper, True)):
            work = tmp_path_factory.mktemp(f"flow_parallel_{name}")
            shutil.copy(OPUS, work / "call.opus")
            mp.chdir(work)
            mp.setenv("WNT_MODEL_DIR", str(directory))
            mp.setenv("OMP_NUM_THREADS", "1")
            flow.run_parallel(_args(work / "call.opus", subprocess_diarization=child))
            out[name] = {"txt": (work / "call.txt").read_bytes(),
                         "srt": (work / "call.srt").read_bytes(), "work": work}

        work = tmp_path_factory.mktemp("flow_jasper_jax")
        shutil.copy(OPUS, work / "call.opus")
        mp.chdir(work)
        audio = jax_flow.fw.decode_audio(str(work / "call.opus"))
        turns = jax_flow.run_diarization(audio, str(work / "temp_outputs"))
        words, language = flows["jax_words"][0]
        jax_flow._merge_and_write(words, turns, language, str(work / "call.opus"))
        out["jax_jasper"] = {"txt": (work / "call.txt").read_bytes(),
                             "srt": (work / "call.srt").read_bytes()}
        stats = {}
        diarizer = pipeline.NeuralDiarizer(flow.create_config(str(work / "probe"), "telephonic"),
                                           device="cpu")
        assert diarizer._spk_cfgs is not None
        diarizer.diarize_waveform(audio, stats=stats)
        out["jasper_stats"] = stats
    return out


def test_flow_writes_the_jax_flows_bytes(flows):
    assert flows["stats"]["path"] == "dense" and flows["stats"]["eigengap"] > DIAR_GAP
    assert flows["port"]["srt"] == flows["jax"]["srt"]
    assert flows["port"]["txt"] == flows["jax"]["txt"]


def test_flow_runs_every_stage(flows):
    """Words came out of ASR and alignment, the punctuation model labelled
    each (not the fallback), the diarizer found more than one speaker, the
    files carry the BOM, and temp_outputs is gone."""
    n_words, n_labels = flows["rows"][0]
    assert n_words == n_labels > 20 and len(flows["rows"]) == 1
    assert flows["stats"]["speakers"] > 1
    srt = flows["port"]["srt"].decode("utf-8-sig")
    cues = srt.strip().split("\n\n")
    assert flows["port"]["srt"].startswith(BOM) and flows["port"]["txt"].startswith(BOM)
    assert [c.split("\n")[0] for c in cues] == [str(i + 1) for i in range(len(cues))]
    assert len(cues) > 1 and len({c.split("\n")[2].split(":")[0] for c in cues}) > 1
    for name in ("port", "jax"):
        assert sorted(os.listdir(flows[name]["work"])) == ["call.opus", "call.srt", "call.txt"]


def test_cli_entry_point_runs():
    proc = subprocess.run([sys.executable, "-m", "whisper_nemo_tpu_torch.cli", "--help"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--whisper-model" in proc.stdout and "--device" in proc.stdout
    assert all(flag in proc.stdout for flag in ("--no-stem", "--batch-size", "--domain"))


@pytest.mark.parametrize("module,flags", [
    ("whisper_nemo_tpu_torch.cli.parallel", ("--subprocess-diarization", "--whisper-model")),
    ("whisper_nemo_tpu_torch.cli.nemo_process", ("--audio", "--device", "--domain"))])
def test_parallel_entry_points_run(module, flags):
    proc = subprocess.run([sys.executable, "-m", module, "--help"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert all(flag in proc.stdout for flag in flags)


def test_parallel_flow_in_process_writes_the_jax_flows_bytes(flows, parallel_flows):
    """``run_parallel`` with its branches in two threads of this process."""
    assert parallel_flows["in_process"]["srt"] == flows["jax"]["srt"]
    assert parallel_flows["in_process"]["txt"] == flows["jax"]["txt"]
    assert sorted(os.listdir(parallel_flows["in_process"]["work"])) == [
        "call.opus", "call.srt", "call.txt"]


def test_parallel_flow_with_a_child_diarizer_writes_the_jax_flows_bytes(parallel_flows):
    """``run_parallel --subprocess-diarization``: the child process
    (``python -m whisper_nemo_tpu_torch.cli.nemo_process``) diarizes with
    the converted Jasper TitaNet it reads at its own dims."""
    stats = parallel_flows["jasper_stats"]
    assert stats["path"] == "dense" and stats["eigengap"] > DIAR_GAP
    got, want = parallel_flows["subprocess"], parallel_flows["jax_jasper"]
    assert got["srt"] == want["srt"] and got["txt"] == want["txt"]
    assert len(want["srt"].decode("utf-8-sig").strip().split("\n\n")) > 1
    assert sorted(os.listdir(got["work"])) == ["call.opus", "call.srt", "call.txt"]

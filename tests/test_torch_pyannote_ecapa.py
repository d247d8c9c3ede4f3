"""The port's PyanNet (pyannote segmentation) and ECAPA-TDNN against the
JAX package's on the CPU, alone and inside the diarizer.

One seeded JAX tree per model at tiny widths (PyanNet: 2 BiLSTM layers of
16; ECAPA: 32 channels in 4 Res2Net groups, 48 aggregated, 16 mel bands),
made as numpy from ``jax.eval_shape`` of the JAX init with every 1-D leaf
off its init value (``_seeded_tree``), is saved with the JAX package's
``save_params`` and loaded with the port's ``load_params``. PyanNet's
empty-class weights are scaled by 60 and its bias set to 1.0: at the
init's scale the random classifier gives every frame a speech probability
near 0.86, above the VAD's onset, and the VAD would find one region. The
diarizer cases run the telephonic preset at three scales on 15 s of three
voices (an audio seed whose Laplacian has the eigengap, asserted), the JAX
package as its own tests run it on the CPU.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import voices
from test_torch_diarize_models import (  # noqa: F401  (_one_blas_thread: autouse)
    N_MELS, TITANET, _one_blas_thread, _seeded_tree)
from test_torch_diarize_pipeline import PORT_TITANET, _configs
from test_torch_slice import _one_torch_thread, built_decoder  # noqa: F401  (autouse; a fixture)
from whisper_nemo_tpu.audio import write_wav
from whisper_nemo_tpu.config import write_manifest
from whisper_nemo_tpu.diarize import pipeline as jax_pipeline
from whisper_nemo_tpu.engine.checkpoint import flatten_tree, save_params
from whisper_nemo_tpu.models import ecapa as jax_ecapa
from whisper_nemo_tpu.models import msdd as jax_msdd
from whisper_nemo_tpu.models import pyannet as jax_pyannet
from whisper_nemo_tpu.models import titanet as jax_titanet
from whisper_nemo_tpu_torch.diarize import NeuralDiarizer, SpeakerDiarizationPipeline
from whisper_nemo_tpu_torch.engine.checkpoint import load_params
from whisper_nemo_tpu_torch.models import ecapa, pyannet

PYANNET = dict(lstm_layers=2, hidden=16)
ECAPA = jax_ecapa.EcapaDims(n_mels=N_MELS, channels=32, agg_channels=48, res2net_scale=4,
                            se_reduction=4, attn_hidden=16, emb_dim=20)
PORT_ECAPA = ecapa.EcapaDims(**ECAPA.__dict__)
PROB_TOL = 1e-5  # PyanNet's speech probabilities
EMB_TOL = 1e-4  # ECAPA's embeddings, relative to their largest entry


def pyannet_tree(seed: int):
    tree = _seeded_tree(lambda key: jax_pyannet.init_pyannet_params(key, **PYANNET), seed=seed)
    tree["classifier"]["w"][:, 0] *= 60.0
    tree["classifier"]["b"][0] = 1.0
    return tree


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{model: (JAX tree, the port's tree loaded from the saved .npz)}."""
    tmp = tmp_path_factory.mktemp("pyannote_ecapa")
    out = {}
    for name, tree in (("pyannet", pyannet_tree(0)),
                       ("ecapa", _seeded_tree(jax_ecapa.init_ecapa_params, ECAPA, seed=1))):
        save_params(str(tmp / f"{name}.npz"), tree)
        out[name] = (tree, load_params(str(tmp / f"{name}.npz"), "cpu"))
    return out


@pytest.mark.parametrize("name", ["pyannet", "ecapa"])
def test_trees_load_in_the_ports_layout(trees, name):
    """Every 3-D array (a conv weight, ``[k, in, out]``) loads as ``[out,
    in, k]``, every other leaf as it is; the port's seeded init has the
    JAX init's keys and (so converted) shapes."""
    jax_tree, port_tree = trees[name]
    theirs = flatten_tree(jax_tree)
    ours = flatten_tree(port_tree)
    assert ours.keys() == theirs.keys()
    for key, value in theirs.items():
        expect = value.transpose(2, 1, 0) if value.ndim == 3 else value
        assert np.array_equal(ours[key], expect), key
    g = torch.Generator().manual_seed(0)
    init = (pyannet.init_pyannet_params("cpu", g, **PYANNET) if name == "pyannet"
            else ecapa.init_ecapa_params(PORT_ECAPA, "cpu", g))
    assert {k: v.shape for k, v in flatten_tree(init).items()} == {
        k: v.shape for k, v in ours.items()}


# JAX's speech_probs compiled once for 15 s of audio, where the JAX diarizer
# runs it op by op: test_diarizer_matches_jax's PyanNet case reuses the compile
jax_speech_probs = jax.jit(jax_pyannet.speech_probs)


def test_pyannet_probs_and_activity_match_jax(trees):
    """Seeded voices: speech probabilities of 15 s within PROB_TOL, and the
    powerset decode of two 3 s waveforms equal (its table and frame rate
    are the JAX package's)."""
    jax_tree, port_tree = trees["pyannet"]
    wave = voices(15.0, 3)[None]
    want = np.asarray(jax_speech_probs(jax_tree, wave))
    got = pyannet.speech_probs(port_tree, torch.from_numpy(wave)).numpy()
    assert got.shape == want.shape == (1, 886) and 0.2 < (got > 0.8).mean() < 0.9
    np.testing.assert_allclose(got, want, atol=PROB_TOL, rtol=0)
    wave = voices(6.0, 3).reshape(2, -1)
    want = np.asarray(jax.jit(jax_pyannet.speaker_activity)(jax_tree, wave))
    got = pyannet.speaker_activity(port_tree, torch.from_numpy(wave)).numpy()
    assert got.shape == (2, 175, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pyannet.powerset_table(), jax_pyannet.powerset_table())
    assert pyannet.frames_per_second() == jax_pyannet.frames_per_second()


def test_bilstm_gate_order_matches_the_jax_layout(trees):
    """The converter's ``wx``/``wh``/``b`` (gates i, f, g, o) through
    ``torch.lstm``: the JAX package's BiLSTM within 1e-5 on features whose
    four gate blocks all differ, and ``lstm_weights`` is exactly what an
    ``nn.LSTM`` holds for it (``weight_ih_l0 = wx.T``, ``_reverse`` for the
    backward direction, a zero ``bias_hh``)."""
    jax_tree, port_tree = trees["pyannet"]
    x = np.random.default_rng(4).standard_normal((2, 9, 60)).astype(np.float32)
    want = np.asarray(jax.jit(jax_pyannet._bilstm)(jax_tree["lstm"], jnp.asarray(x)))
    got = pyannet._bilstm(port_tree["lstm"], torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    module = torch.nn.LSTM(60, PYANNET["hidden"], PYANNET["lstm_layers"], batch_first=True,
                           bidirectional=True)
    with torch.no_grad():
        for dst, src in zip(module._flat_weights, pyannet.lstm_weights(port_tree["lstm"])):
            dst.copy_(src)
        np.testing.assert_array_equal(module(torch.from_numpy(x))[0].numpy(), got)
    fwd = port_tree["lstm"][0]["fwd"]
    assert torch.equal(module.weight_ih_l0, fwd["wx"].t()) and torch.equal(
        module.bias_ih_l0_reverse, port_tree["lstm"][0]["bwd"]["b"])


def test_ecapa_embeddings_match_jax(trees):
    """Windows of 1, 23 and 40 valid frames in one padded batch of 40,
    within EMB_TOL of the largest entry."""
    jax_tree, port_tree = trees["ecapa"]
    x = np.random.default_rng(5).standard_normal((3, 40, N_MELS)).astype(np.float32)
    xt = torch.from_numpy(x.transpose(0, 2, 1).copy())
    lengths = np.array([1, 23, 40], np.int32)
    want = np.asarray(jax.jit(jax_ecapa.embed, static_argnums=3)(
        jax_tree, jnp.asarray(x), jnp.asarray(lengths), ECAPA))
    got = ecapa.embed(port_tree, xt, torch.from_numpy(lengths), PORT_ECAPA).numpy()
    assert got.shape == (3, ECAPA.emb_dim)
    np.testing.assert_allclose(got, want, atol=EMB_TOL * np.abs(want).max(), rtol=0)


@pytest.fixture(scope="module")
def model_dirs(trees, tmp_path_factory, built_decoder):
    """{case: $WNT_MODEL_DIR}: "pyannet" holds pyannote_segmentation.npz
    (no MarbleNet), the tiny TitaNet and the MSDD; "ecapa" holds
    ecapa_tdnn.npz and the MSDD (the energy VAD)."""
    msdd = _seeded_tree(jax_msdd.init_msdd_params, jax_msdd.MsddDims(
        n_scales=3, emb_dim=TITANET.emb_dim, hidden=12, proj=8), seed=12)
    dirs = {}
    for case, files in (("pyannet", {"pyannote_segmentation": trees["pyannet"][0],
                                     "titanet_large": _seeded_tree(
                                         jax_titanet.init_titanet_params, TITANET, seed=11)}),
                        ("ecapa", {"ecapa_tdnn": trees["ecapa"][0]})):
        tmp = tmp_path_factory.mktemp(f"diar_{case}")
        for name, tree in {**files, "diar_msdd_telephonic": msdd}.items():
            save_params(str(tmp / f"{name}.npz"), tree)
        dirs[case] = tmp
    return dirs


@pytest.mark.parametrize("case,seed", [("pyannet", 7), ("ecapa", 3)])
def test_diarizer_matches_jax(model_dirs, case, seed, tmp_path, monkeypatch):
    """15 s of three voices, diarize() from a manifest with the oracle count
    of 3, MSDD on: the same turns and the same RTTM bytes. With PyanNet the
    VAD's probabilities (PyanNet's frames interpolated onto the 10 ms
    grid) agree within PROB_TOL on the way; with ECAPA the config names
    ``ecapa_tdnn``. The dense eigengap is asserted, as in
    ``test_torch_diarize_pipeline``."""
    monkeypatch.setenv("WNT_MODEL_DIR", str(model_dirs[case]))
    monkeypatch.setattr(jax_pyannet, "speech_probs", jax_speech_probs)
    jcfg, pcfg = _configs(tmp_path)
    for cfg in (jcfg, pcfg):
        cfg.diarizer.clustering.parameters.oracle_num_speakers = True
        if case == "ecapa":
            cfg.diarizer.speaker_embeddings.model_path = "ecapa_tdnn"
    write_manifest(pcfg.diarizer.manifest_filepath, str(tmp_path / "mono_file.wav"), num_speakers=3)
    jd, pd = jax_pipeline.NeuralDiarizer(jcfg), NeuralDiarizer(pcfg, device="cpu")
    jd.spk_dims, pd.spk_dims = (TITANET, PORT_TITANET) if case == "pyannet" else (ECAPA, PORT_ECAPA)
    assert (pd.pyannet_params is not None) == (case == "pyannet") and pd.vad_params is None
    probs, stats = [], {}
    for d in (jd, pd):
        d._frame_speech_probs = (lambda *a, _f=d._frame_speech_probs, **k:
                                 probs.append(_f(*a, **k)) or probs[-1])
    pd.diarize_waveform = functools.partial(NeuralDiarizer.diarize_waveform, pd, stats=stats)
    audio = voices(15.0, seed)
    write_wav(str(tmp_path / "mono_file.wav"), audio)
    rttm = tmp_path / "pred_rttms" / "mono_file.rttm"
    want = jd.diarize()
    want_bytes = rttm.read_bytes()
    os.remove(rttm)
    got = pd.diarize()
    assert stats["path"] == "dense" and stats["eigengap"] > 1e-3
    assert got == want and len({s for _, _, s in got}) == 3
    assert rttm.read_bytes() == want_bytes
    np.testing.assert_allclose(probs[1], probs[0], atol=PROB_TOL, rtol=0)
    assert ("vad_pyannet" in stats["seconds"]) == (case == "pyannet")
    if case == "pyannet":  # on the 10 ms grid, about 2/3 of it speech
        assert probs[1].shape == (1500,) and 0.2 < (probs[1] > 0.8).mean() < 0.9


def test_facade_takes_pyannet(model_dirs, monkeypatch):
    """The pyannote-style facade reaches PyanNet where its checkpoint is
    installed, and ``to`` moves its tree."""
    monkeypatch.setenv("WNT_MODEL_DIR", str(model_dirs["pyannet"]))
    facade = SpeakerDiarizationPipeline.from_pretrained("x", device="cpu")
    diarizer = facade.to("cpu").diarizer
    assert diarizer.pyannet_params is not None and diarizer._bench_vad_params is None
    assert diarizer.pyannet_params["convs"][0]["w"].shape == (80, 1, pyannet.SINC_KERNEL)

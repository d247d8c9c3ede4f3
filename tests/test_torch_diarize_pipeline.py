"""The port's clustering and diarizer against the JAX package's on the CPU.

Clustering runs on seeded, separated clusters of embeddings; the diarizer
on seeded audio of three band-distinct voices taking turns, with one JAX
TitaNet and one MSDD tree at tiny widths saved with the JAX package's
``save_params`` into a model directory both packages read. The JAX
package runs as its own tests run it on the CPU (host eigensolvers and
NME search).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_nemo_tpu.diarize.clustering as jax_cl
import whisper_nemo_tpu_torch.audio.decode as port_decode
import whisper_nemo_tpu_torch.diarize.clustering as cl
from chip_smoke import same_partition, voices
from test_torch_diarize_models import _one_blas_thread  # noqa: F401  (autouse)
from test_torch_diarize_models import MARBLENET, MSDD, TITANET, _seeded_tree
from test_torch_slice import _one_torch_thread, built_decoder, no_libav  # noqa: F401  (autouse; fixtures)
from whisper_nemo_tpu import config as jax_config
from whisper_nemo_tpu.audio import write_wav
from whisper_nemo_tpu.diarize import pipeline as jax_pipeline
from whisper_nemo_tpu.engine.checkpoint import save_params
from whisper_nemo_tpu.models import marblenet as jax_marblenet
from whisper_nemo_tpu.models import msdd as jax_msdd
from whisper_nemo_tpu.models import titanet as jax_titanet
from whisper_nemo_tpu_torch import config
from whisper_nemo_tpu_torch.diarize import NeuralDiarizer, SpeakerDiarizationPipeline
from whisper_nemo_tpu_torch.models import marblenet, titanet

SR = 16000
SCALES = dict(window_length_in_sec=(1.5, 1.0, 0.5), shift_length_in_sec=(0.75, 0.5, 0.25),
              multiscale_weights=(1, 1, 1))
PORT_TITANET = titanet.TitaNetDims(**TITANET.__dict__)


def clusters(n: int, k: int, seed: int, dim: int = 32, spread: float = 0.3) -> np.ndarray:
    """n seeded embeddings around k random centers, in turns of 5."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, dim))
    labels = (np.arange(n) // 5) % k
    return (centers[labels] + spread * rng.standard_normal((n, dim))).astype(np.float32)


# -- clustering ---------------------------------------------------------------


def test_affinities_match_jax():
    """The multiscale affinity and the host cosine affinity, within 1e-5."""
    stacked = np.stack([clusters(60, 3, s) for s in range(3)])
    weights = np.array([0.5, 0.3, 0.2])
    want = np.asarray(jax_cl.multiscale_affinity(stacked, weights))
    got = cl.multiscale_affinity(torch.from_numpy(stacked), weights).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(cl.cosine_affinity(stacked[0]), jax_cl.cosine_affinity(stacked[0]),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("n", [200, 600])
def test_nmesc_search_matches_jax(n):
    """(p, count) equal: the port's batched probes on the affinity tensor
    against the JAX host search, below and above the 512 subsample."""
    embs = clusters(n, 4, n)
    want = jax_cl.nmesc_search(jnp.asarray(jax_cl.cosine_affinity(embs)))
    assert cl.nmesc_search(torch.from_numpy(cl.cosine_affinity(embs))) == want


@pytest.mark.parametrize("n, oracle, enhanced", [(200, None, 0), (200, 3, 0), (60, None, 80)])
def test_nme_spectral_clustering_matches_jax(n, oracle, enhanced):
    """Labels equal on a device affinity: estimated count, oracle count,
    and below ``enhanced_count_thres`` (the enhanced count)."""
    embs = clusters(n, 3, n + 1)
    stacked = np.stack([embs, embs + 0.1 * clusters(n, 3, n + 2)])
    kw = dict(num_speakers=oracle, enhanced_count_thres=enhanced)
    want = jax_cl.nme_spectral_clustering(
        jnp.asarray(embs), affinity=jax_cl.multiscale_affinity(stacked, np.array([0.5, 0.5])), **kw)
    got = cl.nme_spectral_clustering(
        torch.from_numpy(embs), affinity=cl.multiscale_affinity(torch.from_numpy(stacked),
                                                                np.array([0.5, 0.5])), **kw)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) == 3


@pytest.mark.parametrize("host", [False, True])
def test_nystrom_path_matches_jax(monkeypatch, host):
    """Past a Nyström threshold lowered to 128 in both packages: labels
    equal to the JAX package's device path, from an affinity tensor and
    from a host affinity, which the port takes to its tensor path (it
    carries no host Nyström)."""
    monkeypatch.setattr(jax_cl, "_NYSTROM_THRESHOLD", 128)
    monkeypatch.setattr(cl, "_NYSTROM_THRESHOLD", 128)
    monkeypatch.setattr(jax_cl, "_NYSTROM_ANCHORS", 64)
    monkeypatch.setattr(cl, "_NYSTROM_ANCHORS", 64)
    embs = clusters(300, 4, 7)
    affinity = cl.cosine_affinity(embs)
    stats = {}
    want = jax_cl.nme_spectral_clustering(jnp.asarray(embs),
                                          affinity=jnp.asarray(jax_cl.cosine_affinity(embs)))
    got = cl.nme_spectral_clustering(torch.from_numpy(embs), stats=stats,
                                     affinity=affinity if host else torch.from_numpy(affinity))
    assert stats["path"] == "nystrom"
    np.testing.assert_array_equal(got, want)


def test_longform_matches_jax_up_to_relabeling():
    """Chunks of 200 over-clustered by the device k-means (torch's draws
    against jax.random's), the means reclustered: the same partition."""
    embs = clusters(450, 3, 8)
    kw = dict(embeddings_per_chunk=200, chunk_cluster_count=12)
    want = jax_cl.longform_cluster(jnp.asarray(embs), **kw)
    stats = {}
    got = cl.longform_cluster(torch.from_numpy(embs), stats=stats, **kw)
    assert stats["path"] == "longform" and len(np.unique(got)) == 3
    assert same_partition(got, want)


# -- the diarizer -------------------------------------------------------------


def _configs(tmp):
    """The telephonic preset of both packages at three scales."""
    jcfg = jax_config.create_config(str(tmp), "telephonic")
    pcfg = config.create_config(str(tmp), "telephonic")
    jcfg.diarizer.speaker_embeddings.parameters = jax_config.SpeakerEmbeddingParams(**SCALES)
    pcfg.diarizer.speaker_embeddings.parameters = config.SpeakerEmbeddingParams(**SCALES)
    return jcfg, pcfg


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, built_decoder):
    """$WNT_MODEL_DIR holding tiny titanet_large.npz and
    diar_msdd_telephonic.npz saved by the JAX package (energy VAD). Its
    tests decode a .wav through ``audio.decode_audio``, which first loads
    (and may build) the libav decoder: ``built_decoder`` builds it under
    its lock."""
    tmp = tmp_path_factory.mktemp("diar_models")
    save_params(str(tmp / "titanet_large.npz"),
                _seeded_tree(jax_titanet.init_titanet_params, TITANET, seed=11))
    save_params(str(tmp / "diar_msdd_telephonic.npz"), _seeded_tree(
        jax_msdd.init_msdd_params, jax_msdd.MsddDims(n_scales=3, emb_dim=TITANET.emb_dim,
                                                     hidden=MSDD.hidden, proj=MSDD.proj), seed=12))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WNT_MODEL_DIR", str(tmp))
        yield tmp


@pytest.fixture(scope="module")
def diarizers(model_dir, tmp_path_factory):
    """(the JAX diarizer, the port's on the CPU, the run directory)."""
    run = tmp_path_factory.mktemp("diar_run")
    jcfg, pcfg = _configs(run)
    jd = jax_pipeline.NeuralDiarizer(jcfg)
    jd.spk_dims = TITANET  # the test checkpoint's widths
    pd = NeuralDiarizer(pcfg, device="cpu")
    pd.spk_dims = PORT_TITANET
    assert pd.msdd_params is not None and pd.vad_params is None
    return jd, pd, run


def test_diarize_waveform_and_rttm_match_jax(diarizers):
    """30 s of three voices: the turns of diarize_waveform equal (MSDD on,
    the oracle count of 3), then diarize() from the manifest's .wav
    writes the same RTTM bytes. The audio's Laplacian has its 3rd and 4th
    smallest eigenvalues apart (asserted): where they coincide, the 3
    eigenvectors are any basis of a larger null space, which LAPACK's and
    torch's eigensolvers pick differently (as two LAPACK builds may)."""
    jd, pd, run = diarizers
    audio = voices(30.0, 1)
    stats = {}
    want = jd.diarize_waveform(audio, num_speakers=3)
    got = pd.diarize_waveform(audio, num_speakers=3, stats=stats)
    assert stats["path"] == "dense" and stats["eigengap"] > 1e-3
    assert got == want and len({s for _, _, s in got}) == 3
    assert stats["msdd_pairs"] == 3 and stats["n_base"] > 80
    write_wav(str(run / "mono_file.wav"), audio)
    rttm = run / "pred_rttms" / "mono_file.rttm"
    want = jd.diarize()
    want_bytes = rttm.read_bytes()
    os.remove(rttm)
    assert pd.diarize() == want
    assert rttm.read_bytes() == want_bytes


def test_silence_gives_no_turns(diarizers):
    assert diarizers[1].diarize_waveform(np.zeros(4 * SR, np.float32)) == []


def test_facade_on_a_wav_matches_jax(model_dir, tmp_path):
    """The pyannote-style facade ("general" preset, no MSDD) on a .wav."""
    path = str(tmp_path / "call.wav")
    write_wav(path, voices(12.0, 1))
    theirs = jax_pipeline.SpeakerDiarizationPipeline.from_pretrained("x", use_auth_token="x")
    theirs.diarizer.spk_dims = TITANET
    ours = SpeakerDiarizationPipeline.from_pretrained("x", device="cpu", use_auth_token="x")
    ours.diarizer.spk_dims = PORT_TITANET

    def rows(result):
        return [(t.start, t.end, i, label) for t, i, label in result.itertracks(yield_label=True)]

    want = rows(theirs(path, min_speakers=1, max_speakers=4))
    assert rows(ours(path, min_speakers=1, max_speakers=4)) == want and want


def test_marblenet_vad_probs_match_jax(model_dir, tmp_path, monkeypatch):
    """With a VAD checkpoint the MarbleNet frame probabilities (after the
    median smoothing) agree within 1e-5."""
    dims = MARBLENET
    save_params(str(tmp_path / "vad_multilingual_marblenet.npz"),
                _seeded_tree(jax_marblenet.init_marblenet_params, dims, seed=13))
    os.link(model_dir / "titanet_large.npz", tmp_path / "titanet_large.npz")
    monkeypatch.setenv("WNT_MODEL_DIR", str(tmp_path))
    jcfg, pcfg = _configs(tmp_path)
    jd, pd = jax_pipeline.NeuralDiarizer(jcfg), NeuralDiarizer(pcfg, device="cpu")
    jd.marblenet_dims = dims
    pd.marblenet_dims = marblenet.MarbleNetDims(**dims.__dict__)
    audio = voices(3.0, 2)
    want = jd._frame_speech_probs(audio)
    got = pd._frame_speech_probs(audio, torch.from_numpy(audio))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_what_is_not_ported_is_refused(tmp_path, monkeypatch, no_libav):
    """Where the libav decoder cannot load (as on the card), a non-WAV
    manifest raises naming libav. The pyannote VAD and ECAPA-TDNN are
    ported and refuse nothing (tests/test_torch_pyannote_ecapa.py)."""
    monkeypatch.setenv("WNT_MODEL_DIR", str(tmp_path))
    _, pcfg = _configs(tmp_path)
    config.write_manifest(pcfg.diarizer.manifest_filepath, str(tmp_path / "call.opus"))
    with pytest.raises(port_decode.AudioDecodeError, match="libav"):
        NeuralDiarizer(pcfg, device="cpu").diarize()

"""The port's alignment slice (wav2vec2 emissions and the segmented CTC
aligner) against the JAX package on the CPU.

Both sides get the same inputs, made with numpy from a seed, and the same
JAX param tree (converted array by array by ``params_from_jax``, or saved
once as the ``ctc_aligner.npz`` both packages load). Tolerances:
- wav2vec2 logits and emissions, f32: 1e-4 absolute, for matrix products
  and convolutions summed in another order;
- on shared emissions the Viterbi is exact (tests/test_torch_ctc.py), so
  word rows are equal, and word scores (float64 means of the same f32
  values) agree to 1e-6;
- end to end, the emissions differ by float rounding and random small
  weights give near-ties, so word starts and ends may move by one frame
  stride; texts and segment indices are equal.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_nemo_tpu.align.segmented as jax_seg
from test_torch_slice import _one_torch_thread  # noqa: F401  (autouse)
from whisper_nemo_tpu.align import api as jax_api
from whisper_nemo_tpu.engine.checkpoint import save_params
from whisper_nemo_tpu.models import wav2vec2 as jax_w2v
from whisper_nemo_tpu.ops.ctc import add_star_column
from whisper_nemo_tpu_torch.align import api, segmented
from whisper_nemo_tpu_torch.engine.checkpoint import params_from_jax
from whisper_nemo_tpu_torch.engine.transcribe import WhisperEngine
from whisper_nemo_tpu_torch.models import wav2vec2
from whisper_nemo_tpu_torch.ops.ctc import NEG_INF

SR = 16000
STRIDE_MS = 20.0


def _small_dims(module, stable):
    return module.Wav2Vec2Dims(vocab_size=39, hidden_size=64, num_layers=2, num_heads=4,
                               intermediate_size=128, conv_dim=(32,) * 7,
                               do_stable_layer_norm=stable)


@pytest.mark.parametrize("stable", [False, True])
def test_ctc_logits_match_jax(stable):
    """Post-LN with the first layer's group norm, and pre-LN
    (``do_stable_layer_norm``) with per-layer conv LayerNorms and conv
    biases added to the tree; f32 on both sides, 1e-4."""
    rng = np.random.default_rng(4)
    jparams = jax_w2v.init_wav2vec2_params(jax.random.PRNGKey(3), _small_dims(jax_w2v, stable))
    if stable:
        for layer in jparams["fe"]["conv_layers"]:
            layer.pop("gn_g", None)
            layer.pop("gn_b", None)
            c = layer["w"].shape[-1]
            layer["ln"] = {"g": 1 + 0.1 * rng.standard_normal(c).astype(np.float32),
                           "b": 0.1 * rng.standard_normal(c).astype(np.float32)}
            layer["cb"] = 0.1 * rng.standard_normal(c).astype(np.float32)
    wave = rng.standard_normal((2, 16000)).astype(np.float32) * 0.1
    want = np.asarray(jax.jit(
        lambda p, w: jax_w2v.ctc_logits(p, w, _small_dims(jax_w2v, stable)))(jparams, wave))
    got = wav2vec2.ctc_logits(params_from_jax(jparams), torch.from_numpy(wave),
                              _small_dims(wav2vec2, stable))
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 49, 39)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_converter_carries_the_wav2vec2_tree():
    """Every array arrives; the conv stack's and the grouped positional
    conv's weights go from [k, in, out] to [out, in, k]."""
    jparams = jax_w2v.init_wav2vec2_params(jax.random.PRNGKey(0), _small_dims(jax_w2v, False))
    params = params_from_jax(jparams)
    for i, layer in enumerate(jparams["fe"]["conv_layers"]):
        np.testing.assert_array_equal(params["fe"]["conv_layers"][i]["w"].numpy(),
                                      np.asarray(layer["w"]).transpose(2, 1, 0))
    np.testing.assert_array_equal(params["enc"]["pos_conv"]["w"].numpy(),
                                  np.asarray(jparams["enc"]["pos_conv"]["w"]).transpose(2, 1, 0))
    np.testing.assert_array_equal(params["enc"]["layers"][1]["ff_in"]["w"].numpy(),
                                  np.asarray(jparams["enc"]["layers"][1]["ff_in"]["w"]))
    ours = wav2vec2.init_wav2vec2_params(_small_dims(wav2vec2, False), "cpu",
                                         torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), params)
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape), ours) == shapes


def _shared_emissions(monkeypatch, em):
    """Both packages' aligners read ``em`` as their emissions."""
    fake = lambda m, a, b, device=False: (em, STRIDE_MS)  # noqa: E731
    monkeypatch.setattr(jax_seg, "generate_emissions", fake)
    monkeypatch.setattr(segmented, "generate_emissions", fake)


def _assert_words_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["text"], g["start"], g["end"], g["segment"]) == (
            w["text"], w["start"], w["end"], w["segment"])
        assert abs(g["score"] - w["score"]) <= 1e-6


def _planted_hi_yo():
    tok = api.AlignmentTokenizer()
    em = np.full((500, 39), np.log(1e-4), np.float32)
    em[:, tok.blank_id] = np.log(0.9)
    for s, c in [(50, "h"), (60, "i"), (300, "y"), (310, "o")]:
        em[s : s + 10, :] = np.log(1e-4)
        em[s : s + 10, tok.vocab[c]] = np.log(0.9)
    segs = [{"start": 0.8, "end": 2.0, "text": "hi"}, {"start": 5.5, "end": 7.0, "text": "yo"}]
    return em, segs


def _random_segments():
    """Seeded emissions; segments in two T buckets (128, 256) and two L
    buckets (32, 64), one empty and one starting at frame 0."""
    rng = np.random.default_rng(9)
    em = np.log(rng.dirichlet(np.ones(39) * 0.3, size=1200).astype(np.float32))
    words = "the quick brown fox jumps over a lazy dog near seven old banks".split()
    segs = []
    for start, dur, n in [(0.0, 1.5, 3), (2.0, 3.5, 6), (6.0, 1.8, 2), (9.0, 4.2, 12),
                          (14.0, 0.8, 1), (15.0, 2.0, 0), (17.0, 5.0, 9)]:
        segs.append({"start": start, "end": start + dur,
                     "text": " ".join(rng.choice(words, size=n))})
    return em, segs


@pytest.mark.parametrize("case", ["planted", "random", "chunked"])
def test_align_segments_on_shared_emissions_match_jax(monkeypatch, case):
    """Planted "hi"/"yo"; seeded random emissions over several segments in
    two buckets; and the same under a tiny group budget, so that every
    group dispatches in one-row chunks. Word rows equal JAX's."""
    em, segs = _planted_hi_yo() if case == "planted" else _random_segments()
    _shared_emissions(monkeypatch, em)
    if case == "chunked":
        monkeypatch.setattr(jax_seg, "_GROUP_BYTES_BUDGET", 1.0)
        monkeypatch.setattr(segmented, "_GROUP_BYTES_BUDGET", 1.0)
    audio = np.zeros(int(len(em) * STRIDE_MS / 1000 * SR), np.float32)
    want = jax_seg.align_segments(None, jax_api.AlignmentTokenizer(), audio, segs)
    stats = {}
    got = segmented.align_segments(None, api.AlignmentTokenizer(), audio, segs, device="cpu",
                                   stats=stats)
    _assert_words_equal(got, want)
    if case == "planted":
        assert [w["text"] for w in got] == ["hi", "yo"]
        assert abs(got[0]["start"] - 1.0) < 0.15 and abs(got[1]["end"] - 6.4) < 0.15
    else:
        assert len(stats["groups"]) >= 3
        if case == "chunked":
            assert all(rows == [1] * len(rows) for rows in stats["groups"].values())


@pytest.mark.parametrize("labels", [[], [7], [3, 3], [5, 9, 9, 2, 39, 5], list(range(1, 40)) * 2])
def test_trellis_helpers_match_jax(labels):
    """The port's numpy slices for the pad labels and the skip rule equal
    the JAX package's loops (no labels, one, repeats, the wildcard, and
    more labels than the bucket holds)."""
    labels = np.asarray(labels, np.int32)
    for l_b in (32, 64):
        ext = segmented._extend_labels(labels, l_b, 40)
        np.testing.assert_array_equal(ext, jax_seg._extend_labels(labels, l_b, 40))
        for got, want in zip(segmented._trellis_arrays(ext, 0), jax_seg._trellis_arrays(ext, 0)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_group_blocks_match_jax():
    """The device block build, state gather, Viterbi and score gather of
    one group (spans that reach the end of the emissions and the idle
    frames past a short span) against JAX's: paths and scores exact."""
    tok = api.AlignmentTokenizer()
    rng = np.random.default_rng(7)
    em_star = add_star_column(rng.standard_normal((700, 39)).astype(np.float32), tok.blank_id)
    t_b, l_b = 128, 32
    spans = [(0, 100), (50, 178), (600, 700), (650, 700)]
    slabels, skips = [], []
    for n in (5, 12, 3, 30):
        labels = segmented._extend_labels(rng.integers(1, 39, size=n).astype(np.int32), l_b,
                                          em_star.shape[1])
        sl, sk = segmented._trellis_arrays(labels, tok.blank_id)
        slabels.append(sl)
        skips.append(sk)
    t0s = [s for s, _ in spans]
    t_effs = [min(e - s, t_b) for s, e in spans]
    em_pad = np.pad(em_star, ((0, 4096), (0, 0)), constant_values=np.float32(NEG_INF))
    want_paths, want_scores = jax_seg._viterbi_group_device(
        jnp.asarray(em_pad), jnp.asarray(t0s, jnp.int32), jnp.asarray(t_effs, jnp.int32),
        jnp.asarray(np.stack(slabels)), jnp.asarray(np.stack(skips)), t_b=t_b, l_b=l_b)
    paths, scores = segmented._viterbi_group_device(
        torch.from_numpy(em_pad), t0s, t_effs, np.stack(slabels), np.stack(skips), t_b, l_b)
    np.testing.assert_array_equal(paths.numpy(), np.asarray(want_paths))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(want_scores))


def test_alignment_end_to_end_matches_jax(tmp_path, monkeypatch):
    """``load_alignment_model("cpu")`` at the small test dims on the JAX
    package's random tree, saved as the ``ctc_aligner.npz`` both packages
    load, over 40 s of seeded speech-like audio: emissions within 1e-4,
    then ``align_segments`` word texts and segments equal and times
    within one frame stride."""
    from test_torch_slice import speechlike

    monkeypatch.setenv("WNT_TEST_SMALL_MODELS", "1")
    monkeypatch.setenv("WNT_MODEL_DIR", str(tmp_path))
    dims = jax_w2v.Wav2Vec2Dims(vocab_size=39, hidden_size=64, num_layers=2, num_heads=4,
                                intermediate_size=128, conv_dim=(32,) * 7)
    save_params(str(tmp_path / "ctc_aligner.npz"),
                jax_w2v.init_wav2vec2_params(jax.random.PRNGKey(5), dims))
    audio = speechlike(40.0, 1)

    jmodel, jtok = jax_api.load_alignment_model()
    model, tok = api.load_alignment_model("cpu")
    assert model.dims == wav2vec2.Wav2Vec2Dims(**vars(dims))
    want_em, want_stride = jax_api.generate_emissions(jmodel, audio, batch_size=2)
    got_em, got_stride = api.generate_emissions(model, audio, batch_size=2)
    assert got_stride == want_stride and got_em.shape == want_em.shape == (1999, 39)
    np.testing.assert_allclose(got_em, want_em, atol=1e-4, rtol=0)

    segs = [{"start": 0.5, "end": 9.0, "text": "one two three four"},
            {"start": 10.0, "end": 21.0, "text": "hello there general kenobi"},
            {"start": 25.0, "end": 39.5, "text": "it's over anakin i have the high ground"}]
    want = jax_seg.align_segments(jmodel, jtok, audio, segs, batch_size=2)
    got = segmented.align_segments(model, tok, audio, segs, batch_size=2, device="cpu")
    assert [(w["text"], w["segment"]) for w in got] == [(w["text"], w["segment"]) for w in want]
    stride_s = got_stride / 1000
    for g, w in zip(got, want):
        assert abs(g["start"] - w["start"]) <= stride_s + 1e-9
        assert abs(g["end"] - w["end"]) <= stride_s + 1e-9


def test_entry_points_default_to_the_card():
    """The engine and the alignment entry points run on the card unless
    the caller names the CPU; there is no "auto"."""
    for fn in (WhisperEngine.__init__, api.load_alignment_model, segmented.align_segments):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    with pytest.raises(ValueError, match="explicit"):
        api.load_alignment_model("auto")

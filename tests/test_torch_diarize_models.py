"""The port's diarization models against the JAX package's on the CPU.

One seeded JAX param tree per family (MarbleNet, TitaNet, the Jasper stack
of ``models/conv_asr.py``, MSDD) at tiny widths, with every 1-D leaf moved
off its init value so that scales and biases count, is saved with the JAX
package's ``save_params`` and loaded with the port's ``load_params``; both
packages then run the same seeded inputs. The JAX models run as the JAX
package's own tests run them on the CPU.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit is for speed only
    threadpool_limits = None

from test_torch_slice import _one_torch_thread, speechlike  # noqa: F401  (autouse)
from whisper_nemo_tpu.engine.checkpoint import flatten_tree, save_params
from whisper_nemo_tpu.engine.checkpoint import load_params as jax_load_params
from whisper_nemo_tpu.models import conv_asr as jax_conv_asr
from whisper_nemo_tpu.models import marblenet as jax_marblenet
from whisper_nemo_tpu.models import msdd as jax_msdd
from whisper_nemo_tpu.models import titanet as jax_titanet
from whisper_nemo_tpu.ops import features as jax_features
from whisper_nemo_tpu_torch.engine.checkpoint import load_params
from whisper_nemo_tpu_torch.engine.checkpoint import save_params as save_params_port
from whisper_nemo_tpu_torch.models import conv_asr, marblenet, msdd, titanet
from whisper_nemo_tpu_torch.ops.features import log_mel_features

N_MELS = 16
MARBLENET = jax_marblenet.MarbleNetDims(n_mels=N_MELS, filters=(16, 8, 8, 8),
                                        kernels=(5, 7, 9, 11), head_hidden=16)
TITANET = jax_titanet.TitaNetDims(n_mels=N_MELS, filters=(24, 24, 24, 48), kernels=(3, 5, 7, 1),
                                  repeat=2, se_reduction=4, attn_hidden=16, emb_dim=20)
JASPER = [
    jax_conv_asr.JasperBlockCfg(filters=24, kernel=5),
    jax_conv_asr.JasperBlockCfg(filters=24, repeat=2, kernel=5, dilation=2, separable=True,
                                residual=True, se=True, se_reduction=4),
    jax_conv_asr.JasperBlockCfg(filters=32, kernel=1, residual=True),
]
MSDD = jax_msdd.MsddDims(n_scales=3, emb_dim=16, hidden=12, proj=8)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread for numpy's LAPACK (the JAX package's host
    eigensolvers): under the suite's six workers, a pool a worker made
    the clustering cases thirty times slower; restored afterwards. The
    port's diarization test modules import it, which makes it theirs.
    Without ``threadpoolctl`` numpy keeps its pool."""
    limit = threadpool_limits(limits=1, user_api="blas") if threadpool_limits else None
    with limit or contextlib.nullcontext():
        yield


def _seeded_tree(init_fn, *args, seed: int):
    """The tree ``init_fn`` makes (its structure from ``jax.eval_shape``,
    so nothing compiles) filled from numpy: matrices and conv weights
    normal over the square root of their fan-in, scales 1 ± 0.1, shifts
    and biases ±0.1, so that every leaf counts."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        shape = leaf.shape
        if len(shape) >= 2:
            return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        base = 1.0 if path[-1].key in ("g", "bn_g") else 0.0
        return (base + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda: init_fn(jax.random.PRNGKey(0), *args))
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _msdd_variants():
    base = _seeded_tree(jax_msdd.init_msdd_params, MSDD, seed=3)
    no_in_dims = jax_msdd.MsddDims(n_scales=MSDD.n_scales, emb_dim=MSDD.emb_dim,
                                   hidden=MSDD.hidden, proj=2 * MSDD.n_scales + 2)
    no_in = _seeded_tree(jax_msdd.init_msdd_params, no_in_dims, seed=4)
    del no_in["in"]
    rev = dict(base, lstm_rev=_seeded_tree(jax_msdd.init_msdd_params, MSDD, seed=5)["lstm"],
               out=_seeded_tree(jax_msdd.init_msdd_params,
                                jax_msdd.MsddDims(n_scales=MSDD.n_scales, emb_dim=MSDD.emb_dim,
                                                  hidden=2 * MSDD.hidden, proj=MSDD.proj),
                                seed=6)["out"])
    return {"msdd": base, "msdd_no_in": no_in, "msdd_rev": rev}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{family: (JAX tree, the port's tree loaded from the saved .npz)}."""
    jax_trees = {
        "marblenet": _seeded_tree(jax_marblenet.init_marblenet_params, MARBLENET, seed=0),
        "titanet": _seeded_tree(jax_titanet.init_titanet_params, TITANET, seed=1),
        "conv_asr": _seeded_tree(lambda key: jax_conv_asr.init_conv_asr_params(
            key, JASPER, N_MELS, n_classes=2, emb_dim=20, attn_hidden=16), seed=2),
        **_msdd_variants(),
    }
    out = {}
    tmp = tmp_path_factory.mktemp("diar_trees")
    for name, tree in jax_trees.items():
        path = str(tmp / f"{name}.npz")
        save_params(path, tree)
        out[name] = (tree, load_params(path, "cpu"))
    return out


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", ["marblenet", "titanet", "conv_asr", "msdd", "msdd_rev"])
def test_saved_jax_tree_loads_in_the_ports_layout(trees, name, tmp_path):
    """save_params -> load_params: a diarization convnet's every 3-D array
    (a conv weight, [k, in/groups, out]) comes back as [out, in/groups, k];
    MSDD's matrices and every other leaf keep their layout and values. The
    port's save_params writes the JAX package's tree back."""
    jax_tree, port_tree = trees[name]
    save_params_port(str(tmp_path / "back.npz"), port_tree)
    back = flatten_tree(jax_load_params(str(tmp_path / "back.npz")))
    assert back.keys() == flatten_tree(jax_tree).keys()
    assert all(np.array_equal(back[k], v) for k, v in flatten_tree(jax_tree).items())
    ours = flatten_tree(jax.tree_util.tree_map(_np, port_tree))
    theirs = flatten_tree(jax_tree)
    assert ours.keys() == theirs.keys()
    n_conv = 0
    for key, value in theirs.items():
        expect = np.asarray(value)
        if expect.ndim == 3 and not name.startswith("msdd"):
            expect = expect.transpose(2, 1, 0)
            n_conv += 1
        assert ours[key].shape == expect.shape and np.array_equal(ours[key], expect), key
    assert (n_conv > 0) == (not name.startswith("msdd"))


@pytest.mark.parametrize("case", ["normalized", "raw", "chunked", "short"])
def test_features_match_jax(monkeypatch, case):
    """log_mel_features on 3.3 s of speech-like audio, within 1e-4; "chunked"
    cuts the JAX side into blocks of 128 frames (the port takes one call);
    "short" is 150 samples, fewer than the reflect pad of 200."""
    audio = speechlike(3.3, 0)[: 150 if case == "short" else None]
    if case == "chunked":
        monkeypatch.setattr(jax_features, "_CHUNK_FRAMES", 128)
    normalize = case != "raw"
    want = np.asarray(jax_features.log_mel_features(jnp.asarray(audio), N_MELS, normalize))
    got = log_mel_features(torch.from_numpy(audio), N_MELS, normalize).numpy()
    assert got.shape == want.shape == (len(audio) // 160 + 1, N_MELS)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _feats(seed, t):
    """Seeded features [1, t, n_mels] (JAX layout) and [1, n_mels, t] (the port's)."""
    x = np.random.default_rng(seed).standard_normal((1, t, N_MELS)).astype(np.float32)
    return x, torch.from_numpy(x.transpose(0, 2, 1).copy())


def test_marblenet_probs_match_jax(trees):
    jax_tree, port_tree = trees["marblenet"]
    x, xt = _feats(1, 200)
    want = np.asarray(jax_marblenet.speech_probs(jax_tree, jnp.asarray(x), MARBLENET))
    got = marblenet.speech_probs(port_tree, xt, marblenet.MarbleNetDims(**MARBLENET.__dict__))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _windows(seed, b, t):
    x = np.random.default_rng(seed).standard_normal((b, t, N_MELS)).astype(np.float32)
    return x, torch.from_numpy(x.transpose(0, 2, 1).copy())


def test_titanet_embeddings_match_jax(trees):
    """Windows of 1, 23 and 40 valid frames in one padded batch of 40,
    within 1e-4. And a padded window embeds as its valid frames alone do:
    the activations are masked after every conv stack, but not after a
    block's residual add (as in the JAX package), so this holds where the
    residual convs' shifts are zero, as the init makes them."""
    jax_tree, port_tree = trees["titanet"]
    dims = titanet.TitaNetDims(**TITANET.__dict__)
    x, xt = _windows(2, 3, 40)
    lengths = np.array([1, 23, 40], np.int32)
    want = np.asarray(jax.jit(jax_titanet.embed, static_argnums=3)(
        jax_tree, jnp.asarray(x), jnp.asarray(lengths), TITANET))
    got = titanet.embed(port_tree, xt, torch.from_numpy(lengths), dims).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    tree = dict(port_tree, blocks=[dict(b, res=dict(b["res"], bn_b=torch.zeros_like(b["res"]["bn_b"])))
                                   for b in port_tree["blocks"]])
    padded = titanet.embed(tree, xt, torch.from_numpy(lengths), dims).numpy()
    alone = titanet.embed(tree, xt[1:2, :, :23], torch.tensor([23]), dims).numpy()
    np.testing.assert_allclose(alone[0], padded[1], atol=1e-5, rtol=0)


def test_conv_asr_matches_jax(trees):
    """The Jasper stack (plain, dilated separable with SE and residual, 1x1
    with residual): frame speech probabilities and speaker embeddings of
    windows of 9, 30 and 31 valid frames, within 1e-4."""
    jax_tree, port_tree = trees["conv_asr"]
    cfgs = [conv_asr.JasperBlockCfg(**c.__dict__) for c in JASPER]
    x, xt = _windows(3, 3, 31)
    want = np.asarray(jax.jit(jax_conv_asr.speech_probs, static_argnums=1)(
        jax_tree, tuple(JASPER), jnp.asarray(x)))
    np.testing.assert_allclose(conv_asr.speech_probs(port_tree, cfgs, xt).numpy(), want,
                               atol=1e-4, rtol=0)
    lengths = np.array([9, 30, 31], np.int32)
    want = np.asarray(jax.jit(jax_conv_asr.speaker_embed, static_argnums=1)(
        jax_tree, tuple(JASPER), jnp.asarray(x), jnp.asarray(lengths)))
    got = conv_asr.speaker_embed(port_tree, cfgs, xt, torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_msdd_pair_features_match_jax():
    rng = np.random.default_rng(6)
    seg = rng.standard_normal((MSDD.n_scales, 11, MSDD.emb_dim)).astype(np.float32)
    avg = rng.standard_normal((MSDD.n_scales, 2, MSDD.emb_dim)).astype(np.float32)
    w = np.array([1.0, 2.0, 1.0], np.float32)
    want = np.asarray(jax_msdd.pair_features(jnp.asarray(seg), jnp.asarray(avg), jnp.asarray(w)))
    got = msdd.pair_features(torch.from_numpy(seg), torch.from_numpy(avg), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["msdd", "msdd_no_in", "msdd_rev"])
def test_msdd_logits_match_jax(trees, name):
    """With the input projection, without it, and with a reverse LSTM."""
    jax_tree, port_tree = trees[name]
    x = np.random.default_rng(4).standard_normal((5, 17, 2 * MSDD.n_scales + 2)).astype(np.float32)
    want = np.asarray(jax.jit(jax_msdd.msdd_logits)(jax_tree, jnp.asarray(x)))
    np.testing.assert_allclose(msdd.msdd_logits(port_tree, torch.from_numpy(x)).numpy(), want,
                               atol=1e-5, rtol=0)


def test_msdd_infer_multi_matches_jax(trees, monkeypatch):
    """Three speakers over 23 segments in windows of 10 (two full and a
    remainder of 3), pairs in batches of 2: the mean sigmoids within 1e-5,
    activity equal at two thresholds, and the one-threshold call."""
    jax_tree, port_tree = trees["msdd_rev"]
    rng = np.random.default_rng(5)
    seg = rng.standard_normal((MSDD.n_scales, 23, MSDD.emb_dim)).astype(np.float32)
    labels = rng.integers(0, 3, 23)
    kw = dict(diar_window=5, seg_duration=0.5, infer_batch_size=2)
    seen = []
    mean_sigmoids = jax_msdd.msdd_mean_sigmoids
    monkeypatch.setattr(jax_msdd, "msdd_mean_sigmoids",
                        lambda *a, **k: seen.append(mean_sigmoids(*a, **k)) or seen[-1])
    want = jax_msdd.msdd_infer_multi(jax_tree, seg, labels, (1, 2, 1),
                                     sigmoid_thresholds=(0.5, 0.7), **kw)
    got_sig, got_spk = msdd.msdd_mean_sigmoids(port_tree, torch.from_numpy(seg), labels,
                                               (1, 2, 1), **kw)
    np.testing.assert_array_equal(got_spk, seen[0][1])
    np.testing.assert_allclose(got_sig, seen[0][0], atol=1e-5, rtol=0)
    got = msdd.msdd_infer_multi(port_tree, torch.from_numpy(seg), labels, (1, 2, 1),
                                sigmoid_thresholds=(0.5, 0.7), **kw)
    assert got.keys() == want.keys()
    for th in want:
        np.testing.assert_array_equal(got[th], want[th])
    np.testing.assert_array_equal(
        msdd.msdd_infer(port_tree, torch.from_numpy(seg), labels, (1, 2, 1), 0.7, **kw), want[0.7])

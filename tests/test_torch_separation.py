"""The port's separator (htdemucs) and polyphase resampler against the JAX
package's on the CPU.

One htdemucs tree at small dims (``SMALL``: 4 channels, depth 4, nfft 512,
a transformer of 3 layers at 32 wide with 8 heads, 0.5 s windows at 16
kHz) is made
once as numpy from ``jax.eval_shape`` of the JAX init, every leaf drawn so
that it counts, and converted with ``params_from_jax``. Both packages run
the same seeded mixes, f32; htdemucs outputs are held within 1e-4 of the
largest JAX output, the resampler within 1e-5. The JAX package's window
batch compiles once: every JAX ``apply_segments`` call (the
``separate_vocals`` one too) runs 8 windows of one source at a time.
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import _one_torch_thread, built_decoder  # noqa: F401  (autouse; a fixture)
from whisper_nemo_tpu.audio import read_wav, write_wav
from whisper_nemo_tpu.engine.checkpoint import flatten_tree, save_params
from whisper_nemo_tpu.models import htdemucs as jax_demucs
from whisper_nemo_tpu.ops import resample as jax_resample
from whisper_nemo_tpu_torch.engine.checkpoint import load_params, params_from_jax
from whisper_nemo_tpu_torch.models import htdemucs
from whisper_nemo_tpu_torch.ops.resample import resample_poly

# what infer_dims and the sidecar give back, so that the JAX separate_vocals
# reuses apply_segments' compile
SMALL = jax_demucs.HTDemucsDims(channels=4, depth=4, nfft=512, bottom_channels=32, t_layers=3,
                                segment=0.5, samplerate=16000)
PORT_SMALL = htdemucs.HTDemucsDims(**dataclasses.asdict(SMALL))
DEMUCS_TOL = 1e-4  # relative to the largest JAX output: f32 sums in other orders
RESAMPLE_TOL = 1e-5
# 8 windows of 8,000 samples at a stride of 6,000, the last zero-padded
MIX_SAMPLES = 47_500
VOCALS = SMALL.sources.index("vocals")


def htdemucs_tree(dims, seed: int, every_leaf: bool = True):
    """The JAX init's tree (its structure from ``jax.eval_shape``, so
    nothing compiles) filled from numpy: weights normal over the square
    root of their fan-in; with ``every_leaf`` norm weights 1 ± 0.1 and
    every other vector ±0.1, else the init's constants (norms 1, biases
    0, the DConv and transformer scales 1e-3 and 1e-4)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        shape, key = leaf.shape, path[-1].key
        if len(shape) >= 2:
            return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))).astype(np.float32)
        if every_leaf:
            base = 1.0 if key == "weight" else 0.0
            return (base + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if key == "scale":  # LayerScale: the transformer's gamma_1/2, the DConv's
            gamma = any(getattr(k, "key", None) in ("gamma_1", "gamma_2") for k in path)
            return np.full(shape, 1e-4 if gamma else 1e-3, np.float32)
        return np.full(shape, 1.0 if key == "weight" else 0.0, np.float32)

    shapes = jax.eval_shape(lambda: jax_demucs.init_htdemucs_params(jax.random.PRNGKey(0), dims))
    return jax.tree_util.tree_map_with_path(fill, shapes)


def install_htdemucs(directory, tree, dims) -> None:
    """``htdemucs.npz`` and its sidecar, as the JAX package's converter
    writes them."""
    save_params(str(directory / "htdemucs.npz"), tree)
    (directory / "htdemucs.cfg.json").write_text(json.dumps(
        {"sources": list(dims.sources), "segment": dims.segment, "samplerate": dims.samplerate}))


@pytest.fixture(scope="module")
def trees():
    tree = htdemucs_tree(SMALL, seed=0)
    return tree, params_from_jax(tree)


@pytest.fixture(scope="module")
def mix():
    rng = np.random.default_rng(1)
    return (0.2 * rng.standard_normal((2, MIX_SAMPLES))).astype(np.float32)


@pytest.fixture(scope="module")
def jax_vocals(trees, mix):
    """The JAX package's apply_segments of the vocals, 8 windows a batch."""
    return jax_demucs.apply_segments(trees[0], mix, SMALL, source_indices=(VOCALS,))


def _close(got, want, tol=DEMUCS_TOL):
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


# -- the resampler ------------------------------------------------------------


@pytest.mark.parametrize("orig_sr,target_sr",
                         [(44100, 16000), (16000, 44100), (48000, 16000), (22050, 16000)])
def test_resample_poly_matches_jax(orig_sr, target_sr):
    """4,410 seeded samples: within 1e-5 of the JAX package's GEMM form,
    the same length."""
    x = np.random.default_rng(2).standard_normal(4410).astype(np.float32)
    want = np.asarray(jax_resample.resample_poly(jnp.asarray(x), orig_sr, target_sr))
    got = resample_poly(torch.from_numpy(x), orig_sr, target_sr).numpy()
    assert got.shape == want.shape == (math.ceil(4410 * target_sr / orig_sr),)
    np.testing.assert_allclose(got, want, atol=RESAMPLE_TOL, rtol=0)


def test_resample_poly_keeps_scipys_alignment():
    """scipy's alignment: output sample k lies at input time k * down / up.
    A 440 Hz tone of 1 s at 44.1 kHz comes out as the tone sampled at 16
    kHz, within 5e-3 away from the ends (a shift of one output sample
    would move it by up to 0.17). Leading axes pass through, and equal
    rates return the input."""
    x = np.sin(2 * np.pi * 440.0 * np.arange(44100) / 44100).astype(np.float32)
    got = resample_poly(torch.from_numpy(x), 44100, 16000).numpy()
    want = np.sin(2 * np.pi * 440.0 * np.arange(16000) / 16000)
    assert got.shape == (16000,)
    np.testing.assert_allclose(got[500:-500], want[500:-500], atol=5e-3, rtol=0)
    batch = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 3, 1000)))
    assert resample_poly(batch, 32000, 16000).shape == (2, 3, 500)
    assert resample_poly(batch, 16000, 16000) is batch


# -- htdemucs -----------------------------------------------------------------


def test_htdemucs_forward_matches_jax(trees):
    """Two mixes of 8,000 samples: every source within DEMUCS_TOL; the
    spectrogram and its inverse of demucs' padding contract on the way."""
    x = (0.2 * np.random.default_rng(5).standard_normal((2, 2, 8000))).astype(np.float32)
    want = np.asarray(jax.jit(jax_demucs.htdemucs_forward, static_argnums=2)(trees[0], x, SMALL))
    got = htdemucs.htdemucs_forward(trees[1], torch.from_numpy(x), PORT_SMALL).numpy()
    assert got.shape == (2, 4, 2, 8000)
    _close(got, want)
    want_z = np.asarray(jax.jit(jax_demucs._spec, static_argnums=1)(x, SMALL))
    z = htdemucs._spec(torch.from_numpy(x), PORT_SMALL)
    assert z.shape == want_z.shape == (2, 2, SMALL.nfft // 2, -(-8000 // SMALL.hop_length))
    _close(z.numpy(), want_z)
    want_back = np.asarray(jax.jit(jax_demucs._ispec, static_argnums=(1, 2))(want_z, SMALL, 8000))
    _close(htdemucs._ispec(z, PORT_SMALL, 8000).numpy(), want_back)


@pytest.mark.parametrize("batch_size,sources", [(3, None), (8, (VOCALS,))])
def test_apply_segments_matches_jax(trees, mix, jax_vocals, batch_size, sources):
    """47,500 samples in 8 windows (the last zero-padded, cross-faded into
    its neighbour): the vocals within DEMUCS_TOL of the JAX package's,
    whether the port runs 3 windows a batch with every source (a ragged
    last batch) or 8 of the vocals alone; ``device_out`` keeps the
    tensor."""
    got = htdemucs.apply_segments(trees[1], mix, PORT_SMALL, batch_size=batch_size,
                                  source_indices=sources)
    assert got.shape == ((4 if sources is None else 1), 2, MIX_SAMPLES)
    _close(got[VOCALS if sources is None else 0][None], jax_vocals)
    out = htdemucs.apply_segments(trees[1], torch.from_numpy(mix), PORT_SMALL,
                                  source_indices=(VOCALS,), device_out=True)
    assert isinstance(out, torch.Tensor) and out.shape == (1, 2, MIX_SAMPLES)


def test_init_and_checkpoint_keep_the_jax_layout(trees, tmp_path):
    """The port's seeded init has the JAX tree's keys and shapes; a saved
    JAX tree loads unchanged (torch layouts already), and ``infer_dims``
    reads the same dims as the JAX package's."""
    want = {k: v.shape for k, v in flatten_tree(trees[0]).items()}
    init = htdemucs.init_htdemucs_params(PORT_SMALL, "cpu", torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in flatten_tree(init).items()} == want
    save_params(str(tmp_path / "htdemucs.npz"), trees[0])
    loaded = flatten_tree(load_params(str(tmp_path / "htdemucs.npz"), "cpu"))
    assert all(np.array_equal(loaded[k], v) for k, v in flatten_tree(trees[0]).items())
    flat = {k.replace("/", "."): v for k, v in loaded.items()}
    dims = htdemucs.infer_dims(flat)
    assert dataclasses.asdict(dims) == dataclasses.asdict(jax_demucs.infer_dims(flat))
    assert dims == dataclasses.replace(PORT_SMALL, segment=7.8, samplerate=44100)


def test_separate_vocals_writes_the_jax_vocals(trees, mix, tmp_path, monkeypatch, built_decoder):
    """Both packages' ``separate_vocals`` on a 16 kHz WAV with the checkpoint
    and its sidecar: the CLI layout, the same header, and samples within
    one step of 16-bit PCM (each package truncates its own f32 vocals);
    without a checkpoint the port raises ``FileNotFoundError``, which the
    flow turns into its warning."""
    monkeypatch.setenv("WNT_MODEL_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        htdemucs.separate_vocals(str(tmp_path / "song.wav"), str(tmp_path / "out"), "cpu")
    install_htdemucs(tmp_path, trees[0], SMALL)
    write_wav(str(tmp_path / "song.wav"), mix[0])
    want = jax_demucs.separate_vocals(str(tmp_path / "song.wav"), str(tmp_path / "jax"))
    got = htdemucs.separate_vocals(str(tmp_path / "song.wav"), str(tmp_path / "port"), "cpu")
    assert got == os.path.join(str(tmp_path / "port"), "htdemucs", "song", "vocals.wav")
    assert open(got, "rb").read()[:44] == open(want, "rb").read()[:44]
    (g, g_rate), (w, w_rate) = read_wav(got), read_wav(want)
    assert g_rate == w_rate == SMALL.samplerate and g.shape == w.shape == (MIX_SAMPLES,)
    assert np.abs(g - w).max() <= 1.5 / 32767 and np.abs(w).max() > 0.01

"""The port's Whisper model (whisper_nemo_tpu_torch/models) against the
JAX package, on one JAX param tree converted array by array.

f32 cases check the algorithm, so their tolerances are f32 summation
order. int8 cases (bf16 activations) carry bf16 roundings that differ
between the frameworks: PyTorch returns a bf16 product in bf16 where
the JAX package keeps an f32 epilogue (models/whisper.py:_linear), and
the JAX package's int8 encoder promotes to f32 activations through its
f32 conv bias where the port stays in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import _one_torch_thread  # noqa: F401  (autouse)
from whisper_nemo_tpu.engine.quantize import quantize_whisper_params as jax_quantize
from whisper_nemo_tpu.models import whisper as jw
from whisper_nemo_tpu.models import whisper_stacked as jws
from whisper_nemo_tpu_torch.engine.checkpoint import params_from_jax
from whisper_nemo_tpu_torch.engine.quantize import quantize_whisper_params
from whisper_nemo_tpu_torch.models import whisper as tw
from whisper_nemo_tpu_torch.models import whisper_stacked as tws

DIMS = jw.WhisperDims(80, 1500, 64, 4, 2, 51864, 64, 64, 4, 2)
TDIMS = tw.WhisperDims(80, 1500, 64, 4, 2, 51864, 64, 64, 4, 2)
PROMPT = [[50257, 50362], [50257, 50362]]  # <|startoftranscript|> <|notimestamps|> (.en)


def _j2t(x):
    a = np.asarray(jnp.asarray(x).astype(jnp.float32)) if x.dtype == jnp.bfloat16 else np.asarray(x)
    t = torch.from_numpy(np.array(a))
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


@pytest.fixture(scope="module")
def trees():
    init = jax.jit(jw.init_whisper_params, static_argnums=1)  # one compile, not one per op
    jparams = init(jax.random.PRNGKey(1), DIMS)
    return jparams, params_from_jax(jparams)


@pytest.fixture(scope="module")
def feats():
    rng = np.random.default_rng(0)
    return rng.standard_normal((2, 1500, 64)).astype(np.float32)


def _mel():
    rng = np.random.default_rng(1)
    return rng.standard_normal((2, 80, 3000)).astype(np.float32)


# JAX's encoder compiled once per width, where it runs op by op
_jax_encode = jax.jit(jw.encode, static_argnums=(2, 3))


def test_encode_f32_matches_jax(trees):
    """f32 encoder: 1e-5 absolute on layer-normed features of order 1
    (summation order through conv, two blocks and the final norm)."""
    jparams, params = trees
    want = np.asarray(_jax_encode(jparams, jnp.asarray(_mel()), DIMS, jnp.float32))
    got = tw.encode(params, torch.from_numpy(_mel()), TDIMS, torch.float32)
    assert got.shape == (2, 1500, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_encode_int8_matches_jax(trees):
    """int8 weights, bf16 activations (see the module note): 0.06 absolute
    on features of order 1 is a few bf16 roundings (2^-8 relative each)
    through two blocks; the mean error stays an order below that."""
    jparams, params = trees
    want = np.asarray(
        _jax_encode(jax_quantize(jparams), jnp.asarray(_mel()), DIMS, jnp.bfloat16), np.float32
    )
    got = tw.encode(quantize_whisper_params(params), torch.from_numpy(_mel()), TDIMS,
                    torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got, want, atol=0.06)
    assert np.abs(got - want).mean() < 6e-3


def _jax_state(jparams, feats, dtype):
    """JAX stacked params, decode-layout cross-KV, prefill hidden and cache."""
    stacked = jws.stack_decoder_blocks(jparams)
    audio = jnp.asarray(feats).astype(dtype)
    ckv = jws.cross_kv_decode_layout_fused(stacked, audio, DIMS, bits=8)
    cache = jws.init_stacked_cache(2, DIMS, dtype, cache_len=128)
    x, cache = jws.prefill_cache_stacked(stacked, jnp.asarray(PROMPT), cache, ckv, DIMS, dtype)
    return stacked, ckv, x, cache


def _port_state(params, feats, dtype):
    stacked = tws.stack_decoder_blocks(params)
    audio = torch.from_numpy(feats).to(dtype)
    ckv = tws.cross_kv_decode_layout_fused(stacked, audio, TDIMS, bits=8)
    cache = tws.init_stacked_cache(2, TDIMS, dtype, 128, "cpu")
    x, cache = tws.prefill_cache_stacked(stacked, torch.tensor(PROMPT), cache, ckv, TDIMS, dtype)
    return stacked, ckv, x, cache


def test_cross_kv_and_prefill_f32_match_jax(trees, feats):
    """f32: the decode-layout cross-KV equals the JAX package's to one
    quantization step where a product lands on a rounding boundary, and
    the prefill hidden states and cache agree to 1e-5 (f32 order)."""
    jparams, params = trees
    _, jckv, jx, jcache = _jax_state(jparams, feats, jnp.float32)
    _, ckv, x, cache = _port_state(params, feats, torch.float32)
    diff = np.abs(ckv["kv_dec"].numpy().astype(np.int32) - np.asarray(jckv["kv_dec"], np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    np.testing.assert_allclose(ckv["k_dec_scale"].numpy(), np.asarray(jckv["k_dec_scale"]), rtol=1e-5)
    assert ckv["_k_len"] == jckv["_k_len"] == 1500
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), atol=1e-5)


@pytest.mark.parametrize("compute", ["float32", "int8"])
def test_decode_step_logits_match_jax(trees, feats, compute):
    """One decode step from the same cache state and the same cross-KV
    (both taken from the JAX side). The JAX step runs the Pallas
    cross-attention kernel in interpret mode. f32: 1e-5 absolute on
    logits of order 0.3. int8 (bf16): 0.02 absolute, a few bf16 roundings
    of the hidden state through two layers projected onto the vocab (the
    logits tie tolerance of tests/test_torch_slice.py); the argmax
    agrees."""
    jparams, params = trees
    if compute == "int8":
        jparams, params = jax_quantize(jparams), quantize_whisper_params(params)
        jdtype, tdtype, atol = jnp.bfloat16, torch.bfloat16, 0.02
    else:
        jdtype, tdtype, atol = jnp.float32, torch.float32, 1e-5
    jstacked, jckv, _, jcache = _jax_state(jparams, feats, jdtype)
    token = np.array([100, 7000], np.int32)
    want, _ = jws.decode_step_stacked(
        jstacked, jnp.asarray(token), jnp.int32(2), jcache, jckv, DIMS, jdtype
    )
    stacked = tws.stack_decoder_blocks(params)
    ckv = {
        "kv_dec": _j2t(jckv["kv_dec"]), "k_dec_scale": _j2t(jckv["k_dec_scale"]),
        "v_dec_scale": _j2t(jckv["v_dec_scale"]), "_k_len": 1500, "_bits": 8,
    }
    cache = {name: _j2t(jcache[name]) for name in ("k", "v")}
    got, cache = tws.decode_step_stacked(
        stacked, torch.from_numpy(token).long(), 2, cache, ckv, TDIMS, tdtype
    )
    want = np.asarray(want)
    assert got.shape == want.shape == (2, 51864) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=atol)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))

"""The port's ops (whisper_nemo_tpu_torch/ops) against the JAX package.

Inputs are made with numpy from a seed and fed to both sides. Where the
JAX function reaches a Pallas kernel it runs as the JAX package's own
tests run it on the CPU: interpret mode for the cross-attention decode
kernel, the einsum path (``_xla_attention``) for the encoder flash
kernel. Every tolerance is stated with its reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_nemo_tpu.engine.quantize import quantize_whisper_params as jax_quantize
from whisper_nemo_tpu.models.whisper import WhisperDims, init_whisper_params
from whisper_nemo_tpu.ops import attention as jax_attention
from whisper_nemo_tpu.ops import cross_decode as jax_cd
from whisper_nemo_tpu.ops.framing import frame_energy as jax_frame_energy
from whisper_nemo_tpu.ops.mel import log_mel_spectrogram_batch as jax_mel_batch
from whisper_nemo_tpu_torch.engine.checkpoint import params_from_jax
from whisper_nemo_tpu_torch.engine.quantize import quantize_whisper_params
from whisper_nemo_tpu_torch.ops import attention, cross_decode
from whisper_nemo_tpu_torch.ops.framing import frame_energy
from whisper_nemo_tpu_torch.ops.mel import log_mel_spectrogram_batch

TINY = WhisperDims(80, 1500, 64, 4, 1, 51864, 64, 64, 4, 1)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_converter_and_quantize_match_jax():
    """params_from_jax carries every array (conv weights WIO -> OIW); the
    port's int8 weights and f32 scales equal the JAX package's exactly
    (both compute the scale as amax times f32 1/127)."""
    jparams = jax.jit(init_whisper_params, static_argnums=1)(jax.random.PRNGKey(0), TINY)
    params = params_from_jax(jparams)
    flat = dict(_leaves(params))
    for path, leaf in _leaves(jparams):
        got = flat[path]
        want = np.asarray(leaf)
        if path.endswith(("conv1/w", "conv2/w")):
            want = want.transpose(2, 1, 0)
        assert got.dtype == torch.float32, path
        np.testing.assert_array_equal(got.numpy(), want, err_msg=path)

    jq = dict(_leaves(jax_quantize(jparams)))
    pq = dict(_leaves(quantize_whisper_params(params)))
    for path, leaf in jq.items():
        want = np.asarray(leaf)
        if path.endswith(("conv1/w", "conv2/w")):
            want = want.transpose(2, 1, 0)
        got = pq[path]
        assert str(got.dtype).split(".")[-1] == str(want.dtype), path
        np.testing.assert_array_equal(got.numpy(), want, err_msg=path)
    assert set(pq) == set(jq)


def test_log_mel_batch_matches_jax():
    """Two 30 s windows: the same f32 DFT and mel products in another
    summation order; the log compresses, so 1e-4 absolute on values of
    order 1 after whisper's normalization."""
    rng = np.random.default_rng(0)
    waves = (rng.standard_normal((2, 480000)) * 0.1).astype(np.float32)
    waves[1, 200000:] = 0.0  # a padded tail, as the batched path makes
    want = np.asarray(jax_mel_batch(jnp.asarray(waves)))
    got = log_mel_spectrogram_batch(torch.from_numpy(waves)).numpy()
    assert got.shape == want.shape == (2, 80, 3000)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_cross_kv_decode_exact(bits):
    """The decode-layout quantization is the same f32 arithmetic and round
    half to even on both sides: int8 bytes and scales are equal. The JAX
    side runs jitted, as the engine runs it (XLA turns ``amax / qmax``
    into a multiply by the reciprocal; eager JAX divides)."""
    rng = np.random.default_rng(1)
    k = rng.standard_normal((2, 3, 200, 4, 64)).astype(np.float32)
    v = rng.standard_normal((2, 3, 200, 4, 64)).astype(np.float32)
    quantize = jax.jit(jax_cd.quantize_cross_kv_decode, static_argnames="bits")
    want = quantize(jnp.asarray(k), jnp.asarray(v), bits=bits)
    got = cross_decode.quantize_cross_kv_decode(torch.from_numpy(k), torch.from_numpy(v), bits=bits)
    np.testing.assert_array_equal(got["kv_dec"].numpy(), np.asarray(want["kv_dec"]))
    np.testing.assert_array_equal(got["k_dec_scale"].numpy(), np.asarray(want["k_dec_scale"]))
    np.testing.assert_array_equal(got["v_dec_scale"].numpy(), np.asarray(want["v_dec_scale"]))
    assert got["k_len"] == want["k_len"] == 200


def test_int4_pack_roundtrip_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.integers(-7, 8, size=(3, 8, 64, 128)).astype(np.int8)
    for dim in (2, 3):
        got = cross_decode.pack_int4(torch.from_numpy(x), dim)
        want = np.asarray(jax_cd.pack_int4(jnp.asarray(x), axis=dim))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(cross_decode.unpack_int4(got, dim).numpy(), x)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("beam", [1, 3])
@pytest.mark.parametrize("T", [77, 128, 200])
def test_cross_decode_plain_matches_jax_interpret(T, beam, bits):
    """The plain version of kernel A against the Pallas kernel in
    interpret mode, on the same quantized stack and layer: both round q
    and the weights to bf16; 5e-3 absolute, the JAX kernel test's bound."""
    rng = np.random.default_rng(T + beam + bits)
    L, W, H, D = 2, 2, 4, 64
    k = rng.standard_normal((L, W, T, H, D)).astype(np.float32)
    v = rng.standard_normal((L, W, T, H, D)).astype(np.float32)
    q = rng.standard_normal((W * beam, 1, H, D)).astype(np.float32)
    kv = jax_cd.quantize_cross_kv_decode(
        jnp.asarray(k).astype(jnp.bfloat16), jnp.asarray(v).astype(jnp.bfloat16), bits=bits
    )
    layer = 1
    want = jax_cd.cross_attention_decode_layered(
        jnp.asarray(q), kv["kv_dec"], kv["k_dec_scale"][layer], kv["v_dec_scale"][layer],
        jnp.int32(layer), T, bits=bits, beam=beam, interpret=True,
    )
    got = cross_decode.cross_attention_decode_layered(
        torch.from_numpy(q), torch.from_numpy(np.array(kv["kv_dec"])),
        torch.from_numpy(np.array(kv["k_dec_scale"][layer])),
        torch.from_numpy(np.array(kv["v_dec_scale"][layer])),
        layer, T, bits=bits, beam=beam,
    )
    assert got.shape == (W * beam, 1, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_attention_plain_matches_xla(dtype):
    """The plain version of kernel B against the JAX einsum path: f32
    agrees to summation order (1e-5); bf16 to one bf16 rounding of the
    weights and the output (2e-2 on outputs of order 1)."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 300, 4, 64)).astype(np.float32) for _ in range(3))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_attention._xla_attention(*(jnp.asarray(x).astype(jd) for x in (q, k, v)))
    got = attention.encoder_attention(*(torch.from_numpy(x).to(td) for x in (q, k, v)))
    atol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=atol
    )


def test_frame_energy_matches_jax():
    """Block sums of the squared signal in f32 on both sides: 1e-6
    relative to the energies' scale."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(16000 * 5).astype(np.float32)
    n_frames = 1 + (len(x) - 640) // 320
    want = np.asarray(jax_frame_energy(jnp.asarray(x), n_frames, 640, 320))
    got = frame_energy(torch.from_numpy(x), n_frames, 640, 320).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

"""The port's kernel wrappers (kernels A, B, C, D, E and F), without JAX.

On the CPU the wrappers must run the plain versions and count no launch;
on any other device they launch the kernel or raise. The CUDA cases hold
each kernel against its plain version on the card. This file imports
nothing of JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -q tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import DEMUCS_SMALL, speechlike
from whisper_nemo_tpu_torch.engine.checkpoint import to_device
from whisper_nemo_tpu_torch.engine.precision import full_f32
from whisper_nemo_tpu_torch.models import htdemucs
from whisper_nemo_tpu_torch.ops import attention, beam_permute, cross_decode, ctc, mel, self_decode
from whisper_nemo_tpu_torch.ops.resample import resample_poly


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build with nvcc and run only on the card")
    return torch.device("cuda")


def test_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the kernel wrappers return exactly the plain
    versions' results and never count a launch."""
    rng = np.random.default_rng(6)
    cross_decode.cross_attention_decode_layered.launches = 0
    attention.encoder_attention.launches = 0
    kv = cross_decode.quantize_cross_kv_decode(
        torch.from_numpy(rng.standard_normal((2, 2, 100, 4, 64)).astype(np.float32)),
        torch.from_numpy(rng.standard_normal((2, 2, 100, 4, 64)).astype(np.float32)),
    )
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 64)).astype(np.float32))
    out = cross_decode.cross_attention_decode_layered(
        q, kv["kv_dec"], kv["k_dec_scale"][0], kv["v_dec_scale"][0], 0, 100
    )
    qs = q[:, 0] * (kv["k_dec_scale"][0] * 64**-0.5)[None]
    plain = cross_decode._cross_attention_decode_plain(qs, kv["kv_dec"], 0, 100, 8, 1)
    torch.testing.assert_close(out, (plain * kv["v_dec_scale"][0])[:, None], rtol=0, atol=0)

    x = torch.from_numpy(rng.standard_normal((3, 3, 50, 4, 64)).astype(np.float32))
    got = attention.multihead_attention(x[0], x[1], x[2])
    torch.testing.assert_close(got, attention._xla_attention(x[0], x[1], x[2]), rtol=0, atol=0)
    assert cross_decode.cross_attention_decode_layered.launches == 0
    assert attention.encoder_attention.launches == 0


def _ancestry_inputs(device, dtype, seed, layers=2, b=3, kk=5, h=4, s=40):
    """Seeded q ``[B·K, 1, H, 64]``, cache ``[L, B·K, H, 64, S]``, anc
    ``[B, K, S]`` int32 and a shared mask hiding the last 7 positions."""
    g = torch.Generator(device=device).manual_seed(seed)
    bk = b * kk
    q = torch.randn((bk, 1, h, 64), device=device, generator=g).to(dtype)
    k, v = (torch.randn((layers, bk, h, 64, s), device=device, generator=g).to(dtype)
            for _ in range(2))
    anc = torch.randint(0, kk, (b, kk, s), device=device, generator=g, dtype=torch.int32)
    mask = torch.where(torch.arange(s, device=device) < s - 7, 0.0, float("-inf"))[None, None, None]
    return q, k, v, anc, mask


def test_beam_wrappers_take_the_plain_version_on_cpu():
    """Kernels E and F on CPU tensors: exactly the plain versions (the
    ancestry attention of the named layer; the row gather, out of place
    and in place), no launch counted."""
    self_decode.self_attention_decode_ancestry_layered.launches = 0
    beam_permute.beam_permute_cache.launches = 0
    beam_permute.beam_permute_cache_inplace.launches = 0
    q, k, v, anc, mask = _ancestry_inputs("cpu", torch.float32, 2)
    got = self_decode.self_attention_decode_ancestry_layered(q, k, v, anc, mask, 1, 5, n_visible=33)
    want = attention.attention_kt_ancestry(q, k[1], v[1], anc, mask)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got = self_decode.self_attention_decode_ancestry(q, k[0], v[0], anc, mask, 5)
    torch.testing.assert_close(got, attention.attention_kt_ancestry(q, k[0], v[0], anc, mask),
                               rtol=0, atol=0)
    src = torch.tensor([[4, 4, 0, 1, 2], [0, 1, 2, 3, 4], [3, 3, 3, 3, 3]])
    idx = (torch.arange(3)[:, None] * 5 + src).reshape(-1)
    want = (k[:, idx], v[:, idx])
    assert all(torch.equal(g, w) for g, w in zip(beam_permute.beam_permute_cache(k, v, idx), want))
    got = beam_permute.beam_permute_cache_inplace(k, v, src, 5)
    assert got[0] is k and got[1] is v
    assert torch.equal(k, want[0]) and torch.equal(v, want[1])
    assert self_decode.self_attention_decode_ancestry_layered.launches == 0
    assert beam_permute.beam_permute_cache.launches == 0
    assert beam_permute.beam_permute_cache_inplace.launches == 0


def _viterbi_case(r, t, n, seed):
    """``[r, t, 2n+1]`` state emissions (Dirichlet log-probs gathered
    through random labels, one repeated label) and the CTC skip rule."""
    rng = np.random.default_rng(seed)
    e_states, skips = [], []
    for _ in range(r):
        em = np.log(rng.dirichlet(np.ones(8), size=t).astype(np.float32))
        labels = rng.integers(1, 8, size=n)
        labels[n // 2] = labels[n // 2 - 1]
        state_labels = np.zeros(2 * n + 1, np.int64)
        state_labels[1::2] = labels
        allow = np.zeros(2 * n + 1, bool)
        allow[3::2] = labels[1:] != labels[:-1]
        e_states.append(em[:, state_labels])
        skips.append(allow)
    return (torch.from_numpy(np.ascontiguousarray(np.stack(e_states))),
            torch.from_numpy(np.stack(skips)))


def test_viterbi_takes_the_plain_version_on_cpu():
    """Kernel D's wrapper on CPU tensors: the plain sweep and backtrack,
    no launch counted."""
    ctc.viterbi_batch.launches = 0
    e_states, skips = _viterbi_case(2, 30, 4, 1)
    alpha, bps, path = ctc.viterbi_batch(e_states, skips)
    want_alpha, want_bps = ctc._viterbi_forward_states(e_states, skips)
    torch.testing.assert_close(alpha, want_alpha, rtol=0, atol=0)
    assert torch.equal(bps, want_bps)
    assert torch.equal(path, ctc._viterbi_backtrack(want_alpha, want_bps))
    # a path moves up by at most two states a step, from state 0 or 1
    steps = path[:, 1:] - path[:, :-1]
    assert bool(((steps >= 0) & (steps <= 2)).all()) and bool((path[:, 0] <= 1).all())
    assert ctc.viterbi_batch.launches == 0


def _mel_windows(device, seed=0):
    """Three 30 s f32 waveforms on ``device``: seeded noise with a tone,
    a 7.3 s one zero-padded to 30 s, and silence."""
    rng = np.random.default_rng(seed)
    waves = np.zeros((3, mel.N_SAMPLES), np.float32)
    t = np.arange(mel.N_SAMPLES) / mel.SAMPLE_RATE
    waves[0] = 0.1 * rng.standard_normal(mel.N_SAMPLES) + 0.3 * np.sin(2 * np.pi * 440 * t)
    n = int(7.3 * mel.SAMPLE_RATE)
    waves[1, :n] = 0.2 * rng.standard_normal(n)
    return torch.from_numpy(waves).to(device)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_takes_the_plain_version_on_cpu(n_mels):
    """Kernel C's wrapper on CPU tensors: exactly the plain version, no
    launch counted; the single-window mel is its normalized transpose,
    and the batched mel the same formula."""
    mel.log_mel_raw.launches = 0
    waves = _mel_windows("cpu")
    raw = mel.log_mel_raw(waves, n_mels)
    want = mel._log_mel_plain(waves, n_mels)
    assert raw.shape == (3, 3000, n_mels)
    torch.testing.assert_close(raw, want, rtol=0, atol=0)
    assert bool((raw[2] == -10.0).all())  # silence: every bin at the 1e-10 clamp
    single = mel.log_mel_spectrogram(waves[1], n_mels)
    torch.testing.assert_close(single, mel._finalize(want[1:2])[0].T, rtol=0, atol=0)
    torch.testing.assert_close(mel.log_mel_spectrogram_batch(waves, n_mels)[1], single,
                               rtol=0, atol=0)
    assert mel.log_mel_raw.launches == 0


@pytest.mark.parametrize("n_mels", [1, 40, 80, 128, 256, 1024])
def test_log_mel_kernel_tables(n_mels):
    """Kernel C's host tables: every nonzero of the mel bank lies in its
    band's [lo, hi), every weight outside it is 0, the band weights are
    the bank's own, and the window and twiddles are float64 cos and sin
    rounded to f32."""
    fb = mel.mel_filter_bank(mel.N_FFT // 2 + 1, n_mels)  # [201, n_mels]
    bands, weights = mel._mel_bands(n_mels)
    assert bands.dtype == np.int32 and bands.shape == (n_mels, 2)
    assert weights.dtype == np.float32 and weights.shape[0] == n_mels
    lo, hi = bands[:, 0], bands[:, 1]
    assert bool(((0 <= lo) & (lo <= hi) & (hi <= fb.shape[0])).all())
    assert int((hi - lo).max()) <= weights.shape[1]
    k = np.arange(fb.shape[0])[:, None]
    inside = (k >= lo[None]) & (k < hi[None])
    assert not fb[~inside].any()
    assert bool((fb[lo, np.arange(n_mels)][hi > lo] != 0).all())  # runs start on a nonzero
    assert bool((fb[hi - 1, np.arange(n_mels)][hi > lo] != 0).all())  # and end on one
    for m in range(n_mels):
        np.testing.assert_array_equal(weights[m, : hi[m] - lo[m]], fb[lo[m] : hi[m], m])
        assert not weights[m, hi[m] - lo[m] :].any()
    window, twiddles = mel._fft_tables()
    angle = 2.0 * np.pi * np.arange(mel.N_FFT, dtype=np.float64) / mel.N_FFT
    assert window.dtype == twiddles.dtype == np.float32
    np.testing.assert_array_equal(window, (0.5 - 0.5 * np.cos(angle)).astype(np.float32))
    np.testing.assert_array_equal(twiddles[:, 0], np.cos(angle).astype(np.float32))
    np.testing.assert_array_equal(twiddles[:, 1], (-np.sin(angle)).astype(np.float32))


# the radix-8 and radix-5 butterflies' constants, as csrc/log_mel.cu writes them
_R2 = np.float32(np.sqrt(0.5))
_C1, _C2 = np.float32(np.cos(2 * np.pi / 5)), np.float32(np.cos(4 * np.pi / 5))
_S1, _S2 = np.float32(np.sin(2 * np.pi / 5)), np.float32(np.sin(4 * np.pi / 5))


def _dft4(u):
    s0, d0 = u[..., 0] + u[..., 2], u[..., 0] - u[..., 2]
    s1, d1 = u[..., 1] + u[..., 3], u[..., 1] - u[..., 3]
    return np.stack([s0 + s1, d0 - 1j * d1, s0 - s1, d0 + 1j * d1], -1).astype(np.complex64)


def _dft8(v):
    """The kernel's radix-8 butterfly over the last axis: even outputs
    from the sums, odd ones from the differences times W8^r."""
    a, t = v[..., :4] + v[..., 4:], v[..., :4] - v[..., 4:]
    b = np.stack([t[..., 0], _R2 * (t[..., 1] * (1 - 1j)), t[..., 2] * -1j,
                  _R2 * (t[..., 3] * (-1 - 1j))], -1).astype(np.complex64)
    out = np.empty_like(v)
    out[..., 0::2], out[..., 1::2] = _dft4(a), _dft4(b)
    return out


def _dft5(v):
    """The kernel's radix-5 butterfly over the last axis."""
    t1, t2 = v[..., 1] + v[..., 4], v[..., 2] + v[..., 3]
    t3, t4 = v[..., 1] - v[..., 4], v[..., 2] - v[..., 3]
    a1, a2 = v[..., 0] + _C1 * t1 + _C2 * t2, v[..., 0] + _C2 * t1 + _C1 * t2
    b1, b2 = _S1 * t3 + _S2 * t4, _S2 * t3 - _S1 * t4
    return np.stack([v[..., 0] + t1 + t2, a1 - 1j * b1, a2 - 1j * b2, a2 + 1j * b2, a1 + 1j * b1],
                    -1).astype(np.complex64)


def _log_mel_fft_model(waves, n_mels):
    """A numpy f32 model of kernel C's factorization on ``[B, T]``
    waveforms: the 200-point FFT as 8 x 25 (thread n1's 25-point DFT as
    5 x 5, its twiddles W200^{n1 k2}, the 8-point DFTs over n1), the index
    maps, twiddle table and real split of csrc/log_mel.cu, then the banded
    mel and log10."""
    window, tw = mel._fft_tables()
    tw = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    bands, weights = mel._mel_bands(n_mels)
    n_frames = waves.shape[1] // mel.HOP_LENGTH
    padded = np.pad(waves, ((0, 0), (mel.N_FFT // 2, mel.N_FFT // 2)), mode="reflect")
    xw = padded[:, mel.HOP_LENGTH * np.arange(n_frames)[:, None] + np.arange(mel.N_FFT)] * window
    z = (xw[..., 0::2] + 1j * xw[..., 1::2]).astype(np.complex64)  # [B, F, 200]
    # thread n1 takes u[n2] = z[n1 + 8 n2]; n2 = 5a + b: a DFT over a for
    # each b, times W25^{bc} (entry 16 b c), then a DFT over b for each c
    n1, n2 = np.arange(8)[:, None], np.arange(25)[None]
    u = z[..., n1 + 8 * n2].reshape(z.shape[:-1] + (8, 5, 5))  # [..., n1, a, b]
    b, c = np.arange(5)[:, None], np.arange(5)[None]
    v = _dft5(np.swapaxes(u, -1, -2)) * tw[16 * b * c]  # [..., n1, b, c]
    y = _dft5(np.swapaxes(v, -1, -2))  # [..., n1, c, d]: Y[c + 5 d]
    y = np.swapaxes(y, -1, -2).reshape(y.shape[:-2] + (25,))  # [..., n1, k2]
    y = y * tw[2 * n1 * np.arange(25)[None]]  # W200^{n1 k2} (entry 2 n1 k2)
    # the 8-point DFT over n1 for each k2: Z[25 k1 + k2]
    zz = np.swapaxes(_dft8(np.swapaxes(y, -1, -2)), -1, -2).reshape(z.shape)
    # the real split, bins k and 200 - k for k = 0..100
    k = np.arange(101)
    zk, zr = zz[..., k], np.conj(zz[..., (200 - k) % 200])
    e, o = np.float32(0.5) * (zk + zr), np.float32(0.5) * (zk - zr)
    t = tw[k] * o
    xa, xb = e - 1j * t, e + 1j * t
    power = np.empty(zz.shape[:-1] + (201,), np.float32)
    power[..., 200 - k] = xb.real**2 + xb.imag**2
    power[..., k] = xa.real**2 + xa.imag**2
    out = np.zeros(power.shape[:-1] + (n_mels,), np.float32)
    for m, (lo, hi) in enumerate(bands):
        out[..., m] = power[..., lo:hi] @ weights[m, : hi - lo]
    return torch.log10(torch.clamp(torch.from_numpy(out), min=1e-10))


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_fft_model_matches_plain_and_float64(n_mels):
    """The numpy model of kernel C's FFT (8 x 25, the 25-point DFTs as
    5 x 5, and the real split) against the plain version within 1e-4 and against the same
    formula in float64 within 5e-5, after whisper's normalization: where
    a sign or an index of the factorization goes wrong without the card.
    Silence stays at the clamp."""
    waves = _mel_windows("cpu")
    got = _log_mel_fft_model(waves.numpy(), n_mels)
    want = mel._log_mel_plain(waves, n_mels)
    exact = mel._log_mel_plain(waves, n_mels, torch.float64)
    assert got.shape == want.shape == exact.shape == (3, 3000, n_mels)
    assert bool((got[2] == -10.0).all())
    torch.testing.assert_close(mel._finalize(got), mel._finalize(want), atol=1e-4, rtol=0)
    torch.testing.assert_close(mel._finalize(got.double()), mel._finalize(exact), atol=5e-5,
                               rtol=0)


def test_wrappers_raise_off_the_cpu_without_cuda():
    """A tensor that is neither on the CPU nor on a CUDA device (here
    PyTorch's shape-only "meta" device) is refused before any build or
    launch: the wrappers never fall back to the plain version."""
    meta = torch.device("meta")
    q = torch.empty((4, 1, 2, 64), device=meta)
    kv = torch.empty((1, 2, 2, 128, 128), dtype=torch.int8, device=meta)
    scale = torch.empty((2, 64), device=meta)
    with pytest.raises(ValueError, match="CUDA device"):
        cross_decode.cross_attention_decode_layered(q, kv, scale, scale, 0, 100, beam=2)
    x = torch.empty((2, 100, 2, 64), dtype=torch.bfloat16, device=meta)
    with pytest.raises(ValueError, match="CUDA device"):
        attention.encoder_attention(x, x, x)
    with pytest.raises(ValueError, match="CUDA device"):
        ctc.viterbi_batch(torch.empty((2, 10, 5), device=meta),
                          torch.empty((2, 5), dtype=torch.bool, device=meta))
    q, k, v, anc, mask = (x.to(meta) for x in _ancestry_inputs("cpu", torch.bfloat16, 0))
    with pytest.raises(ValueError, match="CUDA device"):
        self_decode.self_attention_decode_ancestry_layered(q, k, v, anc, mask, 0, 5)
    idx = torch.arange(15, device=meta)
    with pytest.raises(ValueError, match="CUDA device"):
        beam_permute.beam_permute_cache(k, v, idx)
    with pytest.raises(ValueError, match="CUDA device"):
        beam_permute.beam_permute_cache_inplace(k, v, idx.reshape(3, 5), 5)
    with pytest.raises(ValueError, match="CUDA device"):
        mel.log_mel_raw(torch.empty((1, 480000), device=meta))
    with pytest.raises(ValueError, match="CUDA device"):
        mel.log_mel_spectrogram_batch(torch.empty((2, 480000), device=meta))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("windows,beam", [(1, 1), (1, 5), (3, 2), (3, 8)])
@pytest.mark.parametrize("kp,k_len,cluster", [(1536, 1500, None), (1536, 1400, None),
                                              (1536, 1, None), (1536, 1536, 2),
                                              (128, 128, None), (128, 77, 4), (256, 200, 8)])
def test_kernels_match_plain_on_cuda(cuda_device, bits, windows, beam, kp, k_len, cluster):
    """Kernel A against its plain version on the card, at both layers of
    the stack: one window and three, beam 1 to 8, bits 8 and 4; k_len of
    1 (every other CTA of the cluster holds only masked positions), inside
    the last CTA's slice, and equal to Kp; Kp = 128 (16 positions a CTA);
    cluster sizes 2, 4 and 8 beside the wrapper's choice; bf16 q and
    non-unit k_scale/v_scale, so the in-kernel fold is checked. Within
    5e-3 per unit of v_scale on outputs that are weighted sums of int8
    values up to 127 (both round q and the weights to bf16; f32 sums in
    another order). One launch a call; out-of-range arguments raise."""
    g = torch.Generator(device=cuda_device).manual_seed(bits * 1000 + kp + k_len)
    h, d = 4, 64
    rows = 2 * d if bits == 8 else d
    kv = torch.randint(-127, 128, (2, windows, h, rows, kp), device=cuda_device, generator=g,
                       dtype=torch.int8)
    q = torch.randn((windows * beam, 1, h, d), device=cuda_device, generator=g).bfloat16()
    k_scale = 0.005 + 0.05 * torch.rand((h, d), device=cuda_device, generator=g)
    v_scale = (0.5 + torch.rand((h, d), device=cuda_device, generator=g)) / 127
    launches = cross_decode.cross_attention_decode_layered.launches
    for layer in (0, 1):
        got = cross_decode._cross_attention_decode_cuda(q, kv, k_scale, v_scale, layer, k_len,
                                                        bits, beam, cluster)
        ref = cross_decode._cross_attention_decode_plain(cross_decode.fold_q(q, k_scale), kv,
                                                         layer, k_len, bits, beam)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and bool(torch.isfinite(got).all())
        torch.testing.assert_close(got / v_scale, ref, atol=5e-3 * 127, rtol=0)
    public = cross_decode.cross_attention_decode_layered(q, kv, k_scale, v_scale, 1, k_len,
                                                         bits, beam)
    torch.testing.assert_close(public[:, 0] / v_scale, ref, atol=5e-3 * 127, rtol=0)
    assert cross_decode.cross_attention_decode_layered.launches == launches + 3
    with pytest.raises(ValueError, match="shapes"):
        cross_decode._cross_attention_decode_cuda(q, kv, k_scale, v_scale, 2, k_len, bits, beam)
    with pytest.raises(ValueError, match="shapes"):
        cross_decode._cross_attention_decode_cuda(q, kv, k_scale, v_scale, 0, kp + 1, bits, beam)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 63, 64, 65, 127, 129, 1499, 1500])
@pytest.mark.parametrize("b,h", [(1, 3), (1, 16), (3, 3), (3, 16)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_encoder_attention_kernel_matches_plain_on_cuda(cuda_device, t, b, h, dtype):
    """Kernel B against its plain version on the card: lengths around the
    128-row tiles (ragged query and key tiles, one key), batch 1 and 3,
    3 and 16 heads; bf16 in and out, and f32 in and out. bf16: inputs are
    N(0, 1), so the outputs' RMS falls from 1 at T=1 to about sqrt(e/T),
    0.043 at T=1500, and the absolute bound 1e-2 is a quarter of that; so
    the error is also held within 0.2 of the outputs' RMS at every T. Both
    come from the rounding: bf16 P in the PV product against bf16
    normalized weights, q and k rounded to bf16 after the D^-1/4 scale in
    the plain version, bf16 outputs (an emulation of the kernel's rounding
    on the CPU reads at most 0.09 of the RMS at these shapes). f32: the
    kernel's split bf16 products (hi and lo parts of q, k, v and P) leave
    terms of order 2^-16 of each product, held within 1e-4 of the plain
    version's f32 with TF32 off."""
    g = torch.Generator(device=cuda_device).manual_seed(t * 7 + b * 3 + h)
    q, k, v = (torch.randn((b, t, h, 64), device=cuda_device, generator=g).to(dtype)
               for _ in range(3))
    launches = attention.encoder_attention.launches
    got = attention.encoder_attention(q, k, v)
    want = _f32_plain(q, k, v)
    torch.cuda.synchronize()
    assert attention.encoder_attention.launches == launches + 1
    assert got.dtype == dtype and got.shape == want.shape
    _hold_kernel_b(got, want, dtype)


def _f32_plain(q, k, v):
    """Kernel B's plain version with TF32 off (the f32 widths' setting)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return attention._xla_attention(q, k, v)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _hold_kernel_b(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        return
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=0)
    err = float((got.float() - want.float()).abs().max())
    assert err <= 0.2 * float(want.float().pow(2).mean().sqrt()), err


@pytest.mark.cuda
@pytest.mark.parametrize("b,h", [(4, 16), (8, 16), (4, 20), (8, 20)])
def test_encoder_attention_f32_on_cuda(cuda_device, b, h):
    """Kernel B at f32 at the encoders' T = 1500 (medium.en's 16 heads at
    batch 4 and 8, large-v2's 20 at batch 4, large-v3's 20 at config 3's
    batch 8) on N(0, 1) inputs, within
    1e-4 of the plain version's f32 (TF32 off); one launch a call. The
    split's error is relative: of order 2^-16 of |q||k| in each logit and
    of |v| in the output."""
    g = torch.Generator(device=cuda_device).manual_seed(b * 100 + h)
    q, k, v = (torch.randn((b, 1500, h, 64), device=cuda_device, generator=g)
               for _ in range(3))
    launches = attention.encoder_attention.launches
    got = attention.encoder_attention(q, k, v)
    want = _f32_plain(q, k, v)
    torch.cuda.synchronize()
    assert attention.encoder_attention.launches == launches + 1
    _hold_kernel_b(got, want, torch.float32)


def _viterbi_random(r, t, n_states, seed, ties):
    """``[r, t, n_states]`` f32 state emissions with random skip
    permissions (``ties``: values on a grid of 0.5, so equal candidates
    are common and the first-maximum rule decides)."""
    rng = np.random.default_rng(seed)
    em = rng.standard_normal((r, t, n_states)).astype(np.float32) * 3
    if ties:
        em = np.round(em * 2) / 2
    return torch.from_numpy(em), torch.from_numpy(rng.random((r, n_states)) < 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("r,t,n", [(3, 300, 20), (2, 1, 3), (1, 40, 15000)])
def test_viterbi_kernel_matches_plain_on_cuda(cuda_device, r, t, n):
    """Kernel D against its plain version on the card, bit for bit:
    rows of different content, a single frame, and L = 30001 states,
    a cluster of CTAs (chip_smoke.py checks the main path's shapes)."""
    e_states, skips = _viterbi_case(r, t, n, 3)
    e_states, skips = e_states.to(cuda_device), skips.to(cuda_device)
    launches = ctc.viterbi_batch.launches
    got = ctc.viterbi_batch(e_states, skips)
    want_alpha, want_bps = ctc._viterbi_forward_states(e_states, skips)
    want = (want_alpha, want_bps, ctc._viterbi_backtrack(want_alpha, want_bps))
    torch.cuda.synchronize()
    assert ctc.viterbi_batch.launches == launches + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("r,t,n_states,ties", [
    (2, 7, 1, False), (2, 7, 2, True), (3, 1, 3, False), (2, 9, 3, True),
    (2, 50, 256, True), (2, 50, 257, False), (3, 64, 1025, True), (1, 33, 2049, False),
    (2, 20, 16384, True), (1, 20, 16385, False), (1, 12, 28785, True), (1, 6, 32769, False),
])
def test_viterbi_kernel_edges_on_cuda(cuda_device, r, t, n_states, ties):
    """Kernel D bit for bit at its edges, with random skip permissions
    (also at states 0 and 1, where the rule never skips): L = 1, 2 and 3;
    a single frame; one warp's 256 states and one more (two segments);
    the main bucket's L = 1025 (five warps); 2049; the last L of 8 and of
    16 states a lane; past the 28,784 states whose alpha buffers filled
    the earlier design's shared memory; 32 states a lane. Emissions on a
    grid of 0.5 make ties common, where the first maximum must win."""
    e_states, skips = (x.to(cuda_device) for x in _viterbi_random(r, t, n_states, n_states, ties))
    got = ctc.viterbi_batch(e_states, skips)
    want_alpha, want_bps = ctc._viterbi_forward_states(e_states, skips)
    want = (want_alpha, want_bps, ctc._viterbi_backtrack(want_alpha, want_bps))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("r,t,n_states,ties", [
    (1, 6, 65536, True), (2, 9, 65537, False), (1, 12, 70001, True), (1, 300, 70001, False),
    (1, 5, 196609, True),
])
def test_viterbi_kernel_passes_on_cuda(cuda_device, r, t, n_states, ties):
    """Kernel D bit for bit on trellises wider than one pass of 65,536
    states (a global alignment of more than about half an hour): the last
    L of one pass, one state more, about 70,000 states at few and at 300
    frames, and four passes. Non-negative emissions of order 1e28 make the
    states no path reaches yet (alpha -1e30 + emissions) differ too, so
    every edge handed from one pass to the next decides backpointers. (Not
    negative: as with log-probs, every alpha then stays at or above the
    -1e30 that stands for a skip the rule forbids, where the plain version
    and the kernel agree by construction.)"""
    e_states, skips = _viterbi_random(r, t, n_states, n_states, ties)
    e_states, skips = (e_states.abs() * 1e28).to(cuda_device), skips.to(cuda_device)
    got = ctc.viterbi_batch(e_states, skips)
    want_alpha, want_bps = ctc._viterbi_forward_states(e_states, skips)
    want = (want_alpha, want_bps, ctc._viterbi_backtrack(want_alpha, want_bps))
    torch.cuda.synchronize()
    assert bool((want_bps[:, :, n_states // 2:] != 0).any())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("per_row_mask", [False, True])
def test_self_decode_kernel_matches_plain_on_cuda(cuda_device, per_row_mask):
    """Kernel E against its plain version on the card, at both layers of
    the cache and both mask forms (one shared row, one row per beam row),
    with positions past the last visible one unread: 1e-2 + 1e-2·|plain|
    on bf16 outputs of order 1 (both round the output to bf16 once; the
    kernel's f32 sums run in another order). Out-of-range shapes and
    types raise (chip_smoke.py checks the main path's shapes)."""
    q, k, v, anc, mask = _ancestry_inputs(cuda_device, torch.bfloat16, 5)
    if per_row_mask:
        g = torch.Generator(device=cuda_device).manual_seed(9)
        keep = torch.rand((15, 40), device=cuda_device, generator=g) > 0.3
        keep[:, 0] = True
        mask = torch.where(keep & (torch.arange(40, device=cuda_device) < 33), 0.0,
                           float("-inf"))[:, None, None, :].contiguous()
    launches = self_decode.self_attention_decode_ancestry_layered.launches
    for layer in (0, 1):
        got = self_decode.self_attention_decode_ancestry_layered(q, k, v, anc, mask, layer, 5,
                                                                 n_visible=33)
        want = attention.attention_kt_ancestry(q, k[layer], v[layer], anc, mask)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)
    assert self_decode.self_attention_decode_ancestry_layered.launches == launches + 2
    with pytest.raises(TypeError, match="int32"):
        self_decode.self_attention_decode_ancestry_layered(q, k, v, anc.long(), mask, 0, 5)
    with pytest.raises(ValueError, match="shapes"):
        self_decode.self_attention_decode_ancestry_layered(q, k, v, anc, mask, 2, 5)


# |kernel - plain| <= atol + rtol * |plain| on outputs of order 1: bf16 as
# above; f32 keeps q, the weights and the output in f32, so only the order
# of the f32 sums differs
E_BOUNDS = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-4, 1e-4)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("beam,windows,s,n_visible,per_row,cluster,d", [
    (1, 1, 40, 1, False, None, 64), (2, 3, 64, 64, True, None, 64),
    (3, 5, 128, 128, False, 1, 64), (4, 2, 128, 63, True, 2, 64), (5, 1, 384, 101, True, None, 64),
    (5, 4, 256, 64, False, 2, 64), (5, 4, 256, 65, False, 4, 64), (5, 32, 256, 226, False, None, 64),
    (6, 1, 448, 448, True, 8, 64), (7, 2, 448, 300, False, 3, 64), (8, 2, 128, 127, True, 8, 64),
    (8, 1, 64, 9, False, 8, 64), (3, 2, 64, 40, True, None, 18), (5, 2, 128, 100, False, 2, 128),
])
def test_self_decode_kernel_shapes_on_cuda(cuda_device, dtype, beam, windows, s, n_visible,
                                           per_row, cluster, d):
    """Kernel E against its plain version at bf16 and f32: beam 1 to 8,
    one window and many, a shared mask and one mask row per beam row (a
    third of the positions hidden at random, position 0 kept), n_visible
    of 1, at the edges of 16- to 64-position tiles and equal to S, cluster
    sizes 1, 2, 3, 4 and 8 beside the wrapper's choice (8 with fewer
    positions than CTAs), and head dims 18 and 128 beside Whisper's 64.
    Positions at and past n_visible hold NaN, so a read of one shows. The
    output has the cache's dtype."""
    g = torch.Generator(device=cuda_device).manual_seed(beam * 1000 + s + n_visible)
    bk, h = windows * beam, 4
    q = torch.randn((bk, 1, h, d), device=cuda_device, generator=g).to(dtype)
    k, v = (torch.randn((2, bk, h, d, s), device=cuda_device, generator=g).to(dtype)
            for _ in range(2))
    for x in (k, v):
        x[..., n_visible:] = float("nan")
    anc = torch.randint(0, beam, (windows, beam, s), device=cuda_device, generator=g,
                        dtype=torch.int32)
    visible = torch.arange(s, device=cuda_device) < n_visible
    if per_row:
        keep = torch.rand((bk, s), device=cuda_device, generator=g) > 0.3
        keep[:, 0] = True
        mask = torch.where(keep & visible, 0.0, float("-inf"))[:, None, None, :].contiguous()
    else:
        mask = torch.where(visible, 0.0, float("-inf"))[None, None, None, :]
    atol, rtol = E_BOUNDS[dtype]
    for layer in (0, 1):
        got = self_decode._self_decode_cuda(q, k, v, anc, mask, layer, beam, n_visible, cluster)
        kl, vl = (x[layer, ..., :n_visible] for x in (k, v))
        want = attention.attention_kt_ancestry(q, kl, vl, anc[..., :n_visible],
                                               mask[..., :n_visible])
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 48, 80, 128])
@pytest.mark.parametrize("t", [1, 65, 1500])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_encoder_attention_head_dims_on_cuda(cuda_device, d, t, dtype):
    """Kernel B at head dims other than 64: 32 and 48 on the 64-column
    instantiation (the columns past D zero-filled by TMA), 80 and 128 on
    the 128-column one (one K/V stage at f32); held as the D = 64 test
    holds it (bf16: 1e-2, and 0.2 of the outputs' RMS; f32: 1e-4). A head
    dim past 128 raises, naming ROADMAP."""
    g = torch.Generator(device=cuda_device).manual_seed(t * 7 + d)
    q, k, v = (torch.randn((2, t, 3, d), device=cuda_device, generator=g).to(dtype)
               for _ in range(3))
    got = attention.encoder_attention(q, k, v)
    want = _f32_plain(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    _hold_kernel_b(got, want, dtype)
    wide = torch.zeros((1, 8, 2, 136), device=cuda_device, dtype=dtype)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attention.encoder_attention(wide, wide, wide)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", [(torch.bfloat16, (3, 15, 4, 64, 40)),
                                         (torch.float32, (2, 10, 3, 5)),
                                         (torch.int8, (2, 10, 7))])
def test_beam_permute_kernel_matches_plain_on_cuda(cuda_device, dtype, shape):
    """Kernel F against its plain versions on the card, bit for bit: rows
    of 16-byte vectors, of 4-byte ones and of single bytes; out of place
    with rows from any window, in place with gather repeats."""
    g = torch.Generator(device=cuda_device).manual_seed(len(shape))
    k, v = (torch.randint(-100, 100, shape, device=cuda_device, generator=g).to(dtype)
            for _ in range(2))
    idx = torch.randperm(shape[1], device=cuda_device, generator=g)
    idx[0] = idx[1]
    got = beam_permute.beam_permute_cache(k, v, idx)
    want = (k[:, idx], v[:, idx])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    src = torch.randint(0, 5, (shape[1] // 5, 5), device=cuda_device, generator=g)
    rows = (torch.arange(shape[1] // 5, device=cuda_device)[:, None] * 5 + src).reshape(-1)
    want = (k[:, rows].clone(), v[:, rows].clone())
    got = beam_permute.beam_permute_cache_inplace(k, v, src, 5)
    torch.cuda.synchronize()
    assert got[0] is k and torch.equal(k, want[0]) and torch.equal(v, want[1])


def _log_mel_errors(waves, n_mels, got):
    """max|err| of kernel C's ``got`` after whisper's normalization,
    against the plain version and against the same formula in float64."""
    want = mel._log_mel_plain(waves, n_mels)
    exact = mel._log_mel_plain(waves, n_mels, torch.float64)
    err = float((mel._finalize(got) - mel._finalize(want)).abs().max())
    err64 = float((mel._finalize(got.double()) - mel._finalize(exact)).abs().max())
    return err, err64


@pytest.mark.cuda
@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_kernel_matches_plain_on_cuda(cuda_device, n_mels):
    """Kernel C against its plain version on the card, TF32 off: a 30 s
    window, a 7.3 s one zero-padded to 30 s and silence, as one batch and
    one window alone, and a batch of 32 speech-like windows through the
    batched mel (one launch), at 80 and 128 mel bands. After whisper's normalization
    (values of order 1) within 1e-4 of the plain version (an f32 FFT
    against f32 dense products, each with its own rounding) and within
    5e-5 of the same formula in float64. Silence is -10 exactly (the
    1e-10 clamp). Wrong types and shapes raise."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        waves = _mel_windows(cuda_device)
        launches = mel.log_mel_raw.launches
        got = mel.log_mel_raw(waves, n_mels)
        want = mel._log_mel_plain(waves, n_mels)
        one = mel.log_mel_spectrogram(waves[1], n_mels)
        # phase 3e's batch of 32 windows of speech-like audio, the last silent
        batch = speechlike(32 * 30.0, 7).reshape(32, mel.N_SAMPLES)
        batch = torch.from_numpy(batch).to(cuda_device)
        batch[-1] = 0.0
        batched = mel.log_mel_spectrogram_batch(batch, n_mels)
        batch_want = mel._finalize(mel._log_mel_plain(batch, n_mels)).transpose(-1, -2)
        errs = _log_mel_errors(waves, n_mels, got)
        batch_raw = mel.log_mel_raw(batch, n_mels)
        batch_errs = _log_mel_errors(batch, n_mels, batch_raw)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert mel.log_mel_raw.launches == launches + 4
    assert got.shape == want.shape == (3, 3000, n_mels)
    assert bool((got[2] == -10.0).all()) and bool((batch_raw[-1] == -10.0).all())
    torch.testing.assert_close(mel._finalize(got), mel._finalize(want), atol=1e-4, rtol=0)
    torch.testing.assert_close(one, mel._finalize(want[1:2])[0].T, atol=1e-4, rtol=0)
    assert batched.shape == (32, n_mels, 3000)
    torch.testing.assert_close(batched, batch_want, atol=1e-4, rtol=0)
    for err, err64 in (errs, batch_errs):
        assert err <= 1e-4 and err64 <= 5e-5, (err, err64)
    with pytest.raises(TypeError, match="f32"):
        mel.log_mel_raw(waves.double(), n_mels)
    with pytest.raises(ValueError, match="contiguous"):
        mel.log_mel_raw(waves[:, ::2], n_mels)
    with pytest.raises(ValueError, match="reflect"):
        mel.log_mel_raw(waves[:, :100].contiguous(), n_mels)


@pytest.mark.cuda
@pytest.mark.parametrize("t,n_mels", [(480_100, 80), (201, 80), (16_000, 80), (16_000, 128),
                                      (mel.N_SAMPLES, 1), (mel.N_SAMPLES, 1024)])
def test_log_mel_kernel_shapes_on_cuda(cuda_device, t, n_mels):
    """Kernel C at other lengths and widths, TF32 off: T not a multiple
    of 160, T = 201 (one frame, the reflect padding's least), one second,
    one band and 1024 bands (most of them without a nonzero bin), two
    waveforms and a silent third. Within 1e-4 of the plain version and
    5e-5 of float64 after whisper's normalization; silence is -10."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rng = np.random.default_rng(t + n_mels)
        waves = np.zeros((3, t), np.float32)
        tone = np.sin(2 * np.pi * 440 * np.arange(t) / mel.SAMPLE_RATE)
        waves[0] = 0.1 * rng.standard_normal(t) + 0.3 * tone
        waves[1] = 0.02 * rng.standard_normal(t)
        waves = torch.from_numpy(waves).to(cuda_device)
        launches = mel.log_mel_raw.launches
        got = mel.log_mel_raw(waves, n_mels)
        err, err64 = _log_mel_errors(waves, n_mels, got)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert mel.log_mel_raw.launches == launches + 1
    assert got.shape == (3, t // mel.HOP_LENGTH, n_mels)
    assert bool(torch.isfinite(got).all()) and bool((got[2] == -10.0).all())
    assert err <= 1e-4 and err64 <= 5e-5, (err, err64)


@pytest.mark.cuda
@pytest.mark.parametrize("n_windows", [8, 2])
def test_log_mel_kernel_large_v3_batches_on_cuda(cuda_device, n_windows):
    """Kernel C at config 3's shapes: batches of 8 and 2 windows (5 minutes
    at batch 8 in two batches) at large-v3's 128 mel bands, one launch a
    batch, within 1e-4 of the plain version and 5e-5 of float64."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        waves = speechlike(n_windows * 30.0, n_windows).reshape(n_windows, mel.N_SAMPLES)
        waves = torch.from_numpy(waves).to(cuda_device)
        launches = mel.log_mel_raw.launches
        got = mel.log_mel_raw(waves, 128)
        err, err64 = _log_mel_errors(waves, 128, got)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert mel.log_mel_raw.launches == launches + 1
    assert got.shape == (n_windows, 3000, 128)
    assert err <= 1e-4 and err64 <= 5e-5, (err, err64)


@pytest.mark.cuda
@pytest.mark.parametrize("s,n_visible", [(256, 5), (256, 226), (384, 300), (448, 448)])
def test_self_decode_kernel_large_v3_on_cuda(cuda_device, s, n_visible):
    """Kernel E at f32 at config 3's beam cache: 8 windows at beam 5 (B·K =
    40) with large-v3's 20 heads of 64, caches of 256 to 448 positions,
    through the wrapper's cluster choice, within E_BOUNDS of the plain
    version; positions past n_visible hold NaN."""
    g = torch.Generator(device=cuda_device).manual_seed(s + n_visible)
    windows, beam, h = 8, 5, 20
    bk = windows * beam
    q = torch.randn((bk, 1, h, 64), device=cuda_device, generator=g)
    k, v = (torch.randn((2, bk, h, 64, s), device=cuda_device, generator=g) for _ in range(2))
    for x in (k, v):
        x[..., n_visible:] = float("nan")
    anc = torch.randint(0, beam, (windows, beam, s), device=cuda_device, generator=g,
                        dtype=torch.int32)
    mask = torch.where(torch.arange(s, device=cuda_device) < n_visible, 0.0,
                       float("-inf"))[None, None, None, :]
    launches = self_decode.self_attention_decode_ancestry_layered.launches
    got = self_decode.self_attention_decode_ancestry_layered(q, k, v, anc, mask, 1, beam,
                                                              n_visible=n_visible)
    want = attention.attention_kt_ancestry(q, k[1, ..., :n_visible], v[1, ..., :n_visible],
                                           anc[..., :n_visible], mask[..., :n_visible])
    torch.cuda.synchronize()
    assert self_decode.self_attention_decode_ancestry_layered.launches == launches + 1
    torch.testing.assert_close(got, want, atol=E_BOUNDS[torch.float32][0],
                               rtol=E_BOUNDS[torch.float32][1])


@pytest.mark.cuda
def test_resample_poly_on_cuda(cuda_device):
    """The polyphase resample 44.1 kHz -> 16 kHz of 10 s on the card against
    the same GEMM on the CPU, within 1e-5 (TF32 off)."""
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 441_000)).astype(np.float32))
    with full_f32():
        got = resample_poly(x.to(cuda_device), 44100, 16000)
    torch.testing.assert_close(got.cpu(), resample_poly(x, 44100, 16000), atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_htdemucs_forward_on_cuda(cuda_device):
    """htdemucs at small dims (chip_smoke.DEMUCS_SMALL) on the card against
    the CPU, f32 with TF32 off: the forward of two mixes of 8,000 samples
    and apply_segments over 8 windows, 3 a batch, each within 1e-4 of the
    largest CPU output."""
    dims = htdemucs.HTDemucsDims(**DEMUCS_SMALL)
    params = htdemucs.init_htdemucs_params(dims, "cpu", torch.Generator().manual_seed(0))
    rng = np.random.default_rng(9)
    mix = torch.from_numpy((0.2 * rng.standard_normal((2, 2, 8000))).astype(np.float32))
    wave = torch.from_numpy((0.2 * rng.standard_normal((2, 47_500))).astype(np.float32))
    outs = {}
    for dev in ("cpu", cuda_device):
        p = to_device(params, dev)
        with full_f32(), torch.inference_mode():
            outs[str(dev)] = (
                htdemucs.htdemucs_forward(p, mix.to(dev), dims).cpu(),
                htdemucs.apply_segments(p, wave, dims, batch_size=3, device_out=True).cpu())
    for got, want in zip(outs[str(cuda_device)], outs["cpu"]):
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())

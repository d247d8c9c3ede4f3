"""Hybrid Transformer Demucs (htdemucs) in PyTorch: the CLI's vocal
separator (``demucs.separate -n htdemucs --two-stems=vocals``).

Counterpart of ``whisper_nemo_tpu/models/htdemucs.py``: a frequency-branch
conv encoder over a complex-as-channels spectrogram and a time-branch
conv encoder over the waveform, joined by a cross-domain transformer at
the bottleneck, mirrored decoders with skip connections, and the spectral
output's iSTFT summed with the time branch's waveform. The param tree is
the torch state dict's (Conv ``[O, I, *k]``, ConvTranspose ``[I, O,
*k]``, Linear ``[out, in]``), re-keyed by the JAX package's converter;
``engine/checkpoint.params_from_jax`` keeps its layouts.

Long audio is separated in fixed ``segment``-long windows with triangular
cross-fade weights and a zero-padded tail (demucs' ``apply_model``
contract), ``batch_size`` windows a forward, the overlap-add accumulated
on the device. ``separate_vocals`` writes the CLI's
``<out>/htdemucs/<track>/vocals.wav``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..engine.checkpoint import flatten_tree, load_params, model_cache_dir, to_device
from ..engine.precision import full_f32

Params = Dict[str, Any]

NATIVE_SAMPLE_RATE = 44100


@dataclass(frozen=True)
class HTDemucsDims:
    sources: Tuple[str, ...] = ("drums", "bass", "other", "vocals")
    audio_channels: int = 2
    channels: int = 48
    growth: int = 2
    depth: int = 4
    nfft: int = 4096
    kernel_size: int = 8
    stride: int = 4
    # the encoders' rewrite is 1x1 (context_enc=0), the decoders' 3 wide
    context: int = 1
    # DConv residual branches (encoders only: dconv_mode=1)
    dconv_depth: int = 2
    dconv_comp: int = 8
    # frequency embedding after the first frequency encoder layer
    freq_emb_scale: float = 0.2
    emb_scale: float = 10.0
    # cross-domain transformer
    bottom_channels: int = 512
    t_layers: int = 5
    t_heads: int = 8
    t_hidden_scale: float = 4.0
    max_period: float = 10000.0
    # the released model was trained on 7.8 s windows and is applied at that length
    segment: float = 7.8
    samplerate: int = NATIVE_SAMPLE_RATE

    @property
    def hop_length(self) -> int:
        return self.nfft // 4

    @property
    def freqs(self) -> int:
        return self.nfft // 2

    def layer_channels(self) -> List[int]:
        return [self.channels * self.growth**i for i in range(self.depth)]


# -- spectrogram with demucs' padding contract ----------------------------------


def _hann(nfft: int, device) -> torch.Tensor:
    return torch.hann_window(nfft, periodic=True, dtype=torch.float32, device=device)


def _spec(x: torch.Tensor, dims: HTDemucsDims) -> torch.Tensor:
    """``[B, C, T]`` -> complex ``[B, C, nfft/2, ceil(T / hop)]``: demucs'
    ``_spec``, so that the frequency and time branches align (torch.stft
    with reflect padding, normalized, the Nyquist bin dropped)."""
    hl, nfft = dims.hop_length, dims.nfft
    le = -(-x.shape[-1] // hl)
    pad = hl // 2 * 3
    x = F.pad(x, (pad, pad + le * hl - x.shape[-1]), mode="reflect")
    z = torch.stft(x.reshape(-1, x.shape[-1]), nfft, hl, window=_hann(nfft, x.device),
                   center=True, pad_mode="reflect", normalized=True, return_complex=True)
    z = z.reshape(*x.shape[:-1], *z.shape[-2:])
    return z[..., :-1, 2: 2 + le]


def _ispec(z: torch.Tensor, dims: HTDemucsDims, length: int) -> torch.Tensor:
    """The inverse of ``_spec``: complex ``[..., nfft/2, frames]`` -> ``[..., length]``."""
    hl, nfft = dims.hop_length, dims.nfft
    z = F.pad(z, (2, 2, 0, 1))
    pad = hl // 2 * 3
    le = hl * -(-length // hl) + 2 * pad
    x = torch.istft(z.reshape(-1, *z.shape[-2:]), nfft, hl, window=_hann(nfft, z.device),
                    center=True, normalized=True, length=le)
    return x.reshape(*z.shape[:-2], le)[..., pad: pad + length]


def _magnitude_cac(z: torch.Tensor) -> torch.Tensor:
    """Complex ``[B, C, Fr, T]`` -> real ``[B, 2C, Fr, T]``, channels
    (c0 real, c0 imaginary, c1 real, ...)."""
    b, c, fr, t = z.shape
    return torch.view_as_real(z).permute(0, 1, 4, 2, 3).reshape(b, 2 * c, fr, t)


def _mask_cac(m: torch.Tensor) -> torch.Tensor:
    """Real ``[B, S, 2C, Fr, T]`` -> complex ``[B, S, C, Fr, T]``."""
    b, s, c2, fr, t = m.shape
    m = m.reshape(b, s, c2 // 2, 2, fr, t).permute(0, 1, 2, 4, 5, 3)
    return torch.view_as_complex(m.contiguous())


# -- layers ---------------------------------------------------------------------


def _conv1d(p: Params, x: torch.Tensor, **kw) -> torch.Tensor:
    return F.conv1d(x, p["weight"], p["bias"], **kw)


def _conv2d(p: Params, x: torch.Tensor, **kw) -> torch.Tensor:
    return F.conv2d(x, p["weight"], p["bias"], **kw)


def _group_norm1(p: Params, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm(1, C): statistics over the channels and every other axis."""
    return F.group_norm(x, 1, p["weight"], p["bias"], eps=1e-5)


def _dconv(p: Params, x: torch.Tensor) -> torch.Tensor:
    """DConv on ``[B, C, T]``: residual branches of a dilated conv
    (dilation 2^d), GroupNorm, GELU, a 1x1 conv to 2C, GroupNorm, GLU and
    a LayerScale."""
    for d, lp in enumerate(p["layers"]):
        y = F.gelu(_group_norm1(lp["norm1"], _conv1d(lp["conv1"], x, padding=2**d,
                                                    dilation=2**d)))
        y = F.glu(_group_norm1(lp["norm2"], _conv1d(lp["conv2"], y)), dim=1)
        x = x + lp["scale"][:, None] * y
    return x


def _henc_freq(p: Params, x: torch.Tensor, dims: HTDemucsDims) -> torch.Tensor:
    """HEncLayer(freq=True): a conv over frequency, DConv over time in each
    frequency bin, a 1x1 rewrite and GLU."""
    x = F.gelu(_conv2d(p["conv"], x, stride=(dims.stride, 1), padding=(dims.kernel_size // 4, 0)))
    b, c, fr, t = x.shape
    y = _dconv(p["dconv"], x.transpose(1, 2).reshape(b * fr, c, t))
    x = y.reshape(b, fr, c, t).transpose(1, 2)
    return F.glu(_conv2d(p["rewrite"], x), dim=1)


def _henc_time(p: Params, x: torch.Tensor, dims: HTDemucsDims) -> torch.Tensor:
    """HEncLayer(freq=False) on ``[B, C, T]``: T padded to a multiple of the
    stride, a strided conv, DConv, a 1x1 rewrite and GLU."""
    rem = x.shape[-1] % dims.stride
    if rem:
        x = F.pad(x, (0, dims.stride - rem))
    x = F.gelu(_conv1d(p["conv"], x, stride=dims.stride, padding=dims.kernel_size // 4))
    return F.glu(_conv1d(p["rewrite"], _dconv(p["dconv"], x)), dim=1)


def _hdec_freq(p: Params, x: torch.Tensor, skip: torch.Tensor, dims: HTDemucsDims,
               last: bool) -> torch.Tensor:
    """HDecLayer(freq=True): the skip added, a 3x3 rewrite and GLU, a
    transposed conv over frequency, its pad rows trimmed."""
    x = F.glu(_conv2d(p["rewrite"], x + skip, padding=(dims.context, dims.context)), dim=1)
    pad = dims.kernel_size // 4
    z = F.conv_transpose2d(x, p["conv_tr"]["weight"], p["conv_tr"]["bias"],
                           stride=(dims.stride, 1))[:, :, pad:-pad]
    return z if last else F.gelu(z)


def _hdec_time(p: Params, x: torch.Tensor, skip: torch.Tensor, length: int,
               dims: HTDemucsDims, last: bool) -> torch.Tensor:
    x = F.glu(_conv1d(p["rewrite"], x + skip, padding=dims.context), dim=1)
    pad = dims.kernel_size // 4
    z = F.conv_transpose1d(x, p["conv_tr"]["weight"], p["conv_tr"]["bias"],
                           stride=dims.stride)[..., pad: pad + length]
    return z if last else F.gelu(z)


# -- cross-domain transformer ---------------------------------------------------


def _sin_embedding_1d(length: int, dim: int, max_period: float) -> np.ndarray:
    """demucs' create_sin_embedding, ``[T, dim]``: cosines in the first half
    of the channels, sines in the second."""
    pos = np.arange(length, dtype=np.float64)[:, None]
    half = dim // 2
    phase = pos / (max_period ** (np.arange(half, dtype=np.float64)[None, :] / (half - 1)))
    return np.concatenate([np.cos(phase), np.sin(phase)], axis=-1).astype(np.float32)


def _sin_embedding_2d(dim: int, height: int, width: int, max_period: float) -> np.ndarray:
    """demucs' create_2d_sin_embedding as ``[width (T), height (Fr), dim]``:
    the first half of the channels encodes time, the second frequency,
    sines and cosines interleaved."""
    if dim % 4 != 0:
        raise ValueError("2D sin embedding needs dim % 4 == 0")
    half = dim // 2
    div = np.exp(np.arange(0.0, half, 2) * -(math.log(max_period) / half))
    pos_w = np.arange(width)[:, None] * div[None, :]
    pos_h = np.arange(height)[:, None] * div[None, :]
    emb = np.zeros((width, height, dim), np.float64)
    emb[:, :, 0:half:2] = np.sin(pos_w)[:, None, :]
    emb[:, :, 1:half:2] = np.cos(pos_w)[:, None, :]
    emb[:, :, half::2] = np.sin(pos_h)[None, :, :]
    emb[:, :, half + 1::2] = np.cos(pos_h)[None, :, :]
    return emb.astype(np.float32)


def _mha(p: Params, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         n_heads: int) -> torch.Tensor:
    """nn.MultiheadAttention(batch_first=True) with its packed in_proj on
    ``[B, T, C]``; softmax(QK^T / sqrt(d))V in plain f32 products."""
    d = q.shape[-1]
    w, b = p["in_proj_weight"], p["in_proj_bias"]

    def heads(x, i):
        y = F.linear(x, w[i * d: (i + 1) * d], b[i * d: (i + 1) * d])
        return y.unflatten(-1, (n_heads, d // n_heads)).transpose(1, 2)

    scores = torch.matmul(heads(q, 0), heads(k, 1).transpose(-1, -2)) / math.sqrt(d // n_heads)
    out = torch.matmul(torch.softmax(scores, dim=-1), heads(v, 2))
    return F.linear(out.transpose(1, 2).flatten(2), p["out_proj"]["weight"],
                    p["out_proj"]["bias"])


def _layer_norm(p: Params, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p["weight"], p["bias"], eps=1e-5)


def _group_norm_seq(p: Params, x: torch.Tensor) -> torch.Tensor:
    """demucs' MyGroupNorm(1, C) on ``[B, T, C]``."""
    return _group_norm1(p, x.transpose(1, 2)).transpose(1, 2)


def _feed_forward(p: Params, x: torch.Tensor) -> torch.Tensor:
    return F.linear(F.gelu(F.linear(x, p["linear1"]["weight"], p["linear1"]["bias"])),
                    p["linear2"]["weight"], p["linear2"]["bias"])


def _t_self_layer(p: Params, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """MyTransformerEncoderLayer: norm first, GELU, LayerScale, a
    GroupNorm on the output."""
    y = _layer_norm(p["norm1"], x)
    x = x + p["gamma_1"]["scale"] * _mha(p["self_attn"], y, y, y, n_heads)
    x = x + p["gamma_2"]["scale"] * _feed_forward(p, _layer_norm(p["norm2"], x))
    return _group_norm_seq(p["norm_out"], x)


def _t_cross_layer(p: Params, q: torch.Tensor, k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """CrossTransformerEncoderLayer: ``q`` attends to ``k``."""
    kn = _layer_norm(p["norm2"], k)
    x = q + p["gamma_1"]["scale"] * _mha(p["cross_attn"], _layer_norm(p["norm1"], q), kn, kn,
                                         n_heads)
    x = x + p["gamma_2"]["scale"] * _feed_forward(p, _layer_norm(p["norm3"], x))
    return _group_norm_seq(p["norm_out"], x)


def _cross_transformer(p: Params, x: torch.Tensor, xt: torch.Tensor,
                       dims: HTDemucsDims) -> Tuple[torch.Tensor, torch.Tensor]:
    """CrossTransformerEncoder on ``x [B, C, Fr, T1]`` (spectral) and ``xt
    [B, C, T2]`` (temporal): even layers attend within each domain, odd
    layers across them, both ways."""
    b, c, fr, t1 = x.shape
    pos2d = torch.from_numpy(_sin_embedding_2d(c, fr, t1, dims.max_period)).to(x.device)
    x = _layer_norm(p["norm_in"], x.permute(0, 3, 2, 1).reshape(b, t1 * fr, c))
    x = x + pos2d.reshape(t1 * fr, c)
    pos1d = torch.from_numpy(_sin_embedding_1d(xt.shape[-1], c, dims.max_period)).to(x.device)
    xt = _layer_norm(p["norm_in_t"], xt.transpose(1, 2)) + pos1d
    for idx in range(dims.t_layers):
        if idx % 2 == 0:
            x = _t_self_layer(p["layers"][idx], x, dims.t_heads)
            xt = _t_self_layer(p["layers_t"][idx], xt, dims.t_heads)
        else:
            x, xt = (_t_cross_layer(p["layers"][idx], x, xt, dims.t_heads),
                     _t_cross_layer(p["layers_t"][idx], xt, x, dims.t_heads))
    return x.reshape(b, t1, fr, c).permute(0, 3, 2, 1), xt.transpose(1, 2)


# -- the forward ----------------------------------------------------------------


def htdemucs_forward(params: Params, mix: torch.Tensor, dims: HTDemucsDims) -> torch.Tensor:
    """``[B, audio_channels, T]`` mix -> ``[B, n_sources, audio_channels, T]``
    (demucs' HTDemucs.forward): the spectrogram and the waveform each
    normalized, both encoders (the frequency embedding after the first
    frequency layer), the bottom channels around the transformer, the
    skip-connected decoders, the CaC mask's iSTFT plus the time branch."""
    length = mix.shape[-1]
    x = _magnitude_cac(_spec(mix, dims))
    b, _, fq, t = x.shape
    std, mean = torch.std_mean(x, dim=(1, 2, 3), correction=0, keepdim=True)
    x = (x - mean) / (1e-5 + std)
    stdt, meant = torch.std_mean(mix, dim=(1, 2), correction=0, keepdim=True)
    xt = (mix - meant) / (1e-5 + stdt)

    saved, saved_t, lengths_t = [], [], []
    for idx in range(dims.depth):
        lengths_t.append(xt.shape[-1])
        xt = _henc_time(params["tencoder"][idx], xt, dims)
        saved_t.append(xt)
        x = _henc_freq(params["encoder"][idx], x, dims)
        if idx == 0:
            emb = params["freq_emb"]["embedding"]["weight"] * dims.emb_scale  # [Fr, C]
            x = x + dims.freq_emb_scale * emb.t()[None, :, :, None]
        saved.append(x)

    if dims.bottom_channels:
        ff, tt = x.shape[-2:]
        x = _conv1d(params["channel_upsampler"], x.flatten(2)).unflatten(2, (ff, tt))
        xt = _conv1d(params["channel_upsampler_t"], xt)
    x, xt = _cross_transformer(params["crosstransformer"], x, xt, dims)
    if dims.bottom_channels:
        ff, tt = x.shape[-2:]
        x = _conv1d(params["channel_downsampler"], x.flatten(2)).unflatten(2, (ff, tt))
        xt = _conv1d(params["channel_downsampler_t"], xt)

    for idx in range(dims.depth):
        last = idx == dims.depth - 1
        x = _hdec_freq(params["decoder"][idx], x, saved.pop(), dims, last)
        xt = _hdec_time(params["tdecoder"][idx], xt, saved_t.pop(), lengths_t.pop(), dims, last)

    n_src = len(dims.sources)
    x = x.reshape(b, n_src, -1, fq, t) * std[:, None] + mean[:, None]
    spec_out = _ispec(_mask_cac(x), dims, length)
    xt = xt.reshape(b, n_src, dims.audio_channels, length) * stdt[:, None] + meant[:, None]
    return spec_out + xt


# -- parameters -----------------------------------------------------------------


def init_htdemucs_params(dims: HTDemucsDims, device, generator: torch.Generator) -> Params:
    """Seeded random f32 parameters on ``device`` from ``generator`` (which
    must live on that device), with the shapes of the released
    checkpoint's state dict and the JAX package's scales."""

    def tensor(*shape):
        fan_in = int(np.prod(shape[1:])) or 1
        return torch.randn(shape, device=device, generator=generator) / math.sqrt(fan_in)

    def zeros(n):
        return torch.zeros(n, device=device)

    def full(n, value):
        return torch.full((n,), value, device=device)

    def conv(o, i, *k):
        return {"weight": tensor(o, i, *k), "bias": zeros(o)}

    def conv_tr(i, o, *k):
        return {"weight": tensor(i, o, *k), "bias": zeros(o)}

    def norm(c):
        return {"weight": full(c, 1.0), "bias": zeros(c)}

    def dconv(c):
        hid = max(4, c // dims.dconv_comp)
        return {"layers": [{"conv1": conv(hid, c, 3), "norm1": norm(hid),
                            "conv2": conv(2 * c, hid, 1), "norm2": norm(2 * c),
                            "scale": full(c, 1e-3)} for _ in range(dims.dconv_depth)]}

    chans = dims.layer_channels()
    k = dims.kernel_size
    enc, tenc, dec, tdec = [], [], [], []
    for i, c in enumerate(chans):
        cin_z = dims.audio_channels * 2 if i == 0 else chans[i - 1]
        cin_t = dims.audio_channels if i == 0 else chans[i - 1]
        enc.append({"conv": conv(c, cin_z, k, 1), "rewrite": conv(2 * c, c, 1, 1),
                    "dconv": dconv(c)})
        tenc.append({"conv": conv(c, cin_t, k), "rewrite": conv(2 * c, c, 1), "dconv": dconv(c)})
    n_src = len(dims.sources)
    rev = chans[::-1]  # decoder.0 runs first, at the deepest width
    for i, c in enumerate(rev):
        last = i + 1 == len(rev)
        dec.append({"rewrite": conv(2 * c, c, 3, 3),
                    "conv_tr": conv_tr(c, n_src * dims.audio_channels * 2 if last else rev[i + 1],
                                       k, 1)})
        tdec.append({"rewrite": conv(2 * c, c, 3),
                     "conv_tr": conv_tr(c, n_src * dims.audio_channels if last else rev[i + 1], k)})

    dim_t = dims.bottom_channels or chans[-1]
    hidden = int(dims.t_hidden_scale * dim_t)

    def lin(o, i):
        return {"weight": tensor(o, i), "bias": zeros(o)}

    def t_layer(cross):
        return {"cross_attn" if cross else "self_attn": {
                    "in_proj_weight": tensor(3 * dim_t, dim_t),
                    "in_proj_bias": zeros(3 * dim_t), "out_proj": lin(dim_t, dim_t)},
                "linear1": lin(hidden, dim_t), "linear2": lin(dim_t, hidden),
                **{name: norm(dim_t) for name in
                   ("norm1", "norm2", "norm3", "norm_out") if cross or name != "norm3"},
                "gamma_1": {"scale": full(dim_t, 1e-4)}, "gamma_2": {"scale": full(dim_t, 1e-4)}}

    params = {
        "encoder": enc, "tencoder": tenc, "decoder": dec, "tdecoder": tdec,
        "freq_emb": {"embedding": {"weight": tensor(dims.freqs // dims.stride, chans[0])
                                   / dims.emb_scale}},
        "crosstransformer": {
            "norm_in": norm(dim_t), "norm_in_t": norm(dim_t),
            "layers": [t_layer(i % 2 == 1) for i in range(dims.t_layers)],
            "layers_t": [t_layer(i % 2 == 1) for i in range(dims.t_layers)]},
    }
    if dims.bottom_channels:
        params["channel_upsampler"] = conv(dims.bottom_channels, chans[-1], 1)
        params["channel_downsampler"] = conv(chans[-1], dims.bottom_channels, 1)
        params["channel_upsampler_t"] = conv(dims.bottom_channels, chans[-1], 1)
        params["channel_downsampler_t"] = conv(chans[-1], dims.bottom_channels, 1)
    return params


def infer_dims(flat_state: Mapping[str, Any]) -> HTDemucsDims:
    """The architecture from a state dict's shapes (dotted keys; any
    values with a ``shape``)."""
    required = ("encoder.0.conv.weight", "tencoder.0.conv.weight", "freq_emb.embedding.weight")
    missing = [k for k in required if k not in flat_state]
    if missing:
        raise ValueError(f"not an htdemucs state dict: missing {missing}")

    def count(prefix, level):
        return 1 + max(int(k.split(".")[level]) for k in flat_state if k.startswith(prefix))

    depth = count("encoder.", 1)
    channels = flat_state["encoder.0.conv.weight"].shape[0]
    growth = flat_state["encoder.1.conv.weight"].shape[0] // channels if depth > 1 else 2
    audio_channels = flat_state["tencoder.0.conv.weight"].shape[1]
    stride = 4
    n_sources = flat_state[f"tdecoder.{depth - 1}.conv_tr.weight"].shape[1] // audio_channels
    bottom = (flat_state["channel_upsampler.weight"].shape[0]
              if "channel_upsampler.weight" in flat_state else 0)
    dim_t = bottom or channels * growth ** (depth - 1)
    # the released four-source models' order
    names = ("drums", "bass", "other", "vocals")
    return HTDemucsDims(
        sources=names if n_sources == 4 else tuple(f"source_{i}" for i in range(n_sources)),
        audio_channels=audio_channels, channels=channels, growth=growth, depth=depth,
        nfft=flat_state["freq_emb.embedding.weight"].shape[0] * stride * 2,
        kernel_size=flat_state["encoder.0.conv.weight"].shape[2], bottom_channels=bottom,
        t_layers=count("crosstransformer.layers.", 2),
        t_hidden_scale=flat_state["crosstransformer.layers.0.linear1.weight"].shape[0] / dim_t,
        dconv_depth=count("encoder.0.dconv.layers.", 4),
    )


def load_htdemucs(directory: Optional[str] = None, device="cuda") -> Tuple[Params, HTDemucsDims]:
    """``htdemucs.npz`` (and its ``htdemucs.cfg.json`` sidecar, which may
    name ``sources``, ``segment`` and ``samplerate``) from ``directory``
    (the model cache by default) -> (params on ``device``, dims). Raises
    ``FileNotFoundError`` where no checkpoint is installed."""
    directory = directory or model_cache_dir()
    ckpt = os.path.join(directory, "htdemucs.npz")
    if not os.path.exists(ckpt):
        raise FileNotFoundError(f"no separator checkpoint at {ckpt}; skipping source separation")
    params = load_params(ckpt, "cpu")
    dims = infer_dims({k.replace("/", "."): v for k, v in flatten_tree(params).items()})
    sidecar = os.path.join(directory, "htdemucs.cfg.json")
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            cfg = json.load(f)
        dims = dataclasses.replace(dims, **{k: (tuple(v) if k == "sources" else v)
                                            for k, v in cfg.items()
                                            if k in {"sources", "segment", "samplerate"}})
    return to_device(params, device), dims


# -- long audio -----------------------------------------------------------------


def _triangle(seg: int) -> np.ndarray:
    tri = np.concatenate([np.arange(1, seg // 2 + 1), np.arange(seg - seg // 2, 0, -1)])
    tri = tri.astype(np.float32)
    return tri / tri.max()


def apply_segments(params: Params, wave, dims: HTDemucsDims, overlap: float = 0.25,
                   batch_size: int = 8, source_indices: Optional[Sequence[int]] = None,
                   device_out: bool = False):
    """``[C, T]`` mix (numpy or a tensor) -> ``[S', C, T]`` on the params'
    device: fixed ``segment``-long windows at a stride of ``1 - overlap``
    segments, the last zero-padded, ``batch_size`` windows a forward, each
    window's output weighted by a triangle and overlap-added, the sum
    divided by the summed weights. ``source_indices`` keeps only those
    sources. Returns numpy, or the tensor with ``device_out``."""
    device = params["freq_emb"]["embedding"]["weight"].device
    seg = int(dims.segment * dims.samplerate)
    stride = int((1 - overlap) * seg)
    wave = torch.as_tensor(wave, dtype=torch.float32).to(device)
    n_ch, length = wave.shape
    starts = []
    for start in range(0, length, stride):
        starts.append(start)
        if start + seg >= length:
            break
    src = list(range(len(dims.sources)) if source_indices is None else source_indices)
    tri = torch.from_numpy(_triangle(seg)).to(device)
    pad_len = starts[-1] + seg
    windows = F.pad(wave, (0, pad_len - length)).unfold(-1, seg, stride)  # [C, n, seg]
    out = torch.zeros((len(src), n_ch, pad_len), device=device)
    weight = torch.zeros(pad_len, device=device)
    for b0 in range(0, len(starts), batch_size):
        chunk = windows[:, b0: b0 + batch_size].transpose(0, 1)  # [b, C, seg]
        y = htdemucs_forward(params, chunk, dims)[:, src] * tri
        for i, start in enumerate(starts[b0: b0 + batch_size]):
            out[..., start: start + seg] += y[i]
            weight[start: start + seg] += tri
    result = out[..., :length] / weight[:length].clamp(min=1e-8)
    return result if device_out else result.cpu().numpy()


def separate_vocals(audio_path: str, out_dir: str, device="cuda") -> str:
    """The CLI's separation (reference diarize.py:98-114) on ``device``:
    writes ``<out_dir>/htdemucs/<track>/vocals.wav`` and returns its path.
    Raises ``FileNotFoundError`` where no ``htdemucs.npz`` is installed.
    Mono input goes to every channel, as demucs does, at the model's
    sample rate; f32 with TF32 off."""
    from ..audio import decode_audio, write_wav

    params, dims = load_htdemucs(device=device)
    wave = decode_audio(audio_path, sampling_rate=dims.samplerate)
    stereo = np.stack([wave] * dims.audio_channels)
    with full_f32(), torch.inference_mode():
        sources = apply_segments(params, stereo, dims,
                                 source_indices=(dims.sources.index("vocals"),))
    track = os.path.splitext(os.path.basename(audio_path))[0]
    target_dir = os.path.join(out_dir, "htdemucs", track)
    os.makedirs(target_dir, exist_ok=True)
    target = os.path.join(target_dir, "vocals.wav")
    write_wav(target, sources[0].mean(axis=0), sample_rate=dims.samplerate)
    return target

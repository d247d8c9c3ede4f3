"""The port's checkpoint converters against the JAX package's tools.

Each case writes one seeded source in a published layout at tiny dims
(one or two layers, narrow widths, 128 mels for Whisper, vocabularies that
are not multiples of 8): an HF directory (``config.json`` and
``model.safetensors`` or ``pytorch_model.bin``), an OpenAI whisper ``.pt``,
a ``.nemo`` tar, a lightning ``pytorch_model.bin``, a demucs ``.th``. The
JAX tools (``tools/convert_*.py``, called in this process) and
``python -m whisper_nemo_tpu_torch.cli.convert`` (its ``main``) convert it
into two directories, which must hold the same files: every ``.npz`` array
for array, bit for bit, in the same dtype; every ``.json`` equal as JSON;
every other asset byte for byte. Sources whose classes the JAX tools cannot
import (a demucs ``klass``, a lightning wrapper's own objects) are read by
the port alone and held against the same file without them.
"""

import fractions
import io
import json
import os
import pickle
import subprocess
import sys
import tarfile
import types

import numpy as np
import pytest
import torch

from chip_smoke import voices
from test_torch_slice import REPO, _one_torch_thread, built_decoder  # noqa: F401  (autouse; fixtures)
from whisper_nemo_tpu import config as jax_config
from whisper_nemo_tpu.audio import write_wav
from whisper_nemo_tpu.diarize import pipeline as jax_pipeline
from whisper_nemo_tpu_torch import config
from whisper_nemo_tpu_torch.cli import convert
from whisper_nemo_tpu_torch.diarize import NeuralDiarizer
from whisper_nemo_tpu_torch.engine import demucs_weights, nemo_weights, readers
from whisper_nemo_tpu_torch.models.conv_asr import JasperBlockCfg
from whisper_nemo_tpu_torch.models.htdemucs import HTDemucsDims, init_htdemucs_params

sys.path.insert(0, str(REPO / "tools"))
import convert_checkpoint as jax_checkpoint_tool  # noqa: E402
import convert_demucs as jax_demucs_tool  # noqa: E402
import convert_nemo as jax_nemo_tool  # noqa: E402
import convert_pyannote as jax_pyannote_tool  # noqa: E402

N_MELS = 128
VOCAB = 101  # not a multiple of 8
D = 16
SCALES = dict(window_length_in_sec=(1.5, 1.0, 0.5), shift_length_in_sec=(0.75, 0.5, 0.25),
              multiscale_weights=(1, 1, 1))
VAD_CFGS = [JasperBlockCfg(filters=12, kernel=5, separable=True),
            JasperBlockCfg(filters=12, repeat=2, kernel=7, separable=True, residual=True),
            JasperBlockCfg(filters=16, kernel=1)]
SPK_CFGS = [JasperBlockCfg(filters=20, kernel=3, separable=True),
            JasperBlockCfg(filters=20, repeat=2, kernel=5, dilation=2, separable=True,
                           residual=True, se=True, se_reduction=4),
            JasperBlockCfg(filters=24, kernel=1)]
FEATURES, ATTN, EMB = 16, 8, 10  # the NeMo models' mels, TitaNet's attention and embedding
MSDD_HIDDEN, MSDD_PROJ = 12, 6
DEMUCS = HTDemucsDims(channels=4, depth=2, nfft=64, bottom_channels=8, t_layers=2)


class Seeded:
    """Seeded float32 arrays: weights normal over the square root of their
    fan-in, scales 1 ± 0.25, shifts ±0.1."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def w(self, *shape):
        fan_in = int(np.prod(shape[1:])) or 1
        return (self.rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    def shift(self, n):
        return (0.1 * self.rng.standard_normal(n)).astype(np.float32)

    def scale(self, n):
        return self.rng.uniform(0.75, 1.25, n).astype(np.float32)


def _tensors(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


# -- sources ----------------------------------------------------------------------


def _hf_whisper(s: Seeded) -> dict:
    """An HF WhisperModel's state dict (no ``model.`` prefix), 1 encoder and
    2 decoder layers, its values f16-exact (OpenAI's .pt is f16)."""
    sd = {}

    def lin(p, o, i, bias=True):
        sd[f"{p}.weight"] = s.w(o, i)
        if bias:
            sd[f"{p}.bias"] = s.shift(o)

    def ln(p):
        sd[f"{p}.weight"], sd[f"{p}.bias"] = s.scale(D), s.shift(D)

    def attn(p):
        lin(f"{p}.q_proj", D, D)
        lin(f"{p}.k_proj", D, D, bias=False)
        lin(f"{p}.v_proj", D, D)
        lin(f"{p}.out_proj", D, D)

    def block(p, cross):
        attn(f"{p}.self_attn")
        ln(f"{p}.self_attn_layer_norm")
        if cross:
            attn(f"{p}.encoder_attn")
            ln(f"{p}.encoder_attn_layer_norm")
        lin(f"{p}.fc1", 2 * D, D)
        lin(f"{p}.fc2", D, 2 * D)
        ln(f"{p}.final_layer_norm")

    sd["encoder.conv1.weight"], sd["encoder.conv1.bias"] = s.w(D, N_MELS, 3), s.shift(D)
    sd["encoder.conv2.weight"], sd["encoder.conv2.bias"] = s.w(D, D, 3), s.shift(D)
    sd["encoder.embed_positions.weight"] = s.w(10, D)
    block("encoder.layers.0", cross=False)
    ln("encoder.layer_norm")
    sd["decoder.embed_tokens.weight"] = s.w(VOCAB, D)
    sd["decoder.embed_positions.weight"] = s.w(8, D)
    for i in range(2):
        block(f"decoder.layers.{i}", cross=True)
    ln("decoder.layer_norm")
    return {k: v.astype(np.float16).astype(np.float32) for k, v in sd.items()}


def _whisper_config() -> dict:
    return {"model_type": "whisper", "num_mel_bins": N_MELS, "max_source_positions": 10,
            "d_model": D, "encoder_attention_heads": 2, "encoder_layers": 1,
            "vocab_size": VOCAB, "max_target_positions": 8, "decoder_attention_heads": 2,
            "decoder_layers": 2, "encoder_ffn_dim": 2 * D, "decoder_ffn_dim": 2 * D}


def _openai_names(sd: dict) -> dict:
    """HF names -> OpenAI whisper's, the same tensors."""
    out = {}
    for k, v in sd.items():
        for a, b in (("layers.", "blocks."), ("self_attn_layer_norm", "attn_ln"),
                     ("encoder_attn_layer_norm", "cross_attn_ln"), ("self_attn.", "attn."),
                     ("encoder_attn.", "cross_attn."), ("q_proj", "query"), ("k_proj", "key"),
                     ("v_proj", "value"), ("out_proj", "out"), ("final_layer_norm", "mlp_ln"),
                     ("fc1", "mlp.0"), ("fc2", "mlp.2"),
                     ("encoder.embed_positions.weight", "encoder.positional_embedding"),
                     ("decoder.embed_positions.weight", "decoder.positional_embedding"),
                     ("decoder.embed_tokens.weight", "decoder.token_embedding.weight"),
                     ("encoder.layer_norm", "encoder.ln_post"), ("decoder.layer_norm", "decoder.ln")):
            k = k.replace(a, b)
        out[k] = v
    return out


def _write_hf(directory, config_dict, sd, assets=(), bin_format=False) -> str:
    from safetensors.numpy import save_file

    os.makedirs(directory)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(config_dict, f)
    if bin_format:
        torch.save(_tensors(sd), os.path.join(directory, "pytorch_model.bin"))
    else:
        save_file(sd, os.path.join(directory, "model.safetensors"))
    for name in assets:
        with open(os.path.join(directory, name), "w") as f:
            json.dump({"asset": name, "tokens": list(range(7))}, f)
    return str(directory)


def src_whisper(tmp, s):
    sd = {"model." + k: v for k, v in _hf_whisper(s).items()}
    sd["proj_out.weight"] = sd["model.decoder.embed_tokens.weight"].copy()
    return _write_hf(tmp / "hf_whisper", _whisper_config(), sd,
                     ("vocab.json", "merges.txt", "tokenizer.json"))


def _whisper_pt_dims() -> dict:
    c = _whisper_config()
    return {"n_mels": N_MELS, "n_audio_ctx": 10, "n_audio_state": D, "n_audio_head": 2,
            "n_audio_layer": 1, "n_vocab": VOCAB, "n_text_ctx": 8, "n_text_state": D,
            "n_text_head": c["decoder_attention_heads"], "n_text_layer": 2}


def src_whisper_pt(tmp, s):
    path = str(tmp / "tiny.pt")
    sd = {k: torch.from_numpy(v).half() for k, v in _openai_names(_hf_whisper(s)).items()}
    torch.save({"dims": _whisper_pt_dims(), "model_state_dict": sd}, path)
    return path


def _wav2vec2(s: Seeded, spelling: str) -> dict:
    """Wav2Vec2ForCTC at 2 layers, width 16, 31 tokens, the MMS layout
    (stable layer norm, a layer norm per conv layer, conv biases)."""
    sd, pre = {}, "wav2vec2."
    conv_dim, kernels = (8, 8), (10, 3)
    c_in = 1
    for i, (c, k) in enumerate(zip(conv_dim, kernels)):
        p = f"{pre}feature_extractor.conv_layers.{i}"
        sd[f"{p}.conv.weight"], sd[f"{p}.conv.bias"] = s.w(c, c_in, k), s.shift(c)
        sd[f"{p}.layer_norm.weight"], sd[f"{p}.layer_norm.bias"] = s.scale(c), s.shift(c)
        c_in = c

    def lin(p, o, i):
        sd[f"{p}.weight"], sd[f"{p}.bias"] = s.w(o, i), s.shift(o)

    def ln(p, n=D):
        sd[f"{p}.weight"], sd[f"{p}.bias"] = s.scale(n), s.shift(n)

    ln(f"{pre}feature_projection.layer_norm", conv_dim[-1])
    lin(f"{pre}feature_projection.projection", D, conv_dim[-1])
    base = f"{pre}encoder.pos_conv_embed.conv"
    g, v = s.scale(4).reshape(1, 1, 4), s.w(D, D // 2, 4)
    if spelling == "weight_g":
        sd[f"{base}.weight_g"], sd[f"{base}.weight_v"] = g, v
    else:
        sd[f"{base}.parametrizations.weight.original0"] = g
        sd[f"{base}.parametrizations.weight.original1"] = v
    sd[f"{base}.bias"] = s.shift(D)
    ln(f"{pre}encoder.layer_norm")
    for i in range(2):
        lp = f"{pre}encoder.layers.{i}"
        for n in ("q", "k", "v", "out"):
            lin(f"{lp}.attention.{n}_proj", D, D)
        ln(f"{lp}.layer_norm")
        lin(f"{lp}.feed_forward.intermediate_dense", 2 * D, D)
        lin(f"{lp}.feed_forward.output_dense", D, 2 * D)
        ln(f"{lp}.final_layer_norm")
    sd[f"{pre}masked_spec_embed"] = s.shift(D)  # in HF's files, unused at inference
    lin("lm_head", 31, D)
    return sd


def _wav2vec2_config() -> dict:
    return {"model_type": "wav2vec2", "vocab_size": 31, "hidden_size": D,
            "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 2 * D,
            "conv_dim": [8, 8], "conv_kernel": [10, 3], "conv_stride": [5, 2],
            "num_conv_pos_embeddings": 4, "num_conv_pos_embedding_groups": 2,
            "do_stable_layer_norm": True, "feat_extract_norm": "layer", "conv_bias": True}


def src_aligner(tmp, s, spelling="weight_g"):
    return _write_hf(tmp / f"hf_aligner_{spelling}", _wav2vec2_config(), _wav2vec2(s, spelling),
                     ("vocab.json",))


def src_punctuation(tmp, s):
    """XLMRobertaForTokenClassification, 1 layer, width 16, in
    pytorch_model.bin."""
    sd, pre = {}, "roberta."

    def lin(p, o, i):
        sd[f"{p}.weight"], sd[f"{p}.bias"] = s.w(o, i), s.shift(o)

    def ln(p):
        sd[f"{p}.weight"], sd[f"{p}.bias"] = s.scale(D), s.shift(D)

    sd[f"{pre}embeddings.word_embeddings.weight"] = s.w(VOCAB, D)
    sd[f"{pre}embeddings.position_embeddings.weight"] = s.w(20, D)
    sd[f"{pre}embeddings.token_type_embeddings.weight"] = s.w(1, D)
    ln(f"{pre}embeddings.LayerNorm")
    lp = f"{pre}encoder.layer.0"
    for n in ("query", "key", "value"):
        lin(f"{lp}.attention.self.{n}", D, D)
    lin(f"{lp}.attention.output.dense", D, D)
    ln(f"{lp}.attention.output.LayerNorm")
    lin(f"{lp}.intermediate.dense", 2 * D, D)
    lin(f"{lp}.output.dense", D, 2 * D)
    ln(f"{lp}.output.LayerNorm")
    lin("classifier", 6, D)
    cfg = {"model_type": "xlm-roberta", "vocab_size": VOCAB, "hidden_size": D,
           "num_hidden_layers": 1, "num_attention_heads": 2, "intermediate_size": 2 * D,
           "max_position_embeddings": 20, "id2label": {str(i): str(i) for i in range(6)}}
    return _write_hf(tmp / "hf_punctuation", cfg, sd, ("tokenizer.json",), bin_format=True)


def _bn(sd, s, p, c):
    sd[f"{p}.weight"], sd[f"{p}.bias"] = s.scale(c), s.shift(c)
    sd[f"{p}.running_mean"], sd[f"{p}.running_var"] = s.shift(c), s.scale(c)
    sd[f"{p}.num_batches_tracked"] = np.array(7, np.int64)


def _jasper(s: Seeded, cfgs, n_in: int, conv_bias: bool) -> dict:
    """NeMo ConvASREncoder keys: convs under ``mconv.<i>.conv``, bare batch
    norms, activations and dropout holding no tensor, squeeze-excite
    ``fc`` at the tail, the residual under ``res.0``."""
    sd = {}
    for bi, cfg in enumerate(cfgs):
        base, i, c_in = f"encoder.encoder.{bi}.mconv", 0, n_in
        for r in range(cfg.repeat):
            if cfg.separable:
                sd[f"{base}.{i}.conv.weight"] = s.w(c_in, 1, cfg.kernel)
                i += 1
            sd[f"{base}.{i}.conv.weight"] = s.w(cfg.filters, c_in, 1 if cfg.separable else cfg.kernel)
            if conv_bias:
                sd[f"{base}.{i}.conv.bias"] = s.shift(cfg.filters)
            _bn(sd, s, f"{base}.{i + 1}", cfg.filters)
            i += 2 if r == cfg.repeat - 1 else 4
            c_in = cfg.filters
        if cfg.se:
            sd[f"{base}.{i}.fc.0.weight"] = s.w(cfg.filters // cfg.se_reduction, cfg.filters)
            sd[f"{base}.{i}.fc.2.weight"] = s.w(cfg.filters, cfg.filters // cfg.se_reduction)
        if cfg.residual:
            sd[f"encoder.encoder.{bi}.res.0.0.conv.weight"] = s.w(cfg.filters, n_in, 1)
            _bn(sd, s, f"encoder.encoder.{bi}.res.0.1", cfg.filters)
        n_in = cfg.filters
    return sd


def _jasper_yaml(cfgs) -> dict:
    return {"jasper": [{"filters": c.filters, "repeat": c.repeat, "kernel": [c.kernel],
                        "dilation": [c.dilation], "separable": c.separable,
                        "residual": c.residual, "se": c.se, "se_reduction_ratio": c.se_reduction}
                       for c in cfgs]}


def _write_nemo(path, config_dict, sd, as_json=False) -> str:
    """A .nemo tar (gzip): ``model_config.yaml`` and ``model_weights.ckpt``."""
    import yaml

    text = json.dumps(config_dict) if as_json else yaml.safe_dump(config_dict)
    with tarfile.open(path, "w:gz") as tar:
        for name, blob in (("./model_config.yaml", text.encode()), ("./model_weights.ckpt", None)):
            if blob is None:
                buf = io.BytesIO()
                torch.save(_tensors(sd), buf)
                blob = buf.getvalue()
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))
    return str(path)


def src_vad(tmp, s):
    sd = _jasper(s, VAD_CFGS, FEATURES, conv_bias=True)
    # the head leans to speech, so that the 0.8 onset keeps the voices
    sd["decoder.decoder_layers.0.weight"] = 0.05 * s.w(2, VAD_CFGS[-1].filters, 1)
    sd["decoder.decoder_layers.0.bias"] = np.array([0.0, 4.0], np.float32)
    cfg = {"preprocessor": {"features": FEATURES}, "encoder": _jasper_yaml(VAD_CFGS)}
    return _write_nemo(tmp / "vad_multilingual_marblenet.nemo", cfg, sd)


def src_titanet(tmp, s):
    c = SPK_CFGS[-1].filters
    sd = _jasper(s, SPK_CFGS, FEATURES, conv_bias=False)
    p = "decoder._pooling.attention_layer"
    sd[f"{p}.0.conv_layer.weight"], sd[f"{p}.0.conv_layer.bias"] = s.w(ATTN, 3 * c, 1), s.shift(ATTN)
    _bn(sd, s, f"{p}.0.bn", ATTN)
    sd[f"{p}.2.weight"], sd[f"{p}.2.bias"] = s.w(c, ATTN, 1), s.shift(c)
    _bn(sd, s, "decoder.emb_layers.0.0", 2 * c)
    sd["decoder.emb_layers.0.1.weight"], sd["decoder.emb_layers.0.1.bias"] = s.w(EMB, 2 * c, 1), s.shift(EMB)
    cfg = {"preprocessor": {"features": FEATURES}, "encoder": _jasper_yaml(SPK_CFGS),
           "decoder": {"attention_channels": ATTN, "emb_sizes": EMB}}
    return _write_nemo(tmp / "titanet_large.nemo", cfg, sd)


def src_msdd(tmp, s):
    """A bidirectional LSTM on a projection of the 3 scales' 8 features, a
    2-speaker head, and tensors the converter leaves unmapped."""
    sd, h, n_feat = {}, MSDD_HIDDEN, 2 * len(SCALES["window_length_in_sec"]) + 2
    for sfx in ("", "_reverse"):
        sd[f"msdd.lstm.weight_ih_l0{sfx}"] = s.w(4 * h, MSDD_PROJ)
        sd[f"msdd.lstm.weight_hh_l0{sfx}"] = s.w(4 * h, h)
        sd[f"msdd.lstm.bias_ih_l0{sfx}"], sd[f"msdd.lstm.bias_hh_l0{sfx}"] = s.shift(4 * h), s.shift(4 * h)
    sd["msdd.hidden_to_spks.weight"], sd["msdd.hidden_to_spks.bias"] = s.w(2, 2 * h), s.shift(2)
    sd["msdd.dist_to_emb.weight"], sd["msdd.dist_to_emb.bias"] = s.w(MSDD_PROJ, n_feat), s.shift(MSDD_PROJ)
    sd["msdd.conv_bn.0.weight"] = s.scale(4)
    sd["msdd._speaker_model.encoder.encoder.0.mconv.0.conv.weight"] = s.w(4, 1, 3)
    return _write_nemo(tmp / "diar_msdd_telephonic.nemo", {"msdd_module": {"num_lstm_layers": 1}}, sd)


def _pyannet(s: Seeded) -> dict:
    """PyanNet (pyannote 3.x keys): 8 sinc filters, 2 BiLSTM layers of 4,
    7 powerset classes."""
    sd = {"sincnet.wav_norm1d.weight": s.scale(1), "sincnet.wav_norm1d.bias": s.shift(1),
          "sincnet.conv1d.0.filterbank.low_hz_": s.rng.uniform(0, 2000, (8, 1)).astype(np.float32),
          "sincnet.conv1d.0.filterbank.band_hz_": s.rng.uniform(0, 1000, (8, 1)).astype(np.float32)}
    for i, (o, c_in) in ((1, (6, 8)), (2, (6, 6))):
        sd[f"sincnet.conv1d.{i}.weight"], sd[f"sincnet.conv1d.{i}.bias"] = s.w(o, c_in, 5), s.shift(o)
    for i, c in enumerate((8, 6, 6)):
        sd[f"sincnet.norm1d.{i}.weight"], sd[f"sincnet.norm1d.{i}.bias"] = s.scale(c), s.shift(c)
    for layer, n_in in ((0, 6), (1, 8)):
        for sfx in ("", "_reverse"):
            sd[f"lstm.weight_ih_l{layer}{sfx}"] = s.w(16, n_in)
            sd[f"lstm.weight_hh_l{layer}{sfx}"] = s.w(16, 4)
            sd[f"lstm.bias_ih_l{layer}{sfx}"], sd[f"lstm.bias_hh_l{layer}{sfx}"] = s.shift(16), s.shift(16)
    sd["linear.0.weight"], sd["linear.0.bias"] = s.w(4, 8), s.shift(4)
    sd["linear.1.weight"], sd["linear.1.bias"] = s.w(4, 4), s.shift(4)
    sd["classifier.weight"], sd["classifier.bias"] = s.w(7, 4), s.shift(7)
    return sd


def src_pyannote(tmp, s, extra=None):
    """A lightning checkpoint: ``state_dict`` under ``model.``, beside
    entries of its own (``extra``: objects only the port reads)."""
    path = str(tmp / "pytorch_model.bin")
    blob = {"state_dict": {"model." + k: v for k, v in _tensors(_pyannet(s)).items()},
            "pyannote.audio": {"versions": {"torch": "2.0.0"}}, "epoch": 3, **(extra or {})}
    torch.save(blob, path)
    return path


class FakeHTDemucs:
    """Stands in for demucs' model class in a ``.th`` the JAX tool can read."""


def _demucs_state(s: Seeded) -> dict:
    """The htdemucs state dict at DEMUCS's dims, under torch's names."""
    inverse = {v: k for k, v in demucs_weights._DCONV_RENAME.items()}
    sd = {}
    for path, shape in demucs_weights._shapes(init_htdemucs_params(DEMUCS, "meta", None)).items():
        parts = path.split("/")
        if "dconv" in parts:
            i = parts.index("dconv") + 3
            parts = parts[:i] + (["6", "scale"] if parts[i] == "scale" else [inverse[parts[i]]] + parts[i + 1:])
        sd[".".join(parts)] = s.w(*shape) if len(shape) > 1 else s.shift(shape[0])
    return sd


def src_demucs(tmp, s, klass=FakeHTDemucs):
    path = str(tmp / f"htdemucs_{klass.__module__}.th")
    kwargs = {"sources": ["drums", "bass", "other", "vocals"], "segment": fractions.Fraction(39, 5)}
    torch.save({"klass": klass, "args": (), "kwargs": kwargs, "state": _tensors(_demucs_state(s))},
               path)
    return path


SOURCES = {
    "whisper": (src_whisper, ["--name", "tiny"]),
    "whisper-pt": (src_whisper_pt, ["--name", "tiny"]),
    "aligner": (src_aligner, []),
    "aligner-parametrizations": (lambda t, s: src_aligner(t, s, "parametrizations"), []),
    "punctuation": (src_punctuation, []),
    "vad": (src_vad, []),
    "titanet": (src_titanet, []),
    "msdd": (src_msdd, []),
    "pyannote": (src_pyannote, []),
    "demucs": (src_demucs, []),
}


def run_jax_tool(kind: str, source: str, out: str, monkeypatch) -> None:
    """The JAX package's tool for ``kind``, in this process. The demucs
    tool's expected tree (its shapes only) comes from ``jax.eval_shape``
    of the JAX init, as zeros: run op by op, the init takes 20 s here."""
    os.makedirs(out, exist_ok=True)
    if kind == "demucs":
        import jax

        import whisper_nemo_tpu.models.htdemucs as jax_htdemucs

        init = jax_htdemucs.init_htdemucs_params
        monkeypatch.setattr(jax_htdemucs, "init_htdemucs_params", lambda key, dims: jax.tree.map(
            lambda x: np.zeros(x.shape, x.dtype), jax.eval_shape(lambda k: init(k, dims), key)))
    if kind == "whisper":
        jax_checkpoint_tool.convert_whisper(source, "tiny", out)
    elif kind == "whisper-pt":
        jax_checkpoint_tool.convert_whisper_pt(source, "tiny", out)
    elif kind.startswith("aligner"):
        jax_checkpoint_tool.convert_aligner(source, out)
    elif kind == "punctuation":
        jax_checkpoint_tool.convert_punctuation(source, out)
    else:
        tool, argv = {"vad": (jax_nemo_tool, ["vad"]), "titanet": (jax_nemo_tool, ["titanet"]),
                      "msdd": (jax_nemo_tool, ["msdd"]), "pyannote": (jax_pyannote_tool, []),
                      "demucs": (jax_demucs_tool, [])}[kind]
        monkeypatch.setattr(sys, "argv", ["tool", *argv, source, "--out-dir", out])
        tool.main()


def run_port(kind: str, source: str, out: str, extra=()) -> None:
    convert.main([kind.split("-parametrizations")[0], source, "--out-dir", out, *extra])


def assert_same_files(port_dir, jax_dir) -> None:
    """The same file names; each .npz the same arrays bit for bit, each
    .json the same JSON, any other file the same bytes."""
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names and names
    for name in names:
        a, b = os.path.join(port_dir, name), os.path.join(jax_dir, name)
        if name.endswith(".npz"):
            with np.load(a) as got, np.load(b) as want:
                assert sorted(got.files) == sorted(want.files)
                for k in want.files:
                    x, y = got[k], want[k]
                    assert (x.dtype, x.shape) == (y.dtype, y.shape) == (np.float32, y.shape), k
                    assert x.tobytes() == y.tobytes(), f"{name}: {k} differs"
        elif name.endswith(".json"):
            with open(a) as f, open(b) as g:
                assert json.load(f) == json.load(g), name
        else:
            with open(a, "rb") as f, open(b, "rb") as g:
                assert f.read() == g.read(), name


# -- the cases --------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(SOURCES))
def test_port_file_equals_jax_tool_file(kind, tmp_path, monkeypatch):
    """Every kind of the four JAX tools: the same files, arrays bit-equal."""
    build, extra = SOURCES[kind]
    source = build(tmp_path, Seeded(sorted(SOURCES).index(kind)))
    run_jax_tool(kind, source, str(tmp_path / "jax"), monkeypatch)
    run_port(kind, source, str(tmp_path / "port"), extra)
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_hf_and_openai_layouts_give_one_file(tmp_path):
    """The same weights in HF's layout (f32) and OpenAI's .pt (f16) make
    one .npz."""
    run_port("whisper", src_whisper(tmp_path, Seeded(5)), str(tmp_path / "hf"), ["--name", "tiny"])
    run_port("whisper-pt", src_whisper_pt(tmp_path, Seeded(5)), str(tmp_path / "pt"),
             ["--name", "tiny"])
    for asset in ("vocab.json", "merges.txt", "tokenizer.json"):
        os.remove(tmp_path / "hf" / asset)
    assert_same_files(str(tmp_path / "pt"), str(tmp_path / "hf"))


@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16", "I64"])
def test_safetensors_reader_matches_the_package(dtype, tmp_path):
    """The port's reader against safetensors' own on each dtype (BF16,
    which safetensors.numpy cannot read, against safetensors.torch's,
    widened to float32)."""
    import safetensors.numpy
    import safetensors.torch

    g = torch.Generator().manual_seed(3)
    values = {"a.weight": torch.randn(5, 3, generator=g) * 100, "b": torch.randn(7, generator=g),
              "empty": torch.zeros(0, 4), "scalar": torch.tensor(2.5)}
    values = {k: (v.round().to(torch.int64) if dtype == "I64" else
                  v.to({"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}[dtype]))
              for k, v in values.items()}
    path = str(tmp_path / "x.safetensors")
    safetensors.torch.save_file(values, path, metadata={"format": "pt"})
    got = readers.read_safetensors(path)
    if dtype == "BF16":
        want = {k: v.float().numpy() for k, v in safetensors.torch.load_file(path).items()}
    else:
        want = safetensors.numpy.load_file(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.fixture()
def unimportable(monkeypatch):
    """A class of a module that no one can import once the file is
    written, ``demucs.htdemucs.HTDemucs``: pickle imports a global's module
    while saving, so the module stands in sys.modules until
    :func:`forget` puts None there (``import demucs`` then raises)."""
    pkg, mod = types.ModuleType("demucs"), types.ModuleType("demucs.htdemucs")
    cls = type("HTDemucs", (), {"__module__": "demucs.htdemucs"})
    mod.HTDemucs, pkg.htdemucs = cls, mod
    for name, module in (("demucs", pkg), ("demucs.htdemucs", mod)):
        monkeypatch.setitem(sys.modules, name, module)

    def forget():
        for name in ("demucs", "demucs.htdemucs"):
            monkeypatch.setitem(sys.modules, name, None)

    return cls, forget


@pytest.mark.parametrize("kind", ["demucs", "pyannote"])
def test_foreign_classes_stay_stubs(kind, tmp_path, monkeypatch, unimportable):
    """A .th whose ``klass`` is demucs', and a lightning checkpoint holding
    an object of that class: the port reads both without importing the
    class's module, into the files of the same checkpoint without it. The
    JAX tools cannot read them: demucs' ``klass`` needs the demucs package
    (``tools/convert_demucs.py`` unpickles with ``weights_only=False``),
    and ``weights_only=True`` refuses the lightning file's object."""

    cls, forget = unimportable
    if kind == "demucs":
        plain, foreign = src_demucs(tmp_path, Seeded(9)), src_demucs(tmp_path, Seeded(9), cls)
    else:
        plain = src_pyannote(tmp_path, Seeded(9))
        plain = str(os.replace(plain, tmp_path / "plain.bin") or tmp_path / "plain.bin")
        foreign = src_pyannote(tmp_path, Seeded(9), {"hyper_parameters": cls()})
    forget()
    run_port(kind, plain, str(tmp_path / "plain"))
    run_port(kind, foreign, str(tmp_path / "foreign"))
    assert_same_files(str(tmp_path / "foreign"), str(tmp_path / "plain"))
    blob = readers.load_pickled(foreign)
    stub = blob["klass"] if kind == "demucs" else type(blob["hyper_parameters"])
    assert issubclass(stub, readers.Stub) and stub.__module__ == "demucs.htdemucs"
    with pytest.raises(ModuleNotFoundError if kind == "demucs" else pickle.UnpicklingError):
        run_jax_tool(kind, foreign, str(tmp_path / "jax"), monkeypatch)


class _RawPickler:
    """A ``pickle_module.Pickler`` for ``torch.save`` that writes the bytes
    it is given as the archive's pickle."""

    def __init__(self, f, protocol=None):
        self.f = f

    def dump(self, raw):
        self.f.write(raw)


def _call_pickle(module: str, name: str, args: tuple) -> bytes:
    """A protocol-4 pickle that calls ``module``'s global ``name`` on
    ``args``."""
    def text(s):
        return b"\x8c" + bytes([len(s)]) + s.encode()

    return (b"\x80\x04" + text(module) + text(name) + b"\x93"
            + pickle.dumps(args, protocol=2)[2:-1] + b"R.")


@pytest.mark.parametrize("module,name", [("numpy", "memmap"),
                                         ("torch.utils.cpp_extension", "subprocess.Popen")])
def test_loader_refuses_other_globals_of_trusted_packages(module, name, tmp_path):
    """A checkpoint that calls ``numpy.memmap`` to truncate a file, or
    reaches ``subprocess.Popen`` through a dotted name under torch: the
    loader refuses both before either is called."""
    target, marker = tmp_path / "target.bin", tmp_path / "ran"
    target.write_bytes(b"kept")
    args = ((str(target), "u1", "w+", 0, (1,)) if name == "memmap"
            else ([sys.executable, "-c", f"open({str(marker)!r}, 'w')"],))
    path = str(tmp_path / "crafted.pt")
    torch.save(_call_pickle(module, name, args), path,
               pickle_module=types.SimpleNamespace(__name__="raw", Pickler=_RawPickler))
    with pytest.raises(pickle.UnpicklingError):
        readers.load_pickled(path)
    assert target.read_bytes() == b"kept" and not marker.exists()


def test_demucs_converter_rejects_mismatched_state():
    """A renamed tensor: the strict check lists it as missing and
    unconsumed."""
    sd = _demucs_state(Seeded(4))
    sd["decoder.1.rewrite.weigth"] = sd.pop("decoder.1.rewrite.weight")
    with pytest.raises(ValueError, match=r"missing \(1\).*\n.*unconsumed \(1\)"):
        demucs_weights.convert_state_dict(sd)


def test_nemo_without_pyyaml_raises_naming_it(tmp_path, monkeypatch):
    path = src_msdd(tmp_path, Seeded(2))
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        nemo_weights.extract_nemo(path)


def test_diarizer_on_converted_nemo_files_matches_jax(tmp_path, monkeypatch, built_decoder):
    """Converted MarbleNet, TitaNet and MSDD (with the conv models'
    .cfg.json sidecars) put both diarizers on the Jasper stacks of
    ``models/conv_asr.py``: 20 s of three voices from the manifest, the
    port's diarizer on the port's files and the JAX diarizer on the JAX
    tools': the same turns and RTTM bytes."""
    dirs = {}
    for who in ("jax", "port"):
        dirs[who] = str(tmp_path / who)
        for i, kind in enumerate(("vad", "titanet", "msdd")):
            source = SOURCES[kind][0](tmp_path, Seeded(20 + i))
            if who == "jax":
                run_jax_tool(kind, source, dirs[who], monkeypatch)
            else:
                run_port(kind, source, dirs[who])
    assert sorted(os.listdir(dirs["port"])) == sorted(
        ["vad_multilingual_marblenet.npz", "vad_multilingual_marblenet.cfg.json",
         "titanet_large.npz", "titanet_large.cfg.json", "diar_msdd_telephonic.npz"])
    audio = voices(20.0, 3)
    runs = {}
    for who, make, cfg_mod in (("jax", lambda c: jax_pipeline.NeuralDiarizer(c), jax_config),
                               ("port", lambda c: NeuralDiarizer(c, device="cpu"), config)):
        monkeypatch.setenv("WNT_MODEL_DIR", dirs[who])
        run = tmp_path / f"run_{who}"
        cfg = cfg_mod.create_config(str(run), "telephonic")
        cfg.diarizer.speaker_embeddings.parameters = cfg_mod.SpeakerEmbeddingParams(**SCALES)
        diarizer = make(cfg)
        # the sidecars picked up: the Jasper VAD, TitaNet at the sidecar's widths
        assert diarizer._vad_cfgs is not None and diarizer.msdd_params is not None
        assert (diarizer.spk_dims.n_mels, diarizer.spk_dims.emb_dim) == (FEATURES, EMB)
        write_wav(str(run / "mono_file.wav"), audio)
        turns = diarizer.diarize()
        with open(run / "pred_rttms" / "mono_file.rttm", "rb") as f:
            runs[who] = (turns, f.read())
    assert runs["port"] == runs["jax"]
    assert len({s for _, _, s in runs["port"][0]}) >= 2


def test_cli_runs_without_jax_and_the_reference_packages(tmp_path):
    """``python -m whisper_nemo_tpu_torch.cli.convert`` in a new process on
    an HF Whisper directory: it writes the file and imports none of jax,
    whisper_nemo_tpu, transformers, safetensors, demucs or yaml (by
    ``-X importtime``'s list of every module the child imported)."""
    source = src_whisper(tmp_path, Seeded(6))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "whisper_nemo_tpu_torch.cli.convert", "whisper",
         source, "--name", "tiny", "--out-dir", str(tmp_path / "out")],
        cwd=tmp_path, env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-2000:]
    imported = {line.split("|")[-1].strip() for line in proc.stderr.splitlines()
                if line.startswith("import time:")}
    assert {"torch", "whisper_nemo_tpu_torch.engine.weights"} <= imported
    banned = {m for m in imported
              if m.split(".")[0] in ("jax", "jaxlib", "whisper_nemo_tpu", "transformers",
                                     "safetensors", "demucs", "yaml")}
    assert banned == set()
    assert proc.stdout.strip() == f"wrote {tmp_path / 'out' / 'tiny.npz'}"
    run_port("whisper", source, str(tmp_path / "in_process"), ["--name", "tiny"])
    assert_same_files(str(tmp_path / "out"), str(tmp_path / "in_process"))

"""NeMo ``.nemo`` checkpoint -> conv_asr/msdd param-tree converters.

Counterpart of ``whisper_nemo_tpu/engine/nemo_weights.py``, array for
array (the same numpy arithmetic in the same order). A ``.nemo`` archive
(what NeMo's ``NeuralDiarizer`` downloads) is a tar file holding
``model_config.yaml`` plus ``model_weights.ckpt``, a torch state dict.
This module unpacks the archive, derives the Jasper block configuration
from the yaml, and maps the torch tensors into the folded-BN layout of
``models/conv_asr.py`` as the JAX package stores it:

* conv weights transpose [out, in/groups, k] -> WIO [k, in/groups, out];
* inference batch norm folds into a per-channel scale/shift
  (``g = γ/√(σ²+ε)``, ``b = β + g·(bias − μ)``), absorbing any conv
  bias that feeds the norm;
* torch LSTM gates (i, f, g, o packed rows) transpose into the
  ``models/msdd.py`` layout.

The yaml is read with PyYAML, imported at the call: without it
:func:`extract_nemo` raises naming it, and the ``convert_*`` functions
take the config as a dict.
"""

from __future__ import annotations

import io
import logging
import tarfile
from dataclasses import asdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..models.conv_asr import JasperBlockCfg

logger = logging.getLogger(__name__)

Params = Dict[str, Any]
_BN_EPS = 1e-5  # torch BatchNorm1d default (NeMo leaves it unset)


# -- archive ----------------------------------------------------------------
def extract_nemo(path: str) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Unpack a .nemo tar: (model_config dict, numpy state dict)."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            f"{path}: reading a .nemo archive's model_config.yaml needs PyYAML"
            " (pip install pyyaml); convert_marblenet, convert_titanet and"
            " convert_msdd take the config as a dict without it"
        ) from e

    config = None
    state = None
    # .nemo archives are plain or gzipped tars; "r:*" sniffs both
    with tarfile.open(path, "r:*") as tar:
        for member in tar.getmembers():
            name = member.name.lstrip("./")
            if name.endswith("model_config.yaml"):
                config = yaml.safe_load(tar.extractfile(member))
            elif name.endswith((".ckpt", ".pt")):
                import torch

                blob = tar.extractfile(member).read()
                state = torch.load(
                    io.BytesIO(blob), map_location="cpu", weights_only=True
                )
    if config is None or state is None:
        raise ValueError(
            f"{path}: expected model_config.yaml + model_weights.ckpt "
            "inside the .nemo tar"
        )
    if "state_dict" in state:  # lightning checkpoint wrapper
        state = state["state_dict"]
    return config, {k: _to_numpy(v) for k, v in state.items()}


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, np.ndarray):
        return v
    return v.detach().cpu().float().numpy()


# -- primitives (parity-tested) ---------------------------------------------
def conv_to_wio(w: np.ndarray) -> np.ndarray:
    """torch Conv1d weight [out, in/groups, k] → WIO [k, in/groups, out]."""
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))


def linear_to_jax(w: np.ndarray) -> np.ndarray:
    """torch Linear weight [out, in] → [in, out]."""
    return np.ascontiguousarray(w.T)


def fold_bn(
    gamma: np.ndarray,
    beta: np.ndarray,
    mean: np.ndarray,
    var: np.ndarray,
    eps: float = _BN_EPS,
    conv_bias: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Inference BN after a conv → (scale, shift) with the conv bias
    absorbed: BN(conv(x) + bias) == scale·conv(x) + shift."""
    scale = gamma / np.sqrt(var + eps)
    bias = conv_bias if conv_bias is not None else 0.0
    return scale, beta + scale * (bias - mean)


def lstm_to_jax(sd: Dict[str, np.ndarray], base: str,
                suffix: str = "") -> Params:
    """torch LSTM layer-0 tensors → msdd scan params {wx, wh, b}.

    torch packs gate rows in (i, f, g, o) order, the same order
    ``models/msdd.py`` splits its fused projection, so a plain
    transpose (and summing the two bias vectors) is exact.
    """
    return {
        "wx": linear_to_jax(sd[f"{base}weight_ih_l0{suffix}"]),
        "wh": linear_to_jax(sd[f"{base}weight_hh_l0{suffix}"]),
        "b": sd[f"{base}bias_ih_l0{suffix}"]
        + sd[f"{base}bias_hh_l0{suffix}"],
    }


# -- jasper encoder ----------------------------------------------------------
def jasper_cfgs_from_config(encoder_cfg: dict) -> List[JasperBlockCfg]:
    """``encoder.jasper`` yaml list → JasperBlockCfg list."""

    def first(v, default):
        if v is None:
            return default
        return v[0] if isinstance(v, (list, tuple)) else v

    out = []
    for b in encoder_cfg["jasper"]:
        out.append(
            JasperBlockCfg(
                filters=b["filters"],
                repeat=b.get("repeat", 1),
                kernel=first(b.get("kernel"), 1),
                dilation=first(b.get("dilation"), 1),
                separable=b.get("separable", False),
                residual=b.get("residual", False),
                se=b.get("se", False),
                se_reduction=b.get("se_reduction_ratio", 8),
            )
        )
    return out


def _mconv_indices(sd: Dict[str, np.ndarray], prefix: str) -> List[int]:
    idx = set()
    for k in sd:
        if k.startswith(prefix + "."):
            head = k[len(prefix) + 1 :].split(".")[0]
            if head.isdigit():
                idx.add(int(head))
    return sorted(idx)


def _conv_unit(w: np.ndarray, bn: Optional[dict],
               bias: Optional[np.ndarray]) -> Params:
    if bn is not None:
        g, b = fold_bn(bn["weight"], bn["bias"], bn["running_mean"],
                       bn["running_var"], conv_bias=bias)
    else:
        c = w.shape[0]
        g = np.ones((c,), np.float32)
        b = bias if bias is not None else np.zeros((c,), np.float32)
    return {"w": conv_to_wio(w), "g": g.astype(np.float32),
            "b": b.astype(np.float32)}


def convert_jasper_encoder(
    sd: Dict[str, np.ndarray],
    cfgs: Sequence[JasperBlockCfg],
    prefix: str = "encoder.encoder",
) -> Params:
    """NeMo ConvASREncoder state dict → conv_asr ``{"blocks": [...]}``.

    NeMo's JasperBlock stores its repeat units flat in ``mconv``
    (MaskedConv1d wraps the torch conv as ``.conv``; BatchNorm1d sits
    bare; activations/dropout hold no tensors), the squeeze-excite as a
    trailing ``fc`` module, and the residual projection under
    ``res.0``. Layers are recovered by walking the indices in order and
    closing a (conv[, conv], bn) group at each batch norm.
    """
    blocks = []
    for bi, cfg in enumerate(cfgs):
        base = f"{prefix}.{bi}.mconv"
        pending: List[Tuple[np.ndarray, Optional[np.ndarray]]] = []
        layers: List[Params] = []
        se: Optional[Params] = None
        for i in _mconv_indices(sd, base):
            conv_w = sd.get(f"{base}.{i}.conv.weight")
            if conv_w is not None:
                pending.append((conv_w, sd.get(f"{base}.{i}.conv.bias")))
                continue
            if f"{base}.{i}.running_mean" in sd:
                bn = {
                    "weight": sd[f"{base}.{i}.weight"],
                    "bias": sd[f"{base}.{i}.bias"],
                    "running_mean": sd[f"{base}.{i}.running_mean"],
                    "running_var": sd[f"{base}.{i}.running_var"],
                }
                if len(pending) == 2:  # separable: depthwise then pointwise
                    dw_w, dw_b = pending[0]
                    pw_w, pw_b = pending[1]
                    layers.append(
                        {"dw": _conv_unit(dw_w, None, dw_b),
                         "pw": _conv_unit(pw_w, bn, pw_b)}
                    )
                elif len(pending) == 1:
                    w, b = pending[0]
                    layers.append({"pw": _conv_unit(w, bn, b)})
                else:
                    raise ValueError(
                        f"block {bi}: batch norm at mconv.{i} closes "
                        f"{len(pending)} convs (expected 1 or 2)"
                    )
                pending = []
                continue
            if f"{base}.{i}.fc.0.weight" in sd:
                se = {
                    "w1": linear_to_jax(sd[f"{base}.{i}.fc.0.weight"]),
                    "w2": linear_to_jax(sd[f"{base}.{i}.fc.2.weight"]),
                }
                if f"{base}.{i}.fc.0.bias" in sd:
                    se["b1"] = sd[f"{base}.{i}.fc.0.bias"]
                    se["b2"] = sd[f"{base}.{i}.fc.2.bias"]
        if len(layers) != cfg.repeat:
            raise ValueError(
                f"block {bi}: found {len(layers)} conv layers, config "
                f"says repeat={cfg.repeat}"
            )
        block: Params = {"layers": layers}
        if se is not None:
            block["se"] = se
        res_w = sd.get(f"{prefix}.{bi}.res.0.0.conv.weight")
        if res_w is not None:
            bn = {
                "weight": sd[f"{prefix}.{bi}.res.0.1.weight"],
                "bias": sd[f"{prefix}.{bi}.res.0.1.bias"],
                "running_mean": sd[f"{prefix}.{bi}.res.0.1.running_mean"],
                "running_var": sd[f"{prefix}.{bi}.res.0.1.running_var"],
            }
            block["res"] = _conv_unit(
                res_w, bn, sd.get(f"{prefix}.{bi}.res.0.0.conv.bias")
            )
        blocks.append(block)
    return {"blocks": blocks}


# -- model converters ---------------------------------------------------------
def convert_marblenet(config: dict, sd: Dict[str, np.ndarray]):
    """vad_multilingual_marblenet .nemo → (cfgs, params, meta).

    The frame-VAD decoder is a single 1×1 conv
    (``decoder.decoder_layers.0``) over the encoder output.
    """
    cfgs = jasper_cfgs_from_config(config["encoder"])
    params = convert_jasper_encoder(sd, cfgs)
    head_w = None
    for key in ("decoder.decoder_layers.0.weight",
                "decoder.decoder_layers.1.weight"):
        if key in sd:
            head_w, head_key = sd[key], key
            break
    if head_w is None:
        raise ValueError("no decoder.decoder_layers.*.weight in state dict")
    if head_w.ndim == 3:  # Conv1d kernel-1 head
        head_w = head_w[:, :, 0]
    params["head"] = {
        "w": linear_to_jax(head_w),
        "b": sd.get(
            head_key.replace(".weight", ".bias"),
            np.zeros((head_w.shape[0],), np.float32),
        ),
    }
    meta = {
        "kind": "conv_asr_vad",
        "n_mels": config["preprocessor"]["features"],
        "blocks": [asdict(c) for c in cfgs],
    }
    return cfgs, params, meta


def convert_titanet(config: dict, sd: Dict[str, np.ndarray]):
    """titanet_large .nemo → (cfgs, params, meta).

    The SpeakerDecoder tensors are matched by shape (attention TDNN
    conv sees 3C channels of global context, the embedding layer 2C
    pooled stats) rather than by NeMo's exact attribute names, which
    differ across NeMo releases.
    """
    cfgs = jasper_cfgs_from_config(config["encoder"])
    params = convert_jasper_encoder(sd, cfgs)
    c = cfgs[-1].filters
    attn_ch = config.get("decoder", {}).get("attention_channels", 128)

    dec = {k: v for k, v in sd.items() if k.startswith("decoder.")}
    attn1_w = attn1_b = attn2_w = attn2_b = emb_w = emb_b = None
    attn_bn = emb_bn = None
    for k, v in dec.items():
        if not k.endswith(".weight"):
            continue
        bias = dec.get(k[: -len(".weight")] + ".bias")
        rm = dec.get(k[: -len(".weight")] + ".running_mean")
        if rm is not None:  # a batch norm
            bn = {
                "weight": v, "bias": bias, "running_mean": rm,
                "running_var": dec[k[: -len(".weight")] + ".running_var"],
            }
            if v.shape[0] == attn_ch:
                attn_bn = bn
            elif v.shape[0] == 2 * c:
                emb_bn = bn
            continue
        if v.ndim == 3:
            v2 = v[:, :, 0]
        elif v.ndim == 2:
            v2 = v
        else:
            continue
        if v2.shape == (attn_ch, 3 * c):
            attn1_w, attn1_b = v2, bias
        elif v2.shape == (c, attn_ch):
            attn2_w, attn2_b = v2, bias
        elif v2.shape[1] == 2 * c:
            emb_w, emb_b = v2, bias

    missing = [n for n, v in [
        ("attention conv (attn_ch×3C)", attn1_w),
        ("attention output conv (C×attn_ch)", attn2_w),
        ("attention batch norm", attn_bn),
        ("embedding batch norm (2C)", emb_bn),
        ("embedding linear (·×2C)", emb_w),
    ] if v is None]
    if missing:
        raise ValueError(
            "titanet decoder tensors not found: " + ", ".join(missing)
            + f" (decoder keys: {sorted(dec)})"
        )

    g, b = fold_bn(attn_bn["weight"], attn_bn["bias"],
                   attn_bn["running_mean"], attn_bn["running_var"])
    emb_g, emb_shift = fold_bn(emb_bn["weight"], emb_bn["bias"],
                               emb_bn["running_mean"], emb_bn["running_var"])
    pool: Params = {
        "attn1": {
            "w": linear_to_jax(attn1_w)[None],  # [1, 3C, attn] WIO
            "cb": attn1_b if attn1_b is not None
            else np.zeros((attn_ch,), np.float32),
            "g": g, "b": b,
        },
        "attn2": {
            "w": linear_to_jax(attn2_w),
            "b": attn2_b if attn2_b is not None
            else np.zeros((c,), np.float32),
        },
        "emb_bn": {"g": emb_g, "b": emb_shift},
        "emb": {"w": linear_to_jax(emb_w)},
    }
    if emb_b is not None:
        pool["emb"]["b"] = emb_b
    params["pool"] = pool
    meta = {
        "kind": "conv_asr_speaker",
        "n_mels": config["preprocessor"]["features"],
        "emb_dim": emb_w.shape[0],
        "blocks": [asdict(c2) for c2 in cfgs],
    }
    return cfgs, params, meta


def convert_msdd(config: dict, sd: Dict[str, np.ndarray]):
    """diar_msdd_telephonic .nemo → (params, meta, unmapped_keys).

    Best-effort: the LSTM core and the hidden→speaker projection map
    exactly (torch gate order matches the scan); any convolutional
    front-end tensors NeMo variants carry are reported as unmapped so
    the caller can see what a given release would still need.
    """
    lstm_base = None
    for k in sd:
        if k.endswith("lstm.weight_ih_l0"):
            lstm_base = k[: -len("weight_ih_l0")]
            break
    if lstm_base is None:
        raise ValueError("no lstm.weight_ih_l0 tensor in MSDD state dict")
    params: Params = {"lstm": lstm_to_jax(sd, lstm_base)}
    mapped = {f"{lstm_base}{t}_l0" for t in
              ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
    if f"{lstm_base}weight_ih_l0_reverse" in sd:
        params["lstm_rev"] = lstm_to_jax(sd, lstm_base, "_reverse")
        mapped |= {f"{lstm_base}{t}_l0_reverse" for t in
                   ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}

    hidden = params["lstm"]["wh"].shape[0]
    out_dim = 2 * hidden if "lstm_rev" in params else hidden
    in_dim = params["lstm"]["wx"].shape[0]
    for k, v in sd.items():
        if k in mapped or v.ndim != 2 or not k.endswith(".weight"):
            continue
        if "hidden_to_spks" in k or (v.shape[1] == out_dim
                                     and v.shape[0] <= 4):
            params["out"] = {
                "w": linear_to_jax(v),
                "b": sd.get(k[: -len(".weight")] + ".bias",
                            np.zeros((v.shape[0],), np.float32)),
            }
            mapped |= {k, k[: -len(".weight")] + ".bias"}
        elif v.shape[0] == in_dim and k.endswith(".weight"):
            params["in"] = {
                "w": linear_to_jax(v),
                "b": sd.get(k[: -len(".weight")] + ".bias",
                            np.zeros((in_dim,), np.float32)),
            }
            mapped |= {k, k[: -len(".weight")] + ".bias"}
    if "out" not in params:
        raise ValueError("no hidden→speaker projection found in MSDD ckpt")
    unmapped = sorted(
        k for k in sd
        if k not in mapped and not k.startswith("msdd._speaker_model")
        and "num_batches_tracked" not in k
    )
    if unmapped:
        logger.warning("MSDD converter left %d tensors unmapped: %s",
                       len(unmapped), unmapped[:8])
    meta = {"kind": "msdd", "hidden": hidden}
    return params, meta, unmapped

"""Model resolution and the JAX param-tree converter.

Counterpart of ``whisper_nemo_tpu/engine/checkpoint.py``. Checkpoints are
the JAX package's flat ``.npz`` files (path-joined keys); both packages
read the same files. :func:`params_from_jax` turns the JAX nested tree
into the port's: the same dict, tensors instead of arrays, conv weights
from ``[k, in/groups, out]`` to PyTorch's ``[out, in/groups, k]``. Each
family has its rule: Whisper's two convs and the wav2vec2 aligner's by
name; in the diarization convnets (MarbleNet, TitaNet, ECAPA-TDNN, the
Jasper stacks of ``models/conv_asr.py`` and PyanNet) every 3-D array, as
they hold no other; MSDD's weights are matrices and keep their layout;
htdemucs' tree is in PyTorch's layouts already and keeps them.
:func:`save_params` writes a port tree back as such a file, :func:`save_tree` a
converter's tree of numpy arrays.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models.wav2vec2 import Wav2Vec2Dims, init_wav2vec2_params
from ..models.whisper import WHISPER_DIMS, WhisperDims, init_whisper_params

logger = logging.getLogger(__name__)

_SEP = "/"
_CONV_KEYS = ("conv1", "conv2")


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Any:
    """Path-joined flat keys -> nested dicts, with all-digit key levels
    as lists (the layout of the JAX package's ``flatten_tree``)."""
    root: Dict[str, Any] = {}
    for path, value in flat.items():
        keys = path.split(_SEP)
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(re.fullmatch(r"\d+", k) for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _to_tensors(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_tensors(v, device) for v in tree]
    arr = np.asarray(tree)
    if str(arr.dtype) == "bfloat16":  # numpy has no bf16: go through f32
        return torch.from_numpy(arr.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)  # a writable copy


def _permute_3d(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _permute_3d(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_permute_3d(v) for v in tree]
    return tree.permute(2, 1, 0).contiguous() if tree.ndim == 3 else tree


def _swap_conv_layout(params: Any) -> Any:
    """Conv weights between ``[k, in/groups, out]`` and ``[out, in/groups,
    k]``, either way (the swap is its own inverse): Whisper's two convs,
    the wav2vec2 feature extractor's and its grouped positional conv,
    every 3-D array of a diarization convnet; none of htdemucs'. Rebinds
    the weights in the tree's own dicts."""
    if "tencoder" in params:  # htdemucs: the torch state dict's layouts
        return params
    # MarbleNet, TitaNet, ECAPA and conv_asr; PyanNet
    if "prologue" in params or "blocks" in params or "convs" in params:
        return _permute_3d(params)
    convs = [params.get("encoder", {}).get(name) for name in _CONV_KEYS]
    if "fe" in params:  # wav2vec2
        convs += params["fe"]["conv_layers"] + [params["enc"]["pos_conv"]]
    for conv in convs:
        if conv is not None:
            conv["w"] = conv["w"].permute(2, 1, 0).contiguous()
    return params


def params_from_jax(tree: Any, device="cpu") -> Any:
    """JAX param tree (nested dicts/lists of numpy-convertible arrays) ->
    the port's tree of tensors on ``device``, conv weights in PyTorch's
    layout; everything else keeps its layout and dtype."""
    return _swap_conv_layout(_to_tensors(tree, device))


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return (tree.float() if tree.dtype == torch.bfloat16 else tree).numpy()


def params_to_jax(params: Any) -> Any:
    """The inverse of :func:`params_from_jax`: the port's tree -> the JAX
    package's tree of numpy arrays (bf16 as f32)."""
    return _to_numpy(_swap_conv_layout(to_device(params, "cpu")))


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts and lists -> path-joined flat keys (the layout of the
    JAX package's ``flatten_tree``)."""
    flat: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(flatten_tree(v, f"{prefix}{_SEP}{k}" if prefix else k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(flatten_tree(v, f"{prefix}{_SEP}{i}"))
    else:
        flat[prefix] = np.asarray(tree)
    return flat


def save_params(path: str, params: Any) -> None:
    """Writes the port's tree as the JAX package's ``.npz`` checkpoint."""
    np.savez(path, **flatten_tree(params_to_jax(params)))


def save_tree(path: str, tree: Any) -> None:
    """Writes a tree of numpy arrays in the JAX package's layout (a
    converter's output, ``engine/weights.py`` and its siblings) as the
    ``.npz`` checkpoint, as the JAX package's ``save_params`` does."""
    np.savez(path, **flatten_tree(tree))


def to_device(tree: Any, device) -> Any:
    """The same tree with every tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def cast_floats(tree: Any, dtype) -> Any:
    """The same tree with every floating-point tensor in ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_floats(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def load_params(path: str, device) -> Any:
    with np.load(path) as data:
        tree = unflatten_tree({k: data[k] for k in data.files})
    return params_from_jax(tree, device)


def model_cache_dir() -> str:
    return os.environ.get(
        "WNT_MODEL_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "whisper_nemo_tpu"),
    )


def resolve_model(
    name: str, device, generator: torch.Generator
) -> Tuple[Any, WhisperDims]:
    """Model name or path -> (params on ``device``, dims).

    Order: explicit ``.npz`` path -> ``<cache>/<name>.npz`` -> seeded random
    initialization on ``device`` from ``generator`` (logged loudly)."""
    if name.endswith(".npz") and os.path.exists(name):
        dims = WHISPER_DIMS.get(
            os.path.splitext(os.path.basename(name))[0], WHISPER_DIMS["tiny"]
        )
        return load_params(name, device), dims
    if name not in WHISPER_DIMS:
        raise ValueError(
            f"unknown whisper model {name!r}; expected one of"
            f" {sorted(WHISPER_DIMS)} or a .npz checkpoint path"
        )
    dims = WHISPER_DIMS[name]
    ckpt = os.path.join(model_cache_dir(), f"{name}.npz")
    if os.path.exists(ckpt):
        logger.info("loading %s from %s", name, ckpt)
        return load_params(ckpt, device), dims
    logger.warning(
        "no checkpoint found for %s (looked in %s); using seeded random "
        "initialization — transcriptions will be meaningless until "
        "converted weights are installed",
        name,
        model_cache_dir(),
    )
    return init_whisper_params(dims, device, generator), dims


def resolve_aligner(
    dims: Wav2Vec2Dims, device, generator: torch.Generator
) -> Any:
    """The alignment model's f32 params on ``device``:
    ``<cache>/ctc_aligner.npz``, else a seeded random initialization on
    ``device`` from ``generator`` (logged loudly)."""
    ckpt = os.path.join(model_cache_dir(), "ctc_aligner.npz")
    if os.path.exists(ckpt):
        logger.info("loading the aligner from %s", ckpt)
        return load_params(ckpt, device)
    logger.warning(
        "no aligner checkpoint at %s; using seeded random initialization —"
        " word timestamps will be meaningless until converted weights are"
        " installed",
        ckpt,
    )
    return init_wav2vec2_params(dims, device, generator)

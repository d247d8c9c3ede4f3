"""A released (ht)demucs checkpoint -> the htdemucs param tree.

Counterpart of ``tools/convert_demucs.py:42-140``. The stemming stage's
model, ``htdemucs``, ships as a ``.th`` file holding ``{'klass', 'args',
'kwargs', 'state'}`` (demucs' ``serialize_model``) or a raw state dict.
:func:`read_th` reads it through ``engine/readers.load_pickled``, so
demucs' class stays a stub and the demucs package is not needed.
:func:`convert_state_dict` re-keys the state dict into the torch-layout
tree ``models/htdemucs.py`` runs (a pure re-keying: tensor layouts are
kept) and checks it strictly: the key set and every shape must be those
of ``models/htdemucs.init_htdemucs_params`` at the inferred dims, else
it raises listing what is missing, unconsumed or mis-shaped.
:func:`sidecar` is the ``.cfg.json`` written beside the ``.npz``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..models.htdemucs import HTDemucsDims, infer_dims, init_htdemucs_params
from .readers import load_pickled, state_dict_of

# torch DConv submodule indices -> tree keys (the npz tree cannot use the
# sparse numeric keys 0/1/3/4/6: the loader list-ifies numeric dicts)
_DCONV_RENAME = {"0": "conv1", "1": "norm1", "3": "conv2", "4": "norm2"}


def rekey(torch_key: str) -> str:
    """torch state-dict name -> '/'-joined tree path."""
    parts = torch_key.split(".")
    if "dconv" in parts:
        i = parts.index("dconv")
        # encoder.N.dconv.layers.D.<idx>.<param>
        idx = parts[i + 3]
        if idx == "6":
            parts = parts[: i + 3] + ["scale"]  # 6.scale -> scale
        else:
            parts = parts[: i + 3] + [_DCONV_RENAME[idx]] + parts[i + 4 :]
    return "/".join(parts)


def _shapes(tree: Any, prefix: str = "") -> Dict[str, Tuple[int, ...]]:
    """'/'-joined paths of a tree of tensors -> their shapes."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tuple(tree.shape)}
    out: Dict[str, Tuple[int, ...]] = {}
    for k, v in items:
        out.update(_shapes(v, f"{prefix}/{k}" if prefix else k))
    return out


def convert_state_dict(sd: Dict[str, Any]) -> Tuple[Dict[str, np.ndarray], HTDemucsDims]:
    """torch state dict -> (flat '/'-keyed float32 tree, inferred dims).

    Raises ValueError listing unconsumed/missing/mis-shaped tensors."""
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
    dims = infer_dims(sd)
    flat = {rekey(k): v for k, v in sd.items()}
    # the expected tree's shapes, on the meta device: nothing is allocated
    expected = _shapes(init_htdemucs_params(dims, "meta", None))
    got = {k: v.shape for k, v in flat.items()}
    missing = sorted(set(expected) - set(got))
    extra = sorted(set(got) - set(expected))
    bad = sorted(k for k in set(got) & set(expected) if got[k] != expected[k])
    if missing or extra or bad:
        raise ValueError(
            "state dict does not match the htdemucs architecture for "
            f"inferred dims {dims}:\n"
            f"  missing ({len(missing)}): {missing[:8]}\n"
            f"  unconsumed ({len(extra)}): {extra[:8]}\n"
            f"  shape mismatches ({len(bad)}): "
            f"{[(k, got[k], expected[k]) for k in bad[:8]]}"
        )
    return flat, dims


def read_th(path: str) -> Tuple[Dict[str, np.ndarray], Optional[float]]:
    """A ``.th`` file -> (float32 numpy state dict, the training segment
    in seconds from ``kwargs`` where the file holds one)."""
    blob = load_pickled(path)
    segment = None
    if isinstance(blob, dict) and "state" in blob:
        kwargs = blob.get("kwargs") or {}
        if "segment" in kwargs:
            segment = float(kwargs["segment"])
    sd = state_dict_of(blob)
    return {k: v.float().numpy() for k, v in sd.items()}, segment


def sidecar(dims: HTDemucsDims, segment: Optional[float]) -> dict:
    """The ``<name>.cfg.json`` contents: the inferred architecture and the
    training segment (the dims' default where the file names none)."""
    return {
        "sources": list(dims.sources),
        "channels": dims.channels,
        "depth": dims.depth,
        "nfft": dims.nfft,
        "bottom_channels": dims.bottom_channels,
        "t_layers": dims.t_layers,
        "segment": segment or dims.segment,
    }

"""Readers of the published checkpoint files, without their packages.

The converters (``engine/weights.py``, ``engine/nemo_weights.py``,
``engine/pyannote_weights.py``, ``engine/demucs_weights.py``) read:

* ``model.safetensors`` by :func:`read_safetensors`, the format read
  directly (an 8-byte little-endian header length, a JSON header of each
  tensor's dtype, shape and byte offsets, then the raw bytes), so that no
  ``safetensors`` package is needed;
* ``pytorch_model.bin`` through ``torch.load(weights_only=True)``;
* torch pickles that name classes of packages this one does not carry
  (demucs' ``klass``, lightning's wrappers) by :func:`load_pickled`, whose
  unpickler turns every such global into an inert stub (the global's
  module is never imported and the global never called) and loads, of
  torch's, numpy's and the standard library's globals, only an exact list
  of rebuild functions and types.

Counterpart of ``tools/convert_checkpoint.py:32-50`` (``load_state_dict``,
``load_config``) and the ``torch.load`` calls of the JAX package's
converters.
"""

from __future__ import annotations

import _compat_pickle
import importlib
import json
import os
import pickle
import struct
import types
from typing import Any, Dict

import numpy as np
import torch

# safetensors dtype names -> little-endian numpy dtypes (BF16 apart)
_SAFETENSORS_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2",
    "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1",
    "U64": "<u8", "U32": "<u4", "U16": "<u2", "U8": "u1", "BOOL": "?",
}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file -> ``{name: array}`` in the file's dtypes,
    BF16 as float32 (numpy has no bfloat16; the widening is exact)."""
    with open(path, "rb") as f:
        (n_header,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n_header))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n_header)
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        if not 0 <= begin <= end <= len(data):
            raise ValueError(f"{path}: {name}'s bytes [{begin}, {end}) lie outside the file")
        raw = data[begin:end]
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            arr = (torch.frombuffer(bytearray(raw), dtype=torch.bfloat16).float().numpy()
                   if len(raw) else np.zeros(0, np.float32))
        elif info["dtype"] in _SAFETENSORS_DTYPES:
            arr = np.array(raw).view(_SAFETENSORS_DTYPES[info["dtype"]])
        else:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which this reader"
                             f" does not take ({sorted(_SAFETENSORS_DTYPES) + ['BF16']})")
        if arr.size != int(np.prod(shape)):
            raise ValueError(f"{path}: {name} holds {arr.size} elements, its shape {shape}")
        out[name] = arr.reshape(shape)
    del data
    return out


def as_f32(x) -> np.ndarray:
    """A tensor or array as a float32 numpy array (the converters' first
    step on every weight)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def load_state_dict(hf_dir: str) -> dict:
    """An HF checkpoint directory's tensors: ``model.safetensors`` (numpy
    arrays), else ``pytorch_model.bin`` (tensors)."""
    st_path = os.path.join(hf_dir, "model.safetensors")
    if os.path.exists(st_path):
        return read_safetensors(st_path)
    bin_path = os.path.join(hf_dir, "pytorch_model.bin")
    if os.path.exists(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin in {hf_dir}")


def load_config(hf_dir: str) -> dict:
    with open(os.path.join(hf_dir, "config.json")) as f:
        return json.load(f)


# -- torch pickles that name foreign classes --------------------------------------

# The globals that unpickle as themselves, each by its exact (module, name):
# torch's tensor and parameter rebuild functions and the types torch's own
# ``weights_only`` unpickler admits, numpy's array and scalar rebuilds, and
# a few inert standard-library types. Any other global of torch, numpy or
# collections is refused; any other global elsewhere becomes a stub.
_TORCH_REBUILD_FUNCS = (
    "_rebuild_tensor", "_rebuild_tensor_v2", "_rebuild_tensor_v3", "_rebuild_parameter",
    "_rebuild_parameter_with_state", "_rebuild_qtensor", "_rebuild_sparse_tensor",
    "_rebuild_nested_tensor", "_rebuild_meta_tensor_no_storage",
    "_rebuild_device_tensor_from_numpy", "_rebuild_device_tensor_from_cpu_tensor",
    "_rebuild_wrapper_subclass",
)
_LEGACY_TENSOR_TYPES = (
    "FloatTensor", "DoubleTensor", "HalfTensor", "BFloat16Tensor", "ByteTensor",
    "CharTensor", "ShortTensor", "IntTensor", "LongTensor", "BoolTensor",
)
_ALLOWED_GLOBALS = frozenset({
    ("collections", "OrderedDict"), ("collections", "Counter"),
    ("torch", "Size"), ("torch", "Tensor"), ("torch", "device"),
    ("torch.nn.parameter", "Parameter"), ("torch.serialization", "_get_layout"),
    ("torch._tensor", "_rebuild_from_type_v2"), ("torch.torch_version", "TorchVersion"),
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("_codecs", "encode"), ("builtins", "set"), ("builtins", "frozenset"),
    ("builtins", "complex"), ("builtins", "slice"), ("builtins", "bytearray"),
    ("fractions", "Fraction"),
    *(("torch._utils", f) for f in _TORCH_REBUILD_FUNCS),
    *(("torch", t) for t in _LEGACY_TENSOR_TYPES),
    *((m, f) for m in ("numpy.core.multiarray", "numpy._core.multiarray")
      for f in ("_reconstruct", "scalar", "_frombuffer")),
})
_TRUSTED_ROOTS = ("torch", "numpy", "collections")


def _is_inert_value(module: str, obj) -> bool:
    """torch's dtypes, layouts, memory formats and qschemes (``torch.float16``
    pickles as a global), and numpy 2's dtype classes."""
    if module == "torch":
        return isinstance(obj, (torch.dtype, torch.layout, torch.memory_format, torch.qscheme))
    return module == "numpy.dtypes" and isinstance(obj, type) and issubclass(obj, np.dtype)


class Stub:
    """An inert stand-in for a global outside the trusted packages. Made
    or called, it keeps its arguments; built, its state."""

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.args, obj.kwargs = args, kwargs
        return obj

    def __setstate__(self, state):
        self.state = state


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        # python 2's names, as protocol-2 pickles (torch.save's default) write them
        if (module, name) in _compat_pickle.NAME_MAPPING:
            module, name = _compat_pickle.NAME_MAPPING[(module, name)]
        elif module in _compat_pickle.IMPORT_MAPPING:
            module = _compat_pickle.IMPORT_MAPPING[module]
        if "." in name:
            raise pickle.UnpicklingError(f"{module}.{name}: a dotted name is not resolved")
        if (module, name) in _ALLOWED_GLOBALS:
            return getattr(importlib.import_module(module), name)
        if module.split(".")[0] not in _TRUSTED_ROOTS:
            return type(name, (Stub,), {"__module__": module, "__qualname__": name})
        if module in ("torch", "numpy.dtypes"):
            obj = getattr(importlib.import_module(module), name, None)
            if _is_inert_value(module, obj):
                return obj
        raise pickle.UnpicklingError(f"{module}.{name} is a global this loader does not load")


# the pickle_module torch.load takes: its Unpickler is the stub unpickler
_stub_pickle = types.SimpleNamespace(__name__="pickle", Unpickler=_StubUnpickler,
                                     load=lambda f, **kw: _StubUnpickler(f, **kw).load())


def load_pickled(path: str) -> Any:
    """A torch pickle (``torch.save``'s zip or legacy format) on the CPU.
    Each global outside torch, numpy, collections and the standard
    library's few inert types unpickles as a :class:`Stub` subclass of its
    name: its module is never imported and the global never called. Within
    those packages only the exact globals of ``_ALLOWED_GLOBALS`` (and
    torch's and numpy's dtype values) load; any other, and any dotted
    name, raises ``pickle.UnpicklingError``."""
    return torch.load(path, map_location="cpu", pickle_module=_stub_pickle, weights_only=False)


def state_dict_of(blob: Any) -> Dict[str, Any]:
    """The tensors of a loaded checkpoint: demucs' ``state``, lightning's
    ``state_dict``, or the mapping itself; entries that are not tensors
    are dropped."""
    if isinstance(blob, dict):
        for key in ("state", "state_dict"):
            if isinstance(blob.get(key), dict):
                blob = blob[key]
                break
        return {k: v for k, v in blob.items() if isinstance(v, torch.Tensor)}
    raise ValueError(f"expected a dict of tensors, got {type(blob).__name__}")

"""Converts the published checkpoints into ``$WNT_MODEL_DIR``'s files:

    python -m whisper_nemo_tpu_torch.cli.convert <kind> <source> [--name N] [--out-dir D]

    whisper      <hf_dir>   --name medium.en   HF Whisper (config.json + model.safetensors
                                                or pytorch_model.bin; vocab.json, merges.txt,
                                                tokenizer.json copied)
    whisper-pt   <ckpt.pt>  --name large-v2    an OpenAI whisper .pt ({"dims", "model_state_dict"})
    aligner      <hf_dir>                      Wav2Vec2ForCTC -> ctc_aligner.npz (+ .vocab.json)
    punctuation  <hf_dir>   [--name hub/id]    XLMRobertaForTokenClassification
                                                (default kredor/punctuate-all)
    vad          <x.nemo>                      vad_multilingual_marblenet (+ .cfg.json)
    titanet      <x.nemo>                      titanet_large (+ .cfg.json)
    msdd         <x.nemo>                      diar_msdd_telephonic
    pyannote     <pytorch_model.bin>           pyannote/segmentation-3.0 -> pyannote_segmentation.npz
    demucs       <x.th>                        htdemucs -> htdemucs.npz (+ .cfg.json)

The kinds, names, files and sidecars are those of the JAX package's tools
(``tools/convert_checkpoint.py``, ``convert_nemo.py``,
``convert_pyannote.py``, ``convert_demucs.py``), and each ``.npz`` holds
the same arrays, so a directory converted by either serves both packages.
It runs without JAX, transformers, safetensors or demucs; the ``.nemo``
kinds need PyYAML. The default output directory is
``engine/checkpoint.model_cache_dir()``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from types import SimpleNamespace

from ..engine.checkpoint import model_cache_dir, save_tree
from ..engine.readers import load_config, load_state_dict

KINDS = ("whisper", "whisper-pt", "aligner", "punctuation", "vad", "titanet", "msdd",
         "pyannote", "demucs")
_NAMED = ("whisper", "whisper-pt")  # the kinds that require --name


def _copy_assets(src_dir: str, out_dir: str, names) -> None:
    """Copies each ``(source name, destination name)`` that exists."""
    for src, dst in names:
        if os.path.exists(os.path.join(src_dir, src)):
            shutil.copy(os.path.join(src_dir, src), os.path.join(out_dir, dst))


def convert_whisper(hf_dir: str, name: str, out_dir: str) -> str:
    from ..engine.weights import convert_hf_whisper_state_dict, dims_from_hf_config

    dims = dims_from_hf_config(SimpleNamespace(**load_config(hf_dir)))
    out = os.path.join(out_dir, f"{name}.npz")
    save_tree(out, convert_hf_whisper_state_dict(load_state_dict(hf_dir), dims))
    _copy_assets(hf_dir, out_dir, [(a, a) for a in ("vocab.json", "merges.txt",
                                                    "tokenizer.json")])
    return out


def convert_whisper_pt(pt_path: str, name: str, out_dir: str) -> str:
    import torch

    from ..engine.weights import convert_openai_whisper_state_dict, dims_from_openai_dims

    ckpt = torch.load(pt_path, map_location="cpu", weights_only=True)
    dims = dims_from_openai_dims(ckpt["dims"])
    out = os.path.join(out_dir, f"{name}.npz")
    save_tree(out, convert_openai_whisper_state_dict(ckpt["model_state_dict"], dims))
    return out


def convert_aligner(hf_dir: str, out_dir: str) -> str:
    from ..models.wav2vec2 import convert_hf_wav2vec2_state_dict, dims_from_hf_wav2vec2_config

    dims = dims_from_hf_wav2vec2_config(SimpleNamespace(**load_config(hf_dir)))
    out = os.path.join(out_dir, "ctc_aligner.npz")
    save_tree(out, convert_hf_wav2vec2_state_dict(load_state_dict(hf_dir), dims))
    _copy_assets(hf_dir, out_dir, [("vocab.json", "ctc_aligner.vocab.json")])
    return out


def convert_punctuation(hf_dir: str, out_dir: str, name: str = "kredor/punctuate-all") -> str:
    from ..models.punctuation import convert_hf_xlmr_state_dict, dims_from_hf_xlmr_config

    dims = dims_from_hf_xlmr_config(load_config(hf_dir))
    safe = name.replace("/", "_")
    out = os.path.join(out_dir, f"{safe}.npz")
    save_tree(out, convert_hf_xlmr_state_dict(load_state_dict(hf_dir), dims))
    _copy_assets(hf_dir, out_dir, [("tokenizer.json", f"{safe}.tokenizer.json")])
    return out


def convert_nemo(kind: str, nemo_path: str, name: str, out_dir: str) -> str:
    """``vad``, ``titanet`` or ``msdd``: ``<name>.npz``, and for the conv
    models the ``<name>.cfg.json`` sidecar of their Jasper blocks."""
    from ..engine import nemo_weights as nw

    config, sd = nw.extract_nemo(nemo_path)
    if kind == "vad":
        _, params, meta = nw.convert_marblenet(config, sd)
    elif kind == "titanet":
        _, params, meta = nw.convert_titanet(config, sd)
    else:
        params, meta, unmapped = nw.convert_msdd(config, sd)
        if unmapped:
            print(f"warning: {len(unmapped)} unmapped tensors: {unmapped[:5]}", file=sys.stderr)
    out = os.path.join(out_dir, f"{name}.npz")
    save_tree(out, params)
    if meta.get("blocks"):
        with open(os.path.join(out_dir, f"{name}.cfg.json"), "w") as f:
            json.dump(meta, f, indent=1)
    return out


def convert_pyannote(ckpt_path: str, name: str, out_dir: str) -> str:
    from ..engine.pyannote_weights import convert_pyannet, extract_pyannote

    out = os.path.join(out_dir, f"{name}.npz")
    save_tree(out, convert_pyannet(extract_pyannote(ckpt_path)))
    return out


def convert_demucs(th_path: str, name: str, out_dir: str) -> str:
    from ..engine.demucs_weights import convert_state_dict, read_th, sidecar

    sd, segment = read_th(th_path)
    flat, dims = convert_state_dict(sd)
    out = os.path.join(out_dir, f"{name}.npz")
    save_tree(out, flat)
    with open(os.path.join(out_dir, f"{name}.cfg.json"), "w") as f:
        json.dump(sidecar(dims, segment), f, indent=2)
    return out


def default_name(kind: str, source: str) -> str:
    """The JAX tools' default output names."""
    if kind in ("vad", "titanet", "msdd"):
        return os.path.splitext(os.path.basename(source))[0]
    return {"punctuation": "kredor/punctuate-all", "pyannote": "pyannote_segmentation",
            "demucs": "htdemucs", "aligner": "ctc_aligner"}[kind]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m whisper_nemo_tpu_torch.cli.convert", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("kind", choices=KINDS)
    parser.add_argument("source", help="checkpoint directory (HF kinds) or file")
    parser.add_argument("--name", default=None,
                        help="output name (whisper: e.g. medium.en; punctuation: the hub id)")
    parser.add_argument("--out-dir", default=None, help="override $WNT_MODEL_DIR")
    args = parser.parse_args(argv)
    if args.kind in _NAMED and not args.name:
        parser.error(f"{args.kind} conversion requires --name (e.g. medium.en)")
    name = args.name or default_name(args.kind, args.source)
    out_dir = args.out_dir or model_cache_dir()
    os.makedirs(out_dir, exist_ok=True)

    if args.kind == "whisper":
        out = convert_whisper(args.source, name, out_dir)
    elif args.kind == "whisper-pt":
        out = convert_whisper_pt(args.source, name, out_dir)
    elif args.kind == "aligner":
        out = convert_aligner(args.source, out_dir)
    elif args.kind == "punctuation":
        out = convert_punctuation(args.source, out_dir, name)
    elif args.kind == "pyannote":
        out = convert_pyannote(args.source, name, out_dir)
    elif args.kind == "demucs":
        out = convert_demucs(args.source, name, out_dir)
    else:
        out = convert_nemo(args.kind, args.source, name, out_dir)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()

"""Diarization child-process entry of the parallel flow, argv-compatible
with the reference's nemo_process.py:

    python -m whisper_nemo_tpu_torch.cli.nemo_process -a <audio>
        [--device auto|cuda|cuda:N|cpu] [--domain PRESET]

decodes the audio, writes ``temp_outputs/mono_file.wav`` under the working
directory and diarizes it there, leaving
``temp_outputs/pred_rttms/mono_file.rttm`` for the parent
(``cli/flow.run_parallel --subprocess-diarization``)."""

import argparse
import os

from ..audio import decode_audio, write_wav
from ..config import create_config
from ..diarize import NeuralDiarizer
from .flow import resolve_device


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("-a", "--audio", help="name of the target audio file", required=True)
    parser.add_argument(
        "--device",
        dest="device",
        default="auto",
        help="'auto' and 'cuda' run on the GPU ('cuda:N' on GPU N) and fail "
        "without one; 'cpu' forces host execution",
    )
    parser.add_argument(
        "--domain",
        dest="domain",
        default="telephonic",
        choices=["telephonic", "meeting", "general"],
    )
    return parser


def main(argv=None) -> None:
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(args.device)
    audio = decode_audio(args.audio)
    temp_path = os.path.join(os.getcwd(), "temp_outputs")
    os.makedirs(temp_path, exist_ok=True)
    write_wav(os.path.join(temp_path, "mono_file.wav"), audio)
    NeuralDiarizer(create_config(temp_path, args.domain), device=device).diarize()


if __name__ == "__main__":
    main()

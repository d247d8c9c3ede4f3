"""Branch-parallel diarized-transcription CLI, argv-compatible with the
reference's diarize_parallel.py:

    python -m whisper_nemo_tpu_torch.cli.parallel -a <audio>
        [--whisper-model NAME (large-v2)] [--batch-size N (4)]
        [--language LANG] [--device auto|cuda|cuda:N|cpu] [--no-stem]
        [--suppress_numerals] [--domain PRESET] [--num-speakers N]
        [--max-speakers N] [--subprocess-diarization]

runs ASR and alignment beside diarization (in process, or the diarizer
in a child process) and writes ``<audio>.txt`` and ``<audio>.srt`` beside
the input."""

from .flow import build_arg_parser, run_parallel

if __name__ == "__main__":
    run_parallel(build_arg_parser(parallel=True).parse_args())

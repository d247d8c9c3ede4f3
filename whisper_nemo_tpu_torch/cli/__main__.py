"""Sequential diarized-transcription CLI, argv-compatible with the
reference's diarize.py:

    python -m whisper_nemo_tpu_torch.cli -a <audio> [--whisper-model NAME]
        [--batch-size N] [--language LANG] [--device auto|cuda|cuda:N|cpu]
        [--no-stem] [--suppress_numerals] [--domain PRESET]
        [--num-speakers N] [--max-speakers N]

writes ``<audio>.txt`` and ``<audio>.srt`` beside the input."""

from .flow import build_arg_parser, run_sequential

if __name__ == "__main__":
    run_sequential(build_arg_parser(parallel=False).parse_args())

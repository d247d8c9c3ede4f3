"""ctc-forced-aligner–compatible alignment API (``api.py``) and the
per-segment batched aligner (``segmented.py``)."""

from .api import (
    generate_emissions,
    get_alignments,
    get_spans,
    load_alignment_model,
    postprocess_results,
    preprocess_text,
)

__all__ = [
    "generate_emissions",
    "get_alignments",
    "get_spans",
    "load_alignment_model",
    "postprocess_results",
    "preprocess_text",
]

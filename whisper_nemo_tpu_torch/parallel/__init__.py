"""Branch-parallel orchestration (``branch.py``): the one-card parallel
CLI flow's ASR and diarization branches. Device meshes over more than one
GPU are not ported (ROADMAP.md queue 1, item 6b)."""

from .branch import BranchResult, asr_and_diarization, run_branches, split_core_groups

__all__ = ["BranchResult", "asr_and_diarization", "run_branches", "split_core_groups"]

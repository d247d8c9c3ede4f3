"""Full-f32 arithmetic on the card for the widths held against the JAX
package's f32 computation on the CPU."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Full-f32 matrix products and convolutions (TF32 off), the caller's
    settings restored after. They are process-wide: a thread that runs
    another model meanwhile sees them too."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

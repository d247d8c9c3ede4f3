"""Full-f32 arithmetic on the card for the widths held against the JAX
package's f32 computation on the CPU."""

from __future__ import annotations

import contextlib
import threading

import torch

_lock = threading.Lock()
_inside = 0  # calls inside full_f32, across threads
_saved = None  # the settings the first of them found


@contextlib.contextmanager
def full_f32():
    """Full-f32 matrix products and convolutions (TF32 off) while any
    thread is inside, the caller's settings restored when the last one
    leaves. The settings are process-wide, so the calls share one count:
    the first in saves and clears them, the last out restores them, and
    calls that overlap in time on several threads (the serving handler
    diarizes each job in a thread of its own) never turn TF32 back on
    under one another. A reduced-width model in another thread meanwhile
    is unaffected: TF32 touches f32 products and convolutions only."""
    global _inside, _saved
    with _lock:
        if _inside == 0:
            _saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        _inside += 1
    try:
        yield
    finally:
        with _lock:
            _inside -= 1
            if _inside == 0:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = _saved

"""Branch-parallel orchestration: ASR and diarization side by side.

Counterpart of ``whisper_nemo_tpu/parallel/branch.py``. Each branch runs
in a thread of its own on a group of devices; the join is in memory and
re-raises the first branch's error. With at least as many devices as
branches the devices are split into disjoint contiguous groups by
fraction (``split_core_groups``); with fewer, every branch shares them.

On CUDA each branch thread enters ``torch.inference_mode`` and its
group's first device, and runs on a ``torch.cuda.Stream`` of its own:
PyTorch's current stream is thread-local, and the port's kernels launch
on it, so the two branches' kernels, cuBLAS and cuDNN calls can overlap
on one card, where the JAX package gives each branch disjoint TPU cores.
A branch's stream first waits for the work its caller had queued on the
device, and is synchronised before the branch returns, so its results
are complete at the join. On the CPU there are no streams.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass
class BranchResult:
    value: Any = None
    error: Optional[BaseException] = None


def _visible_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: pass devices=[torch.device('cpu')] to run the"
            " branches on the host"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def split_core_groups(fractions: Sequence[float], devices: Sequence) -> List[List]:
    """Split devices into disjoint contiguous groups by fraction, every
    group at least one device (the JAX package's
    ``parallel/mesh.split_core_groups``)."""
    devices = list(devices)
    n = len(devices)
    if not fractions or any(f <= 0 for f in fractions):
        raise ValueError("fractions must be positive")
    total = sum(fractions)
    counts = [max(1, int(round(n * f / total))) for f in fractions]
    # fix rounding drift while keeping every group non-empty
    while sum(counts) > n:
        counts[int(np.argmax(counts))] -= 1
    while sum(counts) < n:
        counts[int(np.argmin(counts))] += 1
    if any(c < 1 for c in counts):
        raise ValueError(f"cannot split {n} devices into {len(fractions)} groups")
    groups = []
    start = 0
    for c in counts:
        groups.append(devices[start: start + c])
        start += c
    return groups


@contextlib.contextmanager
def _on(device: torch.device):
    """Inference mode on ``device``; on CUDA, the device and a stream of
    its own that waits for the caller's queued work and is synchronised
    on the way out."""
    with torch.inference_mode():
        if device.type != "cuda":
            yield
            return
        with torch.cuda.device(device):
            stream = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            try:
                with torch.cuda.stream(stream):
                    yield
            finally:
                stream.synchronize()


def run_branches(
    branch_fns: Sequence[Callable[[Sequence[torch.device]], Any]],
    fractions: Optional[Sequence[float]] = None,
    devices: Optional[Sequence[torch.device]] = None,
) -> List[Any]:
    """Run each ``branch_fns[i](group_i)`` concurrently, each in a thread
    on its own device group (``_on`` its first device); join and re-raise
    the first branch error. ``fractions`` splits the devices (default: an
    equal split); ``devices`` defaults to every visible CUDA device.
    Returns the branch results in order."""
    devices = list(devices if devices is not None else _visible_devices())
    if len(devices) >= len(branch_fns):
        fractions = fractions or [1.0 / len(branch_fns)] * len(branch_fns)
        groups = split_core_groups(fractions, devices)
    else:
        # fewer devices than branches: every branch shares them
        groups = [devices for _ in branch_fns]

    results = [BranchResult() for _ in branch_fns]

    def runner(i: int) -> None:
        try:
            with _on(torch.device(groups[i][0])):
                results[i].value = branch_fns[i](groups[i])
        except BaseException as exc:  # surfaced at join
            results[i].error = exc

    threads = [
        threading.Thread(target=runner, args=(i,), name=f"branch-{i}")
        for i in range(len(branch_fns))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, r in enumerate(results):
        if r.error is not None:
            raise RuntimeError(f"branch {i} failed: {r.error}") from r.error
    return [r.value for r in results]


def asr_and_diarization(
    asr_fn: Callable[[Sequence[torch.device]], Any],
    diar_fn: Callable[[Sequence[torch.device]], Any],
    asr_fraction: float = 0.75,
    devices: Optional[Sequence[torch.device]] = None,
) -> Tuple[Any, Any]:
    """The ASR branch takes the large device group, diarization the small
    one; on one card both share it, each on its own stream."""
    asr_result, diar_result = run_branches(
        [asr_fn, diar_fn],
        fractions=[asr_fraction, 1.0 - asr_fraction],
        devices=devices,
    )
    return asr_result, diar_result

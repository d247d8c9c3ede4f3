"""The port's branch-parallel orchestration (``parallel/branch.py``)
against the JAX package's, on the CPU.

The JAX package's ``run_branches`` runs on the conftest's eight virtual
CPU devices; the port's on eight ``torch.device("cpu", i)`` (torch has one
CPU device, and the indices only tell the groups apart: on the CPU a
branch enters ``torch.inference_mode`` and no stream). Both must split
the devices into groups of the same sizes, return the results in order,
re-raise a branch's error at the join as "branch i failed", and share one
device between both branches when there are fewer devices than branches.
"""

import threading

import pytest
import torch

from whisper_nemo_tpu.parallel import branch as jax_branch
from whisper_nemo_tpu.parallel.mesh import split_core_groups as jax_split
from whisper_nemo_tpu_torch.parallel import branch

PORT_DEVICES = [torch.device("cpu", i) for i in range(8)]


def _recorder(tag):
    def fn(devices):
        return tag, [d.index if isinstance(d, torch.device) else d.id for d in devices]
    return fn


@pytest.mark.parametrize("fractions", [(0.75, 0.25), (0.5, 0.5), (1 / 3, 1 / 3, 1 / 3)])
def test_groups_and_results_match_jax(cpu_devices, fractions):
    """Group sizes as JAX's ``split_core_groups`` gives them, contiguous
    and disjoint, and each branch's result in its place."""
    want = [len(g) for g in jax_split(fractions, cpu_devices)]
    assert [len(g) for g in branch.split_core_groups(fractions, PORT_DEVICES)] == want
    fns = [_recorder(f"branch {i}") for i in range(len(fractions))]
    ours = branch.run_branches(fns, fractions=fractions, devices=PORT_DEVICES)
    theirs = jax_branch.run_branches(fns, fractions=fractions, devices=cpu_devices)
    assert [tag for tag, _ in ours] == [tag for tag, _ in theirs] == [
        f"branch {i}" for i in range(len(fractions))]
    assert [ids for _, ids in ours] == [[d.id for d in g] for g in
                                        jax_split(fractions, cpu_devices)]
    assert [ids for _, ids in ours] == [ids for _, ids in theirs]


def test_asr_and_diarization_split_as_jax(cpu_devices):
    ours = branch.asr_and_diarization(_recorder("asr"), _recorder("diar"), devices=PORT_DEVICES)
    theirs = jax_branch.asr_and_diarization(_recorder("asr"), _recorder("diar"),
                                            devices=cpu_devices)
    assert ours == tuple(theirs) == (("asr", [0, 1, 2, 3, 4, 5]), ("diar", [6, 7]))


def test_branch_error_surfaces_at_join(cpu_devices):
    def good(devices):
        return 1

    def bad(devices):
        raise ValueError("diarizer exploded")

    for run, devices in ((branch.run_branches, PORT_DEVICES),
                         (jax_branch.run_branches, cpu_devices)):
        with pytest.raises(RuntimeError, match="branch 1 failed: diarizer exploded") as info:
            run([good, bad], devices=devices)
        assert isinstance(info.value.__cause__, ValueError)


def test_one_device_is_shared_and_branches_overlap():
    """With one device both branches get it, run at the same time (each
    waits for the other at a barrier) and in inference mode."""
    both = threading.Barrier(2, timeout=30)

    def fn(devices):
        both.wait()
        return devices, torch.is_inference_mode_enabled()

    cpu = [torch.device("cpu")]
    assert branch.run_branches([fn, fn], devices=cpu) == [(cpu, True), (cpu, True)]
    assert jax_branch.run_branches([_recorder("a"), _recorder("b")],
                                   devices=jax_branch.jax.devices()[:1]) == [("a", [0]),
                                                                             ("b", [0])]


def test_no_cuda_device_raises_naming_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"devices=\[torch.device\('cpu'\)\]"):
        branch.run_branches([_recorder("a"), _recorder("b")])

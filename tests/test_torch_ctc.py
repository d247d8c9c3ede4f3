"""The port's CTC Viterbi (whisper_nemo_tpu_torch/ops/ctc.py) against the
JAX package.

Inputs are made with numpy from a seed and fed to both sides. The
Viterbi is one f32 add per state and step and an exact max with the same
tie order, so alpha, backpointers and paths must be exactly equal. Where
the JAX function is a Pallas kernel, it runs in interpret mode, as the
JAX package's own tests run it on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_nemo_tpu.ops import ctc as jax_ctc
from whisper_nemo_tpu.ops.viterbi_pallas import viterbi_forward_pallas
from whisper_nemo_tpu_torch.ops import ctc


def _trellis(t, n, v, rng):
    """Dirichlet log-probs gathered through random labels, with the CTC
    skip rule (tests/test_viterbi_pallas.py's construction)."""
    em = np.log(rng.dirichlet(np.ones(v), size=t).astype(np.float32))
    labels = rng.integers(1, v, size=n).astype(np.int32)
    labels[n // 2] = labels[n // 2 - 1]  # a repeat: a skip that is not allowed
    ll = 2 * n + 1
    state_labels = np.zeros((ll,), np.int32)
    state_labels[1::2] = labels
    allow_skip = np.zeros((ll,), bool)
    for s in range(3, ll, 2):
        allow_skip[s] = labels[(s - 1) // 2] != labels[(s - 3) // 2]
    return em[:, state_labels], allow_skip


def _rows(t, n, seed, r=3):
    rng = np.random.default_rng(seed)
    cases = [_trellis(t, n, 8, rng) for _ in range(r)]
    return np.stack([c[0] for c in cases]), np.stack([c[1] for c in cases])


@pytest.mark.parametrize("t,n", [(40, 5), (300, 20)])
def test_plain_viterbi_matches_jax_scan_exactly(t, n):
    """Three rows of different content in one batch against JAX's scan
    and backtrack row by row: alpha, bps and path exactly equal."""
    e_states, allow_skip = _rows(t, n, seed=t + n)
    alpha, bps, path = ctc.viterbi_batch(torch.from_numpy(e_states), torch.from_numpy(allow_skip))
    assert alpha.dtype == torch.float32 and bps.dtype == torch.int8 and path.dtype == torch.int32
    for row in range(len(e_states)):
        a_ref, bp_ref = jax_ctc._viterbi_forward_states(jnp.asarray(e_states[row]),
                                                        jnp.asarray(allow_skip[row]))
        path_ref = jax_ctc._viterbi_backtrack(a_ref, bp_ref)
        np.testing.assert_array_equal(alpha[row].numpy(), np.asarray(a_ref))
        np.testing.assert_array_equal(bps[row].numpy(), np.asarray(bp_ref))
        np.testing.assert_array_equal(path[row].numpy(), np.asarray(path_ref))


def test_plain_viterbi_matches_the_pallas_kernel():
    """Against the TPU kernel itself (interpret mode, one small T): the
    same alpha, backpointers and path."""
    e_states, allow_skip = _rows(37, 6, seed=5, r=2)
    alpha, bps, path = ctc.viterbi_batch(torch.from_numpy(e_states), torch.from_numpy(allow_skip))
    for row in range(2):
        a_pal, bp_pal = viterbi_forward_pallas(jnp.asarray(e_states[row]),
                                               jnp.asarray(allow_skip[row]), interpret=True)
        np.testing.assert_array_equal(alpha[row].numpy(), np.asarray(a_pal))
        np.testing.assert_array_equal(bps[row].numpy(), np.asarray(bp_pal))
        np.testing.assert_array_equal(
            path[row].numpy(), np.asarray(jax_ctc._viterbi_backtrack(a_pal, bp_pal)))


def test_single_frame_trellis():
    """T = 1 has no backpointers; the path is the start state alone, as
    in JAX (one label: alpha is NEG_INF in the last state, so the path
    starts in the one before it)."""
    e_states, allow_skip = _rows(1, 1, seed=2, r=2)
    alpha, bps, path = ctc.viterbi_batch(torch.from_numpy(e_states), torch.from_numpy(allow_skip))
    assert bps.shape == (2, 0, 3)
    for row in range(2):
        a_ref, bp_ref = jax_ctc._viterbi_forward_states(jnp.asarray(e_states[row]),
                                                        jnp.asarray(allow_skip[row]))
        np.testing.assert_array_equal(alpha[row].numpy(), np.asarray(a_ref))
        np.testing.assert_array_equal(path[row].numpy(),
                                      np.asarray(jax_ctc._viterbi_backtrack(a_ref, bp_ref)))
    assert path[:, 0].tolist() == [1, 1]


@pytest.mark.parametrize("t,n_states", [(1, 1), (1, 2), (1, 3), (9, 1), (9, 2), (9, 3)])
def test_plain_viterbi_edges_match_jax(t, n_states):
    """The smallest trellises (L = 1, 2 and 3 states; T = 1 and 9) with
    random skip permissions, also at states 0 and 1, and emissions on a
    grid of 0.5, so ties are common: alpha, backpointers and path exactly
    JAX's, row by row (kernel D is held bit for bit against this plain
    version on the card, tests/test_torch_kernels.py). JAX's scan does not
    take a single state (its shifted copies lose their shape), so L = 1
    is held against its closed form: stay at every step, alpha the f32
    running sum of the one state's emissions."""
    rng = np.random.default_rng(t * 10 + n_states)
    e_states = (np.round(rng.standard_normal((3, t, n_states)) * 4) / 2).astype(np.float32)
    allow_skip = rng.random((3, n_states)) < 0.5
    alpha, bps, path = ctc.viterbi_batch(torch.from_numpy(e_states), torch.from_numpy(allow_skip))
    assert bps.shape == (3, t - 1, n_states)
    if n_states == 1:
        want = e_states[:, 0, 0].copy()
        for step in range(1, t):
            want = e_states[:, step, 0] + want  # f32, in the recurrence's order
        np.testing.assert_array_equal(alpha[:, 0].numpy(), want)
        assert not bps.any() and not path.any()
        return
    for row in range(3):
        a_ref, bp_ref = jax_ctc._viterbi_forward_states(jnp.asarray(e_states[row]),
                                                        jnp.asarray(allow_skip[row]))
        np.testing.assert_array_equal(alpha[row].numpy(), np.asarray(a_ref))
        np.testing.assert_array_equal(bps[row].numpy(), np.asarray(bp_ref).reshape(t - 1, n_states))
        np.testing.assert_array_equal(path[row].numpy(),
                                      np.asarray(jax_ctc._viterbi_backtrack(a_ref, bp_ref)))


def test_forced_align_label_segments_and_star_match_jax():
    """The planted case of tests/test_align.py plus a wildcard label:
    star column, frame labels, score and label spans equal JAX's."""
    T, V = 50, 4
    em = np.full((T, V), np.log(0.01), np.float32)
    em[:, 0] = np.log(0.97)
    em[10:20, :] = np.log(0.01)
    em[10:20, 1] = np.log(0.97)
    em[25:30, :] = np.log(0.01)
    em[25:30, 3] = np.log(0.97)
    em[30:40, :] = np.log(0.01)
    em[30:40, 2] = np.log(0.97)
    em_star = ctc.add_star_column(em)
    np.testing.assert_array_equal(em_star, jax_ctc.add_star_column(em))
    labels = np.array([1, V, 2], np.int32)
    got_frames, got_score = ctc.forced_align(em_star, labels, device="cpu")
    want_frames, want_score = jax_ctc.forced_align(em_star, labels)
    np.testing.assert_array_equal(got_frames, want_frames)
    assert got_score == want_score
    assert ctc.label_segments(got_frames, em_star, labels) == jax_ctc.label_segments(
        want_frames, em_star, labels)
    empty_frames, empty_score = ctc.forced_align(em_star, np.zeros(0, np.int32), device="cpu")
    want_frames, want_score = jax_ctc.forced_align(em_star, np.zeros(0, np.int32))
    np.testing.assert_array_equal(empty_frames, want_frames)
    assert empty_score == want_score

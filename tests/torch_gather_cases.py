"""Inputs of the scatter and genome-map gather cases, shared by the CPU
schedule tests (tests/test_torch_gather_schedule.py) and the card's
(tests/test_torch_cuda.py).  No JAX here: the machine with the card has
none."""
import numpy as np

from skani_tpu_torch import synth

I32 = np.int32
TOP_BITS = np.array([0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x80000001,
                     0xDEADBEEF], np.uint32).view(I32)


def fill_targets(rng, R, P, A):
    """Phase A's fill targets: where(emit, offs_p, A), strictly increasing
    over the emitting positions, the dropped sentinel A between them."""
    cnt = np.where(rng.random((R, P)) < 0.5, rng.integers(1, 4, (R, P)), 0)
    offs = np.cumsum(cnt, axis=1) - cnt
    emit = (cnt > 0) & (offs < A)
    return np.where(emit, offs, A).astype(I32)


def scatter_inputs(rng, kind, R, V, P, K):
    """(idx (R, P), vals (R, V, P)): "ascending" fill targets, "random"
    unique targets in [0, K) (P <= K), or "dropped": unique targets with
    negative ones and ones >= K up to INT32_MAX.  Payloads are adversarial
    words with top-bit patterns."""
    if kind == "ascending":
        idx = fill_targets(rng, R, P, K)
    elif kind == "random":
        idx = np.stack([rng.permutation(K)[:P] for _ in range(R)]
                       ).astype(I32)
    else:
        idx = synth.unique_targets(rng, R, P, K)
        idx[:, 8:12] = [K, K + 1, 2 ** 31 - 1, -(2 ** 31)]
    vals = synth.adversarial_words(rng, (R, V, P))
    vals[:, :, 12:12 + TOP_BITS.size] = TOP_BITS
    return idx, vals


def gmap_inputs(rng, kind, G, R, P, K):
    """(skid (G, P), a_idx (R,), jw (R, K)): the last eighth of every skid
    row is padding (0); a_idx "unsorted" with repeats, "all_equal", or
    "out_of_range" (genome ids and skid values outside [0, G) and
    [0, K))."""
    skid = rng.integers(0, K, (G, P)).astype(I32)
    skid[:, P - P // 8:] = 0
    a = rng.integers(0, G, R).astype(I32)
    if kind == "all_equal":
        a[:] = G // 2
    elif kind == "out_of_range":
        a[:4] = [-2, G, G + 3, -(2 ** 31)]
        skid[:, :6] = [-1, K, K + 7, -(2 ** 31), 2 ** 31 - 1, K - 1]
    jw = synth.adversarial_words(rng, (R, K))
    jw[:, :TOP_BITS.size] = TOP_BITS
    return skid, a, jw

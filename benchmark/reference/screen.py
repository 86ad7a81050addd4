"""Marker-based screening (pre-filter before chaining).

Hash-set semantics become sorted-array set ops (reference: src/screen.rs).
The inverted index marker->sketch_ids is stored CSR-style so a query's
membership test is one searchsorted + bincount — the same masked sparse
lookup the sharded multi-host path broadcasts.

A frozen copy of skani_tpu_torch/screen.py, kept in the benchmark's reference so that no
change to the program moves it.
"""
from __future__ import annotations

import numpy as np

from .params import K_MARKER_AA, K_MARKER_DNA, SCREEN_MINIMUM_KMERS


def check_markers_quickly(ref_sketch, query_sketch, screen_val: float,
                          rescue_small: bool) -> bool:
    """reference: src/screen.rs:84-142"""
    if screen_val == 0.0:
        return True
    min_card = min(len(ref_sketch.marker_seeds), len(query_sketch.marker_seeds))
    if min_card < SCREEN_MINIMUM_KMERS and rescue_small:
        return True
    if min_card == 0:
        return rescue_small
    assert ref_sketch.amino_acid == query_sketch.amino_acid
    k = K_MARKER_AA if ref_sketch.amino_acid else K_MARKER_DNA
    ratio = int(screen_val ** k * min_card)
    if ratio == 0:
        ratio = 1
    # Both marker arrays are sorted unique.  Mirror the reference's early
    # exit (reference: src/screen.rs:131-137 breaks once intersect_len >=
    # ratio): scan the smaller array in growing chunks and stop as soon as
    # the verdict is decided either way (the extra early-False exit cannot
    # change the boolean — the remaining elements can't reach ratio).
    a, b = ref_sketch.marker_seeds, query_sketch.marker_seeds
    if len(a) > len(b):
        a, b = b, a
    inter = 0
    start = 0
    n = len(a)
    chunk = max(256, 2 * ratio)
    while start < n:
        end = min(n, start + chunk)
        seg = a[start:end]
        idx = np.searchsorted(b, seg)
        idx = np.minimum(idx, len(b) - 1)
        inter += int((b[idx] == seg).sum())
        if inter >= ratio:
            return True
        start = end
        if inter + (n - start) < ratio:
            return False
        chunk *= 4
    return inter >= ratio

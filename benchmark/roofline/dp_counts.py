"""Operations and bytes of the chaining DP kernels, and their least time.

A frozen copy of chip_smoke.py's counts (its _DP_*_OPS_PER_CANDIDATE,
dp_candidates and the `bytes=` of each DP row), applied to each launch's
own inputs: the int32 operations are the recurrence's least work a
(valid anchor, candidate) pair, min(band, step) candidates for a valid
anchor at step `step` of its lane; the bytes read every input plane and
write every output plane once.  The least time is the larger of
operations over the int32 lane rate and bytes over the memory rate
(peaks.json; the lane rate is derived, not a data-sheet figure).
"""
from __future__ import annotations

import json
import os

#: the DP wrappers that kernels/device_pipeline.py calls, by name
KINDS = ("dp_chain_compact", "dp_chain_compact_wide", "dp_chain",
         "dp_chain_packed")
#: int32 operations a (valid anchor, candidate) pair
OPS_PER_CANDIDATE = {"dp_chain_compact": 16, "dp_chain_compact_wide": 17,
                     "dp_chain": 15, "dp_chain_packed": 16}
#: int32 words a cell over input and output planes
WORDS_PER_CELL = {"dp_chain_compact": 5, "dp_chain_compact_wide": 6,
                  "dp_chain": 5, "dp_chain_packed": 3}
#: the CUDA kernel behind each wrapper, as the profiler names it
KERNELS = {"dp_compact_kernel": "dp_chain_compact",
           "dp_wide_kernel": "dp_chain_compact_wide",
           "dp_chain_packed_kernel": "dp_chain_packed",
           "dp_chain_kernel": "dp_chain"}


def kernel_kind(name: str):
    """The wrapper whose kernel the profiler's event `name` is, or None."""
    for k, kind in KERNELS.items():
        if k + "<" in name or k + "(" in name or name == k:
            return kind
    return None


def candidates(valid, band: int):
    """(anchor, candidate) pairs along the last axis of `valid` (a torch
    tensor of 0/1): an anchor at step i weighs min(band, i).  Returns a
    0-d tensor on valid's device (no synchronisation)."""
    import torch
    n = valid.shape[-1]
    tt = torch.clamp(torch.arange(n, device=valid.device), max=band)
    return (valid.to(torch.int64) * tt).sum()


def counts(kind: str, args):
    """(operations as a 0-d tensor, bytes) of one call of wrapper `kind`
    with positional arguments `args`."""
    if kind == "dp_chain_compact":
        w1, band = args[0], int(args[3])
        valid = w1 & 1
    elif kind == "dp_chain_compact_wide":
        w1, band = args[0], int(args[4])
        valid = w1 & 1
    elif kind == "dp_chain":
        w1, band = args[0], int(args[3])
        valid = (args[2] & 1).T
    elif kind == "dp_chain_packed":
        w1, band = args[0], int(args[2])
        valid = (args[0] & 1).T
    else:
        raise ValueError(kind)
    cells = int(w1.shape[0]) * int(w1.shape[1])
    return (OPS_PER_CANDIDATE[kind] * candidates(valid, band),
            4 * WORDS_PER_CELL[kind] * cells)


def peaks(device_name: str) -> dict:
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "peaks.json")) as f:
        table = json.load(f)
    if device_name not in table:
        raise KeyError(f"no peaks known for {device_name!r}")
    return table[device_name]


def least_seconds(ops, nbytes: int, p: dict) -> float:
    """The least time of one launch at peaks `p`: max(ops / lane rate,
    bytes / memory rate)."""
    return max(float(ops) / p["int32_ops_per_s"],
               nbytes / p["hbm_bytes_per_s"])

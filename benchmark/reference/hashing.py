"""fastrand 1.9's wyrand draws for the bootstrap CI, vectorized (NumPy
uint64 arithmetic wraps, matching Rust's wrapping ops).

A frozen copy of skani_tpu_torch/hashing.py's PRNG part, kept in the
benchmark's reference so that no change to the program moves it (the
seeding hash is in sketch.py, in torch).
"""
from __future__ import annotations

import numpy as np

_U = np.uint64


# ---------------------------------------------------------------------------
# wyrand PRNG (fastrand v1.9), needed for the bit-compatible bootstrap CI
# (reference: src/chain.rs:57-86 uses fastrand::seed(7) + fastrand::usize).
# fastrand's gen_u64: s += 0xa0761d6478bd642f;
#                     t = (s as u128) * ((s ^ 0xe7037ed1a0b428db) as u128);
#                     return lo64(t) ^ hi64(t)
# fastrand's usize(..n) (n < 2^64): mul_high(gen_u64(), n).
# The state advances by a fixed constant each call, so call i (1-based) can be
# computed in closed form -> fully vectorizable.
# ---------------------------------------------------------------------------

_WY_P0 = 0xa0761d6478bd642f
_WY_P1 = 0xe7037ed1a0b428db


def wyrand_u64_batch(seed: int, n: int) -> np.ndarray:
    """The first n outputs of fastrand 1.9's gen_u64 starting from `seed`."""
    idx = np.arange(1, n + 1, dtype=np.uint64)
    s = (_U(seed) + idx * _U(_WY_P0)).astype(np.uint64)
    sx = s ^ _U(_WY_P1)
    # 64x64 -> 128-bit product via 32-bit limbs
    lo, hi = _mul_u64_full(s, sx)
    return lo ^ hi


def _mul_u64_full(a: np.ndarray, b: np.ndarray):
    """Full 128-bit product of uint64 arrays -> (lo64, hi64)."""
    mask32 = _U(0xFFFFFFFF)
    a_lo = a & mask32
    a_hi = a >> _U(32)
    b_lo = b & mask32
    b_hi = b >> _U(32)
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = (ll >> _U(32)) + (lh & mask32) + (hl & mask32)
    lo = (ll & mask32) | ((mid & mask32) << _U(32))
    hi = hh + (lh >> _U(32)) + (hl >> _U(32)) + (mid >> _U(32))
    return lo, hi


def fastrand_usize_below_batch(seed: int, n_calls: int, below: int) -> np.ndarray:
    """fastrand::usize(..below) repeated n_calls times after fastrand::seed(seed).

    fastrand 1.9 uses Lemire's debiased multiply-high reduction with a
    rejection loop.  Rejection fires with probability < below/2^64 (never in
    practice for the bootstrap's small `below`); the vectorized closed form is
    valid when no call rejects, with an exact scalar fallback otherwise.
    """
    r = wyrand_u64_batch(seed, n_calls)
    nvec = np.full(n_calls, below, dtype=np.uint64)
    lo, hi = _mul_u64_full(r, nvec)
    if not np.any(lo < _U(below)):
        return hi
    # Exact scalar fallback replaying the generator with rejection.
    M = (1 << 64) - 1
    out = np.empty(n_calls, dtype=np.uint64)
    s = seed
    t = ((-below) % (1 << 64)) % below

    def gen(sv):
        sv = (sv + _WY_P0) & M
        prod = sv * (sv ^ _WY_P1)
        return sv, (prod & M) ^ (prod >> 64)

    for i in range(n_calls):
        s, rv = gen(s)
        loi = (rv * below) & M
        hii = (rv * below) >> 64
        if loi < below:
            while loi < t:
                s, rv = gen(s)
                loi = (rv * below) & M
                hii = (rv * below) >> 64
        out[i] = hii
    return out

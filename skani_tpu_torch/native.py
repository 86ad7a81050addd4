"""ctypes bindings for the native core (native/skani_core.cpp), the
port's own markers.bin walker (csrc/markers_bin.cpp) and its DeviceDb
pack (csrc/db_pack.cpp).

Builds each source on first use (g++ -O3) into skani_tpu_torch/_native/
(never into another package's directory); falls back cleanly if the
toolchain is unavailable (`available()` -> False and the NumPy reference
path is used; `markers_lib()` -> None and db.py's Python walker reads
markers.bin; `dbpack_lib()` -> None and device_db._pack_genome packs every
row).  The build writes a process-private temporary file and
renames it into place, so concurrent first uses (test workers, the CLI and
a smoke run) never load a half-written library.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "..", "native", "skani_core.cpp")
_OUT_DIR = os.path.join(_HERE, "_native")
_SO = os.path.join(_OUT_DIR, "libskani_core.so")
_MARKERS_SRC = os.path.join(_HERE, "csrc", "markers_bin.cpp")
_MARKERS_SO = os.path.join(_OUT_DIR, "libskt_markers.so")
_DBPACK_SRC = os.path.join(_HERE, "csrc", "db_pack.cpp")
_DBPACK_SO = os.path.join(_OUT_DIR, "libskt_dbpack.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_markers_lib: Optional[ctypes.CDLL] = None
_markers_tried = False
_dbpack_lib: Optional[ctypes.CDLL] = None
_dbpack_tried = False
_lib_lock = threading.Lock()


class _PairOutput(ctypes.Structure):
    _fields_ = [
        ("ani_est", ctypes.POINTER(ctypes.c_double)),
        ("weight", ctypes.POINTER(ctypes.c_int64)),
        ("n_ests", ctypes.c_int64),
        ("total_query_bases", ctypes.c_uint64),
        ("total_ref_range", ctypes.c_uint64),
        ("avg_chain_int_len", ctypes.c_uint64),
        ("num_chains", ctypes.c_int64),
        ("n_anchors", ctypes.c_int64),
        ("owner", ctypes.c_void_p),
    ]


class _IvOutputView(ctypes.Structure):
    _fields_ = [
        ("rec_data", ctypes.POINTER(ctypes.c_int64)),
        ("n_recs", ctypes.c_int64),
        ("q_ctg", ctypes.POINTER(ctypes.c_int32)),
        ("q_val", ctypes.POINTER(ctypes.c_int32)),
        ("n_queries", ctypes.c_int64),
        ("total_query_bases", ctypes.c_uint64),
        ("total_ref_range", ctypes.c_uint64),
        ("avg_chain_sum", ctypes.c_uint64),
        ("num_chains", ctypes.c_int64),
        ("owner", ctypes.c_void_p),
        ("flat", ctypes.c_void_p),
    ]


def _build(src: str, so: str) -> Optional[str]:
    src = os.path.abspath(src)
    if not os.path.exists(src):
        return None
    if (os.path.exists(so)
            and os.path.getmtime(so) >= os.path.getmtime(src)):
        return so
    os.makedirs(_OUT_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
    except (OSError, subprocess.CalledProcessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    return so


def get_lib() -> Optional[ctypes.CDLL]:
    with _lib_lock:
        return _get_lib_locked()


def _get_lib_locked() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _build(_SRC, _SO)
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.fmh_seeds.restype = ctypes.c_int64
    lib.fmh_seeds.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        u32p, u32p, u8p, u64p, ctypes.POINTER(ctypes.c_int64)]
    lib.run_pair.restype = ctypes.POINTER(_PairOutput)
    lib.run_pair.argtypes = [
        u32p, i64p, ctypes.c_int64, u32p, u32p, u8p, ctypes.c_int64,
        u32p, i64p, ctypes.c_int64, u32p, u32p, u8p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_int64, ctypes.c_double,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64]
    lib.free_pair_output.argtypes = [ctypes.POINTER(_PairOutput)]
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.process_intervals.restype = ctypes.POINTER(_IvOutputView)
    lib.process_intervals.argtypes = [
        f64p, i64p, u32p, u32p, u32p, u32p, i64p, i64p, i64p, u8p,
        ctypes.c_int64,
        i64p, i64p, u8p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64]
    lib.free_iv_output.argtypes = [ctypes.POINTER(_IvOutputView)]
    lib.fastrand_indices.restype = None
    lib.fastrand_indices.argtypes = [
        ctypes.c_int64, ctypes.c_uint64, ctypes.c_uint64, u64p]
    lib.bootstrap_ci.restype = None
    lib.bootstrap_ci.argtypes = [f64p, i64p, ctypes.c_int64, f64p]
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.finalize_device_batch.restype = None
    lib.finalize_device_batch.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        i64p, i64p, u8p, u8p, i64p, u8p, u8p, f64p, f64p, i64p, i64p,
        i64p, i64p, i64p, i64p, i64p, i64p,
        f64p, i64p, ctypes.c_int64]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def markers_lib() -> Optional[ctypes.CDLL]:
    """The markers.bin walker (csrc/markers_bin.cpp; db.read_markers_bin),
    or None where it cannot be built."""
    global _markers_lib, _markers_tried
    with _lib_lock:
        if _markers_lib is not None or _markers_tried:
            return _markers_lib
        _markers_tried = True
        so = _build(_MARKERS_SRC, _MARKERS_SO)
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.skt_markers_scan.restype = ctypes.c_int64
        lib.skt_markers_scan.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, u64p, u8p,
            ctypes.c_int64, i64p]
        lib.skt_markers_compact.restype = None
        lib.skt_markers_compact.argtypes = [u8p, ctypes.c_int64, u64p]
        _markers_lib = lib
        return lib


def dbpack_lib() -> Optional[ctypes.CDLL]:
    """The DeviceDb row pack (csrc/db_pack.cpp; device_db._pack_rows), or
    None where it cannot be built."""
    global _dbpack_lib, _dbpack_tried
    with _lib_lock:
        if _dbpack_lib is not None or _dbpack_tried:
            return _dbpack_lib
        _dbpack_tried = True
        so = _build(_DBPACK_SRC, _DBPACK_SO)
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        ptr = ctypes.c_void_p
        lib.skt_db_pack.restype = i64
        lib.skt_db_pack.argtypes = [
            i64, i64, i64, u64p, u64p, u64p, u64p, u64p, i64p, i64p, i64,
            i64] + [ptr] * 10
        _dbpack_lib = lib
        return lib


def fmh_seeds_native(seq: np.ndarray, params):
    """Native sketcher — exact same outputs as sketch.fmh_seeds_np."""
    lib = get_lib()
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    n = len(seq)
    kmer = np.empty(n, dtype=np.uint32)
    pos = np.empty(n, dtype=np.uint32)
    canon = np.empty(n, dtype=np.uint8)
    marker = np.empty(n, dtype=np.uint64)
    nm = ctypes.c_int64(0)
    cnt = lib.fmh_seeds(seq, n, params.c, params.k, params.marker_c,
                        kmer, pos, canon, marker, ctypes.byref(nm))
    return (kmer[:cnt].copy(), pos[:cnt].copy(),
            canon[:cnt].astype(bool), marker[:nm.value].copy())


def process_intervals_native(iv: dict, n_iv: int, chunk_hi: np.ndarray,
                             chunk_ctg: np.ndarray,
                             chunk_new_ctg: np.ndarray, n_chunks: int,
                             k: int, c: int, switched: bool,
                             amino_acid: bool, min_length_cover: int):
    """Greedy non-overlap + per-chunk aggregation over device intervals.

    iv: dict of per-interval arrays (score f64, num i64, q0/q1/r0/r1 u32,
    rc/qc/cid i64, rev u8) of length n_iv.
    Returns (records (n,10) i64, q_ctg i32[], q_val i32[], totals tuple).
    Record columns: chunk_idx, total_anchors, tbc_query, trq0, trq1, ctg,
    lo, hi, union_off, n_union.
    """
    lib = get_lib()
    out = lib.process_intervals(
        np.ascontiguousarray(iv["score"], np.float64),
        np.ascontiguousarray(iv["num"], np.int64),
        np.ascontiguousarray(iv["q0"], np.uint32),
        np.ascontiguousarray(iv["q1"], np.uint32),
        np.ascontiguousarray(iv["r0"], np.uint32),
        np.ascontiguousarray(iv["r1"], np.uint32),
        np.ascontiguousarray(iv["rc"], np.int64),
        np.ascontiguousarray(iv["qc"], np.int64),
        np.ascontiguousarray(iv["cid"], np.int64),
        np.ascontiguousarray(iv["rev"], np.uint8),
        n_iv,
        np.ascontiguousarray(chunk_hi, np.int64),
        np.ascontiguousarray(chunk_ctg, np.int64),
        np.ascontiguousarray(chunk_new_ctg, np.uint8),
        n_chunks, k, c, 1 if switched else 0, 1 if amino_acid else 0,
        min_length_cover)
    o = out.contents
    recs = (np.ctypeslib.as_array(o.rec_data, shape=(o.n_recs, 10)).copy()
            if o.n_recs else np.zeros((0, 10), dtype=np.int64))
    qc = (np.ctypeslib.as_array(o.q_ctg, shape=(o.n_queries,)).copy()
          if o.n_queries else np.zeros(0, dtype=np.int32))
    qv = (np.ctypeslib.as_array(o.q_val, shape=(o.n_queries,)).copy()
          if o.n_queries else np.zeros(0, dtype=np.int32))
    totals = (int(o.total_query_bases), int(o.total_ref_range),
              int(o.avg_chain_sum), int(o.num_chains))
    lib.free_iv_output(out)
    return recs, qc, qv, totals


def _marshal(sk):
    """Cache ctypes-ready contiguous arrays on the sketch object."""
    m = getattr(sk, "_native_arrays", None)
    if m is None:
        m = (np.ascontiguousarray(sk.seed_kmers, np.uint32),
             np.ascontiguousarray(sk.seed_starts, np.int64),
             np.ascontiguousarray(sk.seed_pos, np.uint32),
             np.ascontiguousarray(sk.seed_contig, np.uint32),
             np.ascontiguousarray(sk.seed_canon, np.uint8))
        sk._native_arrays = m
    return m


def run_pair_native(q_sk, r_sk, map_params, switched: bool, c: int):
    """Full per-pair pipeline on pre-switched sketches.

    Returns (ani_est f64[], weight i64[], total_query_bases, total_ref_range,
    avg_chain_int_len, num_chains, n_anchors).
    """
    lib = get_lib()
    pcl = min(map_params.fragment_length // 2, map_params.bp_chain_band)
    qm = _marshal(q_sk)
    rm = _marshal(r_sk)
    out = lib.run_pair(
        qm[0], qm[1], len(q_sk.seed_kmers), qm[2], qm[3], qm[4],
        len(q_sk.contigs),
        rm[0], rm[1], len(r_sk.seed_kmers), rm[2], rm[3], rm[4],
        map_params.index_chain_band, map_params.fragment_length, pcl,
        map_params.max_gap_length, map_params.anchor_score,
        map_params.min_anchors, map_params.min_score, map_params.k,
        c, 1 if switched else 0,
        1 if map_params.amino_acid else 0, map_params.min_length_cover)
    o = out.contents
    n = o.n_ests
    ani_est = np.ctypeslib.as_array(o.ani_est, shape=(n,)).copy() \
        if n else np.zeros(0)
    weight = np.ctypeslib.as_array(o.weight, shape=(n,)).copy() \
        if n else np.zeros(0, dtype=np.int64)
    ret = (ani_est, weight, int(o.total_query_bases),
           int(o.total_ref_range), int(o.avg_chain_int_len),
           int(o.num_chains), int(o.n_anchors))
    lib.free_pair_output(out)
    return ret


def bootstrap_ci_native(anis: np.ndarray,
                        weights: np.ndarray) -> Optional[np.ndarray]:
    """Bootstrap CI + std over SORTED (est, weight) pairs — the single
    shared implementation used by every execution tier (see the C++
    docstring).  Returns [lo, hi, std] or None without the lib."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.zeros(3, dtype=np.float64)
    lib.bootstrap_ci(np.ascontiguousarray(anis, np.float64),
                     np.ascontiguousarray(weights, np.int64),
                     len(anis), out)
    return out


def fastrand_indices_native(n_calls: int, below: int,
                            seed: int) -> Optional[np.ndarray]:
    """fastrand::usize(..below) draws via the C++ wyrand core —
    bit-identical to hashing.fastrand_usize_below_batch (incl. the Lemire
    rejection loop, which the vectorized form only approximates via a
    scalar fallback); None if no lib."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(n_calls, dtype=np.uint64)
    lib.fastrand_indices(n_calls, below, seed, out)
    return out

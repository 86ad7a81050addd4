"""ctypes bindings for the native core (native/skani_core.cpp), the
port's own markers.bin walker (csrc/markers_bin.cpp), its DeviceDb
pack (csrc/db_pack.cpp) and its sketch pass (csrc/sketch_pass.cpp).

Builds each source on first use (g++ -O3) into skani_tpu_torch/_native/
(never into another package's directory); falls back cleanly if the
toolchain is unavailable (`available()` -> False and the NumPy reference
path is used; `markers_lib()` -> None and db.py's Python walker reads
markers.bin; `dbpack_lib()` -> None and device_db._pack_genome packs every
row; `sketch_lib()` -> None and sketch.py's Python path sketches every
file).  The build writes a process-private temporary file and renames it
into place, so concurrent first uses (test workers, the CLI and a smoke
run) never load a half-written library.
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
_SKETCH_SRC = os.path.join(_HERE, "csrc", "sketch_pass.cpp")
_SKETCH_SO = os.path.join(_OUT_DIR, "libskt_sketch.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_markers_lib: Optional[ctypes.CDLL] = None
_markers_tried = False
_dbpack_lib: Optional[ctypes.CDLL] = None
_dbpack_tried = False
_sketch_lib: Optional[ctypes.CDLL] = None
_sketch_tried = False
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


def sketch_lib() -> Optional[ctypes.CDLL]:
    """The sketch pass (csrc/sketch_pass.cpp; sketch._read_file,
    sketch_file, _device_windows), or None where it cannot be built."""
    global _sketch_lib, _sketch_tried
    with _lib_lock:
        if _sketch_lib is not None or _sketch_tried:
            return _sketch_lib
        _sketch_tried = True
        so = _build(_SKETCH_SRC, _SKETCH_SO)
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        lib.skt_fasta_parse.restype = i64
        lib.skt_fasta_parse.argtypes = [ctypes.c_char_p, i64, i64, u8p, i64p,
                                        i64]
        lib.skt_sketch_seed.restype = ctypes.c_void_p
        lib.skt_sketch_seed.argtypes = [u8p, i64p, i64, i64, i64, i64,
                                        ctypes.c_int32, i64p]
        lib.skt_sketch_assemble.restype = ctypes.c_void_p
        lib.skt_sketch_assemble.argtypes = [u32p, u32p, u8p, i64p, i64, u64p,
                                            i64, ctypes.c_int32, i64p]
        lib.skt_sketch_take.restype = None
        lib.skt_sketch_take.argtypes = [ctypes.c_void_p, u32p, i64p, u32p,
                                        u8p, u32p, u64p]
        _sketch_lib = lib
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


def parse_fasta_native(data: bytes, min_len: int):
    """skt_fasta_parse of a FASTA file's bytes: (rec, bases), rec (n, 4)
    int64 rows (header offset and length in `data`, base offset and
    length in `bases`) of the contigs of at least `min_len` bases, their
    bases back to back in `bases`."""
    lib = sketch_lib()
    n = len(data)
    bases = np.empty(n, dtype=np.uint8)
    cap = n // max(min_len, 1) + 1
    rec = np.empty((cap, 4), dtype=np.int64)
    kept = lib.skt_fasta_parse(data, n, min_len, bases, rec, cap)
    if kept < 0:
        raise RuntimeError("skt_fasta_parse: contig table overflow")
    return rec[:kept], bases


def _take(lib, handle, counts):
    """skt_sketch_take of a handle: (seeds, markers), seeds (kmers u32,
    starts i64, pos u32, canon bool, contig u32) or None where the handle
    holds none, markers u64 sorted unique."""
    n, u, m = (int(x) for x in counts)
    kmers = np.empty(u, dtype=np.uint32)
    starts = np.empty(u + 1 if n else 0, dtype=np.int64)
    pos = np.empty(n, dtype=np.uint32)
    canon = np.empty(n, dtype=np.uint8)
    contig = np.empty(n, dtype=np.uint32)
    markers = np.empty(m, dtype=np.uint64)
    lib.skt_sketch_take(handle, kmers, starts, pos, canon, contig, markers)
    seeds = (kmers, starts, pos, canon.view(np.bool_), contig) if n else None
    return seeds, markers


def sketch_seed_native(bases: np.ndarray, offs: np.ndarray, params,
                       seed: bool):
    """skt_sketch_seed: the contigs of `bases` at int64 `offs` (n + 1)
    seeded and assembled; _take's (seeds, markers)."""
    lib = sketch_lib()
    counts = np.zeros(3, dtype=np.int64)
    h = lib.skt_sketch_seed(bases, offs, len(offs) - 1, params.c, params.k,
                            params.marker_c, int(seed), counts)
    return _take(lib, h, counts)


def sketch_assemble_native(kmers: np.ndarray, pos: np.ndarray,
                           canon: np.ndarray, offs: np.ndarray,
                           markers: np.ndarray, seed: bool):
    """skt_sketch_assemble: a file's seeds in encounter order (contig j's
    at [offs[j], offs[j + 1]), offs from 0) and its markers assembled;
    _take's (seeds, markers)."""
    lib = sketch_lib()
    counts = np.zeros(3, dtype=np.int64)
    h = lib.skt_sketch_assemble(
        np.ascontiguousarray(kmers, np.uint32),
        np.ascontiguousarray(pos, np.uint32),
        np.ascontiguousarray(canon).view(np.uint8),
        np.ascontiguousarray(offs, np.int64), len(offs) - 1,
        np.ascontiguousarray(markers, np.uint64), len(markers), int(seed),
        counts)
    return _take(lib, h, counts)


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

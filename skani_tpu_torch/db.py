"""Sketch persistence: skani-compatible binary formats.

Implements readers/writers for the reference's on-disk formats so existing
skani databases interoperate:

* `.sketch` files: bincode-encoded (SketchParams, Sketch)
  (reference: src/file_io.rs:680-718, serde derives in src/types.rs:252 &
  src/params.rs:136);
* `markers.bin`: bincode (SketchParams, Vec<Sketch>) of marker-only sketches
  (reference: src/file_io.rs:720-729);
* consolidated DB: `sketches.db` (concatenated bincode blobs) + `index.db`
  (bincode Vec<IndexEntry{file_name, offset, length}>)
  (reference: src/sketch_db.rs:10-139).

bincode v1 default config: little-endian, fixed-size ints (usize as u64),
Vec/String/HashMap/HashSet as u64 length + payload, Option as 1-byte tag.
Parsing uses NumPy views over an mmap for the hot arrays.
"""
from __future__ import annotations

import mmap
import os
import struct
from typing import List, Optional, Tuple

import numpy as np

from . import native, stats
from .params import SketchParams
from .sketch import Sketch

_PAIR_DT = np.dtype({"names": ["k", "v"], "formats": ["<u4", "<u8"],
                     "offsets": [0, 4], "itemsize": 12})
_SEEDPOS_DT = np.dtype([("pos", "<u4"), ("cic", "<u4")])


class CorruptDbError(IOError):
    """A sketch file / database failed structural validation (truncated,
    bit-flipped, or not a sketch file at all).  The reference hard-errors
    with a clean message in this case (src/search.rs:92-95,
    src/file_io.rs:703-709); callers convert this into that behavior
    instead of leaking an arbitrary struct/numpy traceback."""


class _Reader:
    """Bounds-checked cursor over bytes/mmap.  Every read validates
    against the buffer end (and an optional blob-local `end` for
    consolidated-DB entries) so corrupt length fields fail fast with
    CorruptDbError rather than over-reading into a neighboring blob or
    raising an arbitrary low-level exception."""

    def __init__(self, buf, off: int = 0, end: Optional[int] = None):
        self.buf = buf
        self.off = off
        self.end = len(buf) if end is None else min(end, len(buf))

    def _need(self, n: int):
        if n < 0 or self.off + n > self.end:
            raise CorruptDbError(
                f"truncated or corrupt sketch data: need {n} bytes at "
                f"offset {self.off}, only {self.end - self.off} available")

    def u64(self) -> int:
        self._need(8)
        v = struct.unpack_from("<Q", self.buf, self.off)[0]
        self.off += 8
        return v

    def u32(self) -> int:
        self._need(4)
        v = struct.unpack_from("<I", self.buf, self.off)[0]
        self.off += 4
        return v

    def u8(self) -> int:
        self._need(1)
        v = self.buf[self.off]
        self.off += 1
        return v

    def raw(self, n: int) -> bytes:
        self._need(n)
        v = bytes(self.buf[self.off:self.off + n])
        self.off += n
        return v

    def vec_len(self, min_itemsize: int) -> int:
        """u64 element count with a plausibility bound: n elements of at
        least min_itemsize bytes each must fit in the remaining buffer —
        rejects bit-flipped counts before they drive huge Python loops or
        allocations."""
        n = self.u64()
        if n * min_itemsize > self.end - self.off:
            raise CorruptDbError(
                f"corrupt sketch data: element count {n} at offset "
                f"{self.off - 8} exceeds remaining "
                f"{self.end - self.off} bytes")
        return n

    def string(self) -> str:
        n = self.vec_len(1)
        try:
            return self.raw(n).decode("utf-8")
        except UnicodeDecodeError as e:
            raise CorruptDbError(
                f"corrupt sketch data: invalid utf-8 string at offset "
                f"{self.off - n}") from e

    def np_view(self, dtype, count: int) -> np.ndarray:
        nbytes = dtype.itemsize * count
        self._need(nbytes)
        arr = np.frombuffer(self.buf, dtype=dtype, count=count,
                            offset=self.off)
        self.off += nbytes
        return arr


def _read_sketch_params(r: _Reader) -> SketchParams:
    c = r.u64()
    k = r.u64()
    marker_c = r.u64()
    use_syncs = bool(r.u8())
    use_aa = bool(r.u8())
    n = r.u64()
    r.np_view(np.dtype("<u8"), n)       # acgt_to_aa_encoding
    n = r.u64()
    r.raw(n)                             # acgt_to_aa_letters
    r.u64()                              # orf_size
    return SketchParams(c=c, k=k, marker_c=marker_c, use_syncs=use_syncs,
                        use_aa=use_aa)


def _read_sketch(r: _Reader) -> Sketch:
    sk = Sketch()
    sk.file_name = r.string()
    has_seeds = r.u8()
    kmers = pos = cic = None
    multi: List[np.ndarray] = []
    if has_seeds:
        n = r.u64()
        pairs = r.np_view(_PAIR_DT, n)
        kmers = pairs["k"]
        tagged = pairs["v"]
    n_multi = r.vec_len(8)
    for _ in range(n_multi):
        m = r.u64()
        multi.append(r.np_view(_SEEDPOS_DT, m))
    n_ctg = r.vec_len(8)
    sk.contigs = [r.string() for _ in range(n_ctg)]
    sk.total_sequence_length = r.u64()
    n = r.u64()
    sk.contig_lengths = r.np_view(np.dtype("<u4"), n).copy()
    r.u64()  # repetitive_kmers
    n = r.u64()
    sk.marker_seeds = np.sort(r.np_view(np.dtype("<u8"), n))
    sk.marker_c = r.u64()
    sk.c = r.u64()
    sk.k = r.u64()
    sk.contig_order = r.u64()
    sk.individual_contig = bool(r.u8())
    sk.amino_acid = bool(r.u8())

    if has_seeds and len(kmers):
        # Expand tagged indices (reference: src/types.rs:207-244):
        # bit0=1 -> single packed SeedPosition in bits 1..; bit0=0 ->
        # bits 1.. index multi_position_storage.
        single = (tagged & np.uint64(1)) != 0
        payload = tagged >> np.uint64(1)
        s_pos = (payload >> np.uint64(31)).astype(np.uint32)
        s_cic = (payload & np.uint64(0x7FFFFFFF)).astype(np.uint32)
        out_k, out_pos, out_cic = [], [], []
        out_k.append(np.repeat(kmers[single], 1))
        out_pos.append(s_pos[single])
        out_cic.append(s_cic[single])
        midx = payload[~single].astype(np.int64)
        if len(midx) and (midx.max(initial=-1) >= len(multi)
                          or midx.min(initial=0) < 0):
            raise CorruptDbError(
                "corrupt sketch data: tagged index references "
                "multi-position storage out of range")
        mk = kmers[~single]
        for i in range(len(midx)):
            mv = multi[midx[i]]
            out_k.append(np.full(len(mv), mk[i], dtype=np.uint32))
            out_pos.append(mv["pos"].copy())
            out_cic.append(mv["cic"].copy())
        allk = np.concatenate(out_k)
        allp = np.concatenate(out_pos)
        allc = np.concatenate(out_cic)
        order = np.argsort(allk, kind="stable")
        allk = allk[order]
        sk.seed_pos = allp[order]
        cics = allc[order]
        sk.seed_canon = (cics & 1).astype(bool)
        sk.seed_contig = cics >> np.uint32(1)
        uniq, starts = np.unique(allk, return_index=True)
        sk.seed_kmers = uniq
        sk.seed_starts = np.append(starts, len(allk)).astype(np.int64)
    return sk


class _Writer:
    def __init__(self):
        self.parts: List[bytes] = []

    def u64(self, v: int):
        self.parts.append(struct.pack("<Q", v))

    def u8(self, v: int):
        self.parts.append(struct.pack("<B", v))

    def raw(self, b: bytes):
        self.parts.append(b)

    def string(self, s: str):
        b = s.encode("utf-8")
        self.u64(len(b))
        self.raw(b)

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


def _write_sketch_params(w: _Writer, p: SketchParams):
    w.u64(p.c)
    w.u64(p.k)
    w.u64(p.marker_c)
    w.u8(int(p.use_syncs))
    w.u8(int(p.use_aa))
    enc = p.acgt_to_aa_encoding
    w.u64(len(enc))
    w.raw(np.asarray(enc, dtype="<u8").tobytes())
    from .params import DNA_TO_AA
    w.u64(len(DNA_TO_AA))
    w.raw(bytes(DNA_TO_AA))
    w.u64(30)  # orf_size


def _write_sketch(w: _Writer, sk: Sketch, markers_only: bool = False):
    w.string(sk.file_name)
    has_seeds = (not markers_only) and len(sk.seed_kmers) > 0
    w.u8(1 if has_seeds else 0)
    multi_blobs: List[bytes] = []
    if has_seeds:
        counts = sk.seed_counts
        n = len(sk.seed_kmers)
        w.u64(n)
        cic = (sk.seed_contig.astype(np.uint64) << np.uint64(1)) \
            | sk.seed_canon.astype(np.uint64)
        packed = (sk.seed_pos.astype(np.uint64) << np.uint64(31)) | cic
        tagged = np.empty(n, dtype=np.uint64)
        singles = counts == 1
        tagged[singles] = (packed[sk.seed_starts[:-1][singles]]
                           << np.uint64(1)) | np.uint64(1)
        multi_ids = np.nonzero(~singles)[0]
        for storage_index, ki in enumerate(multi_ids):
            s, e = sk.seed_starts[ki], sk.seed_starts[ki + 1]
            tagged[ki] = np.uint64(storage_index) << np.uint64(1)
            sub = np.empty(e - s, dtype=_SEEDPOS_DT)
            sub["pos"] = sk.seed_pos[s:e]
            sub["cic"] = cic[s:e].astype(np.uint32)
            multi_blobs.append(struct.pack("<Q", e - s) + sub.tobytes())
        pairs = np.empty(n, dtype=_PAIR_DT)
        pairs["k"] = sk.seed_kmers
        pairs["v"] = tagged
        w.raw(pairs.tobytes())
    w.u64(len(multi_blobs))
    for b in multi_blobs:
        w.raw(b)
    w.u64(len(sk.contigs))
    for cname in sk.contigs:
        w.string(cname)
    w.u64(sk.total_sequence_length)
    if markers_only:
        w.u64(0)
    else:
        w.u64(len(sk.contig_lengths))
        w.raw(sk.contig_lengths.astype("<u4").tobytes())
    w.u64(0)  # repetitive_kmers
    w.u64(len(sk.marker_seeds))
    w.raw(sk.marker_seeds.astype("<u8").tobytes())
    w.u64(sk.marker_c)
    w.u64(sk.c)
    w.u64(sk.k)
    w.u64(sk.contig_order)
    w.u8(int(sk.individual_contig))
    w.u8(int(sk.amino_acid))


def serialize_sketch(params: SketchParams, sk: Sketch,
                     markers_only: bool = False) -> bytes:
    w = _Writer()
    _write_sketch_params(w, params)
    _write_sketch(w, sk, markers_only=markers_only)
    return w.getvalue()


class _corrupt_guard:
    """Context manager converting any residual low-level parse exception
    (struct/numpy/index arithmetic on adversarial bytes) into a clean
    CorruptDbError naming the file — the reference-style hard error
    (src/search.rs:92-95) instead of an arbitrary traceback."""

    def __init__(self, path: str):
        self.path = path

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if et is None or issubclass(et, CorruptDbError):
            if et is not None:
                ev.args = (f"{self.path}: {ev}",)
            return False
        if issubclass(et, (struct.error, ValueError, IndexError, KeyError,
                           OverflowError, MemoryError, UnicodeDecodeError)):
            raise CorruptDbError(
                f"{self.path} is not a valid sketch file or is corrupted "
                f"({et.__name__}: {ev})") from ev
        return False


def read_sketch_file(path: str) -> Tuple[SketchParams, Sketch]:
    """Read one bincode (SketchParams, Sketch) file
    (reference: src/file_io.rs:680-718)."""
    with open(path, "rb") as f:
        buf = f.read()
    with _corrupt_guard(path):
        r = _Reader(buf)
        params = _read_sketch_params(r)
        sk = _read_sketch(r)
    return params, sk


def write_sketch_file(path: str, params: SketchParams, sk: Sketch) -> None:
    with open(path, "wb") as f:
        f.write(serialize_sketch(params, sk))


def read_sketch_file_legacy(path: str) -> Tuple[SketchParams, Sketch]:
    """Read a pre-v0.3 skani .sketch file (the reference REJECTS these,
    src/file_io.rs:703-709; we support them read-only as a convenience and
    as golden fixtures).  Old SeedPosition = {pos u32, canonical u8,
    contig_index u32, phase u8} inline in per-kmer smallvecs; no
    multi_position_storage / individual_contig fields."""
    with open(path, "rb") as f:
        buf = f.read()
    with _corrupt_guard(path):
        return _read_sketch_file_legacy(buf)


def _read_sketch_file_legacy(buf) -> Tuple[SketchParams, Sketch]:
    r = _Reader(buf)
    params = _read_sketch_params(r)
    sk = Sketch()
    sk.file_name = r.string()
    has_seeds = r.u8()
    allk = allp = allc = allcan = None
    if has_seeds:
        n = r.vec_len(12)   # >= u32 kmer + u64 count per entry
        ks, ps, cs, cans = [], [], [], []
        dt = np.dtype({"names": ["pos", "canon", "ctg", "phase"],
                       "formats": ["<u4", "u1", "<u4", "u1"],
                       "offsets": [0, 4, 5, 9], "itemsize": 10})
        for _ in range(n):
            k = r.u32()
            m = r.u64()
            sub = r.np_view(dt, m)
            ks.append(np.full(m, k, dtype=np.uint32))
            ps.append(sub["pos"].copy())
            cs.append(sub["ctg"].copy())
            cans.append(sub["canon"].astype(bool))
        allk = np.concatenate(ks)
        allp = np.concatenate(ps)
        allc = np.concatenate(cs)
        allcan = np.concatenate(cans)
    n_ctg = r.vec_len(8)
    sk.contigs = [r.string() for _ in range(n_ctg)]
    sk.total_sequence_length = r.u64()
    n = r.u64()
    sk.contig_lengths = r.np_view(np.dtype("<u4"), n).copy()
    r.u64()  # repetitive_kmers
    n = r.u64()
    sk.marker_seeds = np.sort(r.np_view(np.dtype("<u8"), n))
    sk.marker_c = r.u64()
    sk.c = r.u64()
    sk.k = r.u64()
    sk.contig_order = r.u64()
    sk.amino_acid = bool(r.u8())
    if has_seeds and len(allk):
        order = np.argsort(allk, kind="stable")
        allk = allk[order]
        sk.seed_pos = allp[order]
        sk.seed_contig = allc[order]
        sk.seed_canon = allcan[order]
        uniq, starts = np.unique(allk, return_index=True)
        sk.seed_kmers = uniq
        sk.seed_starts = np.append(starts, len(allk)).astype(np.int64)
    return params, sk


def sketches_from_sketch(paths: List[str]):
    """reference: src/file_io.rs:680-718 (skips markers.bin; sorts by name)."""
    params = SketchParams()
    out = []
    for p in paths:
        if "markers.bin" in p:
            continue
        try:
            params, sk = read_sketch_file(p)
            out.append(sk)
        except CorruptDbError:
            raise
        except Exception as e:
            raise CorruptDbError(
                f"{p} is not a valid .sketch file or is corrupted.") from e
    out.sort(key=lambda s: s.file_name)
    return params, out


def read_markers_bin(path: str) -> Tuple[SketchParams, List[Sketch]]:
    """reference: src/file_io.rs:720-729 — bincode (SketchParams, Vec<Sketch>).

    The file is read once into one 8-byte-aligned buffer.  The native walk
    (csrc/markers_bin.cpp) parses what it accepts, counted as
    `markers_native`; anything else (seeds, multi-position storage,
    contig lengths, a name holding a newline or not UTF-8, a bound failed, no
    library) goes to the Python walker on the same bytes, counted as
    `markers_fallback`, which gives today's sketches or CorruptDbError."""
    buf = _read_aligned(path)
    with _corrupt_guard(path):
        r = _Reader(memoryview(buf))
        params = _read_sketch_params(r)
        n = r.vec_len(8)
        sketches = _markers_native(buf, r.off, n)
        if sketches is None:
            stats.add("markers_fallback")
            sketches = [_read_sketch(r) for _ in range(n)]
        else:
            stats.add("markers_native")
    return params, sketches


def _read_aligned(path: str) -> np.ndarray:
    """The whole file as uint8 over an 8-byte-aligned allocation (read,
    not mapped: a file rewritten under a live mapping faults)."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        buf = np.empty((size + 7) // 8, dtype=np.uint64).view(np.uint8)
        got = f.readinto(memoryview(buf[:size]))
    return buf[:got]


# the empty arrays every markers-only sketch shares (zero-length: nothing
# can be written into them)
_NO_U32 = np.zeros(0, dtype=np.uint32)
_NO_BOOL = np.zeros(0, dtype=bool)
_SKETCH_MIN_BYTES = 91   # a sketch's fixed fields: no names, no markers
_ROW_COLS = 10           # Col in csrc/markers_bin.cpp


def _markers_native(buf: np.ndarray, off: int,
                    n: int) -> Optional[List[Sketch]]:
    """The n markers-only sketches at buf[off:] by the native walk, or None
    where it does not accept them (buf is then untouched).  Accepted, every
    marker_seeds is a view of one sorted run of the uint64 column that the
    walk compacts to the front of buf."""
    left = len(buf) - off
    if n > left // _SKETCH_MIN_BYTES:
        return None
    lib = native.markers_lib()
    if lib is None:
        return None
    rows = np.empty((n, _ROW_COLS), dtype=np.uint64)
    blob = np.empty(left, dtype=np.uint8)
    out = np.zeros(2, dtype=np.int64)
    if lib.skt_markers_scan(buf, len(buf), off, n, rows, blob, len(blob),
                            out):
        return None
    try:
        names = blob[:out[0]].tobytes().decode("utf-8").split("\n")
    except UnicodeDecodeError:
        return None
    lib.skt_markers_compact(buf, n, rows)
    column = buf[:8 * int(out[1])].view(np.uint64)
    sketches = []
    at = 0
    i = 0
    for (n_ctg, total, n_mk, marker_c, c, k, order, individual,
         amino_acid, _src) in rows.tolist():
        sketches.append(Sketch(
            file_name=names[i], contigs=names[i + 1:i + 1 + n_ctg],
            contig_lengths=_NO_U32, total_sequence_length=total,
            seed_kmers=_NO_U32, seed_starts=np.zeros(1, dtype=np.int64),
            seed_pos=_NO_U32, seed_contig=_NO_U32, seed_canon=_NO_BOOL,
            marker_seeds=column[at:at + n_mk], marker_c=marker_c, c=c, k=k,
            contig_order=order, individual_contig=bool(individual),
            amino_acid=bool(amino_acid)))
        at += n_mk
        i += 1 + n_ctg
    return sketches


def write_markers_bin(path: str, params: SketchParams,
                      sketches: List[Sketch]) -> None:
    w = _Writer()
    _write_sketch_params(w, params)
    w.u64(len(sketches))
    for sk in sketches:
        _write_sketch(w, sk, markers_only=True)
    with open(path, "wb") as f:
        f.write(w.getvalue())


class SketchDbWriter:
    """Consolidated DB writer (reference: src/sketch_db.rs:30-82)."""

    def __init__(self, output_dir: str):
        self.dir = output_dir
        self.f = open(os.path.join(output_dir, "sketches.db"), "wb")
        self.index: List[Tuple[str, int, int]] = []
        self.offset = 0

    def add_sketch(self, params: SketchParams, sk: Sketch) -> None:
        blob = serialize_sketch(params, sk)
        self.index.append((sk.file_name, self.offset, len(blob)))
        self.f.write(blob)
        self.offset += len(blob)

    def finalize(self) -> None:
        self.f.close()
        w = _Writer()
        w.u64(len(self.index))
        for name, off, length in self.index:
            w.string(name)
            w.u64(off)
            w.u64(length)
        with open(os.path.join(self.dir, "index.db"), "wb") as f:
            f.write(w.getvalue())


class SketchDbReader:
    """mmap-backed lazy reader (reference: src/sketch_db.rs:84-139)."""

    def __init__(self, database_dir: str):
        index_path = os.path.join(database_dir, "index.db")
        db_path = os.path.join(database_dir, "sketches.db")
        with open(index_path, "rb") as f:
            raw = f.read()
        db_size = os.path.getsize(db_path)
        with _corrupt_guard(index_path):
            r = _Reader(raw)
            n = r.vec_len(24)   # name len u64 + offset u64 + length u64
            self.index = []
            for _ in range(n):
                _name = r.string()
                off = r.u64()
                length = r.u64()
                if off + length > db_size:
                    raise CorruptDbError(
                        f"index entry ({off}, {length}) exceeds "
                        f"sketches.db size {db_size} — truncated or "
                        f"mismatched database")
                self.index.append((off, length))
        self._db_path = db_path
        self._file = open(db_path, "rb")
        self.mmap = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)

    def get_sketch(self, i: int) -> Tuple[SketchParams, Sketch]:
        off, length = self.index[i]
        with _corrupt_guard(f"{self._db_path}[entry {i}]"):
            # blob-local end: a corrupt length field inside the blob can
            # never read into (or parse across) the neighboring sketch
            r = _Reader(self.mmap, off, end=off + length)
            params = _read_sketch_params(r)
            sk = _read_sketch(r)
        return params, sk

    def __len__(self):
        return len(self.index)

    def close(self):
        self.mmap.close()
        self._file.close()


def is_consolidated_db(database_dir: str) -> bool:
    return (os.path.exists(os.path.join(database_dir, "sketches.db"))
            and os.path.exists(os.path.join(database_dir, "index.db")))


def has_separate_sketches(database_dir: str) -> bool:
    try:
        return any(f.endswith(".sketch") for f in os.listdir(database_dir))
    except OSError:
        return False


# ---------------------------------------------------------------------------
# shard manifest (multi-host cold start; no reference analog — the
# reference is single-node.  SURVEY §5.8 / §7.5)
# ---------------------------------------------------------------------------

def shard_indices(n_genomes: int, n_shards: int, shard: int) -> List[int]:
    """Round-robin genome ownership — matches MultiHostPairFleet /
    ShardedPairFleet device ownership (genome g -> shard g % n)."""
    return list(range(shard, n_genomes, n_shards)) if n_shards > 0 else []


def write_shard_manifest(database_dir: str, n_shards: int) -> None:
    """Record the shard layout in the consolidated DB so a multi-host
    fleet can cold-start: each host reads shards.json, takes its
    round-robin slice, and mmap-loads only those (offset, length) entries
    from sketches.db."""
    import json
    with open(os.path.join(database_dir, "index.db"), "rb") as f:
        r = _Reader(f.read())
    n = r.u64()
    manifest = {
        "version": 1,
        "n_shards": int(n_shards),
        "n_genomes": int(n),
        "assignment": "round_robin",
    }
    with open(os.path.join(database_dir, "shards.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def read_shard_manifest(database_dir: str):
    """Returns the manifest dict, or None when the DB has no shard layout
    (single-host DBs)."""
    import json
    path = os.path.join(database_dir, "shards.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)

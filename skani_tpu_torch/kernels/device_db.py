"""Device-resident sketch database (torch tensors).

Genome sketches are uploaded once as padded tensors and stay in device
memory; pair batches index into them on the device.

Two position layouts coexist:

* CSR (kmer-grouped) order — positions parallel to the sorted kmer table
  via `starts`/`counts`.  Within each kmer run, positions are sorted by
  (contig, position): the anchor expansion walks a ref kmer's run in
  order, so run-sortedness makes emitted anchors of one (query position,
  ref kmer) block already reference-Ord sorted.
* position-sorted order — sorted by (contig, position) with the owning
  kmer slot id (`skid`) alongside.  Driving the anchor expansion from THIS
  table emits anchors directly in the reference's Anchor sort order
  (types.rs:499-506 Ord), so no per-pair anchor sort is needed (see
  device_pipeline phase A).

When every genome fits (position < 2^24, fewer than 64 contigs), both
layouts are uploaded PRE-PACKED as single int32 words `ctgc << 24 | pos`
(`apk` packed position-sorted, `bpk` packed CSR), so each anchor needs ONE
gather per side.

`mode` selects what is uploaded:

* "sorted_packed" — apk, bpk, skid (the fast path).  The dense join tables
  (gid, dense_cs, and gidp when a band is given) are built only under the
  memory budget and below 2^17 seed positions per genome; without them
  the engine takes the merge join;
* "sorted"        — spos, sctgc, skid + unpacked pos, ctgc (genomes with
  more than 64 contigs or positions near 2^24);
* "legacy"        — unpacked pos, ctgc only (AAI mode, where 6-frame ORFs
  can place two seeds at the same (contig, position) and the expansion
  order would not be a total sort order).

`DeviceDb.update_rows` swaps genome rows in place (resident `search`
streams queries through reserved rows with it).

The row tables are packed on the host by one native pass a genome
(csrc/db_pack.cpp, `_pack_rows`), straight into the final tables and
across genomes on the caller's `threads`; `_pack_genome` is its plain
version and packs any genome the native pass does not take.  The stats
counters `db_pack_native` / `db_pack_fallback` count the genomes of each.

Host-to-device bytes (builds and row updates) are counted in the stats
counter `upload_bytes`; a build's host packing and upload are the spans
`db_pack` and `db_upload`, a row update's `update_rows_pack` and
`update_rows_upload` inside `update_rows` (stats.py).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .. import native, stats

KMER_SENTINEL = np.uint32(0xFFFFFFFF)
CTG_SENTINEL = np.int32(0x3FFFFFFF)
PACK_POS_BITS = 24
# < 64 contigs so the packed-DP layout rc << 25 | rp keeps cross-contig
# position distances above every chaining threshold; genomes with more
# contigs need the unpacked "sorted" layout
PACK_MAX_CTGS = 64
PACK_RC_SHIFT = 25


def _round_up(x: int, step: int = 4096, floor: int = 4096) -> int:
    return max(floor, ((x + step - 1) // step) * step)


def db_pack_ok(sketches: Sequence) -> bool:
    """True when every genome's positions/contig counts fit the packed
    int32 `ctgc << 24 | pos` word.  The 64 KiB position margin keeps
    chunk-end coordinates (position + one 20 kb fragment) under 2^24 for
    the packed chunk-metadata word (hi << 7 | ctg << 1 | new)."""
    for s in sketches:
        if len(s.contig_lengths) > PACK_MAX_CTGS:
            return False
        if len(s.seed_pos) and int(s.seed_pos.max()) >= (
                (1 << PACK_POS_BITS) - 65536):
            return False
    return True


def db_has_duplicate_positions(sketches: Sequence) -> bool:
    """True if any genome has two seeds at the same (contig, position) —
    possible in AAI mode (6-frame ORFs), never for DNA seeds."""
    for s in sketches:
        if len(s.seed_pos) == 0:
            continue
        packed = s.seed_contig.astype(np.int64) << 32 \
            | s.seed_pos.astype(np.int64)
        if len(np.unique(packed)) != len(packed):
            return True
    return False


def _pack_genome(s, K: int, P: int, srt: bool):
    """One genome's padded row pieces at widths (K, P).  Returns a dict of
    1-D arrays: kmers, starts, counts, pos, ctgc (+ spos, sctgc, skid when
    srt).  Raises ValueError when the sketch exceeds the padded widths."""
    nk = len(s.seed_kmers)
    npos = len(s.seed_pos)
    if nk > K or npos > P:
        raise ValueError("sketch exceeds DeviceDb padded widths")
    out = dict(
        kmers=np.full(K, KMER_SENTINEL, dtype=np.uint32),
        starts=np.zeros(K, dtype=np.int32),
        counts=np.zeros(K, dtype=np.int32),
        pos=np.zeros(P, dtype=np.int32),
        ctgc=np.full(P, CTG_SENTINEL * 2, dtype=np.int32),
        n_kmers=np.int32(nk), n_pos=np.int32(npos),
    )
    if srt:
        out["spos"] = np.zeros(P, dtype=np.int32)
        out["sctgc"] = np.full(P, CTG_SENTINEL * 2, dtype=np.int32)
        out["skid"] = np.zeros(P, dtype=np.int32)
    if nk:
        out["kmers"][:nk] = s.seed_kmers
        out["starts"][:nk] = s.seed_starts[:-1]
        out["counts"][:nk] = np.diff(s.seed_starts)
        kid = np.repeat(np.arange(nk, dtype=np.int32),
                        np.diff(s.seed_starts))
        # CSR with runs sorted by (contig, position) — see module doc
        order = np.lexsort((s.seed_pos, s.seed_contig, kid))
        p = s.seed_pos[order].astype(np.int64)
        c2 = (s.seed_contig[order].astype(np.int32) * 2
              + s.seed_canon[order].astype(np.int32))
        out["pos"][:npos] = p
        out["ctgc"][:npos] = c2
        if srt:
            sorder = np.lexsort((p, c2 >> 1))
            out["spos"][:npos] = p[sorder]
            out["sctgc"][:npos] = c2[sorder]
            out["skid"][:npos] = kid[order][sorder]
    return out


def _seed_arrays(s):
    """`s`'s seed_kmers, seed_starts, seed_pos, seed_contig, seed_canon
    where the native pack takes them (1-D, C-contiguous, aligned, of
    dtypes uint32, int64, uint32, uint32 and bool or uint8, lengths that
    agree), else None."""
    arrs = (s.seed_kmers, s.seed_starts, s.seed_pos, s.seed_contig,
            s.seed_canon)
    dtypes = ((np.uint32,), (np.int64,), (np.uint32,), (np.uint32,),
              (np.bool_, np.uint8))
    for a, ok in zip(arrs, dtypes):
        if not (isinstance(a, np.ndarray) and a.ndim == 1
                and a.flags.c_contiguous and a.flags.aligned
                and a.dtype in ok):
            return None
    if (len(arrs[1]) != len(arrs[0]) + 1
            or not len(arrs[2]) == len(arrs[3]) == len(arrs[4])):
        return None
    return arrs


def _pack_rows(sketches: Sequence, K: int, P: int, srt: bool,
               threads: int = 1) -> Dict[str, np.ndarray]:
    """`_pack_genome`'s row pieces of every sketch, stacked: (G, K) kmers,
    starts, counts, (G, P) pos, ctgc (+ spos, sctgc, skid when srt) and
    (G,) n_pos.  The native pass writes each row it takes in place on
    `threads` threads; `_pack_genome` packs the rest.  Raises ValueError
    for a sketch wider than (K, P)."""
    G = len(sketches)
    names = ("pos", "ctgc") + (("spos", "sctgc", "skid") if srt else ())
    t = dict(kmers=np.empty((G, K), np.uint32),
             starts=np.empty((G, K), np.int32),
             counts=np.empty((G, K), np.int32),
             **{k: np.empty((G, P), np.int32) for k in names},
             n_pos=np.empty(G, np.int32))
    status = np.full(G, 2, np.int8)
    lib = native.dbpack_lib() if G else None
    if lib is not None:
        at = np.zeros((5, G), np.uint64)
        nk = np.full(G, -1, np.int64)
        npos = np.zeros(G, np.int64)
        for g, s in enumerate(sketches):
            arrs = _seed_arrays(s)
            if arrs is None:
                continue
            at[:, g] = [a.ctypes.data for a in arrs]
            nk[g] = len(arrs[0])
            npos[g] = len(arrs[2])
        lib.skt_db_pack(
            0, G, int(threads), *at, nk, npos, K, P,
            *(t[k].ctypes.data for k in ("kmers", "starts", "counts", "pos",
                                         "ctgc")),
            *((t[k].ctypes.data for k in ("spos", "sctgc", "skid")) if srt
              else (None,) * 3),
            t["n_pos"].ctypes.data, status.ctypes.data)
        if (status == 1).any():
            raise ValueError("sketch exceeds DeviceDb padded widths")
    fallback = np.flatnonzero(status)
    for g in fallback:
        rowd = _pack_genome(sketches[g], K, P, srt)
        for k, v in t.items():
            v[g] = rowd[k]
    stats.add("db_pack_native", G - len(fallback))
    stats.add("db_pack_fallback", len(fallback))
    return t


MODES = ("sorted_packed", "sorted", "legacy")


def _mode_tables(mode: str, t: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The tables of `mode` (without the dense join tables) from the row
    pieces of _pack_genome stacked along the genome axis."""
    names = dict(legacy=("kmers", "starts", "counts", "pos", "ctgc"),
                 sorted=("kmers", "starts", "counts", "pos", "ctgc", "spos",
                         "sctgc", "skid", "n_pos"))
    if mode in names:
        return {k: t[k] for k in names[mode]}
    return dict(kmers=t["kmers"], starts=t["starts"], counts=t["counts"],
                apk=(t["sctgc"] << PACK_POS_BITS) | t["spos"],
                bpk=(t["ctgc"] << PACK_POS_BITS) | t["pos"],
                skid=t["skid"], n_pos=t["n_pos"])


def build_arrays(sketches: Sequence, dense_join_budget: int = 0,
                 band: int = 0, mode: str = "sorted_packed",
                 min_k: int = 0, min_p: int = 0,
                 threads: int = 1) -> Dict[str, np.ndarray]:
    """Host-side tables of one `mode` for `sketches`: kmers (uint32),
    starts, counts, and
    "sorted_packed": n_pos, apk, bpk, skid, and — when the dense join fits
    `dense_join_budget` bytes — gid, dense_cs and (band > 0) gidp;
    "sorted": n_pos, pos, ctgc, spos, sctgc, skid;
    "legacy": pos, ctgc.
    `min_k` / `min_p` are floors for the padded widths (tests reach the
    big-genome branches with them); `threads` pack the rows."""
    if mode not in MODES:
        raise ValueError(f"unknown DeviceDb mode {mode!r}")
    G = len(sketches)
    # K at 2048 granularity, P at a 4096 stride (the expansion scatter's
    # source width)
    K = _round_up(max([min_k] + [len(s.seed_kmers) for s in sketches]
                      + [16]), step=2048, floor=4096)
    P = _round_up(max([min_p] + [len(s.seed_pos) for s in sketches]
                      + [16]))
    max_ctgs = max((len(s.contig_lengths) for s in sketches), default=0)
    if max_ctgs >= (1 << 28):
        raise ValueError("too many contigs for device packing")
    pieces = _pack_rows(sketches, K, P, mode != "legacy", threads)
    starts, skid = pieces["starts"], pieces.get("skid")
    arrays = _mode_tables(mode, pieces)
    if mode != "sorted_packed":
        return arrays
    # Dense GLOBAL-AXIS join tables (the all-pairs posting-list
    # amortization): the union of every genome's kmers is ranked once;
    # each genome stores its kmers as union ranks (gid) and a dense
    # (cnt << 17 | start) word per union slot, so the per-pair join
    # collapses to ONE row gather.  Memory is G x |union| x 4 bytes, so
    # only built under budget (0 disables); absent kmers hold 0 (present
    # => cnt >= 1).  Cheap upper bound first: skip the DB-wide unique when
    # even the bound cannot fit the budget.
    u_bound = sum(len(s.seed_kmers) for s in sketches)
    if dense_join_budget and G * u_bound * 4 <= dense_join_budget * 8 \
            and P < (1 << 17):
        union = np.unique(np.concatenate(
            [s.seed_kmers for s in sketches] or [np.zeros(0, np.uint32)]))
        U = _round_up(max(len(union), 1024), 1024, 1024)
    else:
        union, U = None, 1 << 62
    if union is not None and G * U * 4 <= dense_join_budget:
        gid = np.full((G, K), -1, dtype=np.int32)
        dense_cs = np.zeros((G, U), dtype=np.int32)
        # POSITION-AXIS global ids: gidp[g, p] is the union rank of the
        # kmer owning sorted-position slot p, or -1 when the slot is
        # padding OR the kmer's own count exceeds the repeat band (the
        # query-side a_cnt <= band test, reference: src/chain.rs:674-676,
        # baked in at build time).  phase_a's per-pair join is then ONE
        # row gather of the ref's dense (cnt | start) table directly on
        # the position axis.
        gidp = np.full((G, P), -1, dtype=np.int32)
        for g, s in enumerate(sketches):
            nk = len(s.seed_kmers)
            if not nk:
                continue
            r = np.searchsorted(union, s.seed_kmers).astype(np.int32)
            gid[g, :nk] = r
            cnts = np.minimum(np.diff(s.seed_starts), 4095)
            dense_cs[g, r] = (cnts.astype(np.int32) << 17) | starts[g, :nk]
            if band > 0:
                npos = len(s.seed_pos)
                kid_p = skid[g, :npos]
                gp = r[kid_p]
                gp[np.diff(s.seed_starts)[kid_p] > band] = -1
                gidp[g, :npos] = gp
        arrays["gid"] = gid
        arrays["dense_cs"] = dense_cs
        if band > 0:
            arrays["gidp"] = gidp
    return arrays


class DeviceDb:
    """Padded per-genome sketch tensors on one device.

    K = padded unique-kmer count, P = padded seed-position count, U =
    padded kmer-union width of the dense join tables.  `arrays` maps each
    table name to its tensor; kmers are sorted ascending with
    KMER_SENTINEL padding and kept as torch.uint32.  `threads` pack the
    host rows, of the build and of `update_rows`."""

    def __init__(self, sketches: Sequence, device,
                 mode: str = "sorted_packed", dense_join_budget: int = 0,
                 band: int = 0, min_k: int = 0, min_p: int = 0,
                 threads: int = 1):
        self.threads = threads
        with stats.span("db_pack"):
            arrays = build_arrays(sketches, dense_join_budget, band, mode,
                                  min_k, min_p, threads)
        self._adopt(arrays, band, device)

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray], band: int,
                    device) -> "DeviceDb":
        """A DeviceDb holding exactly `arrays` (host numpy tables of one
        mode's layout), e.g. those of another implementation.  The mode
        is read off the table names."""
        db = cls.__new__(cls)
        db.threads = 1
        db._adopt({k: np.asarray(v) for k, v in arrays.items()}, band,
                  device)
        return db

    def _adopt(self, arrays: Dict[str, np.ndarray], band: int, device):
        self.mode = ("sorted_packed" if "apk" in arrays else
                     "sorted" if "spos" in arrays else "legacy")
        self.device = torch.device(device)
        self.band = band
        self.G, self.K = arrays["kmers"].shape
        self.P = arrays["apk" if self.mode == "sorted_packed"
                        else "pos"].shape[1]
        if "dense_cs" in arrays:
            self.U = arrays["dense_cs"].shape[1]
        # the legacy layout carries no n_pos: a genome's positions are the
        # sum of its kmer counts
        n_pos = arrays["n_pos"] if "n_pos" in arrays \
            else arrays["counts"].sum(axis=1)
        self.max_n_pos = int(n_pos.max()) if len(n_pos) else 16
        stats.add("upload_bytes", sum(v.nbytes for v in arrays.values()))
        with stats.span("db_upload"):
            self.arrays = {
                k: torch.from_numpy(np.require(v, requirements="CW"))
                .to(self.device) for k, v in arrays.items()}

    def to(self, device) -> "DeviceDb":
        """A copy of this database on `device` (device to device: not
        counted in `upload_bytes`)."""
        db = DeviceDb.__new__(DeviceDb)
        db.__dict__.update(self.__dict__)
        db.device = torch.device(device)
        db.arrays = {k: v.to(db.device) for k, v in self.arrays.items()}
        return db

    def update_rows(self, slots: Sequence[int], sketches: Sequence) -> None:
        """Replace the genome rows `slots` by `sketches` IN PLACE: the rows
        are packed at the database's (K, P) on the host, copied to the
        device and written by a row scatter on the current stream, so only
        the new rows cross the host link and every holder of
        `arrays[name]` sees them.  Raises ValueError for a database with
        dense join tables (their DB-wide kmer-union axis cannot be
        updated row by row) and for a sketch wider than (K, P)."""
        if "gid" in self.arrays or "gidp" in self.arrays:
            raise ValueError("dense-join DeviceDb rows are not updatable")
        if not len(sketches):
            return
        with stats.span("update_rows"):
            with stats.span("update_rows_pack"):
                pieces = _pack_rows(sketches, self.K, self.P,
                                    self.mode != "legacy", self.threads)
                tables = _mode_tables(self.mode, pieces)
            stats.add("upload_bytes", sum(v.nbytes for v in tables.values()))
            with stats.span("update_rows_upload"):
                idx = torch.as_tensor(np.asarray(slots, dtype=np.int64),
                                      device=self.device)
                for name, v in tables.items():
                    arr = self.arrays[name]
                    # torch.uint32 has no index_copy_: write through an
                    # int32 view of the same storage
                    new = torch.from_numpy(np.ascontiguousarray(v)).to(
                        self.device)
                    arr.view(torch.int32).index_copy_(0, idx,
                                                      new.view(torch.int32))
        self.max_n_pos = max([self.max_n_pos]
                             + [len(s.seed_pos) for s in sketches])

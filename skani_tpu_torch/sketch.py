"""FracMinHash sketching — exact NumPy reference path.

This module is the vectorized "scalar spec" of the sketcher.  The reference
validates its AVX2 kernel against its scalar kernel
(reference: tests/tests.rs:130-144); we do the same: the native C++ sketcher
is validated bit-for-bit against this module, and this module transcribes
the reference semantics
(reference: src/seeding.rs:225-323) exactly:

* the seed k-mer is the LOW 2k bits of the rolling 21-mer marker window, and
  the reverse-strand seed is the LOW 2k bits of the reverse-complement 21-mer
  (which covers a *different* sub-window of the 21-mer) — a quirk that must be
  preserved for output compatibility (reference: src/seeding.rs:288-289);
* canonical selection by numeric min of those two values;
* a k-mer is sampled iff mm_hash64(canonical seed) < u64::MAX/c, and the
  canonical full 21-mer is inserted as a marker iff that same hash is also
  < u64::MAX/marker_c (reference: src/seeding.rs:299-321);
* positions within k after an 'N'/'n' (at index >= 20 only) are skipped
  (reference: src/seeding.rs:272-274,300).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from . import fastx, stats
from .hashing import mm_hash64
from .params import (ASCII_N, ASCII_N_SMALL, K_MARKER_DNA, MIN_LENGTH_CONTIG,
                     SketchParams, host_executor_forced)

_U = np.uint64

# 2-bit DNA encoding (reference: src/types.rs:40-49)
BYTE_TO_SEQ = np.zeros(256, dtype=np.uint64)
for _b, _v in ((67, 1), (71, 2), (84, 3), (85, 3),
               (99, 1), (103, 2), (116, 3), (117, 3)):
    BYTE_TO_SEQ[_b] = _v


@dataclasses.dataclass
class Sketch:
    """A genome sketch in tensor (struct-of-arrays, CSR) layout.

    Unlike the reference's hashmap-of-smallvecs (reference: src/types.rs:253),
    seeds are stored sorted by k-mer with CSR offsets — the layout that
    sort-merge joins and batched device kernels want.
    """
    file_name: str = ""
    contigs: List[str] = dataclasses.field(default_factory=list)
    contig_lengths: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.uint32))
    total_sequence_length: int = 0
    # CSR over unique seed k-mers (sorted ascending)
    seed_kmers: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.uint32))
    seed_starts: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(1, dtype=np.int64))
    seed_pos: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.uint32))
    seed_contig: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.uint32))
    seed_canon: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=bool))
    marker_seeds: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.uint64))  # sorted unique
    marker_c: int = 0
    c: int = 0
    k: int = 0
    contig_order: int = 0
    individual_contig: bool = False
    amino_acid: bool = False

    @property
    def num_seed_kmers(self) -> int:
        return len(self.seed_kmers)

    @property
    def seed_counts(self) -> np.ndarray:
        return np.diff(self.seed_starts)

    def sort_key(self):
        # reference: src/types.rs:360-364
        return (self.file_name, self.contig_order)

    def get_markers_only(self) -> "Sketch":
        """reference: src/types.rs:322-340 (drops seeds and contig_lengths)."""
        return Sketch(
            file_name=self.file_name,
            contigs=list(self.contigs),
            contig_lengths=np.zeros(0, dtype=np.uint32),
            total_sequence_length=self.total_sequence_length,
            marker_seeds=self.marker_seeds,
            marker_c=self.marker_c,
            c=self.c,
            k=self.k,
            contig_order=self.contig_order,
            individual_contig=self.individual_contig,
            amino_acid=self.amino_acid,
        )


def fmh_seeds_np(seq: np.ndarray, params: SketchParams):
    """Exact NumPy transcription of the reference scalar sketcher
    (reference: src/seeding.rs:225-323) for one contig.

    Returns (seed_kmers u32, positions u32, canonical bool, markers u64) in
    scan (encounter) order; markers are NOT deduplicated here.
    """
    mk = K_MARKER_DNA
    k = params.k
    c = params.c
    if k > 16:
        raise ValueError(f"Value of k > 16 for DNA; not allowed.")
    L = len(seq)
    empty = (np.zeros(0, np.uint32), np.zeros(0, np.uint32),
             np.zeros(0, bool), np.zeros(0, np.uint64))
    if L < 2 * mk:
        return empty

    codes = BYTE_TO_SEQ[seq]
    nw = L - mk + 1  # windows; window w ends at i = w + mk - 1
    F = np.zeros(nw, dtype=np.uint64)
    R = np.zeros(nw, dtype=np.uint64)
    for t in range(mk):
        F |= codes[t:t + nw] << _U(2 * (mk - 1 - t))
        R |= (_U(3) - codes[t:t + nw]) << _U(2 * t)

    seed_mask = _U((1 << (2 * k)) - 1)
    fs = F & seed_mask
    rs = R & seed_mask
    canon = fs < rs
    kmer = np.where(canon, fs, rs)
    h = mm_hash64(kmer)

    threshold = _U((2 ** 64 - 1) // c)
    threshold_marker = _U((2 ** 64 - 1) // params.marker_c)

    # N handling: an N at index i >= mk-1 suppresses sampling until i + k
    # (resume_ind semantics, reference: src/seeding.rs:272-274,300).
    i_idx = np.arange(mk - 1, L, dtype=np.int64)
    is_n = (seq[mk - 1:] == ASCII_N) | (seq[mk - 1:] == ASCII_N_SMALL)
    last_n = np.where(is_n, i_idx, np.int64(-1 << 40))
    last_n = np.maximum.accumulate(last_n)
    n_ok = last_n + k <= i_idx

    keep = (h < threshold) & n_ok
    if not keep.any():
        return empty

    canon_m = F < R
    marker_kmer = np.where(canon_m, F, R)
    keep_m = keep & (h < threshold_marker)

    positions = (np.nonzero(keep)[0] + (mk - 1)).astype(np.uint32)
    return (kmer[keep].astype(np.uint32), positions, canon[keep],
            marker_kmer[keep_m])


def _finalize_sketch(sk: Sketch, kmers_parts, pos_parts, canon_parts,
                     contig_parts, marker_parts) -> None:
    """Assemble CSR arrays from per-contig streams (stable by encounter order,
    preserving the reference's per-seed multi-position insertion order)."""
    if kmers_parts:
        kmers = np.concatenate(kmers_parts)
        pos = np.concatenate(pos_parts)
        canon = np.concatenate(canon_parts)
        contig = np.concatenate(contig_parts)
        order = np.argsort(kmers, kind="stable")
        kmers = kmers[order]
        sk.seed_pos = pos[order]
        sk.seed_canon = canon[order]
        sk.seed_contig = contig[order]
        uniq, starts = np.unique(kmers, return_index=True)
        sk.seed_kmers = uniq
        sk.seed_starts = np.append(starts, len(kmers)).astype(np.int64)
    if marker_parts:
        sk.marker_seeds = np.unique(np.concatenate(marker_parts))


#: total bases (the file-size hint of _total_bases_hint) from which a run
#: that imports torch and starts CUDA anyway (dist, triangle, search on the
#: device engine) seeds a DNA file set on the card (kernels/seeding.py)
#: rather than with the native seeder on `-t` host threads.  Both give the
#: same sketches, so the rule decides speed only.  chip_smoke.py's
#: `seeding` sweep (NVIDIA H100 80GB HBM3, 700 W, 8 host threads, 8-128
#: genomes of 5 Mbp): the device route lost at 160 and 240 Mbp (0.421 /
#: 0.608 s against 0.395 / 0.530 s) and won at 320, 480 and 640 Mbp
#: (0.786 / 1.335 / 1.696 s against 1.022 / 1.509 / 2.020 s); the gap,
#: interpolated, closes near 260 Mbp.  It won at 320 Mbp in each of five
#: runs; in one, 640 Mbp came out even (1.733 s against 1.705 s).
DEVICE_SEED_MIN_BASES = 300_000_000

#: the same for the `sketch` subcommand, whose native route imports no
#: torch: there the device route also pays a fresh process's `import torch`
#: and CUDA start-up (7.16 s in the same run), and it lost at every sweep
#: point, by 7.1 s at 40 Mbp and 6.8 s at 640 Mbp (5.8-6.1 s in a
#: second run).  The line through the two largest points met native at
#: 7.9 Gbp in one run and never in the other: this is a round number above
#: every measured point and that extrapolation.
DEVICE_SEED_MIN_BASES_COLD = 10_000_000_000

#: bases of the file window that the device route seeds in one batch
DEVICE_SEED_WINDOW_BASES = 256 << 20


def _total_bases_hint(paths: List[str]) -> int:
    """The file set's bases from file sizes alone (a gzip file counted at
    four times its size): a coarse hint, all the routing rule needs."""
    import os
    total = 0
    for p in paths:
        try:
            sz = os.path.getsize(p)
        except OSError:
            continue
        total += sz * 4 if p.endswith(".gz") else sz
    return total


def default_seeder(params: Optional[SketchParams] = None,
                   total_bases: Optional[int] = None, device=None,
                   cold: bool = False):
    """The seeding kernel for a file set of `total_bases` bases: the AA
    seeder for use_aa; the native C++ kernel (else the NumPy reference) on
    a CPU `device`, under SKANI_TPU_EXECUTOR=native|numpy, or below
    DEVICE_SEED_MIN_BASES (DEVICE_SEED_MIN_BASES_COLD where the caller is
    `cold`: it would otherwise import no torch and start no CUDA);
    otherwise the kernel on `device` (default CUDA: RuntimeError when CUDA
    is absent, as resolve_device raises)."""
    if params is not None and params.use_aa:
        from .aa import fmh_seeds_aa_np
        return fmh_seeds_aa_np
    from . import native
    host = native.fmh_seeds_native if native.available() else fmh_seeds_np
    limit = DEVICE_SEED_MIN_BASES_COLD if cold else DEVICE_SEED_MIN_BASES
    if host_executor_forced() or total_bases is None or total_bases < limit:
        return host
    from .kernels.device_pipeline import resolve_device
    dev = resolve_device(device)
    if dev.type == "cpu":
        return host
    from .kernels.seeding import DeviceSeeder
    return DeviceSeeder(dev)


def _native_pass(params: SketchParams, seeder) -> bool:
    """Whether a file takes the native sketch pass (csrc/sketch_pass.cpp):
    DNA, seeded by the native seeder or a device seeder's flat batch
    (`batch_flat`), with the pass's library loaded.  Every other file
    takes the Python path: fastx, the seeder a contig, _finalize_sketch."""
    if params.use_aa:
        return False
    from . import native
    if seeder is not native.fmh_seeds_native \
            and not hasattr(seeder, "batch_flat"):
        return False
    return native.sketch_lib() is not None


def _read_file(path: str, params: SketchParams, native_pass: bool = False):
    """(Sketch without seeds, [(contig index, sequence)], flat) of one
    file, or None for an invalid file or one with only contigs <
    MIN_LENGTH_CONTIG.  On the native pass (a FASTA file where
    `native_pass`) the sequences are views into one buffer of the kept
    contigs' bases and flat is (that buffer, int64 offsets of the contigs
    in it); otherwise fastx reads the file and flat is None.  Timed as the
    `sketch_read` span."""
    sk = Sketch(file_name=path, marker_c=params.c, c=params.c, k=params.k,
                amino_acid=params.use_aa)
    contigs = []
    with stats.span("sketch_read"):
        try:
            data = fastx.read_fastx(path)
        except fastx.InvalidFastxError:
            return None
        if native_pass and data[:1] == b">":
            from . import native
            rec, bases = native.parse_fasta_native(data, MIN_LENGTH_CONTIG)
            if not len(rec):
                return None
            offs = np.empty(len(rec) + 1, dtype=np.int64)
            offs[:-1] = rec[:, 2]
            offs[-1] = rec[-1, 2] + rec[-1, 3]
            sk.contigs = [data[a:a + n].decode("utf-8", "replace")
                          for a, n in rec[:, :2].tolist()]
            sk.contig_lengths = rec[:, 3].astype(np.uint32)
            sk.total_sequence_length = int(offs[-1])
            o = offs.tolist()
            contigs = [(j, bases[o[j]:o[j + 1]]) for j in range(len(rec))]
            return sk, contigs, (bases, offs)
        try:
            for name, seq in fastx.iter_fastx_bytes(data, path):
                if len(seq) >= MIN_LENGTH_CONTIG:
                    sk.contigs.append(name)
                    sk.contig_lengths = np.append(
                        sk.contig_lengths, np.uint32(len(seq)))
                    sk.total_sequence_length += len(seq)
                    contigs.append((len(contigs), seq))
        except fastx.InvalidFastxError:
            return None
    return (sk, contigs, None) if contigs else None


def _seed_parts(contigs, results, seed: bool):
    """_finalize_sketch's per-contig streams from each contig's seeder
    output (markers always; seeds only when `seed`)."""
    parts = ([], [], [], [], [])
    for (j, _s), (km, po, ca, ma) in zip(contigs, results):
        if seed and len(km):
            parts[0].append(km)
            parts[1].append(po)
            parts[2].append(ca)
            parts[3].append(np.full(len(km), j, dtype=np.uint32))
        if len(ma):
            parts[4].append(ma)
    return parts


def _put(sk: Sketch, seeds, markers) -> None:
    """The native pass's (seeds, markers) into `sk`: the fields
    _finalize_sketch sets, left at their defaults where there are none."""
    if seeds is not None:
        (sk.seed_kmers, sk.seed_starts, sk.seed_pos, sk.seed_canon,
         sk.seed_contig) = seeds
    if len(markers):
        sk.marker_seeds = markers


def sketch_file(path: str, params: SketchParams, seed: bool = True,
                seeder=None) -> Optional[Sketch]:
    """Sketch one fasta/fastq file into a single Sketch
    (reference: src/file_io.rs:141-252).  Returns None for invalid/empty
    files (caller warns+skips).  `seeder` overrides the per-contig kernel;
    defaults to the fastest bit-exact kernel.  A FASTA file of DNA under
    the native seeder takes the native pass (counted `sketch_native`),
    any other file the Python path (`sketch_fallback`).
    """
    seeder = seeder or default_seeder(params)
    r = _read_file(path, params, _native_pass(params, seeder))
    if r is None:
        return None
    sk, contigs, flat = r
    with stats.span("sketch_seed"):
        if flat is not None:
            from . import native
            _put(sk, *native.sketch_seed_native(*flat, params, seed))
        else:
            _finalize_sketch(sk, *_seed_parts(
                contigs, [seeder(s, params) for _j, s in contigs], seed))
    stats.add("sketch_fallback" if flat is None else "sketch_native")
    return sk


def sketch_file_individual(path: str, params: SketchParams, seed: bool = True,
                           seeder=None) -> List[Sketch]:
    """One Sketch per contig (-i/--qi/--ri mode)
    (reference: src/file_io.rs:253-362).  Streams the file a contig at a
    time; the reads and the seeding add up into `sketch_read_s` and
    `sketch_seed_s` once a file (no span a contig)."""
    seeder = seeder or default_seeder(params)
    out = []
    j = 0
    read_s = seed_s = 0.0
    t = time.perf_counter()
    try:
        for name, seq in fastx.iter_fastx(path):
            now = time.perf_counter()
            read_s += now - t
            if len(seq) >= MIN_LENGTH_CONTIG:
                sk = Sketch(file_name=path, marker_c=params.c, c=params.c,
                            k=params.k, amino_acid=params.use_aa,
                            individual_contig=True, contig_order=j)
                sk.contigs.append(name)
                sk.contig_lengths = np.array([len(seq)], dtype=np.uint32)
                sk.total_sequence_length = len(seq)
                km, po, ca, ma = seeder(seq, params)
                _finalize_sketch(
                    sk,
                    [km] if seed and len(km) else [],
                    [po] if seed and len(po) else [],
                    [ca] if seed and len(ca) else [],
                    [np.zeros(len(km), dtype=np.uint32)] if seed and len(km)
                    else [],
                    [ma] if len(ma) else [])
                out.append(sk)
                j += 1
            t = time.perf_counter()
            seed_s += t - now
        read_s += time.perf_counter() - t
    except fastx.InvalidFastxError:
        read_s += time.perf_counter() - t
        return []
    finally:
        stats.add("sketch_read_s", read_s)
        stats.add("sketch_seed_s", seed_s)
    if out:
        stats.add("sketch_fallback")
    return out


def _device_windows(paths: List[str], params: SketchParams, seed: bool,
                    seeder, warn, threads: int = 1,
                    window_bases: int = DEVICE_SEED_WINDOW_BASES):
    """Whole-file-set seeding through the device seeder's batch: files are
    read in order (up to 2 * `threads` ahead, on `threads` threads) into
    windows of at least `window_bases` bases, each window's contigs are
    seeded in one batch, and each window's sketches are finalized (on
    `threads` threads).  Yields each window's [(path index, Sketch)], in
    path order; invalid files are warned about and skipped.  The same
    sketches as the per-contig path.  stats counts the time this thread
    waits for reads (seed_read_wait_s), seeds (seed_batch_s: flattening,
    upload, kernels, download) and finalizes (seed_finalize_s), each a
    span of that name closed before a window is yielded.  Under a seeder
    with `batch_flat` (DeviceSeeder) each file takes the native pass:
    parsed natively, then assembled from its slice of the window's flat
    seeder outputs (counted `sketch_native`); under any other, fastx and
    _finalize_sketch (`sketch_fallback`)."""
    import collections
    import concurrent.futures as cf
    from . import native

    native_pass = _native_pass(params, seeder)

    def finalize(item):
        (sk, contigs, _flat), results = item
        _finalize_sketch(sk, *_seed_parts(contigs, results, seed))
        stats.add("sketch_fallback")
        return sk

    def assemble(item):
        sk, (kmers, pos, canon, markers, so, mo), b0, b1 = item
        s0, s1, m0, m1 = so[b0], so[b1], mo[b0], mo[b1]
        _put(sk, *native.sketch_assemble_native(
            kmers[s0:s1], pos[s0:s1], canon[s0:s1], so[b0:b1 + 1] - s0,
            markers[m0:m1], seed))
        stats.add("sketch_native")
        return sk

    def flush(window):
        seqs = [s for _pi, r in window for _j, s in r[1]]
        if native_pass:
            with stats.span("seed_batch"):
                out = seeder.batch_flat(seqs, params)
            items, b = [], 0
            for _pi, r in window:
                items.append((r[0], out, b, b + len(r[1])))
                b += len(r[1])
            fin = assemble
        else:
            with stats.span("seed_batch"):
                results = iter(seeder.batch(seqs, params))
            items = [(r, [next(results) for _ in r[1]]) for _pi, r in window]
            fin = finalize
        with stats.span("seed_finalize"):
            return [(pi, sk) for (pi, _r), sk
                    in zip(window, ex.map(fin, items))]

    n = max(threads, 1)
    with cf.ThreadPoolExecutor(max_workers=n) as ex:
        def reads():
            ahead = collections.deque()
            for pi, p in enumerate(paths):
                ahead.append((pi, p, ex.submit(_read_file, p, params,
                                                  native_pass)))
                if len(ahead) > 2 * n:
                    qi, q, fut = ahead.popleft()
                    with stats.span("seed_read_wait"):
                        r = fut.result()
                    yield qi, q, r
            while ahead:
                qi, q, fut = ahead.popleft()
                with stats.span("seed_read_wait"):
                    r = fut.result()
                yield qi, q, r

        window, bases = [], 0
        for pi, p, r in reads():
            if r is None:
                if warn:
                    warn(f"{p} is not a valid fasta/fastq file or has only "
                         f"contigs < {MIN_LENGTH_CONTIG} bp; skipping.")
                continue
            window.append((pi, r))
            bases += r[0].total_sequence_length
            if bases >= window_bases:
                yield flush(window)
                window, bases = [], 0
        if window:
            yield flush(window)


def _sketch_files_device_batch(paths: List[str], params: SketchParams,
                               seed: bool, warn, seeder, threads: int = 1,
                               window_bases: int = DEVICE_SEED_WINDOW_BASES
                               ) -> List[Sketch]:
    """Every valid file's Sketch through the device seeder's batch
    (_device_windows), sorted by Sketch.sort_key (reference:
    src/file_io.rs:147-149, the rayon-parallel file loop)."""
    out = [sk for win in _device_windows(paths, params, seed, seeder, warn,
                                         threads, window_bases)
           for _pi, sk in win]
    out.sort(key=Sketch.sort_key)
    return out


def fastx_to_sketches(paths: List[str], params: SketchParams,
                      seed: bool = True, seeder=None,
                      warn=None, threads: int = 1, device=None,
                      total_bases: Optional[int] = None) -> List[Sketch]:
    """reference: src/file_io.rs:141-252 (rayon-parallel over files, then
    sorted by (file_name, contig_order) for determinism).  The native C++
    seeding kernel releases the GIL, so `threads` scales across cores.
    Without a `seeder`, default_seeder picks one for `total_bases` (by
    default the hint from the files' sizes) on `device`; the device
    seeder takes the whole file set through its batch."""
    if seeder is None:
        if total_bases is None:
            total_bases = _total_bases_hint(paths)
        seeder = default_seeder(params, total_bases, device)
    if hasattr(seeder, "batch") and not params.use_aa:
        return _sketch_files_device_batch(paths, params, seed, warn, seeder,
                                          threads)
    if threads > 1 and len(paths) > 1:
        import concurrent.futures as cf
        with cf.ThreadPoolExecutor(max_workers=threads) as ex:
            sks = list(ex.map(
                lambda p: sketch_file(p, params, seed=seed, seeder=seeder),
                paths))
    else:
        sks = [sketch_file(p, params, seed=seed, seeder=seeder)
               for p in paths]
    out = []
    for p, sk in zip(paths, sks):
        if sk is None:
            if warn:
                warn(f"{p} is not a valid fasta/fastq file or has only "
                     f"contigs < {MIN_LENGTH_CONTIG} bp; skipping.")
            continue
        out.append(sk)
    out.sort(key=Sketch.sort_key)
    return out


def fastx_to_multiple_sketch_rewrite(paths: List[str], params: SketchParams,
                                     seed: bool = True, seeder=None,
                                     warn=None) -> List[Sketch]:
    """reference: src/file_io.rs:253-362."""
    out = []
    for p in paths:
        sks = sketch_file_individual(p, params, seed=seed, seeder=seeder)
        if not sks and warn:
            warn(f"{p} is not a valid fasta/fastq file; skipping.")
        out.extend(sks)
    out.sort(key=Sketch.sort_key)
    return out

"""The native sketch pass (csrc/sketch_pass.cpp) against the Python path it
replaces, which stays as its fallback: the parse against fastx._iter_fasta
record for record, sketch_file field for field (dtype, shape, bits) on the
host route, the assemble entry on the plain batch's flat outputs (the
device route on the CPU), three files against the JAX package's
sketch_file, and the counters `sketch_native` / `sketch_fallback`.
Tolerance: exact.  Files are synthetic and small.
"""
import gzip
import os

import numpy as np
import pytest
import torch

from skani_tpu_torch import SketchParams, fastx, native, sketch, stats
from skani_tpu_torch.kernels import seeding
from skani_tpu_torch.kernels.seeding import DeviceSeeder

CPU = torch.device("cpu")
_IUPAC = b"ACGTACGTACGTACGTacgtNNnRYKMSWBDHV"
_ARRAYS = ("contig_lengths", "seed_kmers", "seed_starts", "seed_pos",
           "seed_contig", "seed_canon", "marker_seeds")
_FIELDS = ("file_name", "contigs", "total_sequence_length", "marker_c", "c",
           "k", "contig_order", "individual_contig", "amino_acid")

torch.set_num_threads(1)


def _bases(rng, n, alphabet=b"ACGT"):
    a = np.frombuffer(alphabet, np.uint8)
    return a[rng.integers(0, len(a), size=n)].tobytes()


def _with_n_runs(rng, s: bytes) -> bytes:
    b = bytearray(s)
    for _ in range(max(1, len(b) // 3000)):
        at = int(rng.integers(0, len(b)))
        b[at:at + int(rng.integers(1, 40))] = b"N" * 20 + b"n" * 19
    return bytes(b[:len(s)])


def _lines(s: bytes, width: int, eol: bytes = b"\n") -> bytes:
    return b"".join(s[i:i + width] + eol for i in range(0, len(s), width))


def _draft(seed: int) -> bytes:
    """A random draft: 2-40 contigs of 100 bp to 60 kb, IUPAC letters and
    lowercase, N and n runs, wrapped at 60-80 with a blank line here and
    there."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(int(rng.integers(2, 40))):
        s = _with_n_runs(rng, _bases(rng, int(rng.integers(100, 60_000)),
                                     _IUPAC))
        body = _lines(s, int(rng.integers(60, 81)))
        if rng.random() < 0.3:
            body += b"\n"
        out.append(b">contig_%d len=%d\n" % (i, len(s)) + body)
    return b"".join(out)


def _case(name: str) -> bytes:
    rng = np.random.default_rng(sum(map(ord, name)))
    g = lambda n: _bases(rng, n)  # noqa: E731
    if name.startswith("draft"):
        return _draft(int(name[5:]))
    if name == "one_line":
        return b">chromosome one line\n" + g(300_000) + b"\n"
    if name == "crlf_blank":
        return (b">a\r\n" + _lines(g(5000), 70, b"\r\n") + b"\r\n\r\n"
                + b">b \r\r\n" + _lines(g(3000), 61, b"\r\n")
                + b">c\n" + g(800) + b"\r" + g(900) + b"\n\n\n")
    if name == "no_final_newline":
        return b">x\n" + _lines(g(4000), 60) + b">y\n" + g(2500)
    if name == "header_only":
        return (b">empty one\n>full\n" + _lines(g(3000), 80) + b">\n"
                + b">tail header only")
    if name == "short_contigs":
        return b"".join(b">s%d\n" % n + _lines(g(n), 60)
                        for n in (100, 499, 500, 501, 999, 1000, 4000))
    if name == "all_short":
        return b">a\n" + g(400) + b"\n>b\n" + g(499) + b"\n"
    if name == "all_n":
        return b">n\n" + b"N" * 5000 + b"\n>acgt\n" + g(600) + b"\n"
    if name == "odd_headers":
        return (b">\xff\xfe bad utf8\n" + g(2000) + b"\n>tab\there >x\n"
                + g(1500) + b">not a record\n" + g(700) + b"\n")
    if name == "empty":
        return b""
    if name == "bad_first_byte":
        return b"ACGT\n>x\n" + g(2000) + b"\n"
    if name == "fastq":
        s = g(1200)
        return b"@r1\n" + s + b"\n+\n" + b"I" * 1200 + b"\n"
    raise KeyError(name)


PARSE_CASES = ["draft0", "draft1", "draft2", "one_line", "crlf_blank",
               "no_final_newline", "header_only", "short_contigs",
               "all_short", "all_n", "odd_headers"]
FILE_CASES = PARSE_CASES + ["empty", "bad_first_byte", "gzip", "fastq"]


def _write(d, name: str) -> str:
    if name == "gzip":
        p = os.path.join(str(d), "gzip.fa.gz")
        with open(p, "wb") as f:
            f.write(gzip.compress(_case("draft3")))
        return p
    p = os.path.join(str(d), name + ".fa")
    with open(p, "wb") as f:
        f.write(_case(name))
    return p


def _same(got, want, what=""):
    if want is None:
        assert got is None, what
        return
    for f in _FIELDS:
        assert getattr(got, f) == getattr(want, f), (what, f)
    for f in _ARRAYS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, (what, f, a.dtype, b.dtype)
        assert a.shape == b.shape, (what, f, a.shape, b.shape)
        assert np.array_equal(a, b), (what, f)


def _python_path(monkeypatch):
    """The Python path with the native seeder: the pass's library absent."""
    monkeypatch.setattr(native, "sketch_lib", lambda: None)


def _delta(before, key):
    return stats.snapshot().get(key, 0.0) - before.get(key, 0.0)


@pytest.mark.parametrize("name", PARSE_CASES)
def test_parse_matches_iter_fasta(name):
    """Every record (min_len 0 keeps them all): the header, the bases
    and their order, byte for byte."""
    data = _case(name)
    want = list(fastx._iter_fasta(data))
    rec, bases = native.parse_fasta_native(data, 0)
    assert len(rec) == len(want)
    for (h0, hn, b0, bn), (name_w, seq_w) in zip(rec.tolist(), want):
        assert data[h0:h0 + hn].decode("utf-8", "replace") == name_w
        assert bases[b0:b0 + bn].tobytes() == seq_w.tobytes()
    kept, _b = native.parse_fasta_native(data, sketch.MIN_LENGTH_CONTIG)
    assert kept[:, 3].tolist() == [len(s) for _n, s in want
                                   if len(s) >= sketch.MIN_LENGTH_CONTIG]


@pytest.mark.parametrize("seed", [True, False])
@pytest.mark.parametrize("name", FILE_CASES)
def test_host_route_matches_python_path(tmp_path, monkeypatch, name, seed):
    """sketch_file under the native seeder: the native pass's Sketch equals
    the Python path's in every field; invalid and all-short files give
    None on both."""
    p = _write(tmp_path, name)
    sp = SketchParams()
    host = native.fmh_seeds_native
    before = stats.snapshot()
    got = sketch.sketch_file(p, sp, seed=seed, seeder=host)
    native_files = _delta(before, "sketch_native")
    with monkeypatch.context() as m:
        _python_path(m)
        want = sketch.sketch_file(p, sp, seed=seed, seeder=host)
    _same(got, want, name)
    assert native_files == (got is not None and name != "fastq")
    if got is not None and seed and name != "all_n":
        assert len(got.seed_kmers)
    if got is not None and got.total_sequence_length > 50_000:
        assert len(got.marker_seeds)


@pytest.mark.parametrize("k,c", [(15, 125), (16, 30), (12, 5)])
def test_host_route_params(tmp_path, monkeypatch, k, c):
    """Other presets, down to c 5 at k 12, where k-mers repeat across and
    within contigs (the stable sort keeps their encounter order)."""
    p = _write(tmp_path, "draft4")
    sp = SketchParams(c=c, k=k)
    got = sketch.sketch_file(p, sp, seeder=native.fmh_seeds_native)
    with monkeypatch.context() as m:
        _python_path(m)
        want = sketch.sketch_file(p, sp, seeder=native.fmh_seeds_native)
    _same(got, want)
    assert (np.diff(got.seed_starts) > 1).any()


@pytest.mark.parametrize("seed", [True, False])
@pytest.mark.parametrize("n,pool", [(0, 1), (1, 1), (5000, 7),
                                    (20000, 1 << 32), (3000, 300)])
def test_assemble_matches_finalize(n, pool, seed):
    """skt_sketch_assemble on random streams (k-mers from a pool of
    `pool` values, u32 values past 2^31, runs empty contigs among them)
    against _finalize_sketch on the same streams split by contig."""
    rng = np.random.default_rng(n + pool)
    kmers = rng.integers(0, pool, size=n, dtype=np.uint64).astype(np.uint32)
    if pool > 1 << 31:
        kmers[: n // 2] |= np.uint32(1 << 31)
    pos = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    canon = rng.random(n) < 0.5
    cuts = np.sort(rng.integers(0, n + 1, size=6))
    offs = np.concatenate([[0], cuts, [n]]).astype(np.int64)
    markers = rng.integers(0, 1 << 42, size=n // 8, dtype=np.uint64)
    markers = np.concatenate([markers, markers[: n // 16]])
    got = sketch.Sketch()
    sketch._put(got, *native.sketch_assemble_native(
        kmers, pos, canon, offs, markers, seed))
    want = sketch.Sketch()
    parts = ([], [], [], [], [markers] if len(markers) else [])
    for j in range(len(offs) - 1):
        a, b = offs[j], offs[j + 1]
        if seed and b > a:
            parts[0].append(kmers[a:b])
            parts[1].append(pos[a:b])
            parts[2].append(canon[a:b])
            parts[3].append(np.full(b - a, j, dtype=np.uint32))
    sketch._finalize_sketch(want, *parts)
    _same(got, want)


@pytest.fixture(scope="module")
def file_set(tmp_path_factory):
    d = tmp_path_factory.mktemp("sketch_native_set")
    names = ["draft5", "gzip", "empty", "one_line", "crlf_blank",
             "all_short", "draft6", "header_only", "bad_first_byte",
             "short_contigs"]
    return [_write(d, n) for n in names]


@pytest.mark.parametrize("seed", [True, False])
def test_assemble_on_plain_batch_outputs(file_set, seed):
    """The device route's assemble entry on each file's slice of the plain
    batch's flat outputs (one batch for the whole set) equals
    _finalize_sketch on the same batch split by contig."""
    sp = SketchParams()
    reads = [sketch._read_file(p, sp, True) for p in file_set]
    reads = [r for r in reads if r is not None]
    seqs = [s for r in reads for _j, s in r[1]]
    kmers, pos, canon, markers, so, mo = seeding.fmh_seeds_device_flat(
        seqs, sp, device="cpu")
    per = seeding.fmh_seeds_device_batch(seqs, sp, device="cpu")
    b = 0
    for sk, contigs, _flat in reads:
        b1 = b + len(contigs)
        got = sketch.Sketch(file_name=sk.file_name)
        sketch._put(got, *native.sketch_assemble_native(
            kmers[so[b]:so[b1]], pos[so[b]:so[b1]], canon[so[b]:so[b1]],
            so[b:b1 + 1] - so[b], markers[mo[b]:mo[b1]], seed))
        want = sketch.Sketch(file_name=sk.file_name)
        sketch._finalize_sketch(want, *sketch._seed_parts(
            contigs, per[b:b1], seed))
        _same(got, want, sk.file_name)
        b = b1
    assert b == len(seqs)


@pytest.mark.parametrize("window_bases", [sketch.DEVICE_SEED_WINDOW_BASES,
                                          100_000])
def test_device_route_matches_host_and_python(file_set, monkeypatch,
                                              window_bases):
    """_device_windows under DeviceSeeder(CPU) (the native pass) equals the
    native host route and the Python path of both routes, sketch for
    sketch; every valid file counts as `sketch_native`."""
    sp = SketchParams()
    dev_seeder = DeviceSeeder(CPU)
    before = stats.snapshot()
    dev = [sk for w in sketch._device_windows(file_set, sp, True, dev_seeder,
                                              None, 2, window_bases)
           for _pi, sk in w]
    assert _delta(before, "sketch_native") == len(dev) == 7
    assert _delta(before, "sketch_fallback") == 0
    host = [sketch.sketch_file(p, sp, seeder=native.fmh_seeds_native)
            for p in file_set]
    host = [s for s in host if s is not None]
    with monkeypatch.context() as m:
        _python_path(m)
        py_dev = [sk for w in sketch._device_windows(
            file_set, sp, True, dev_seeder, None, 2, window_bases)
            for _pi, sk in w]
        py_host = sketch.fastx_to_sketches(file_set, sp, threads=2)
    assert [s.file_name for s in dev] == [s.file_name for s in host]
    for a, b, c in zip(dev, host, py_dev):
        _same(a, b)
        _same(a, c)
    _same_sets(sorted(dev, key=sketch.Sketch.sort_key), py_host)


def _same_sets(got, want):
    assert [s.file_name for s in got] == [s.file_name for s in want]
    for a, b in zip(got, want):
        _same(a, b)


def test_native_pass_matches_jax_sketch_file(file_set):
    """Three files through the native pass against the JAX package's
    sketch_file."""
    from skani_tpu import sketch as jax_sketch
    from skani_tpu.params import SketchParams as JaxSketchParams
    for p in (file_set[0], file_set[1], file_set[4]):
        got = sketch.sketch_file(p, SketchParams(),
                                 seeder=native.fmh_seeds_native)
        want = jax_sketch.sketch_file(p, JaxSketchParams())
        _same(got, want, p)


def _aa_file(d):
    p = os.path.join(str(d), "aa.fa")
    rng = np.random.default_rng(9)
    with open(p, "wb") as f:
        f.write(b">prot\n" + _bases(rng, 3000, b"ACDEFGHIKLMNPQRSTVWY")
                + b"\n")
    return p


@pytest.mark.parametrize("how,path_kind", [
    ("native", "native"), ("device_batch", "native"),
    ("aa", "fallback"), ("np_seeder", "fallback"),
    ("plain_seeder", "fallback"), ("no_library", "fallback"),
    ("fastq", "fallback"), ("individual", "fallback")])
def test_counters_split(tmp_path, monkeypatch, how, path_kind):
    """Each file sketched adds one to `sketch_native` on the native pass
    and to `sketch_fallback` on the Python path: AA, a caller's own
    per-contig seeder, a missing library, FASTQ and -i take the latter."""
    p = _write(tmp_path, "fastq" if how == "fastq" else "draft7")
    sp = SketchParams()
    seeder = native.fmh_seeds_native
    if how == "aa":
        sp, p = SketchParams(c=200, k=10, use_aa=True), _aa_file(tmp_path)
        seeder = None
    elif how == "np_seeder":
        seeder = sketch.fmh_seeds_np
    elif how == "plain_seeder":
        seeder = seeding.fmh_seeds_plain
    elif how == "device_batch":
        seeder = DeviceSeeder(CPU)
    elif how == "no_library":
        _python_path(monkeypatch)
    before = stats.snapshot()
    if how == "individual":
        sks = sketch.fastx_to_multiple_sketch_rewrite([p, p], sp)
    else:
        sks = sketch.fastx_to_sketches([p, p], sp, seeder=seeder, threads=2)
    assert len(sks) >= 2
    other = "fallback" if path_kind == "native" else "native"
    assert _delta(before, "sketch_" + path_kind) == 2
    assert _delta(before, "sketch_" + other) == 0
    line = stats.driver_report("t", 1.0, before)
    assert (f"sketch[native={2 if path_kind == 'native' else 0} "
            f"fallback={0 if path_kind == 'native' else 2}]") in line

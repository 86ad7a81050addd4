"""The port's sketch persistence (skani_tpu_torch/db.py) against the JAX
package's db.py, on synthetic genomes (the fixtures of
tests/test_db_corruption.py are not needed here).

The two packages sketch the same FASTA files; every `.sketch` blob, every
markers.bin and every consolidated database the port writes must be the
JAX package's bytes, and each side must read back what the other wrote,
field for field.  The corruption cases of tests/test_db_corruption.py run
on a synthetic database: truncations and bit flips anywhere, and garbage
`.sketch` files, raise CorruptDbError and nothing else.
"""
import dataclasses
import os
import shutil
import struct

import numpy as np
import pytest

from skani_tpu import db as jax_db
from skani_tpu import params as jax_params
from skani_tpu import sketch as jax_sketch
from skani_tpu_torch import db, stats, synth
from skani_tpu_torch.params import SketchParams
from skani_tpu_torch.sketch import Sketch, sketch_file, sketch_file_individual


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """Four related genomes (one in several contigs) and one unrelated,
    as FASTA."""
    d = str(tmp_path_factory.mktemp("torch_db"))
    gs = synth.genome_set(41, 4, 60_000, copies=(2, 3), n_split=1,
                          contigs=(3, 5), rates=(0.005, 0.03))
    gs.append([synth.base_genome(np.random.default_rng(42), 50_000)])
    return d, synth.write_genome_set(d, gs)


def _sketches(paths, individual):
    """(port SketchParams, port sketches, JAX SketchParams, JAX sketches)
    of the same files."""
    sp, jp = SketchParams(), jax_params.SketchParams()
    if individual:
        ours = [s for p in paths for s in sketch_file_individual(p, sp)]
        theirs = [s for p in paths
                  for s in jax_sketch.sketch_file_individual(p, jp)]
    else:
        ours = [sketch_file(p, sp) for p in paths]
        theirs = [jax_sketch.sketch_file(p, jp) for p in paths]
    return sp, ours, jp, theirs


def _fields(sk):
    return {f.name: getattr(sk, f.name) for f in dataclasses.fields(sk)}


def _assert_same_sketch(a, b):
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], np.ndarray):
            assert fa[k].dtype == np.asarray(fb[k]).dtype, k
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
        else:
            assert fa[k] == fb[k], k


@pytest.mark.parametrize("markers_only", [False, True])
@pytest.mark.parametrize("individual", [False, True])
def test_serialize_sketch_bytes_match_jax(genomes, individual, markers_only):
    _d, paths = genomes
    sp, ours, jp, theirs = _sketches(paths, individual)
    assert len(ours) == len(theirs) > len(paths) * individual
    for a, b in zip(ours, theirs):
        assert db.serialize_sketch(sp, a, markers_only) \
            == jax_db.serialize_sketch(jp, b, markers_only)


@pytest.mark.parametrize("individual", [False, True])
def test_sketch_file_round_trip_exact(genomes, tmp_path, individual):
    """write -> read is exact on every field, in the port and across the
    two packages in both directions."""
    _d, paths = genomes
    sp, ours, jp, theirs = _sketches(paths, individual)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        mine, other = str(tmp_path / f"{i}.sketch"), \
            str(tmp_path / f"{i}.j.sketch")
        db.write_sketch_file(mine, sp, a)
        jax_db.write_sketch_file(other, jp, b)
        p1, back = db.read_sketch_file(mine)
        assert isinstance(back, Sketch) and p1 == sp
        _assert_same_sketch(back, a)
        _assert_same_sketch(db.read_sketch_file(other)[1], a)
        _assert_same_sketch(jax_db.read_sketch_file(mine)[1], b)
    params, listed = db.sketches_from_sketch(
        [str(tmp_path / f"{i}.sketch") for i in range(len(ours))][::-1]
        + [str(tmp_path / "markers.bin")])
    assert params == sp
    assert [s.file_name for s in listed] == sorted(s.file_name
                                                   for s in ours)


def test_db_writer_reader_markers_and_shards_round_trip(genomes, tmp_path):
    """SketchDbWriter -> SketchDbReader, markers.bin and the shard
    manifest: exact round trips, and the JAX package's bytes."""
    _d, paths = genomes
    sp, ours, jp, theirs = _sketches(paths, False)
    out = {}
    for name, mod, params, sks in (("t", db, sp, ours),
                                   ("j", jax_db, jp, theirs)):
        d = str(tmp_path / name)
        os.makedirs(d)
        w = mod.SketchDbWriter(d)
        for sk in sks:
            w.add_sketch(params, sk)
        w.finalize()
        mod.write_markers_bin(os.path.join(d, "markers.bin"), params,
                              [sk.get_markers_only() for sk in sks])
        mod.write_shard_manifest(d, 3)
        out[name] = d
    for f in ("sketches.db", "index.db", "markers.bin", "shards.json"):
        with open(os.path.join(out["t"], f), "rb") as a, \
                open(os.path.join(out["j"], f), "rb") as b:
            assert a.read() == b.read(), f
    d = out["t"]
    assert db.is_consolidated_db(d) and not db.has_separate_sketches(d)
    r = db.SketchDbReader(d)
    try:
        assert len(r) == len(ours)
        for i, sk in enumerate(ours):
            params, back = r.get_sketch(i)
            assert params == sp
            _assert_same_sketch(back, sk)
    finally:
        r.close()
    params, markers = db.read_markers_bin(os.path.join(d, "markers.bin"))
    assert params == sp
    for m, sk in zip(markers, ours):
        _assert_same_sketch(m, sk.get_markers_only())
    assert db.read_shard_manifest(d) == {
        "version": 1, "n_shards": 3, "n_genomes": len(ours),
        "assignment": "round_robin"}
    assert db.read_shard_manifest(str(tmp_path)) is None
    assert db.shard_indices(len(ours), 3, 1) == list(range(1, len(ours), 3))
    assert db.shard_indices(len(ours), 0, 0) == []


def test_legacy_reader_matches_jax(genomes, tmp_path):
    """A pre-v0.3 layout (seeds inline per k-mer, no individual_contig),
    written by hand from a sketch: both readers give the same sketch."""
    _d, paths = genomes
    sp, ours, _jp, _t = _sketches(paths[:1], False)
    sk = ours[0]
    w = db._Writer()
    db._write_sketch_params(w, sp)
    w.string(sk.file_name)
    w.u8(1)
    w.u64(len(sk.seed_kmers))
    for i, k in enumerate(sk.seed_kmers):
        lo, hi = sk.seed_starts[i], sk.seed_starts[i + 1]
        w.raw(struct.pack("<I", int(k)))
        w.u64(int(hi - lo))
        for j in range(lo, hi):
            w.raw(struct.pack("<IBIB", int(sk.seed_pos[j]),
                              int(sk.seed_canon[j]),
                              int(sk.seed_contig[j]), 0))
    w.u64(len(sk.contigs))
    for c in sk.contigs:
        w.string(c)
    w.u64(sk.total_sequence_length)
    w.u64(len(sk.contig_lengths))
    w.raw(np.asarray(sk.contig_lengths, "<u4").tobytes())
    w.u64(0)
    w.u64(len(sk.marker_seeds))
    w.raw(np.asarray(sk.marker_seeds, "<u8").tobytes())
    for v in (sk.marker_c, sk.c, sk.k, sk.contig_order):
        w.u64(v)
    w.u8(0)
    path = str(tmp_path / "legacy.sketch")
    with open(path, "wb") as f:
        f.write(w.getvalue())
    params, got = db.read_sketch_file_legacy(path)
    _jp2, want = jax_db.read_sketch_file_legacy(path)
    assert params == sp
    for k in ("seed_kmers", "seed_starts", "seed_pos", "seed_contig",
              "seed_canon", "marker_seeds", "contig_lengths"):
        np.testing.assert_array_equal(getattr(got, k), getattr(sk, k))
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.contigs == sk.contigs == want.contigs


# --- corruption: the cases of tests/test_db_corruption.py on a synthetic
# database ---

@pytest.fixture(scope="module")
def small_db(genomes, tmp_path_factory):
    _d, paths = genomes
    d = str(tmp_path_factory.mktemp("torch_cdb"))
    sp = SketchParams()
    sks = [sketch_file(paths[0], sp)] + sketch_file_individual(paths[1], sp)
    w = db.SketchDbWriter(d)
    for sk in sks:
        w.add_sketch(sp, sk)
    w.finalize()
    db.write_markers_bin(os.path.join(d, "markers.bin"), sp,
                         [sk.get_markers_only() for sk in sks])
    return d


def _read_everything(d):
    """Full read path over a database directory."""
    _params, markers = db.read_markers_bin(os.path.join(d, "markers.bin"))
    r = db.SketchDbReader(d)
    try:
        for i in range(len(r)):
            r.get_sketch(i)
    finally:
        r.close()
    return len(markers)


def test_intact_db_reads(small_db):
    assert _read_everything(small_db) >= 2


@pytest.mark.parametrize("victim", ["markers.bin", "index.db",
                                    "sketches.db"])
def test_truncation_is_clean(small_db, tmp_path, victim):
    d = str(tmp_path / "t")
    shutil.copytree(small_db, d)
    path = os.path.join(d, victim)
    size = os.path.getsize(path)
    n_corrupt = 0
    for frac in (0.0, 0.1, 0.5, 0.9, 0.99):
        with open(os.path.join(small_db, victim), "rb") as f:
            data = f.read(int(size * frac))
        with open(path, "wb") as f:
            f.write(data)
        try:
            _read_everything(d)
        except db.CorruptDbError:
            n_corrupt += 1
        # any other exception type propagates and fails the test
    assert n_corrupt > 0


def test_bitflip_fuzz(small_db, tmp_path):
    """One random bit flipped anywhere in any DB file: the read path must
    either still parse (the flip hit payload data) or raise CorruptDbError
    — never leak a low-level exception."""
    d = str(tmp_path / "f")
    shutil.copytree(small_db, d)
    rng = np.random.default_rng(7)
    files = ["markers.bin", "index.db", "sketches.db"]
    originals = {}
    for name in files:
        with open(os.path.join(small_db, name), "rb") as f:
            originals[name] = bytearray(f.read())
    n_corrupt = 0
    for _ in range(120):
        name = files[int(rng.integers(len(files)))]
        data = bytearray(originals[name])
        bit = int(rng.integers(len(data) * 8))
        data[bit // 8] ^= 1 << (bit % 8)
        with open(os.path.join(d, name), "wb") as f:
            f.write(bytes(data))
        try:
            _read_everything(d)
        except db.CorruptDbError:
            n_corrupt += 1
        finally:
            with open(os.path.join(d, name), "wb") as f:
                f.write(bytes(originals[name]))
    assert n_corrupt > 0


def test_garbage_sketch_file(genomes, tmp_path):
    _d, paths = genomes
    p = str(tmp_path / "junk.sketch")
    with open(p, "wb") as f:
        f.write(np.random.default_rng(0).integers(
            0, 255, 4096, dtype=np.uint8).tobytes())
    with pytest.raises(db.CorruptDbError):
        db.read_sketch_file(p)
    with pytest.raises(db.CorruptDbError):
        db.sketches_from_sketch([p])
    # a fasta is not a sketch either
    with pytest.raises(db.CorruptDbError):
        db.read_sketch_file(paths[0])


# --- markers.bin: the native walk (csrc/markers_bin.cpp) against the Python
# walker and the JAX package ---

def _python_walk(path):
    """The Python walker alone, as read_markers_bin ran before the native
    walk: (params, sketches), or CorruptDbError with its message."""
    with open(path, "rb") as f:
        buf = f.read()
    with db._corrupt_guard(path):
        r = db._Reader(buf)
        params = db._read_sketch_params(r)
        n = r.vec_len(8)
        return params, [db._read_sketch(r) for _ in range(n)]


def _outcome(read, path):
    try:
        return read(path)
    except db.CorruptDbError as e:
        return str(e)


def _read_counted(path):
    """read_markers_bin's result and which walk read the file."""
    base = stats.snapshot()
    params, sks = db.read_markers_bin(path)
    now = stats.snapshot()
    counts = {k: now.get(k, 0.0) - base.get(k, 0.0)
              for k in ("markers_native", "markers_fallback")}
    assert sorted(counts.values()) == [0.0, 1.0], counts
    walk = "native" if counts["markers_native"] else "fallback"
    n_native = int(counts["markers_native"])
    assert (f"markers[native={n_native} fallback={1 - n_native}]"
            in stats.driver_report("search", 1.0, base))
    return params, sks, walk


def _assert_same_read(a, b):
    (pa, sa), (pb, sb) = a, b
    _assert_same_sketch(pa, pb)     # any dataclass, field for field
    assert len(sa) == len(sb)
    for x, y in zip(sa, sb):
        _assert_same_sketch(x, y)


def _handmade(path, sketches, params=None, markers_only=True):
    """A markers.bin written through db._Writer, the markers as given."""
    w = db._Writer()
    db._write_sketch_params(w, params or SketchParams())
    w.u64(len(sketches))
    for sk in sketches:
        db._write_sketch(w, sk, markers_only=markers_only)
    with open(path, "wb") as f:
        f.write(w.getvalue())


def _stub(name, markers, contigs=("c1",), **kw):
    return Sketch(file_name=name, contigs=list(contigs),
                  total_sequence_length=12345,
                  marker_seeds=np.asarray(markers, dtype=np.uint64),
                  marker_c=1000, c=125, k=15, contig_order=3, **kw)


def _write_case(case, genomes, path):
    """Writes case `case`; returns the walk that must read it."""
    rng = np.random.default_rng(11)
    if case in ("port", "jax", "no_library"):
        _d, paths = genomes
        sp, ours, jp, theirs = _sketches(paths, True)
        if case == "jax":
            jax_db.write_markers_bin(path, jp,
                                     [s.get_markers_only() for s in theirs])
        else:
            db.write_markers_bin(path, sp,
                                 [s.get_markers_only() for s in ours])
        return "fallback" if case == "no_library" else "native"
    if case == "unsorted_duplicates":
        big = rng.integers(0, 2**64 - 1, 5000, dtype=np.uint64)
        _handmade(path, [
            _stub("a.fa", [9, 3, 3, 2**64 - 1, 0, 3]),
            _stub("b.fa", np.concatenate([big, big[:700]])),
            _stub("c.fa", np.sort(big))])
        return "native"
    if case == "non_ascii_name":
        _handmade(path, [_stub("Escherichia coli Ü 大肠杆菌.fa", [1, 2],
                               contigs=["ctg ä", "κ 1"]),
                         _stub("b.fa", [3])])
        return "native"
    if case == "no_contigs":
        _handmade(path, [_stub("a.fa", [4, 5], contigs=()),
                         _stub("b.fa", [6], individual_contig=True,
                               amino_acid=True)])
        return "native"
    if case == "zero_sketches":
        _handmade(path, [])
        return "native"
    if case == "no_markers":
        _handmade(path, [_stub("a.fa", [])])
        return "native"
    if case == "newline_name":
        _handmade(path, [_stub("a.fa", [1]),
                         _stub("b.fa", [2], contigs=["x\ny", "z"])])
        return "fallback"
    if case == "seeds_set":
        _d, paths = genomes
        sp, ours, _jp, _t = _sketches(paths[:2], False)
        _handmade(path, ours, sp, markers_only=False)
        return "fallback"
    if case == "contig_lengths":
        _handmade(path, [_stub("a.fa", [7, 1], contigs=["c1", "c2"],
                               contig_lengths=np.array([5, 9], np.uint32))],
                  markers_only=False)
        return "fallback"
    raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "port", "jax", "unsorted_duplicates", "non_ascii_name", "no_contigs",
    "zero_sketches", "no_markers", "newline_name", "seeds_set",
    "contig_lengths", "no_library"])
def test_markers_native_matches_python_walker(genomes, tmp_path,
                                              monkeypatch, case):
    """read_markers_bin equals the Python walker and the JAX package's
    reader field for field, and the input decides the walk."""
    path = str(tmp_path / "markers.bin")
    want_walk = _write_case(case, genomes, path)
    if case == "no_library":
        monkeypatch.setattr(db.native, "markers_lib", lambda: None)
    params, sks, walk = _read_counted(path)
    assert walk == want_walk
    _assert_same_read((params, sks), _python_walk(path))
    _assert_same_read((params, sks), jax_db.read_markers_bin(path))
    for sk in sks:
        m = sk.marker_seeds
        assert m.dtype == np.uint64 and m.flags.aligned
        assert np.all(m[1:] >= m[:-1])


@pytest.mark.parametrize("mutation", ["truncate", "bitflip"])
def test_markers_native_error_parity(small_db, tmp_path, mutation):
    """Every truncation (at a stride) and 300 seeded single-bit flips of a
    markers.bin: both walks give equal sketches, or both raise
    CorruptDbError with the same message."""
    with open(os.path.join(small_db, "markers.bin"), "rb") as f:
        original = f.read()
    path = str(tmp_path / "markers.bin")
    if mutation == "truncate":
        stride = max(1, len(original) // 400)
        variants = [original[:n] for n in range(0, len(original), stride)]
    else:
        rng = np.random.default_rng(20)
        variants = []
        for _ in range(300):
            data = bytearray(original)
            bit = int(rng.integers(len(data) * 8))
            data[bit // 8] ^= 1 << (bit % 8)
            variants.append(bytes(data))
    n_errors = n_equal = 0
    for data in variants:
        with open(path, "wb") as f:
            f.write(data)
        got = _outcome(db.read_markers_bin, path)
        want = _outcome(_python_walk, path)
        if isinstance(want, str):
            assert got == want
            n_errors += 1
        else:
            assert not isinstance(got, str), got
            _assert_same_read(got, want)
            n_equal += 1
    assert n_errors > 0
    assert n_equal > 0 or mutation == "truncate"

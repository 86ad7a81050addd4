"""CPU tests of the benchmark's plain reference: its torch seeder and its
frozen NumPy pipeline against the program's host path, and its answers on
a tiny job against known ANI ranges."""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import genomes  # noqa: E402
from benchmark.reference import ani as ref_ani  # noqa: E402
from benchmark.reference import pipeline as refp  # noqa: E402
from benchmark.reference import sketch as refsk  # noqa: E402

CFG = {"genome": {"repeat_len": 1500, "repeat_copies": [2, 4, 8, 20],
                  "min_contig": 1000}}


def _pair(seed, length, rate, n_contigs):
    base = genomes.species_base(CFG["genome"], seed, length)
    other = genomes.derive(seed + 1, base, rate, n_contigs, 1000)
    return [base], other


def _both_sketches(name, parts):
    from skani_tpu_torch import SketchParams, synth
    names = [f"{name}_c{j}" for j in range(len(parts))]
    prog = synth.sketch_parts(parts, SketchParams(), name)
    ref = refsk.sketch_contigs(name, names, parts, 15, 125, 1000, "cpu")
    return prog, ref


def test_torch_seeder_matches_the_programs_numpy_seeder():
    from skani_tpu_torch import SketchParams
    from skani_tpu_torch.sketch import fmh_seeds_np
    rng = np.random.default_rng(3)
    s = genomes.BASES[rng.integers(0, 4, 120_000)]
    s[500:530] = ord("N")
    s[7000] = ord("n")
    s[9000:9004] = np.frombuffer(b"acgt", np.uint8)
    want = fmh_seeds_np(s, SketchParams())
    km, pos, ca, _ctg, ma = refsk.seeds_of_contigs([s], 15, 125, 1000,
                                                   "cpu")
    got = (km, pos, ca, ma)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and np.array_equal(w, g)
    assert len(got[0]) > 500 and len(got[3]) > 50


def test_one_pass_over_contigs_equals_one_contig_at_a_time():
    from skani_tpu_torch import SketchParams
    from skani_tpu_torch.sketch import fmh_seeds_np
    rng = np.random.default_rng(4)
    contigs = [genomes.BASES[rng.integers(0, 4, n)]
               for n in (5000, 41, 42, 900, 20_000, 60)]
    contigs[0][3] = ord("N")             # before index 20: not counted
    contigs[3][25] = ord("n")
    contigs[4][30:34] = ord("N")
    contigs[4][19_990] = ord("N")
    got = refsk.seeds_of_contigs(contigs, 15, 125, 1000, "cpu")
    want = [np.concatenate(x) for x in zip(*[
        fmh_seeds_np(q, SketchParams()) + (np.full(
            len(fmh_seeds_np(q, SketchParams())[0]), j, np.uint32),)
        for j, q in enumerate(contigs)])]
    want = [want[0], want[1], want[2], want[4], want[3]]
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and np.array_equal(w, g)
    assert len(set(got[3].tolist())) == 4 and len(got[4]) > 0


@pytest.mark.parametrize("rate,n_contigs", [(0.01, 1), (0.03, 60),
                                            (0.12, 3)])
def test_reference_pair_equals_the_programs_host_path(rate, n_contigs):
    from skani_tpu_torch import CommandParams, gbdt
    from skani_tpu_torch.ani import chain_seeds_native, chain_seeds_numpy
    from skani_tpu_torch.params import map_params_from_sketch
    a, b = _pair(11, 300_000, rate, n_contigs)
    pa, ra = _both_sketches("a", a)
    pb, rb = _both_sketches("b", b)
    assert refsk.same_sketch(pa, ra) and refsk.same_sketch(pb, rb)
    cp = CommandParams(learned_ani=True)
    mp = map_params_from_sketch(pa, False, cp, gbdt.get_model(125, True))
    want_np = chain_seeds_numpy(pa, pb, mp)
    want_native = chain_seeds_native(pa, pb, mp)
    got = refp.score(ra, rb, refp.command_params())
    assert refp.same_result(got, want_np)
    assert refp.same_result(got, want_native)
    assert refp.tsv_row(got).split("\t")[2:5] == [
        f"{x:.2f}" for x in (np.float32(want_native.ani) * np.float32(100),
                             np.float32(want_native.align_fraction_ref)
                             * np.float32(100),
                             np.float32(want_native.align_fraction_query)
                             * np.float32(100))]


def test_bootstrap_sums_in_skanis_order():
    from skani_tpu_torch import native
    rng = np.random.default_rng(5)
    for n in (9, 10, 57, 400):
        ests = [(float(a), int(m)) for a, m in
                zip(rng.uniform(0.9, 1.0, n), rng.integers(1, 60, n))]
        lo, hi, std = ref_ani.bootstrap_interval(ests)
        c = native.bootstrap_ci_native(np.array([a for a, _ in ests]),
                                       np.array([m for _, m in ests]))
        assert (lo, hi, std) == (float(c[0]), float(c[1]), float(c[2]))


def test_reference_on_a_tiny_job_reads_known_ranges():
    cfg = {"genome": dict(CFG["genome"], length_min=200_000,
                          length_max=200_000)}
    base = genomes.species_base(cfg["genome"], 21, 200_000)
    other = genomes.species_base(cfg["genome"], 22, 200_000)
    sks = []
    for i, (src, rate) in enumerate([(base, 0.004), (base, 0.02),
                                     (base, 0.04), (other, 0.01)]):
        parts = genomes.derive(100 + i, src, rate, 1, 1000)
        sks.append(refsk.sketch_contigs(f"g{i}", [f"g{i}_c0"], parts, 15,
                                        125, 1000, "cpu"))
    cp = refp.command_params()
    # strains redrawn at rate r differ by about 3/4 r from the base
    for j, lo, hi in ((1, 0.97, 0.995), (2, 0.95, 0.985)):
        assert refp.triangle_screen(sks[0], sks[j], 0.8, True)
        r = refp.score(sks[0], sks[j], cp)
        assert lo < r.ani < hi and r.align_fraction_query > 0.9
        assert r.ci_lower <= r.ani <= r.ci_upper
    # another species: random sequence, screened out
    assert not refp.triangle_screen(sks[0], sks[3], 0.8, True)
    assert not refp.search_screen(sks[3], sks[0], 0.8)

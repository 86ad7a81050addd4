"""The reference's answers for one pair: the screen's verdict, the scored
result and the TSV row, from sketches that the reference made itself.

Everything here is NumPy (the frozen copies beside this file) over
RefSketch; it imports nothing of the program.
"""
from __future__ import annotations

import numpy as np

from . import gbdt
from .ani import AniEstResult, chain_seeds_numpy
from .params import (D_FRAC_COVER_CUTOFF, K_MARKER_DNA, CommandParams,
                     map_params_from_sketch)
from .screen import check_markers_quickly

#: the result fields compared pair by pair
RESULT_FIELDS = ("ani", "align_fraction_query", "align_fraction_ref",
                 "ci_lower", "ci_upper")


def triangle_screen(query, ref, identity: float, rescue_small: bool) -> bool:
    """skani triangle's marker screen of row `query` against `ref`
    (reference: src/screen.rs:148-189): more shared markers than
    max(int(identity^21 * min(marker counts)), 1), every pair passing
    where the query has fewer than 20 markers and small genomes are
    rescued."""
    if len(query.marker_seeds) < 20 and rescue_small:
        return True
    shared = len(np.intersect1d(query.marker_seeds, ref.marker_seeds,
                                assume_unique=True))
    cut = max(int(identity ** K_MARKER_DNA
                  * min(len(ref.marker_seeds), len(query.marker_seeds))), 1)
    return shared > cut


def search_screen(query, ref, identity: float) -> bool:
    """skani search's pairwise marker screen (reference:
    src/screen.rs:84-142), no rescue."""
    return check_markers_quickly(query, ref, identity, False)


def command_params(min_aligned_frac: float = D_FRAC_COVER_CUTOFF / 100.0,
                   learned_ani: bool = True) -> CommandParams:
    """skani's command parameters at its defaults (both-AF cutoff off)."""
    return CommandParams(min_aligned_frac=min_aligned_frac,
                         both_min_aligned_frac=-0.01,
                         learned_ani=learned_ani)


def score(ref, query, cp: CommandParams, ftype=np.float64) -> AniEstResult:
    """One pair through anchors, chaining, the estimator (in `ftype`) and,
    where cp.learned_ani, the c 125 regression."""
    model = gbdt.get_model(int(ref.c), cp.learned_ani)
    mp = map_params_from_sketch(ref, False, cp, model)
    return chain_seeds_numpy(ref, query, mp, ftype)


def _f32(x) -> np.float32:
    return np.float32(x)


def tsv_row(r: AniEstResult) -> str:
    """skani's TSV row of a result without --ci or --detailed (reference:
    src/file_io.rs:83-139), a frozen copy of the program's writer."""
    ani = float(_f32(r.ani) * _f32(100.0))
    af_r = float(_f32(r.align_fraction_ref) * _f32(100.0))
    af_q = float(_f32(r.align_fraction_query) * _f32(100.0))
    return (f"{r.ref_file}\t{r.query_file}\t{ani:.2f}\t{af_r:.2f}\t"
            f"{af_q:.2f}\t{r.ref_contig}\t{r.query_contig}")


def written(r: AniEstResult) -> bool:
    """Whether a writer prints the result: not gated off (-1), not NaN."""
    return not (r.ani == -1.0 or np.isnan(r.ani))


def same_result(a, b) -> bool:
    """Whether two results agree in every field of RESULT_FIELDS (NaN
    equal to NaN)."""
    for f in RESULT_FIELDS:
        x, y = float(getattr(a, f)), float(getattr(b, f))
        if not (x == y or (np.isnan(x) and np.isnan(y))):
            return False
    return True

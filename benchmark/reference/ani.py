"""ANI/AF estimation from chains + bootstrap CI + result assembly.

A frozen copy of the port's NumPy estimator (skani_tpu_torch/ani.py),
kept here so that no change to the program moves the benchmark's
reference; the bootstrap sums run in sequence as skani's loops do, and
every estimate takes a float type (float64 as skani computes; the
benchmark's control runs float32).

Exact transcription of the reference estimator (reference:
src/chain.rs:173-555 calculate_ani, src/chain.rs:57-86 bootstrap_interval).
Dead code in the reference (the `extend = 0` spacing estimates,
src/chain.rs:294-321) is elided: spacing is always 0 there.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .chain import (AnchorChunks, ChainInterval, chain_anchors_dp,
                    get_anchors, get_chain_intervals,
                    get_nonoverlapping_chains)
from .hashing import fastrand_usize_below_batch
from .params import CHUNK_SIZE_DNA, MapParams

_f32 = np.float32


@dataclasses.dataclass
class AniEstResult:
    """reference: src/types.rs:559-582 (f32 fields kept as np.float32)."""
    ani: float = 0.0
    align_fraction_query: float = 0.0
    align_fraction_ref: float = 0.0
    ref_file: str = ""
    query_file: str = ""
    query_contig: str = ""
    ref_contig: str = ""
    ci_upper: float = 0.0
    ci_lower: float = 0.0
    aai: bool = False
    quant_90_contig_len_q: float = 0.0
    quant_90_contig_len_r: float = 0.0
    quant_50_contig_len_q: float = 0.0
    quant_50_contig_len_r: float = 0.0
    quant_10_contig_len_q: float = 0.0
    quant_10_contig_len_r: float = 0.0
    std: float = 0.0
    num_contigs_q: int = 0
    num_contigs_r: int = 0
    avg_chain_int_len: int = 0
    total_bases_covered: int = 0


def bootstrap_interval(ani_ests: List[tuple], ftype=np.float64) -> tuple:
    """Percentile bootstrap with the reference's seeded PRNG
    (reference: src/chain.rs:57-86; fastrand 1.9 wyrand, seed 7).  Every
    sum runs in sequence (ufunc.accumulate), the order of skani's loops,
    in `ftype` (float64 as skani computes; the control passes float32)."""
    anis = np.array([a for a, _m in ani_ests], dtype=ftype)
    weights = np.array([m for _a, m in ani_ests], dtype=np.int64)
    n = len(anis)
    std = 0.0
    if n > 0:
        mean = np.add.accumulate(anis, dtype=ftype)[-1] / ftype(n)
        d = mean - anis
        std = float(np.sqrt(np.add.accumulate(d * d, dtype=ftype)[-1]
                            / ftype(n)))
    if n < 10:
        return 0.0, 1.0, std
    mult_anis = np.repeat(anis, weights)
    if len(mult_anis) == 0:
        return 0.0, 1.0, std
    iters = 100
    idx = fastrand_usize_below_batch(7, iters * n, len(mult_anis))
    draws = mult_anis[idx.astype(np.int64)].reshape(iters, n)
    sums = np.add.accumulate(draws, axis=1, dtype=ftype)[:, -1]
    res = np.sort(sums / ftype(n))
    return (float(res[iters * 5 // 100 - 1]),
            float(res[iters * 95 // 100 - 1]), std)


def _merge_closed_intervals(ivs: List[tuple]) -> np.ndarray:
    """Union of closed integer intervals -> (n,2) merged array."""
    if not ivs:
        return np.zeros((0, 2), dtype=np.int64)
    arr = np.array(sorted(ivs), dtype=np.int64)
    merged = [list(arr[0])]
    for s, e in arr[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return np.array(merged, dtype=np.int64)


def _count_in_union(positions: np.ndarray, merged: np.ndarray) -> int:
    """#positions falling in the union of closed intervals."""
    if len(positions) == 0 or len(merged) == 0:
        return 0
    pos = positions.astype(np.int64)
    i = np.searchsorted(merged[:, 0], pos, side="right") - 1
    ok = (i >= 0) & (pos <= merged[np.maximum(i, 0), 1])
    return int(ok.sum())


def calculate_ani(int_chunks: List[List[ChainInterval]], ref_sketch,
                  query_sketch, ac: AnchorChunks, map_params: MapParams,
                  switched: bool, ftype=np.float64) -> AniEstResult:
    """reference: src/chain.rs:173-555; the estimates in `ftype`"""
    k = map_params.k
    c = int(ref_sketch.c)
    sensitive_af = c < 200
    ani_ests: List[tuple] = []
    total_query_bases = 0
    total_ref_range = 0
    avg_chain_int_len = 0
    num_chains = 0

    with np.errstate(divide="ignore", invalid="ignore"):
        for i, intervals in enumerate(int_chunks):
            total_anchors = 0
            tbc_query = 0
            trq = [1 << 62, -1]
            ivs = []
            for interval in intervals:
                total_anchors += interval.num_anchors
                q0, q1 = interval.interval_on_query
                if q0 < trq[0]:
                    trq[0] = q0
                if q1 > trq[1]:
                    trq[1] = q1
                if not switched:
                    tbc_query += (q1 - q0) + k + 2 * c
                else:
                    r0, r1 = interval.interval_on_ref
                    tbc_query += (r1 - r0) + k + 2 * c
                ivs.append((max(q0 - c, 0), q1 + c))
                if sensitive_af:
                    add = interval.query_range_len() - interval.overlap \
                        + 2 * c + k
                    total_query_bases += add
                    total_ref_range += add
                avg_chain_int_len += interval.query_range_len() \
                    - interval.overlap + 2 * c + k
                num_chains += 1

            if total_anchors == 0:
                continue
            if trq[1] - trq[0] < map_params.min_length_cover:
                continue
            if not sensitive_af:
                add = trq[1] - trq[0] + 2 * c + k
                total_query_bases += add
                total_ref_range += add

            seeds = ac.seeds_in_chunk[i]
            merged = _merge_closed_intervals(ivs)
            num_seeds_in_intervals = _count_in_union(seeds, merged)
            seeds64 = seeds.astype(np.int64)
            upper_lower_seeds = int(
                ((seeds64 >= trq[0]) & (seeds64 <= trq[1])).sum())

            anchors_considered = len(seeds)
            putative_ani = ftype(total_anchors) / ftype(
                num_seeds_in_intervals)
            putative_ani = np.power(putative_ani, ftype(1.0 / k))
            # putative-ANI denominator switch (reference: src/chain.rs:340-351)
            if (putative_ani > 0.950
                    and tbc_query > c * 4
                    and not map_params.amino_acid
                    and trq[1] - trq[0] < CHUNK_SIZE_DNA * 9 // 10
                    and anchors_considered > 1.05 * upper_lower_seeds):
                anchors_considered = upper_lower_seeds

            if map_params.amino_acid:
                ml_hits = min(ftype(1.0), ftype(total_anchors)
                              / ftype(anchors_considered) * ftype(6.0))
            else:
                ml_hits = min(ftype(1.0), ftype(total_anchors)
                              / ftype(anchors_considered))
            ani_est = float(np.power(ftype(ml_hits), ftype(1.0 / k)))
            if map_params.amino_acid:
                ani_ests.append((ani_est, len(seeds) // 6))
            else:
                ani_ests.append((ani_est, anchors_considered))

    return finalize_ani(ani_ests, total_query_bases, total_ref_range,
                        avg_chain_int_len, num_chains, ref_sketch,
                        query_sketch, map_params,
                        avg_already_divided=False, ftype=ftype)


def finalize_ani(ani_ests: List[tuple], total_query_bases: int,
                 total_ref_range: int, avg_chain_int_len: int,
                 num_chains: int, ref_sketch, query_sketch,
                 map_params: MapParams,
                 avg_already_divided: bool = False,
                 ftype=np.float64) -> AniEstResult:
    """Tail of the reference's calculate_ani (reference: src/chain.rs:414-555):
    trimmed weighted mean, bootstrap CI, AF gates, result assembly."""
    ani_ests = sorted(ani_ests, key=lambda t: (t[0], t[1]))

    if not ani_ests or num_chains == 0:
        ret = AniEstResult()
        ret.ani = float("nan")
        return ret
    if not avg_already_divided:
        avg_chain_int_len //= num_chains

    total_mult = sum(m for _a, m in ani_ests)
    if map_params.median:
        lower, upper = 0.499, 0.501
    elif map_params.robust:
        lower, upper = 0.10, 0.90
    else:
        lower, upper = 0.0, 1.0

    lower_i = 0
    upper_i = len(ani_ests) - 1
    changed_l = False
    curr_sum = 0
    for i, (_a, m) in enumerate(ani_ests):
        curr_sum += m
        if curr_sum >= int(total_mult * lower) and not changed_l:
            lower_i = i
            changed_l = True
        if curr_sum >= int(total_mult * upper):
            upper_i = i + 1
            break

    w_total = 0
    w_avg = ftype(0.0)
    for i in range(lower_i, upper_i):
        w_avg += ftype(ani_ests[i][0]) * ftype(ani_ests[i][1])
        w_total += ani_ests[i][1]
    final_ani = float(w_avg / ftype(w_total)) if w_total else float("nan")

    ci_lo, ci_hi, std = bootstrap_interval(ani_ests, ftype)
    covered_query = float(min(ftype(1.0), ftype(total_query_bases)
                              / ftype(query_sketch.total_sequence_length)))
    covered_ref = float(min(ftype(1.0), ftype(total_ref_range)
                            / ftype(ref_sketch.total_sequence_length)))

    # AF gates (reference: src/chain.rs:500-517)
    if map_params.both_frac_cover_cutoff > 0.0:
        if (covered_query < map_params.both_frac_cover_cutoff
                or covered_ref < map_params.both_frac_cover_cutoff):
            final_ani = -1.0
    elif map_params.amino_acid:
        if (covered_query < map_params.frac_cover_cutoff
                or covered_ref < map_params.frac_cover_cutoff):
            final_ani = -1.0
    elif (covered_query < map_params.frac_cover_cutoff
          and covered_ref < map_params.frac_cover_cutoff):
        final_ani = -1.0

    sorted_q = np.sort(query_sketch.contig_lengths)
    sorted_r = np.sort(ref_sketch.contig_lengths)
    ql, rl = len(sorted_q), len(sorted_r)
    quants_q = [sorted_q[ql * 10 // 100], sorted_q[ql * 50 // 100],
                sorted_q[ql * 90 // 100]]
    quants_r = [sorted_r[rl * 10 // 100], sorted_r[rl * 50 // 100],
                sorted_r[rl * 90 // 100]]

    return AniEstResult(
        ani=float(_f32(final_ani)),
        align_fraction_query=float(_f32(covered_query)),
        align_fraction_ref=float(_f32(covered_ref)),
        ref_file=ref_sketch.file_name,
        query_file=query_sketch.file_name,
        query_contig=query_sketch.contigs[0],
        ref_contig=ref_sketch.contigs[0],
        num_contigs_r=len(ref_sketch.contigs),
        num_contigs_q=len(query_sketch.contigs),
        ci_upper=float(_f32(ci_hi)),
        ci_lower=float(_f32(ci_lo)),
        aai=map_params.amino_acid,
        quant_90_contig_len_q=float(_f32(quants_q[2])),
        quant_90_contig_len_r=float(_f32(quants_r[2])),
        quant_50_contig_len_q=float(_f32(quants_q[1])),
        quant_50_contig_len_r=float(_f32(quants_r[1])),
        quant_10_contig_len_q=float(_f32(quants_q[0])),
        quant_10_contig_len_r=float(_f32(quants_r[0])),
        std=float(_f32(std)),
        avg_chain_int_len=int(avg_chain_int_len),
        total_bases_covered=int(total_query_bases),
    )


def chain_seeds_numpy(ref_sketch, query_sketch, map_params: MapParams,
                      ftype=np.float64) -> AniEstResult:
    """Full per-pair pipeline (reference: src/chain.rs:144-171), its
    estimates in `ftype`."""
    ac, switched = get_anchors(ref_sketch, query_sketch, map_params)
    scores, ptr = chain_anchors_dp(ac, map_params)
    good_intervals = get_chain_intervals(ac, scores, ptr, map_params)
    good_chunks = get_nonoverlapping_chains(good_intervals, ac.n_chunks)
    ani = calculate_ani(good_chunks, ref_sketch, query_sketch, ac,
                        map_params, switched, ftype)
    if map_params.model is not None:
        from .gbdt import predict_from_ani_res
        predict_from_ani_res(ani, map_params.model)
    return ani

"""Anchor generation + sparse chaining — exact host reference path.

Transcribes the reference pipeline (reference: src/chain.rs) into sorted-array
/ vectorized form.  The hashmap probe loop of the reference's get_anchors
(reference: src/chain.rs:608-836) becomes a sort-merge join over the CSR
sketches; the banded chaining DP (reference: src/chain.rs:838-896) becomes a
padded scan over all 20kb chunks at once (the device engine batches the
same recurrence further over pairs).

A frozen copy of skani_tpu_torch/chain.py, kept in the benchmark's reference so that no
change to the program moves it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .params import MapParams, D_MAX_LIN_LENGTH, OVERLAP_ORTHOLOGOUS_FRACTION


@dataclasses.dataclass
class AnchorChunks:
    """Anchors bucketed into query fragments (reference: src/types.rs:545-550).

    Anchors are stored as parallel arrays (query_contig, query_pos, ref_contig,
    ref_pos, reverse) with chunk CSR offsets."""
    q_contig: np.ndarray
    q_pos: np.ndarray
    r_contig: np.ndarray
    r_pos: np.ndarray
    reverse: np.ndarray
    chunk_starts: np.ndarray          # int64, len = n_chunks + 1
    seeds_in_chunk: List[np.ndarray]  # query seed positions per chunk

    @property
    def n_chunks(self) -> int:
        return len(self.chunk_starts) - 1

    @staticmethod
    def empty() -> "AnchorChunks":
        z = np.zeros(0, dtype=np.uint32)
        return AnchorChunks(z, z, z, z, np.zeros(0, dtype=bool),
                            np.zeros(1, dtype=np.int64), [])


def _switch_qr(mean_ctg_len_r, mean_ctg_len_q, q_sk_len, r_sk_len,
               query_file_name, ref_file_name) -> bool:
    """reference: src/chain.rs:15-26"""
    score_query = q_sk_len * min(mean_ctg_len_q, 300000.0)
    score_ref = r_sk_len * min(mean_ctg_len_r, 300000.0)
    if score_query == score_ref:
        return query_file_name > ref_file_name
    return score_query > score_ref


def _expand_csr(starts: np.ndarray, kmer_ids: np.ndarray,
                seed_starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Row indices into the flat position arrays for the given unique-kmer ids."""
    cnts = counts[kmer_ids]
    total = int(cnts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    base = np.repeat(seed_starts[kmer_ids], cnts)
    excl = np.repeat(np.cumsum(cnts) - cnts, cnts)
    return base + (np.arange(total, dtype=np.int64) - excl)


def compute_switch(ref_sketch, query_sketch) -> bool:
    """Decide query/ref swap (reference: src/chain.rs:625-661)."""
    mean_ctg_len_q = float(query_sketch.contig_lengths.astype(np.float64).sum()
                           ) / len(query_sketch.contig_lengths)
    mean_ctg_len_r = float(ref_sketch.contig_lengths.astype(np.float64).sum()
                           ) / len(ref_sketch.contig_lengths)
    # marker-count proxy for genome length (reference: src/chain.rs:638-648)
    if (query_sketch.total_sequence_length > 100_000
            and ref_sketch.total_sequence_length > 100_000):
        q_proxy = float(len(query_sketch.marker_seeds)) * float(query_sketch.c)
        r_proxy = float(len(ref_sketch.marker_seeds)) * float(ref_sketch.c)
    else:
        q_proxy = float(query_sketch.total_sequence_length)
        r_proxy = float(ref_sketch.total_sequence_length)
    return _switch_qr(mean_ctg_len_r, mean_ctg_len_q, q_proxy, r_proxy,
                      query_sketch.file_name, ref_sketch.file_name)


def get_anchors(ref_sketch, query_sketch,
                map_params: MapParams) -> Tuple[AnchorChunks, bool]:
    """reference: src/chain.rs:608-836"""
    if len(ref_sketch.contig_lengths) == 0 or len(query_sketch.contig_lengths) == 0:
        return AnchorChunks.empty(), True

    switched = compute_switch(ref_sketch, query_sketch)
    # After switching, "Q" is the side whose coordinates define chunks.
    q_sk = ref_sketch if switched else query_sketch
    r_sk = query_sketch if switched else ref_sketch

    band = map_params.index_chain_band
    q_counts = q_sk.seed_counts
    r_counts = r_sk.seed_counts

    common, qi, ri = np.intersect1d(q_sk.seed_kmers, r_sk.seed_kmers,
                                    assume_unique=True, return_indices=True)
    q_ok = q_counts <= band
    pair_ok = q_ok[qi] & (r_counts[ri] <= band)

    # Query positions that feed chunk statistics: all Q kmers with
    # q_count <= band, except kmers shared with R whose R count > band
    # (reference: src/chain.rs:666-712).
    exclude = np.zeros(len(q_sk.seed_kmers), dtype=bool)
    exclude[qi[r_counts[ri] > band]] = True
    qpa_kmer_ids = np.nonzero(q_ok & ~exclude)[0]
    qpa_rows = _expand_csr(None, qpa_kmer_ids, q_sk.seed_starts[:-1],
                           q_counts)
    qpa_pos = q_sk.seed_pos[qpa_rows]
    qpa_ctg = q_sk.seed_contig[qpa_rows]

    # Anchors: cross product of positions for kmers passing both band caps.
    jqi = qi[pair_ok]
    jri = ri[pair_ok]
    qc = q_counts[jqi]
    rc = r_counts[jri]
    pair_counts = (qc * rc).astype(np.int64)
    total = int(pair_counts.sum())
    if total == 0:
        return AnchorChunks.empty(), True
    grp_excl = np.repeat(np.cumsum(pair_counts) - pair_counts, pair_counts)
    rank = np.arange(total, dtype=np.int64) - grp_excl
    rc_rep = np.repeat(rc.astype(np.int64), pair_counts)
    q_row = np.repeat(q_sk.seed_starts[:-1][jqi], pair_counts) + rank // rc_rep
    r_row = np.repeat(r_sk.seed_starts[:-1][jri], pair_counts) + rank % rc_rep

    a_qp = q_sk.seed_pos[q_row]
    a_qc = q_sk.seed_contig[q_row]
    a_rp = r_sk.seed_pos[r_row]
    a_rc = r_sk.seed_contig[r_row]
    a_rev = r_sk.seed_canon[r_row] != q_sk.seed_canon[q_row]

    # Lexicographic anchor sort (reference: src/types.rs:499-506 derived Ord:
    # query_contig, query_pos, ref_contig, ref_pos, reverse_match).
    order = np.lexsort((a_rev, a_rp, a_rc, a_qp, a_qc))
    a_qp = a_qp[order]
    a_qc = a_qc[order]
    a_rp = a_rp[order]
    a_rc = a_rc[order]
    a_rev = a_rev[order]

    # Per-contig sorted query positions.
    qpa_order = np.lexsort((qpa_pos, qpa_ctg))
    qpa_pos = qpa_pos[qpa_order]
    qpa_ctg = qpa_ctg[qpa_order]

    chunk_starts, seeds_in_chunk = _chunk_anchors(
        a_qc, a_qp, qpa_ctg, qpa_pos, map_params.fragment_length)

    return AnchorChunks(a_qc, a_qp, a_rc, a_rp, a_rev,
                        chunk_starts, seeds_in_chunk), switched


def _chunk_anchors(a_qc: np.ndarray, a_qp: np.ndarray, qpa_ctg: np.ndarray,
                   qpa_pos: np.ndarray, fragment_length: int):
    """Split sorted anchors into ~20kb query fragments, collecting the query
    seed positions covered by each fragment (reference: src/chain.rs:738-826).

    The end point advances by exactly one fragment_length per break (not
    re-anchored), and the anchor triggering a break belongs to the NEW chunk —
    quirks preserved from the reference.  O(n_chunks log n) via searchsorted.
    """
    n = len(a_qp)
    # slices of the per-contig query position table
    ctg_bounds_keys, ctg_bounds_idx = np.unique(qpa_ctg, return_index=True)
    ctg_start = {}
    for t, ctg in enumerate(ctg_bounds_keys):
        s = ctg_bounds_idx[t]
        e = ctg_bounds_idx[t + 1] if t + 1 < len(ctg_bounds_idx) else len(qpa_ctg)
        ctg_start[int(ctg)] = (int(s), int(e))

    chunk_starts = [0]
    seeds_in_chunk: List[np.ndarray] = []
    i = 0
    fl = fragment_length
    while i < n:
        contig = int(a_qc[i])
        s, e = ctg_start.get(contig, (0, 0))
        pos_slice = qpa_pos[s:e]
        running = 0
        cep = int(a_qp[i]) + fl
        # process chunks within this contig segment
        seg_end = i
        while seg_end < n and a_qc[seg_end] == contig:
            seg_end += 1
        while i < seg_end:
            # chunk = anchor i plus following anchors with qpos <= cep
            j = int(np.searchsorted(a_qp[i:seg_end], cep, side="right"))
            j = max(j, 1)
            nxt = i + j
            if nxt < seg_end:
                # a break occurs at anchor `nxt`: close chunk with seeds <= cep
                upto = int(np.searchsorted(pos_slice[running:], cep,
                                           side="right"))
                seeds_in_chunk.append(pos_slice[running:running + upto])
                running += upto
                chunk_starts.append(nxt)
                cep += fl
                i = nxt
            else:
                # last chunk of segment (or of all anchors)
                if seg_end == n:
                    # final chunk: seeds up to the last anchor's query pos
                    last_qp = int(a_qp[n - 1])
                    upto = int(np.searchsorted(pos_slice[running:], last_qp,
                                               side="right"))
                    seeds_in_chunk.append(pos_slice[running:running + upto])
                    chunk_starts.append(n)
                    i = n
                else:
                    # contig change: close chunk with seeds <= cep
                    upto = int(np.searchsorted(pos_slice[running:], cep,
                                               side="right"))
                    seeds_in_chunk.append(pos_slice[running:running + upto])
                    chunk_starts.append(seg_end)
                    i = seg_end
    return np.asarray(chunk_starts, dtype=np.int64), seeds_in_chunk


def chain_anchors_dp(ac: AnchorChunks, map_params: MapParams):
    """Banded chaining DP over all chunks, padded & vectorized
    (reference: src/chain.rs:838-896 chain_anchors_ani).

    Returns (scores f64, pointers int64) flat over all anchors.  pointer[i]
    == i means chain start.  Ties resolved like the reference: backward scan
    with strict '>', i.e. the largest eligible j wins among equals.
    """
    n = len(ac.q_pos)
    scores = np.zeros(n, dtype=np.float64)
    ptr = np.arange(n, dtype=np.int64)
    if n == 0:
        return scores, ptr
    band = map_params.index_chain_band
    past_chain_length = min(map_params.fragment_length // 2,
                            map_params.bp_chain_band)

    counts = np.diff(ac.chunk_starts)
    n_chunks = len(counts)
    L = int(counts.max())
    # padded (n_chunks, L) views
    pad_idx = ac.chunk_starts[:-1][:, None] + np.arange(L)[None, :]
    valid = np.arange(L)[None, :] < counts[:, None]
    pad_idx = np.minimum(pad_idx, n - 1)
    qp = ac.q_pos[pad_idx].astype(np.int64)
    rp = ac.r_pos[pad_idx].astype(np.int64)
    rcg = ac.r_contig[pad_idx].astype(np.int64)
    rev = ac.reverse[pad_idx]

    dp = np.zeros((n_chunks, L), dtype=np.float64)
    pt = np.tile(np.arange(L, dtype=np.int64), (n_chunks, 1))

    offs = np.arange(1, band + 1)  # j = i - off, off ascending == j descending
    for i in range(1, L):
        w = offs[offs <= i]
        j_idx = i - w  # descending j
        d_q = (qp[:, i:i + 1] - qp[:, j_idx]).astype(np.float64)
        d_r_fwd = (rp[:, i:i + 1] - rp[:, j_idx]).astype(np.float64)
        d_r = np.where(rev[:, i:i + 1], -d_r_fwd, d_r_fwd)
        gap = np.abs(d_r - d_q)
        ok = (rcg[:, i:i + 1] == rcg[:, j_idx])
        ok &= d_q <= past_chain_length
        ok &= rev[:, i:i + 1] == rev[:, j_idx]
        ok &= (rp[:, i:i + 1] != rp[:, j_idx]) & (d_q != 0)
        ok &= (d_q <= D_MAX_LIN_LENGTH) & (d_r <= D_MAX_LIN_LENGTH)
        ok &= d_r > 0
        ok &= gap <= map_params.max_gap_length
        ok &= valid[:, j_idx] & valid[:, i:i + 1]
        cand = np.where(ok, map_params.anchor_score - gap + dp[:, j_idx],
                        -np.inf)
        best_w = np.argmax(cand, axis=1)  # first max == largest j
        best_val = cand[np.arange(n_chunks), best_w]
        take = best_val > 0.0
        dp[:, i] = np.where(take, best_val, 0.0)
        pt[:, i] = np.where(take, i - w[best_w], i)

    # scatter back to flat arrays
    flat_rows = np.repeat(np.arange(n_chunks), counts)
    flat_cols = np.concatenate([np.arange(c) for c in counts]) \
        if n_chunks else np.zeros(0, dtype=np.int64)
    scores = dp[flat_rows, flat_cols]
    ptr = pt[flat_rows, flat_cols] + np.repeat(ac.chunk_starts[:-1], counts)
    return scores, ptr


@dataclasses.dataclass
class ChainInterval:
    """reference: src/types.rs:508-527"""
    score: float = 0.0
    num_anchors: int = 0
    interval_on_query: Tuple[int, int] = (0, 0)
    interval_on_ref: Tuple[int, int] = (0, 0)
    ref_contig: int = 0
    query_contig: int = 0
    chunk_id: int = 0
    reverse_chain: bool = False
    overlap: int = 0

    def query_range_len(self) -> int:
        return self.interval_on_query[1] - self.interval_on_query[0]

    def ref_range_len(self) -> int:
        return self.interval_on_ref[1] - self.interval_on_ref[0]

    def sort_tuple(self):
        # field order of the reference's derived PartialOrd
        return (self.score, self.num_anchors, self.interval_on_query,
                self.interval_on_ref, self.ref_contig, self.query_contig,
                self.chunk_id, self.reverse_chain, self.overlap)


def get_chain_intervals(ac: AnchorChunks, scores: np.ndarray,
                        ptr: np.ndarray,
                        map_params: MapParams) -> List[ChainInterval]:
    """Extract best chains per union-find set (reference: src/chain.rs:939-1007).

    Sets are the connected components of the pointer forest; since ptr[i] <= i,
    roots are found by pointer doubling.
    """
    n = len(scores)
    out: List[ChainInterval] = []
    if n == 0:
        return out
    root = ptr.copy()
    while True:
        nxt = root[root]
        if np.array_equal(nxt, root):
            break
        root = nxt
    # group members by root
    order = np.argsort(root, kind="stable")
    uniq_roots, grp_starts = np.unique(root[order], return_index=True)
    grp_ends = np.append(grp_starts[1:], n)

    min_anchors = map_params.min_anchors
    min_score = map_params.min_score
    qp = ac.q_pos
    rp = ac.r_pos
    rcg = ac.r_contig
    qcg = ac.q_contig
    rev = ac.reverse
    chunk_of = np.searchsorted(ac.chunk_starts, np.arange(n), side="right") - 1

    for g in range(len(uniq_roots)):
        members = order[grp_starts[g]:grp_ends[g]]
        if len(members) < min_anchors:
            continue
        mscores = scores[members]
        best_local = int(np.argmax(mscores))  # smallest index wins ties
        # members is sorted ascending (stable argsort of arange order)
        best = int(members[best_local])
        max_score = float(mscores[best_local])
        # walk back pointer chain
        num_anchors = 1
        idx = best
        while ptr[idx] != idx:
            idx = int(ptr[idx])
            num_anchors += 1
        if num_anchors < min_anchors or max_score < min_score:
            continue
        smallest = idx
        iq = (int(qp[smallest]), int(qp[best]))
        e1, e2 = int(rp[smallest]), int(rp[best])
        out.append(ChainInterval(
            score=max_score,
            num_anchors=num_anchors,
            interval_on_query=iq,
            interval_on_ref=(min(e1, e2), max(e1, e2)),
            ref_contig=int(rcg[smallest]),
            query_contig=int(qcg[smallest]),
            chunk_id=int(chunk_of[smallest]),
            reverse_chain=bool(rev[smallest]),
            overlap=0,
        ))
    return out


def get_nonoverlapping_chains(intervals: List[ChainInterval],
                              num_chunks: int) -> List[List[ChainInterval]]:
    """Greedy overlap resolution (reference: src/chain.rs:1008-1099).

    An interval is accepted if, on both the query and reference contig, its
    summed overlap with already-accepted intervals is < 50% of its own range
    (reference: OVERLAP_ORTHOLOGOUS_FRACTION).  NOTE: the reference pushes the
    interval with overlap field untouched (src/chain.rs:1091-1093); preserved.
    """
    intervals = sorted(intervals, key=ChainInterval.sort_tuple, reverse=True)
    trees_q: dict = {}
    trees_r: dict = {}
    good: List[List[ChainInterval]] = [[] for _ in range(num_chunks)]
    for interval in intervals:
        q0, q1 = interval.interval_on_query
        r0, r1 = interval.interval_on_ref
        tq = trees_q.setdefault(interval.query_contig, [])
        tr = trees_r.setdefault(interval.ref_contig, [])

        sum_ol_ref = 0
        overlapping_r = [iv for iv in tr
                         if iv.interval_on_ref[0] < r1
                         and r0 < iv.interval_on_ref[1]]
        if overlapping_r:
            for ol in overlapping_r:
                sum_ol_ref += min(r1 - ol.interval_on_ref[0],
                                  ol.interval_on_ref[1] - r0)
            no_overlap_ref = (np.float32(sum_ol_ref)
                              < np.float32(interval.ref_range_len())
                              * np.float32(OVERLAP_ORTHOLOGOUS_FRACTION))
        else:
            no_overlap_ref = True

        sum_ol_q = 0
        overlapping_q = [iv for iv in tq
                         if iv.interval_on_query[0] < q1
                         and q0 < iv.interval_on_query[1]]
        if overlapping_q:
            for ol in overlapping_q:
                sum_ol_q += min(q1 - ol.interval_on_query[0],
                                ol.interval_on_query[1] - q0)
            no_overlap_query = (np.float32(sum_ol_q)
                                < np.float32(interval.query_range_len())
                                * np.float32(OVERLAP_ORTHOLOGOUS_FRACTION))
        else:
            no_overlap_query = True

        if no_overlap_ref and no_overlap_query:
            tq.append(interval)
            tr.append(interval)
            good[interval.chunk_id].append(interval)
    return good

"""Device-resident pair engine: join -> chunk -> DP -> chains on the device.

The per-pair hot path of the reference (reference: src/chain.rs:144-171)
executed on the device for a BATCH of genome pairs against the
device-resident DeviceDb:

  phase A (eager torch ops plus the hand-written CUDA kernels):
    * seed join, one of three with the same result, under the reference's
      repeat band caps (reference: src/chain.rs:666-712).  `dense_pos`
      (POSITION axis): the DB-wide kmer union is ranked once; per pair, ONE
      row gather of the ref's dense (cnt | start) table at the query's
      per-position global kmer ids.  `dense` (kmer axis): the same table
      read at the query's per-kmer union ranks, which ascend, so the gather
      is windowed; taken when a pair's band differs from the one baked
      into the position-axis ids.  `merge`: a batched sorted search of the
      query kmers in the ref kmers, for databases whose dense tables were
      not built (past the memory budget, or >= 2^17 seed positions).  The
      kmer-axis joins map their per-kmer result onto the position axis
      with one genome-map gather;
    * anchor expansion DIRECTLY IN SORTED ORDER: the expansion walks the
      query's (contig, position)-sorted seed table and each ref kmer run is
      itself run-sorted, so emitted anchors are already in the reference's
      Anchor Ord (types.rs:499-506) — there is NO per-pair anchor sort.
      Slot -> source mapping is one fill scatter + forward-fill cummax.
      Up to 65536 positions the query-side packed position word rides the
      same fill as a second payload (`fused_apk`); beyond, the fill word
      is the position index alone and the query side is a windowed gather
      at the (nondecreasing) filled indices;
    * fragment chunking in CLOSED FORM: the reference's sequential
      cep-advance scan (reference: src/chain.rs:738-826) reduces, per
      contig segment, to m_t = min(q_t, t+1, t + prefmin_s(q_s - s)) where
      q_t = max(0, (qp_t - qp_first - 1) // fragment_length) — q_t is
      nondecreasing because anchors are sorted, so the cascade counter is a
      segmented prefix-min, computed as one cummax over
      (segment_id << VBITS | encoded value) packed keys;
    * banded chaining DP over the COMPACT anchor stream
      (kernels/dp_compact.py): chunk identity rides in-band (a 5-bit tag
      for band < 32, the full chunk id in a third plane for wider bands),
      rows split into segment-lanes with an L_CAP halo; chain ROOT and
      DEPTH propagate through the band ring buffer, so no pointer-chasing
      pass is needed;
    * where the compact stream does not apply (per-chunk caps of 2048 and
      above, the `sorted` tier at band >= 32, the legacy generator, or
      `compact_dp=False`) the anchors are regrouped into a TRANSPOSED
      padded layout (L_CAP, R * C_CAP), one lane per chunk, by two or
      three scatters; the padded DP (kernels/dp_pallas.py) walks it, and
      one or two flat gathers bring score, depth and root back to the
      compact order;
    * chain extraction by SORT AGGREGATION: anchors sorted by (root, score
      desc, col asc) put each chain's best (score, col) first in its root
      group (one packed key when the score fits beside the column, three
      keys otherwise); good roots compact with a second sort, and every
      other per-chain field comes from small (R, I_CAP) gathers at the
      root columns;
    * ALL outputs packed into one int32 tensor (one device->host copy per
      batch: 6 words per interval + 1 per chunk).
  host: greedy overlap resolution + per-chunk aggregation (native C++);
    the seed-rank queries it emits are answered from HOST-side sorted
    position tables (kernels/rank_host.py), so there is no second device
    round trip per batch.

  run_pairs buckets pairs into anchor-buffer sizes, keeps several device
  batches in flight, finalizes each batch on a host thread while the next
  one runs, lets host steal-workers score single pairs natively from the
  back of the same queue, and computes mirrored pair orientations once.

Three anchor generators (`gen_mode`), chosen by the engine from the
sketches: "sorted_packed" (above; positions < 2^24 and at most 64
contigs), "sorted" (the same expansion with unpacked position and contig
tables: four row gathers in place of two, the merge join only, an unpacked
readback of 10 words per interval and 3 per chunk), and "legacy" (AAI or
duplicate seed positions: expansion in kmer order, then a 5-key anchor
sort).  Databases with 2^19 seed positions or more map the join onto the
position axis with two gathers (count, start) instead of one packed word.

The kernels of this path (kernels/gather.py row_gather,
windowed_sorted_gather, genome_map_gather, row_scatter and
row_scatter_multi; kernels/dp_compact.py dp_chain_compact and
dp_chain_compact_wide; kernels/dp_pallas.py dp_chain and dp_chain_packed;
kernels/expand_pallas.py expand_anchors) launch on a CUDA tensor and take
their plain torch versions on a CPU tensor.  Only the `rg` row gathers go
to the gather kernels; the small flat gathers of the aggregation, the
regroup scatters and the extraction gathers stay torch ops.
"""
from __future__ import annotations

import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import stats
from .device_db import PACK_RC_SHIFT, DeviceDb
from .dp_compact import (CID_SHIFT, dp_chain_compact,
                         dp_chain_compact_wide, ring_size)
from .dp_pallas import dbits, dp_chain, dp_chain_packed
from .expand_pallas import expand_anchors, expand_ok
from .gather import (genome_map_gather, row_gather, row_scatter,
                     row_scatter_multi, windowed_gather_ok,
                     windowed_sorted_gather)

I32MAX = 2 ** 31 - 1
BIG = 1 << 30
_I32 = torch.int32

JOIN_MODES = ("dense_pos", "dense", "merge")
GEN_MODES = ("sorted_packed", "sorted", "legacy")

# engine sizing: batch rows and the wide-batch row cap (_r_for) on the card
# and on the CPU (tests), the dense join tables' memory budget, the interval
# and chunk caps (_caps_for scales them per batch; E. coli-scale pairs
# produce ~420 intervals, and a pair past a cap falls back to the exact
# native path), and the device batches kept in flight by run_pairs
BATCH_CUDA, BATCH_CPU = 32, 12
RMAX_CUDA, RMAX_CPU = 256, 0
DENSE_JOIN_BUDGET = 512 << 20
I_CAP, C_CAP = 512, 512
INFLIGHT = 3


def default_host_workers() -> int:
    """run_pairs' steal-worker count: SKANI_TPU_HOST_WORKERS, else
    min(2, cores - 2).  Workers pay only where cores are spare beyond the
    one that dispatches the device and the one that finalizes its
    batches; on a small host they would only leave stragglers."""
    spare = max(0, (os.cpu_count() or 1) - 2)
    return int(os.environ.get("SKANI_TPU_HOST_WORKERS", str(min(2, spare))))


def job_threads(threads) -> int:
    """The job's `-t` threads, at least one and at most the cores."""
    return min(max(int(threads or 1), 1), os.cpu_count() or 1)


def fallback_workers(threads: int, host_workers: int) -> int:
    """run_pairs' threads for overflow rows: of the job's `threads` (at
    most the cores), those left beyond the dispatching thread, the
    finalize thread and the steal-workers, and at least one, so that an
    overflow row never holds up the finalize thread."""
    return max(1, job_threads(threads) - 2 - host_workers)


def resolve_device(device=None) -> torch.device:
    """The engine's device: CUDA unless the caller names another.  Raises
    RuntimeError when CUDA is asked for (or defaulted to) and absent; the
    package never moves to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "skani_tpu_torch: CUDA is not available; pass device='cpu' to "
            "run the plain torch versions on the CPU")
    return dev


def _ceil_log2(n: int) -> int:
    return int(np.ceil(np.log2(max(n, 2))))


def _contig_quants(sk):
    """Cached 10/50/90% contig-length quantiles, pre-cast through f32
    exactly as finalize_ani computes them (reference: src/chain.rs:519-554)."""
    qs = getattr(sk, "_quants_cache", None)
    if qs is None:
        s = np.sort(sk.contig_lengths)
        n = len(s)
        qs = (float(np.float32(s[n * 10 // 100])),
              float(np.float32(s[n * 50 // 100])),
              float(np.float32(s[n * 90 // 100])))
        sk._quants_cache = qs
    return qs


def _row_gather(mat, idx):
    """take_along_axis(mat, idx, axis=1): a flat torch gather (not the
    row-gather kernel; these are the small aggregation lookups)."""
    return torch.gather(mat, 1, idx.long())


def _full(R, value, like):
    return torch.full((R, 1), value, dtype=_I32, device=like.device)


def _cummax(x):
    return torch.cummax(x, dim=1).values


def _stable_sort(key, *payloads):
    """Stable ascending sort along dim 1 carrying payloads (lax.sort with
    num_keys=1 and is_stable=True)."""
    s, order = torch.sort(key, dim=1, stable=True)
    return (s,) + tuple(torch.gather(p, 1, order) for p in payloads)


def _u32_bits(x64):
    """int64 values in [0, 2^32) -> int32 with the same bit pattern."""
    return torch.where(x64 >= (1 << 31), x64 - (1 << 32), x64).to(_I32)


def _chk(*xs):
    """Tiny int32 checksum (wrapping like XLA's int32 sum) for the stage
    exits that bisect a mismatch against the reference."""
    return torch.stack([x.to(_I32).sum(dtype=_I32) for x in xs])


def _join_kmer_axis(db, a_idx, b_idx, b_rows, join_mode, band, stage, P):
    """The two kmer-axis joins.  Returns (hit, b_cnt_hit, b_start_hit,
    pair_ok, join_ovf), each (R, K) but the per-row flag, or a checksum at
    an early `stage`.  b_rows: the ref rows as int32 (R,), for the row
    gathers that read a database table by genome id."""
    R = a_idx.shape[0]
    K = db["kmers"].shape[1]
    a_cnt = db["counts"][a_idx]
    join_ovf = torch.zeros((R,), dtype=torch.bool, device=a_idx.device)
    if join_mode == "dense":
        # --- GLOBAL-AXIS join: kmers are pre-ranked on the DB-wide union
        # axis, so the per-pair sorted merge collapses to ONE row gather of
        # the ref genome's dense (cnt << 17 | start) table (0 = absent;
        # present => cnt >= 1)
        gid_a = db["gid"][a_idx]                      # (R, K)
        if stage == 21:  # join: query-side gid row gather only
            return _chk(gid_a)
        valid_k = gid_a >= 0
        U = db["dense_cs"].shape[1]
        if stage == 22:  # join: + ref-side dense table row gather
            return _chk(db["dense_cs"][b_idx])
        if windowed_gather_ok(U, K):
            # gid is ASCENDING per row (ranks of the sorted kmer table),
            # so the union-axis gather takes the windowed kernel.  Padding
            # kmers (-1) fill with the row max to stay sorted; rows whose
            # tile range exceeds the window overflow to the exact native
            # path
            gmax = gid_a.max(dim=1, keepdim=True).values
            idx_sorted = torch.where(valid_k, gid_a, gmax).clamp_min(0)
            csb, join_ovf = windowed_sorted_gather(db["dense_cs"][b_idx],
                                                   idx_sorted)
        else:
            csb = row_gather(db["dense_cs"], gid_a.clamp_min(0), b_rows)
        if stage == 23:  # join: + union-axis gather
            return _chk(csb, join_ovf)
        hit = valid_k & (csb != 0)
        b_cnt_hit = torch.where(hit, csb >> 17, 0)
        b_start_hit = torch.where(hit, csb & ((1 << 17) - 1), 0)
        a_ok = (a_cnt <= band) & valid_k
    else:
        # --- sorted-merge join (reference: src/chain.rs:666-712).  The
        # kmers are uint32 bit patterns: viewed as int32, XOR with the sign
        # bit maps unsigned order onto signed order (the all-ones padding
        # sentinel stays last), so a signed sorted search orders them as
        # unsigned
        km = db["kmers"]
        if km.dtype != _I32:
            km = km.view(_I32)
        ak_i, bk_i = km[a_idx], km[b_idx]             # (R, K)
        sign = -(1 << 31)
        idx = torch.searchsorted(bk_i ^ sign, ak_i ^ sign, out_int32=True)
        idx = idx.clamp_max(K - 1)
        a_valid = ak_i != -1
        hit = (row_gather(km, idx, b_rows) == ak_i) & a_valid
        if P < (1 << 17):
            # pack (count, start) so the join needs two gathers, not three
            # (count clipped to 4095: only compared against band < 4096)
            cs = row_gather((db["counts"][b_idx].clamp_max(4095) << 17)
                            | db["starts"][b_idx], idx)
            b_cnt_hit = torch.where(hit, cs >> 17, 0)
            b_start_hit = torch.where(hit, cs & ((1 << 17) - 1), 0)
        else:
            b_cnt_hit = torch.where(
                hit, row_gather(db["counts"], idx, b_rows), 0)
            b_start_hit = torch.where(
                hit, row_gather(db["starts"], idx, b_rows), 0)
        a_ok = (a_cnt <= band) & a_valid
    pair_ok = hit & a_ok & (b_cnt_hit <= band)
    return hit, b_cnt_hit, b_start_hit, pair_ok, join_ovf


def _expand_legacy(db, a_idx, ab_rows, joined, A, P, slots, stage):
    """The legacy generator: anchor expansion in KMER order, then the
    reference's Anchor sort (reference: src/types.rs:499-506 Ord) on five
    keys.  ab_rows: the query and ref rows as int32 (R,).  Returns (qc,
    qp, rc, rp, rev, anchor_valid, total), or a checksum at stage 3 or
    4."""
    _hit, b_cnt_hit, b_start_hit, pair_ok, _ovf = joined
    R, K = b_cnt_hit.shape
    dev = a_idx.device
    a_rows, b_rows = ab_rows
    pair_counts = torch.where(pair_ok, db["counts"][a_idx] * b_cnt_hit, 0)
    offs = torch.cumsum(pair_counts, dim=1, dtype=_I32) - pair_counts
    total = offs[:, -1] + pair_counts[:, -1]
    kcols = torch.arange(K, dtype=_I32, device=dev)[None, :].expand(R, K)
    # slot -> kmer: each emitting kmer's id lands at its first output slot
    # (offsets strictly increase across emitting kmers, so targets are
    # distinct; every other kmer lands in the extra last column), then a
    # cummax forward-fill
    emit = pair_ok & (pair_counts > 0) & (offs < A)
    gb = torch.full((R, A + 1), -1, dtype=_I32, device=dev)
    gb.scatter_(1, torch.where(emit, offs, A).long(), kcols)
    g = torch.clamp(_cummax(gb[:, :A]), 0, K - 1)
    anchor_valid = slots < torch.clamp_max(total, A)[:, None]
    # the per-kmer lookups fused into as few (R, A) gathers as possible:
    # (offset, count) pack into one int32; (a_start, b_start) pack when the
    # position table is small (16 + 16 bits)
    oc = row_gather((torch.clamp_max(offs, A) << 12)
                    | torch.clamp_max(b_cnt_hit, 4095), g)
    rank = slots - (oc >> 12)
    bc = torch.clamp_min(oc & 4095, 1)
    if P <= 65536:
        ab = row_gather((db["starts"][a_idx] << 16) | b_start_hit, g)
        a_start_g = (ab >> 16) & 0xFFFF
        b_start_g = ab & 0xFFFF
    else:
        a_start_g = row_gather(db["starts"], g, a_rows)
        b_start_g = row_gather(b_start_hit, g)
    arow = torch.clamp(
        a_start_g + torch.div(rank, bc, rounding_mode="floor"), 0, P - 1)
    brow = torch.clamp(b_start_g + torch.remainder(rank, bc), 0, P - 1)
    qp = torch.where(anchor_valid, row_gather(db["pos"], arow, a_rows),
                     I32MAX)
    qcc = row_gather(db["ctgc"], arow, a_rows)
    rp = torch.where(anchor_valid, row_gather(db["pos"], brow, b_rows),
                     I32MAX)
    rcc = row_gather(db["ctgc"], brow, b_rows)
    qc = torch.where(anchor_valid, qcc >> 1, I32MAX)
    rc = torch.where(anchor_valid, rcc >> 1, I32MAX)
    rev = ((qcc & 1) != (rcc & 1)) & anchor_valid
    if stage == 3:   # + anchor expansion
        return _chk(qp, rp, qc, rc, rev)
    # 5-key sort (qc, qp, rc, rp, rev) as two stable sorts of composed
    # int64 keys, least significant first; every field lies in [0, 2^31)
    # (invalid slots hold I32MAX), so both keys stay below 2^63
    lo = (rc.long() << 32) | (rp.long() << 1) | rev.long()
    hi = (qc.long() << 32) | qp.long()
    order = torch.sort(lo, dim=1, stable=True).indices
    order = torch.gather(order, 1, torch.sort(
        torch.gather(hi, 1, order), dim=1, stable=True).indices)
    qc, qp, rc, rp, rev, anchor_valid = (
        torch.gather(x, 1, order)
        for x in (qc, qp, rc, rp, rev, anchor_valid))
    if stage == 4:   # + anchor sort
        return _chk(qc, qp, rc, rp, rev)
    return qc, qp, rc, rp, rev, anchor_valid, total


def phase_a(db, ab_idx, A: int, I_CAP: int, C_CAP: int, L_CAP: int,
            band: int, fl: int, pcl: int, max_gap: float,
            anchor_score: float, min_anchors: int, min_score: float,
            gen_mode: str = "sorted_packed", join_mode: str = "dense_pos",
            stage: int = 99, fused_apk: bool = True,
            compact_dp: bool = True, compact_wide: bool = False,
            expand_kernel: bool = False):
    """One batch of phase A.  `db` is DeviceDb.arrays, `ab_idx` the stacked
    (2, R) int32 query/ref genome rows.

    `gen_mode` names the database's layout and anchor generator (see the
    module docstring); "sorted" and "legacy" have the merge join only.
    `fused_apk` lets the query-side position word ride the fill scatter
    when P <= 65536 ("sorted_packed"); False takes the single-payload fill
    and a query-side gather.  `compact_dp=False` keeps the DP off the
    compact anchor stream and on the padded layout.  `compact_wide` says
    that the host checked the `sorted` tier's bounds for the 3-plane
    compact DP (positions < 2^28, contig ids < 2^26).  `expand_kernel`
    takes the one-pass expansion kernel (kernels/expand_pallas.py,
    "sorted_packed" only, experimental) in place of the fill and
    forward-fills.  The regroup into the padded layout is one scatter per
    payload; the reference's fused multi-payload regroup is an A/B knob
    that is off by default there and is not ported.  A batch that reaches
    the DP's choice counts one `dp_batches_compact` or
    `dp_batches_padded` (stats.py).

    Returns the packed int32 readback, (R, 6*I_CAP + C_CAP + 3) for
    "sorted_packed" and (R, 10*I_CAP + 3*C_CAP + 3) otherwise, or a small
    checksum vector at an early `stage`."""
    if gen_mode not in GEN_MODES:
        raise ValueError(f"phase_a: unknown gen_mode {gen_mode!r}")
    if join_mode not in JOIN_MODES:
        raise ValueError(f"phase_a: unknown join_mode {join_mode!r}")
    packed_db = gen_mode == "sorted_packed"
    if not packed_db and join_mode != "merge":
        raise ValueError(f"phase_a: gen_mode {gen_mode!r} has the merge "
                         f"join only (no dense tables)")
    if band >= 4096:
        raise ValueError("band must be < 4096")
    a_idx, b_idx = ab_idx[0].long(), ab_idx[1].long()
    # the same rows as int32, for the row gathers that read a database
    # table by genome id (no per-batch copy of the rows)
    a_rows, b_rows = (ab_idx[0].to(_I32).contiguous(),
                      ab_idx[1].to(_I32).contiguous())
    R = a_idx.shape[0]
    P = (db["apk"] if packed_db else db["pos"]).shape[1]
    if expand_kernel and not (packed_db and expand_ok(P, A)):
        raise ValueError(f"phase_a: expand_kernel needs gen_mode "
                         f"'sorted_packed', A % 1024 == 0, P % 128 == 0 and "
                         f"P >= 2048 (got {gen_mode!r}, A={A}, P={P})")
    dev = a_idx.device
    pcols = torch.arange(P, dtype=_I32, device=dev)[None, :].expand(R, P)
    slots = torch.arange(A, dtype=_I32, device=dev)[None, :].expand(R, A)
    expand_ovf = torch.zeros((R,), dtype=torch.bool, device=dev)

    if join_mode == "dense_pos":
        # --- POSITION-AXIS dense join: ONE row gather of the ref's dense
        # (cnt << 17 | start) table at the query's per-position global kmer
        # ids.  The query-side repeat test (a_cnt <= band) is baked into
        # gidp (-1), matching the engine's band check at dispatch.
        join_ovf = torch.zeros((R,), dtype=torch.bool, device=dev)
        gidp_a = db["gidp"][a_idx]                          # (R, P)
        csb_p = row_gather(db["dense_cs"], gidp_a.clamp_min(0), b_rows)
        okp = (gidp_a >= 0) & (csb_p != 0) & ((csb_p >> 17) <= band)
        cnt_p = torch.where(okp, csb_p >> 17, 0)
        bs_p = torch.where(okp, csb_p & ((1 << 17) - 1), 0)
        if stage == 1:   # join only
            return _chk(okp, cnt_p, bs_p)
    else:
        joined = _join_kmer_axis(db, a_idx, b_idx, b_rows, join_mode, band,
                                 stage, P)
        if not isinstance(joined, tuple):
            return joined
        hit, b_cnt_hit, b_start_hit, pair_ok, join_ovf = joined
        if stage == 1:   # join only
            return _chk(hit, b_cnt_hit, b_start_hit, pair_ok)

    if gen_mode == "legacy":
        gen = _expand_legacy(db, a_idx, (a_rows, b_rows), joined, A, P,
                             slots, stage)
        if not isinstance(gen, tuple):
            return gen
        qc, qp, rc, rp, rev, anchor_valid, total = gen
    else:
        if join_mode != "dense_pos":
            valid_p = pcols < db["n_pos"][a_idx][:, None]
            if P < (1 << 19):
                # per-kmer join word -> position domain (one genome-map
                # gather): b_start < 2^19, count <= band < 2^12.  skid is
                # constant per GENOME, so the kernel reads it in place and
                # the (R, P) copy of skid[a_idx] is never made; padding
                # positions read jw[:, 0] and are masked here
                jw = torch.where(pair_ok, (b_start_hit << 12) | b_cnt_hit,
                                 0)
                jw_p = torch.where(
                    valid_p, genome_map_gather(
                        db["skid"], ab_idx[0].contiguous(), jw), 0)
                cnt_p = jw_p & 0xFFF
                bs_p = jw_p >> 12
            else:
                # big-genome buckets (>= 2^19 seed positions): start
                # offsets no longer fit the packed join word, so count and
                # start take two separate mapping gathers
                cnt_w = torch.where(pair_ok, b_cnt_hit, 0)
                bs_w = torch.where(pair_ok, b_start_hit, 0)
                skid_a = db["skid"][a_idx]
                cnt_p = torch.where(valid_p, row_gather(cnt_w, skid_a), 0)
                bs_p = torch.where(valid_p, row_gather(bs_w, skid_a), 0)

        # --- anchor expansion in SORTED order (no anchor sort needed): the
        # expansion walks the query's (contig, position)-sorted seed table;
        # each position's anchors are its ref kmer run (itself (contig,
        # position)-sorted), so emitted anchors are ALREADY in the
        # reference's Anchor Ord.  DNA seeds have unique (contig,
        # position), so this order is total.
        offs_p = torch.cumsum(cnt_p, dim=1, dtype=_I32) - cnt_p
        total = offs_p[:, -1] + cnt_p[:, -1]
        anchor_valid = slots < torch.clamp_max(total, A)[:, None]
        if stage == 30:  # expansion inputs (no kernel: for timing)
            return offs_p
        if expand_kernel:
            # one-pass banded expansion: the query-side word and the ref
            # row per slot straight from the run-length decode; rows whose
            # window ran out take the exact native fallback.  apk is read
            # by genome id: no per-batch copy of the rows
            aw, brow_k, ovf_k = expand_anchors(
                offs_p, bs_p.contiguous(), db["apk"],
                total.contiguous(), A, a_rows)
            expand_ovf = ovf_k > 0
            bw = row_gather(db["bpk"], torch.clamp(brow_k, 0, P - 1),
                            b_rows)
            qp_r = aw & 0xFFFFFF
            qcc = (aw >> 24) & 0xFF
            rp_r = bw & 0xFFFFFF
            rcc = (bw >> 24) & 0xFF
        else:
            # slot -> source position: scatter each emitting position's
            # fill word at its first output slot, forward-fill with cummax;
            # block starts recover the intra-block rank
            emit = (cnt_p > 0) & (offs_p < A)
            tgt = torch.where(emit, offs_p, A)
            fused_apk = fused_apk and packed_db and P <= 65536
            aw_fill = None
            if P <= 65536:
                # both the position index and its ref-run start fit 16
                # bits, so ONE packed (p << 16 | bs) uint32 fill carries
                # both: the fill word stays monotone in p, and no separate
                # (R, A) bs gather is needed
                pk = _u32_bits((pcols.long() << 16) | bs_p.long())
                if fused_apk:
                    # the query-side packed position word is a forward-fill
                    # of apk VALUES (the fill index is itself a
                    # forward-fill and apk is sorted), so a monotone repack
                    # of apk (ctg<<25 | pos<<1 | canon: the canonical bit
                    # moves BELOW pos so the word is nondecreasing in (ctg,
                    # pos) order; 6+24+1 = 31 bits) rides as the scatter's
                    # second payload
                    apk_a = db["apk"][a_idx]
                    awf = (((apk_a >> 25) << 25) | ((apk_a & 0xFFFFFF) << 1)
                           | ((apk_a >> 24) & 1))
                    outs = row_scatter_multi(
                        tgt, torch.stack([pk, awf], dim=1), A)
                    fw, aw_fill = outs[:, 0], outs[:, 1]
                else:
                    fw = row_scatter(tgt, pk, A)
                if stage == 31:  # expansion: fill scatter only
                    return _chk(fw)
                # the fill word's top bit is set once p >= 32768:
                # forward-fill it as an UNSIGNED value (int64 carrier)
                fwm = _cummax(fw.long() & 0xFFFFFFFF)
                g = torch.clamp_max(fwm >> 16, P - 1).to(_I32)
                bs = (fwm & 0xFFFF).to(_I32)
            else:
                # the fill word is the position index alone (-1 where no
                # position starts).  Emitting positions have distinct
                # targets; every other position lands in the extra last
                # column with the fill value
                fwb = torch.full((R, A + 1), -1, dtype=_I32, device=dev)
                fwb.scatter_(1, tgt.long(), torch.where(emit, pcols, -1))
                g = torch.clamp(_cummax(fwb[:, :A]), 0, P - 1)
                bs = None
            prev_g = torch.cat([_full(R, -2, g), g[:, :-1]], dim=1)
            block_start = _cummax(torch.where(g != prev_g, slots, 0))
            rank = slots - block_start
            if bs is None:
                bs = row_gather(bs_p, g)
            brow = torch.clamp(bs + rank, 0, P - 1)
            if stage == 32:  # expansion: + forward-fill, rank, brow
                return _chk(g, bs, brow)
            if not packed_db:
                # unpacked tables: two gathers per side
                qp_r = row_gather(db["spos"], g, a_rows)
                qcc = row_gather(db["sctgc"], g, a_rows)
                rp_r = row_gather(db["pos"], brow, b_rows)
                rcc = row_gather(db["ctgc"], brow, b_rows)
            else:
                if aw_fill is not None:
                    # fused query side: forward-fill the scattered
                    # monotone apk word
                    awm = _cummax(aw_fill)
                    qp_r = (awm >> 1) & 0xFFFFFF
                    qcc = ((awm >> 25) << 1) | (awm & 1)
                    if stage == 33:  # expansion: + query-side fill
                        return _chk(awm)
                else:
                    # g is a cummax forward-fill, so NONDECREASING per
                    # row: the query-side gather takes the windowed kernel
                    # when the shapes allow.  Sparse-hit pairs whose
                    # 1024-anchor tile spans more than the window set the
                    # per-row overflow and take the exact native fallback
                    if windowed_gather_ok(P, A):
                        aw, apk_ovf = windowed_sorted_gather(
                            db["apk"][a_idx], g)
                        join_ovf = join_ovf | apk_ovf
                    else:
                        aw = row_gather(db["apk"], g, a_rows)
                    if stage == 33:  # expansion: + query-side gather
                        return _chk(aw)
                    qp_r = aw & 0xFFFFFF
                    qcc = (aw >> 24) & 0xFF
                # ref side: ONE gather, positions pre-packed ctgc<<24 | pos
                bw = row_gather(db["bpk"], brow, b_rows)
                if stage == 34:  # expansion: + ref-side gather
                    return _chk(bw)
                rp_r = bw & 0xFFFFFF
                rcc = (bw >> 24) & 0xFF
        if stage == 35:  # + the expansion (no kernel: for timing)
            return qp_r
        qp = torch.where(anchor_valid, qp_r, I32MAX)
        rp = torch.where(anchor_valid, rp_r, I32MAX)
        qc = torch.where(anchor_valid, qcc >> 1, I32MAX)
        rc = torch.where(anchor_valid, rcc >> 1, I32MAX)
        rev = (((qcc ^ rcc) & 1) != 0) & anchor_valid
        if stage in (3, 4):   # + anchor expansion (already sorted)
            return _chk(qc, qp, rc, rp, rev)

    # --- closed-form fragment chunking (see module docstring) ---
    cols = slots
    prev_qc = torch.cat([_full(R, -1, qc), qc[:, :-1]], dim=1)
    seg_start = anchor_valid & (qc != prev_qc)
    seg_idx0 = _cummax(torch.where(seg_start, cols, -1)).clamp_min(0)
    if packed_db:
        # anchors are (qc, qp)-sorted and qc < 64, so the packed (qc << 24
        # | qp) word is nondecreasing along the row: a seg-start-masked
        # cummax forward-fills the segment's FIRST word
        qp_first = _cummax(torch.where(seg_start, (qc << 24) | qp, -1)) \
            & 0xFFFFFF
    else:
        qp_first = row_gather(qp, seg_idx0)
    t_in_seg = cols - seg_idx0
    u = qp - qp_first
    q_units = torch.div(u - 1, fl, rounding_mode="floor").clamp_min(0)
    # segmented prefix-min of (q_units - t_in_seg) via one packed cummax:
    # high bits = segment id (resets the running min at each new segment),
    # low VBITS = descending encoding of the value (so max picks the min).
    VBITS = _ceil_log2(A) + 1
    VCAP = (1 << VBITS) - 1
    QMAX = VCAP - A - 1
    seg_id = torch.cumsum(seg_start.to(_I32), dim=1, dtype=_I32)
    seg_overflow = seg_id[:, -1] >= (1 << (30 - VBITS))
    qu_overflow = torch.any(anchor_valid & (q_units > QMAX), dim=1)
    q_units = torch.clamp_max(q_units, QMAX)
    v_enc = VCAP - (q_units - t_in_seg + A)   # in [0, VCAP-1], desc in v
    packed = (seg_id << VBITS) | v_enc
    pm = (VCAP - (_cummax(packed) & VCAP)) - A
    m = torch.minimum(torch.minimum(q_units, t_in_seg + 1), t_in_seg + pm)
    prev_m = torch.cat([_full(R, 0, m), m[:, :-1]], dim=1)
    chunk_start = seg_start | (anchor_valid & ~seg_start & (m != prev_m))
    cid = torch.cumsum(chunk_start.to(_I32), dim=1, dtype=_I32) - 1
    cid = torch.where(anchor_valid, cid, -1)
    n_chunks = cid.max(dim=1).values + 1

    # per-chunk metadata: hi = qp_first + (m+1)*fl, except the globally
    # last chunk: the LAST anchor's query position in sorted order
    # (reference closes the final chunk at a_qp[n-1], NOT the max position
    # across contigs — src/chain.rs:804-817)
    hi_vals = qp_first + (m + 1) * fl
    # compact chunk-start metadata to columns 0..n_chunks-1 with a SORT:
    # cids are distinct and contiguous over chunk starts, so sorting on
    # where(chunk_start, cid, BIG) lands chunk c's payload at column c
    skey = torch.where(chunk_start, cid, BIG)
    ccols = torch.arange(C_CAP, dtype=_I32, device=dev)[None, :]
    if packed_db:
        # ONE packed payload (hi < 2^24, ctg < 64): hi<<7 | ctg<<1 | new
        wmeta = (hi_vals << 7) | (qc << 1) | seg_start.to(_I32)
        skey_s, wmeta_s = _stable_sort(skey, wmeta)
        present = skey_s[:, :C_CAP] == ccols
        meta_buf = torch.where(present, wmeta_s[:, :C_CAP], -1)
        miss = meta_buf < 0
        chunk_ctg = torch.where(miss, -1, (meta_buf >> 1) & 0x3F)
        chunk_new_ctg = ~miss & ((meta_buf & 1) == 1)
        chunk_hi = torch.where(miss, -1, meta_buf >> 7)
    else:
        skey_s, qc_s, new_s, hi_s = _stable_sort(
            skey, qc, seg_start.to(_I32), hi_vals)
        present = skey_s[:, :C_CAP] == ccols
        chunk_ctg = torch.where(present, qc_s[:, :C_CAP], -1)
        chunk_new_ctg = present & (new_s[:, :C_CAP] == 1)
        chunk_hi = torch.where(present, hi_s[:, :C_CAP], -1)
    last_idx = torch.clamp(torch.clamp_max(total, A) - 1, 0, A - 1)
    last_qp = torch.gather(qp, 1, last_idx[:, None].long())[:, 0]
    last_cid = n_chunks - 1
    chunk_hi[torch.arange(R, device=dev),
             torch.clamp(last_cid, 0, C_CAP - 1).long()] = \
        torch.where(last_cid >= 0, last_qp, -1)
    if stage == 5:   # + chunking
        return _chk(cid, chunk_hi, chunk_ctg, chunk_new_ctg)

    # a chunk's anchors are CONSECUTIVE columns, so the chunk-local column
    # is a forward-fill of chunk-start columns
    col_in_chunk = cols - _cummax(torch.where(chunk_start, cols, -1)
                                  ).clamp_min(0)
    ok_place = anchor_valid & (cid >= 0) & (cid < C_CAP) \
        & (col_in_chunk < L_CAP)
    overflow = (total > A) | (n_chunks > C_CAP) \
        | torch.any(anchor_valid & ~ok_place, dim=1) \
        | seg_overflow | qu_overflow | expand_ovf | join_ovf

    # --- banded chaining DP (reference: src/chain.rs:838-896), over the
    # compact stream where it applies.  Three packings share its kernels:
    #  * packed, band < 32: the cid mod-32 tag rides in w1 (2 planes);
    #  * packed, band >= 32 (medium and slow presets): the FULL cid and rc
    #    (< 64) pack into a third plane, so there is no tag-ambiguity band
    #    limit;
    #  * wide (`sorted` tier, bounds checked by the host: compact_wide):
    #    qp and rp in their own planes, tag << 26 | rc in the third (band
    #    < 32 only: no spare bits for a full cid next to rc).
    compact_common = (compact_dp and A <= (1 << 20) and L_CAP <= 2047
                      and (L_CAP * int(anchor_score) + 1) * ring_size(band)
                      < (1 << 31))
    use_compact2 = compact_common and packed_db and band < 32
    use_compact3 = (compact_common and packed_db and band >= 32
                    and C_CAP * 64 < (1 << 31))
    use_compact_w = (compact_common and gen_mode == "sorted"
                     and compact_wide and band < 32)
    stats.add("dp_batches_compact"
              if use_compact2 or use_compact3 or use_compact_w
              else "dp_batches_padded")
    valid_c = ok_place
    if use_compact2:
        w1 = torch.where(ok_place, ((cid & 31) << CID_SHIFT)
                         | (qp * 4 + rev.to(_I32) * 2 + 1), 0)
        w2 = torch.where(ok_place, (rc << PACK_RC_SHIFT) | rp, 0)
        if stage == 6:   # + DP input packing
            return _chk(w1, w2)
        dp_c, dr_c = dp_chain_compact(w1, w2, col_in_chunk, band, pcl,
                                      max_gap, anchor_score, L_CAP)
    elif use_compact3 or use_compact_w:
        w1 = torch.where(ok_place, qp * 4 + rev.to(_I32) * 2 + 1, 0)
        w2 = torch.where(ok_place, rp, 0)
        if use_compact3:
            w3 = torch.where(ok_place, cid * 64 + rc, -1)
        else:
            w3 = torch.where(ok_place, ((cid & 31) << CID_SHIFT) | rc, -1)
        if stage == 6:   # + DP input packing
            return _chk(w1, w2, w3)
        dp_c, dr_c = dp_chain_compact_wide(w1, w2, w3, col_in_chunk, band,
                                           pcl, max_gap, anchor_score, L_CAP)
    if use_compact2 or use_compact3 or use_compact_w:
        if stage == 7:   # + chaining DP
            return _chk(dp_c, dr_c)
        dep_c = dr_c >> 20
        root_cid = dr_c & ((1 << 20) - 1)
        if stage == 8:   # (no extraction gather in compact mode)
            return _chk(dp_c, root_cid)
    else:
        # --- regroup anchors to one lane per chunk: the TRANSPOSED padded
        # layout (L_CAP, RC), which the padded DP walks along its major
        # dimension.  Placed anchors have distinct (column-in-chunk, chunk
        # row) cells; every other anchor lands in one extra cell past the
        # end of the flat buffer, which is dropped
        RC = R * C_CAP
        rowi = torch.arange(R, dtype=_I32, device=dev)[:, None]
        flat_row = rowi * C_CAP + torch.clamp(cid, 0, C_CAP - 1)
        flat_col = torch.clamp(col_in_chunk, 0, L_CAP - 1)
        # compact -> padded (flat index); unplaced anchors read some cell
        # of the last lane and are masked by valid_c downstream
        dest_c = (flat_col * RC + torch.where(
            ok_place, flat_row, RC - 1)).long().reshape(-1)
        put = torch.where(ok_place, flat_col * RC + flat_row,
                          L_CAP * RC).long().reshape(-1)

        def scatter_t(vals, fill):
            buf = torch.full((L_CAP * RC + 1,), fill, dtype=_I32,
                             device=dev)
            buf.scatter_(0, put, vals.reshape(-1))
            return buf[:L_CAP * RC].view(L_CAP, RC)

        # the packed padded DP: two packed inputs instead of three, ONE
        # output word, ONE extraction gather instead of two
        dp_packed = (packed_db and L_CAP * int(anchor_score)
                     < (1 << (32 - 2 * _ceil_log2(L_CAP))))
        if dp_packed:
            EBITS = _ceil_log2(L_CAP)
            gqprv = scatter_t(
                torch.where(ok_place, qp * 4 + rev.to(_I32) * 2 + 1, 0), 0)
            grprc = scatter_t(
                torch.where(ok_place, (rc << PACK_RC_SHIFT) | rp, 0), 0)
            if stage == 6:   # + DP regroup scatters
                return _chk(gqprv, grprc)
            ddr = dp_chain_packed(gqprv, grprc, band, pcl, max_gap,
                                  anchor_score, EBITS)
            if stage == 7:   # + chaining DP
                return _chk(ddr)
            ddr_c = ddr.reshape(-1)[dest_c].reshape(R, A)
            dp_c = (ddr_c >> (2 * EBITS)) & ((1 << (32 - 2 * EBITS)) - 1)
            dep_c = (ddr_c >> EBITS) & ((1 << EBITS) - 1)
            root_pad = ddr_c & ((1 << EBITS) - 1)
        else:
            # contig ids are small (< 2^28, checked when the database is
            # built): rc, rev and valid pack into one word
            gqp = scatter_t(qp, I32MAX)
            grp = scatter_t(rp, I32MAX)
            grcv = scatter_t(
                torch.where(ok_place, rc * 4 + rev.to(_I32) * 2 + 1, 0), 0)
            if stage == 6:   # + DP regroup scatters
                return _chk(gqp, grp, grcv)
            dd, root = dp_chain(gqp, grp, grcv, band, pcl, max_gap,
                                anchor_score)
            if stage == 7:   # + chaining DP
                return _chk(dd, root)
            # two flat padded -> compact gathers
            DBITS = dbits(L_CAP)
            dd_c = dd.reshape(-1)[dest_c].reshape(R, A)
            root_pad = root.reshape(-1)[dest_c].reshape(R, A)
            dp_c = dd_c >> DBITS
            dep_c = dd_c & ((1 << DBITS) - 1)
        # a chunk's anchors occupy CONSECUTIVE compact columns, so the
        # root's compact column is element-wise arithmetic
        root_cid = cols - col_in_chunk + root_pad
        if stage == 8:   # + extraction gathers (padded -> compact)
            return _chk(dp_c, root_cid)

    INVBITS = _ceil_log2(A)
    # packing headroom: `key` needs score < 2^(31-INVBITS), the readback
    # needs score < 2^15; pairs whose best score would overflow the
    # packing fall back to the exact native path
    score_lim = min(1 << (31 - INVBITS), 1 << 15)
    # the packed (score << INVBITS | col) key needs score < score_lim;
    # large anchor buffers or dense presets (L_CAP 1024 at the slow
    # preset's A) can exceed it: those shapes sort on three keys with
    # score and column apart (identical semantics)
    wide_agg = score_lim <= L_CAP * int(anchor_score)
    if not wide_agg:
        overflow |= torch.any(valid_c & (dp_c >= score_lim), dim=1)

    # --- per-chain aggregation with a multi-key sort: sorting anchors by
    # (root asc, score desc, col asc) puts each chain's best (score,
    # smallest-col) key first in its root group.  The reference's set-size
    # >= min_anchors test (src/chain.rs:954-976) is IMPLIED: the best
    # path's length num_anchors <= set size.
    root_k = torch.where(valid_c, root_cid, BIG)
    if wide_agg:
        # 3-key sort: columns ascend already, so the stable sort's order
        # among equal (root, score) is the third key
        neg_key = -dp_c
    else:
        # packed single key halves the sort payloads
        key = (dp_c << INVBITS) | (A - 1 - cols)
        neg_key = -key
    # one stable sort of an int64 key: root in the high word, the signed
    # second key offset into [0, 2^32) in the low word
    k64 = (root_k.long() << 32) | (neg_key.long() + (1 << 31))
    _s, order = torch.sort(k64, dim=1, stable=True)
    s_root = torch.gather(root_k, 1, order)
    s_nk = torch.gather(neg_key, 1, order)
    agg_score = -s_nk if wide_agg else (-s_nk) >> INVBITS
    prev_root = torch.cat([_full(R, -1, s_root), s_root[:, :-1]], dim=1)
    first = (s_root != prev_root) & (s_root != BIG)
    good_pre = first & (agg_score.to(torch.float32) >= min_score)
    # conservative I_CAP check: good_pre is a superset of the final good
    # set (the num_anchors filter lands after compaction)
    overflow |= good_pre.sum(dim=1) > I_CAP
    if stage == 9:   # + chain aggregation sort
        return _chk(good_pre, s_root)

    # --- compact the good roots (sort on the root column with the best
    # key as payload), then fetch every other per-chain field with small
    # (R, I_CAP) gathers at the root columns
    if wide_agg:
        rcols, g_negs, g_col = _stable_sort(
            torch.where(good_pre, s_root, BIG), s_nk, order.to(_I32))
        rcols = rcols[:, :I_CAP]
        g_score = -g_negs[:, :I_CAP]
        bcl = torch.clamp(g_col[:, :I_CAP], 0, A - 1)
    else:
        rcols, g_nk = _stable_sort(torch.where(good_pre, s_root, BIG), s_nk)
        rcols = rcols[:, :I_CAP]
        g_best = -g_nk[:, :I_CAP]
        g_score = g_best >> INVBITS
        bcl = torch.clamp((A - 1) - (g_best & ((1 << INVBITS) - 1)), 0,
                          A - 1)
    if stage == 10:  # + root compaction sort
        return _chk(rcols, g_score)
    has = rcols != BIG
    rcl = torch.clamp_max(rcols, A - 1)
    num_anchors = _row_gather(dep_c, bcl) + 1
    good = has & (num_anchors >= min_anchors)
    if packed_db:
        # the packed readback carries num_anchors in 10 bits; deeper
        # chains fall back to the exact native path instead of wrapping
        # into the adjacent score field
        overflow |= torch.any(good & (num_anchors > 0x3FF), dim=1)
    g_qp0 = _row_gather(qp, rcl)
    g_rp0 = _row_gather(rp, rcl)
    g_qp1 = _row_gather(qp, bcl)
    g_rp1 = _row_gather(rp, bcl)
    if stage == 11:  # + per-chain field gathers
        return _chk(g_qp0, g_rp0, g_qp1, g_rp1, num_anchors, good)
    scalars = torch.stack([n_chunks, total, overflow.to(_I32)], dim=1)
    if not packed_db:
        # unpacked readback: 10 words per interval, 3 per chunk
        return torch.cat([
            good.to(_I32), g_score, num_anchors, g_qp0, g_qp1,
            torch.minimum(g_rp0, g_rp1), torch.maximum(g_rp0, g_rp1),
            _row_gather(rc, rcl), _row_gather(cid, rcl),
            _row_gather(rev.to(_I32), rcl),
            chunk_hi, chunk_ctg, chunk_new_ctg.to(_I32), scalars], dim=1)
    # interval metadata in 2 words (score<<11|num<<1|good;
    # cid<<7|rc<<1|rev) and chunk metadata re-packed into hi<<7|ctg<<1|new
    wm1 = (g_score << 11) | (num_anchors << 1) | good.to(_I32)
    wm2 = (_row_gather(cid, rcl) << 7) | (_row_gather(rc, rcl) << 1) \
        | _row_gather(rev.to(_I32), rcl)
    out_meta = torch.where(
        chunk_hi < 0, -1,
        (chunk_hi << 7) | ((chunk_ctg & 0x3F) << 1)
        | chunk_new_ctg.to(_I32))
    return torch.cat([wm1, wm2, g_qp0, g_qp1,
                      torch.minimum(g_rp0, g_rp1),
                      torch.maximum(g_rp0, g_rp1),
                      out_meta, scalars], dim=1)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def _compact_wide_fits(sketches) -> bool:
    """The bounds of the compact DP's wide tier (dp_chain_compact_wide):
    positions fit 28 bits, contig ids 26; true for any realistic genome,
    but checked rather than assumed."""
    return all((len(s.contig_lengths) == 0
                or int(max(s.contig_lengths)) < (1 << 28))
               and len(s.contigs) < (1 << 26) for s in sketches)


class _WorkQueue:
    """run_pairs' shared work queue over the sorted pair items `meta`:
    the device takes batches from the front, host steal-workers single
    pairs from the back, both under one lock."""

    def __init__(self, meta, r_for):
        self.meta = meta
        self.r_for = r_for
        self.front, self.back = 0, len(meta)
        self.lock = threading.Lock()

    def take_front(self) -> list:
        """The next device batch: at most r_for(bucket) items, stopping at
        a bucket boundary; [] once the queue is empty."""
        with self.lock:
            lo, meta = self.front, self.meta
            if lo >= self.back:
                return []
            hi = min(lo + self.r_for(meta[lo][7]), self.back)
            while hi > lo + 1 and meta[hi - 1][7] != meta[lo][7]:
                hi -= 1     # stop at a bucket boundary
            self.front = hi
            return meta[lo:hi]

    def take_back(self):
        """The last item, or None once the queue is empty."""
        with self.lock:
            if self.front >= self.back:
                return None
            self.back -= 1
            return self.meta[self.back]

    def close(self) -> None:
        """Drop what is left: both ends then find the queue empty."""
        with self.lock:
            self.back = self.front


class DevicePairEngine:
    """Batched pair scoring against a device-resident DeviceDb."""

    def __init__(self, sketches: Sequence, sketch_params, command_params,
                 model=None, batch: int = None, l_cap: int = None,
                 device=None, join_mode: str = None,
                 compact_dp: bool = True, min_k: int = 0, min_p: int = 0,
                 reserved_slots: int = 0, py_finalize: bool = None):
        """`join_mode` forces one of JOIN_MODES; by default the engine
        takes `dense_pos` when the position-axis ids were built, `dense`
        when only the kmer-axis tables were, else `merge`.
        `compact_dp=False` keeps every batch's DP on the padded layout.
        `min_k` / `min_p` are floors for the database's padded widths.
        `reserved_slots` empty rows follow the sketches, from row
        `reserved_base` on: load_slots swaps genomes into them (queries
        stream through them in resident `search`).  A database with
        reserved rows builds no dense join tables (their kmer-union axis
        cannot be updated row by row), so it takes the merge join.
        `py_finalize=True` (default: SKANI_TPU_PY_FINALIZE=1) finalizes
        each batch in Python (_host_process, _finalize_batch), the plain
        version of the native finalize_device_batch; the engine needs the
        native library either way."""
        from .. import native
        from ..params import map_params_from_sketch
        from ..sketch import Sketch
        from .device_db import db_has_duplicate_positions, db_pack_ok

        self.device = resolve_device(device)
        if not native.available():
            raise RuntimeError(
                "the device engine finalizes batches with the native "
                "library (native/skani_core.cpp), which failed to build")
        self.py_finalize = (os.environ.get("SKANI_TPU_PY_FINALIZE") == "1"
                            if py_finalize is None else py_finalize)
        accel = self.device.type == "cuda"
        if batch is None:
            # the accelerator batch; the CPU (tests) keeps smaller batches
            batch = BATCH_CUDA if accel else BATCH_CPU
        self.reserved_base = len(sketches)
        self.sketches = list(sketches) + [
            Sketch(file_name="", marker_c=sketch_params.marker_c,
                   c=sketch_params.c, k=sketch_params.k)
            for _ in range(reserved_slots)]
        sketches = self.sketches
        # anchor generation mode: sorted-order generation needs a total
        # (contig, position) order (not AAI); the packed variant also
        # needs positions < 2^24 and at most 64 contigs
        use_aa = getattr(sketch_params, "use_aa", False)
        if use_aa or db_has_duplicate_positions(sketches):
            self.gen_mode = "legacy"
        elif db_pack_ok(sketches):
            self.gen_mode = "sorted_packed"
        else:
            self.gen_mode = "sorted"
        self._compact_wide_ok = _compact_wide_fits(sketches)
        self.compact_dp = compact_dp
        db_band = 0
        if self.gen_mode == "sorted_packed" and self.sketches:
            db_band = map_params_from_sketch(
                self.sketches[0], use_aa, command_params,
                None).index_chain_band
        with stats.span("db_build"):
            self.db = DeviceDb(self.sketches, self.device,
                               mode=self.gen_mode,
                               dense_join_budget=(0 if reserved_slots
                                                  else DENSE_JOIN_BUDGET),
                               band=db_band, min_k=min_k, min_p=min_p,
                               threads=job_threads(getattr(
                                   command_params, "threads", 1)))
        # the position-axis dense join whenever its tables exist, the
        # kmer-axis one when only its tables do, else the merge join
        have = {"dense_pos": "gidp" in self.db.arrays,
                "dense": "gid" in self.db.arrays, "merge": True}
        if join_mode is None:
            join_mode = next(m for m in JOIN_MODES if have[m])
        elif join_mode not in JOIN_MODES:
            raise ValueError(f"unknown join_mode {join_mode!r}")
        elif not have[join_mode]:
            raise ValueError(f"join_mode {join_mode!r} needs dense join "
                             f"tables that this database does not hold")
        self.join_mode = join_mode
        self.sketch_params = sketch_params
        self.command_params = command_params
        self.model = model
        self.R = batch
        self._rmax = RMAX_CUDA if accel else RMAX_CPU
        # anchors rarely exceed ~1.1x the larger position count (the repeat
        # band caps the blowup); overflow pairs fall back to the exact
        # native path, so a tight buffer only costs speed on outliers.
        # A at 2048 granularity (the compact DP's segment length)
        a = int(1.15 * self.db.max_n_pos)
        self.A = min(max(((a + 2047) // 2048) * 2048, 8192), 1 << 20)
        self.I_CAP = I_CAP
        self.C_CAP = C_CAP
        if l_cap is None:
            # per-chunk anchor cap sized to the sketch density: ~20kb/c
            # positions per fragment.  512 covers the default/medium
            # presets with >= 1.8x headroom and 1024 the slow preset
            # (c=30); overflowing chunks fall back to the exact native
            # path.  2048 (c < 30) is outside the compact DPs and takes
            # the padded one
            if use_aa:
                l_cap = 768
            else:
                min_c = max(min((int(s.c) for s in sketches), default=125),
                            1)
                need = int(1.5 * 20000 / min_c)
                l_cap = 512 if need <= 512 else (
                    1024 if need <= 1024 else 2048)
        self.L_CAP = l_cap

    def load_slots(self, slots: Sequence[int], sketches: Sequence) -> bool:
        """Swap `sketches` into the reserved rows `slots` (a device-side
        row scatter, DeviceDb.update_rows).  Returns False, and changes
        nothing, when a sketch breaks the generation mode's invariants or
        exceeds the database's padded widths: the caller then scores its
        pairs on the exact host path.  The anchor buffer A stays the one
        sized from the references; a pair that outgrows it overflows to
        the exact native path.  run_pairs has drained every batch (and
        its finalize thread) before it returns, so no batch in flight
        reads a row being replaced; the scatter is issued on the current
        stream, ahead of the next phase_a."""
        from .device_db import db_has_duplicate_positions, db_pack_ok
        if self.gen_mode != "legacy":
            if any(len(s.seed_pos) >= (1 << 19) for s in sketches) \
                    or db_has_duplicate_positions(sketches):
                return False
            if self.gen_mode == "sorted_packed" and not db_pack_ok(sketches):
                return False
            if self._compact_wide_ok and not _compact_wide_fits(sketches):
                return False
        try:
            self.db.update_rows(slots, sketches)
        except ValueError:
            return False
        for g, s in zip(slots, sketches):
            self.sketches[g] = s
        # the anchor-bucket predictions of the replaced rows are stale
        self._surv_cache = {}
        return True

    def _caps_for(self, bucket_a: int, group=()):
        """(I_CAP, C_CAP) for one batch: chunk count scales with the QUERY
        genome length (~ positions * c / 20000) PLUS the query side's
        contig count (every contig with anchors opens at least one chunk),
        so big-genome buckets get wider chunk and interval buffers and
        small buckets shrink both caps.  A pair that overflows a cap falls
        back to the exact native path, so the caps are purely a
        throughput choice."""
        c0 = max(int(getattr(self.sketches[0], "c", 125) or 125), 1) \
            if self.sketches else 125
        cmax = max((len(self.sketches[item[1]].contig_lengths)
                    for item in group), default=0)
        pmax = max((len(self.sketches[item[1]].seed_pos)
                    for item in group), default=0)
        est = int(1.3 * max(bucket_a, pmax) * c0 / 20000) + 2 + cmax
        cc = min(self.C_CAP, 64)
        while cc < est and cc < 8192:
            cc *= 2
        cc = min(cc, self.C_CAP) if est <= self.C_CAP else cc
        # intervals run ~1.5-2 per chunk on real genomes
        icap = max(128, min(2 * cc, max(self.I_CAP, cc)))
        return icap, cc

    def _marker_survival(self, ri: int, qi: int) -> float:
        """Predicted per-seed anchor survival for a pair from its marker
        sketches: shared-marker containment c_m ~ ani^21 (21-mer
        markers), so the k-mer seed hit rate ~ ani^k = c_m^(k/21)
        (reference signal: src/screen.rs:84-142), used here to size the
        anchor buffer."""
        key = (ri, qi) if ri <= qi else (qi, ri)
        cache = getattr(self, "_surv_cache", None)
        if cache is None:
            cache = self._surv_cache = {}
        s = cache.get(key)
        if s is not None:
            return s
        a, b = self.sketches[ri], self.sketches[qi]

        def sorted_markers(sk):
            m = getattr(sk, "_markers_sorted", None)
            if m is None:
                m = np.asarray(sk.marker_seeds)
                if len(m) > 1 and not bool((m[1:] >= m[:-1]).all()):
                    m = np.sort(m)
                sk._markers_sorted = m
            return m

        ma, mb = sorted_markers(a), sorted_markers(b)
        if len(ma) < 20 or len(mb) < 20:   # rescue_small regime: no signal
            s = 1.0
        else:
            if len(mb) < len(ma):
                ma, mb = mb, ma
            idx = np.searchsorted(mb, ma)
            idx_c = np.minimum(idx, len(mb) - 1)
            shared = int(np.count_nonzero(mb[idx_c] == ma))
            c_m = shared / min(len(ma), len(mb))
            k = int(getattr(a, "k", 15) or 15)
            s = min(1.0, c_m ** (k / 21.0)) if c_m > 0 else 0.0
        cache[key] = s
        return s

    def _bucket_a(self, ri: int, qi: int) -> int:
        """Anchor-buffer size for one pair: the smallest power-of-two
        bucket covering the PREDICTED anchor count — the larger
        seed-position count scaled by the marker-predicted seed survival
        (x1.6 safety).  An underestimate is safe: the total > A overflow
        guard routes the pair to the exact native path.  A pair only drops
        to a smaller bucket when that saves >= 3x, so the shape set stays
        small."""
        pmax = max(len(self.sketches[ri].seed_pos),
                   len(self.sketches[qi].seed_pos))
        if getattr(self.sketch_params, "use_aa", False):
            # AAI takes no anchor buckets: the survival estimate assumes
            # 21-mer DNA markers
            need = int(1.15 * pmax)
        else:
            surv = self._marker_survival(ri, qi)
            need = min(int(1.6 * pmax * max(surv, 0.02)) + 64,
                       int(1.15 * pmax))
        b = 8192
        while b < need:
            b *= 2
        return b if 3 * b <= self.A else self.A

    def _r_for(self, bucket_a: int) -> int:
        """Batch rows for one anchor bucket: huge-genome buckets shrink R
        so the padded (R, A) domain stays ~8M slots; small buckets widen R
        (up to RMAX_CUDA on the card; off on the CPU) so the
        batch carries ~ the same total anchor slots as (R, 49152) and the
        fixed per-batch costs amortize over more pairs."""
        r_big = min(self.R, (8 << 20) // bucket_a)
        r_small = min(self._rmax, (self.R * 49152) // bucket_a)
        return max(2, r_big, r_small)

    def _r_shape(self, group) -> int:
        """Batch SHAPE for one formed group: _r_for's width, halved while
        the group fills less than half of it (min 8)."""
        r = self._r_for(group[0][7])
        n = max(len(group), 8)
        while r // 2 >= n and r > 8:
            r //= 2
        return r

    def batch_args(self, group, mp0) -> dict:
        """phase_a's static arguments for one formed group."""
        jm = self.join_mode
        if jm == "dense_pos" and mp0.index_chain_band != self.db.band:
            jm = "dense"   # gidp was baked for a different repeat band
        icap, ccap = self._caps_for(group[0][7], group)
        return dict(A=group[0][7], I_CAP=icap, C_CAP=ccap, L_CAP=self.L_CAP,
                    band=mp0.index_chain_band, fl=mp0.fragment_length,
                    pcl=min(mp0.fragment_length // 2, mp0.bp_chain_band),
                    max_gap=mp0.max_gap_length,
                    anchor_score=mp0.anchor_score,
                    min_anchors=mp0.min_anchors, min_score=mp0.min_score,
                    gen_mode=self.gen_mode, join_mode=jm,
                    compact_dp=self.compact_dp,
                    compact_wide=self._compact_wide_ok)

    def batch_index(self, group) -> torch.Tensor:
        """The stacked (2, R) query/ref rows of one group on the device."""
        r_b = self._r_shape(group)
        ab = np.zeros((2, r_b), dtype=np.int32)
        for w, item in enumerate(group):
            ab[0, w] = item[1]
            ab[1, w] = item[2]
        return torch.from_numpy(ab).to(self.device)

    def _dispatch_phase_a(self, group, mp0):
        """Enqueue one batch and start its device->host copy; returns
        (host tensor, event or None, icap, ccap)."""
        args = self.batch_args(group, mp0)
        ph = phase_a(self.db.arrays, self.batch_index(group), **args)
        if ph.device.type == "cuda":
            # the copy starts the moment compute finishes and overlaps the
            # next batch's device work; the event marks its completion
            host = torch.empty(ph.shape, dtype=ph.dtype, pin_memory=True)
            host.copy_(ph, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            return host, ev, args["I_CAP"], args["C_CAP"]
        return ph, None, args["I_CAP"], args["C_CAP"]

    def _exact_pair(self, out, t, ri, qi, mp) -> None:
        """One overflow row on the exact per-pair path (applies GBDT)."""
        from ..ani import chain_seeds_native
        with stats.span("overflow_fallback"):
            out[t] = chain_seeds_native(self.sketches[ri],
                                        self.sketches[qi], mp)

    def _overflow_row(self, out, t, ri, qi, mp, fallback=None) -> None:
        """An overflow row: counted here, scored on the exact per-pair
        path by `fallback(t, ri, qi, mp)` (run_pairs hands it to its
        overflow threads) or, without one, here."""
        stats.add("pairs_overflow")
        if fallback is not None:
            fallback(t, ri, qi, mp)
        else:
            self._exact_pair(out, t, ri, qi, mp)

    def _process_batch_native(self, group, packed, out, icap, ccap,
                              fallback=None):
        """One native call for the whole batch's post-readback work:
        unpack + overlap resolution + rank answering + estimator tail +
        trimmed mean + bootstrap CI (native/skani_core.cpp
        finalize_device_batch); overflow rows take the exact per-pair
        path (_overflow_row)."""
        from .. import native
        from ..ani import AniEstResult
        from ..gbdt import predict_from_ani_res_batch
        from . import rank_host

        lib = native.get_lib()
        n = len(group)
        # the readback's layout: 1 = packed (6 interval words + 1 chunk
        # word), 0 = unpacked (10 + 3)
        layout = 1 if self.gen_mode == "sorted_packed" else 0
        k_a = np.empty(n, np.int64)
        c_a = np.empty(n, np.int64)
        sw_a = np.empty(n, np.uint8)
        am_a = np.empty(n, np.uint8)
        mlc_a = np.empty(n, np.int64)
        rb_a = np.empty(n, np.uint8)
        md_a = np.empty(n, np.uint8)
        bc_a = np.empty(n, np.float64)
        fc_a = np.empty(n, np.float64)
        ql_a = np.empty(n, np.int64)
        rl_a = np.empty(n, np.int64)
        addrs = np.zeros((3, n), np.int64)
        lens = np.zeros((3, n), np.int64)
        keep = []   # keep the table arrays alive across the C call
        for w, (_t, a, b, sw, mp, ri, qi, _ba) in enumerate(group):
            k_a[w] = mp.k
            c_a[w] = int(self.sketches[ri].c)
            sw_a[w] = 1 if sw else 0
            am_a[w] = 1 if mp.amino_acid else 0
            mlc_a[w] = mp.min_length_cover
            rb_a[w] = 1 if mp.robust else 0
            md_a[w] = 1 if mp.median else 0
            bc_a[w] = mp.both_frac_cover_cutoff
            fc_a[w] = mp.frac_cover_cutoff
            ql_a[w] = self.sketches[qi].total_sequence_length
            rl_a[w] = self.sketches[ri].total_sequence_length
            qsk, rsk = self.sketches[a], self.sketches[b]
            packed_all, own_excl, _rep, _cnt = rank_host._tables(
                qsk, mp.index_chain_band)
            banned = rank_host.pair_banned_positions(qsk, rsk,
                                                     mp.index_chain_band)
            for s, t_arr in enumerate((packed_all, own_excl, banned)):
                addrs[s, w] = t_arr.ctypes.data if len(t_arr) else 0
                lens[s, w] = len(t_arr)
                keep.append(t_arr)
        out_f = np.zeros((n, 6), np.float64)
        out_i = np.zeros((n, 4), np.int64)
        packed = np.ascontiguousarray(packed, np.int32)
        lib.finalize_device_batch(
            packed, packed.shape[1], n, icap, ccap, layout,
            k_a, c_a, sw_a, am_a, mlc_a, rb_a, md_a, bc_a, fc_a, ql_a,
            rl_a,
            np.ascontiguousarray(addrs[0]), np.ascontiguousarray(lens[0]),
            np.ascontiguousarray(addrs[1]), np.ascontiguousarray(lens[1]),
            np.ascontiguousarray(addrs[2]), np.ascontiguousarray(lens[2]),
            out_f.reshape(-1), out_i.reshape(-1),
            job_threads(getattr(self.command_params, "threads", 1)))
        del keep
        f32 = np.float32
        fresh, fresh_model = [], None
        for w, (t, _a, _b, sw, mp, ri, qi, _ba) in enumerate(group):
            status = out_i[w, 0]
            if status == 2:       # overflow -> exact per-pair fallback
                self._overflow_row(out, t, ri, qi, mp, fallback)
                continue
            if status == 1:       # no chains -> nan result
                r = AniEstResult()
                r.ani = float("nan")
                out[t] = r
                continue
            ref = self.sketches[ri]
            q = self.sketches[qi]
            qt = _contig_quants(q)
            rt = _contig_quants(ref)
            res = AniEstResult(
                ani=float(f32(out_f[w, 0])),
                align_fraction_query=float(f32(out_f[w, 1])),
                align_fraction_ref=float(f32(out_f[w, 2])),
                ref_file=ref.file_name,
                query_file=q.file_name,
                query_contig=q.contigs[0],
                ref_contig=ref.contigs[0],
                num_contigs_r=len(ref.contigs),
                num_contigs_q=len(q.contigs),
                ci_lower=float(f32(out_f[w, 3])),
                ci_upper=float(f32(out_f[w, 4])),
                aai=mp.amino_acid,
                quant_90_contig_len_q=qt[2], quant_90_contig_len_r=rt[2],
                quant_50_contig_len_q=qt[1], quant_50_contig_len_r=rt[1],
                quant_10_contig_len_q=qt[0], quant_10_contig_len_r=rt[0],
                std=float(f32(out_f[w, 5])),
                avg_chain_int_len=int(out_i[w, 1]),
                total_bases_covered=int(out_i[w, 3]),
            )
            if mp.model is not None:
                fresh.append(res)
                fresh_model = mp.model
            out[t] = res
        predict_from_ani_res_batch(fresh, fresh_model)

    def _unpack(self, packed: np.ndarray, icap: int, ccap: int):
        """Split one batch's readback into its fields: the packed layout
        (`sorted_packed`: 6 words an interval, 1 a chunk) or the unpacked
        one (10 and 3); the scalars (chunks, anchors, overflow) close
        both."""
        I, C = icap, ccap
        iv = {}
        if self.gen_mode == "sorted_packed":
            wm1 = packed[:, 0:I]
            wm2 = packed[:, I:2 * I]
            iv["valid"] = wm1 & 1
            iv["score"] = wm1 >> 11
            iv["num"] = (wm1 >> 1) & 0x3FF
            iv["q0"] = packed[:, 2 * I:3 * I]
            iv["q1"] = packed[:, 3 * I:4 * I]
            iv["r0"] = packed[:, 4 * I:5 * I]
            iv["r1"] = packed[:, 5 * I:6 * I]
            iv["cid"] = wm2 >> 7
            iv["rc"] = (wm2 >> 1) & 0x3F
            iv["rev"] = wm2 & 1
            o = 6 * I
            meta = packed[:, o:o + C]
            miss = meta < 0
            chunk_hi = np.where(miss, -1, meta >> 7)
            chunk_ctg = np.where(miss, -1, (meta >> 1) & 0x3F)
            chunk_new = np.where(miss, 0, meta & 1)
            o += C
        else:
            o = 0
            for name in ("valid", "score", "num", "q0", "q1", "r0", "r1",
                         "rc", "cid", "rev"):
                iv[name] = packed[:, o:o + I]
                o += I
            chunk_hi = packed[:, o:o + C]
            chunk_ctg = packed[:, o + C:o + 2 * C]
            chunk_new = packed[:, o + 2 * C:o + 3 * C]
            o += 3 * C
        n_chunks = packed[:, o]
        n_anchors = packed[:, o + 1]
        overflow = packed[:, o + 2]
        return iv, chunk_hi, chunk_ctg, chunk_new, n_chunks, n_anchors, \
            overflow

    def _host_process(self, group, packed, icap, ccap):
        """The Python batch finalize's host stage: unpack, overlap-resolve
        and aggregate each row's intervals (native.process_intervals_native)
        and answer its seed-rank queries from the host tables
        (rank_host.rank_queries).  Returns (per-row (records, totals) or
        None for an overflow row, per-row ranks)."""
        from .. import native
        from . import rank_host

        (iv_all, chunk_hi, chunk_ctg, chunk_new, n_chunks_v,
         _n_anchors, overflow) = self._unpack(packed, icap, ccap)
        ranks = []
        batch_recs = []
        for w, (_t, a, b, sw, mp, ri, _qi, _ba) in enumerate(group):
            if overflow[w]:
                batch_recs.append(None)
                ranks.append(None)
                continue
            m = iv_all["valid"][w].astype(bool)
            nm = int(m.sum())
            iv = dict(
                score=iv_all["score"][w][m].astype(np.float64),
                num=iv_all["num"][w][m].astype(np.int64),
                q0=iv_all["q0"][w][m].astype(np.uint32),
                q1=iv_all["q1"][w][m].astype(np.uint32),
                r0=iv_all["r0"][w][m].astype(np.uint32),
                r1=iv_all["r1"][w][m].astype(np.uint32),
                rc=iv_all["rc"][w][m].astype(np.int64),
                cid=iv_all["cid"][w][m].astype(np.int64),
                rev=iv_all["rev"][w][m].astype(np.uint8),
            )
            nch = int(n_chunks_v[w])
            # query contig of each interval = contig of its chunk
            iv["qc"] = chunk_ctg[w][iv["cid"]].astype(np.int64)
            recs, qc, qv, totals = native.process_intervals_native(
                iv, nm, chunk_hi[w][:nch].astype(np.int64),
                chunk_ctg[w][:nch].astype(np.int64),
                chunk_new[w][:nch].astype(np.uint8), nch,
                mp.k, int(self.sketches[ri].c), sw,
                mp.amino_acid, mp.min_length_cover)
            batch_recs.append((recs, totals))
            ranks.append(rank_host.rank_queries(
                self.sketches[a], self.sketches[b], mp.index_chain_band,
                np.asarray(qc), np.asarray(qv)))
        return batch_recs, ranks

    def _finalize_batch(self, group, batch_recs, ranks, out,
                        fallback=None):
        """The Python batch finalize's tail: per-chunk estimates
        (_finalize_chunks), then finalize_ani's trimmed mean, bootstrap CI
        and AF gates a row; overflow rows take the exact per-pair path
        (_overflow_row)."""
        from ..ani import finalize_ani
        from ..gbdt import predict_from_ani_res_batch

        fresh, fresh_model = [], None
        for w, (t, _a, _b, _sw, mp, ri, qi, _ba) in enumerate(group):
            ref = self.sketches[ri]
            q = self.sketches[qi]
            if batch_recs[w] is None:
                self._overflow_row(out, t, ri, qi, mp, fallback)
                continue
            recs, totals = batch_recs[w]
            ani_ests = self._finalize_chunks(recs, ranks[w], int(ref.c), mp)
            tqb, trr, avg_sum, num_chains = totals
            avg_len = avg_sum // num_chains if num_chains else 0
            res = finalize_ani(ani_ests, tqb, trr, avg_len, num_chains,
                               ref, q, mp, avg_already_divided=True)
            if mp.model is not None:
                fresh.append(res)
                fresh_model = mp.model
            out[t] = res
        # one batched tree-ensemble readout for the whole batch
        predict_from_ani_res_batch(fresh, fresh_model)

    @staticmethod
    def _finalize_chunks(recs: np.ndarray, rk: np.ndarray, c: int,
                         mp) -> list:
        """Per-chunk estimator tail (reference: src/chain.rs:326-396) from
        the aggregation records and the seed ranks, vectorized."""
        if len(recs) == 0:
            return []
        k = mp.k
        total_anchors = recs[:, 1].astype(np.float64)
        tbc_query = recs[:, 2]
        trq0 = recs[:, 3]
        trq1 = recs[:, 4]
        uoff = recs[:, 8]
        n_union = recs[:, 9]
        total_seeds = rk[uoff + 1] - rk[uoff]
        in_range = rk[uoff + 3] - rk[uoff + 2]
        # union sums (ragged): segment sums over consecutive query pairs
        tot_u = int(n_union.sum())
        if tot_u:
            seg = np.repeat(np.arange(len(recs)), n_union)
            base = np.repeat(uoff + 4, n_union)
            off = np.arange(tot_u) - np.repeat(
                np.cumsum(n_union) - n_union, n_union)
            lo_i = base + 2 * off
            in_union = np.bincount(
                seg, weights=(rk[lo_i + 1] - rk[lo_i]).astype(np.float64),
                minlength=len(recs))
        else:
            in_union = np.zeros(len(recs))
        with np.errstate(divide="ignore", invalid="ignore"):
            putative = np.power(total_anchors / in_union, 1.0 / k)
            considered = total_seeds.astype(np.int64).copy()
            switch = ((putative > 0.950) & (tbc_query > c * 4)
                      & (not mp.amino_acid)
                      & (trq1 - trq0 < 18000)
                      & (considered > 1.05 * in_range))
            considered = np.where(switch, in_range, considered)
            if mp.amino_acid:
                ml = np.minimum(1.0, total_anchors / considered * 6.0)
                weights = (total_seeds // 6).astype(np.int64)
            else:
                ml = np.minimum(1.0, total_anchors / considered)
                weights = considered
            ests = np.power(ml, 1.0 / k)
        return list(zip(ests.tolist(), weights.tolist()))

    @staticmethod
    def _mirror_result(res):
        """The (ref, query) -> (query, ref) mirror of a result.  chain_seeds
        canonicalizes the pair internally (switch_qr, reference:
        src/chain.rs:15-26), so the reverse-direction result is exactly the
        field-swapped copy."""
        import copy
        m = copy.copy(res)
        m.align_fraction_query, m.align_fraction_ref = \
            res.align_fraction_ref, res.align_fraction_query
        m.ref_file, m.query_file = res.query_file, res.ref_file
        m.ref_contig, m.query_contig = res.query_contig, res.ref_contig
        m.quant_90_contig_len_q, m.quant_90_contig_len_r = \
            res.quant_90_contig_len_r, res.quant_90_contig_len_q
        m.quant_50_contig_len_q, m.quant_50_contig_len_r = \
            res.quant_50_contig_len_r, res.quant_50_contig_len_q
        m.quant_10_contig_len_q, m.quant_10_contig_len_r = \
            res.quant_10_contig_len_r, res.quant_10_contig_len_q
        m.num_contigs_q, m.num_contigs_r = \
            res.num_contigs_r, res.num_contigs_q
        return m

    def plan(self, pairs: List[Tuple[int, int]]):
        """Pair bookkeeping of run_pairs: returns (out, meta, mirrors).
        `out` holds the results decided without the device (empty
        genomes), `meta` the (t, query row, ref row, switched, map params,
        ri, qi, bucket) items to score, sorted by (bucket, query row), and
        `mirrors` the (t, source t) duplicates of opposite orientation."""
        from ..ani import AniEstResult
        from ..chain import compute_switch
        from ..params import map_params_from_sketch

        out = [None] * len(pairs)
        meta = []
        seen = {}      # (ri, qi) -> output slot of the first occurrence
        mirrors = []   # (t, source slot)
        for t, (ri, qi) in enumerate(pairs):
            ref = self.sketches[ri]
            q = self.sketches[qi]
            mp = map_params_from_sketch(ref, self.sketch_params.use_aa,
                                        self.command_params, self.model)
            if len(ref.contig_lengths) == 0 or len(q.contig_lengths) == 0:
                r = AniEstResult()
                r.ani = float("nan")
                out[t] = r
                continue
            if (qi, ri) in seen:
                mirrors.append((t, seen[(qi, ri)]))
                continue
            if (ri, qi) not in seen:
                seen[(ri, qi)] = t
            sw = compute_switch(ref, q)
            meta.append((t, ri if sw else qi, qi if sw else ri, sw, mp,
                         ri, qi, self._bucket_a(ri, qi)))
        # group same-bucket pairs so each device batch runs at its own
        # (R, A) shape; the secondary key groups a bucket's pairs by QUERY
        # genome (results are order-independent)
        meta.sort(key=lambda m: (m[7], m[1]))
        return out, meta, mirrors

    def groups(self, meta):
        """The device batches run_pairs forms from `meta` when no host
        worker takes pairs, in order: at most _r_for rows of one bucket
        each."""
        return iter(_WorkQueue(meta, self._r_for).take_front, [])

    def run_pairs(self, pairs: List[Tuple[int, int]],
                  host_workers: Optional[int] = None):
        """Score pairs in pipelined batches: the device takes the batches
        of groups() from the front of a shared queue, with several in
        flight, and a finalize thread resolves batch k on the host while
        the device runs batch k+1.  `host_workers` steal-worker threads
        (default: default_host_workers()) take single pairs from the back
        of the queue and score them on the exact native path
        (chain_seeds_native); they start only where the queue holds more
        than two batches.  The finalize thread hands each overflow row to
        a pool of fallback_workers() threads, made at the first one,
        which score it on the same exact path while batches go on.  Both
        paths are exact, so the split never changes a result.
        SKANI_TPU_TIMING=1 prints one line a device batch to stderr.

        Spans (stats.py): `dispatch` and `readback` a batch on this
        thread, `finalize` a batch on the finalize thread,
        `overflow_fallback` around each overflow row's exact per-pair
        path on its pool thread, and `run_pairs_drain` from the first
        time no batch is left to dispatch until return (the last
        readbacks, the finalize queue's drain, the workers' joins, the
        overflow rows still running); each steal-worker adds its life to
        `steal_s` when it exits, and makes no torch call; neither does a
        fallback thread.

        Ordered duplicates of the same unordered pair are computed once and
        mirrored (the estimator is orientation-invariant by construction)."""
        import queue
        import time

        from ..ani import chain_seeds_native

        if host_workers is None:
            host_workers = default_host_workers()
        out, meta, mirrors = self.plan(pairs)
        work = _WorkQueue(meta, self._r_for)
        errors = []
        timing = os.environ.get("SKANI_TPU_TIMING") == "1"

        def host_loop():
            # native code and numpy only: no torch call on this thread
            t0 = time.perf_counter()
            try:
                while True:
                    item = work.take_back()
                    if item is None:
                        return
                    t, _a, _b, _sw, mp, ri, qi, _ba = item
                    try:
                        out[t] = chain_seeds_native(self.sketches[ri],
                                                    self.sketches[qi], mp)
                        stats.add("pairs_host")
                    except BaseException as e:   # surfaced after the join
                        errors.append(e)
                        return
            finally:
                stats.add("steal_s", time.perf_counter() - t0)

        pool, pending = [], []

        def fallback(t, ri, qi, mp):
            # only the one thread that finalizes batches calls this
            if not pool:
                pool.append(ThreadPoolExecutor(
                    fallback_workers(getattr(self.command_params,
                                             "threads", 1), host_workers),
                    thread_name_prefix="overflow_fallback"))
            pending.append(pool[0].submit(self._exact_pair, out, t, ri, qi,
                                          mp))

        def finalize(group, packed, icap, ccap, t_read):
            with stats.span("finalize") as fin:
                if self.py_finalize:
                    batch_recs, ranks = self._host_process(group, packed,
                                                           icap, ccap)
                    self._finalize_batch(group, batch_recs, ranks, out,
                                         fallback)
                else:
                    self._process_batch_native(group, packed, out, icap,
                                               ccap, fallback)
            stats.add("device_batches")
            stats.add("pairs_device", len(group))
            if timing:
                sys.stderr.write(f"# batch n={len(group)} readback "
                                 f"{1e3 * t_read:.1f}ms host+finalize "
                                 f"{1e3 * fin.seconds:.1f}ms\n")

        def read(entry):
            """Wait for one in-flight batch's copy; returns finalize args."""
            group, (host, ev, icap, ccap) = entry
            with stats.span("readback") as rb:
                if ev is not None:
                    ev.synchronize()
                packed = host.numpy()
            return group, packed, icap, ccap, rb.seconds

        def next_dispatch():
            group = work.take_front()
            if not group:
                return None
            with stats.span("dispatch"):
                return group, self._dispatch_phase_a(group, group[0][4])

        workers = []
        if host_workers > 0 and len(meta) > 2 * self.R:
            workers = [threading.Thread(target=host_loop)
                       for _ in range(host_workers)]
            for w in workers:
                w.start()
        fz = None
        if len(meta) > self.R:
            # dispatch and readback stay on this thread; the CPU-bound
            # native finalize runs on ONE worker thread so it overlaps the
            # next batches' device work
            fin_q = queue.Queue(maxsize=INFLIGHT)

            def finalize_loop():
                failed = False
                while True:
                    item = fin_q.get()
                    if item is None:
                        return
                    if failed:
                        continue     # drain so the producer never blocks
                    try:
                        finalize(*item)
                    except BaseException as e:   # surfaced after join
                        errors.append(e)
                        failed = True

            fz = threading.Thread(target=finalize_loop)
            fz.start()

            def consume(entry):
                fin_q.put(read(entry))
        else:
            def consume(entry):
                finalize(*read(entry))
        inflight = []
        drain = stats.span("run_pairs_drain")
        draining = False
        try:
            while True:
                entry = next_dispatch()
                if entry is not None:
                    inflight.append(entry)
                elif not draining:
                    drain.__enter__()
                    draining = True
                if (entry is None and inflight) or len(inflight) >= INFLIGHT:
                    consume(inflight.pop(0))
                if entry is None and not inflight:
                    break
        except BaseException:
            work.close()     # the device path failed: stop the workers
            for f in pending:
                f.cancel()
            raise
        finally:
            if fz is not None:
                fin_q.put(None)
                fz.join()
            for w in workers:
                w.join()
            if pool:
                pool[0].shutdown(wait=True)
                errors += [f.exception() for f in pending
                           if not f.cancelled() and f.exception()]
            if draining:
                drain.__exit__(None, None, None)
        if errors:
            raise errors[0]
        for t, src in mirrors:
            out[t] = self._mirror_result(out[src])
        stats.add("pairs_mirrored", len(mirrors))
        return out

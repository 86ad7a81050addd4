"""Row-local gathers and unique-target scatters (phase A's joins, `rg`
and fill).

Each kernel has its plain PyTorch version beside it:

* `row_gather(table, idx, rows=None)` -> out[r, a] = table[rows[r],
  idx[r, a]] (rows the identity when None), so that a caller gathers from
  a device table by genome id without copying the batch's rows first.
  Replaces skani_tpu/kernels/gather_pallas.py mxu_row_gather, whose table
  is the copy table[rows].
* `windowed_sorted_gather(table, idx, WB)` -> (out, ovf): the same gather
  for per-row nondecreasing idx, from a window of WB * 128 words placed per
  1024-index tile; an index outside its tile's window reads 0 and raises
  the row's overflow flag.  Replaces gather_pallas.py
  windowed_sorted_gather.
* `genome_map_gather(skid, a_idx, jw)` -> out[r, p] = jw[r, skid[a_idx[r],
  p]], without the (R, P) copy of skid[a_idx]: row_gather's kernel with a
  map on the index rows.  Replaces gather_pallas.py genome_map_gather.
* `row_scatter_multi(idx, vals, K)` -> out[r, v, idx[r, p]] = vals[r, v, p],
  zeros elsewhere; targets are unique per row and targets outside [0, K)
  are dropped.  Replaces gather_pallas.py mxu_row_scatter_multi_wide and
  mxu_row_scatter_multi (one contract).
* `row_scatter(idx, vals, K)` -> the single-payload scatter, out[r, idx[r,
  p]] = vals[r, p].  Replaces gather_pallas.py mxu_row_scatter; it launches
  the multi-payload kernel with V = 1 (V is 1, 2 or 3 on the card).

The TPU kernels build one-hot byte-plane matrix products because that
chip has no fast gather; their shape predicates, plane choices and VMEM
sizing exist only for that reason and do not carry over.  On the card all
are memory-bound kernels (csrc/gather.cu): coalesced index and output
streams, row-local table reads (for the windowed gather's ascending
indices, coalesced).  row_gather reads its table row through L2, or,
where the row fits in a block's shared memory (ROW_SMEM_WORDS) and the
shape makes a copy pay, from a copy that each block stages there unless
its first 32 indices are nondecreasing.  genome_map_gather's launch gives
each SM one jw row (sms / R blocks of 1024 threads a row), so that the
SM's L1 holds as much of that row as fits, where the R jw rows take at
most 3/5 of the L2 and either a row fits ROW_SMEM_WORDS or the grid keeps
nine tenths of the SMs busy; elsewhere one thread a position.  The
scatters own their output: a block zeroes a tile of one row's V planes in
shared memory, writes the payloads whose targets fall in it, and stores
it once; the tiles give each SM one block (more where a row's V planes
need more tiles to fit).

Dispatch rule: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.  There is no fallback from one to the other.
`LAUNCHES` counts kernel launches (CPU calls never count).
"""
from __future__ import annotations

import torch

from . import _build

#: kernel launches per entry point; reset by callers that want a window
LAUNCHES = {"row_gather": 0, "row_scatter_multi": 0,
            "windowed_sorted_gather": 0, "genome_map_gather": 0,
            "row_scatter": 0}

#: index tile of the windowed gather
WG_TILE = 1024


def _check_i32(name, *ts):
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")


#: the widest row (int32 words) that a block of the row_gather kernel
#: stages in its 227 KB of shared memory (less the mbarrier and a pad of
#: up to 3 words); wider rows are always read through L2
ROW_SMEM_WORDS = 58104


def row_gather_plain(table: torch.Tensor, idx: torch.Tensor,
                     rows=None) -> torch.Tensor:
    """Plain version: the rows' copy table[rows], then torch.gather along
    the row, indices clamped to the row like the kernel's."""
    if rows is not None:
        table = table[rows.clamp(0, table.shape[0] - 1).long()]
    K = table.shape[1]
    return torch.gather(table, 1, idx.clamp(0, K - 1).long())


def row_gather(table: torch.Tensor, idx: torch.Tensor,
               rows=None) -> torch.Tensor:
    """out[r, a] = table[rows[r], clamp(idx[r, a], 0, K - 1)] for an int32
    (G, K) table, int32 (R, A) idx and int32 (R,) rows, each row id
    clamped into [0, G); without rows, table is (R, K) and row r reads
    table row r.  Callers clip indices into range, as the TPU kernel
    required; the clamps only guarantee that no read leaves the table."""
    if table.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"row_gather: bad shapes {tuple(table.shape)}, "
                         f"{tuple(idx.shape)}")
    R = idx.shape[0]
    if rows is None and table.shape[0] != R \
            or rows is not None and tuple(rows.shape) != (R,):
        raise ValueError(f"row_gather: bad shapes {tuple(table.shape)}, "
                         f"{tuple(idx.shape)}, rows "
                         f"{None if rows is None else tuple(rows.shape)}")
    ts = [table, idx] + ([] if rows is None else [rows])
    if all(t.device.type == "cpu" for t in ts):
        return row_gather_plain(table, idx, rows)
    if table.device.type != "cuda" or any(t.device != table.device
                                          for t in ts):
        raise RuntimeError("row_gather: tensors must all lie on one CUDA "
                           "device or all on the CPU")
    _check_i32("row_gather", *ts)
    G, K = table.shape
    A = idx.shape[1]
    if R > 65535 or K < 1 or G < 1:
        raise ValueError(f"row_gather: unsupported shape R={R}, G={G}, "
                         f"K={K}")
    out = torch.empty((R, A), dtype=torch.int32, device=table.device)
    lib = _build.lib()
    _build.check(lib.skt_row_gather(
        table.data_ptr(), idx.data_ptr(),
        None if rows is None else rows.data_ptr(), out.data_ptr(), G, R, K,
        A, _build.stream_ptr(table.device)), "row_gather")
    LAUNCHES["row_gather"] += 1
    return out


def windowed_gather_ok(U: int, A: int, WB: int = 64) -> bool:
    """The shapes windowed_sorted_gather takes: table width U a multiple of
    1024 and at least one window wide, index width A a multiple of the
    1024-index tile."""
    return U % 1024 == 0 and A % WG_TILE == 0 and U >= WB * 128


def _windowed_check(table, idx, WB):
    if table.dim() != 2 or idx.dim() != 2 \
            or table.shape[0] != idx.shape[0]:
        raise ValueError(f"windowed_sorted_gather: bad shapes "
                         f"{tuple(table.shape)}, {tuple(idx.shape)}")
    U, A = table.shape[1], idx.shape[1]
    if U % 1024 or A % WG_TILE or not 1 <= WB <= U // 128:
        raise ValueError(f"windowed_sorted_gather: unsupported U={U}, "
                         f"A={A}, WB={WB}")


def windowed_sorted_gather_plain(table: torch.Tensor, idx: torch.Tensor,
                                 WB: int = 64):
    """Plain version: per 1024-index tile, the window's first block is
    clip(min >> 7, 0, U/128 - WB); indices outside [lo, lo + WB*128) read
    0, and a tile with (max >> 7) - lo_blk >= WB flags its row."""
    _windowed_check(table, idx, WB)
    R, U = table.shape
    A = idx.shape[1]
    it = idx.reshape(R, A // WG_TILE, WG_TILE)
    lo_blk = torch.clamp(it.min(dim=2).values >> 7, 0, U // 128 - WB)
    ovf = (((it.max(dim=2).values >> 7) - lo_blk) >= WB).any(dim=1)
    rel = it - (lo_blk * 128)[:, :, None]
    inside = ((rel >= 0) & (rel < WB * 128)).reshape(R, A)
    vals = torch.gather(table, 1, idx.clamp(0, U - 1).long())
    return torch.where(inside, vals, torch.zeros_like(vals)), ovf


def windowed_sorted_gather(table: torch.Tensor, idx: torch.Tensor,
                           WB: int = 64):
    """(out, ovf) for int32 (R, U) table and per-row NONDECREASING int32
    (R, A) idx: out[r, a] = table[r, idx[r, a]] where the index lies in its
    tile's window, else 0; ovf[r] (bool) is set when some tile's range
    exceeded the window, and callers route such rows to an exact path.
    U must be a multiple of 1024, A of 1024, and 1 <= WB <= U/128."""
    _windowed_check(table, idx, WB)
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return windowed_sorted_gather_plain(table, idx, WB)
    if table.device.type != "cuda" or idx.device != table.device:
        raise RuntimeError("windowed_sorted_gather: tensors must both lie "
                           "on one CUDA device or both on the CPU")
    _check_i32("windowed_sorted_gather", table, idx)
    R, U = table.shape
    A = idx.shape[1]
    if R > 65535:
        raise ValueError(f"windowed_sorted_gather: unsupported R={R}")
    out = torch.empty((R, A), dtype=torch.int32, device=table.device)
    ovf = torch.empty((R,), dtype=torch.bool, device=table.device)
    lib = _build.lib()
    _build.check(lib.skt_windowed_gather(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), ovf.data_ptr(),
        R, U, A, int(WB), _build.stream_ptr(table.device)),
        "windowed_sorted_gather")
    LAUNCHES["windowed_sorted_gather"] += 1
    return out, ovf


def genome_map_gather_plain(skid: torch.Tensor, a_idx: torch.Tensor,
                            jw: torch.Tensor) -> torch.Tensor:
    """Plain version: materialise skid[a_idx] (genome ids clamped into
    [0, G)), then gather along the row, skid values clamped into [0, K)
    like the kernel's."""
    G, K = skid.shape[0], jw.shape[1]
    rows = a_idx.clamp(0, G - 1).long()
    return torch.gather(jw, 1, skid[rows].clamp(0, K - 1).long())


def genome_map_gather(skid: torch.Tensor, a_idx: torch.Tensor,
                      jw: torch.Tensor) -> torch.Tensor:
    """out[r, p] = jw[r, skid[a_idx[r], p]] for int32 skid (G, P), a_idx
    (R,) and jw (R, K), a_idx clamped into [0, G) and skid values into
    [0, K).  a_idx may come in any order.  Padding positions (skid == 0)
    read jw[:, 0]; the caller masks them."""
    if skid.dim() != 2 or jw.dim() != 2 or a_idx.dim() != 1 \
            or a_idx.shape[0] != jw.shape[0]:
        raise ValueError(f"genome_map_gather: bad shapes "
                         f"{tuple(skid.shape)}, {tuple(a_idx.shape)}, "
                         f"{tuple(jw.shape)}")
    devs = {skid.device.type, a_idx.device.type, jw.device.type}
    if devs == {"cpu"}:
        return genome_map_gather_plain(skid, a_idx, jw)
    if devs != {"cuda"} or not (skid.device == a_idx.device == jw.device):
        raise RuntimeError("genome_map_gather: tensors must all lie on one "
                           "CUDA device or all on the CPU")
    _check_i32("genome_map_gather", skid, a_idx, jw)
    G, P = skid.shape
    R, K = jw.shape
    if R > 65535 or K < 1 or G < 1:
        raise ValueError(f"genome_map_gather: unsupported G={G}, R={R}, "
                         f"K={K}")
    out = torch.empty((R, P), dtype=torch.int32, device=jw.device)
    lib = _build.lib()
    _build.check(lib.skt_genome_map_gather(
        skid.data_ptr(), a_idx.data_ptr(), jw.data_ptr(), out.data_ptr(),
        G, R, P, K, _build.stream_ptr(jw.device)), "genome_map_gather")
    LAUNCHES["genome_map_gather"] += 1
    return out


def row_scatter_multi_plain(idx: torch.Tensor, vals: torch.Tensor,
                            K: int) -> torch.Tensor:
    """Plain version: one masked scatter into a (R, V, K + 1) buffer whose
    last column absorbs the dropped targets."""
    R, V, P = vals.shape
    tgt = torch.where((idx >= 0) & (idx < K), idx,
                      torch.full_like(idx, K)).long()
    out = torch.zeros((R, V, K + 1), dtype=vals.dtype, device=vals.device)
    out.scatter_(2, tgt[:, None, :].expand(R, V, P), vals)
    return out[:, :, :K].contiguous()


def _launch_scatter(name, idx, vals, K):
    """Shared launch of csrc/gather.cu skt_row_scatter_multi for int32 idx
    (R, P) and vals (R, V, P) on one CUDA device; counts under `name`."""
    _check_i32(name, idx, vals)
    R, V, P = vals.shape
    if R > 65535 or not 1 <= V <= 3:
        raise ValueError(f"{name}: unsupported R={R}, V={V}")
    out = torch.empty((R, V, K), dtype=torch.int32, device=idx.device)
    lib = _build.lib()
    _build.check(lib.skt_row_scatter_multi(
        idx.data_ptr(), vals.data_ptr(), out.data_ptr(), R, V, P, int(K),
        _build.stream_ptr(idx.device)), name)
    LAUNCHES[name] += 1
    return out


def row_scatter_multi(idx: torch.Tensor, vals: torch.Tensor,
                      K: int) -> torch.Tensor:
    """out (R, V, K) int32 with out[r, v, idx[r, p]] = vals[r, v, p] and
    zeros elsewhere, for int32 idx (R, P) and vals (R, V, P), V in [1, 3]
    on the card.  Payloads are bit patterns (a uint32 word bitcast to
    int32 keeps its top bit).  Targets must be unique per row, in any
    order; targets outside [0, K) are dropped."""
    if idx.dim() != 2 or vals.dim() != 3 \
            or vals.shape[0] != idx.shape[0] \
            or vals.shape[2] != idx.shape[1]:
        raise ValueError(f"row_scatter_multi: bad shapes "
                         f"{tuple(idx.shape)}, {tuple(vals.shape)}")
    if idx.device.type == "cpu" and vals.device.type == "cpu":
        return row_scatter_multi_plain(idx, vals, K)
    if idx.device.type != "cuda" or vals.device != idx.device:
        raise RuntimeError("row_scatter_multi: tensors must both lie on "
                           "one CUDA device or both on the CPU")
    return _launch_scatter("row_scatter_multi", idx, vals, K)


def row_scatter_plain(idx: torch.Tensor, vals: torch.Tensor,
                      K: int) -> torch.Tensor:
    """Plain version: the multi-payload plain scatter with V = 1."""
    return row_scatter_multi_plain(idx, vals[:, None, :], K)[:, 0]


def row_scatter(idx: torch.Tensor, vals: torch.Tensor,
                K: int) -> torch.Tensor:
    """out (R, K) int32 with out[r, idx[r, p]] = vals[r, p] and zeros
    elsewhere, for int32 idx and vals (R, P).  Targets must be unique per
    row; targets outside [0, K) are dropped."""
    if idx.dim() != 2 or vals.shape != idx.shape:
        raise ValueError(f"row_scatter: bad shapes {tuple(idx.shape)}, "
                         f"{tuple(vals.shape)}")
    if idx.device.type == "cpu" and vals.device.type == "cpu":
        return row_scatter_plain(idx, vals, K)
    if idx.device.type != "cuda" or vals.device != idx.device:
        raise RuntimeError("row_scatter: tensors must both lie on one CUDA "
                           "device or both on the CPU")
    return _launch_scatter("row_scatter", idx, vals[:, None, :], K)[:, 0]

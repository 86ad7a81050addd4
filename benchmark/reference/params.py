"""Core constants and parameter structures.

These values ARE the spec: they mirror the reference implementation's tuning
constants (reference: src/params.rs:4-62) exactly, since ANI/AF output
compatibility depends on them.

A frozen copy of skani_tpu_torch/params.py, kept in the benchmark's reference so that no
change to the program moves it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

VERSION = "0.3.0-tpu"

# --- tuning constants (reference: src/params.rs) ---
INTERMEDIATE_WRITE_COUNT = 5000          # params.rs:9
D_FRAGMENT_LENGTH = 200000               # params.rs:13
STOP_CODON = 21                          # params.rs:14
DEFAULT_C = 125                          # params.rs:15
DEFAULT_C_AAI = 15                       # params.rs:16
DEFAULT_K = 15                           # params.rs:17
DEFAULT_K_AAI = 6                        # params.rs:18
D_MAX_GAP_LENGTH = 300.0                 # params.rs:19
D_MAX_GAP_LENGTH_AAI = 50.0              # params.rs:20
D_MAX_LIN_LENGTH = 5000.0                # params.rs:21
D_ANCHOR_SCORE_ANI = 20.0                # params.rs:22
D_ANCHOR_SCORE_AAI = 20.0                # params.rs:23
D_MIN_ANCHORS_ANI = 3                    # params.rs:24
D_MIN_ANCHORS_AAI = 5                    # params.rs:25
D_FRAC_COVER_CUTOFF = 15.0               # params.rs:27 (percent)
D_FRAC_COVER_CUTOFF_AA = 5.0             # params.rs:29 (percent)
ORF_SIZE = 30                            # params.rs:32
MARKER_C_DEFAULT = 1000                  # params.rs:33
K_MARKER_AA = 10                         # params.rs:34
K_MARKER_DNA = 21                        # params.rs:35
CHUNK_SIZE_DNA = 20000                   # params.rs:40
CHUNK_SIZE_AA = 20000                    # params.rs:41
MIN_LENGTH_CONTIG = 500                  # params.rs:42
MIN_LENGTH_COVER_AAI = 500               # params.rs:43
MIN_LENGTH_COVER = 500                   # params.rs:44
BP_CHAIN_BAND = 2500                     # params.rs:45
BP_CHAIN_BAND_AAI = 500                  # params.rs:46
SEARCH_AAI_CUTOFF_DEFAULT = 0.60         # params.rs:47
SEARCH_ANI_CUTOFF_DEFAULT = 0.80         # params.rs:48
SCREEN_MINIMUM_KMERS = 20                # params.rs:49
FULL_INDEX_THRESH = 50                   # params.rs:50
OVERLAP_ORTHOLOGOUS_FRACTION = 0.50      # params.rs:52
TOTAL_BASES_REGRESS_CUTOFF = 150000      # params.rs:53

FAST_C = 200                             # params.rs:56
SLOW_C = 30                              # params.rs:57
MEDIUM_C = 70                            # params.rs:58
SMALL_M = 200                            # params.rs:59

ASCII_N = 78                             # params.rs:61 ('N')
ASCII_N_SMALL = 110                      # params.rs:62 ('n')



def fragment_length_formula(_n: int, aa: bool) -> int:
    """reference: src/params.rs:125-134"""
    return CHUNK_SIZE_AA if aa else CHUNK_SIZE_DNA


class Mode:
    SKETCH = "sketch"
    DIST = "dist"
    TRIANGLE = "triangle"
    SEARCH = "search"


@dataclasses.dataclass
class CommandParams:
    """Per-command run configuration (reference: src/params.rs:95-123)."""
    screen: bool = False
    screen_val: float = 0.0
    mode: str = Mode.DIST
    out_file_name: str = ""
    ref_files: list = dataclasses.field(default_factory=list)
    query_files: list = dataclasses.field(default_factory=list)
    refs_are_sketch: bool = False
    queries_are_sketch: bool = False
    robust: bool = False
    median: bool = False
    sparse: bool = False
    full_matrix: bool = False
    diagonal: bool = False
    max_results: int = 10 ** 12
    individual_contig_q: bool = False
    individual_contig_r: bool = False
    min_aligned_frac: float = 0.15
    both_min_aligned_frac: float = -0.01
    keep_refs: bool = False
    est_ci: bool = False
    learned_ani: bool = False
    detailed_out: bool = False
    distance: bool = False
    rescue_small: bool = True
    separate_sketches: bool = False
    short_header: bool = False
    threads: int = 3                 # reference: src/cli.rs:41-42 (-t)
    shards: int = 0                  # multi-host DB shard manifest


@dataclasses.dataclass
class MapParams:
    """Resolved chaining parameters for one reference sketch
    (reference: src/params.rs:74-93, derived in src/chain.rs:88-142)."""
    fragment_length: int = CHUNK_SIZE_DNA
    max_gap_length: float = D_MAX_GAP_LENGTH
    anchor_score: float = D_ANCHOR_SCORE_ANI
    min_anchors: int = D_MIN_ANCHORS_ANI
    length_cutoff: int = CHUNK_SIZE_DNA
    frac_cover_cutoff: float = 0.15
    both_frac_cover_cutoff: float = -0.01
    length_cover_cutoff: int = 5000000
    index_chain_band: int = BP_CHAIN_BAND // DEFAULT_C
    k: int = DEFAULT_K
    amino_acid: bool = False
    min_score: float = D_MIN_ANCHORS_ANI * D_ANCHOR_SCORE_ANI * 0.75
    robust: bool = False
    median: bool = False
    bp_chain_band: int = BP_CHAIN_BAND
    min_length_cover: int = MIN_LENGTH_COVER
    model: Optional[object] = None


def map_params_from_sketch(ref_sketch, amino_acid: bool,
                           command_params: CommandParams,
                           model=None) -> MapParams:
    """reference: src/chain.rs:88-142"""
    max_gap_length = D_MAX_GAP_LENGTH_AAI if amino_acid else D_MAX_GAP_LENGTH
    anchor_score = D_ANCHOR_SCORE_AAI if amino_acid else D_ANCHOR_SCORE_ANI
    min_anchors = D_MIN_ANCHORS_AAI if amino_acid else D_MIN_ANCHORS_ANI
    min_length_cover = MIN_LENGTH_COVER_AAI if amino_acid else MIN_LENGTH_COVER
    fragment_length = fragment_length_formula(
        ref_sketch.total_sequence_length, amino_acid)
    frac_cover_cutoff = command_params.min_aligned_frac
    if frac_cover_cutoff < 0.0:
        frac_cover_cutoff = (D_FRAC_COVER_CUTOFF_AA if amino_acid
                             else D_FRAC_COVER_CUTOFF) / 100.0
    bp_chain_band = BP_CHAIN_BAND_AAI if amino_acid else BP_CHAIN_BAND
    return MapParams(
        fragment_length=fragment_length,
        max_gap_length=max_gap_length,
        anchor_score=anchor_score,
        min_anchors=min_anchors,
        length_cutoff=fragment_length,
        frac_cover_cutoff=frac_cover_cutoff,
        both_frac_cover_cutoff=command_params.both_min_aligned_frac,
        length_cover_cutoff=5000000,
        index_chain_band=bp_chain_band // ref_sketch.c,
        k=ref_sketch.k,
        amino_acid=amino_acid,
        min_score=min_anchors * anchor_score * 0.75,
        robust=command_params.robust,
        median=command_params.median,
        bp_chain_band=bp_chain_band,
        min_length_cover=min_length_cover,
        model=model,
    )

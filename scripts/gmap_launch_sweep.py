"""Both launches of genome_map_gather (K5, skani_tpu_torch/csrc/gather.cu)
at every row count R around the rule that picks between them, on one
NVIDIA GPU.

    python3 scripts/gmap_launch_sweep.py [--r-lo 12] [--r-hi 66]

csrc/gather.cu genome_map() launches K1's direct kernel row-affine (sms / R
blocks of 1024 threads a row, each SM's L1 serving one jw row, spans
started on 128-byte lines) where the R jw rows take at most 3/5 of the L2
and either a row fits kRowSmemWords or the grid keeps nine tenths of the
SMs busy; else genome_map_gather_kernel (one thread a position).  The
library picks one from the shape; this script compiles a harness that
includes gather.cu and launches each of the two itself, so that both run
at every R, and beside them the row-affine launch with spans that start
anywhere ("row_affine_any").  Shapes: the kmer
axes (P, K) of chip_smoke.py's contigs, slow and -c 20 batches, G 16,
a_idx with repeated genomes, skid random in [0, K) with a padded tail.
Each launch is first held exact against gather.genome_map_gather_plain,
then timed with CUDA events: around one launch made as inside a batch
(after a 64 MB write and a rewrite of jw), the median of 30; and over 30
back-to-back launches ("alone").  Prints the card's name and power limit,
one JSON line per (shape, R), and a summary: for the library's pick and
for either launch everywhere, the mean and the largest excess over the
faster of the two launches at each point, and the share of points within
2 % of it.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from skani_tpu_torch import synth  # noqa: E402
from skani_tpu_torch.kernels import _build, gather  # noqa: E402

# (name, P, K): the kmer axes of chip_smoke.py's batches
SHAPES = (("contigs", 45056, 38912), ("slow", 167936, 157696),
          ("c20", 253952, 235520))
G = 16

HARNESS = r"""
#include "%s"
extern "C" int sweep_row_affine(const void* skid, const void* a_idx,
                                const void* jw, void* out, int G, int R,
                                int P, int K, int nb, void* stream) {
  static const cudaError_t set = cudaFuncSetAttribute(
      row_gather_kernel<kDirectPer, kRowThreads, true>,
      cudaFuncAttributePreferredSharedMemoryCarveout, 0);
  if (set != cudaSuccess) return (int)set;
  row_gather_kernel<kDirectPer, kRowThreads, true>
      <<<dim3(nb, R), kRowThreads, 0, (cudaStream_t)stream>>>(
          (const int32_t*)jw, (const int32_t*)skid, (const int32_t*)a_idx,
          (int32_t*)out, G, K, P);
  return (int)cudaGetLastError();
}
// the row-affine launch with balanced spans that start anywhere (not
// rounded down to 128-byte lines)
template <int PER>
__global__ void __launch_bounds__(kRowThreads)
row_affine_any_kernel(const int32_t* __restrict__ table,
                      const int32_t* __restrict__ idx,
                      const int32_t* __restrict__ rows,
                      int32_t* __restrict__ out, int G, int K, int A) {
  const int64_t r = blockIdx.y;
  const int32_t* irow = idx + (int64_t)source_row(rows, (int)r, G) * A;
  int lo, hi;
  block_span(A, blockIdx.x, gridDim.x, lo, hi);
  const int w = lo + (int)threadIdx.x;
  int ix[PER];
  load_direct<PER>(irow, w, hi, ix);
  serve_direct<PER>(table + r * K, irow, out + r * A, w, hi, K, ix);
}
extern "C" int sweep_row_affine_any(const void* skid, const void* a_idx,
                                    const void* jw, void* out, int G,
                                    int R, int P, int K, int nb,
                                    void* stream) {
  static const cudaError_t set = cudaFuncSetAttribute(
      row_affine_any_kernel<kDirectPer>,
      cudaFuncAttributePreferredSharedMemoryCarveout, 0);
  if (set != cudaSuccess) return (int)set;
  row_affine_any_kernel<kDirectPer>
      <<<dim3(nb, R), kRowThreads, 0, (cudaStream_t)stream>>>(
          (const int32_t*)jw, (const int32_t*)skid, (const int32_t*)a_idx,
          (int32_t*)out, G, K, P);
  return (int)cudaGetLastError();
}
extern "C" int sweep_positions(const void* skid, const void* a_idx,
                               const void* jw, void* out, int G, int R,
                               int P, int K, void* stream) {
  genome_map_gather_kernel<<<dim3((P + kThreads - 1) / kThreads, R),
                             kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)skid, (const int32_t*)a_idx, (const int32_t*)jw,
      (int32_t*)out, G, P, K);
  return (int)cudaGetLastError();
}
"""


def build_harness():
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "gmap_launch_sweep.cu")
    so = os.path.join(_build.BUILD_DIR, "libgmap_launch_sweep.so")
    with open(src, "w") as f:
        f.write(HARNESS % os.path.join(_build.CSRC, "gather.cu"))
    subprocess.run([_build.nvcc_path(),
                    *[x for x in _build.NVCC_FLAGS if x != "-Xptxas=-v"],
                    "-shared", src, "-o", so], check=True)
    lib = ctypes.CDLL(so)
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    lib.sweep_row_affine.argtypes = [P_] * 4 + [I_] * 5 + [P_]
    lib.sweep_row_affine_any.argtypes = [P_] * 4 + [I_] * 5 + [P_]
    lib.sweep_positions.argtypes = [P_] * 4 + [I_] * 4 + [P_]
    return lib


def in_batch_ms(launch, jw, reps=30):
    flush = torch.empty(16 << 20, dtype=torch.int32, device="cuda")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    ts = []
    for _ in range(reps):
        flush.fill_(1)
        jw.add_(0)
        a.record()
        launch()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def alone_ms(launch, reps=30):
    launch()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        launch()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--r-lo", type=int, default=12)
    ap.add_argument("--r-hi", type=int, default=66)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("gmap_launch_sweep: needs an NVIDIA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    lib = build_harness()
    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    l2_mb = props.L2_cache_size / 2 ** 20
    st = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(29)
    rows = []
    for name, P, K in SHAPES:
        skid_np = rng.integers(0, K, (G, P)).astype(np.int32)
        skid_np[:, P - P // 30:] = 0
        skid = torch.from_numpy(skid_np).to(dev)
        for R in range(args.r_lo, args.r_hi + 1):
            a_np = np.sort(rng.integers(0, G, R)).astype(np.int32)
            a_t = torch.from_numpy(a_np).to(dev)
            jw = torch.from_numpy(synth.adversarial_words(rng, (R, K))
                                  ).to(dev)
            out = torch.empty((R, P), dtype=torch.int32, device=dev)
            nb = max(1, sms // R)
            ptrs = (skid.data_ptr(), a_t.data_ptr(), jw.data_ptr(),
                    out.data_ptr())
            launches = {
                "row_affine": lambda: _build.check(lib.sweep_row_affine(
                    *ptrs, G, R, P, K, nb, st), "row_affine"),
                "row_affine_any": lambda: _build.check(
                    lib.sweep_row_affine_any(*ptrs, G, R, P, K, nb, st),
                    "row_affine_any"),
                "positions": lambda: _build.check(lib.sweep_positions(
                    *ptrs, G, R, P, K, st), "positions")}
            want = gather.genome_map_gather_plain(skid, a_t, jw)
            # the launch csrc/gather.cu genome_map() picks
            row = {"shape": name, "G": G, "R": R, "P": P, "K": K,
                   "nb": nb, "busy_sms": min(sms, nb * R), "sms": sms,
                   "jw_mb": R * K * 4 / 2 ** 20, "l2_mb": l2_mb,
                   "rule": ("row_affine"
                            if sms // R >= 1
                            and 5 * 4 * R * K <= 3 * props.L2_cache_size
                            and (K <= gather.ROW_SMEM_WORDS
                                 or 10 * nb * R >= 9 * sms)
                            else "positions")}
            for k, launch in launches.items():
                out.fill_(-1)
                launch()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise RuntimeError(f"{name} R {R}: {k} differs from "
                                       f"the plain version")
                row[f"{k}_ms"] = in_batch_ms(launch, jw)
                row[f"{k}_alone_ms"] = alone_ms(launch)
            print(json.dumps(row), flush=True)
            rows.append(row)
            del jw, out, want
    # each choice's time over the faster of the two launches, point by
    # point: the rule's pick, and either launch everywhere
    summary = {}
    for t in ("", "_alone"):
        for choice in ("rule", "row_affine", "positions"):
            loss = [r[f"{r['rule'] if choice == 'rule' else choice}{t}_ms"]
                    / min(r[f"row_affine{t}_ms"], r[f"positions{t}_ms"]) - 1
                    for r in rows]
            summary[f"{choice}{t}"] = {
                "mean_loss": float(np.mean(loss)),
                "max_loss": float(np.max(loss)),
                "share_within_2pct": float(np.mean(np.array(loss) <= 0.02))}
    print(json.dumps({"points": len(rows), "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

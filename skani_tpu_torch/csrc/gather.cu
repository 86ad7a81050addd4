// Row-local gather and unique-target scatter for phase A (sm_90a).
//
// skt_row_gather replaces skani_tpu/kernels/gather_pallas.py
// mxu_row_gather (K1): out[r, a] = table[rows[r], idx[r, a]], with rows
// the identity when none is given.
// skt_genome_map_gather replaces gather_pallas.py genome_map_gather (K5):
// out[r, p] = jw[r, skid[a_idx[r], p]], which is K1's gather with a map
// on the INDEX rows (index row a_idx[r] of skid) instead of the table's;
// its row-affine launch is K1's direct kernel with that map (below).
// skt_row_scatter_multi replaces gather_pallas.py
// mxu_row_scatter_multi_wide (K2): out[r, v, idx[r, p]] = vals[r, v, p],
// zeros elsewhere, targets outside [0, K) dropped.  The same kernel serves
// gather_pallas.py mxu_row_scatter (K6) at V = 1 and
// mxu_row_scatter_multi (K7), whose contract is K2's, at V = 3.
// skt_windowed_gather replaces gather_pallas.py windowed_sorted_gather
// (K4): the gather for per-row nondecreasing indices that reads 0 outside
// a per-tile window and raises a per-row overflow flag.
//
// The TPU versions are one-hot byte-plane matrix products because that
// chip has no fast gather.  Hopper has one, so the kernels implement the
// contract directly, int32 words moved as bit patterns.  All are bound by
// memory traffic: the index and output streams are read and written
// coalesced (consecutive threads, consecutive columns).
//
// K1 reads one table row per index row; each block serves a contiguous
// span of one row's indices, in one of two ways:
//   * direct: consecutive lanes on consecutive indices, the table read
//     through L2: one index a thread where that fills the card at most
//     once (short launches are latency-bound), else 4 indices a thread in
//     flight (long ones stream).  Sorted indices touch few 32-byte
//     sectors a warp this way.
//   * staged: the block copies its row into dynamic shared memory by TMA
//     bulk copies (cp.async.bulk completing on an mbarrier) while its
//     threads load their first indices, then serves them from there with
//     int4 index loads and output stores: 4-byte bank reads instead of
//     the 32-byte sector that a random read pulls through L2.
// The launch offers staging where the shape makes it pay (a row of at most
// kRowSmemWords words, 227 KB, and a span of more indices than the row
// has sectors); each block of such a launch then stages only when its
// first 32 indices are not nondecreasing, because a sorted span reads
// fewer bytes directly than the copy of its row moves.
// The choice changes only where words are read from, never the result.
// Every stream keeps the default cache policy: phase A's next kernel reads
// the output, and evict-first hints on the index and output streams
// measured slower wherever the inputs were still in L2.
// `rows` (int32, clamped into [0, G)) maps output row r to table row
// rows[r], so callers pass a device table and the batch's genome ids
// instead of a per-batch copy of the rows.  K5's row-affine launch maps
// output row r to INDEX row a_idx[r] (clamped into [0, G)) and table row r.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// --- K1 ---

constexpr int kGatherThreads = 1024;  // a block of a staging launch
constexpr int kDirectThreads = 256;   // a block of a direct launch
constexpr int kRowThreads = 1024;     // a block of K5's launch
constexpr int kUnroll = 4;            // staged: index units in flight
constexpr int kDirectPer = 4;         // direct: indices in flight
constexpr int kBulkChunk = 16384;     // bytes per cp.async.bulk
// dynamic shared memory of one staging block (232,448 bytes): 16 bytes of
// mbarrier and flag, then a row of up to kRowSmemWords words at a pad of
// 0-3 words
constexpr int kSmemBytes = 232448;
constexpr int kRowSmemWords = (kSmemBytes - 16) / 4 - 4;

__device__ __forceinline__ int clamp_row(int j, int K) {
  return j < 0 ? 0 : (j >= K ? K - 1 : j);
}

__device__ __forceinline__ int source_row(const int32_t* rows, int r,
                                          int G) {
  return rows == nullptr ? r : clamp_row(rows[r], G);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// The pad (0-3 words) after a 16-byte aligned shared base at which the
// copy of a row starting at src begins, so that src's first 16-byte
// boundary lands on one of the copy's.
__device__ __forceinline__ int stage_pad(const int32_t* src) {
  const int head = (int)(((16u - ((unsigned)(uintptr_t)src & 15u)) & 15u)
                         >> 2);
  return (4 - head) & 3;
}

// Stages words [0, n) of src into dst[pad + i] (dst 16-byte aligned, pad =
// stage_pad(src)): the 16-byte aligned middle by TMA bulk copies that
// complete on `bar` (thread 0 sets the middle's bytes as expected, then
// issues them), the 0-3 words on either side by plain loads, which the
// caller's next barrier publishes.
__device__ __forceinline__ void stage_row(int32_t* dst, const int32_t* src,
                                          int n, uint64_t* bar) {
  const int pad = stage_pad(src);
  const int head = min((4 - pad) & 3, n);
  const int mid = (n - head) & ~3;
  if (threadIdx.x == 0) {
    const unsigned b = smem_addr(bar);
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
        "r"(mid * 4)
        : "memory");
    for (int off = 0; off < mid; off += kBulkChunk / 4) {
      const int w = min(kBulkChunk / 4, mid - off);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
          "bytes [%0], [%1], %2, [%3];\n" ::"r"(
              smem_addr(dst + pad + head + off)),
          "l"(src + head + off), "r"(w * 4), "r"(b)
          : "memory");
    }
  }
  const int t = threadIdx.x;
  if (t < head) dst[pad + t] = src[t];
  const int tail0 = head + mid;
  if (t < n - tail0) dst[pad + tail0 + t] = src[tail0 + t];
}

// The span of one block: units [lo, hi) of its row (a unit is 4 words
// where VEC, else one), spans balanced over nb blocks.
__device__ __forceinline__ void block_span(int units, int b, int nb,
                                           int& lo, int& hi) {
  lo = (int)((int64_t)units * b / nb);
  hi = (int)((int64_t)units * (b + 1) / nb);
}

template <bool VEC>
__device__ __forceinline__ void load_units(const int32_t* __restrict__ irow,
                                           int u, int hi,
                                           int (&ix)[kUnroll][4]) {
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int v = u + k * (int)blockDim.x;
    if (v < hi) {
      if constexpr (VEC) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(irow) + v);
        ix[k][0] = q.x;
        ix[k][1] = q.y;
        ix[k][2] = q.z;
        ix[k][3] = q.w;
      } else {
        ix[k][0] = __ldg(irow + v);
      }
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void store_units(int32_t* __restrict__ orow,
                                            int u, int hi, int K,
                                            const int (&ix)[kUnroll][4],
                                            const int32_t* s) {
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int v = u + k * (int)blockDim.x;
    if (v < hi) {
      if constexpr (VEC) {
        int4 o;
        o.x = s[clamp_row(ix[k][0], K)];
        o.y = s[clamp_row(ix[k][1], K)];
        o.z = s[clamp_row(ix[k][2], K)];
        o.w = s[clamp_row(ix[k][3], K)];
        reinterpret_cast<int4*>(orow)[v] = o;
      } else {
        orow[v] = s[clamp_row(ix[k][0], K)];
      }
    }
  }
}

// Serves units [lo, hi) of one index row from the staged row s: the first
// kUnroll units a thread are loaded before the row's arrival is awaited,
// so the index stream overlaps the copy.
template <bool VEC>
__device__ __forceinline__ void serve_staged(
    const int32_t* __restrict__ irow, int32_t* __restrict__ orow, int lo,
    int hi, int K, uint64_t* bar, const int32_t* s) {
  int ix[kUnroll][4];
  const int step = kUnroll * (int)blockDim.x;
  int u = lo + (int)threadIdx.x;
  load_units<VEC>(irow, u, hi, ix);
  __syncthreads();  // the plain-loaded ends of the row
  mbar_wait(bar, 0);
  while (u < hi) {
    store_units<VEC>(orow, u, hi, K, ix, s);
    u += step;
    load_units<VEC>(irow, u, hi, ix);
  }
}

// Loads the indices of one round of the direct path that starts at word
// w (words w + k * blockDim, k < PER, of [.., hi); 0 past hi).
template <int PER>
__device__ __forceinline__ void load_direct(const int32_t* __restrict__ irow,
                                            int w, int hi, int (&ix)[PER]) {
  const int n = (int)blockDim.x;
#pragma unroll
  for (int k = 0; k < PER; ++k)
    ix[k] = w + k * n < hi ? __ldg(irow + w + k * n) : 0;
}

// Serves words [w - threadIdx.x, hi) of one index row from the table row
// through L2, PER indices a thread in flight, the first round's indices ix
// already loaded from w.
template <int PER>
__device__ __forceinline__ void serve_direct(
    const int32_t* __restrict__ trow, const int32_t* __restrict__ irow,
    int32_t* __restrict__ orow, int w, int hi, int K, int (&ix)[PER]) {
  const int n = (int)blockDim.x;
  for (; w < hi; w += PER * n) {
    int v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) v[k] = __ldg(trow + clamp_row(ix[k], K));
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (w + k * n < hi) orow[w + k * n] = v[k];
    load_direct<PER>(irow, w + PER * n, hi, ix);
  }
}

// Direct launches: block x of row y serves span x of it.  K1 (MAP_IDX
// false) reads table row rows[y] (clamped into [0, G)) at index row y;
// K5 (MAP_IDX true) reads table row y at index row rows[y] (clamped into
// [0, G), G then the index rows' count), its spans (P / nb words) started
// on 128-byte lines.  Blocks of NT threads.
template <int PER, int NT, bool MAP_IDX>
__global__ void __launch_bounds__(NT)
row_gather_kernel(const int32_t* __restrict__ table,
                  const int32_t* __restrict__ idx,
                  const int32_t* __restrict__ rows,
                  int32_t* __restrict__ out, int G, int K, int A) {
  const int64_t r = blockIdx.y;
  const int64_t m = source_row(rows, (int)r, G);
  const int32_t* trow = table + (MAP_IDX ? r : m) * K;
  const int32_t* irow = idx + (MAP_IDX ? m : r) * A;
  int lo, hi;
  block_span(A, blockIdx.x, gridDim.x, lo, hi);
  if constexpr (MAP_IDX) {
    lo &= ~31;
    if (blockIdx.x + 1 < gridDim.x) hi &= ~31;
  }
  const int w = lo + (int)threadIdx.x;
  int ix[PER];
  load_direct<PER>(irow, w, hi, ix);
  serve_direct<PER>(trow, irow, out + r * A, w, hi, K, ix);
}

// Staging launches: block x of row y serves span x of it (spans of over
// 4 words a thread).  Each block loads its first direct round, then stages
// the row in its dynamic shared memory and serves from there unless its
// first 32 indices (warp 0's) are nondecreasing; then it reads directly.
template <bool VEC>
__global__ void __launch_bounds__(kGatherThreads)
row_gather_staged_kernel(const int32_t* __restrict__ table,
                         const int32_t* __restrict__ idx,
                         const int32_t* __restrict__ rows,
                         int32_t* __restrict__ out, int G, int K, int A) {
  extern __shared__ __align__(16) int32_t s_buf[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_buf);
  int* staged = s_buf + 2;
  const int64_t r = blockIdx.y;
  const int32_t* trow = table + (int64_t)source_row(rows, (int)r, G) * K;
  const int32_t* irow = idx + r * A;
  int32_t* orow = out + r * A;
  constexpr int W = VEC ? 4 : 1;
  int lo, hi;
  block_span(A / W, blockIdx.x, gridDim.x, lo, hi);
  const int w = lo * W + (int)threadIdx.x;
  int ix[kDirectPer];
  load_direct<kDirectPer>(irow, w, hi * W, ix);
  if (threadIdx.x < 32) {
    const int prev = __shfl_up_sync(0xffffffffu, ix[0], 1);
    const bool sorted =
        __all_sync(0xffffffffu, threadIdx.x == 0 || prev <= ix[0]);
    if (threadIdx.x == 0) {
      *staged = !sorted;
      if (!sorted) mbar_init(bar);
    }
  }
  __syncthreads();
  if (*staged) {
    int32_t* srow = s_buf + 4;
    stage_row(srow, trow, K, bar);
    serve_staged<VEC>(irow, orow, lo, hi, K, bar, srow + stage_pad(trow));
  } else {
    serve_direct<kDirectPer>(trow, irow, orow, w, hi * W, K, ix);
  }
}

// --- K2, K6, K7: the unique-target scatter, by output ownership ---
//
// Block x of row y owns words [x * T, x * T + T) of all V output planes of
// row y: it zeroes the tile in shared memory, reads the row's targets
// (int4 where P % 4 == 0, coalesced; from L2 after the row's first tile),
// writes the payloads whose targets fall inside the tile, and stores the
// tile once (int4 where K % 4 == 0).  Every output word is written once,
// by one block, in whole sectors, and the zero pass of its own is gone.
// A target outside [0, K) falls in no tile and is dropped.  Unique targets
// mean no two threads write one shared word: no atomics.

template <int V, bool VEC, int NT>
__global__ void __launch_bounds__(NT)
row_scatter_kernel(const int32_t* __restrict__ idx,
                   const int32_t* __restrict__ vals,
                   int32_t* __restrict__ out, int P, int K, int T,
                   bool out_vec) {
  extern __shared__ __align__(16) int32_t s_tile[];  // V planes of T words
  const int64_t r = blockIdx.y;
  const int t0 = (int)blockIdx.x * T;
  const unsigned n = (unsigned)min(T, K - t0);
  const int nt = (int)blockDim.x;
  for (int i = threadIdx.x; i < V * T / 4; i += nt)
    reinterpret_cast<int4*>(s_tile)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  const int32_t* irow = idx + r * P;
  const int32_t* vrow = vals + r * V * P;
  constexpr int W = VEC ? 4 : 1;
  const int units = P / W;
  for (int u = threadIdx.x; u < units; u += kUnroll * nt) {
    int ix[kUnroll][4];
    load_units<VEC>(irow, u, units, ix);
    unsigned rel[kUnroll][4];
    bool hit[kUnroll];
    int pv[kUnroll][V][4];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int v = u + k * nt;
      hit[k] = false;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        // unsigned: one compare rejects both sides of the tile
        rel[k][w] = (unsigned)ix[k][w] - (unsigned)t0;
        hit[k] |= v < units && rel[k][w] < n;
      }
      if (hit[k]) {
#pragma unroll
        for (int p = 0; p < V; ++p) {
          if constexpr (VEC) {
            const int4 q = __ldg(
                reinterpret_cast<const int4*>(vrow + (int64_t)p * P) + v);
            pv[k][p][0] = q.x;
            pv[k][p][1] = q.y;
            pv[k][p][2] = q.z;
            pv[k][p][3] = q.w;
          } else {
            pv[k][p][0] = __ldg(vrow + (int64_t)p * P + v);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (!hit[k]) continue;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (rel[k][w] < n) {
#pragma unroll
          for (int p = 0; p < V; ++p) s_tile[p * T + rel[k][w]] = pv[k][p][w];
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < V; ++p) {
    int32_t* orow = out + (r * V + p) * K + t0;
    const int32_t* src = s_tile + p * T;
    if (out_vec) {
      for (int i = threadIdx.x; i < (int)n / 4; i += nt)
        reinterpret_cast<int4*>(orow)[i] =
            reinterpret_cast<const int4*>(src)[i];
    } else {
      for (int i = threadIdx.x; i < (int)n; i += nt) orow[i] = src[i];
    }
  }
}

constexpr int kThreads = 256;

// K4.  One block per (row, tile of kTile indices).  The window is placed as
// the TPU kernel places it: lo_blk = clip(min(tile) >> 7, 0, UB - WB)
// blocks of 128 words, WB blocks wide.  An index outside the window reads
// 0, and a tile whose (max >> 7) - lo_blk >= WB sets the row's flag (every
// writer stores the same 1, so plain byte stores suffice).  Bound by bytes:
// the index and output streams are coalesced, and because the indices
// ascend, neighbouring threads read neighbouring table words, so the table
// is read about one 32-byte sector per eight indices straight from global
// memory; staging the window in shared memory first measured no faster
// and cost 32 KB a block.
constexpr int kTile = 1024;

__global__ void windowed_gather_kernel(
    const int32_t* __restrict__ table, const int32_t* __restrict__ idx,
    int32_t* __restrict__ out, uint8_t* __restrict__ ovf, int U, int A,
    int WB) {
  __shared__ int s_min[kThreads / 32], s_max[kThreads / 32];
  const int64_t r = blockIdx.y;
  const int a0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  constexpr int kPer = kTile / kThreads;
  int ix[kPer];
  int mn = INT32_MAX, mx = INT32_MIN;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    ix[k] = idx[r * A + a0 + k * kThreads + tid];
    mn = min(mn, ix[k]);
    mx = max(mx, ix[k]);
  }
  mn = __reduce_min_sync(0xffffffffu, mn);
  mx = __reduce_max_sync(0xffffffffu, mx);
  if ((tid & 31) == 0) {
    s_min[tid >> 5] = mn;
    s_max[tid >> 5] = mx;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    mn = min(mn, s_min[w]);
    mx = max(mx, s_max[w]);
  }
  const int UB = U >> 7;
  int lo_blk = mn >> 7;
  lo_blk = lo_blk < 0 ? 0 : (lo_blk > UB - WB ? UB - WB : lo_blk);
  if (tid == 0 && (mx >> 7) - lo_blk >= WB) ovf[r] = 1;
  const int32_t* src = table + r * U + (int64_t)lo_blk * 128;
  const unsigned n_words = (unsigned)WB * 128u;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    // unsigned compare: one test rejects both sides of the window
    const unsigned rel = (unsigned)ix[k] - (unsigned)(lo_blk * 128);
    out[r * A + a0 + k * kThreads + tid] =
        rel < n_words ? __ldg(src + rel) : 0;
  }
}

// K5, one thread a position (the form of the port's first K5 kernel),
// for the launches where the row-affine one does not pay (genome_map).
__global__ void genome_map_gather_kernel(const int32_t* __restrict__ skid,
                                         const int32_t* __restrict__ a_idx,
                                         const int32_t* __restrict__ jw,
                                         int32_t* __restrict__ out,
                                         int G, int P, int K) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int64_t r = blockIdx.y;
  const int j = clamp_row(skid[(int64_t)clamp_row(a_idx[r], G) * P + p], K);
  out[r * P + p] = __ldg(jw + r * K + j);
}

// K1's launches.  Staging (blocks of kGatherThreads) is offered where the
// row fits in a block's shared memory and where each block of one wave
// (the blocks the SMs hold at a time, shared among the R rows) then serves
// more indices than the row has 32-byte sectors (a random read pulls a
// sector per index; the copy moves the row once) and at least 4 a thread
// (else the copy's round trip outweighs what it saves).  Direct launches
// use blocks of kDirectThreads.
struct Card {
  int sms, smem_sm, reserved, threads_sm, l2;
};

const Card& card() {
  static Card c = [] {
    Card d{};
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&d.smem_sm,
                           cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    cudaDeviceGetAttribute(&d.reserved,
                           cudaDevAttrReservedSharedMemoryPerBlock, dev);
    cudaDeviceGetAttribute(&d.threads_sm,
                           cudaDevAttrMaxThreadsPerMultiProcessor, dev);
    cudaDeviceGetAttribute(&d.l2, cudaDevAttrL2CacheSize, dev);
    return d;
  }();
  return c;
}

int smem_bytes(int words) { return (16 + 4 * (words + 3) + 15) & ~15; }

template <bool VEC>
int gather(const int32_t* table, const int32_t* idx, const int32_t* rows,
           int32_t* out, int G, int R, int K, int A, cudaStream_t st) {
  const Card& c = card();
  if (K <= kRowSmemWords) {
    const int b = smem_bytes(K);
    const int resident = max(1, min(c.threads_sm / kGatherThreads,
                                    c.smem_sm / (b + c.reserved)));
    const int units = VEC ? A / 4 : A;
    const int nb = max(1, min(c.sms * resident / R, units / kGatherThreads));
    const int span = A / nb;
    if (span > K / 8 && span >= 4 * kGatherThreads) {
      // once, at the first launch
      static const cudaError_t set = cudaFuncSetAttribute(
          row_gather_staged_kernel<VEC>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
      if (set != cudaSuccess) return (int)set;
      row_gather_staged_kernel<VEC><<<dim3(nb, R), kGatherThreads, b, st>>>(
          table, idx, rows, out, G, K, A);
      return (int)cudaGetLastError();
    }
  }
  // direct: one index a thread where that fills the card at most once,
  // else kDirectPer, one block a kDirectThreads * that many indices
  if ((int64_t)A * R <= (int64_t)c.sms * c.threads_sm) {
    row_gather_kernel<1, kDirectThreads, false>
        <<<dim3((A + kDirectThreads - 1) / kDirectThreads, R),
            kDirectThreads, 0, st>>>(table, idx, rows, out, G, K, A);
  } else {
    constexpr int per_block = kDirectThreads * kDirectPer;
    row_gather_kernel<kDirectPer, kDirectThreads, false>
        <<<dim3((A + per_block - 1) / per_block, R), kDirectThreads, 0,
            st>>>(table, idx, rows, out, G, K, A);
  }
  return (int)cudaGetLastError();
}

// K5's launch.  skid's positions map to kmer ids in no order, so the jw
// reads are random: through L2 each pulls a 32-byte sector, and the rate
// of those requests, not DRAM, bounds the gather.  The row-affine launch
// (sms / R blocks of kRowThreads a row, the kernel asking for the largest
// L1 share of the SM's 256 KB) gives each SM one jw row, so that a row of
// up to kRowSmemWords words (the contigs and joins batches') is served
// from L1 after its first touch, as if staged, without the copy, and a
// wider one (slow, -c 20) hits L1 in proportion.  It takes that launch
// where the R jw rows take at most 3/5 of the L2 (else they thrash it:
// 1.03-2.1x slower at -c 20's width and R 34-66) and where either the row
// fits or the grid keeps nine tenths of the SMs busy (a wide row gains
// too little from L1 to pay for idle SMs).  Elsewhere one thread a
// position over the whole card, which reads one jw row at a time.  The
// rule is fitted on scripts/gmap_launch_sweep.py (R 12-66 at the contigs,
// slow and -c 20 widths).  skid rows are read once a row; rows that share
// a genome find theirs in L2.
int genome_map(const int32_t* skid, const int32_t* a_idx, const int32_t* jw,
               int32_t* out, int G, int R, int P, int K, cudaStream_t st) {
  const Card& c = card();
  const int nb = c.sms / R;
  const bool fits_l2 = 5 * 4 * (int64_t)R * K <= 3 * (int64_t)c.l2;
  if (nb >= 1 && fits_l2
      && (K <= kRowSmemWords || 10 * nb * R >= 9 * c.sms)) {
    static const cudaError_t set = cudaFuncSetAttribute(
        row_gather_kernel<kDirectPer, kRowThreads, true>,
        cudaFuncAttributePreferredSharedMemoryCarveout, 0);
    if (set != cudaSuccess) return (int)set;
    row_gather_kernel<kDirectPer, kRowThreads, true>
        <<<dim3(nb, R), kRowThreads, 0, st>>>(jw, skid, a_idx, out, G, K,
                                              P);
  } else {
    genome_map_gather_kernel<<<dim3((P + kThreads - 1) / kThreads, R),
                               kThreads, 0, st>>>(skid, a_idx, jw, out, G,
                                                  P, K);
  }
  return (int)cudaGetLastError();
}

// The scatter's tiles: at least as many a row as the V planes of a row
// need to fit a block's shared memory, else as many as give each SM one
// block of the R rows' (at most one block an SM: more tiles re-read each
// row's targets more often and measured slower); T a multiple of 4 words.
// A block has 1024 threads at V = 1 and 512 at V = 2 and 3, whose int4
// payload registers would spill at 1024.
constexpr int scatter_threads(int V) { return V == 1 ? 1024 : 512; }

template <int V, bool VEC>
int scatter(const int32_t* idx, const int32_t* vals, int32_t* out, int R,
            int P, int K, cudaStream_t st) {
  constexpr int kMaxT = (kSmemBytes / 4 / V) & ~3;
  constexpr int NT = scatter_threads(V);
  int nt = max((K + kMaxT - 1) / kMaxT, max(1, card().sms / R));
  const int T = min((((K + nt - 1) / nt) + 3) & ~3, kMaxT);
  nt = (K + T - 1) / T;
  static const cudaError_t set = cudaFuncSetAttribute(
      row_scatter_kernel<V, VEC, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (set != cudaSuccess) return (int)set;
  const bool out_vec = K % 4 == 0 && ((uintptr_t)out & 15) == 0;
  row_scatter_kernel<V, VEC, NT><<<dim3(nt, R), NT, 4 * V * T, st>>>(
      idx, vals, out, P, K, T, out_vec);
  return (int)cudaGetLastError();
}

template <int V>
int scatter_v(const int32_t* idx, const int32_t* vals, int32_t* out, int R,
              int P, int K, cudaStream_t st) {
  // int4 index and payload loads need every row 16-byte aligned
  const bool vec = P % 4 == 0 && ((uintptr_t)idx & 15) == 0
      && ((uintptr_t)vals & 15) == 0;
  return vec ? scatter<V, true>(idx, vals, out, R, P, K, st)
             : scatter<V, false>(idx, vals, out, R, P, K, st);
}

}  // namespace

// rows: int32 (R,) or null for the identity (then G == R).
extern "C" int skt_row_gather(const void* table, const void* idx,
                              const void* rows, void* out, int G, int R,
                              int K, int A, void* stream) {
  if (R <= 0 || A <= 0) return (int)cudaGetLastError();
  if (K < 1 || G < 1) return (int)cudaErrorInvalidValue;
  // int4 index loads and output stores need every row 16-byte aligned
  const bool vec = A % 4 == 0 && ((uintptr_t)idx & 15) == 0
      && ((uintptr_t)out & 15) == 0;
  const auto t = (const int32_t*)table;
  const auto i = (const int32_t*)idx;
  const auto m = (const int32_t*)rows;
  const auto o = (int32_t*)out;
  const auto st = (cudaStream_t)stream;
  return vec ? gather<true>(t, i, m, o, G, R, K, A, st)
             : gather<false>(t, i, m, o, G, R, K, A, st);
}

// V in [1, 3]; out (R, V, K) is written whole, zeros included.
extern "C" int skt_row_scatter_multi(const void* idx, const void* vals,
                                     void* out, int R, int V, int P, int K,
                                     void* stream) {
  if (R <= 0 || K <= 0) return (int)cudaGetLastError();
  if (P < 0) return (int)cudaErrorInvalidValue;
  const auto i = (const int32_t*)idx;
  const auto v = (const int32_t*)vals;
  const auto o = (int32_t*)out;
  const auto st = (cudaStream_t)stream;
  switch (V) {
    case 1: return scatter_v<1>(i, v, o, R, P, K, st);
    case 2: return scatter_v<2>(i, v, o, R, P, K, st);
    case 3: return scatter_v<3>(i, v, o, R, P, K, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int skt_windowed_gather(const void* table, const void* idx,
                                   void* out, void* ovf, int R, int U, int A,
                                   int WB, void* stream) {
  if (U % 128 != 0 || A % kTile != 0 || WB < 1 || WB > U / 128)
    return (int)cudaErrorInvalidValue;
  if (R > 0) {
    // ovf: R bytes (a bool per row), cleared here, set by the kernel
    cudaError_t e = cudaMemsetAsync(ovf, 0, (size_t)R, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  if (R > 0 && A > 0) {
    dim3 grid(A / kTile, R);
    windowed_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)table, (const int32_t*)idx, (int32_t*)out,
        (uint8_t*)ovf, U, A, WB);
  }
  return (int)cudaGetLastError();
}

// skid int32 (G, P), a_idx (R,), jw (R, K), out (R, P).
extern "C" int skt_genome_map_gather(const void* skid, const void* a_idx,
                                     const void* jw, void* out, int G, int R,
                                     int P, int K, void* stream) {
  if (R <= 0 || P <= 0) return (int)cudaGetLastError();
  if (K < 1 || G < 1) return (int)cudaErrorInvalidValue;
  return genome_map((const int32_t*)skid, (const int32_t*)a_idx,
                    (const int32_t*)jw, (int32_t*)out, G, R, P, K,
                    (cudaStream_t)stream);
}

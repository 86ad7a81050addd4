// Native pack of the DeviceDb's row tables (kernels/device_db.py): one pass
// a genome, written straight into row g of each final (G, K) / (G, P)
// table, padding included, on n_threads std::threads that take genomes
// one at a time.  Each row equals what device_db._pack_genome gives:
//
// * kmers / starts / counts from the sketch's CSR (seed_kmers,
//   seed_starts); padding KMER_SENTINEL, 0, 0.
// * pos / ctgc in CSR order, each k-mer's run sorted by (contig, position)
//   as unsigned 32-bit values (np.lexsort((pos, contig, kid))).  A run
//   already nondecreasing is copied as it is; any other is sorted stably,
//   so ties (duplicate seeds, AAI's legacy layout) keep their order.
//   ctgc = int32(contig * 2 + canon); padding 0 and CTG_SENTINEL * 2.
// * spos / sctgc / skid (only where the tables are given): the CSR-ordered
//   seeds sorted stably by (ctgc >> 1 as signed int32, position as
//   unsigned 32-bit), by an LSD radix sort over the key's bytes that vary,
//   which equals np.lexsort((p, c2 >> 1)); skid is the seed's k-mer slot.
// * n_pos.
//
// status[g]: 0 packed; 1 wider than (K, P) (the caller raises); 2 a
// genome this pass does not take (nk < 0: the caller's choice; or
// seed_starts not starting at 0, not ending at the seed count, or
// decreasing), left to the plain version.  Rows of status 1 and 2 are
// not written.  C ABI (ctypes); the GIL is released for the whole call.
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <utility>
#include <vector>

namespace {

constexpr uint32_t kKmerSentinel = 0xFFFFFFFFu;
constexpr int32_t kCtgPad = 0x3FFFFFFF * 2;

struct Tables {
    const uint64_t* kmers_at;
    const uint64_t* starts_at;
    const uint64_t* pos_at;
    const uint64_t* contig_at;
    const uint64_t* canon_at;
    const int64_t* nk;
    const int64_t* npos;
    int64_t K;
    int64_t P;
    uint32_t* kmers;
    int32_t* starts;
    int32_t* counts;
    int32_t* pos;
    int32_t* ctgc;
    int32_t* spos;   // null: no position-sorted tables (legacy)
    int32_t* sctgc;
    int32_t* skid;
    int32_t* n_pos;
    int8_t* status;
};

// One thread's buffers, grown to the widest genome it packs.
struct Scratch {
    std::vector<std::pair<uint64_t, uint32_t>> run;
    std::vector<int32_t> kid;
    std::vector<uint64_t> key, key2;
    std::vector<uint32_t> idx, idx2;
};

inline uint64_t run_key(uint32_t contig, uint32_t p) {
    return (uint64_t(contig) << 32) | p;
}

// Stable LSD radix sort of (key, idx) by key, one pass per byte that
// differs between keys; the result lands in s.key / s.idx.
void radix_sort(Scratch& s, int64_t n) {
    uint64_t differ = 0;
    for (int64_t i = 1; i < n; ++i) differ |= s.key[i] ^ s.key[0];
    s.key2.resize(n);
    s.idx2.resize(n);
    for (int b = 0; b < 8; ++b) {
        const int shift = 8 * b;
        if (((differ >> shift) & 0xFF) == 0) continue;
        int64_t count[257] = {0};
        for (int64_t i = 0; i < n; ++i) ++count[((s.key[i] >> shift) & 0xFF) + 1];
        for (int d = 0; d < 256; ++d) count[d + 1] += count[d];
        for (int64_t i = 0; i < n; ++i) {
            const int64_t at = count[(s.key[i] >> shift) & 0xFF]++;
            s.key2[at] = s.key[i];
            s.idx2[at] = s.idx[i];
        }
        s.key.swap(s.key2);
        s.idx.swap(s.idx2);
    }
}

int8_t pack_one(const Tables& t, int64_t g, Scratch& s) {
    const int64_t nk = t.nk[g], np = t.npos[g], K = t.K, P = t.P;
    if (nk < 0) return 2;
    if (nk > K || np > P) return 1;
    const int64_t* st = reinterpret_cast<const int64_t*>(t.starts_at[g]);
    if (st[0] != 0 || st[nk] != np) return 2;
    for (int64_t i = 0; i < nk; ++i)
        if (st[i + 1] < st[i]) return 2;
    const uint32_t* km = reinterpret_cast<const uint32_t*>(t.kmers_at[g]);
    const uint32_t* sp = reinterpret_cast<const uint32_t*>(t.pos_at[g]);
    const uint32_t* sc = reinterpret_cast<const uint32_t*>(t.contig_at[g]);
    const uint8_t* cn = reinterpret_cast<const uint8_t*>(t.canon_at[g]);

    uint32_t* kmers = t.kmers + g * K;
    int32_t* starts = t.starts + g * K;
    int32_t* counts = t.counts + g * K;
    if (nk) std::memcpy(kmers, km, nk * sizeof(uint32_t));
    std::fill(kmers + nk, kmers + K, kKmerSentinel);
    for (int64_t i = 0; i < nk; ++i) {
        starts[i] = int32_t(st[i]);
        counts[i] = int32_t(st[i + 1] - st[i]);
    }
    std::fill(starts + nk, starts + K, 0);
    std::fill(counts + nk, counts + K, 0);

    // CSR order, each run by (contig, position)
    int32_t* pos = t.pos + g * P;
    int32_t* ctgc = t.ctgc + g * P;
    const bool srt = t.spos != nullptr;
    if (srt) s.kid.resize(np);
    for (int64_t i = 0; i < nk; ++i) {
        const int64_t a = st[i], b = st[i + 1];
        bool sorted = true;
        for (int64_t j = a + 1; j < b && sorted; ++j)
            sorted = run_key(sc[j - 1], sp[j - 1]) <= run_key(sc[j], sp[j]);
        if (sorted) {
            for (int64_t j = a; j < b; ++j) {
                pos[j] = int32_t(sp[j]);
                ctgc[j] = int32_t(sc[j] * 2u + cn[j]);
            }
        } else {
            s.run.clear();
            for (int64_t j = a; j < b; ++j)
                s.run.emplace_back(run_key(sc[j], sp[j]), uint32_t(j));
            // (key, index) pairs are distinct, so this order is the
            // stable order by key
            std::sort(s.run.begin(), s.run.end());
            for (int64_t j = a; j < b; ++j) {
                const uint32_t o = s.run[j - a].second;
                pos[j] = int32_t(sp[o]);
                ctgc[j] = int32_t(sc[o] * 2u + cn[o]);
            }
        }
        if (srt)
            for (int64_t j = a; j < b; ++j) s.kid[j] = int32_t(i);
    }
    std::fill(pos + np, pos + P, 0);
    std::fill(ctgc + np, ctgc + P, kCtgPad);
    t.n_pos[g] = int32_t(np);
    if (!srt) return 0;

    // position-sorted order: (ctgc >> 1 signed, position unsigned), the
    // signed half biased so that unsigned order is signed order
    s.key.resize(np);
    s.idx.resize(np);
    for (int64_t j = 0; j < np; ++j) {
        const uint32_t c = uint32_t(ctgc[j] >> 1) ^ 0x80000000u;
        s.key[j] = (uint64_t(c) << 32) | uint32_t(pos[j]);
        s.idx[j] = uint32_t(j);
    }
    radix_sort(s, np);
    int32_t* spos = t.spos + g * P;
    int32_t* sctgc = t.sctgc + g * P;
    int32_t* skid = t.skid + g * P;
    for (int64_t j = 0; j < np; ++j) {
        const uint32_t o = s.idx[j];
        spos[j] = pos[o];
        sctgc[j] = ctgc[o];
        skid[j] = s.kid[o];
    }
    std::fill(spos + np, spos + P, 0);
    std::fill(sctgc + np, sctgc + P, kCtgPad);
    std::fill(skid + np, skid + P, 0);
    return 0;
}

}  // namespace

extern "C" {

// Packs genomes [g0, g1) on min(n_threads, g1 - g0) threads (at least
// one).  The five *_at arrays hold each genome's seed_kmers (uint32),
// seed_starts (int64), seed_pos (uint32), seed_contig (uint32) and
// seed_canon (one byte) addresses; nk / npos its k-mer and seed counts
// (nk -1: not taken, no address read).  kmers..ctgc are (G, K) / (G, P)
// tables, spos / sctgc / skid (G, P) or
// all three null, n_pos and status (G,).  Returns the genomes packed.
int64_t skt_db_pack(int64_t g0, int64_t g1, int64_t n_threads,
                    const uint64_t* kmers_at, const uint64_t* starts_at,
                    const uint64_t* pos_at, const uint64_t* contig_at,
                    const uint64_t* canon_at, const int64_t* nk,
                    const int64_t* npos, int64_t K, int64_t P,
                    uint32_t* kmers, int32_t* starts, int32_t* counts,
                    int32_t* pos, int32_t* ctgc, int32_t* spos,
                    int32_t* sctgc, int32_t* skid, int32_t* n_pos,
                    int8_t* status) {
    const Tables t{kmers_at, starts_at, pos_at, contig_at, canon_at, nk,
                   npos, K, P, kmers, starts, counts, pos, ctgc, spos,
                   sctgc, skid, n_pos, status};
    std::atomic<int64_t> next(g0);
    std::atomic<int64_t> packed(0);
    auto work = [&]() {
        Scratch s;
        int64_t mine = 0;
        for (int64_t g; (g = next.fetch_add(1)) < g1;) {
            status[g] = pack_one(t, g, s);
            mine += status[g] == 0;
        }
        packed += mine;
    };
    const int64_t n = std::max<int64_t>(
        1, std::min<int64_t>(n_threads, g1 - g0));
    std::vector<std::thread> threads;
    for (int64_t i = 1; i < n; ++i) threads.emplace_back(work);
    work();
    for (auto& th : threads) th.join();
    return packed;
}

}  // extern "C"

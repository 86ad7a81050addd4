// Native sketch pass over one FASTA file (sketch.py): the file's bytes to
// its Sketch arrays without the GIL, so that the `-t` pool's threads, one
// file each, run in parallel.  Three C entry points (ctypes releases the
// GIL around each call):
//
// 1. skt_fasta_parse: the file's bytes -> a table of its kept contigs and
//    their bases, back to back in one buffer, byte for byte as
//    fastx._iter_fasta reads them: a record starts at '>', its header runs
//    to the first '\n' (trailing '\r's stripped), its sequence runs to the
//    next "\n>" or the end, and only '\n' and '\r' are dropped from it.  A
//    contig is kept iff its length is at least `min_len`.  The caller has
//    checked that the first byte is '>'.
// 2. skt_sketch_seed: every contig of such a buffer seeded with the host
//    seeder's loop (native/skani_core.cpp fmh_seeds, the same arithmetic),
//    then assembled as skt_sketch_assemble does.
// 3. skt_sketch_assemble: a file's seeds in encounter order (contig by
//    contig, window order within each) and its markers -> the CSR of
//    sketch._finalize_sketch: seeds sorted stably by k-mer, the unique
//    k-mers with int64 starts ending in the seed count, positions,
//    canonical flags and contig indices in that order, and the sorted
//    unique markers.
//
// Both 2 and 3 return a handle holding the result and write its sizes to
// counts[0..2] (seeds, unique k-mers, markers; seeds and k-mers 0 unless
// `seed`); skt_sketch_take copies the result into the caller's arrays and
// frees the handle.  C ABI (ctypes).
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

// 2-bit DNA codes (reference: src/types.rs:40-49); anything else is 0
struct Codes {
    uint64_t v[256];
    constexpr Codes() : v{} {
        v['C'] = 1; v['G'] = 2; v['T'] = 3; v['U'] = 3;
        v['c'] = 1; v['g'] = 2; v['t'] = 3; v['u'] = 3;
    }
};
constexpr Codes kCodes{};

// the reference's mm_hash64 variant (native/skani_core.cpp)
inline uint64_t mm_hash64(uint64_t key) {
    key = ~(key + (key << 21));
    key = key ^ (key >> 24);
    key = (key + (key << 3)) + (key << 8);
    key = key ^ (key >> 14);
    key = (key + (key << 2)) + (key << 4);
    key = key ^ (key >> 28);
    key = key + (key << 31);
    return key;
}

struct Result {
    std::vector<uint32_t> kmers;
    std::vector<int64_t> starts;
    std::vector<uint32_t> pos;
    std::vector<uint8_t> canon;
    std::vector<uint32_t> contig;
    std::vector<uint64_t> markers;
};

// Seeds of one contig, appended in window order (reference:
// src/seeding.rs:225-323; native/skani_core.cpp fmh_seeds line for line).
void seed_contig(const uint8_t* seq, int64_t len, uint32_t j, int64_t c,
                 int64_t k, int64_t marker_c, std::vector<uint32_t>& kmer_out,
                 std::vector<uint32_t>& pos_out,
                 std::vector<uint8_t>& canon_out,
                 std::vector<uint32_t>& contig_out,
                 std::vector<uint64_t>& marker_out) {
    const int64_t mk = 21;
    if (len < 2 * mk) return;
    const uint64_t seed_mask = (~0ULL) >> (64 - 2 * k);
    const uint64_t marker_mask = (~0ULL) >> (64 - 2 * mk);
    const uint64_t marker_rev_mask = ~(3ULL << (2 * mk - 2));
    const int marker_shift = 2 * (mk - 1);
    const uint64_t thr = (~0ULL) / (uint64_t)c;
    const uint64_t thr_m = (~0ULL) / (uint64_t)marker_c;
    uint64_t f = 0, r = 0;
    for (int64_t i = 0; i < mk - 1; i++) {
        uint64_t nf = kCodes.v[seq[i]];
        f = (f << 2) | nf;
        r = (r >> 2) | ((3 - nf) << marker_shift);
    }
    int64_t resume_ind = 0;
    for (int64_t i = mk - 1; i < len; i++) {
        uint8_t b = seq[i];
        if (b == 'N' || b == 'n') resume_ind = i + k;
        uint64_t nf = kCodes.v[b];
        f = ((f << 2) | nf) & marker_mask;
        r = ((r >> 2) & marker_rev_mask) | ((3 - nf) << marker_shift);
        uint64_t fs = f & seed_mask, rs = r & seed_mask;
        bool canon = fs < rs;
        uint64_t kmer = canon ? fs : rs;
        uint64_t h = mm_hash64(kmer);
        if (h < thr && resume_ind <= i) {
            kmer_out.push_back((uint32_t)kmer);
            pos_out.push_back((uint32_t)i);
            canon_out.push_back(canon ? 1 : 0);
            contig_out.push_back(j);
            if (h < thr_m) marker_out.push_back(f < r ? f : r);
        }
    }
}

// The CSR of n seeds in encounter order: a stable LSD radix sort of
// (k-mer << 32 | index) on the k-mer's bytes that vary, so that ties keep
// their index order (np.argsort(kind="stable")), then np.unique's starts.
void assemble(const uint32_t* kmer, const uint32_t* pos, const uint8_t* canon,
              const uint32_t* contig, int64_t n, Result& out) {
    if (n == 0) return;
    std::vector<uint64_t> a(n), b(n);
    uint32_t differ = 0;
    for (int64_t i = 0; i < n; ++i) {
        a[i] = (uint64_t(kmer[i]) << 32) | uint64_t(i);
        differ |= kmer[i] ^ kmer[0];
    }
    for (int d = 0; d < 4; ++d) {
        const int shift = 32 + 8 * d;
        if (((differ >> (8 * d)) & 0xFF) == 0) continue;
        int64_t count[257] = {0};
        for (int64_t i = 0; i < n; ++i) ++count[((a[i] >> shift) & 0xFF) + 1];
        for (int v = 0; v < 256; ++v) count[v + 1] += count[v];
        for (int64_t i = 0; i < n; ++i)
            b[count[(a[i] >> shift) & 0xFF]++] = a[i];
        a.swap(b);
    }
    out.pos.resize(n);
    out.canon.resize(n);
    out.contig.resize(n);
    out.kmers.reserve(n);
    out.starts.reserve(n + 1);
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t km = uint32_t(a[i] >> 32);
        const uint32_t at = uint32_t(a[i]);
        if (i == 0 || km != out.kmers.back()) {
            out.kmers.push_back(km);
            out.starts.push_back(i);
        }
        out.pos[i] = pos[at];
        out.canon[i] = canon[at];
        out.contig[i] = contig[at];
    }
    out.starts.push_back(n);
}

void unique_markers(std::vector<uint64_t>& m) {
    std::sort(m.begin(), m.end());
    m.erase(std::unique(m.begin(), m.end()), m.end());
}

void write_counts(const Result& r, int64_t* counts) {
    counts[0] = int64_t(r.pos.size());
    counts[1] = int64_t(r.kmers.size());
    counts[2] = int64_t(r.markers.size());
}

// Copies [from, end) into out, less every '\r'; returns the bytes written.
inline int64_t copy_line(const uint8_t* from, const uint8_t* end,
                         uint8_t* out) {
    int64_t w = 0;
    while (from < end) {
        const void* cr = memchr(from, '\r', size_t(end - from));
        const uint8_t* stop = cr ? static_cast<const uint8_t*>(cr) : end;
        memcpy(out + w, from, size_t(stop - from));
        w += stop - from;
        from = cr ? stop + 1 : end;
    }
    return w;
}

}  // namespace

extern "C" {

// rec: `cap` rows of (header offset, header length, base offset, base
// length), one a kept contig, header spans into `data`, base spans into
// `out` (which must hold n bytes).  Returns the kept contigs, or -1 where
// more than `cap` are kept.
int64_t skt_fasta_parse(const uint8_t* data, int64_t n, int64_t min_len,
                        uint8_t* out, int64_t* rec, int64_t cap) {
    int64_t pos = 0, w = 0, kept = 0;
    while (pos < n) {
        const int64_t h0 = pos + 1;
        const void* nl = memchr(data + pos, '\n', size_t(n - pos));
        int64_t h1, len = 0;
        if (!nl) {
            h1 = n;
            pos = n;
        } else {
            int64_t q = static_cast<const uint8_t*>(nl) - data;
            h1 = q;
            // lines until "\n>" or the end; q is at a '\n'
            for (;;) {
                if (q + 1 < n && data[q + 1] == '>') {
                    pos = q + 1;
                    break;
                }
                const int64_t s = q + 1;
                if (s >= n) {
                    pos = n;
                    break;
                }
                const void* e = memchr(data + s, '\n', size_t(n - s));
                const int64_t stop = e ? static_cast<const uint8_t*>(e) - data
                                       : n;
                len += copy_line(data + s, data + stop, out + w + len);
                if (!e) {
                    pos = n;
                    break;
                }
                q = stop;
            }
        }
        while (h1 > h0 && data[h1 - 1] == '\r') --h1;
        if (len >= min_len) {
            if (kept == cap) return -1;
            int64_t* row = rec + 4 * kept;
            row[0] = h0;
            row[1] = h1 > h0 ? h1 - h0 : 0;
            row[2] = w;
            row[3] = len;
            w += len;
            ++kept;
        }
    }
    return kept;
}

// offs: n_contigs + 1 offsets of the contigs in `bases`.
void* skt_sketch_seed(const uint8_t* bases, const int64_t* offs,
                      int64_t n_contigs, int64_t c, int64_t k,
                      int64_t marker_c, int32_t seed, int64_t* counts) {
    auto* res = new Result();
    const int64_t total = offs[n_contigs] - offs[0];
    const size_t guess = size_t(total / (c > 0 ? c : 1)) * 5 / 4 + 64;
    std::vector<uint32_t> kmer, pos, contig;
    std::vector<uint8_t> canon;
    kmer.reserve(guess);
    pos.reserve(guess);
    canon.reserve(guess);
    contig.reserve(guess);
    res->markers.reserve(guess / 4 + 64);
    for (int64_t j = 0; j < n_contigs; ++j)
        seed_contig(bases + offs[j], offs[j + 1] - offs[j], uint32_t(j), c, k,
                    marker_c, kmer, pos, canon, contig, res->markers);
    if (seed)
        assemble(kmer.data(), pos.data(), canon.data(), contig.data(),
                 int64_t(kmer.size()), *res);
    unique_markers(res->markers);
    write_counts(*res, counts);
    return res;
}

// offs: n_contigs + 1 offsets of each contig's seeds in kmer / pos /
// canon, from 0.
void* skt_sketch_assemble(const uint32_t* kmer, const uint32_t* pos,
                          const uint8_t* canon, const int64_t* offs,
                          int64_t n_contigs, const uint64_t* markers,
                          int64_t n_markers, int32_t seed, int64_t* counts) {
    auto* res = new Result();
    if (seed) {
        const int64_t n = offs[n_contigs];
        std::vector<uint32_t> contig(n);
        for (int64_t j = 0; j < n_contigs; ++j)
            std::fill(contig.begin() + offs[j], contig.begin() + offs[j + 1],
                      uint32_t(j));
        assemble(kmer, pos, canon, contig.data(), n, *res);
    }
    res->markers.assign(markers, markers + n_markers);
    unique_markers(res->markers);
    write_counts(*res, counts);
    return res;
}

// Copies the handle's arrays into the caller's (sized by counts) and
// frees it.
void skt_sketch_take(void* handle, uint32_t* kmers, int64_t* starts,
                     uint32_t* pos, uint8_t* canon, uint32_t* contig,
                     uint64_t* markers) {
    auto* r = static_cast<Result*>(handle);
    auto put = [](const auto& v, auto* dst) {
        if (!v.empty()) memcpy(dst, v.data(), v.size() * sizeof(v[0]));
    };
    put(r->kmers, kmers);
    put(r->starts, starts);
    put(r->pos, pos);
    put(r->canon, canon);
    put(r->contig, contig);
    put(r->markers, markers);
    delete r;
}

}  // extern "C"

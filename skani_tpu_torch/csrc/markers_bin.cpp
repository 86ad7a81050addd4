// Native walk over a markers.bin: bincode (SketchParams, Vec<Sketch>) of
// markers-only sketches (reference: src/file_io.rs:720-729), the layout of
// db._write_sketch(..., markers_only=True).  db.read_markers_bin parses the
// SketchParams header and the sketch count in Python, then:
//
// 1. skt_markers_scan walks the N sketches without writing to the file's
//    bytes: one row of scalars a sketch, and every name (the file name,
//    then its contigs) followed by '\n' into one blob.  It accepts only
//    what the Python walker would read without error and with no seeds,
//    no multi-position storage and no contig lengths, and only names free
//    of '\n'; anything else returns nonzero and the Python walker reads
//    the untouched bytes.
// 2. skt_markers_compact, after the blob decoded as UTF-8, moves every
//    sketch's markers down to the front of the same buffer, one contiguous
//    8-byte-aligned uint64 column, and sorts a run only where it is not
//    already nondecreasing.  A run never moves up: the bytes before a
//    marker hold at least the earlier runs, so the write never overtakes
//    the read.
//
// Every count is checked by division against the bytes left, never by a
// product that could overflow; no read passes `len`.  C ABI (ctypes).
#include <algorithm>
#include <cstdint>
#include <cstring>

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "bincode is little-endian; the column is read in place");

namespace {

// One row of uint64 a sketch; the order db._markers_native reads.
enum Col {
    kNContigs, kTotalLength, kNMarkers, kMarkerC, kC, kK, kContigOrder,
    kIndividualContig, kAminoAcid, kMarkersAt, kCols
};

struct Cursor {
    const uint8_t* buf;
    uint64_t off;
    uint64_t end;

    uint64_t left() const { return end - off; }

    bool u64(uint64_t* v) {
        if (left() < 8) return false;
        std::memcpy(v, buf + off, 8);
        off += 8;
        return true;
    }

    bool u8(uint64_t* v) {
        if (left() < 1) return false;
        *v = buf[off++];
        return true;
    }

    // A bincode String, appended to the blob with a '\n' after it.
    bool string(uint8_t* blob, uint64_t cap, uint64_t* at) {
        uint64_t n;
        if (!u64(&n) || n > left() || n >= cap - *at) return false;
        const uint8_t* s = buf + off;
        if (n && std::memchr(s, '\n', n)) return false;
        std::memcpy(blob + *at, s, n);
        blob[*at + n] = '\n';
        *at += n + 1;
        off += n;
        return true;
    }
};

}  // namespace

extern "C" {

// Walks n sketches of buf[off:len].  Fills rows (n x kCols), the blob
// (capacity blob_cap) and out = {blob bytes, markers in all}.  Returns 0
// when every sketch was accepted, 1 otherwise (rows and blob then hold
// nothing of use).
int64_t skt_markers_scan(const uint8_t* buf, int64_t len, int64_t off,
                         int64_t n, uint64_t* rows, uint8_t* blob,
                         int64_t blob_cap, int64_t* out) {
    if (off < 0 || len < off || n < 0 || blob_cap < 0) return 1;
    Cursor r{buf, (uint64_t)off, (uint64_t)len};
    uint64_t at = 0, cap = (uint64_t)blob_cap, markers = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t* row = rows + i * kCols;
        uint64_t v, count;
        if (!r.string(blob, cap, &at)) return 1;            // file_name
        if (!r.u8(&v) || v != 0) return 1;                  // seeds
        if (!r.u64(&count) || count != 0) return 1;         // multi-pos
        if (!r.u64(&count) || count > r.left() / 8) return 1;
        row[kNContigs] = count;
        for (uint64_t j = 0; j < count; ++j)
            if (!r.string(blob, cap, &at)) return 1;
        if (!r.u64(&row[kTotalLength])) return 1;
        if (!r.u64(&count) || count != 0) return 1;         // lengths
        if (!r.u64(&v)) return 1;                           // repetitive
        if (!r.u64(&count) || count > r.left() / 8) return 1;
        row[kNMarkers] = count;
        row[kMarkersAt] = r.off;
        r.off += count * 8;
        markers += count;
        for (int c : {kMarkerC, kC, kK, kContigOrder})
            if (!r.u64(&row[c])) return 1;
        if (!r.u8(&row[kIndividualContig]) || !r.u8(&row[kAminoAcid]))
            return 1;
    }
    out[0] = (int64_t)at;
    out[1] = (int64_t)markers;
    return 0;
}

// Moves the n sketches' marker runs, as skt_markers_scan found them, to
// the front of buf (8-byte aligned) in order, sorting each run that is
// not nondecreasing.
void skt_markers_compact(uint8_t* buf, int64_t n, const uint64_t* rows) {
    uint64_t* col = reinterpret_cast<uint64_t*>(buf);
    uint64_t at = 0;
    for (int64_t i = 0; i < n; ++i) {
        const uint64_t* row = rows + i * kCols;
        uint64_t m = row[kNMarkers];
        uint64_t* run = col + at;
        std::memmove(run, buf + row[kMarkersAt], m * 8);
        if (!std::is_sorted(run, run + m)) std::sort(run, run + m);
        at += m;
    }
}

}  // extern "C"

// Native entropy-coded-segment scanners for jpeglibrary_tpu_torch.host.
//
// This is the TPU framework's host-side runtime component: JPEG entropy
// decode is bit-serial and branchy — the one stage that cannot live on
// the TPU — so it runs here as optimized C++, writing dense zig-zag
// coefficient planes that ship straight to the device transform
// kernels.
//
// Semantics mirror the reference decoders exactly (citations into
// yigolden/JpegLibrary/src/JpegLibrary):
//  - bit reader with 0xFF-stuffing removal and 1-bit padding past the
//    end of data (JpegBitReader.cs:95-172)
//  - two-level Huffman lookup: 8-bit lookahead + maxcode/valoffset
//    slow path (JpegHuffmanDecodingTable.cs:63-113)
//  - baseline block decode incl. the Min(i, 63) corrupt-stream clamp
//    (JpegHuffmanBaselineScanDecoder.cs:179-223)
//  - restart handling resets DC predictors per segment
//    (JpegHuffmanBaselineScanDecoder.cs:140-163)
//
// Restart segments are decoded in parallel across threads: each RSTn
// segment starts at a known MCU index with fresh predictors, so the
// work partitions with no shared mutable state.
//
// Build: see native/build.py (g++ -O3 -shared, cached by source hash).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdio>
#include <memory>
#include <thread>
#include <vector>

#if defined(__BMI2__) && defined(__SSE2__)
#include <immintrin.h>
#define JPX_HAVE_REFINE_FAST 1
#endif

namespace {

// ---------------------------------------------------------------------------
// Huffman decoding table (fixed-layout blob shared with Python)
// ---------------------------------------------------------------------------

#pragma pack(push, 1)
struct HuffTable {
    uint16_t lookahead[256];  // (code_size << 8) | symbol_value; 0 = slow path
    uint16_t maxcode[18];
    uint8_t valoffset[19];
    uint8_t values[256];
    uint8_t pad[1];  // total 824 bytes
};
#pragma pack(pop)

static_assert(sizeof(HuffTable) == 824, "HuffTable layout drifted from Python packer");

// ---------------------------------------------------------------------------
// Bit reader over one entropy span (raw bytes, unstuffing on the fly)
// ---------------------------------------------------------------------------

struct BitReader {
    const uint8_t* p;
    const uint8_t* end;
    uint64_t bits;     // left-justified bit buffer
    int count;         // valid bits in buffer
    bool exhausted;    // ran past the real data (now serving 1-padding)

    void init(const uint8_t* data, int64_t len) {
        p = data;
        end = data + len;
        bits = 0;
        count = 0;
        exhausted = false;
    }

    // Refill to >= 48 bits, emulating JpegBitReader.FillBuffer
    // (JpegBitReader.cs:95-138): 0xFF00 -> 0xFF, 0xFF-fill runs
    // collapse, end pads with 1-bits (without counting them).
    //
    // Fast path: when the next 8 raw bytes contain no 0xFF (detected
    // with one SWAR test), bulk-insert as many whole bytes as fit —
    // this serves the vast majority of refills at ~1 load per 7 bytes
    // instead of a branchy per-byte loop.
    // always_inline: an out-of-line fill() takes &this, which blocks
    // scalar replacement of `bits`/`count` — the hot loops then pay a
    // stack store->load round trip on the critical bit-buffer chain
    // every symbol (measured ~20% of scan time).
    __attribute__((always_inline)) inline void fill() {
        while (count <= 56) {
            if (end - p >= 8) {
                uint64_t v;
                std::memcpy(&v, p, 8);
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
                v = __builtin_bswap64(v);
#endif
                // any byte == 0xFF  <=>  ~v has a zero byte
                uint64_t inv = ~v;
                if ((((inv - 0x0101010101010101ULL) & ~inv) &
                     0x8080808080808080ULL) == 0) {
                    int s = (64 - count) >> 3;  // whole bytes that fit (>=1)
                    uint64_t w = v & (~0ULL << (64 - 8 * s));
                    bits |= w >> count;
                    count += 8 * s;
                    p += s;
                    continue;  // count is now > 56
                }
            }
            if (p >= end) { exhausted = true; break; }
            uint8_t b = *p;
            if (b != 0xFF) {
                ++p;
            } else {
                const uint8_t* q = p + 1;
                while (q < end && *q == 0xFF) ++q;
                if (q >= end) { p = end; exhausted = true; break; }
                if (*q == 0x00) {
                    p = q + 1;  // deliver the 0xFF literal
                } else {
                    // marker inside span (shouldn't happen: spans are
                    // pre-split) — treat as end of data
                    p = end;
                    exhausted = true;
                    break;
                }
            }
            bits |= (uint64_t)b << (56 - count);
            count += 8;
        }
    }

    // Peek `n` (<=16) bits, 1-padded past the end. Returns the bits and
    // sets `avail` to how many were real.
    inline uint32_t peek(int n, int* avail) {
        if (count < n) fill();
        uint64_t window = bits | (count >= 64 ? 0 : (~0ULL >> (count == 0 ? 0 : count)));
        if (count == 0) window = ~0ULL;
        *avail = count < n ? count : n;
        return (uint32_t)(window >> (64 - n));
    }

    inline void advance(int n) {
        if (n > count) n = count;
        bits <<= n;
        count -= n;
    }

    // Read exactly n bits; returns -1 if not enough real bits remain
    // (TryReadBits failure, JpegBitReader.cs:190-206).
    inline int32_t read(int n) {
        if (n == 0) return 0;
        if (count < n) fill();
        if (count < n) return -1;
        uint32_t v = (uint32_t)(bits >> (64 - n));
        bits <<= n;
        count -= n;
        return (int32_t)v;
    }
};

// Huffman symbol decode: 16-bit peek + two-level lookup
// (JpegHuffmanScanDecoder.DecodeHuffmanCode, JpegHuffmanScanDecoder.cs:81-98
//  and JpegHuffmanDecodingTable.Lookup/LookupSlow).
// Returns symbol value, or -1 on invalid code.
static inline int decode_huffman(BitReader& br, const HuffTable* t) {
    int avail;
    uint32_t code16 = br.peek(16, &avail);
    int entry = t->lookahead[code16 >> 8];
    int size = entry >> 8;
    int value;
    if (size != 0) {
        value = entry & 0xFF;
    } else {
        size = 9;
        while (size <= 16 && code16 > t->maxcode[size]) ++size;
        if (size > 16) return -1;
        uint32_t code = code16 >> (16 - size);
        value = t->values[(uint8_t)(t->valoffset[size] + code)];
    }
    br.advance(size < avail ? size : avail);
    return value;
}

// ITU-T T.81 EXTEND, branchless (JpegHuffmanScanDecoder.cs:100-116).
static inline int32_t extend(int32_t v, int nbits) {
    return v - ((((v + v) >> nbits) - 1) & ((1 << nbits) - 1));
}

// receive_and_extend; *err set on premature end.
static inline int32_t receive_extend(BitReader& br, int nbits, int* err) {
    int32_t v = br.read(nbits);
    if (v < 0) { *err = 1; return 0; }
    return extend(v, nbits);
}

// ---------------------------------------------------------------------------
// Baseline scan
// ---------------------------------------------------------------------------

struct Component {
    int h, v;
    const HuffTable* dc;
    const HuffTable* ac;
    int16_t* plane;    // [Hb, Wb, 64] zig-zag
    int64_t wb;        // plane width in blocks
    const uint32_t* dc_comb = nullptr;  // combined symbol+EXTEND tables
    const uint32_t* ac_comb = nullptr;  // (COMB_BITS-indexed), may be null
};

// ---------------------------------------------------------------------------
// Combined symbol+EXTEND lookahead
// ---------------------------------------------------------------------------
//
// One table load resolves the Huffman code AND its appended EXTEND
// value bits whenever code_len + ssss <= COMB_BITS: the value bits are
// part of the table index, so the entry stores the fully sign-extended
// coefficient (or DC diff) and the total advance. This folds the
// dependent load->shift->extract->EXTEND chain of the hot loop
// (decode_huffman_hot + manual bit pulls) into load->shift. Entry
// layout: bits[0:5] total advance (0 = not covered, fall back),
// bits[5:9] run (AC) , bit 9 = zero-ssss class (EOB/ZRL), bits[16:32]
// value as int16. 2^COMB_BITS * 4 bytes per table (4 KB at 10 bits —
// measured fastest on the 4.2 MP q75 asset: 10 beats 8/9/11/12; the six
// hot tables must share L1d with the bitstream and the emitter buffer).
static constexpr int COMB_BITS = 10;
static constexpr uint32_t COMB_SZERO = 1u << 9;

struct CombTable {
    uint32_t e[1 << COMB_BITS];
};

// Enumerate the canonical codes straight out of a packed HuffTable
// (mincode chain: next_min doubles entering each length, maxcode_raw =
// maxcode[l] >> (16-l) for present lengths; absent lengths have
// maxcode[l] == 0 — exact for l < 16, and a length-16-only table is
// degenerate and merely loses acceleration).
static void build_comb_table(const HuffTable* t, bool is_dc, CombTable* out) {
    std::memset(out->e, 0, sizeof(out->e));
    uint32_t next_min = 0;
    for (int l = 1; l <= 16; ++l) {
        next_min <<= 1;
        if (t->maxcode[l] == 0) continue;  // absent (l==16 raw-0: degenerate, skip)
        uint32_t maxr = (uint32_t)t->maxcode[l] >> (16 - l);
        if (maxr < next_min) continue;
        for (uint32_t code = next_min; code <= maxr; ++code) {
            int symbol = t->values[(uint8_t)(t->valoffset[l] + code)];
            int s = is_dc ? symbol : (symbol & 15);
            int r = is_dc ? 0 : (symbol >> 4);
            int total = l + s;
            if (total > COMB_BITS || (is_dc && s > 15)) continue;
            // All COMB_BITS patterns with this code prefix; the next s
            // bits are the EXTEND raw value.
            int pad = COMB_BITS - total;
            uint32_t base = code << (s + pad);
            for (uint32_t raw = 0; raw < (1u << s); ++raw) {
                int32_t val =
                    s == 0 ? 0
                           : ((int32_t)raw < (1 << (s - 1))
                                  ? (int32_t)raw - (1 << s) + 1
                                  : (int32_t)raw);  // ITU-T81 EXTEND
                uint32_t entry = (uint32_t)total | ((uint32_t)r << 5) |
                                 (s == 0 ? COMB_SZERO : 0) |
                                 ((uint32_t)(uint16_t)(int16_t)val << 16);
                uint32_t lo = base | (raw << pad);
                for (uint32_t fill = 0; fill < (1u << pad); ++fill)
                    out->e[lo + fill] = entry;
            }
        }
        next_min = maxr + 1;
    }
}

// Decode one 8x8 block (JpegHuffmanBaselineScanDecoder.ReadBlockBaseline).
// Returns 0 ok, 1 bitstream-end, 2 invalid code.
static inline int read_block_baseline(BitReader& br, const Component& c,
                                      int32_t& predictor, int16_t* out) {
    std::memset(out, 0, 64 * sizeof(int16_t));
    int err = 0;
    int t = decode_huffman(br, c.dc);
    if (t < 0) return 2;
    int32_t diff = 0;
    if (t != 0) {
        diff = receive_extend(br, t, &err);
        if (err) return 1;
    }
    predictor += diff;
    out[0] = (int16_t)predictor;

    int i = 1;
    while (i < 64) {
        int s = decode_huffman(br, c.ac);
        if (s < 0) return 2;
        int r = s >> 4;
        s &= 15;
        if (s != 0) {
            i += r;
            int32_t val = receive_extend(br, s, &err);
            if (err) return 1;
            out[i < 63 ? i : 63] = (int16_t)val;
            ++i;
        } else {
            if (r == 0) break;
            i += 16;
        }
    }
    return 0;
}

struct SpanTask {
    const uint8_t* data;
    int64_t len;
    int64_t first_mcu;   // global MCU index this span starts at
    int64_t n_mcus;      // MCUs to decode in this span (may hit end of image)
};

// Decode a run of MCUs from one span with fresh DC predictors.
static int decode_span(const SpanTask& task, Component* comps, int n_comps,
                       int64_t mcus_per_line, int64_t mcu_row_offset = 0) {
    BitReader br;
    br.init(task.data, task.len);
    std::vector<int32_t> pred(n_comps, 0);
    int16_t block[64];

    for (int64_t m = 0; m < task.n_mcus; ++m) {
        int64_t mcu = task.first_mcu + m;
        int64_t row = mcu / mcus_per_line - mcu_row_offset;
        int64_t col = mcu % mcus_per_line;
        for (int ci = 0; ci < n_comps; ++ci) {
            Component& c = comps[ci];
            for (int y = 0; y < c.v; ++y) {
                int64_t by = row * c.v + y;
                for (int x = 0; x < c.h; ++x) {
                    int64_t bx = col * c.h + x;
                    int rc = read_block_baseline(br, c, pred[ci], block);
                    if (rc == 2) return 2;
                    if (rc == 1) return 1;
                    std::memcpy(c.plane + (by * c.wb + bx) * 64, block,
                                64 * sizeof(int16_t));
                }
            }
        }
    }
    return 0;
}


}  // namespace

// ---------------------------------------------------------------------------
// Speculative self-synchronizing parallel decode (no restart markers)
// ---------------------------------------------------------------------------
//
// Baseline scans without RSTn markers have no built-in parallel seam,
// so we make one: Huffman codes self-synchronize, and a decoder
// started at an arbitrary byte offset almost always locks onto the
// true symbol stream within a few hundred bytes (see the GPU JPEG
// decompression literature). Two phases:
//
//  Phase A (parallel): thread k speculatively decodes from its chunk's
//    byte boundary (retrying at the next byte on invalid codes),
//    recording at every MCU start a CANONICAL reader state: after a
//    forced refill the (next-raw-byte, buffered-bit-count) pair is a
//    pure function of the logical unstuffed bit position, so equal
//    records mean equal positions AND equal future decodes. Records
//    also carry the 64-bit buffer and per-component DC predictors
//    (relative to the thread's arbitrary start).
//
//  Stitch (sequential, cheap): adjacent threads share a first common
//    record in the overlap window; the chain from thread 0 (which
//    starts at the true stream start) assigns every sync point its
//    true global MCU index and true DC predictors (relative predictors
//    compose additively). Any failure falls back to sequential decode,
//    so correctness never depends on synchronization succeeding.
//
//  Phase B (parallel): each chunk re-decodes exactly from its restored
//    canonical state with true predictors, writing blocks straight to
//    the coefficient planes. Output is bit-identical to the sequential
//    decode by construction.

namespace {

struct McuRecord {
    int64_t byte_off;   // canonical next-raw-byte offset from span start
    int32_t bit_count;  // canonical buffered-bit count
    uint64_t bits;      // buffer contents (left-justified)
    int32_t preds[4];   // per-component DC predictors BEFORE this MCU
    // Sparse single-pass speculation only (dense path leaves them 0):
    int64_t entry_n;     // emitter entry count at this MCU start
    int64_t em_last_pos; // emitter last emitted (thread-local) position
};

static inline bool rec_key_less(const McuRecord& a, const McuRecord& b) {
    return a.byte_off != b.byte_off ? a.byte_off < b.byte_off
                                    : a.bit_count > b.bit_count;  // more bits == earlier
}

static inline bool rec_key_eq(const McuRecord& a, const McuRecord& b) {
    return a.byte_off == b.byte_off && a.bit_count == b.bit_count;
}

// Decode one MCU worth of blocks without storing output.
// Returns 0 ok, nonzero error.
static inline int scan_one_mcu(BitReader& br, Component* comps, int n_comps,
                               int32_t* pred, int16_t* scratch) {
    for (int ci = 0; ci < n_comps; ++ci) {
        Component& c = comps[ci];
        int nb = c.h * c.v;
        for (int b = 0; b < nb; ++b) {
            int rc = read_block_baseline(br, c, pred[ci], scratch);
            if (rc) return rc;
        }
    }
    return 0;
}

// Phase A for one thread: record canonical MCU-start states from
// byte offset `from` until the canonical position passes `until`.
static void speculative_scan(const uint8_t* base, int64_t span_len,
                             int64_t from, int64_t until,
                             Component* comps, int n_comps,
                             int64_t max_mcus, std::vector<McuRecord>& out) {
    int16_t scratch[64];
    // Thread 0 starts at the true stream start: a failure there is a
    // truly corrupt stream and must NOT be retried at the next byte —
    // the stitch maps its first record to MCU 0 unconditionally, so a
    // shifted self-sync would re-decode garbage without error. Leaving
    // out empty aborts the speculative path into the sequential one,
    // which raises properly (mirrors the sparse guard below).
    const int kMaxRetries = from == 0 ? 1 : 64;
    for (int attempt = 0; attempt < kMaxRetries; ++attempt) {
        int64_t start = from + attempt;
        if (start >= span_len) return;
        out.clear();
        BitReader br;
        br.init(base + start, span_len - start);
        int32_t pred[4] = {0, 0, 0, 0};
        bool failed = false;
        for (int64_t m = 0; m < max_mcus; ++m) {
            br.fill();  // canonicalize
            McuRecord rec;
            rec.byte_off = (br.p - base);
            rec.bit_count = br.count;
            rec.bits = br.bits;
            for (int ci = 0; ci < n_comps; ++ci) rec.preds[ci] = pred[ci];
            out.push_back(rec);
            if (rec.byte_off > until + 8) {
                return;  // covered the overlap window
            }
            int rc = scan_one_mcu(br, comps, n_comps, pred, scratch);
            if (rc == 2) { failed = true; break; }
            if (rc == 1) return;  // ran off the end: keep records
        }
        if (!failed) return;
        // Invalid code: mis-aligned start. Retry one byte later unless
        // we already recorded a healthy run (sync then late corruption
        // would also fail sequentially — keep what we have).
        if (out.size() > 16) return;
    }
    out.clear();
}

struct SpecEntry {
    int64_t byte_off;
    int32_t bit_count;
    uint64_t bits;
    int64_t first_mcu;
    int64_t n_mcus;
    int32_t preds[4];
};

// Phase B: exact re-decode of one chunk from a restored state.
static int spec_decode_chunk(const uint8_t* base, int64_t span_len,
                             const SpecEntry& e, Component* comps, int n_comps,
                             int64_t mcus_per_line) {
    BitReader br;
    br.p = base + e.byte_off;
    br.end = base + span_len;
    br.bits = e.bits;
    br.count = e.bit_count;
    br.exhausted = false;
    std::vector<int32_t> pred(e.preds, e.preds + n_comps);
    int16_t block[64];
    for (int64_t m = 0; m < e.n_mcus; ++m) {
        int64_t mcu = e.first_mcu + m;
        int64_t row = mcu / mcus_per_line;
        int64_t col = mcu % mcus_per_line;
        for (int ci = 0; ci < n_comps; ++ci) {
            Component& c = comps[ci];
            for (int y = 0; y < c.v; ++y) {
                int64_t by = row * c.v + y;
                for (int x = 0; x < c.h; ++x) {
                    int64_t bx = col * c.h + x;
                    int rc = read_block_baseline(br, c, pred[ci], block);
                    if (rc) return rc;
                    std::memcpy(c.plane + (by * c.wb + bx) * 64, block,
                                64 * sizeof(int16_t));
                }
            }
        }
    }
    return 0;
}

// Full speculative pipeline. Returns 0 on success, -1 when it could
// not synchronize (caller falls back to sequential), >0 decode error.
static int decode_span_speculative(const uint8_t* data, int64_t len,
                                   int64_t total_mcus, int64_t mcus_per_line,
                                   Component* comps, int n_comps, int n_threads) {
    if (n_comps > 4) return -1;
    int T = n_threads;
    if ((int64_t)T > len / 65536) T = (int)(len / 65536);
    if (T < 2) return -1;
    const int64_t kOverlap = 16384;

    std::vector<std::vector<McuRecord>> records(T);
    std::vector<std::vector<Component>> comp_copies(T,
        std::vector<Component>(comps, comps + n_comps));
    {
        std::vector<std::thread> pool;
        int64_t chunk = len / T;
        for (int t = 0; t < T; ++t) {
            int64_t from = t * chunk;
            int64_t until = (t + 1 < T) ? (t + 1) * chunk + kOverlap : len;
            pool.emplace_back([&, t, from, until]() {
                speculative_scan(data, len, from, until,
                                 comp_copies[t].data(), n_comps,
                                 total_mcus + 16, records[t]);
            });
        }
        for (auto& th : pool) th.join();
    }

    // Stitch the chain of sync points.
    std::vector<SpecEntry> entries;
    SpecEntry cur;
    if (records[0].empty()) return -1;
    cur.byte_off = records[0][0].byte_off;
    cur.bit_count = records[0][0].bit_count;
    cur.bits = records[0][0].bits;
    cur.first_mcu = 0;
    for (int ci = 0; ci < n_comps; ++ci) cur.preds[ci] = 0;

    int prev_thread = 0;
    size_t prev_sync_idx = 0;       // index in records[prev] of cur's MCU
    int32_t delta[4] = {0, 0, 0, 0};

    for (int t = 1; t < T; ++t) {
        const auto& a = records[prev_thread];
        const auto& b = records[t];
        // find first common record (both sorted by construction)
        size_t i = prev_sync_idx, j = 0;
        bool found = false;
        while (i < a.size() && j < b.size()) {
            if (rec_key_eq(a[i], b[j])) { found = true; break; }
            if (rec_key_less(a[i], b[j])) ++i; else ++j;
        }
        if (!found || b[j].byte_off >= len) return -1;
        int64_t sync_mcu = cur.first_mcu + (int64_t)(i - prev_sync_idx);
        if (sync_mcu >= total_mcus) break;
        cur.n_mcus = sync_mcu - cur.first_mcu;
        entries.push_back(cur);

        // new entry from thread t's record j, with composed predictors
        SpecEntry e;
        e.byte_off = b[j].byte_off;
        e.bit_count = b[j].bit_count;
        e.bits = b[j].bits;
        e.first_mcu = sync_mcu;
        for (int ci = 0; ci < n_comps; ++ci) {
            int32_t true_pred = a[i].preds[ci] + delta[ci];
            e.preds[ci] = true_pred;
        }
        // delta for thread t's later records
        for (int ci = 0; ci < n_comps; ++ci)
            delta[ci] = e.preds[ci] - b[j].preds[ci];
        cur = e;
        prev_thread = t;
        prev_sync_idx = j;
    }
    cur.n_mcus = total_mcus - cur.first_mcu;
    entries.push_back(cur);

    // Phase B: parallel exact re-decode.
    std::vector<int> results(entries.size(), 0);
    std::vector<std::thread> pool;
    std::vector<std::vector<Component>> copies(entries.size(),
        std::vector<Component>(comps, comps + n_comps));
    for (size_t k = 0; k < entries.size(); ++k) {
        pool.emplace_back([&, k]() {
            results[k] = spec_decode_chunk(data, len, entries[k],
                                           copies[k].data(), n_comps,
                                           mcus_per_line);
        });
    }
    for (auto& th : pool) th.join();
    for (int rc : results)
        if (rc) return rc;
    return 0;
}

// Shared loop for the full-image and region (span-subset) decodes.
//   first_mcu: global MCU index of the first span passed in (0 for a
//     full decode; a multiple of restart_interval for a region decode —
//     restart seams make any contiguous span subset independently
//     decodable since DC predictors reset at every RSTn).
//   mcu_row_offset: MCU rows to subtract before plane writes, so a
//     caller can hand band-sized planes covering only the decoded rows.
static int decode_baseline_scan_impl(
    const uint8_t* data,
    const int64_t* span_starts, const int64_t* span_ends, int32_t n_spans,
    int64_t restart_interval,
    int64_t mcus_per_line, int64_t mcus_per_column,
    int32_t n_comps,
    const int32_t* comp_h, const int32_t* comp_v,
    const uint8_t* dc_blob, const uint8_t* ac_blob,  // n_comps HuffTables each
    int16_t** planes, const int64_t* plane_wb,
    int32_t n_threads,
    int64_t first_mcu, int64_t mcu_row_offset) {
    if (n_comps <= 0 || n_spans <= 0) return 3;
    // Region decode needs the restart-seam structure (and the
    // speculative no-restart path below never sees an offset).
    if ((first_mcu != 0 || mcu_row_offset != 0) && restart_interval <= 0)
        return 3;

    std::vector<Component> comps(n_comps);
    for (int i = 0; i < n_comps; ++i) {
        comps[i].h = comp_h[i];
        comps[i].v = comp_v[i];
        comps[i].dc = reinterpret_cast<const HuffTable*>(dc_blob) + i;
        comps[i].ac = reinterpret_cast<const HuffTable*>(ac_blob) + i;
        comps[i].plane = planes[i];
        comps[i].wb = plane_wb[i];
    }

    const int64_t total_mcus = mcus_per_line * mcus_per_column;
    std::vector<SpanTask> tasks;
    if (restart_interval <= 0) {
        SpanTask t{data + span_starts[0], span_ends[0] - span_starts[0], 0, total_mcus};
        // No restart seam: try the speculative self-sync parallel path
        // (JPX_SPECULATIVE=0 disables; falls back to sequential when
        // synchronization fails).
        const char* spec_env = std::getenv("JPX_SPECULATIVE");
        bool allow_spec = !(spec_env && spec_env[0] == '0');
        int hw0 = (int)std::thread::hardware_concurrency();
        int nt0 = n_threads > 0 ? n_threads : (hw0 > 0 ? hw0 : 1);
        if (allow_spec && nt0 > 2) {
            int rc = decode_span_speculative(t.data, t.len, total_mcus,
                                             mcus_per_line, comps.data(),
                                             n_comps, nt0);
            if (rc >= 0) return rc;
        }
        tasks.push_back(t);
    } else {
        int64_t mcu = first_mcu;
        for (int32_t s = 0; s < n_spans && mcu < total_mcus; ++s) {
            int64_t n = std::min<int64_t>(restart_interval, total_mcus - mcu);
            SpanTask t{data + span_starts[s], span_ends[s] - span_starts[s], mcu, n};
            tasks.push_back(t);
            mcu += n;
        }
    }

    int hw = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;
    n_threads = std::min<int32_t>(n_threads, (int32_t)tasks.size());

    if (n_threads <= 1) {
        for (const auto& t : tasks) {
            int rc = decode_span(t, comps.data(), n_comps, mcus_per_line,
                                 mcu_row_offset);
            if (rc) return rc;
        }
        return 0;
    }

    std::vector<int> results(tasks.size(), 0);
    std::vector<std::thread> pool;
    std::vector<std::vector<Component>> comp_copies(n_threads, comps);
    for (int tid = 0; tid < n_threads; ++tid) {
        pool.emplace_back([&, tid]() {
            for (size_t k = tid; k < tasks.size(); k += n_threads) {
                results[k] = decode_span(tasks[k], comp_copies[tid].data(),
                                         n_comps, mcus_per_line, mcu_row_offset);
            }
        });
    }
    for (auto& th : pool) th.join();
    for (int rc : results)
        if (rc) return rc;
    return 0;
}

}  // namespace

extern "C" {

// Decode one baseline scan. Components are in scan order.
//   span_starts/span_ends: byte ranges of the entropy spans (RSTn-split)
//   restart_interval: MCUs per span (0 = single span)
//   planes: per-component int16 [Hb, Wb, 64] zig-zag coefficient planes
// Returns 0 on success; 1 premature end (tolerated truncation decodes
// partially, matching the reference's exception-free paths is handled
// Python-side); 2 invalid Huffman code; 3 bad arguments.
int jpx_decode_baseline_scan(
    const uint8_t* data,
    const int64_t* span_starts, const int64_t* span_ends, int32_t n_spans,
    int64_t restart_interval,
    int64_t mcus_per_line, int64_t mcus_per_column,
    int32_t n_comps,
    const int32_t* comp_h, const int32_t* comp_v,
    const uint8_t* dc_blob, const uint8_t* ac_blob,
    int16_t** planes, const int64_t* plane_wb,
    int32_t n_threads) {
    return decode_baseline_scan_impl(
        data, span_starts, span_ends, n_spans, restart_interval,
        mcus_per_line, mcus_per_column, n_comps, comp_h, comp_v,
        dc_blob, ac_blob, planes, plane_wb, n_threads, 0, 0);
}

// Region decode: a contiguous SUBSET of an image's restart spans into
// band-sized planes. first_mcu must be span-aligned (a multiple of
// restart_interval); mcu_row_offset shifts plane writes so the planes
// only need to cover the touched MCU rows. Restart seams reset DC
// predictors, so the subset decodes bit-identically to the same spans
// inside a full decode.
int jpx_decode_baseline_scan_region(
    const uint8_t* data,
    const int64_t* span_starts, const int64_t* span_ends, int32_t n_spans,
    int64_t restart_interval,
    int64_t mcus_per_line, int64_t mcus_per_column,
    int32_t n_comps,
    const int32_t* comp_h, const int32_t* comp_v,
    const uint8_t* dc_blob, const uint8_t* ac_blob,
    int16_t** planes, const int64_t* plane_wb,
    int32_t n_threads,
    int64_t first_mcu, int64_t mcu_row_offset) {
    return decode_baseline_scan_impl(
        data, span_starts, span_ends, n_spans, restart_interval,
        mcus_per_line, mcus_per_column, n_comps, comp_h, comp_v,
        dc_blob, ac_blob, planes, plane_wb, n_threads,
        first_mcu, mcu_row_offset);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Sparse coefficient packing
// ---------------------------------------------------------------------------
//
// Pack dense zig-zag coefficient planes into (delta uint16, value int16)
// pairs in concatenated-plane flat order. Gaps >= 0xFFFF emit escape
// entries (delta 0xFFFF, value 0): the device reconstructs positions
// with a plain cumulative sum and scatter-adds values (escape values
// add 0). 4 bytes per nonzero instead of 2 bytes per coefficient —
// ~4x fewer host->device bytes at typical quality levels.
//
// Parallelized with a two-pass scheme: chunks count their nonzeros and
// internal escapes independently, a cheap sequential pass assigns
// output offsets (boundary escapes depend on the previous chunk's last
// nonzero), then chunks fill their output ranges concurrently.

namespace {

struct PackChunk {
    int64_t begin, end;        // flat range [begin, end)
    int64_t nnz;               // nonzero count
    int64_t internal_escapes;  // escapes for gaps between nonzeros inside
    int64_t first_nz, last_nz; // flat indices (-1 if none)
    int64_t out_offset;        // entry offset assigned by the prefix pass
    int64_t lead_escapes;      // escapes before the first entry
};

static void pack_count_chunk(const int16_t* base, int64_t begin, int64_t end,
                             int64_t flat_base, PackChunk& ck) {
    int64_t nnz = 0, escapes = 0;
    int64_t first_nz = -1, last_nz = -1;
    for (int64_t i = begin; i < end; ++i) {
        if (base[i] == 0) continue;
        int64_t flat = flat_base + i;
        if (first_nz < 0) {
            first_nz = flat;
        } else {
            int64_t gap = flat - last_nz;
            escapes += gap / 0xFFFF;
        }
        last_nz = flat;
        ++nnz;
    }
    ck.nnz = nnz;
    ck.internal_escapes = escapes;
    ck.first_nz = first_nz;
    ck.last_nz = last_nz;
}

static void pack_fill_chunk(const int16_t* base, int64_t begin, int64_t end,
                            int64_t flat_base, int64_t prev_last,
                            int16_t* out, int64_t offset) {
    int64_t n = offset;
    int64_t last = prev_last;
    for (int64_t i = begin; i < end; ++i) {
        int16_t v = base[i];
        if (v == 0) continue;
        int64_t gap = flat_base + i - last;
        while (gap >= 0xFFFF) {
            out[2 * n] = (int16_t)0xFFFF;
            out[2 * n + 1] = 0;
            ++n;
            gap -= 0xFFFF;
        }
        out[2 * n] = (int16_t)(uint16_t)gap;
        out[2 * n + 1] = v;
        ++n;
        last = flat_base + i;
    }
}

}  // namespace

extern "C" {

// Returns the number of entries written, or -1 if `capacity` is too
// small. `planes` are int16 plane pointers with `plane_sizes` elements
// each (flattened); output entries go to `out` as interleaved
// (uint16 delta, int16 value).
int64_t jpx_pack_sparse(
    const int16_t** planes, const int64_t* plane_sizes, int32_t n_planes,
    int16_t* out, int64_t capacity) {
    // Build chunk list: split each plane into ~per-thread chunks.
    int hw = (int)std::thread::hardware_concurrency();
    int n_threads = hw > 2 ? hw - 2 : 1;

    struct PlaneChunk { int32_t plane; PackChunk ck; };
    std::vector<PlaneChunk> chunks;
    int64_t base = 0;
    for (int32_t p = 0; p < n_planes; ++p) {
        int64_t size = plane_sizes[p];
        int64_t n_chunks = std::min<int64_t>(std::max<int64_t>(1, n_threads),
                                             std::max<int64_t>(1, size / 65536));
        int64_t step = (size + n_chunks - 1) / n_chunks;
        for (int64_t b = 0; b < size; b += step) {
            PlaneChunk pc;
            pc.plane = p;
            pc.ck.begin = b;
            pc.ck.end = std::min(b + step, size);
            pc.ck.out_offset = 0;
            pc.ck.lead_escapes = 0;
            chunks.push_back(pc);
        }
        base += size;
    }

    // Pass 1: parallel count.
    {
        std::vector<std::thread> pool;
        std::atomic<size_t> next{0};
        int nt = std::min<int>(n_threads, (int)chunks.size());
        auto worker = [&]() {
            for (;;) {
                size_t k = next.fetch_add(1);
                if (k >= chunks.size()) break;
                PlaneChunk& pc = chunks[k];
                int64_t flat_base = 0;
                for (int32_t p = 0; p < pc.plane; ++p) flat_base += plane_sizes[p];
                pack_count_chunk(planes[pc.plane], pc.ck.begin, pc.ck.end,
                                 flat_base, pc.ck);
            }
        };
        if (nt <= 1) {
            worker();
        } else {
            for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
            for (auto& th : pool) th.join();
        }
    }

    // Sequential prefix: boundary escapes + offsets.
    int64_t total = 0;
    int64_t prev_last = -1;
    std::vector<int64_t> prev_last_for(chunks.size());
    for (size_t k = 0; k < chunks.size(); ++k) {
        PackChunk& ck = chunks[k].ck;
        prev_last_for[k] = prev_last;
        ck.out_offset = total;
        if (ck.nnz > 0) {
            int64_t gap = ck.first_nz - prev_last;
            int64_t lead = gap / 0xFFFF;
            total += ck.nnz + ck.internal_escapes + lead;
            prev_last = ck.last_nz;
        }
    }
    if (total > capacity) return -1;

    // Pass 2: parallel fill.
    {
        std::vector<std::thread> pool;
        std::atomic<size_t> next{0};
        int nt = std::min<int>(n_threads, (int)chunks.size());
        auto worker = [&]() {
            for (;;) {
                size_t k = next.fetch_add(1);
                if (k >= chunks.size()) break;
                PlaneChunk& pc = chunks[k];
                if (pc.ck.nnz == 0) continue;
                int64_t flat_base = 0;
                for (int32_t p = 0; p < pc.plane; ++p) flat_base += plane_sizes[p];
                pack_fill_chunk(planes[pc.plane], pc.ck.begin, pc.ck.end,
                                flat_base, prev_last_for[k], out, pc.ck.out_offset);
            }
        };
        if (nt <= 1) {
            worker();
        } else {
            for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
            for (auto& th : pool) th.join();
        }
    }
    return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Merged baseline decode + sparse emission
// ---------------------------------------------------------------------------
//
// The decode-throughput hot path. Baseline Huffman block decode already
// produces the nonzero coefficients in strictly increasing position
// order (DC, then AC at increasing zig-zag index), so the sparse
// (delta uint16, value int16) wire entries can be emitted straight from
// the symbol loop — no dense plane writes (memset + memcpy per block)
// and no separate whole-plane packing pass. Entry positions are in
// MCU-interleaved decode order: MCU m contributes coefficients
// [m*cpm, (m+1)*cpm) where cpm = 64 * sum(h*v); the device transform
// undoes the interleave with a reshape+transpose (free in XLA layout
// assignment). See ops/pipeline.jitted_transform_mcu.
//
// Restart spans emit into disjoint worst-case regions of the output in
// parallel, then a cheap sequential compaction stitches them with
// boundary-delta patches.

namespace {

struct SparseEmitter {
    int16_t* out;       // interleaved (delta, value) entries
    int64_t n;          // entries emitted
    int64_t cap;        // entry capacity
    int64_t last_pos;   // position of last emitted nonzero
    int64_t first_pos;  // position of first nonzero (-1 until set)
    bool overflow;

    void init(int16_t* buf, int64_t capacity) {
        out = buf;
        n = 0;
        cap = capacity;
        last_pos = -1;
        first_pos = -1;
        overflow = false;
    }

    // Typed 32-bit stores (not memcpy): a char-level store would force
    // the compiler to treat the write as aliasing n/cap/last_pos; a
    // uint32_t store's TBAA class is disjoint from the int64 fields,
    // so the hot loop can keep the emitter state in registers. The
    // buffer is raw numpy-allocated storage (4-byte aligned: entries
    // are two int16), accessed as uint32 throughout the C++ side.
    __attribute__((always_inline)) inline void emit(int64_t pos, int32_t val) {
        int64_t gap = pos - last_pos;
        if (__builtin_expect(first_pos < 0, 0)) {
            // First entry: delta is patched at compaction (the true
            // gap depends on the previous span's last nonzero).
            first_pos = pos;
            gap = 0;
        }
        uint32_t* o32 = reinterpret_cast<uint32_t*>(out);
        while (__builtin_expect(gap >= 0xFFFF, 0)) {
            if (n >= cap) { overflow = true; return; }
            o32[n] = 0x0000FFFFu;  // escape entry (delta 0xFFFF, value 0)
            ++n;
            gap -= 0xFFFF;
        }
        if (__builtin_expect(n >= cap, 0)) { overflow = true; return; }
        o32[n] = (uint16_t)gap | ((uint32_t)(uint16_t)val << 16);
        ++n;
        last_pos = pos;
    }
};

// Huffman symbol decode straight off the bit buffer — caller must
// guarantee count >= 16 real bits. Identical lookup to decode_huffman.
__attribute__((always_inline)) static inline int decode_huffman_hot(BitReader& br, const HuffTable* t) {
    uint32_t code16 = (uint32_t)(br.bits >> 48);
    int entry = t->lookahead[code16 >> 8];
    int size = entry >> 8;
    int value;
    if (size != 0) {
        value = entry & 0xFF;
    } else {
        size = 9;
        while (size <= 16 && code16 > t->maxcode[size]) ++size;
        if (size > 16) return -1;
        value = t->values[(uint8_t)(t->valoffset[size] + (code16 >> (16 - size)))];
    }
    br.bits <<= size;
    br.count -= size;
    return value;
}

// Baseline block decode emitting nonzeros directly (same bitstream
// semantics as read_block_baseline — positions strictly increase and
// the corrupt-stream Min(i, 63) clamp can produce at most one write at
// 63 as the block's final write, so add-scatter equals dense stores).
//
// Hot path: ONE refill check per coefficient serves both the Huffman
// symbol (<=16 bits) and its EXTEND value bits (<=16 bits) from the
// same 64-bit window; the careful peek/advance path (with its 1-bit
// padding semantics) only runs within 32 bits of the end of the span.
template <class EmitterT, bool AlwaysDC = false>
static inline int read_block_baseline_sparse(BitReader& br, const Component& c,
                                             int32_t& predictor,
                                             EmitterT& em,
                                             int64_t block_base) {
    int err = 0;
    if (br.count < 32) br.fill();
    if (br.count >= 32) {
        const uint32_t ec = c.dc_comb[(uint32_t)(br.bits >> (64 - COMB_BITS))];
        if (ec) {
            // combined hit: code + EXTEND resolved in one load
            const int adv = ec & 31;
            br.bits <<= adv;
            br.count -= adv;
            predictor += (int32_t)(int16_t)(ec >> 16);
        } else {
            int t = decode_huffman_hot(br, c.dc);
            if (t < 0) return 2;
            if (t != 0) {
                if (t > 16) {  // corrupt table: take the careful path
                    int32_t diff = receive_extend(br, t, &err);
                    if (err) return 1;
                    predictor += diff;
                } else {
                    uint32_t raw = (uint32_t)(br.bits >> (64 - t));
                    br.bits <<= t;
                    br.count -= t;
                    predictor += extend((int32_t)raw, t);
                }
            }
        }
    } else {
        int t = decode_huffman(br, c.dc);
        if (t < 0) return 2;
        if (t != 0) {
            int32_t diff = receive_extend(br, t, &err);
            if (err) return 1;
            predictor += diff;
        }
    }
    // AlwaysDC (speculative single-pass mode): emit the DC entry even
    // when the thread-relative predictor is 0 — the stitch's DC-delta
    // fixup needs an anchor in every block (a relative 0 can be a true
    // nonzero). Zero values scatter-add 0 downstream, so extra entries
    // are harmless. dc_mark hands the DC entry's index to the caller
    // for the fixup's DC-entry list.
    if (AlwaysDC || predictor != 0) em.emit(block_base, predictor);
    if constexpr (AlwaysDC) em.dc_mark = em.n - 1;

    int i = 1;
    while (i < 64) {
        int s, r;
        if (br.count < 32) br.fill();
        if (br.count >= 32) {
            const uint32_t ec = c.ac_comb[(uint32_t)(br.bits >> (64 - COMB_BITS))];
            if (ec) {
                const int adv = ec & 31;
                br.bits <<= adv;
                br.count -= adv;
                if (ec & COMB_SZERO) {
                    const int rr = (ec >> 5) & 15;
                    if (rr == 0) break;
                    i += 16;
                } else {
                    i += (ec >> 5) & 15;
                    em.emit(block_base + (i < 63 ? i : 63),
                            (int32_t)(int16_t)(ec >> 16));
                    ++i;
                }
                continue;
            }
            s = decode_huffman_hot(br, c.ac);
            if (s < 0) return 2;
            r = s >> 4;
            s &= 15;
            if (s != 0) {
                i += r;
                uint32_t raw = (uint32_t)(br.bits >> (64 - s));
                br.bits <<= s;
                br.count -= s;
                em.emit(block_base + (i < 63 ? i : 63), extend((int32_t)raw, s));
                ++i;
            } else {
                if (r == 0) break;
                i += 16;
            }
        } else {
            s = decode_huffman(br, c.ac);
            if (s < 0) return 2;
            r = s >> 4;
            s &= 15;
            if (s != 0) {
                i += r;
                int32_t val = receive_extend(br, s, &err);
                if (err) return 1;
                em.emit(block_base + (i < 63 ? i : 63), val);
                ++i;
            } else {
                if (r == 0) break;
                i += 16;
            }
        }
    }
    return 0;
}

// Decode one span's MCUs, emitting sparse entries.
static int decode_span_sparse(const SpanTask& task, Component* comps, int n_comps,
                              int64_t cpm, const int64_t* comp_off,
                              SparseEmitter& em) {
    BitReader br;
    br.init(task.data, task.len);
    int32_t pred[4] = {0, 0, 0, 0};
    for (int64_t m = 0; m < task.n_mcus; ++m) {
        int64_t base = (task.first_mcu + m) * cpm;
        for (int ci = 0; ci < n_comps; ++ci) {
            Component& c = comps[ci];
            int64_t boff = base + comp_off[ci];
            int nb = c.h * c.v;
            for (int b = 0; b < nb; ++b) {
                int rc = read_block_baseline_sparse(br, c, pred[ci], em,
                                                    boff + (int64_t)b * 64);
                if (rc) return rc;
                if (em.overflow) return 4;
            }
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Speculative SINGLE-PASS sparse decode (no restart markers)
// ---------------------------------------------------------------------------
//
// The dense path's two-phase speculation (scan for sync points, then
// re-decode) pays the entropy decode twice. For the sparse serving path
// a single pass suffices: each thread EMITS sparse entries as it
// speculatively scans (into its own growable buffer, thread-local MCU
// positions, DC values relative to the thread's arbitrary start), and
// each per-MCU record carries the emitter state (entry count + last
// emitted position). After the canonical-state stitch assigns every
// chunk its true first MCU index and true DC predictor deltas:
//
//  - a parallel fixup pass walks each chunk's valid entry slice, adds
//    the per-component DC delta to every DC entry (position % 64 == 0;
//    DC entries are ALWAYS emitted in this mode so none are missing),
//    and finds the slice's first/last absolute positions;
//  - a sequential assembly memcpy's the slices into the output with
//    boundary escapes and first-delta patches, exactly like the
//    restart-span compaction.
//
// DC value correctness: predictors evolve additively (pred_true =
// pred_local + delta in int32), and the emitter stores (int16)pred, so
// (int16)(stored + delta) == (int16)pred_true — bit-identical to the
// sequential emission. Any failure returns -6 and the caller falls
// back to the sequential single-span decode.

struct VecSparseEmitter {
    // One packed uint32 per entry: low 16 bits = delta (uint16), high
    // 16 = value (int16). All C++ accesses go through uint32 (never
    // int16) so the emit store's TBAA class is disjoint from the int64
    // bookkeeping fields — the hot loop keeps them in registers.
    std::vector<uint32_t> buf;
    uint32_t* w = nullptr;     // write cursor (1 uint32 per entry)
    uint32_t* wend = nullptr;
    int64_t n = 0;             // entries emitted
    int64_t last_pos = -1;     // thread-local position of last entry
    int64_t first_pos = -1;
    int64_t dc_mark = -1;      // index of the block's DC entry (AlwaysDC)

    void reset() {  // rewind without releasing the allocation
        n = 0;
        last_pos = -1;
        first_pos = -1;
        dc_mark = -1;
        w = buf.data();
        wend = buf.data() + buf.size();
    }

    __attribute__((noinline)) void grow() {
        size_t used = (size_t)(w - buf.data());
        buf.resize(buf.empty() ? 8192 : buf.size() * 2);
        w = buf.data() + used;
        wend = buf.data() + buf.size();
    }

    inline void emit(int64_t pos, int32_t val) {
        // Unlike SparseEmitter, the FIRST entry also gets its true
        // (thread-local) gap — any record's (entry_n, em_last_pos) pair
        // must be a valid resume point for the fixup walk.
        int64_t gap = pos - last_pos;
        while (__builtin_expect(gap >= 0xFFFF, 0)) {
            if (w + 1 > wend) grow();
            *w++ = 0x0000FFFFu;  // escape entry (delta 0xFFFF, value 0)
            ++n;
            gap -= 0xFFFF;
        }
        if (__builtin_expect(first_pos < 0, 0)) first_pos = pos;
        if (__builtin_expect(w + 1 > wend, 0)) grow();
        *w++ = (uint16_t)gap | ((uint32_t)(uint16_t)val << 16);
        ++n;
        last_pos = pos;
    }
};

// Phase A for one thread: emit sparse entries speculatively from byte
// offset `from`, recording canonical MCU-start states + emitter state.
// `dc_entries` records each always-emitted DC entry as
// (entry_index << 2) | component — the DC-delta fixup then touches only
// those entries instead of walking the whole payload.
static void speculative_scan_sparse(const uint8_t* base, int64_t span_len,
                                    int64_t from, int64_t until,
                                    Component* comps, int n_comps,
                                    int64_t cpm, const int64_t* comp_off,
                                    int64_t max_mcus,
                                    std::vector<McuRecord>& out,
                                    VecSparseEmitter& em,
                                    std::vector<int64_t>& dc_entries) {
    // Thread 0 starts at the true stream start: a failure there is a
    // truly corrupt stream and must NOT be retried at the next byte
    // (there is no phase-B re-decode to catch garbage in this mode —
    // fall back to the sequential path, which raises properly).
    const int kMaxRetries = from == 0 ? 1 : 64;
    for (int attempt = 0; attempt < kMaxRetries; ++attempt) {
        int64_t start = from + attempt;
        if (start >= span_len) return;
        out.clear();
        em.reset();
        dc_entries.clear();
        BitReader br;
        br.init(base + start, span_len - start);
        int32_t pred[4] = {0, 0, 0, 0};
        bool failed = false;
        for (int64_t m = 0; m < max_mcus; ++m) {
            br.fill();  // canonicalize
            McuRecord rec;
            rec.byte_off = (br.p - base);
            rec.bit_count = br.count;
            rec.bits = br.bits;
            for (int ci = 0; ci < n_comps; ++ci) rec.preds[ci] = pred[ci];
            rec.entry_n = em.n;
            rec.em_last_pos = em.last_pos;
            out.push_back(rec);
            if (rec.byte_off > until + 8) return;  // covered the overlap
            int64_t bpos = m * cpm;
            int rc = 0;
            for (int ci = 0; ci < n_comps && rc == 0; ++ci) {
                Component& c = comps[ci];
                int64_t boff = bpos + comp_off[ci];
                int nb = c.h * c.v;
                for (int b = 0; b < nb; ++b) {
                    rc = read_block_baseline_sparse<VecSparseEmitter, true>(
                        br, c, pred[ci], em, boff + (int64_t)b * 64);
                    if (rc) break;
                    // The DC entry the block just always-emitted is the
                    // one right before its AC entries: its index is the
                    // entry count at block start... the DC is emitted
                    // first, so it is at (entry count before any AC).
                    // Record it via the emitter's dc_mark (set below).
                    dc_entries.push_back((em.dc_mark << 2) | ci);
                }
            }
            if (rc == 2) { failed = true; break; }
            if (rc == 1) return;  // ran off the end: keep records
        }
        if (!failed) return;
        // Invalid code: mis-aligned start. Retry one byte later unless
        // we already recorded a healthy run (sync then late corruption
        // would also fail sequentially — keep what we have; the chunk
        // cutoffs only use entry counts at intact records).
        if (out.size() > 16) return;
    }
    out.clear();
    em.reset();
}

// Returns the entry count written to `out`, or: -1 capacity exceeded,
// -6 could-not-sync (caller falls back to the sequential span decode).
static int64_t decode_span_sparse_speculative(
    const uint8_t* data, int64_t len, int64_t total_mcus,
    Component* comps, int n_comps, int64_t cpm, const int64_t* comp_off,
    int16_t* out, int64_t capacity, int n_threads) {
    if (n_comps > 4) return -6;
    int T = n_threads;
    if ((int64_t)T > len / 65536) T = (int)(len / 65536);
    if (T < 2) return -6;
    const int64_t kOverlap = 16384;
    // More chunks than threads: threads self-schedule, so one stolen
    // core (shared host) or a dense region doesn't hold up 1/T of the
    // stream. Each extra chunk costs kOverlap of duplicated decode.
    int C = std::min<int>(2 * T, (int)(len / 65536));
    if (C < 2) return -6;

    const bool dbg = std::getenv("JPX_SPEC_DEBUG") != nullptr;
    auto now_us = []() {
        return std::chrono::duration_cast<std::chrono::microseconds>(
                   std::chrono::steady_clock::now().time_since_epoch())
            .count();
    };
    int64_t t_a = now_us();

    std::vector<std::vector<McuRecord>> records(C);
    std::vector<VecSparseEmitter> ems(C);
    std::vector<std::vector<int64_t>> dc_lists(C);
    std::vector<std::vector<Component>> comp_copies(T,
        std::vector<Component>(comps, comps + n_comps));
    {
        std::vector<std::thread> pool;
        std::atomic<int> next{0};
        int64_t chunk = len / C;
        auto run_chunk = [&](int k, Component* cv) {
            int64_t from = (int64_t)k * chunk;
            int64_t until = (k + 1 < C) ? (int64_t)(k + 1) * chunk + kOverlap : len;
            // Stack-local working state: the emitter's hot fields are
            // updated once per ENTRY — if they lived in the shared
            // ems[] array, adjacent chunks' emitters would share cache
            // lines and threads would false-share at entry rate.
            std::vector<McuRecord> recs;
            std::vector<int64_t> dcs;
            VecSparseEmitter em;
            // Size roughly the byte share (natural images emit about
            // one entry per compressed byte); buffers grow as needed.
            em.buf.resize((size_t)((until - from) + 2048));
            speculative_scan_sparse(data, len, from, until, cv, n_comps,
                                    cpm, comp_off, total_mcus + 16,
                                    recs, em, dcs);
            records[k] = std::move(recs);
            ems[k] = std::move(em);
            dc_lists[k] = std::move(dcs);
        };
        for (int t = 0; t < T; ++t) {
            pool.emplace_back([&, t]() {
                for (;;) {
                    int k = next.fetch_add(1);
                    if (k >= C) break;
                    run_chunk(k, comp_copies[t].data());
                }
            });
        }
        for (auto& th : pool) th.join();
    }
    int64_t t_b = now_us();
    if (dbg) {
        fprintf(stderr, "[spec] phaseA %lld us (chunks:", (long long)(t_b - t_a));
        for (int k = 0; k < C; ++k)
            fprintf(stderr, " %zurec", records[k].size());
        fprintf(stderr, ")\n");
    }

    // Stitch the chain of sync points into chunk descriptors.
    struct Chunk {
        int thread;
        int64_t rec_start, rec_end;  // record index range [start, end)
        int64_t first_mcu;           // true MCU index of rec_start
        int32_t dc_delta[4];         // true_pred - local_pred
    };
    std::vector<Chunk> chunks;
    if (records[0].empty()) return -6;

    int prev_thread = 0;
    int64_t prev_sync_idx = 0;
    int64_t prev_first_mcu = 0;
    int32_t delta_prev[4] = {0, 0, 0, 0};

    for (int t = 1; t < C; ++t) {
        const auto& a = records[prev_thread];
        const auto& b = records[t];
        size_t i = (size_t)prev_sync_idx, j = 0;
        bool found = false;
        while (i < a.size() && j < b.size()) {
            if (rec_key_eq(a[i], b[j])) { found = true; break; }
            if (rec_key_less(a[i], b[j])) ++i; else ++j;
        }
        if (!found || b[j].byte_off >= len) return -6;
        int64_t sync_mcu = prev_first_mcu + (int64_t)(i - (size_t)prev_sync_idx);
        if (sync_mcu >= total_mcus) break;
        Chunk c;
        c.thread = prev_thread;
        c.rec_start = prev_sync_idx;
        c.rec_end = (int64_t)i;
        c.first_mcu = prev_first_mcu;
        for (int ci = 0; ci < 4; ++ci) c.dc_delta[ci] = delta_prev[ci];
        chunks.push_back(c);
        // true predictors at the sync, then thread t's delta
        for (int ci = 0; ci < n_comps; ++ci)
            delta_prev[ci] = (a[i].preds[ci] + delta_prev[ci]) - b[j].preds[ci];
        prev_thread = t;
        prev_sync_idx = (int64_t)j;
        prev_first_mcu = sync_mcu;
    }
    {
        // Last chunk: needs the boundary record AT MCU total_mcus for
        // its entry cutoff (pushed before the phantom-MCU attempt; a
        // stream that truncates earlier lacks it -> fall back).
        int64_t need = prev_sync_idx + (total_mcus - prev_first_mcu);
        if ((int64_t)records[prev_thread].size() < need + 1) return -6;
        Chunk c;
        c.thread = prev_thread;
        c.rec_start = prev_sync_idx;
        c.rec_end = need;
        c.first_mcu = prev_first_mcu;
        for (int ci = 0; ci < 4; ++ci) c.dc_delta[ci] = delta_prev[ci];
        chunks.push_back(c);
    }

    int64_t t_c = now_us();
    if (dbg) fprintf(stderr, "[spec] stitch %lld us, %zu chunks\n",
                     (long long)(t_c - t_b), chunks.size());

    // Assembly with O(DC-count) fixup: each chunk's slice bounds come
    // straight from its boundary records (em_last_pos gives the last
    // emitted position AT the cutoff MCU; only the leading escape group
    // needs a mini-walk), and the DC-delta patch touches only the
    // recorded DC entry indices instead of walking the whole payload.
    int64_t out_n = 0;
    int64_t prev_abs = -1;
    for (const Chunk& c : chunks) {
        const auto& R = records[c.thread];
        auto& buf = ems[c.thread].buf;
        int64_t e_begin = R[c.rec_start].entry_n;
        int64_t e_end = R[c.rec_end].entry_n;
        if (e_end <= e_begin) continue;
        // record index == thread-local MCU index (records are pushed
        // per MCU from m = 0, cleared on retry).
        int64_t rebase = (c.first_mcu - c.rec_start) * cpm;
        // Skip leading escapes (they encode the thread-LOCAL gap; the
        // true boundary gap is recomputed below) and find the first
        // real entry's absolute position.
        int64_t pos = R[c.rec_start].em_last_pos;
        int64_t e = e_begin;
        while (e < e_end && buf[e] == 0x0000FFFFu) {  // escape entries
            pos += 0xFFFF;
            ++e;
        }
        if (e >= e_end) continue;  // escape-only slice (no real entries)
        int64_t first_abs = pos + (uint16_t)buf[e] + rebase;
        int64_t last_abs = R[c.rec_end].em_last_pos + rebase;
        int64_t n_entries = e_end - e;

        // DC-delta patch over the recorded DC entries in this slice.
        if (c.dc_delta[0] | c.dc_delta[1] | c.dc_delta[2] | c.dc_delta[3]) {
            const auto& dcl = dc_lists[c.thread];
            auto it = std::lower_bound(dcl.begin(), dcl.end(), e_begin << 2);
            for (; it != dcl.end(); ++it) {
                int64_t idx = *it >> 2;
                if (idx >= e_end) break;
                int ci = (int)(*it & 3);
                // (int16)(stored + delta) — same truncation as the
                // sequential emission's (int16)pred_true.
                int16_t patched = (int16_t)((int32_t)(int16_t)(buf[idx] >> 16) +
                                            c.dc_delta[ci]);
                buf[idx] = (buf[idx] & 0xFFFFu) |
                           ((uint32_t)(uint16_t)patched << 16);
            }
        }

        int64_t gap = first_abs - prev_abs;
        int64_t n_esc = gap / 0xFFFF;
        if (out_n + n_esc + n_entries > capacity) return -1;
        uint32_t* o32 = reinterpret_cast<uint32_t*>(out);
        for (int64_t k = 0; k < n_esc; ++k) o32[out_n++] = 0x0000FFFFu;
        gap -= n_esc * 0xFFFF;
        std::memcpy(o32 + out_n, buf.data() + e, (size_t)n_entries * 4);
        // patch first delta, keep its value half
        o32[out_n] = (o32[out_n] & 0xFFFF0000u) | (uint16_t)gap;
        out_n += n_entries;
        prev_abs = last_abs;
    }
    if (dbg) fprintf(stderr, "[spec] assembly %lld us, %lld entries\n",
                     (long long)(now_us() - t_c), (long long)out_n);
    return out_n;
}

// Patch an in-place single-span emission's first delta — positions are
// relative to -1 — inserting leading escape entries when the first
// nonzero sits >= 0xFFFF coefficients in (pathological all-zero head;
// the shift is safe, capacity permitting). Returns the final entry
// count, or -1 on capacity.
static int64_t finalize_single_span(SparseEmitter& em, int16_t* out,
                                    int64_t capacity) {
    if (em.n > 0) {
        int64_t gap = em.first_pos + 1;
        int64_t n_esc = gap / 0xFFFF;
        uint32_t* o32 = reinterpret_cast<uint32_t*>(out);
        if (n_esc > 0) {
            if (em.n + n_esc > capacity) return -1;
            std::memmove(o32 + n_esc, o32, (size_t)em.n * 4);
            for (int64_t e = 0; e < n_esc; ++e) o32[e] = 0x0000FFFFu;
            em.n += n_esc;
            gap -= n_esc * 0xFFFF;
        }
        o32[n_esc] = (o32[n_esc] & 0xFFFF0000u) | (uint16_t)gap;
    }
    return em.n;
}

}  // namespace

extern "C" {

// Merged baseline scan decode + sparse pack. Emits interleaved
// (delta uint16, value int16) entries in MCU decode order into `out`.
// Only for scans whose component set matches the frame (interleaved
// full-frame scan, or a single-component frame) — the Python wrapper
// gates eligibility. Returns the entry count, or a negative error:
// -1 capacity exceeded, -2 invalid Huffman code, -3 premature end,
// -4 bad arguments.
int64_t jpx_decode_baseline_scan_sparse(
    const uint8_t* data,
    const int64_t* span_starts, const int64_t* span_ends, int32_t n_spans,
    int64_t restart_interval,
    int64_t mcus_per_line, int64_t mcus_per_column,
    int32_t n_comps,
    const int32_t* comp_h, const int32_t* comp_v,
    const uint8_t* dc_blob, const uint8_t* ac_blob,
    int16_t* out, int64_t capacity,
    int32_t n_threads) {
    if (n_comps <= 0 || n_comps > 4 || n_spans <= 0) return -4;

    std::vector<Component> comps(n_comps);
    int64_t comp_off[4];
    int64_t cpm = 0;  // coefficients per MCU
    for (int i = 0; i < n_comps; ++i) {
        comps[i].h = comp_h[i];
        comps[i].v = comp_v[i];
        comps[i].dc = reinterpret_cast<const HuffTable*>(dc_blob) + i;
        comps[i].ac = reinterpret_cast<const HuffTable*>(ac_blob) + i;
        comps[i].plane = nullptr;
        comps[i].wb = 0;
        comp_off[i] = cpm;
        cpm += (int64_t)comp_h[i] * comp_v[i] * 64;
    }
    // Combined symbol+EXTEND tables (one per component table slot; the
    // ~16 KB build cost is microseconds against any real scan). Thread
    // copies of Component share these via pointer — read-only after here.
    std::vector<CombTable> comb_tables(2 * n_comps);
    for (int i = 0; i < n_comps; ++i) {
        build_comb_table(comps[i].dc, true, &comb_tables[2 * i]);
        build_comb_table(comps[i].ac, false, &comb_tables[2 * i + 1]);
        comps[i].dc_comb = comb_tables[2 * i].e;
        comps[i].ac_comb = comb_tables[2 * i + 1].e;
    }
    const int64_t total_mcus = mcus_per_line * mcus_per_column;

    if (restart_interval <= 0 || n_spans == 1) {
        // Single span: no restart seam. With a DECLARED restart
        // interval the one span still covers at most `ri` MCUs — a
        // truncated restart stream must decode its surviving span and
        // stop, exactly like the dense path's per-span task list
        // (decoding `total_mcus` from it would run into the 1-padding
        // and raise where the dense path tolerates the truncation).
        int64_t span_mcus = restart_interval > 0
                                ? std::min<int64_t>(restart_interval,
                                                    total_mcus)
                                : total_mcus;
        SpanTask t{data + span_starts[0], span_ends[0] - span_starts[0],
                   0, span_mcus};
        {
            const char* spec_env = std::getenv("JPX_SPECULATIVE");
            bool allow_spec = !(spec_env && spec_env[0] == '0');
            int hw0 = (int)std::thread::hardware_concurrency();
            int nt0 = n_threads > 0 ? n_threads : (hw0 > 0 ? hw0 : 1);
            if (allow_spec && nt0 > 2) {
                int64_t n = decode_span_sparse_speculative(
                    t.data, t.len, span_mcus, comps.data(), n_comps, cpm,
                    comp_off, out, capacity, nt0);
                if (n != -6) return n;
            }
        }
        SparseEmitter em;
        em.init(out, capacity);
        int rc = decode_span_sparse(t, comps.data(), n_comps, cpm, comp_off, em);
        if (rc == 4 || em.overflow) return -1;
        if (rc == 2) return -2;
        if (rc == 1) return -3;
        return finalize_single_span(em, out, capacity);
    }

    // Restart spans: parallel emission into disjoint worst-case
    // regions, then sequential compaction with boundary patches.
    struct SpanOut {
        SpanTask task;
        int64_t region_off;   // entry offset of this span's region
        SparseEmitter em;
        int rc;
    };
    std::vector<SpanOut> spans_out;
    {
        int64_t mcu = 0;
        int64_t off = 0;
        for (int32_t s = 0; s < n_spans && mcu < total_mcus; ++s) {
            int64_t n = std::min<int64_t>(restart_interval, total_mcus - mcu);
            int64_t span_coefs = n * cpm;
            SpanOut so;
            so.task = SpanTask{data + span_starts[s],
                               span_ends[s] - span_starts[s], mcu, n};
            so.region_off = off;
            so.rc = 0;
            spans_out.push_back(so);
            off += span_coefs + span_coefs / 0xFFFF + 8;  // worst case + escape slack
            mcu += n;
        }
        if (off > capacity) return -1;
    }

    int hw = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;
    n_threads = std::min<int32_t>(n_threads, (int32_t)spans_out.size());

    auto run_one = [&](SpanOut& so, Component* cv) {
        so.em.init(out + 2 * so.region_off,
                   (so.task.n_mcus * cpm) + (so.task.n_mcus * cpm) / 0xFFFF + 8);
        so.rc = decode_span_sparse(so.task, cv, n_comps, cpm, comp_off, so.em);
    };

    if (n_threads <= 1) {
        for (auto& so : spans_out) run_one(so, comps.data());
    } else {
        std::vector<std::thread> pool;
        std::vector<std::vector<Component>> copies(n_threads, comps);
        for (int tid = 0; tid < n_threads; ++tid) {
            pool.emplace_back([&, tid]() {
                for (size_t k = tid; k < spans_out.size(); k += n_threads) {
                    run_one(spans_out[k], copies[tid].data());
                }
            });
        }
        for (auto& th : pool) th.join();
    }
    for (const auto& so : spans_out) {
        if (so.rc == 4 || so.em.overflow) return -1;
        if (so.rc == 2) return -2;
        if (so.rc == 1) return -3;
    }

    // Compaction: stitch regions left-to-right. Destination offsets
    // never exceed source offsets (regions are sized worst-case), so
    // overlapping moves are safe with memmove.
    int64_t out_n = 0;
    int64_t prev_last = -1;
    uint32_t* o32 = reinterpret_cast<uint32_t*>(out);
    for (auto& so : spans_out) {
        if (so.em.n == 0) continue;
        int64_t gap = so.em.first_pos - prev_last;
        int64_t n_esc = gap / 0xFFFF;
        if (out_n + n_esc + so.em.n > capacity) return -1;
        // Move the body BEFORE writing boundary escapes: for the first
        // non-empty span the region starts at offset 0 with no slack, so
        // escape writes at out_n..out_n+n_esc-1 would clobber the span's
        // own leading entries. memmove is overlap-safe in both directions.
        std::memmove(o32 + out_n + n_esc, o32 + so.region_off,
                     (size_t)so.em.n * 4);
        for (int64_t e = 0; e < n_esc; ++e) o32[out_n++] = 0x0000FFFFu;
        gap -= n_esc * 0xFFFF;
        // patch first delta, keep its value half
        o32[out_n] = (o32[out_n] & 0xFFFF0000u) | (uint16_t)gap;
        out_n += so.em.n;
        prev_last = so.em.last_pos;
    }
    return out_n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// v2 split-stream sparse wire format (half the transfer bytes)
// ---------------------------------------------------------------------------
//
// The v1 wire spends 4 bytes per nonzero coefficient ((delta uint16,
// value int16) entries). On a network-attached chip the payload upload
// is the pipeline's largest cost term (BASELINE.md budget analysis), so
// v2 re-shapes the wire around what JPEG coefficients actually are:
//
//   dc      int16[NB]   dense DC plane (1/64th of the coefficients —
//                        dense costs little and removes every escape /
//                        DC-patch special case)
//   counts  uint8[NB]   AC entries per block (<= 64)
//   acpos   uint8[n]    position-in-block (1..63) per AC entry
//   acval   int8[n]     clamped AC value per entry
//   exc     (pos int64, residual int64)[k]
//                        rare |AC| > 127 overflow: residual vs the
//                        clamp, scatter-ADDed on device after the main
//                        scatter (positions are absolute coefficient
//                        indices; k is returned for the caller to size)
//
// ~2 bytes per AC coefficient + 3 bytes per block: ~0.54x the v1 bytes
// on the benchmark workload. Positions are block-relative, so restart-
// span compaction is a plain memcpy (no delta patches, no escapes) and
// the speculative stitch's DC fixup becomes a vectorized add over the
// dense DC slice. Device unpack: ops/pipeline.jitted_transform_mcu2.
//
// Block enumeration: ord = mcu * bpm + block-within-MCU in decode order
// (component blocks consecutive, frame order) — identical to v1's
// coefficient order at block granularity.

namespace {

struct Emitter2 {
    // Direct-to-final emission (sequential + restart-span modes): dc /
    // counts are absolute-ord arrays zeroed by the entry point; acpos /
    // acval point at this span's worst-case region.
    int16_t* dc;
    uint8_t* counts;
    uint8_t* acpos;
    int8_t* acval;
    int64_t n;    // AC entries emitted into this region
    int64_t cap;  // region entry capacity
    std::vector<int64_t>* exc;  // (pos, residual) pairs, appended flat
    int64_t dc_mark;  // required by the AlwaysDC template path (unused)
    bool overflow;

    void init(uint8_t* pos_region, int8_t* val_region, int64_t capacity,
              int16_t* dc_out, uint8_t* counts_out,
              std::vector<int64_t>* exc_out) {
        acpos = pos_region;
        acval = val_region;
        n = 0;
        cap = capacity;
        dc = dc_out;
        counts = counts_out;
        exc = exc_out;
        dc_mark = -1;
        overflow = false;
    }

    __attribute__((always_inline)) inline void emit(int64_t pos, int32_t val) {
        int64_t ord = pos >> 6;
        int idx = (int)(pos & 63);
        if (idx == 0) {
            dc[ord] = (int16_t)val;
            return;
        }
        if (__builtin_expect(n >= cap, 0)) { overflow = true; return; }
        int32_t c = val;
        if (__builtin_expect(c < -128 || c > 127, 0)) {
            int32_t cl = c < 0 ? -128 : 127;
            exc->push_back(pos);
            exc->push_back(c - cl);
            c = cl;
        }
        acpos[n] = (uint8_t)idx;
        acval[n] = (int8_t)c;
        ++n;
        ++counts[ord];
    }
};

// Speculative-mode emitter: thread-local ords, growable buffers. DC is
// ALWAYS emitted before a block's ACs in that mode (AlwaysDC), so the
// DC store doubles as the per-block counts[] initializer — no bulk
// zeroing, and retries self-heal (re-visited blocks re-zero).
struct VecEmitter2 {
    std::vector<uint8_t> acpos;
    std::vector<int8_t> acval;
    std::vector<int16_t> dc;      // thread-local ord indexed
    std::vector<uint8_t> counts;  // idem
    std::vector<int64_t> exc;     // (thread-local pos, residual) pairs
    int64_t n = 0;
    int64_t last_pos = -1;  // record-compat field (unused by v2)
    int64_t dc_mark = -1;   // AlwaysDC template path (unused by v2)

    void reset() {
        n = 0;
        last_pos = -1;
        dc_mark = -1;
        exc.clear();
    }

    inline void emit(int64_t pos, int32_t val) {
        int64_t ord = pos >> 6;
        int idx = (int)(pos & 63);
        if (idx == 0) {
            if (__builtin_expect((size_t)ord >= dc.size(), 0)) {
                dc.resize((size_t)ord + 4096);
                counts.resize((size_t)ord + 4096);
            }
            dc[ord] = (int16_t)val;
            counts[ord] = 0;
            return;
        }
        int32_t c = val;
        if (__builtin_expect(c < -128 || c > 127, 0)) {
            int32_t cl = c < 0 ? -128 : 127;
            exc.push_back(pos);
            exc.push_back(c - cl);
            c = cl;
        }
        if (__builtin_expect((size_t)n >= acpos.size(), 0)) {
            acpos.resize(acpos.empty() ? 8192 : acpos.size() * 2);
            acval.resize(acpos.size());
        }
        acpos[n] = (uint8_t)idx;
        acval[n] = (int8_t)c;
        ++n;
        ++counts[ord];
    }
};

// Twin of decode_span_sparse for the v2 emitter.
static int decode_span_sparse2(const SpanTask& task, Component* comps,
                               int n_comps, int64_t cpm,
                               const int64_t* comp_off, Emitter2& em) {
    BitReader br;
    br.init(task.data, task.len);
    int32_t pred[4] = {0, 0, 0, 0};
    for (int64_t m = 0; m < task.n_mcus; ++m) {
        int64_t base = (task.first_mcu + m) * cpm;
        for (int ci = 0; ci < n_comps; ++ci) {
            Component& c = comps[ci];
            int64_t boff = base + comp_off[ci];
            int nb = c.h * c.v;
            for (int b = 0; b < nb; ++b) {
                int rc = read_block_baseline_sparse(br, c, pred[ci], em,
                                                    boff + (int64_t)b * 64);
                if (rc) return rc;
                if (em.overflow) return 4;
            }
        }
    }
    return 0;
}

// Twin of speculative_scan_sparse: same retry / record discipline, no
// DC-entry list (DC is dense in v2 — the fixup is a slice add).
static void speculative_scan_sparse2(const uint8_t* base, int64_t span_len,
                                     int64_t from, int64_t until,
                                     Component* comps, int n_comps,
                                     int64_t cpm, const int64_t* comp_off,
                                     int64_t max_mcus,
                                     std::vector<McuRecord>& out,
                                     VecEmitter2& em) {
    const int kMaxRetries = from == 0 ? 1 : 64;
    for (int attempt = 0; attempt < kMaxRetries; ++attempt) {
        int64_t start = from + attempt;
        if (start >= span_len) return;
        out.clear();
        em.reset();
        BitReader br;
        br.init(base + start, span_len - start);
        int32_t pred[4] = {0, 0, 0, 0};
        bool failed = false;
        for (int64_t m = 0; m < max_mcus; ++m) {
            br.fill();  // canonicalize
            McuRecord rec;
            rec.byte_off = (br.p - base);
            rec.bit_count = br.count;
            rec.bits = br.bits;
            for (int ci = 0; ci < n_comps; ++ci) rec.preds[ci] = pred[ci];
            rec.entry_n = em.n;
            rec.em_last_pos = 0;
            out.push_back(rec);
            if (rec.byte_off > until + 8) return;  // covered the overlap
            int64_t bpos = m * cpm;
            int rc = 0;
            for (int ci = 0; ci < n_comps && rc == 0; ++ci) {
                Component& c = comps[ci];
                int64_t boff = bpos + comp_off[ci];
                int nb = c.h * c.v;
                for (int b = 0; b < nb; ++b) {
                    rc = read_block_baseline_sparse<VecEmitter2, true>(
                        br, c, pred[ci], em, boff + (int64_t)b * 64);
                    if (rc) break;
                }
            }
            if (rc == 2) { failed = true; break; }
            if (rc == 1) return;  // ran off the end: keep records
        }
        if (!failed) return;
        if (out.size() > 16) return;  // synced then late corruption
    }
    out.clear();
    em.reset();
}

// v2 speculative single-pass decode. Same phase-A / stitch scaffolding
// as decode_span_sparse_speculative; the assembly copies block-granular
// slices (AC memcpy, counts memcpy, DC slice-add of the per-component
// predictor delta) instead of entry patching. Returns the AC entry
// count, -1 on capacity, -6 to fall back to the sequential decode.
static int64_t decode_span_sparse_speculative2(
    const uint8_t* data, int64_t len, int64_t total_mcus,
    Component* comps, int n_comps, int64_t cpm, const int64_t* comp_off,
    int16_t* dc_out, uint8_t* counts_out,
    uint8_t* acpos_out, int8_t* acval_out, int64_t ac_capacity,
    std::vector<int64_t>& exc_out, int n_threads) {
    if (n_comps > 4) return -6;
    int T = n_threads;
    if ((int64_t)T > len / 65536) T = (int)(len / 65536);
    if (T < 2) return -6;
    const int64_t kOverlap = 16384;
    int C = std::min<int>(2 * T, (int)(len / 65536));
    if (C < 2) return -6;

    int64_t bpm = cpm / 64;  // blocks per MCU
    // Per-block component pattern within one MCU (for the DC delta).
    uint8_t comp_of[64];
    {
        int k = 0;
        for (int ci = 0; ci < n_comps; ++ci) {
            int nb = comps[ci].h * comps[ci].v;
            for (int b = 0; b < nb && k < 64; ++b) comp_of[k++] = (uint8_t)ci;
        }
    }

    std::vector<std::vector<McuRecord>> records(C);
    std::vector<VecEmitter2> ems(C);
    std::vector<std::vector<Component>> comp_copies(T,
        std::vector<Component>(comps, comps + n_comps));
    {
        std::vector<std::thread> pool;
        std::atomic<int> next{0};
        int64_t chunk = len / C;
        auto run_chunk = [&](int k, Component* cv) {
            int64_t from = (int64_t)k * chunk;
            int64_t until = (k + 1 < C) ? (int64_t)(k + 1) * chunk + kOverlap : len;
            std::vector<McuRecord> recs;
            VecEmitter2 em;
            em.acpos.resize((size_t)((until - from) + 2048));
            em.acval.resize(em.acpos.size());
            speculative_scan_sparse2(data, len, from, until, cv, n_comps,
                                     cpm, comp_off, total_mcus + 16,
                                     recs, em);
            records[k] = std::move(recs);
            ems[k] = std::move(em);
        };
        for (int t = 0; t < T; ++t) {
            pool.emplace_back([&, t]() {
                for (;;) {
                    int k = next.fetch_add(1);
                    if (k >= C) break;
                    run_chunk(k, comp_copies[t].data());
                }
            });
        }
        for (auto& th : pool) th.join();
    }

    struct Chunk {
        int thread;
        int64_t rec_start, rec_end;
        int64_t first_mcu;
        int32_t dc_delta[4];
    };
    std::vector<Chunk> chunks;
    if (records[0].empty()) return -6;

    int prev_thread = 0;
    int64_t prev_sync_idx = 0;
    int64_t prev_first_mcu = 0;
    int32_t delta_prev[4] = {0, 0, 0, 0};

    for (int t = 1; t < C; ++t) {
        const auto& a = records[prev_thread];
        const auto& b = records[t];
        size_t i = (size_t)prev_sync_idx, j = 0;
        bool found = false;
        while (i < a.size() && j < b.size()) {
            if (rec_key_eq(a[i], b[j])) { found = true; break; }
            if (rec_key_less(a[i], b[j])) ++i; else ++j;
        }
        if (!found || b[j].byte_off >= len) return -6;
        int64_t sync_mcu = prev_first_mcu + (int64_t)(i - (size_t)prev_sync_idx);
        if (sync_mcu >= total_mcus) break;
        Chunk c;
        c.thread = prev_thread;
        c.rec_start = prev_sync_idx;
        c.rec_end = (int64_t)i;
        c.first_mcu = prev_first_mcu;
        for (int ci = 0; ci < 4; ++ci) c.dc_delta[ci] = delta_prev[ci];
        chunks.push_back(c);
        for (int ci = 0; ci < n_comps; ++ci)
            delta_prev[ci] = (a[i].preds[ci] + delta_prev[ci]) - b[j].preds[ci];
        prev_thread = t;
        prev_sync_idx = (int64_t)j;
        prev_first_mcu = sync_mcu;
    }
    {
        int64_t need = prev_sync_idx + (total_mcus - prev_first_mcu);
        if ((int64_t)records[prev_thread].size() < need + 1) return -6;
        Chunk c;
        c.thread = prev_thread;
        c.rec_start = prev_sync_idx;
        c.rec_end = need;
        c.first_mcu = prev_first_mcu;
        for (int ci = 0; ci < 4; ++ci) c.dc_delta[ci] = delta_prev[ci];
        chunks.push_back(c);
    }

    int64_t out_n = 0;
    for (const Chunk& c : chunks) {
        const auto& R = records[c.thread];
        auto& E = ems[c.thread];
        int64_t e_begin = R[c.rec_start].entry_n;
        int64_t e_end = R[c.rec_end].entry_n;
        int64_t n_entries = e_end - e_begin;
        if (out_n + n_entries > ac_capacity) return -1;
        // record index == thread-local MCU index.
        int64_t ord_lo = c.rec_start * bpm;        // thread-local
        int64_t ord_hi = c.rec_end * bpm;
        int64_t true_ord0 = c.first_mcu * bpm;     // absolute
        if (n_entries > 0) {
            std::memcpy(acpos_out + out_n, E.acpos.data() + e_begin,
                        (size_t)n_entries);
            std::memcpy(acval_out + out_n, E.acval.data() + e_begin,
                        (size_t)n_entries);
            out_n += n_entries;
        }
        int64_t nb = ord_hi - ord_lo;
        if (nb > 0) {
            std::memcpy(counts_out + true_ord0, E.counts.data() + ord_lo,
                        (size_t)nb);
            bool zero = !(c.dc_delta[0] | c.dc_delta[1] | c.dc_delta[2] |
                          c.dc_delta[3]);
            if (zero) {
                std::memcpy(dc_out + true_ord0, E.dc.data() + ord_lo,
                            (size_t)nb * 2);
            } else {
                const int16_t* src = E.dc.data() + ord_lo;
                int16_t* dst = dc_out + true_ord0;
                for (int64_t k = 0; k < nb; ++k) {
                    // same int16 truncation as the sequential emission
                    dst[k] = (int16_t)((int32_t)src[k] +
                                       c.dc_delta[comp_of[k % bpm]]);
                }
            }
        }
        // Exceptions in [ord_lo*64, ord_hi*64), rebased to absolute.
        int64_t rebase = (c.first_mcu - c.rec_start) * cpm;
        int64_t p_lo = ord_lo * 64, p_hi = ord_hi * 64;
        for (size_t e = 0; e + 1 < E.exc.size(); e += 2) {
            int64_t p = E.exc[e];
            if (p >= p_lo && p < p_hi) {
                exc_out.push_back(p + rebase);
                exc_out.push_back(E.exc[e + 1]);
            }
        }
    }
    return out_n;
}

}  // namespace

extern "C" {

// v2 merged baseline scan decode. Same eligibility and error codes as
// jpx_decode_baseline_scan_sparse. dc_out/counts_out are [NB]
// (NB = mcus * sum(h*v)) and are fully written (zero-filled first).
// Returns the AC entry count; *n_exc_out gets the exception PAIR count
// (each pair = absolute coefficient position, residual); pairs beyond
// exc_capacity are counted but not written — the caller must check.
int64_t jpx_decode_baseline_scan_sparse2(
    const uint8_t* data,
    const int64_t* span_starts, const int64_t* span_ends, int32_t n_spans,
    int64_t restart_interval,
    int64_t mcus_per_line, int64_t mcus_per_column,
    int32_t n_comps,
    const int32_t* comp_h, const int32_t* comp_v,
    const uint8_t* dc_blob, const uint8_t* ac_blob,
    int16_t* dc_out, uint8_t* counts_out,
    uint8_t* acpos_out, int8_t* acval_out, int64_t ac_capacity,
    int64_t* exc_out, int64_t exc_capacity, int64_t* n_exc_out,
    int32_t n_threads) {
    if (n_comps <= 0 || n_comps > 4 || n_spans <= 0) return -4;

    std::vector<Component> comps(n_comps);
    int64_t comp_off[4];
    int64_t cpm = 0;
    for (int i = 0; i < n_comps; ++i) {
        comps[i].h = comp_h[i];
        comps[i].v = comp_v[i];
        comps[i].dc = reinterpret_cast<const HuffTable*>(dc_blob) + i;
        comps[i].ac = reinterpret_cast<const HuffTable*>(ac_blob) + i;
        comps[i].plane = nullptr;
        comps[i].wb = 0;
        comp_off[i] = cpm;
        cpm += (int64_t)comp_h[i] * comp_v[i] * 64;
    }
    std::vector<CombTable> comb_tables(2 * n_comps);
    for (int i = 0; i < n_comps; ++i) {
        build_comb_table(comps[i].dc, true, &comb_tables[2 * i]);
        build_comb_table(comps[i].ac, false, &comb_tables[2 * i + 1]);
        comps[i].dc_comb = comb_tables[2 * i].e;
        comps[i].ac_comb = comb_tables[2 * i + 1].e;
    }
    const int64_t total_mcus = mcus_per_line * mcus_per_column;
    const int64_t bpm = cpm / 64;
    const int64_t nb_total = total_mcus * bpm;
    std::memset(dc_out, 0, (size_t)nb_total * 2);
    std::memset(counts_out, 0, (size_t)nb_total);
    *n_exc_out = 0;

    auto flush_exc = [&](const std::vector<int64_t>& exc) {
        int64_t pairs = (int64_t)exc.size() / 2;
        int64_t keep = std::min(pairs, exc_capacity - *n_exc_out);
        if (keep > 0)
            std::memcpy(exc_out + 2 * *n_exc_out, exc.data(),
                        (size_t)keep * 16);
        *n_exc_out += pairs;  // true demand; caller checks vs capacity
    };

    if (restart_interval <= 0 || n_spans == 1) {
        // See the v1 twin: a declared restart interval caps the one
        // span's MCU budget (tolerated-truncation parity with the
        // dense per-span task list).
        int64_t span_mcus = restart_interval > 0
                                ? std::min<int64_t>(restart_interval,
                                                    total_mcus)
                                : total_mcus;
        SpanTask t{data + span_starts[0], span_ends[0] - span_starts[0],
                   0, span_mcus};
        {
            const char* spec_env = std::getenv("JPX_SPECULATIVE");
            bool allow_spec = !(spec_env && spec_env[0] == '0');
            int hw0 = (int)std::thread::hardware_concurrency();
            int nt0 = n_threads > 0 ? n_threads : (hw0 > 0 ? hw0 : 1);
            if (allow_spec && nt0 > 2) {
                std::vector<int64_t> exc;
                int64_t n = decode_span_sparse_speculative2(
                    t.data, t.len, span_mcus, comps.data(), n_comps, cpm,
                    comp_off, dc_out, counts_out, acpos_out, acval_out,
                    ac_capacity, exc, nt0);
                if (n != -6) {
                    if (n >= 0) flush_exc(exc);
                    return n;
                }
                // fall back: re-zero whatever the failed attempt wrote
                std::memset(dc_out, 0, (size_t)nb_total * 2);
                std::memset(counts_out, 0, (size_t)nb_total);
            }
        }
        std::vector<int64_t> exc;
        Emitter2 em;
        em.init(acpos_out, acval_out, ac_capacity, dc_out, counts_out, &exc);
        int rc = decode_span_sparse2(t, comps.data(), n_comps, cpm,
                                     comp_off, em);
        if (rc == 4 || em.overflow) return -1;
        if (rc == 2) return -2;
        if (rc == 1) return -3;
        flush_exc(exc);
        return em.n;
    }

    // Restart spans: DC/counts write straight to absolute ords
    // (disjoint across spans); AC entries emit into worst-case regions
    // then compact with plain memcpys (block-relative positions need
    // no patching — the v1 escape/delta machinery has no v2 analogue).
    struct SpanOut {
        SpanTask task;
        int64_t region_off;  // AC entry offset of this span's region
        Emitter2 em;
        std::vector<int64_t> exc;
        int rc;
    };
    std::vector<SpanOut> spans_out;
    {
        int64_t mcu = 0;
        int64_t off = 0;
        for (int32_t s = 0; s < n_spans && mcu < total_mcus; ++s) {
            int64_t n = std::min<int64_t>(restart_interval, total_mcus - mcu);
            SpanOut so;
            so.task = SpanTask{data + span_starts[s],
                               span_ends[s] - span_starts[s], mcu, n};
            so.region_off = off;
            so.rc = 0;
            spans_out.push_back(std::move(so));
            off += n * bpm * 63;  // worst case: 63 ACs per block
            mcu += n;
        }
        if (off > ac_capacity) return -1;
    }

    int hw = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;
    n_threads = std::min<int32_t>(n_threads, (int32_t)spans_out.size());

    auto run_one = [&](SpanOut& so, Component* cv) {
        so.em.init(acpos_out + so.region_off, acval_out + so.region_off,
                   so.task.n_mcus * bpm * 63, dc_out, counts_out, &so.exc);
        so.rc = decode_span_sparse2(so.task, cv, n_comps, cpm, comp_off,
                                    so.em);
    };

    if (n_threads <= 1) {
        for (auto& so : spans_out) run_one(so, comps.data());
    } else {
        std::vector<std::thread> pool;
        std::vector<std::vector<Component>> copies(n_threads, comps);
        for (int tid = 0; tid < n_threads; ++tid) {
            pool.emplace_back([&, tid]() {
                for (size_t k = tid; k < spans_out.size(); k += n_threads) {
                    run_one(spans_out[k], copies[tid].data());
                }
            });
        }
        for (auto& th : pool) th.join();
    }
    for (const auto& so : spans_out) {
        if (so.rc == 4 || so.em.overflow) return -1;
        if (so.rc == 2) return -2;
        if (so.rc == 1) return -3;
    }

    // Compaction: slide each span's AC slice left. Destinations never
    // exceed sources (regions are worst-case sized), memmove is safe.
    int64_t out_n = 0;
    for (auto& so : spans_out) {
        if (so.em.n > 0) {
            std::memmove(acpos_out + out_n, acpos_out + so.region_off,
                         (size_t)so.em.n);
            std::memmove(acval_out + out_n, acval_out + so.region_off,
                         (size_t)so.em.n);
            out_n += so.em.n;
        }
        flush_exc(so.exc);
    }
    return out_n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused whole-image baseline decode (container walk + tables + merged
// sparse scan in ONE native call)
// ---------------------------------------------------------------------------
//
// The per-image Python overhead (marker walk, DHT/DQT parse, table
// blob packing, ctypes marshalling) is GIL-held and caps multi-worker
// scaling; for the serving-dominant case — single-scan interleaved
// baseline — this entry point does the entire job natively. Returns a
// negative "not eligible" code for anything else so the Python path
// handles the full generality.

namespace {

// Build the two-level lookup HuffTable from DHT counts+values
// (mirrors syntax/huffman.py::HuffmanDecodingTable.build /
// JpegHuffmanDecodingTable.cs:293-390). Returns false for counts that
// are canonically infeasible (more codes at a length than the code
// space allows) — with such counts the 8-bit lookahead fill would
// index far past the table (corrupt DHT payloads reach here; the
// caller must reject the stream, not build from garbage).
static bool build_hufftable(const uint8_t counts[16], const uint8_t* values,
                            int n_values, HuffTable* t) {
    std::memset(t, 0, sizeof(*t));
    // code sizes in code order
    uint8_t sizes[257];
    int k = 0;
    for (int l = 1; l <= 16; ++l) {
        for (int i = 0; i < counts[l - 1] && k < 256; ++i) sizes[k++] = (uint8_t)l;
    }
    int total = k;
    // canonical codes (validating the Kraft prefix condition per level)
    uint16_t codes[256];
    {
        uint32_t code = 0;
        int si = 0;
        for (int l = 1; l <= 16; ++l) {
            while (si < total && sizes[si] == l) codes[si++] = (uint16_t)code++;
            if (code > (1u << l)) return false;  // infeasible counts
            code <<= 1;
        }
    }
    // maxcode (left-justified in 16 bits) + valoffset
    for (int l = 0; l < 18; ++l) t->maxcode[l] = 0;
    uint16_t maxcode_raw[17];
    int32_t valoff[17];
    {
        int si = 0;
        for (int l = 1; l <= 16; ++l) {
            if (counts[l - 1] == 0) {
                maxcode_raw[l] = 0;
                valoff[l] = 0;
                continue;
            }
            valoff[l] = si - (int32_t)codes[si];
            si += counts[l - 1];
            maxcode_raw[l] = codes[si - 1];
        }
    }
    // Mirror syntax/huffman.py exactly: maxcode left-justified with
    // 1-fill for present lengths, 0 for absent lengths (both decoders
    // share the same "code16 > maxcode" walk, so identical tables give
    // identical behavior even on the code16 == 0 corner), 0xFFFF
    // sentinel at [17].
    for (int l = 1; l <= 16; ++l) {
        if (counts[l - 1] == 0) {
            t->maxcode[l] = 0;
        } else {
            t->maxcode[l] =
                (uint16_t)(((uint32_t)maxcode_raw[l] << (16 - l)) |
                           ((1u << (16 - l)) - 1));
        }
    }
    t->maxcode[17] = 0xFFFF;
    for (int l = 1; l <= 16; ++l) {
        t->valoffset[l] = (uint8_t)(valoff[l] & 0xFF);
    }
    for (int i = 0; i < n_values && i < 256; ++i) t->values[i] = values[i];
    // 8-bit lookahead
    {
        int si = 0;
        for (int l = 1; l <= 8; ++l) {
            for (int i = 0; i < counts[l - 1]; ++i, ++si) {
                uint32_t code = codes[si];
                int shift = 8 - l;
                uint32_t base = code << shift;
                for (uint32_t fill = 0; fill < (1u << shift); ++fill) {
                    t->lookahead[base + fill] =
                        (uint16_t)((l << 8) | values[si]);
                }
            }
        }
    }
    return true;
}

// Everything the scan stage needs, produced by one pass over the
// container: tables in scan-component order, geometry, and the ECS
// span split. Shared by the single-image fused entry and the
// dual-image interleaved entry.
struct BaselinePlan {
    std::vector<HuffTable> dcs, acs;  // scan order
    int32_t ch[4], cv[4];
    int32_t n_comps = 0;
    int64_t mcus_per_line = 0, mcus_per_column = 0;
    int64_t restart_interval = 0;
    std::vector<int64_t> starts, ends;  // ECS spans
};

// Container walk + table build + ECS split for a single-scan baseline
// (SOF0/1) stream. Fills `info` (int32 fields):
//   [0]=width [1]=height [2]=precision [3]=n_comps
//   [4..7]=comp_h [8..11]=comp_v [12..15]=comp quant-table slot
//   [16]=SOF marker [17..20]=component ids [21]=Adobe APP14 transform
// and `quants` (uint16 [4][64], zig-zag). Returns 0, or -10 when the
// stream is not an eligible single-scan baseline image (Python path).
static int64_t walk_baseline_image(const uint8_t* data, int64_t len,
                                   BaselinePlan& P, int32_t* info,
                                   uint16_t* quants) {
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return -10;

    HuffTable dc_tables[4], ac_tables[4];
    bool dc_seen[4] = {false}, ac_seen[4] = {false};
    bool q_seen[4] = {false};
    int32_t width = 0, height = 0, precision = 0, n_comps = 0;
    int32_t sof_marker = 0xC0;
    int32_t comp_h[4], comp_v[4], comp_q[4], comp_dc[4], comp_ac[4], comp_id[4];
    int32_t adobe_transform = -1;  // APP14 "Adobe" color transform
    int64_t restart_interval = 0;
    int64_t pos = 2;
    bool got_sof = false;

    auto read16 = [&](int64_t p) -> int {
        return ((int)data[p] << 8) | data[p + 1];
    };

    int64_t sos_end = -1;
    while (pos + 4 <= len) {
        // hunt marker (skip fill bytes)
        if (data[pos] != 0xFF) return -10;  // garbage: let Python handle
        while (pos < len && data[pos] == 0xFF) ++pos;
        if (pos >= len) return -10;
        uint8_t marker = data[pos++];
        if (marker == 0xD8 || marker == 0x01 ||
            (marker >= 0xD0 && marker <= 0xD7))
            continue;  // no-payload markers
        if (marker == 0xD9) return -10;  // EOI before SOS
        if (pos + 2 > len) return -10;
        int seg_len = read16(pos);
        if (seg_len < 2 || pos + seg_len > len) return -10;
        const uint8_t* seg = data + pos + 2;
        int seg_n = seg_len - 2;
        if (marker == 0xC0 || marker == 0xC1) {  // SOF0/1
            if (seg_n < 6) return -10;
            sof_marker = marker;
            precision = seg[0];
            height = (seg[1] << 8) | seg[2];
            width = (seg[3] << 8) | seg[4];
            n_comps = seg[5];
            if (n_comps < 1 || n_comps > 4 || seg_n < 6 + 3 * n_comps) return -10;
            for (int i = 0; i < n_comps; ++i) {
                comp_id[i] = seg[6 + 3 * i];
                comp_h[i] = seg[6 + 3 * i + 1] >> 4;
                comp_v[i] = seg[6 + 3 * i + 1] & 15;
                comp_q[i] = seg[6 + 3 * i + 2];
                if (comp_q[i] > 3 || comp_h[i] < 1 || comp_v[i] < 1) return -10;
            }
            // height == 0 defers the line count to a DNL segment
            // (T.81 B.2.5) — the general Python path resolves it.
            if (height == 0 || width == 0) return -10;
            got_sof = true;
        } else if (marker >= 0xC2 && marker <= 0xCF && marker != 0xC4 &&
                   marker != 0xC8 && marker != 0xCC) {
            return -10;  // other SOF types: Python path
        } else if (marker == 0xDE || marker == 0xDF) {
            // DHP/EXP: hierarchical stream — the SOF0 here is only the
            // base pyramid frame; differential frames follow.
            return -10;
        } else if (marker == 0xC4) {  // DHT
            int off = 0;
            while (off + 17 <= seg_n) {
                int tc = seg[off] >> 4, th = seg[off] & 15;
                if (th > 3 || tc > 1) return -10;
                const uint8_t* counts = seg + off + 1;
                int nv = 0;
                for (int i = 0; i < 16; ++i) nv += counts[i];
                if (off + 17 + nv > seg_n || nv > 256) return -10;
                if (tc == 0) {
                    if (!build_hufftable(counts, seg + off + 17, nv,
                                         &dc_tables[th]))
                        return -10;
                    dc_seen[th] = true;
                } else {
                    if (!build_hufftable(counts, seg + off + 17, nv,
                                         &ac_tables[th]))
                        return -10;
                    ac_seen[th] = true;
                }
                off += 17 + nv;
            }
        } else if (marker == 0xDB) {  // DQT
            int off = 0;
            while (off < seg_n) {
                int pq = seg[off] >> 4, tq = seg[off] & 15;
                if (tq > 3) return -10;
                ++off;
                if (pq == 0) {
                    if (off + 64 > seg_n) return -10;
                    for (int i = 0; i < 64; ++i) quants[tq * 64 + i] = seg[off + i];
                    off += 64;
                } else if (pq == 1) {
                    if (off + 128 > seg_n) return -10;
                    for (int i = 0; i < 64; ++i)
                        quants[tq * 64 + i] =
                            (uint16_t)((seg[off + 2 * i] << 8) | seg[off + 2 * i + 1]);
                    off += 128;
                } else {
                    return -10;
                }
                q_seen[tq] = true;
            }
        } else if (marker == 0xDD) {  // DRI
            if (seg_n < 2) return -10;
            restart_interval = (seg[0] << 8) | seg[1];
        } else if (marker == 0xDA) {  // SOS
            if (!got_sof) return -10;
            if (seg_n < 1) return -10;  // length must cover Ns itself
            int ns = seg[0];
            if (ns != n_comps || seg_n < 1 + 2 * ns + 3) return -10;
            for (int i = 0; i < ns; ++i) {
                // components must appear in frame order (the sparse
                // layout assumes it)
                if (seg[1 + 2 * i] != comp_id[i]) return -10;
                comp_dc[i] = seg[1 + 2 * i + 1] >> 4;
                comp_ac[i] = seg[1 + 2 * i + 1] & 15;
                if (comp_dc[i] > 3 || comp_ac[i] > 3) return -10;
                if (!dc_seen[comp_dc[i]] || !ac_seen[comp_ac[i]]) return -10;
            }
            sos_end = pos + seg_len;
            break;
        } else if (marker == 0xEE) {  // APP14: Adobe color transform
            if (seg_n >= 12 && memcmp(seg, "Adobe", 5) == 0)
                adobe_transform = seg[11];
        }
        // other APPn/COM/anything else: skip
        pos += seg_len;
    }
    if (sos_end < 0 || !got_sof) return -10;
    for (int i = 0; i < n_comps; ++i)
        if (!q_seen[comp_q[i]]) return -10;
    if (n_comps == 1 && (comp_h[0] != 1 || comp_v[0] != 1)) return -10;

    // ECS span split: scan for markers (0xFF followed by non-0/non-FF),
    // splitting at RSTn; stop at any other marker (EOI/next SOS).
    std::vector<int64_t> starts, ends;
    uint8_t scan_terminator = 0;  // 0 = stream end (tolerated truncation)
    {
        int64_t p = sos_end;
        int64_t span_start = p;
        bool done = false;
        while (p + 1 < len && !done) {
            if (data[p] != 0xFF) { ++p; continue; }
            uint8_t b2 = data[p + 1];
            if (b2 == 0x00 || b2 == 0xFF) { ++p; continue; }
            if (b2 >= 0xD0 && b2 <= 0xD7) {  // RSTn
                starts.push_back(span_start);
                ends.push_back(p);
                p += 2;
                span_start = p;
                continue;
            }
            // terminating marker
            starts.push_back(span_start);
            ends.push_back(p);
            done = true;
            scan_terminator = b2;
            // Only EOI / DNL legally follow a complete single scan; any
            // other marker (another SOS, a hierarchical differential
            // SOF, EXP, ...) means this was not the whole image.
            if (b2 != 0xD9 && b2 != 0xDC) return -10;
        }
        if (!done) {
            starts.push_back(span_start);
            ends.push_back(len);
        }
    }

    // Assemble HuffTable blobs in scan component order.
    P.dcs.resize(n_comps);
    P.acs.resize(n_comps);
    int max_h = 1, max_v = 1;
    for (int i = 0; i < n_comps; ++i) {
        P.dcs[i] = dc_tables[comp_dc[i]];
        P.acs[i] = ac_tables[comp_ac[i]];
        P.ch[i] = comp_h[i];
        P.cv[i] = comp_v[i];
        if (comp_h[i] > max_h) max_h = comp_h[i];
        if (comp_v[i] > max_v) max_v = comp_v[i];
    }
    P.n_comps = n_comps;
    P.mcus_per_line = (width + 8 * max_h - 1) / (8 * max_h);
    P.mcus_per_column = (height + 8 * max_v - 1) / (8 * max_v);
    P.restart_interval = restart_interval;

    // A scan that ends at a non-restart, non-EOI marker before covering
    // all restart intervals is corrupt ("Expect restart marker."): defer
    // to the Python path, which raises. EOI/stream-end truncation stays
    // tolerated like the reference (JpegHuffmanBaselineScanDecoder.cs:145-149).
    if (restart_interval > 0 && scan_terminator != 0 && scan_terminator != 0xD9) {
        int64_t total = P.mcus_per_line * P.mcus_per_column;
        int64_t required = (total + restart_interval - 1) / restart_interval;
        if ((int64_t)starts.size() < required) return -10;
    }
    P.starts = std::move(starts);
    P.ends = std::move(ends);

    // Fill info BEFORE decoding so a capacity failure (-1) lets the
    // caller size the buffer from the parsed dimensions and retry.
    info[0] = width;
    info[1] = height;
    info[2] = precision;
    info[3] = n_comps;
    for (int i = 0; i < 4; ++i) {
        info[4 + i] = i < n_comps ? comp_h[i] : 0;
        info[8 + i] = i < n_comps ? comp_v[i] : 0;
        info[12 + i] = i < n_comps ? comp_q[i] : 0;
    }
    info[16] = sof_marker;  // 0xC0 or 0xC1 (the walk accepts both)
    for (int i = 0; i < 4; ++i)
        info[17 + i] = i < n_comps ? comp_id[i] : 0;
    info[21] = adobe_transform;  // -1 = no Adobe APP14
    return 0;
}

}  // namespace

extern "C" {

// Whole-image fused decode. On success returns the sparse entry count;
// see walk_baseline_image for the `info`/`quants` contract.
// Negative: -10 not eligible (Python path), -2/-3 decode errors,
// -1 capacity.
int64_t jpx_decode_image_baseline_sparse(
    const uint8_t* data, int64_t len,
    int16_t* out, int64_t capacity,
    int32_t* info, uint16_t* quants,
    int32_t n_threads) {
    BaselinePlan P;
    int64_t rc = walk_baseline_image(data, len, P, info, quants);
    if (rc != 0) return rc;
    return jpx_decode_baseline_scan_sparse(
        data,
        P.starts.data(), P.ends.data(), (int32_t)P.starts.size(),
        P.restart_interval,
        P.mcus_per_line, P.mcus_per_column,
        P.n_comps, P.ch, P.cv,
        reinterpret_cast<const uint8_t*>(P.dcs.data()),
        reinterpret_cast<const uint8_t*>(P.acs.data()),
        out, capacity, n_threads);
}

// v2-wire twin of the fused whole-image decode: same walk/eligibility,
// same info/quants contract, split-stream output (see
// jpx_decode_baseline_scan_sparse2). Returns the AC entry count.
int64_t jpx_decode_image_baseline_sparse2(
    const uint8_t* data, int64_t len,
    int16_t* dc_out, uint8_t* counts_out, int64_t nb_capacity,
    uint8_t* acpos_out, int8_t* acval_out, int64_t ac_capacity,
    int64_t* exc_out, int64_t exc_capacity, int64_t* n_exc_out,
    int32_t* info, uint16_t* quants,
    int32_t n_threads) {
    BaselinePlan P;
    int64_t rc = walk_baseline_image(data, len, P, info, quants);
    if (rc != 0) return rc;
    {   // dc/counts are caller-sized; the walk fills `info`, so a -1
        // lets the caller size both exactly and retry (v1 discipline).
        int64_t bpm = 0;
        for (int i = 0; i < P.n_comps; ++i) bpm += (int64_t)P.ch[i] * P.cv[i];
        if (P.mcus_per_line * P.mcus_per_column * bpm > nb_capacity)
            return -1;
    }
    return jpx_decode_baseline_scan_sparse2(
        data,
        P.starts.data(), P.ends.data(), (int32_t)P.starts.size(),
        P.restart_interval,
        P.mcus_per_line, P.mcus_per_column,
        P.n_comps, P.ch, P.cv,
        reinterpret_cast<const uint8_t*>(P.dcs.data()),
        reinterpret_cast<const uint8_t*>(P.acs.data()),
        dc_out, counts_out, acpos_out, acval_out, ac_capacity,
        exc_out, exc_capacity, n_exc_out, n_threads);
}

}  // extern "C"


// ---------------------------------------------------------------------------
// Progressive (SOF2) Huffman scan decode
// ---------------------------------------------------------------------------
//
// Mirrors jpeglibrary_tpu_torch/host/models/huffman_progressive.py (itself parity
// with JpegHuffmanProgressiveScanDecoder.cs:57-419): DC first/refine,
// AC first with EOB runs, AC refinement. Restart segments decode in
// parallel (each starts with fresh predictors and eobrun = 0).

namespace {

struct ScanParams {
    int ss, se, ah, al;
};

// DC first/refine for one block; predictor updated. Returns 0 ok,
// 1 premature end, 2 invalid code. `comb` is the optional combined
// symbol+EXTEND table for the DC table (null: plain decode).
static inline int read_block_prog_dc(BitReader& br, const HuffTable* dc,
                                     const uint32_t* comb,
                                     const ScanParams& sp, int32_t& predictor,
                                     int16_t* block) {
    if (sp.ah == 0) {
        int s;
        if (br.count < 32) br.fill();
        if (br.count >= 32) {  // hot path: one refill serves code + bits
            const uint32_t ec =
                comb ? comb[(uint32_t)(br.bits >> (64 - COMB_BITS))] : 0;
            if (ec) {  // code + EXTEND in one load
                const int adv = ec & 31;
                br.bits <<= adv;
                br.count -= adv;
                s = (int32_t)(int16_t)(ec >> 16);
            } else {
                s = decode_huffman_hot(br, dc);
                if (s < 0) return 2;
                if (s != 0 && s <= 16) {
                    uint32_t raw = (uint32_t)(br.bits >> (64 - s));
                    br.bits <<= s;
                    br.count -= s;
                    s = extend((int32_t)raw, s);
                } else if (s != 0) {
                    int err = 0;
                    s = receive_extend(br, s, &err);
                    if (err) return 1;
                }
            }
        } else {
            s = decode_huffman(br, dc);
            if (s < 0) return 2;
            int err = 0;
            if (s != 0) {
                s = receive_extend(br, s, &err);
                if (err) return 1;
            }
        }
        s += predictor;
        predictor = s;
        block[0] = (int16_t)(s << sp.al);
    } else {
        if (br.count == 0) {
            br.fill();
            if (br.count == 0) return 1;  // read(1) failure semantics
        }
        int bit = (int)(br.bits >> 63);
        br.bits <<= 1;
        --br.count;
        block[0] = (int16_t)(block[0] | (bit << sp.al));
    }
    return 0;
}

// AC first scan for one block; eobrun updated. `comb` is the optional
// combined symbol+EXTEND table for the AC table (EOB's eobrun extension
// bits are NOT folded — a comb hit on an EOB code advances the code
// only; the rr bits are pulled from the same refill window).
static inline int read_block_prog_ac(BitReader& br, const HuffTable* ac,
                                     const uint32_t* comb,
                                     const ScanParams& sp, int64_t& eobrun,
                                     int16_t* block) {
    if (eobrun != 0) {
        --eobrun;
        return 0;
    }
    int err = 0;
    int i = sp.ss;
    while (i <= sp.se) {
        int s, r;
        if (br.count < 32) br.fill();
        if (br.count >= 32) {  // hot path: one refill per coefficient
            const uint32_t ec =
                comb ? comb[(uint32_t)(br.bits >> (64 - COMB_BITS))] : 0;
            if (ec) {
                const int adv = ec & 31;
                br.bits <<= adv;
                br.count -= adv;
                if (ec & COMB_SZERO) {
                    const int rr = (ec >> 5) & 15;
                    if (rr == 15) {  // ZRL
                        i += 16;
                        continue;
                    }
                    eobrun = (int64_t)1 << rr;
                    if (rr != 0) {  // count >= 22 after adv <= 10
                        uint32_t raw = (uint32_t)(br.bits >> (64 - rr));
                        br.bits <<= rr;
                        br.count -= rr;
                        eobrun += (int32_t)raw;
                    }
                    --eobrun;
                    break;
                }
                i += (ec >> 5) & 15;
                block[i < 63 ? i : 63] =
                    (int16_t)(((int32_t)(int16_t)(ec >> 16)) << sp.al);
                ++i;
                continue;
            }
            s = decode_huffman_hot(br, ac);
            if (s < 0) return 2;
            r = s >> 4;
            s &= 15;
            i += r;
            if (s != 0) {
                uint32_t raw = (uint32_t)(br.bits >> (64 - s));
                br.bits <<= s;
                br.count -= s;
                block[i < 63 ? i : 63] = (int16_t)(extend((int32_t)raw, s) << sp.al);
            } else {
                if (r != 15) {
                    eobrun = (int64_t)1 << r;
                    if (r != 0) {
                        uint32_t raw = (uint32_t)(br.bits >> (64 - r));
                        br.bits <<= r;
                        br.count -= r;
                        eobrun += (int32_t)raw;
                    }
                    --eobrun;
                    break;
                }
            }
            ++i;
            continue;
        }
        s = decode_huffman(br, ac);
        if (s < 0) return 2;
        r = s >> 4;
        s &= 15;
        i += r;
        if (s != 0) {
            int32_t v = receive_extend(br, s, &err);
            if (err) return 1;
            block[i < 63 ? i : 63] = (int16_t)(v << sp.al);
        } else {
            if (r != 15) {
                eobrun = (int64_t)1 << r;
                if (r != 0) {
                    int32_t bits = br.read(r);
                    if (bits < 0) return 1;
                    eobrun += bits;
                }
                --eobrun;
                break;
            }
        }
        ++i;
    }
    return 0;
}

// AC refinement (JpegHuffmanProgressiveScanDecoder.cs:313-419 incl. the
// coef >= 0 vs coef > 0 asymmetry). Scalar reference implementation;
// the dispatching wrapper below selects the bitmap fast path when the
// host has BMI2.
static inline int read_block_prog_ac_refined_scalar(
    BitReader& br, const HuffTable* ac,
    const ScanParams& sp, int64_t& eobrun,
    int16_t* block) {
    int start = sp.ss, end = sp.se;
    int p1 = 1 << sp.al;
    int m1 = -(1 << sp.al);  // == (-1) << al for al < 31, without UB
    int k = start;

    if (eobrun == 0) {
        while (k <= end) {
            int s, r;
            // Hot path: one refill serves the Huffman code (<=16 bits)
            // plus the sign bit or the EOB-run bits (<=14).
            if (br.count < 32) br.fill();
            if (br.count >= 32) {
                s = decode_huffman_hot(br, ac);
                if (s < 0) return 2;
                r = s >> 4;
                s &= 15;
                if (s != 0) {
                    int bit = (int)(br.bits >> 63);
                    br.bits <<= 1;
                    --br.count;
                    s = bit != 0 ? p1 : m1;
                } else if (r != 15) {
                    eobrun = (int64_t)1 << r;
                    if (r != 0) {
                        uint32_t raw = (uint32_t)(br.bits >> (64 - r));
                        br.bits <<= r;
                        br.count -= r;
                        eobrun += (int32_t)raw;
                    }
                    break;
                }
            } else {
                s = decode_huffman(br, ac);
                if (s < 0) return 2;
                r = s >> 4;
                s &= 15;
                if (s != 0) {
                    int32_t bit = br.read(1);
                    if (bit < 0) return 1;
                    s = bit != 0 ? p1 : m1;
                } else if (r != 15) {
                    eobrun = (int64_t)1 << r;
                    if (r != 0) {
                        int32_t bits = br.read(r);
                        if (bits < 0) return 1;
                        eobrun += bits;
                    }
                    break;
                }
            }

            while (k <= end) {
                int coef = block[k];
                if (coef != 0) {
                    // Correction bit straight off the register (refill
                    // only when it runs dry; same TryReadBits failure
                    // semantics as br.read(1)).
                    if (br.count == 0) {
                        br.fill();
                        if (br.count == 0) return 1;
                    }
                    int bit = (int)(br.bits >> 63);
                    br.bits <<= 1;
                    --br.count;
                    if (bit != 0 && (coef & p1) == 0) {
                        block[k] = (int16_t)(coef + (coef >= 0 ? p1 : m1));
                    }
                } else {
                    if (--r < 0) break;
                }
                ++k;
            }

            if (s != 0 && k < 64) {
                block[k] = (int16_t)s;
            }
            ++k;
        }
    }

    if (eobrun > 0) {
        for (; k <= end; ++k) {
            int coef = block[k];
            if (coef != 0) {
                if (br.count == 0) {
                    br.fill();
                    if (br.count == 0) return 1;
                }
                int bit = (int)(br.bits >> 63);
                br.bits <<= 1;
                --br.count;
                if (bit != 0 && (coef & p1) == 0) {
                    block[k] = (int16_t)(coef + (coef > 0 ? p1 : m1));
                }
            }
        }
        --eobrun;
    }
    return 0;
}

#ifdef JPX_HAVE_REFINE_FAST

// Nonzero bitmap of a 64-coefficient block: bit i set iff block[i] != 0.
static inline uint64_t block_nonzero_mask(const int16_t* block) {
    const __m128i zero = _mm_setzero_si128();
    uint64_t mask = 0;
    for (int g = 0; g < 64; g += 16) {
        __m128i a = _mm_loadu_si128((const __m128i*)(block + g));
        __m128i b = _mm_loadu_si128((const __m128i*)(block + g + 8));
        __m128i packed =
            _mm_packs_epi16(_mm_cmpeq_epi16(a, zero), _mm_cmpeq_epi16(b, zero));
        uint32_t z = (uint32_t)_mm_movemask_epi8(packed);  // 1 = zero lane
        mask |= ((uint64_t)(~z & 0xFFFFu)) << g;
    }
    return mask;
}

// Bitmap AC refinement: behaviorally identical to the scalar version,
// but the per-coefficient walk is replaced by (a) a SIMD nonzero mask,
// (b) pdep to locate the (r+1)-th zero (the insertion point), and
// (c) batched correction-bit reads — one branchy iteration per NONZERO
// coefficient instead of one per band position. This loop dominates
// progressive decode (the reference's hot path is
// JpegHuffmanProgressiveScanDecoder.cs:313-419).
static inline int read_block_prog_ac_refined_fast(
    BitReader& br, const HuffTable* ac,
    const ScanParams& sp, int64_t& eobrun,
    int16_t* block) {
    const int start = sp.ss, end = sp.se;
    const int p1 = 1 << sp.al;
    const int m1 = -(1 << sp.al);
    const uint64_t band =
        (end == 63 ? ~0ULL : ((1ULL << (end + 1)) - 1)) & ~((1ULL << start) - 1);
    uint64_t nz = block_nonzero_mask(block) & band;
    int k = start;

    // Read one correction bit per set position of m (ascending), apply
    // the p1/m1 increment on 1-bits. Batched 24 bits per refill away
    // from the stream end; per-bit with the scalar failure point near
    // it. Returns 0 ok, 1 premature end.
    auto apply_correction = [&](uint64_t m) -> int {
        while (m) {
            int n = __builtin_popcountll(m);
            int c = n < 24 ? n : 24;
            if (br.count < c) br.fill();
            if (br.count >= c) {
                uint32_t raw = (uint32_t)(br.bits >> (64 - c));
                br.bits <<= c;
                br.count -= c;
                for (int j = c - 1; j >= 0; --j) {
                    int kk = __builtin_ctzll(m);
                    m &= m - 1;
                    if ((raw >> j) & 1) {
                        int coef = block[kk];
                        if ((coef & p1) == 0)
                            block[kk] =
                                (int16_t)(coef + (coef >= 0 ? p1 : m1));
                    }
                }
            } else {
                int kk = __builtin_ctzll(m);
                m &= m - 1;
                if (br.count == 0) {
                    br.fill();
                    if (br.count == 0) return 1;
                }
                int bit = (int)(br.bits >> 63);
                br.bits <<= 1;
                --br.count;
                if (bit) {
                    int coef = block[kk];
                    if ((coef & p1) == 0)
                        block[kk] = (int16_t)(coef + (coef >= 0 ? p1 : m1));
                }
            }
        }
        return 0;
    };

    if (eobrun == 0) {
        while (k <= end) {
            int s, r;
            if (br.count < 32) br.fill();
            if (br.count >= 32) {
                s = decode_huffman_hot(br, ac);
                if (s < 0) return 2;
                r = s >> 4;
                s &= 15;
                if (s != 0) {
                    int bit = (int)(br.bits >> 63);
                    br.bits <<= 1;
                    --br.count;
                    s = bit != 0 ? p1 : m1;
                } else if (r != 15) {
                    eobrun = (int64_t)1 << r;
                    if (r != 0) {
                        uint32_t raw = (uint32_t)(br.bits >> (64 - r));
                        br.bits <<= r;
                        br.count -= r;
                        eobrun += (int32_t)raw;
                    }
                    break;
                }
            } else {
                s = decode_huffman(br, ac);
                if (s < 0) return 2;
                r = s >> 4;
                s &= 15;
                if (s != 0) {
                    int32_t bit = br.read(1);
                    if (bit < 0) return 1;
                    s = bit != 0 ? p1 : m1;
                } else if (r != 15) {
                    eobrun = (int64_t)1 << r;
                    if (r != 0) {
                        int32_t bits = br.read(r);
                        if (bits < 0) return 1;
                        eobrun += bits;
                    }
                    break;
                }
            }

            // Traverse from k: skip r zeros, reading one correction bit
            // per nonzero passed; insert s (if any) at the (r+1)-th
            // zero — or at end+1 when fewer zeros remain (the scalar
            // walk's exit state).
            const uint64_t ge_k = ~((1ULL << k) - 1);
            const uint64_t zeros = ~nz & band & ge_k;
            const uint64_t sel = _pdep_u64(1ULL << r, zeros);
            if (sel != 0) {
                const int ins = __builtin_ctzll(sel);
                if (apply_correction(nz & ge_k & (sel - 1))) return 1;
                if (s != 0) {
                    block[ins] = (int16_t)s;
                    nz |= sel;
                }
                k = ins + 1;
            } else {
                if (apply_correction(nz & ge_k)) return 1;
                k = end + 1;
                if (s != 0 && k < 64) block[k] = (int16_t)s;
                ++k;
            }
        }
    }

    if (eobrun > 0) {
        if (k <= end) {
            if (apply_correction(nz & ~((1ULL << k) - 1))) return 1;
        }
        --eobrun;
    }
    return 0;
}

#endif  // JPX_HAVE_REFINE_FAST

static inline int read_block_prog_ac_refined(BitReader& br, const HuffTable* ac,
                                             const ScanParams& sp, int64_t& eobrun,
                                             int16_t* block) {
#ifdef JPX_HAVE_REFINE_FAST
    // JPX_REFINE_SCALAR=1 forces the scalar walk (A/B benchmarking and
    // differential testing of the two implementations).
    static const bool use_scalar = [] {
        const char* e = std::getenv("JPX_REFINE_SCALAR");
        return e != nullptr && e[0] == '1';
    }();
    if (!use_scalar)
        return read_block_prog_ac_refined_fast(br, ac, sp, eobrun, block);
#endif
    return read_block_prog_ac_refined_scalar(br, ac, sp, eobrun, block);
}

struct ProgSpanTask {
    const uint8_t* data;
    int64_t len;
    int64_t first_unit;  // MCU index (interleaved) or block index (non-interleaved)
    int64_t n_units;
};

// One progressive span: interleaved DC walk over the frame MCU grid.
static int prog_decode_span_interleaved(const ProgSpanTask& task, Component* comps,
                                        int n_comps, const ScanParams& sp,
                                        int64_t mcus_per_line) {
    BitReader br;
    br.init(task.data, task.len);
    std::vector<int32_t> pred(n_comps, 0);
    for (int64_t m = 0; m < task.n_units; ++m) {
        int64_t mcu = task.first_unit + m;
        int64_t row = mcu / mcus_per_line;
        int64_t col = mcu % mcus_per_line;
        for (int ci = 0; ci < n_comps; ++ci) {
            Component& c = comps[ci];
            for (int y = 0; y < c.v; ++y) {
                int64_t by = row * c.v + y;
                for (int x = 0; x < c.h; ++x) {
                    int64_t bx = col * c.h + x;
                    int rc = read_block_prog_dc(br, c.dc, c.dc_comb, sp,
                                                pred[ci],
                                                c.plane + (by * c.wb + bx) * 64);
                    if (rc) return rc;
                }
            }
        }
    }
    return 0;
}

// One progressive span: non-interleaved walk over one component's grid.
static int prog_decode_span_single(const ProgSpanTask& task, Component& c,
                                   const ScanParams& sp, int64_t hbc) {
    BitReader br;
    br.init(task.data, task.len);
    int32_t pred = 0;
    int64_t eobrun = 0;
    const bool is_dc = sp.ss == 0;
    int64_t by = task.first_unit / hbc;
    int64_t bx = task.first_unit % hbc;
    for (int64_t u = 0; u < task.n_units; ++u) {
        int16_t* block = c.plane + (by * c.wb + bx) * 64;
        ++bx;
        if (bx == hbc) {
            bx = 0;
            ++by;
        }
        int rc;
        if (is_dc) {
            rc = read_block_prog_dc(br, c.dc, c.dc_comb, sp, pred, block);
        } else if (sp.ah == 0) {
            rc = read_block_prog_ac(br, c.ac, c.ac_comb, sp, eobrun, block);
        } else {
            rc = read_block_prog_ac_refined(br, c.ac, sp, eobrun, block);
        }
        if (rc) return rc;
    }
    return 0;
}

}  // namespace

extern "C" {

// Decode one progressive scan. For interleaved scans (n_comps > 1),
// units are MCUs on the frame grid; for single-component scans, units
// are blocks on the component's own grid of width `hbc`.
int jpx_decode_progressive_scan(
    const uint8_t* data,
    const int64_t* span_starts, const int64_t* span_ends, int32_t n_spans,
    int64_t restart_interval,
    int64_t total_units, int64_t mcus_per_line, int64_t hbc,
    int32_t n_comps,
    const int32_t* comp_h, const int32_t* comp_v,
    const uint8_t* dc_blob, const uint8_t* ac_blob,
    int16_t** planes, const int64_t* plane_wb,
    int32_t ss, int32_t se, int32_t ah, int32_t al,
    int32_t n_threads) {
    if (n_comps <= 0 || n_spans <= 0) return 3;
    ScanParams sp{ss, se, ah, al};

    std::vector<Component> comps(n_comps);
    for (int i = 0; i < n_comps; ++i) {
        comps[i].h = comp_h[i];
        comps[i].v = comp_v[i];
        comps[i].dc = reinterpret_cast<const HuffTable*>(dc_blob) + i;
        comps[i].ac = reinterpret_cast<const HuffTable*>(ac_blob) + i;
        comps[i].plane = planes[i];
        comps[i].wb = plane_wb[i];
    }
    // Combined symbol+EXTEND tables for the first-pass scans (refine
    // scans read raw bits, not symbols). Shared read-only by threads.
    std::vector<CombTable> comb_tables;
    if (ah == 0) {
        comb_tables.resize(n_comps);
        for (int i = 0; i < n_comps; ++i) {
            if (ss == 0) {
                build_comb_table(comps[i].dc, true, &comb_tables[i]);
                comps[i].dc_comb = comb_tables[i].e;
            } else {
                build_comb_table(comps[i].ac, false, &comb_tables[i]);
                comps[i].ac_comb = comb_tables[i].e;
            }
        }
    }

    std::vector<ProgSpanTask> tasks;
    if (restart_interval <= 0) {
        tasks.push_back({data + span_starts[0], span_ends[0] - span_starts[0], 0, total_units});
    } else {
        int64_t unit = 0;
        for (int32_t s = 0; s < n_spans && unit < total_units; ++s) {
            int64_t n = std::min<int64_t>(restart_interval, total_units - unit);
            tasks.push_back({data + span_starts[s], span_ends[s] - span_starts[s], unit, n});
            unit += n;
        }
    }

    int hw = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;
    n_threads = std::min<int32_t>(n_threads, (int32_t)tasks.size());

    auto run_task = [&](const ProgSpanTask& t, std::vector<Component>& cv) -> int {
        if (n_comps > 1) {
            return prog_decode_span_interleaved(t, cv.data(), n_comps, sp, mcus_per_line);
        }
        return prog_decode_span_single(t, cv[0], sp, hbc);
    };

    if (n_threads <= 1) {
        for (const auto& t : tasks) {
            int rc = run_task(t, comps);
            if (rc) return rc;
        }
        return 0;
    }

    std::vector<int> results(tasks.size(), 0);
    std::vector<std::thread> pool;
    std::vector<std::vector<Component>> copies(n_threads, comps);
    for (int tid = 0; tid < n_threads; ++tid) {
        pool.emplace_back([&, tid]() {
            for (size_t k = tid; k < tasks.size(); k += n_threads) {
                results[k] = run_task(tasks[k], copies[tid]);
            }
        });
    }
    for (auto& th : pool) th.join();
    for (int rc : results)
        if (rc) return rc;
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Watermark-pipelined progressive scan chains
// ---------------------------------------------------------------------------
//
// A progressive stream's heavy cost is the per-component AC chain
// (first scan -> successive refinements): the scans write overlapping
// bands of the same blocks, so scan-level scheduling serializes them.
// But the dependency is per BLOCK, not per scan: refinement of unit u
// only needs the earlier scan to have FINISHED unit u. Each scan runs
// in its own thread, publishing a completed-unit watermark; the next
// scan of the same component spins until its gate watermark passes the
// unit it wants. Wall-clock becomes ~max(scan cost) instead of the sum.
//
// Threads claim scans in stream order (atomic counter), so the earliest
// unfinished claimed scan always has its gate satisfied — deadlock-free
// with any thread count. On ANY exit (success or error) a scan posts
// INT64_MAX so downstream threads never hang; errors propagate and the
// caller discards the planes.

namespace {

struct alignas(64) ChainWatermark {
    std::atomic<int64_t> v{0};
};

struct ChainScan {
    const int64_t* span_starts;  // into the caller's concatenated arrays
    const int64_t* span_ends;
    int32_t n_spans;
    int64_t restart_interval;
    ScanParams sp;
    const HuffTable* table;  // DC table for ss==0, else AC table
    const uint32_t* comb = nullptr;  // combined table (ah==0 scans only)
    int16_t* plane;
    int64_t wb;           // plane row stride in blocks
    int64_t hbc;          // blocks per row for this component
    int64_t total_units;  // hbc * vbc
    int32_t gate;         // index of the previous same-component scan, or -1
};

static int chain_decode_scan(const uint8_t* data, const ChainScan& cs,
                             ChainWatermark* wms, int self) {
    std::atomic<int64_t>* gate = cs.gate >= 0 ? &wms[cs.gate].v : nullptr;
    std::atomic<int64_t>* mine = &wms[self].v;
    BitReader br;
    int span_i = 0;
    br.init(data + cs.span_starts[0], cs.span_ends[0] - cs.span_starts[0]);
    int32_t pred = 0;
    int64_t eobrun = 0;
    int64_t before_restart = cs.restart_interval;
    const bool is_dc = cs.sp.ss == 0;
    const bool is_refine = cs.sp.ah != 0;
    int rc = 0;

    // Watermarks are PUBLISHED (and polled) at a 32-unit granularity:
    // a per-unit release store would bounce the watermark cache line
    // between producer and consumer cores on every block. The consumer
    // caches the last observed value and only re-loads when it actually
    // needs more progress; waits back off pause -> yield -> sleep so
    // oversubscribed chains don't burn the cores the producers need.
    int64_t seen = 0;
    int64_t by = 0, bx = 0;
    for (int64_t u = 0; u < cs.total_units; ++u) {
        if (gate && u >= seen) {
            int spins = 0, yields = 0;
            for (;;) {
                seen = gate->load(std::memory_order_acquire);
                if (seen > u) break;
#if defined(__x86_64__)
                __builtin_ia32_pause();
#endif
                if (++spins > 1024) {
                    spins = 0;
                    if (++yields > 64) {
                        std::this_thread::sleep_for(
                            std::chrono::microseconds(100));
                    } else {
                        std::this_thread::yield();
                    }
                }
            }
        }
        int16_t* block = cs.plane + (by * cs.wb + bx) * 64;
        ++bx;
        if (bx == cs.hbc) {
            bx = 0;
            ++by;
        }
        if (is_dc) {
            rc = read_block_prog_dc(br, cs.table, cs.comb, cs.sp, pred, block);
        } else if (!is_refine) {
            rc = read_block_prog_ac(br, cs.table, cs.comb, cs.sp, eobrun, block);
        } else {
            rc = read_block_prog_ac_refined(br, cs.table, cs.sp, eobrun, block);
        }
        if (rc) break;
        if (((u + 1) & 31) == 0)
            mine->store(u + 1, std::memory_order_release);
        if (cs.restart_interval > 0 && --before_restart == 0) {
            ++span_i;
            if (span_i >= cs.n_spans) break;  // tolerated truncation
            br.init(data + cs.span_starts[span_i],
                    cs.span_ends[span_i] - cs.span_starts[span_i]);
            pred = 0;
            eobrun = 0;
            before_restart = cs.restart_interval;
        }
    }
    mine->store(INT64_MAX, std::memory_order_release);
    return rc;
}

// Decode ONE restart span of a multi-span chain scan: units
// [k*ri, min(total, (k+1)*ri)). No gating inside — the scheduler only
// dispatches a span once its gate scan's watermark covers the span's
// END unit, and restart boundaries reset every bit of entropy state
// (bit reader, DC predictor, EOB run), so spans of one scan are
// mutually independent.
static int chain_decode_span(const uint8_t* data, const ChainScan& cs,
                             int32_t k) {
    const int64_t u0 = (int64_t)k * cs.restart_interval;
    const int64_t u1 =
        std::min<int64_t>(cs.total_units, u0 + cs.restart_interval);
    BitReader br;
    br.init(data + cs.span_starts[k], cs.span_ends[k] - cs.span_starts[k]);
    int32_t pred = 0;
    int64_t eobrun = 0;
    const bool is_dc = cs.sp.ss == 0;
    const bool is_refine = cs.sp.ah != 0;
    int64_t by = u0 / cs.hbc, bx = u0 % cs.hbc;
    for (int64_t u = u0; u < u1; ++u) {
        int16_t* block = cs.plane + (by * cs.wb + bx) * 64;
        ++bx;
        if (bx == cs.hbc) {
            bx = 0;
            ++by;
        }
        int rc;
        if (is_dc) {
            rc = read_block_prog_dc(br, cs.table, cs.comb, cs.sp, pred, block);
        } else if (!is_refine) {
            rc = read_block_prog_ac(br, cs.table, cs.comb, cs.sp, eobrun, block);
        } else {
            rc = read_block_prog_ac_refined(br, cs.table, cs.sp, eobrun, block);
        }
        if (rc) return rc;
    }
    return 0;
}

// Per-scan scheduling state for the span-claiming worker pool.
struct alignas(64) ChainSched {
    std::atomic<int32_t> next{0};     // next span index to claim
    std::atomic<int32_t> prefix{0};   // first not-yet-done span
    std::atomic<char> claimed{0};     // whole-scan claim (span-less scans)
    std::atomic<char> finished{0};
    std::unique_ptr<std::atomic<char>[]> done;  // per span
    int32_t n_work = 0;  // spans that actually carry units
    bool spanwise = false;
};

}  // namespace

extern "C" {

// Decode a set of NON-INTERLEAVED progressive Huffman scans (stream
// order) with per-unit watermark pipelining. Returns 0 ok, 1 premature
// end, 2 invalid code, 3 bad args.
int jpx_decode_progressive_chains(
    const uint8_t* data,
    int32_t n_scans,
    const int64_t* span_starts, const int64_t* span_ends,  // concatenated
    const int32_t* span_offsets, const int32_t* span_counts,  // per scan
    const int64_t* restart_intervals,
    const int32_t* ss_arr, const int32_t* se_arr,
    const int32_t* ah_arr, const int32_t* al_arr,
    const int32_t* gates,        // per scan: previous same-component scan or -1
    const uint8_t* table_blobs,  // per scan, one HuffTable each
    int16_t** planes, const int64_t* wbs,
    const int64_t* hbcs, const int64_t* total_units_arr,
    int32_t n_threads) {
    if (n_scans <= 0) return 3;
    std::vector<ChainScan> scans(n_scans);
    for (int s = 0; s < n_scans; ++s) {
        ChainScan& cs = scans[s];
        cs.span_starts = span_starts + span_offsets[s];
        cs.span_ends = span_ends + span_offsets[s];
        cs.n_spans = span_counts[s];
        if (cs.n_spans <= 0) return 3;
        cs.restart_interval = restart_intervals[s];
        cs.sp = ScanParams{ss_arr[s], se_arr[s], ah_arr[s], al_arr[s]};
        cs.table = reinterpret_cast<const HuffTable*>(table_blobs) + s;
        cs.plane = planes[s];
        cs.wb = wbs[s];
        cs.hbc = hbcs[s];
        cs.total_units = total_units_arr[s];
        cs.gate = gates[s];
        if (cs.gate >= s) return 3;  // gates must point backwards
    }
    // Combined symbol+EXTEND tables for the first-pass scans.
    std::vector<CombTable> comb_tables(n_scans);
    for (int s = 0; s < n_scans; ++s) {
        if (ah_arr[s] == 0) {
            build_comb_table(scans[s].table, ss_arr[s] == 0, &comb_tables[s]);
            scans[s].comb = comb_tables[s].e;
        }
    }

    std::vector<ChainWatermark> wms(n_scans);
    std::vector<int> results(n_scans, 0);
    int hw = (int)std::thread::hardware_concurrency();
    int T = n_threads > 0 ? n_threads : (hw > 0 ? hw : 1);

    if (T <= 1) {
        // Sequential: stream order satisfies every gate by construction.
        for (int s = 0; s < n_scans; ++s)
            results[s] = chain_decode_scan(data, scans[s], wms.data(), s);
        for (int rc : results)
            if (rc) return rc;
        return 0;
    }

    // Span-claiming worker pool. Work items are restart spans (for
    // multi-span scans) or whole scans (span-less: decoded with the
    // per-unit watermark pipeline in chain_decode_scan). Workers scan
    // the job list in stream order and take the EARLIEST runnable
    // item; a span is runnable once its gate scan's watermark covers
    // the span's end unit. Progress argument: the earliest unfinished
    // scan's transitive gate chain is finished, so its work is always
    // runnable; any worker finishing an item rescans from scan 0 and
    // picks it up, and a worker parked inside a span-less scan's
    // per-unit gate poll sits above a producer that is either finished
    // or actively progressing — no cycle is possible because gates
    // point strictly backwards in stream order.
    std::vector<ChainSched> sched(n_scans);
    int64_t total_items = 0;
    for (int s = 0; s < n_scans; ++s) {
        ChainScan& cs = scans[s];
        ChainSched& sc = sched[s];
        sc.spanwise = cs.restart_interval > 0 && cs.n_spans > 1;
        if (sc.spanwise) {
            int64_t required =
                (cs.total_units + cs.restart_interval - 1) / cs.restart_interval;
            sc.n_work = (int32_t)std::min<int64_t>(cs.n_spans, required);
            sc.done.reset(new std::atomic<char>[sc.n_work]);
            for (int32_t k = 0; k < sc.n_work; ++k)
                sc.done[k].store(0, std::memory_order_relaxed);
            total_items += sc.n_work;
        } else {
            total_items += 1;
        }
    }
    T = (int)std::min<int64_t>(T, total_items);

    auto finish_scan = [&](int s) {
        wms[s].v.store(INT64_MAX, std::memory_order_release);
        sched[s].finished.store(1, std::memory_order_release);
    };

    // All done[]/prefix operations are seq_cst (the defaults): the
    // LAST completer in the total order observes every done flag set
    // and drives prefix all the way to n_work, so the scan always
    // finishes — with weaker orders two completers can each miss the
    // other's flag and leave the prefix stuck.
    auto complete_span = [&](int s, int32_t k) {
        ChainSched& sc = sched[s];
        const ChainScan& cs = scans[s];
        sc.done[k].store(1);
        int32_t p = sc.prefix.load();
        while (p < sc.n_work && sc.done[p].load()) {
            if (sc.prefix.compare_exchange_weak(p, p + 1)) {
                ++p;
                // Monotone watermark raise (stale stores must not
                // lower it: a consumer could then spin on a value a
                // faster sibling already published past).
                int64_t w = std::min<int64_t>(
                    cs.total_units, (int64_t)p * cs.restart_interval);
                int64_t cur = wms[s].v.load(std::memory_order_relaxed);
                while (cur < w &&
                       !wms[s].v.compare_exchange_weak(
                           cur, w, std::memory_order_release)) {
                }
            }
        }
        if (p >= sc.n_work) finish_scan(s);
    };

    auto worker = [&]() {
        int idle = 0;
        for (;;) {
            bool any_open = false;
            bool did_work = false;
            for (int s = 0; s < n_scans && !did_work; ++s) {
                ChainSched& sc = sched[s];
                if (sc.finished.load(std::memory_order_acquire)) continue;
                any_open = true;
                const ChainScan& cs = scans[s];
                if (!sc.spanwise) {
                    char expect = 0;
                    if (sc.claimed.compare_exchange_strong(expect, 1)) {
                        int rc = chain_decode_scan(data, cs, wms.data(), s);
                        if (rc) results[s] = rc;
                        sc.finished.store(1, std::memory_order_release);
                        did_work = true;
                    }
                    continue;
                }
                int32_t k = sc.next.load();
                while (k < sc.n_work) {
                    if (cs.gate >= 0) {
                        int64_t u1 = std::min<int64_t>(
                            cs.total_units,
                            (int64_t)(k + 1) * cs.restart_interval);
                        if (wms[cs.gate].v.load(std::memory_order_acquire) < u1)
                            break;  // not runnable yet; try later scans
                    }
                    if (sc.next.compare_exchange_weak(k, k + 1)) {
                        int rc = chain_decode_span(data, cs, k);
                        if (rc) results[s] = rc;
                        complete_span(s, k);
                        did_work = true;
                        break;
                    }
                }
            }
            if (!any_open) return;
            if (did_work) {
                idle = 0;
            } else {
#if defined(__x86_64__)
                __builtin_ia32_pause();
#endif
                if (++idle > 256) {
                    idle = 0;
                    std::this_thread::yield();
                }
            }
        }
    };

    std::vector<std::thread> pool;
    for (int t = 0; t < T; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    for (int rc : results)
        if (rc) return rc;
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Lossless (SOF3) Huffman predictive decode
// ---------------------------------------------------------------------------
//
// Mirrors jpeglibrary_tpu_torch/host/models/lossless.py (parity with
// JpegHuffmanLosslessScanDecoder.cs:52-223). The predictor chain makes
// rows sequentially dependent, so spans decode sequentially — native
// speed is the win here, not threading.

namespace {

static inline int predict_lossless(int sel, int ra, int rb, int rc) {
    switch (sel) {
        case 1: return ra;
        case 2: return rb;
        case 3: return rc;
        case 4: return ra + rb - rc;
        case 5: return ra + ((rb - rc) >> 1);
        case 6: return rb + ((ra - rc) >> 1);
        case 7: return (ra + rb) >> 1;
        default: return 0;
    }
}

struct LosslessComp {
    int h, v;
    const HuffTable* table;
    const uint32_t* comb = nullptr;  // combined category+EXTEND table
    int16_t* plane;   // [rows, width] int16 sample plane (padded grid)
    int64_t width;
};

}  // namespace

extern "C" {

// Decode a lossless frame's scan. Returns 0 ok, 1 premature end,
// 2 invalid code, 3 bad args.
int jpx_decode_lossless_scan(
    const uint8_t* data,
    const int64_t* span_starts, const int64_t* span_ends, int32_t n_spans,
    int64_t restart_interval,
    int64_t mcus_per_line, int64_t mcus_per_column,
    int32_t n_comps,
    const int32_t* comp_h, const int32_t* comp_v,
    const uint8_t* table_blob,           // n_comps HuffTables (DC selectors)
    int16_t** planes, const int64_t* plane_widths,
    int32_t predictor_sel, int32_t initial_prediction) {
    if (n_comps <= 0 || n_spans <= 0) return 3;

    std::vector<LosslessComp> comps(n_comps);
    std::vector<CombTable> combs(n_comps);
    for (int i = 0; i < n_comps; ++i) {
        comps[i].h = comp_h[i];
        comps[i].v = comp_v[i];
        comps[i].table = reinterpret_cast<const HuffTable*>(table_blob) + i;
        build_comb_table(comps[i].table, /*is_dc=*/true, &combs[i]);
        comps[i].comb = combs[i].e;
        comps[i].plane = planes[i];
        comps[i].width = plane_widths[i];
    }

    int span_idx = 0;
    BitReader br;
    br.init(data + span_starts[0], span_ends[0] - span_starts[0]);
    int64_t mcus_before_restart = restart_interval;

    for (int64_t row_mcu = 0; row_mcu < mcus_per_column; ++row_mcu) {
        for (int64_t col_mcu = 0; col_mcu < mcus_per_line; ++col_mcu) {
            bool at_restart_start =
                restart_interval > 0 && mcus_before_restart == restart_interval;
            for (int ci = 0; ci < n_comps; ++ci) {
                LosslessComp& c = comps[ci];
                int64_t offset_x = col_mcu * c.h;
                int64_t offset_y = row_mcu * c.v;
                for (int y = 0; y < c.v; ++y) {
                    int64_t row = offset_y + y;
                    int16_t* scanline = c.plane + row * c.width;
                    const int16_t* lastline =
                        (y == 0 && row_mcu == 0) ? nullptr : c.plane + (row - 1) * c.width;
                    for (int x = 0; x < c.h; ++x) {
                        // ReadSampleLossless (t==16 -> 32768). Hot
                        // path: one refill serves code + EXTEND bits
                        // (cf. read_block_baseline_sparse).
                        int t;
                        int32_t diff;
                        if (br.count < 32) br.fill();
                        if (br.count >= 32) {
                            const uint32_t ec =
                                c.comb[(uint32_t)(br.bits >> (64 - COMB_BITS))];
                            if (ec) {  // category + EXTEND in one load
                                const int adv = ec & 31;
                                br.bits <<= adv;
                                br.count -= adv;
                                diff = (int32_t)(int16_t)(ec >> 16);
                                goto have_diff;
                            }
                            t = decode_huffman_hot(br, c.table);
                            if (t < 0) return 2;
                            if (t == 16) {
                                diff = 32768;
                            } else if (t != 0) {
                                if (t > 16) {  // corrupt table: careful path
                                    int err = 0;
                                    diff = receive_extend(br, t, &err);
                                    if (err) return 1;
                                } else {
                                    uint32_t rawv = (uint32_t)(br.bits >> (64 - t));
                                    br.bits <<= t;
                                    br.count -= t;
                                    diff = extend((int32_t)rawv, t);
                                }
                            } else {
                                diff = 0;
                            }
                        } else {
                            t = decode_huffman(br, c.table);
                            if (t < 0) return 2;
                            if (t == 16) {
                                diff = 32768;
                            } else if (t != 0) {
                                int err = 0;
                                diff = receive_extend(br, t, &err);
                                if (err) return 1;
                            } else {
                                diff = 0;
                            }
                        }
                    have_diff:;
                        int64_t cx = offset_x + x;
                        if (row_mcu == 0 || at_restart_start) {
                            if (col_mcu == 0 && x == 0) {
                                diff += initial_prediction;
                            } else {
                                int ra = scanline[cx - 1];
                                int rb = y == 0 ? initial_prediction : lastline[cx];
                                int rc = y == 0 ? initial_prediction : lastline[cx - 1];
                                diff += predict_lossless(predictor_sel, ra, rb, rc);
                            }
                        } else if (col_mcu == 0) {
                            // Differential frames (T.81 J, sel 0) code
                            // raw diffs: no Rb at line starts either.
                            if (predictor_sel) diff += lastline[cx];
                        } else {
                            int ra = scanline[cx - 1];
                            int rb = lastline[cx];
                            int rc = lastline[cx - 1];
                            diff += predict_lossless(predictor_sel, ra, rb, rc);
                        }
                        scanline[cx] = (int16_t)diff;
                    }
                }
            }

            if (restart_interval > 0) {
                if (--mcus_before_restart == 0) {
                    ++span_idx;
                    if (span_idx >= n_spans) return 0;  // tolerated truncation
                    br.init(data + span_starts[span_idx],
                            span_ends[span_idx] - span_starts[span_idx]);
                    mcus_before_restart = restart_interval;
                }
            }
        }
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Streaming lossless decode: bounded-memory row-panel cursor
// ---------------------------------------------------------------------------
//
// The TPU-native analogue of the reference's 16-row ring
// (JpegPartialScanlineAllocator.cs:11,60): a stateful cursor decodes
// the scan MCU-row-panel at a time into caller-provided buffers,
// carrying only (a) the bit-reader position, (b) restart-span state,
// and (c) ONE previous sample row per component (the Rb/Rc context) —
// peak memory O(width), never O(image). Sample semantics are
// bit-identical to jpx_decode_lossless_scan.

namespace {

struct LosslessStream {
    const uint8_t* data;
    std::vector<int64_t> starts, ends;
    int64_t restart_interval;
    int64_t mcus_per_line, mcus_per_column;
    int n_comps;
    std::vector<HuffTable> tables;
    std::vector<CombTable> combs;  // combined category+EXTEND tables
    struct SComp {
        int h, v;
        int64_t width;
        std::vector<int16_t> prev_row;  // last decoded sample row
    };
    std::vector<SComp> comps;
    int predictor_sel;
    int initial_prediction;
    BitReader br;
    int span_idx = 0;
    int64_t mcus_before_restart = 0;
    int64_t row_mcu = 0;
    bool exhausted_spans = false;
};

}  // namespace

extern "C" {

void* jpx_lossless_stream_open(
    const uint8_t* data,
    const int64_t* span_starts, const int64_t* span_ends, int32_t n_spans,
    int64_t restart_interval,
    int64_t mcus_per_line, int64_t mcus_per_column,
    int32_t n_comps,
    const int32_t* comp_h, const int32_t* comp_v,
    const uint8_t* table_blob,
    const int64_t* plane_widths,
    int32_t predictor_sel, int32_t initial_prediction) {
    if (n_comps <= 0 || n_spans <= 0) return nullptr;
    auto* st = new LosslessStream();
    st->data = data;
    st->starts.assign(span_starts, span_starts + n_spans);
    st->ends.assign(span_ends, span_ends + n_spans);
    st->restart_interval = restart_interval;
    st->mcus_per_line = mcus_per_line;
    st->mcus_per_column = mcus_per_column;
    st->n_comps = n_comps;
    const HuffTable* tb = reinterpret_cast<const HuffTable*>(table_blob);
    st->tables.assign(tb, tb + n_comps);
    st->combs.resize(n_comps);
    for (int i = 0; i < n_comps; ++i)
        build_comb_table(&st->tables[i], /*is_dc=*/true, &st->combs[i]);
    st->comps.resize(n_comps);
    for (int i = 0; i < n_comps; ++i) {
        st->comps[i].h = comp_h[i];
        st->comps[i].v = comp_v[i];
        st->comps[i].width = plane_widths[i];
        st->comps[i].prev_row.assign((size_t)plane_widths[i], 0);
    }
    st->predictor_sel = predictor_sel;
    st->initial_prediction = initial_prediction;
    st->br.init(data + st->starts[0], st->ends[0] - st->starts[0]);
    st->mcus_before_restart = restart_interval;
    return st;
}

void jpx_lossless_stream_close(void* h) {
    delete static_cast<LosslessStream*>(h);
}

// Decode up to `n_mcu_rows` further MCU rows into panels[i] (int16
// [n_mcu_rows * v_i, width_i], caller-provided). Returns the number of
// MCU rows delivered (0 at end of image), or -2 on an invalid Huffman
// code, -1 on premature bitstream end. Like the batch decoder, running
// out of restart spans zero-fills the remainder (truncation tolerance).
int64_t jpx_lossless_stream_next(void* hptr, int64_t n_mcu_rows,
                                 int16_t** panels) {
    auto* st = static_cast<LosslessStream*>(hptr);
    if (st == nullptr || n_mcu_rows <= 0) return -3;
    const int64_t first_row_mcu = st->row_mcu;
    if (first_row_mcu >= st->mcus_per_column) return 0;
    const int64_t last_row_mcu =
        std::min(st->mcus_per_column, first_row_mcu + n_mcu_rows);
    const int sel = st->predictor_sel;
    const int init = st->initial_prediction;

    for (int64_t row_mcu = first_row_mcu; row_mcu < last_row_mcu; ++row_mcu) {
        const int64_t prow_mcu = row_mcu - first_row_mcu;
        // Tolerated truncation (ran out of restart spans): the caller
        // provides zero-initialized panels, so the remainder simply
        // stays zero — parity with the batch decoder's zero-alloc
        // planes (jpx_decode_lossless_scan returns 0 there).
        if (st->exhausted_spans) continue;
        for (int64_t col_mcu = 0; col_mcu < st->mcus_per_line; ++col_mcu) {
            bool at_restart_start = st->restart_interval > 0 &&
                st->mcus_before_restart == st->restart_interval;
            for (int ci = 0; ci < st->n_comps; ++ci) {
                LosslessStream::SComp& c = st->comps[ci];
                const HuffTable* table = &st->tables[ci];
                int64_t offset_x = col_mcu * c.h;
                for (int y = 0; y < c.v; ++y) {
                    int64_t prow = prow_mcu * c.v + y;
                    int16_t* scanline = panels[ci] + prow * c.width;
                    const int16_t* lastline;
                    if (y == 0 && row_mcu == 0) {
                        lastline = nullptr;
                    } else if (prow == 0) {
                        lastline = c.prev_row.data();
                    } else {
                        lastline = panels[ci] + (prow - 1) * c.width;
                    }
                    for (int x = 0; x < c.h; ++x) {
                        int t;
                        int32_t diff;
                        BitReader& br = st->br;
                        if (br.count < 32) br.fill();
                        if (br.count >= 32) {
                            const uint32_t ec = st->combs[ci]
                                .e[(uint32_t)(br.bits >> (64 - COMB_BITS))];
                            if (ec) {  // category + EXTEND in one load
                                const int adv = ec & 31;
                                br.bits <<= adv;
                                br.count -= adv;
                                diff = (int32_t)(int16_t)(ec >> 16);
                                goto stream_have_diff;
                            }
                            t = decode_huffman_hot(br, table);
                            if (t < 0) return -2;
                            if (t == 16) {
                                diff = 32768;
                            } else if (t != 0) {
                                if (t > 16) {
                                    int err = 0;
                                    diff = receive_extend(br, t, &err);
                                    if (err) return -1;
                                } else {
                                    uint32_t rawv =
                                        (uint32_t)(br.bits >> (64 - t));
                                    br.bits <<= t;
                                    br.count -= t;
                                    diff = extend((int32_t)rawv, t);
                                }
                            } else {
                                diff = 0;
                            }
                        } else {
                            t = decode_huffman(br, table);
                            if (t < 0) return -2;
                            if (t == 16) {
                                diff = 32768;
                            } else if (t != 0) {
                                int err = 0;
                                diff = receive_extend(br, t, &err);
                                if (err) return -1;
                            } else {
                                diff = 0;
                            }
                        }
                    stream_have_diff:;
                        int64_t cx = offset_x + x;
                        if (row_mcu == 0 || at_restart_start) {
                            if (col_mcu == 0 && x == 0) {
                                diff += init;
                            } else {
                                int ra = scanline[cx - 1];
                                int rb = y == 0 ? init : lastline[cx];
                                int rc = y == 0 ? init : lastline[cx - 1];
                                diff += predict_lossless(sel, ra, rb, rc);
                            }
                        } else if (col_mcu == 0) {
                            if (sel) diff += lastline[cx];  // sel 0: raw diffs
                        } else {
                            int ra = scanline[cx - 1];
                            int rb = lastline[cx];
                            int rc = lastline[cx - 1];
                            diff += predict_lossless(sel, ra, rb, rc);
                        }
                        scanline[cx] = (int16_t)diff;
                    }
                }
            }
            if (st->restart_interval > 0) {
                if (--st->mcus_before_restart == 0) {
                    ++st->span_idx;
                    st->mcus_before_restart = st->restart_interval;
                    if (st->span_idx >= (int)st->starts.size()) {
                        st->exhausted_spans = true;
                        break;  // rest of the zeroed panel stays zero
                    }
                    st->br.init(st->data + st->starts[st->span_idx],
                                st->ends[st->span_idx] -
                                    st->starts[st->span_idx]);
                }
            }
        }
        // carry the Rb/Rc context: last sample row of this MCU row
        for (int ci = 0; ci < st->n_comps; ++ci) {
            LosslessStream::SComp& c = st->comps[ci];
            int64_t prow = prow_mcu * c.v + (c.v - 1);
            std::memcpy(c.prev_row.data(), panels[ci] + prow * c.width,
                        (size_t)c.width * sizeof(int16_t));
        }
    }
    st->row_mcu = last_row_mcu;
    return last_row_mcu - first_row_mcu;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Speculative parallel lossless decode (no restart markers)
// ---------------------------------------------------------------------------
//
// The lossless predictor chain is 2-D-sequential, but the Huffman DIFF
// stream is context-free: a decoder locked onto the symbol stream
// yields correct diffs regardless of where it started. So: phase A
// threads speculatively decode diff values from chunk byte boundaries
// (self-sync + canonical-state stitch exactly like the baseline
// speculative scanner), producing the full diff sequence in parallel;
// then per-component prediction reconstruction runs as a cheap
// bit-free pass (components in parallel). Output is bit-identical to
// the sequential decode; any stitch failure falls back to it.
// Only the 1x1-sampling single-span case is handled (the wrapper
// gates).

namespace {

struct LlRecord {
    int64_t byte_off;
    int32_t bit_count;
    uint64_t bits;
    int64_t mcu_idx;  // thread-local MCU (pixel) index at this state
};

static inline bool ll_rec_less(const LlRecord& a, const LlRecord& b) {
    return a.byte_off != b.byte_off ? a.byte_off < b.byte_off
                                    : a.bit_count > b.bit_count;
}

static inline bool ll_rec_eq(const LlRecord& a, const LlRecord& b) {
    return a.byte_off == b.byte_off && a.bit_count == b.bit_count;
}

// Decode one lossless diff (ReadSampleLossless semantics). `comb` is
// the optional combined category+EXTEND table (cat==16 is never
// covered — its 32768 special case always takes the fallback).
static inline int ll_read_diff(BitReader& br, const HuffTable* t,
                               const uint32_t* comb, int32_t* out) {
    int cat;
    if (br.count < 32) br.fill();
    if (br.count >= 32) {
        const uint32_t ec =
            comb ? comb[(uint32_t)(br.bits >> (64 - COMB_BITS))] : 0;
        if (ec) {
            const int adv = ec & 31;
            br.bits <<= adv;
            br.count -= adv;
            *out = (int32_t)(int16_t)(ec >> 16);
            return 0;
        }
        cat = decode_huffman_hot(br, t);
        if (cat < 0) return 2;
        if (cat == 16) { *out = 32768; return 0; }
        if (cat == 0) { *out = 0; return 0; }
        if (cat > 16) {  // corrupt table: careful path
            int err = 0;
            *out = receive_extend(br, cat, &err);
            return err ? 1 : 0;
        }
        uint32_t raw = (uint32_t)(br.bits >> (64 - cat));
        br.bits <<= cat;
        br.count -= cat;
        *out = extend((int32_t)raw, cat);
        return 0;
    }
    cat = decode_huffman(br, t);
    if (cat < 0) return 2;
    if (cat == 16) { *out = 32768; return 0; }
    if (cat == 0) { *out = 0; return 0; }
    int err = 0;
    *out = receive_extend(br, cat, &err);
    return err ? 1 : 0;
}

// Phase A for one thread: decode diffs from `from`, recording
// canonical states for the first `head_n` MCUs and for every MCU whose
// position falls in [tail_from, tail_to].
static void ll_speculative_scan(const uint8_t* base, int64_t span_len,
                                int64_t from, int64_t tail_from, int64_t tail_to,
                                const HuffTable* tables,
                                const CombTable* combs, int n_comps,
                                int64_t max_mcus, int64_t head_n,
                                std::vector<int16_t>& diffs,
                                std::vector<LlRecord>& head,
                                std::vector<LlRecord>& tail) {
    const int kMaxRetries = 64;
    for (int attempt = 0; attempt < kMaxRetries; ++attempt) {
        int64_t start = from + attempt;
        if (start >= span_len) return;
        diffs.clear();
        head.clear();
        tail.clear();
        BitReader br;
        br.init(base + start, span_len - start);
        bool failed = false;
        for (int64_t m = 0; m < max_mcus; ++m) {
            br.fill();  // canonicalize
            LlRecord rec;
            rec.byte_off = (br.p - base);
            rec.bit_count = br.count;
            rec.bits = br.bits;
            rec.mcu_idx = m;
            if (m < head_n) head.push_back(rec);
            if (rec.byte_off >= tail_from && rec.byte_off <= tail_to)
                tail.push_back(rec);
            if (rec.byte_off > tail_to + 8) return;  // covered the window
            for (int ci = 0; ci < n_comps; ++ci) {
                int32_t d;
                int rc = ll_read_diff(br, tables + ci, combs[ci].e, &d);
                if (rc == 2) { failed = true; break; }
                if (rc == 1) return;  // end of stream: keep what we have
                diffs.push_back((int16_t)d);
            }
            if (failed) break;
        }
        if (!failed) return;
        if (diffs.size() > (size_t)(16 * n_comps)) return;  // locked, then corrupt
    }
    diffs.clear();
    head.clear();
    tail.clear();
}

template <int SEL>
static inline int32_t ll_predict_t(int32_t ra, int32_t rb, int32_t rc) {
    switch (SEL) {
        case 1: return ra;
        case 2: return rb;
        case 3: return rc;
        case 4: return ra + rb - rc;
        case 5: return ra + ((rb - rc) >> 1);
        case 6: return rb + ((ra - rc) >> 1);
        case 7: return (ra + rb) >> 1;
        default: return 0;
    }
}

// Bit-free prediction pass for one component plane over an AoS diff
// buffer [mcu][component]. A restart-start MCU predicts like a row-0
// sample (JpegHuffmanLosslessScanDecoder.cs:109-115); interval <= 0
// means no restart boundaries. The selector is a template parameter
// and boundary positions are computed per row, so the inner loop
// carries no per-sample switch or modulo — for predictor 1 it reduces
// to the serial add chain.
template <int SEL>
static void ll_reconstruct_plane_t(int16_t* plane, int64_t width,
                                   const int16_t* diffs, int n_comps, int ci,
                                   int64_t mpl, int64_t mpc,
                                   int64_t interval, int32_t init) {
    const int16_t* dp = diffs + ci;
    for (int64_t r = 0; r < mpc; ++r) {
        int16_t* line = plane + r * width;
        const int16_t* d = dp + r * mpl * n_comps;
        if (r == 0) {
            // Row 0: Rb = Rc = init everywhere, so a restart boundary
            // changes nothing (same init-based formula).
            line[0] = (int16_t)((int32_t)d[0] + init);
            for (int64_t x = 1; x < mpl; ++x)
                line[x] = (int16_t)((int32_t)d[x * n_comps] +
                                    ll_predict_t<SEL>(line[x - 1], init, init));
            continue;
        }
        const int16_t* last = plane + (r - 1) * width;
        int64_t next_b = mpl;  // x of the next restart boundary this row
        if (interval > 0) {
            int64_t rem = (r * mpl) % interval;
            next_b = rem == 0 ? 0 : interval - rem;
        }
        if (next_b == 0) {  // restart boundary at x == 0 -> init
            line[0] = (int16_t)((int32_t)d[0] + init);
            next_b = interval;
        } else {
            int32_t diff = (int32_t)d[0];
            if (SEL != 0) diff += last[0];  // x==0 always predicts Rb
            line[0] = (int16_t)diff;
        }
        int64_t x = 1;
        while (x < mpl) {
            const int64_t run_end = next_b < mpl ? next_b : mpl;
            for (; x < run_end; ++x)
                line[x] = (int16_t)((int32_t)d[x * n_comps] +
                                    ll_predict_t<SEL>(line[x - 1], last[x],
                                                      last[x - 1]));
            if (x < mpl) {  // restart boundary mid-row
                line[x] = (int16_t)((int32_t)d[x * n_comps] +
                                    ll_predict_t<SEL>(line[x - 1], init, init));
                ++x;
                next_b += interval;
            }
        }
    }
}

// Predictor-1 reconstruction for rows [r0, r1) where r0 begins a
// restart interval (or is row 0) and the interval is a multiple of
// the row length: the boundary sample takes init, Ra chains stay in
// the row, and the column-0 Rb link stays inside the block — so
// blocks reconstruct independently (the same invariant the region
// fast path exploits, models/region.py). Bit-identical to
// ll_reconstruct_plane_t<1> under those conditions (no mid-row
// boundaries can occur).
static void ll_reconstruct_rows_p1(int16_t* plane, int64_t width,
                                   const int16_t* diffs, int n_comps, int ci,
                                   int64_t mpl, int64_t r0, int64_t r1,
                                   int64_t interval, int32_t init) {
    const int16_t* dp = diffs + ci;
    for (int64_t r = r0; r < r1; ++r) {
        int16_t* line = plane + r * width;
        const int16_t* d = dp + r * mpl * n_comps;
        const bool fresh =
            r == 0 || (interval > 0 && (r * mpl) % interval == 0);
        if (fresh) {
            line[0] = (int16_t)((int32_t)d[0] + init);
        } else {
            const int16_t* last = plane + (r - 1) * width;
            line[0] = (int16_t)((int32_t)d[0] + last[0]);  // x==0 -> Rb
        }
        for (int64_t x = 1; x < mpl; ++x)
            line[x] = (int16_t)((int32_t)d[x * n_comps] + line[x - 1]);
    }
}

static void ll_reconstruct_plane(int sel, int16_t* plane, int64_t width,
                                 const int16_t* diffs, int n_comps, int ci,
                                 int64_t mpl, int64_t mpc,
                                 int64_t interval, int32_t init) {
    switch (sel) {
        case 1: ll_reconstruct_plane_t<1>(plane, width, diffs, n_comps, ci, mpl, mpc, interval, init); break;
        case 2: ll_reconstruct_plane_t<2>(plane, width, diffs, n_comps, ci, mpl, mpc, interval, init); break;
        case 3: ll_reconstruct_plane_t<3>(plane, width, diffs, n_comps, ci, mpl, mpc, interval, init); break;
        case 4: ll_reconstruct_plane_t<4>(plane, width, diffs, n_comps, ci, mpl, mpc, interval, init); break;
        case 5: ll_reconstruct_plane_t<5>(plane, width, diffs, n_comps, ci, mpl, mpc, interval, init); break;
        case 6: ll_reconstruct_plane_t<6>(plane, width, diffs, n_comps, ci, mpl, mpc, interval, init); break;
        case 7: ll_reconstruct_plane_t<7>(plane, width, diffs, n_comps, ci, mpl, mpc, interval, init); break;
        default: ll_reconstruct_plane_t<0>(plane, width, diffs, n_comps, ci, mpl, mpc, interval, init); break;
    }
}

}  // namespace

extern "C" {

// Parallel lossless decode of one entropy span (1x1 sampling, all
// components in the scan). Returns 0 ok, -1 could-not-sync (caller
// falls back to the sequential path), 1/2 decode errors.
int jpx_decode_lossless_scan_parallel(
    const uint8_t* data, int64_t span_start, int64_t span_end,
    int64_t mcus_per_line, int64_t mcus_per_column,
    int32_t n_comps,
    const uint8_t* table_blob,
    int16_t** planes, const int64_t* plane_widths,
    int32_t predictor_sel, int32_t initial_prediction,
    int32_t n_threads) {
    if (n_comps <= 0 || n_comps > 4) return -1;
    const HuffTable* tables = reinterpret_cast<const HuffTable*>(table_blob);
    std::vector<CombTable> combs(n_comps);
    for (int i = 0; i < n_comps; ++i)
        build_comb_table(tables + i, /*is_dc=*/true, &combs[i]);
    const uint8_t* base = data + span_start;
    const int64_t span_len = span_end - span_start;
    const int64_t total_mcus = mcus_per_line * mcus_per_column;

    int hw = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;
    int T = n_threads;
    if ((int64_t)T > span_len / 262144) T = (int)(span_len / 262144);
    if (T < 2) return -1;
    const int64_t kOverlap = 16384;
    const int64_t kHeadN = 8192;

    struct ThreadOut {
        std::vector<int16_t> diffs;
        std::vector<LlRecord> head, tail;
    };
    std::vector<ThreadOut> outs(T);
    {
        std::vector<std::thread> pool;
        int64_t chunk = span_len / T;
        for (int t = 0; t < T; ++t) {
            int64_t from = t * chunk;
            int64_t tail_from = (t + 1 < T) ? (t + 1) * chunk : span_len;
            int64_t tail_to = tail_from + kOverlap;
            pool.emplace_back([&, t, from, tail_from, tail_to]() {
                ll_speculative_scan(base, span_len, from, tail_from, tail_to,
                                    tables, combs.data(), n_comps,
                                    total_mcus + 16, kHeadN,
                                    outs[t].diffs, outs[t].head, outs[t].tail);
            });
        }
        for (auto& th : pool) th.join();
    }

    // Stitch: thread 0 is ground truth from MCU 0; chain sync points.
    if (outs[0].diffs.empty()) return -1;
    std::vector<int16_t> all_diffs;
    all_diffs.reserve((size_t)(total_mcus * n_comps));

    int64_t abs_base = 0;       // absolute MCU index of current thread's local 0
    int64_t local_from = 0;     // local MCU index to consume from
    int cur = 0;
    for (int t = 1; t <= T; ++t) {
        int64_t local_to;       // exclusive local end of cur's contribution
        int64_t next_local = 0;
        if (t < T) {
            const auto& a = outs[cur].tail;
            const auto& b = outs[t].head;
            size_t i = 0, j = 0;
            bool found = false;
            while (i < a.size() && j < b.size()) {
                if (ll_rec_eq(a[i], b[j])) { found = true; break; }
                if (ll_rec_less(a[i], b[j])) ++i; else ++j;
            }
            if (!found) return -1;
            local_to = a[i].mcu_idx;
            next_local = b[j].mcu_idx;
        } else {
            local_to = local_from +
                       ((int64_t)outs[cur].diffs.size() / n_comps - local_from);
        }
        int64_t abs_from = abs_base + local_from;
        int64_t abs_to = abs_base + local_to;
        if (abs_to > total_mcus) abs_to = total_mcus;
        if (abs_to < abs_from) return -1;
        int64_t need = (abs_to - abs_from) * n_comps;
        int64_t have = (int64_t)outs[cur].diffs.size() - local_from * n_comps;
        if (have < need) return -1;
        all_diffs.insert(all_diffs.end(),
                         outs[cur].diffs.begin() + local_from * n_comps,
                         outs[cur].diffs.begin() + local_from * n_comps + need);
        if ((int64_t)all_diffs.size() >= total_mcus * n_comps) break;
        if (t == T) break;
        abs_base = abs_to - next_local;
        local_from = next_local;
        cur = t;
    }
    if ((int64_t)all_diffs.size() < total_mcus * n_comps) return -1;

    // Reconstruction: per-component prediction pass (parallel across
    // components), identical neighbor logic to the sequential decoder.
    std::vector<std::thread> pool;
    for (int ci = 0; ci < n_comps; ++ci) {
        pool.emplace_back([&, ci]() {
            ll_reconstruct_plane(predictor_sel, planes[ci], plane_widths[ci],
                                 all_diffs.data(), n_comps, ci,
                                 mcus_per_line, mcus_per_column,
                                 /*interval=*/0, initial_prediction);
        });
    }
    for (auto& th : pool) th.join();
    return 0;
}

// Restart-interval parallel lossless decode: each span's DIFF stream
// is bitstream-independent (byte-aligned, context-free symbols), so
// spans decode concurrently into a shared diff buffer; reconstruction
// then applies the prediction chain in one cheap bit-free pass per
// component (matching the sequential decoder's at_restart_start
// semantics, JpegHuffmanLosslessScanDecoder.cs:109-115). 1x1 sampling
// only (wrapper gates). Returns 0 ok, 1 premature end, 2 invalid code.
int jpx_decode_lossless_restart_parallel(
    const uint8_t* data,
    const int64_t* span_starts, const int64_t* span_ends, int32_t n_spans,
    int64_t restart_interval,
    int64_t mcus_per_line, int64_t mcus_per_column,
    int32_t n_comps,
    const uint8_t* table_blob,
    int16_t** planes, const int64_t* plane_widths,
    int32_t predictor_sel, int32_t initial_prediction,
    int32_t n_threads) {
    if (n_comps <= 0 || n_comps > 4 || restart_interval <= 0) return 3;
    const HuffTable* tables = reinterpret_cast<const HuffTable*>(table_blob);
    std::vector<CombTable> combs(n_comps);
    for (int i = 0; i < n_comps; ++i)
        build_comb_table(tables + i, /*is_dc=*/true, &combs[i]);
    const int64_t total_mcus = mcus_per_line * mcus_per_column;

    struct Span {
        int64_t start, end, first_mcu, n_mcus;
    };
    std::vector<Span> spans;
    {
        int64_t mcu = 0;
        for (int32_t s = 0; s < n_spans && mcu < total_mcus; ++s) {
            int64_t nm = std::min<int64_t>(restart_interval, total_mcus - mcu);
            spans.push_back({span_starts[s], span_ends[s], mcu, nm});
            mcu += nm;
        }
    }

    // Persistent per-calling-thread diff buffer (a fresh ~25 MB
    // allocation re-page-faulted every call — same lesson as the
    // encoder's pack scratch); zero only the span-uncovered tail
    // (tolerated truncation) — covered diffs are fully overwritten by
    // the parallel decode, which also spreads the first-touch faults
    // across the pool.
    static thread_local std::unique_ptr<int16_t[]> tl_diffs;
    static thread_local int64_t tl_diffs_cap = 0;
    constexpr int64_t kDiffsRetain = 32 << 20;  // elements (64 MB)
    const int64_t diffs_need = total_mcus * n_comps;
    if (tl_diffs_cap < diffs_need) {
        tl_diffs.reset(new int16_t[(size_t)diffs_need]);
        tl_diffs_cap = diffs_need;
    }
    // Gigapixel-class buffers are released after the call (same
    // retention discipline as the encoder's pack scratch).
    struct DiffsTrim {
        ~DiffsTrim() {
            if (tl_diffs_cap > kDiffsRetain) {
                tl_diffs.reset();
                tl_diffs_cap = 0;
            }
        }
    } trim_guard;
    int16_t* const diffs_p = tl_diffs.get();
    {
        const int64_t covered =
            spans.empty() ? 0 : spans.back().first_mcu + spans.back().n_mcus;
        if (covered < total_mcus)
            std::memset(diffs_p + covered * n_comps, 0,
                        (size_t)((total_mcus - covered) * n_comps) *
                            sizeof(int16_t));
    }

    int hw = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;
    int T = std::min<int>(n_threads, (int)spans.size());

    std::vector<int> results(spans.size(), 0);
    auto decode_span_diffs = [&](const Span& sp, int& rc_out) {
        BitReader br;
        br.init(data + sp.start, sp.end - sp.start);
        int16_t* out = diffs_p + sp.first_mcu * n_comps;
        for (int64_t m = 0; m < sp.n_mcus; ++m) {
            for (int ci = 0; ci < n_comps; ++ci) {
                int32_t d;
                int rc = ll_read_diff(br, tables + ci, combs[ci].e, &d);
                if (rc) { rc_out = rc; return; }
                out[m * n_comps + ci] = (int16_t)d;
            }
        }
        rc_out = 0;
    };
    if (T <= 1) {
        for (size_t k = 0; k < spans.size(); ++k)
            decode_span_diffs(spans[k], results[k]);
    } else {
        std::vector<std::thread> pool;
        for (int tid = 0; tid < T; ++tid) {
            pool.emplace_back([&, tid]() {
                for (size_t k = tid; k < spans.size(); k += T)
                    decode_span_diffs(spans[k], results[k]);
            });
        }
        for (auto& th : pool) th.join();
    }
    for (int rc : results)
        if (rc) return rc;

    // Reconstruction. Predictor 1 with a row-aligned interval splits
    // into independent restart blocks (see ll_reconstruct_rows_p1), so
    // the pass threads over (component, block) tasks — one serial
    // plane per component otherwise capped scaling at ~2.7x on 4
    // cores (the diff decode scales, the reconstruction did not).
    if (predictor_sel == 1 && restart_interval % mcus_per_line == 0 &&
        n_threads > 1) {
        const int64_t rpb = restart_interval / mcus_per_line;
        struct RTask {
            int ci;
            int64_t r0, r1;
        };
        std::vector<RTask> rtasks;
        for (int ci = 0; ci < n_comps; ++ci)
            for (int64_t r0 = 0; r0 < mcus_per_column; r0 += rpb)
                rtasks.push_back(
                    {ci, r0, std::min(mcus_per_column, r0 + rpb)});
        int RT = std::min<int>(n_threads, (int)rtasks.size());
        std::vector<std::thread> rpool;
        for (int tid = 0; tid < RT; ++tid) {
            rpool.emplace_back([&, tid]() {
                for (size_t k = tid; k < rtasks.size(); k += RT) {
                    const RTask& t = rtasks[k];
                    ll_reconstruct_rows_p1(
                        planes[t.ci], plane_widths[t.ci], diffs_p,
                        n_comps, t.ci, mcus_per_line, t.r0, t.r1,
                        restart_interval, initial_prediction);
                }
            });
        }
        for (auto& th : rpool) th.join();
        return 0;
    }
    std::vector<std::thread> pool;
    for (int ci = 0; ci < n_comps; ++ci) {
        pool.emplace_back([&, ci]() {
            ll_reconstruct_plane(predictor_sel, planes[ci], plane_widths[ci],
                                 diffs_p, n_comps, ci,
                                 mcus_per_line, mcus_per_column,
                                 restart_interval, initial_prediction);
        });
    }
    for (auto& th : pool) th.join();
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Arithmetic-coded (SOF9/SOF10) scan decode
// ---------------------------------------------------------------------------
//
// Mirrors jpeglibrary_tpu_torch/host/models/arithmetic.py (parity with
// JpegArithmeticScanDecoder.cs:117-324 and the sequential/progressive
// subclasses): Annex D/F Qe probability state machine with adaptive
// statistics bins, DC context conditioning (DcL/DcU), AC Kx
// conditioning, progressive first/refinement scans with EOBx backscan.
// Restart segments reset statistics + registers, so they decode in
// parallel across threads.

namespace {

// The packed Qe table (Table D.3 + the fixed-0.5 bin) is supplied by
// the Python wrapper from models/arithmetic.QE_TABLE so there is a
// single source of truth for the 114 entries.
static int32_t g_qe_table[114];


struct ArithState {
    int32_t c, a, ct;
    uint8_t fixed_bin;

    void reset() {
        c = 0;
        a = 0;
        ct = -16;
    }

    // DecodeBinaryDecision (JpegArithmeticScanDecoder.cs:117-186).
    inline int decode(BitReader& br, uint8_t* st) {
        while (a < 0x8000) {
            if (--ct < 0) {
                int32_t data = br.read(8);
                if (data < 0) data = 0;  // zero-pad past the end
                c = (int32_t)(((uint32_t)c << 8) | (uint32_t)data);
                if ((ct += 8) < 0) {
                    if (++ct == 0) {
                        a = 0x8000;
                    }
                }
            }
            a <<= 1;
        }

        int sv = *st;
        int32_t qe = g_qe_table[sv & 0x7f];
        uint8_t nl = (uint8_t)qe; qe >>= 8;
        uint8_t nm = (uint8_t)qe; qe >>= 8;

        int32_t temp = a - qe;
        a = temp;
        temp <<= ct;
        if (c >= temp) {
            c -= temp;
            if (a < qe) {
                a = qe;
                *st = (uint8_t)((sv & 0x80) ^ nm);
            } else {
                a = qe;
                *st = (uint8_t)((sv & 0x80) ^ nl);
                sv ^= 0x80;
            }
        } else if (a < 0x8000) {
            if (a < qe) {
                *st = (uint8_t)((sv & 0x80) ^ nl);
                sv ^= 0x80;
            } else {
                *st = (uint8_t)((sv & 0x80) ^ nm);
            }
        }
        return sv >> 7;
    }
};

struct ArithComp {
    int h, v;
    int dc_l, dc_u, ac_kx;       // conditioning (DAC)
    bool has_dc, has_ac;
    uint8_t* dc_stats;           // shared per table id (64 B)
    uint8_t* ac_stats;           // shared per table id (256 B)
    int32_t predictor;
    int32_t dc_context;
    int16_t* plane;
    int64_t wb;
};

// DC difference decode, Figures F.19-F.24
// (JpegArithmeticSequentialScanDecoder.cs:185-246). Returns 0/2.
static inline int arith_decode_dc(ArithState& s, BitReader& br, ArithComp& c) {
    uint8_t* st = c.dc_stats;
    int base = c.dc_context;
    if (s.decode(br, st + base) == 0) {
        c.dc_context = 0;
        return 0;
    }
    int sign = s.decode(br, st + base + 1);
    int pos = base + 2 + sign;
    int m = s.decode(br, st + pos);
    if (m != 0) {
        pos = 20;
        while (s.decode(br, st + pos) != 0) {
            m <<= 1;
            if (m == 0x8000) return 2;
            ++pos;
        }
    }
    if (m < ((1 << c.dc_l) >> 1)) {
        c.dc_context = 0;
    } else if (m > ((1 << c.dc_u) >> 1)) {
        c.dc_context = 12 + sign * 4;
    } else {
        c.dc_context = 4 + sign * 4;
    }
    int v = m;
    pos += 14;
    m >>= 1;
    while (m != 0) {
        if (s.decode(br, st + pos) != 0) v |= m;
        m >>= 1;
    }
    v += 1;
    if (sign != 0) v = -v;
    c.predictor = (int16_t)(c.predictor + v);
    return 0;
}

// Shared AC magnitude decode after the nonzero decision (F.21-F.24).
static inline int arith_decode_ac_value(ArithState& s, BitReader& br, ArithComp& c,
                                        uint8_t* st, int pos, int k, int* out) {
    int sign = s.decode(br, &s.fixed_bin);
    pos += 2;
    int m = s.decode(br, st + pos);
    if (m != 0) {
        if (s.decode(br, st + pos) != 0) {
            m <<= 1;
            pos = k <= c.ac_kx ? 189 : 217;
            while (s.decode(br, st + pos) != 0) {
                m <<= 1;
                if (m == 0x8000) return 2;
                ++pos;
            }
        }
    }
    int v = m;
    pos += 14;
    m >>= 1;
    while (m != 0) {
        if (s.decode(br, st + pos) != 0) v |= m;
        m >>= 1;
    }
    v += 1;
    if (sign != 0) v = -v;
    *out = v;
    return 0;
}

// Sequential block (JpegArithmeticSequentialScanDecoder.cs:181-307).
static inline int arith_read_block_sequential(ArithState& s, BitReader& br,
                                              ArithComp& c, int16_t* block) {
    std::memset(block, 0, 64 * sizeof(int16_t));
    int rc = arith_decode_dc(s, br, c);
    if (rc) return rc;
    block[0] = (int16_t)c.predictor;

    uint8_t* st = c.ac_stats;
    int k = 1;
    while (k <= 63) {
        int pos = 3 * (k - 1);
        if (s.decode(br, st + pos) != 0) break;  // EOB
        while (s.decode(br, st + pos + 1) == 0) {
            pos += 3;
            ++k;
            if (k > 63) return 2;
        }
        int v;
        rc = arith_decode_ac_value(s, br, c, st, pos, k, &v);
        if (rc) return rc;
        block[k] = (int16_t)v;
        ++k;
    }
    return 0;
}

// Progressive DC (JpegArithmeticProgressiveScanDecoder.cs:243-321).
static inline int arith_read_block_prog_dc(ArithState& s, BitReader& br,
                                           ArithComp& c, const ScanParams& sp,
                                           int16_t* block) {
    if (sp.ah == 0) {
        int rc = arith_decode_dc(s, br, c);
        if (rc) return rc;
        block[0] = (int16_t)(c.predictor << sp.al);
    } else {
        int bit = s.decode(br, &s.fixed_bin);
        block[0] = (int16_t)(block[0] | (bit << sp.al));
    }
    return 0;
}

// Progressive AC refined (:402-470).
static inline int arith_read_block_prog_ac_refined(ArithState& s, BitReader& br,
                                                   uint8_t* st_arr, const ScanParams& sp,
                                                   int16_t* block) {
    int start = sp.ss, end = sp.se;
    int p1 = 1 << sp.al;
    int m1 = -(1 << sp.al);  // == (-1) << al for al < 31, without UB

    int kex = end;
    for (; kex > 0; --kex) {
        if (block[kex] != 0) break;
    }

    for (int k = start; k <= end; ++k) {
        int pos = 3 * (k - 1);
        if (k > kex) {
            if (s.decode(br, st_arr + pos) != 0) break;
        }
        while (true) {
            int coef = block[k];
            if (coef != 0) {
                if (s.decode(br, st_arr + pos + 2) != 0) {
                    block[k] = (int16_t)(coef + (coef < 0 ? m1 : p1));
                }
                break;
            }
            if (s.decode(br, st_arr + pos + 1) != 0) {
                if (s.decode(br, &s.fixed_bin) != 0) {
                    block[k] = (int16_t)(coef + m1);
                } else {
                    block[k] = (int16_t)(coef + p1);
                }
                break;
            }
            pos += 3;
            ++k;
            if (k > end) return 2;
        }
    }
    return 0;
}

// Progressive AC first (:323-400).
static inline int arith_read_block_prog_ac(ArithState& s, BitReader& br,
                                           ArithComp& c, const ScanParams& sp,
                                           int16_t* block) {
    uint8_t* st = c.ac_stats;
    if (sp.ah != 0) {
        return arith_read_block_prog_ac_refined(s, br, st, sp, block);
    }
    int k = sp.ss;
    while (k <= sp.se) {
        int pos = 3 * (k - 1);
        if (s.decode(br, st + pos) != 0) break;
        while (s.decode(br, st + pos + 1) == 0) {
            pos += 3;
            ++k;
            if (k > 63) return 2;
        }
        int v;
        int rc = arith_decode_ac_value(s, br, c, st, pos, k, &v);
        if (rc) return rc;
        block[k] = (int16_t)(v << sp.al);
        ++k;
    }
    return 0;
}

struct ArithStatsPool {
    // one 64 B DC bin per dc table id, one 256 B AC bin per ac table id
    uint8_t dc[16][64];
    uint8_t ac[16][256];
    void clear() { std::memset(this, 0, sizeof(*this)); }
};

struct ArithSpanTask {
    const uint8_t* data;
    int64_t len;
    int64_t first_unit;
    int64_t n_units;
};

// One span of a sequential (SOF9) scan: fresh stats + registers.
static int arith_decode_span_sequential(const ArithSpanTask& task, ArithComp* comps,
                                        const int32_t* dc_ids, const int32_t* ac_ids,
                                        int n_comps, int64_t mcus_per_line) {
    ArithStatsPool pool;
    pool.clear();
    ArithState s;
    s.reset();
    s.fixed_bin = 113;
    std::vector<ArithComp> local(comps, comps + n_comps);
    for (int i = 0; i < n_comps; ++i) {
        local[i].predictor = 0;
        local[i].dc_context = 0;
        local[i].dc_stats = pool.dc[dc_ids[i] & 15];
        local[i].ac_stats = pool.ac[ac_ids[i] & 15];
    }
    BitReader br;
    br.init(task.data, task.len);
    int16_t block[64];

    for (int64_t m = 0; m < task.n_units; ++m) {
        int64_t mcu = task.first_unit + m;
        int64_t row = mcu / mcus_per_line;
        int64_t col = mcu % mcus_per_line;
        for (int ci = 0; ci < n_comps; ++ci) {
            ArithComp& c = local[ci];
            for (int y = 0; y < c.v; ++y) {
                int64_t by = row * c.v + y;
                for (int x = 0; x < c.h; ++x) {
                    int64_t bx = col * c.h + x;
                    int rc = arith_read_block_sequential(s, br, c, block);
                    if (rc) return rc;
                    std::memcpy(c.plane + (by * c.wb + bx) * 64, block,
                                64 * sizeof(int16_t));
                }
            }
        }
    }
    return 0;
}

// One span of a progressive (SOF10) scan.
static int arith_decode_span_progressive(const ArithSpanTask& task, ArithComp* comps,
                                         const int32_t* dc_ids, const int32_t* ac_ids,
                                         int n_comps, const ScanParams& sp,
                                         int64_t mcus_per_line, int64_t hbc) {
    ArithStatsPool pool;
    pool.clear();
    ArithState s;
    s.reset();
    s.fixed_bin = 113;
    std::vector<ArithComp> local(comps, comps + n_comps);
    for (int i = 0; i < n_comps; ++i) {
        local[i].predictor = 0;
        local[i].dc_context = 0;
        local[i].dc_stats = pool.dc[dc_ids[i] & 15];
        local[i].ac_stats = pool.ac[ac_ids[i] & 15];
    }
    BitReader br;
    br.init(task.data, task.len);

    if (n_comps > 1) {
        for (int64_t m = 0; m < task.n_units; ++m) {
            int64_t mcu = task.first_unit + m;
            int64_t row = mcu / mcus_per_line;
            int64_t col = mcu % mcus_per_line;
            for (int ci = 0; ci < n_comps; ++ci) {
                ArithComp& c = local[ci];
                for (int y = 0; y < c.v; ++y) {
                    int64_t by = row * c.v + y;
                    for (int x = 0; x < c.h; ++x) {
                        int64_t bx = col * c.h + x;
                        int rc = arith_read_block_prog_dc(
                            s, br, c, sp, c.plane + (by * c.wb + bx) * 64);
                        if (rc) return rc;
                    }
                }
            }
        }
        return 0;
    }

    ArithComp& c = local[0];
    const bool is_dc = sp.ss == 0;
    for (int64_t u = 0; u < task.n_units; ++u) {
        int64_t unit = task.first_unit + u;
        int64_t by = unit / hbc;
        int64_t bx = unit % hbc;
        int16_t* block = c.plane + (by * c.wb + bx) * 64;
        int rc = is_dc ? arith_read_block_prog_dc(s, br, c, sp, block)
                       : arith_read_block_prog_ac(s, br, c, sp, block);
        if (rc) return rc;
    }
    return 0;
}

}  // namespace

extern "C" {

// Decode one arithmetic-coded scan (sequential when `progressive` == 0).
// Statistics bins are shared per table id across components, reset at
// scan start and every restart — which makes restart segments
// independent and thread-parallel.
int jpx_decode_arithmetic_scan(
    const uint8_t* data,
    const int64_t* span_starts, const int64_t* span_ends, int32_t n_spans,
    int64_t restart_interval,
    int64_t total_units, int64_t mcus_per_line, int64_t hbc,
    int32_t n_comps,
    const int32_t* comp_h, const int32_t* comp_v,
    const int32_t* dc_ids, const int32_t* ac_ids,
    const int32_t* dc_l, const int32_t* dc_u, const int32_t* ac_kx,
    int16_t** planes, const int64_t* plane_wb,
    int32_t progressive,
    int32_t ss, int32_t se, int32_t ah, int32_t al,
    int32_t n_threads) {
    if (n_comps <= 0 || n_spans <= 0) return 3;
    ScanParams sp{ss, se, ah, al};

    std::vector<ArithComp> comps(n_comps);
    for (int i = 0; i < n_comps; ++i) {
        comps[i].h = comp_h[i];
        comps[i].v = comp_v[i];
        comps[i].dc_l = dc_l[i];
        comps[i].dc_u = dc_u[i];
        comps[i].ac_kx = ac_kx[i];
        comps[i].plane = planes[i];
        comps[i].wb = plane_wb[i];
    }

    std::vector<ArithSpanTask> tasks;
    if (restart_interval <= 0) {
        tasks.push_back({data + span_starts[0], span_ends[0] - span_starts[0], 0, total_units});
    } else {
        int64_t unit = 0;
        for (int32_t sidx = 0; sidx < n_spans && unit < total_units; ++sidx) {
            int64_t n = std::min<int64_t>(restart_interval, total_units - unit);
            tasks.push_back({data + span_starts[sidx], span_ends[sidx] - span_starts[sidx], unit, n});
            unit += n;
        }
    }

    int hw = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;
    n_threads = std::min<int32_t>(n_threads, (int32_t)tasks.size());

    auto run_task = [&](const ArithSpanTask& t) -> int {
        if (progressive) {
            return arith_decode_span_progressive(t, comps.data(), dc_ids, ac_ids,
                                                 n_comps, sp, mcus_per_line, hbc);
        }
        return arith_decode_span_sequential(t, comps.data(), dc_ids, ac_ids,
                                            n_comps, mcus_per_line);
    };

    if (n_threads <= 1) {
        for (const auto& t : tasks) {
            int rc = run_task(t);
            if (rc) return rc;
        }
        return 0;
    }

    std::vector<int> results(tasks.size(), 0);
    std::vector<std::thread> pool;
    for (int tid = 0; tid < n_threads; ++tid) {
        pool.emplace_back([&, tid]() {
            for (size_t k = tid; k < tasks.size(); k += n_threads) {
                results[k] = run_task(tasks[k]);
            }
        });
    }
    for (auto& th : pool) th.join();
    for (int rc : results)
        if (rc) return rc;
    return 0;
}

}  // extern "C"

extern "C" {
// Install the 114-entry packed Qe table (must be called once before
// jpx_decode_arithmetic_scan).
void jpx_set_qe_table(const int32_t* table) {
    std::memcpy(g_qe_table, table, 114 * sizeof(int32_t));
}
}  // extern "C"

// ---------------------------------------------------------------------------
// Arithmetic (SOF9) ENCODER — QM-coder per ITU-T T.81 Annex D, the
// exact inverse of the decoder above (ArithState::decode): same Qe
// state table, same MPS/LPS conditional-exchange rule (the qe-sized
// upper subinterval belongs to the MPS when A-Qe < Qe), byte output
// with carry propagation, 0xFF stacking and 0xFF 0x00 stuffing.
// A capability beyond the reference, whose encoder is Huffman-only;
// validated by bit-exact decode round trips through the
// reference-parity decoder.
// ---------------------------------------------------------------------------

namespace {

struct ArithEncoder {
    int32_t a, c, ct;
    int32_t pending;   // last unemitted byte (-1 before the first)
    int64_t sc;        // stacked 0xFF bytes awaiting carry resolution
    uint8_t* out;
    int64_t cap, n;
    bool overflow;

    void init(uint8_t* buf, int64_t capacity) {
        a = 0x10000;
        c = 0;
        ct = 11;
        pending = -1;
        sc = 0;
        out = buf;
        cap = capacity;
        n = 0;
        overflow = false;
    }

    inline void emit(uint8_t b) {
        if (n >= cap) { overflow = true; return; }
        out[n++] = b;
        if (b == 0xFF) {  // JpegBitReader-compatible byte stuffing
            if (n >= cap) { overflow = true; return; }
            out[n++] = 0x00;
        }
    }

    void byte_out() {
        int32_t temp = c >> 19;
        if (temp > 0xFF) {
            // carry: bump the pending byte, stacked 0xFFs become 0x00
            if (pending >= 0) emit((uint8_t)(pending + 1));
            while (sc > 0) { emit(0x00); --sc; }
            pending = temp & 0xFF;
        } else if (temp == 0xFF) {
            ++sc;  // defer: a later carry may turn it into 0x00
        } else {
            if (pending >= 0) emit((uint8_t)pending);
            while (sc > 0) { emit(0xFF); --sc; }
            pending = temp;
        }
        c &= 0x7FFFF;
    }

    inline void renorm() {
        do {
            a <<= 1;
            c <<= 1;
            if (--ct == 0) {
                byte_out();
                ct = 8;
            }
        } while (a < 0x8000);
    }

    // Encode one binary decision against statistics bin *st.
    inline void encode(int bit, uint8_t* st) {
        int sv = *st;
        int32_t qe = g_qe_table[sv & 0x7f];
        uint8_t nl = (uint8_t)qe; qe >>= 8;
        uint8_t nm = (uint8_t)qe; qe >>= 8;

        int32_t an = a - qe;
        if (bit == (sv >> 7)) {
            // MPS
            if (an & 0x8000) {
                a = an;  // still normalized: no renorm, no state change
                return;
            }
            if (an < qe) {
                c += an;  // conditional exchange: MPS takes the qe region
                a = qe;
            } else {
                a = an;
            }
            *st = (uint8_t)((sv & 0x80) ^ nm);
        } else {
            // LPS
            if (an < qe) {
                a = an;  // exchange: LPS takes the (smaller) lower region
            } else {
                c += an;
                a = qe;
            }
            *st = (uint8_t)((sv & 0x80) ^ nl);
        }
        renorm();
    }

    // Finish the segment (T.81 D.1.8 FLUSH): clear final bits, align,
    // push out the remaining register bytes.
    void flush() {
        int32_t temp = (c + a - 1) & ~0xFFFF;
        if (temp < c) temp += 0x8000;
        c = temp;
        c <<= ct;
        byte_out();
        c <<= 8;
        byte_out();
        if (pending >= 0 && pending != 0) emit((uint8_t)pending);
        else if (pending == 0) emit(0x00);
        while (sc > 0) { emit(0xFF); --sc; }
    }
};

static inline int floor_log2_i32(int32_t v) {
    int k = 0;
    while ((v >> (k + 1)) != 0) ++k;
    return k;
}

// DC difference encode — inverse of arith_decode_dc (F.1.4.1).
static void arith_encode_dc(ArithEncoder& e, ArithComp& c, int32_t v) {
    uint8_t* st = c.dc_stats;
    int base = c.dc_context;
    if (v == 0) {
        e.encode(0, st + base);
        c.dc_context = 0;
        return;
    }
    e.encode(1, st + base);
    int sign = v < 0 ? 1 : 0;
    e.encode(sign, st + base + 1);
    int32_t mval = (v < 0 ? -v : v) - 1;
    int pos = base + 2 + sign;
    int32_t mcat;
    if (mval == 0) {
        e.encode(0, st + pos);
        mcat = 0;
    } else {
        e.encode(1, st + pos);
        int k = floor_log2_i32(mval);
        pos = 20;
        for (int i = 0; i < k; ++i) e.encode(1, st + pos + i);
        e.encode(0, st + pos + k);
        pos += k;
        mcat = 1 << k;
    }
    // bits below the category MSB
    pos += 14;
    for (int32_t m = mcat >> 1; m != 0; m >>= 1) {
        e.encode((mval & m) ? 1 : 0, st + pos);
    }
    // context classification for the next DC (same rule as the decoder)
    if (mcat < ((1 << c.dc_l) >> 1)) {
        c.dc_context = 0;
    } else if (mcat > ((1 << c.dc_u) >> 1)) {
        c.dc_context = 12 + sign * 4;
    } else {
        c.dc_context = 4 + sign * 4;
    }
}

// AC magnitude encode after the nonzero decision — inverse of
// arith_decode_ac_value.
static void arith_encode_ac_value(ArithEncoder& e, ArithComp& c, uint8_t* st,
                                  uint8_t* fixed_bin, int pos, int k, int32_t v) {
    int sign = v < 0 ? 1 : 0;
    e.encode(sign, fixed_bin);
    int32_t mval = (v < 0 ? -v : v) - 1;
    pos += 2;
    int32_t mcat;
    if (mval == 0) {
        e.encode(0, st + pos);
        mcat = 0;
    } else {
        e.encode(1, st + pos);
        if (mval == 1) {
            e.encode(0, st + pos);  // same bin: category stays 1
            mcat = 1;
        } else {
            e.encode(1, st + pos);
            int kk = floor_log2_i32(mval);  // >= 1
            pos = k <= c.ac_kx ? 189 : 217;
            for (int i = 0; i < kk - 1; ++i) e.encode(1, st + pos + i);
            e.encode(0, st + pos + (kk - 1));
            pos += kk - 1;
            mcat = 1 << kk;
        }
    }
    pos += 14;
    for (int32_t m = mcat >> 1; m != 0; m >>= 1) {
        e.encode((mval & m) ? 1 : 0, st + pos);
    }
}

// Progressive AC first scan, one block — inverse of
// arith_read_block_prog_ac (ah == 0 branch).
static void arith_encode_block_prog_ac_first(ArithEncoder& e, ArithComp& c,
                                             uint8_t* fixed_bin,
                                             const int16_t* blk,
                                             int ss, int se, int al) {
    uint8_t* st = c.ac_stats;
    int kmax = se;
    while (kmax >= ss) {
        int32_t v = blk[kmax];
        if (((v < 0 ? -v : v) >> al) != 0) break;
        --kmax;
    }
    int k = ss;
    while (k <= se) {
        int pos = 3 * (k - 1);
        if (k > kmax) {
            e.encode(1, st + pos);  // EOB
            return;
        }
        e.encode(0, st + pos);
        int32_t v = blk[k];
        int32_t mag = (v < 0 ? -v : v) >> al;
        while (mag == 0) {
            e.encode(0, st + pos + 1);
            pos += 3;
            ++k;
            v = blk[k];
            mag = (v < 0 ? -v : v) >> al;
        }
        e.encode(1, st + pos + 1);
        arith_encode_ac_value(e, c, st, fixed_bin, pos, k, v < 0 ? -mag : mag);
        ++k;
    }
}

// Progressive AC refinement, one block — inverse of
// arith_read_block_prog_ac_refined.
static void arith_encode_block_prog_ac_refine(ArithEncoder& e, ArithComp& c,
                                              uint8_t* fixed_bin,
                                              const int16_t* blk,
                                              int ss, int se, int al) {
    uint8_t* st = c.ac_stats;
    int ah = al + 1;
    // kex: last previously-significant position (stored value nonzero)
    int kex = se;
    while (kex > 0) {
        int32_t v = blk[kex];
        if (((v < 0 ? -v : v) >> ah) != 0) break;
        --kex;
    }
    // suffix flags: does any newly-significant coefficient exist at or
    // after position k?
    bool more_new[65];
    more_new[se + 1] = false;
    for (int k = se; k >= ss; --k) {
        int32_t v = blk[k];
        int32_t t = (v < 0 ? -v : v) >> al;
        more_new[k] = more_new[k + 1] || (t == 1);
    }

    for (int k = ss; k <= se; ++k) {
        int pos = 3 * (k - 1);
        if (k > kex) {
            if (!more_new[k]) {
                e.encode(1, st + pos);  // EOB: nothing new remains
                return;
            }
            e.encode(0, st + pos);
        }
        while (true) {
            int32_t v = blk[k];
            int32_t t = (v < 0 ? -v : v) >> al;
            if ((t >> 1) != 0) {
                // previously significant: correction bit
                e.encode(t & 1, st + pos + 2);
                break;
            }
            if (t == 1) {
                // newly significant: decision + sign (1 = negative,
                // matching the decoder's fixed-bin branch)
                e.encode(1, st + pos + 1);
                e.encode(v < 0 ? 1 : 0, fixed_bin);
                break;
            }
            e.encode(0, st + pos + 1);
            pos += 3;
            ++k;
        }
    }
}

// One block, sequential mode — inverse of arith_read_block_sequential.
static void arith_encode_block_sequential(ArithEncoder& e, ArithComp& c,
                                          uint8_t* fixed_bin,
                                          const int16_t* block) {
    int32_t dc = block[0];
    int32_t diff = dc - c.predictor;
    arith_encode_dc(e, c, diff);
    c.predictor = (int16_t)dc;

    uint8_t* st = c.ac_stats;
    int kmax = 63;
    while (kmax >= 1 && block[kmax] == 0) --kmax;
    int k = 1;
    while (k <= 63) {
        int pos = 3 * (k - 1);
        if (k > kmax) {
            e.encode(1, st + pos);  // EOB
            return;
        }
        e.encode(0, st + pos);
        while (block[k] == 0) {
            e.encode(0, st + pos + 1);
            pos += 3;
            ++k;
        }
        e.encode(1, st + pos + 1);
        arith_encode_ac_value(e, c, st, fixed_bin, pos, k, block[k]);
        ++k;
    }
}

}  // namespace

extern "C" {

// Progressive DC scan (SOF10, interleaved): first pass encodes
// (dc >> al) differences through the DC context machinery; refinement
// passes emit bit al through the fixed bin. Fresh statistics per scan.
int64_t jpx_encode_arith_prog_dc(
    int32_t n_comps,
    const int16_t** blocks, const int32_t* per_mcu,
    const int32_t* dc_ids, const int32_t* dc_l, const int32_t* dc_u,
    int64_t n_mcus, int32_t ah, int32_t al,
    uint8_t* out, int64_t capacity,
    int64_t ri) {              // restart interval in MCUs (0 = none)
    ArithStatsPool pool;
    uint8_t fixed_bin = 113;
    std::vector<ArithComp> comps(n_comps);
    std::vector<int64_t> cursors(n_comps, 0);
    for (int i = 0; i < n_comps; ++i) {
        comps[i].dc_l = dc_l[i];
        comps[i].dc_u = dc_u[i];
        comps[i].dc_stats = pool.dc[dc_ids[i] & 15];
        comps[i].ac_stats = nullptr;
    }
    const int64_t seg_len = ri > 0 ? ri : n_mcus;
    int64_t total = 0;
    int64_t m = 0;
    int seg = 0;
    while (m < n_mcus) {
        const int64_t m1 = std::min(n_mcus, m + seg_len);
        pool.clear();  // fresh statistics + predictors per segment
        fixed_bin = 113;
        for (int i = 0; i < n_comps; ++i) {
            comps[i].predictor = 0;
            comps[i].dc_context = 0;
        }
        ArithEncoder e;
        e.init(out + total, capacity - total);
        for (; m < m1; ++m) {
            for (int ci = 0; ci < n_comps; ++ci) {
                for (int b = 0; b < per_mcu[ci]; ++b) {
                    int32_t dc = blocks[ci][cursors[ci] * 64];
                    ++cursors[ci];
                    if (ah == 0) {
                        int32_t v = dc >> al;  // arithmetic shift
                        int32_t diff = v - comps[ci].predictor;
                        arith_encode_dc(e, comps[ci], diff);
                        comps[ci].predictor = (int16_t)v;
                    } else {
                        e.encode((dc >> al) & 1, &fixed_bin);
                    }
                    if (e.overflow) return -1;
                }
            }
        }
        e.flush();
        if (e.overflow) return -1;
        total += e.n;
        if (m < n_mcus) {
            if (total + 2 > capacity) return -1;
            out[total++] = 0xFF;
            out[total++] = (uint8_t)(0xD0 + (seg & 7));
            ++seg;
        }
    }
    return total;
}

// Progressive AC scan (SOF10, single component).
int64_t jpx_encode_arith_prog_ac(
    const int16_t* blocks, int64_t n_blocks,
    int32_t ac_id, int32_t ac_kx,
    int32_t ss, int32_t se, int32_t ah, int32_t al,
    uint8_t* out, int64_t capacity,
    int64_t ri) {              // restart interval in blocks (0 = none)
    ArithStatsPool pool;
    uint8_t fixed_bin = 113;
    ArithComp c;
    c.ac_kx = ac_kx;
    c.ac_stats = pool.ac[ac_id & 15];
    c.dc_stats = nullptr;
    const int64_t seg_len = ri > 0 ? ri : n_blocks;
    int64_t total = 0;
    int64_t b = 0;
    int seg = 0;
    while (b < n_blocks) {
        const int64_t b1 = std::min(n_blocks, b + seg_len);
        pool.clear();  // fresh statistics per segment
        fixed_bin = 113;
        ArithEncoder e;
        e.init(out + total, capacity - total);
        for (; b < b1; ++b) {
            const int16_t* blk = blocks + b * 64;
            if (ah == 0) {
                arith_encode_block_prog_ac_first(e, c, &fixed_bin, blk, ss, se, al);
            } else {
                arith_encode_block_prog_ac_refine(e, c, &fixed_bin, blk, ss, se, al);
            }
            if (e.overflow) return -1;
        }
        e.flush();
        if (e.overflow) return -1;
        total += e.n;
        if (b < n_blocks) {
            if (total + 2 > capacity) return -1;
            out[total++] = 0xFF;
            out[total++] = (uint8_t)(0xD0 + (seg & 7));
            ++seg;
        }
    }
    return total;
}

// Encode one arithmetic-coded (SOF9) entropy segment over `n_mcus`
// interleaved MCUs. Statistics bins are fresh (per-scan /
// per-restart-segment contract); `blocks[i]` points at component i's
// first block of this segment in MCU order. Returns bytes written or
// -1 on capacity overflow.
int64_t jpx_encode_arith_sequential(
    int32_t n_comps,
    const int16_t** blocks, const int32_t* per_mcu,
    const int32_t* dc_ids, const int32_t* ac_ids,
    const int32_t* dc_l, const int32_t* dc_u, const int32_t* ac_kx,
    int64_t n_mcus,
    uint8_t* out, int64_t capacity) {
    ArithStatsPool pool;
    pool.clear();
    uint8_t fixed_bin = 113;
    std::vector<ArithComp> comps(n_comps);
    std::vector<int64_t> cursors(n_comps, 0);
    for (int i = 0; i < n_comps; ++i) {
        comps[i].dc_l = dc_l[i];
        comps[i].dc_u = dc_u[i];
        comps[i].ac_kx = ac_kx[i];
        comps[i].predictor = 0;
        comps[i].dc_context = 0;
        comps[i].dc_stats = pool.dc[dc_ids[i] & 15];
        comps[i].ac_stats = pool.ac[ac_ids[i] & 15];
    }
    ArithEncoder e;
    e.init(out, capacity);
    for (int64_t m = 0; m < n_mcus; ++m) {
        for (int ci = 0; ci < n_comps; ++ci) {
            for (int b = 0; b < per_mcu[ci]; ++b) {
                const int16_t* blk = blocks[ci] + cursors[ci] * 64;
                ++cursors[ci];
                arith_encode_block_sequential(e, comps[ci], &fixed_bin, blk);
                if (e.overflow) return -1;
            }
        }
    }
    e.flush();
    if (e.overflow) return -1;
    return e.n;
}

// Restart-segmented SOF9 scan in ONE call: every segment restarts the
// QM registers and statistics (the per-restart-segment contract), so
// segments are independent byte-aligned streams — encode contiguous
// segment ranges on separate threads and concatenate with RSTn
// separators. Byte-identical to per-segment jpx_encode_arith_sequential
// calls joined with RSTn (which paid Python call overhead per segment).
int64_t jpx_encode_arith_restart_parallel(
    int32_t n_comps,
    const int16_t** blocks, const int32_t* per_mcu,
    const int32_t* dc_ids, const int32_t* ac_ids,
    const int32_t* dc_l, const int32_t* dc_u, const int32_t* ac_kx,
    int64_t n_mcus, int64_t restart_interval,
    uint8_t* out, int64_t capacity, int32_t n_threads) {
    const int64_t ri = restart_interval;
    if (ri <= 0)
        return jpx_encode_arith_sequential(n_comps, blocks, per_mcu, dc_ids,
                                           ac_ids, dc_l, dc_u, ac_kx, n_mcus,
                                           out, capacity);
    const int64_t n_seg = (n_mcus + ri - 1) / ri;
    int hw = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;
    int64_t T = std::min<int64_t>(n_threads, n_seg);
    if (n_mcus < 512) T = 1;

    int64_t blocks_per_mcu = 0;
    for (int i = 0; i < n_comps; ++i) blocks_per_mcu += per_mcu[i];

    struct Chunk {
        int64_t g0, g1;
        std::unique_ptr<uint8_t[]> buf;
        int64_t cap, n, status;
    };
    std::vector<Chunk> chunks((size_t)T);
    int64_t per = (n_seg + T - 1) / T;
    for (int64_t t = 0; t < T; ++t) {
        chunks[t].g0 = std::min(n_seg, t * per);
        chunks[t].g1 = std::min(n_seg, (t + 1) * per);
        int64_t mcus = std::min(n_mcus, chunks[t].g1 * ri) - chunks[t].g0 * ri;
        if (mcus < 0) mcus = 0;
        // QM output is bounded well under the Huffman worst case; keep
        // the same generous 512 B/block bound plus marker room.
        chunks[t].cap = mcus * blocks_per_mcu * 512 +
                        (chunks[t].g1 - chunks[t].g0) * 2 + 1024;
        chunks[t].buf.reset(new uint8_t[(size_t)chunks[t].cap]);
        chunks[t].n = 0;
        chunks[t].status = 0;
    }
    auto work = [&](int64_t t) {
        Chunk& ck = chunks[t];
        int64_t pos = 0;
        std::vector<const int16_t*> seg_blocks((size_t)n_comps);
        for (int64_t g = ck.g0; g < ck.g1; ++g) {
            int64_t m0 = g * ri;
            int64_t count = std::min(n_mcus - m0, ri);
            for (int i = 0; i < n_comps; ++i)
                seg_blocks[(size_t)i] = blocks[i] + m0 * per_mcu[i] * 64;
            int64_t n = jpx_encode_arith_sequential(
                n_comps, seg_blocks.data(), per_mcu, dc_ids, ac_ids, dc_l,
                dc_u, ac_kx, count, ck.buf.get() + pos, ck.cap - pos);
            if (n < 0) { ck.status = n; return; }
            pos += n;
            if (g < n_seg - 1) {
                if (pos + 2 > ck.cap) { ck.status = -1; return; }
                ck.buf[pos++] = 0xFF;
                ck.buf[pos++] = (uint8_t)(0xD0 + (g & 7));
            }
        }
        ck.n = pos;
    };
    if (T <= 1) {
        work(0);
    } else {
        std::vector<std::thread> pool;
        for (int64_t t = 0; t < T; ++t) pool.emplace_back(work, t);
        for (auto& th : pool) th.join();
    }
    int64_t total = 0;
    for (auto& ck : chunks) {
        if (ck.status < 0) return ck.status;
        total += ck.n;
    }
    if (total > capacity) return -1;
    int64_t off = 0;
    for (auto& ck : chunks) {
        std::memcpy(out + off, ck.buf.get(), (size_t)ck.n);
        off += ck.n;
    }
    return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Entropy segment emission (encoder / optimizer hot path)
// ---------------------------------------------------------------------------
//
// Mirrors models/encoder.py::_encode_block/_encode_run_length (parity
// with JpegEncoder.EncodeBlock/EncodeRunLength, JpegEncoder.cs:828-936)
// and io/writer.py::JpegWriter bit mode (0xFF -> 0xFF 0x00 stuffing,
// 1-padding on exit). Emits ONE byte-aligned entropy segment: DC
// predictors start at 0, exactly the reference's per-scan /
// per-restart-segment contract, so the optimizer emits restart streams
// by calling this once per segment.

namespace {

struct BitPacker {
    uint8_t* out;
    int64_t cap;
    int64_t n;
    uint64_t reg;
    int bits;

    bool put_byte(uint8_t b) {
        if (n >= cap) return false;
        out[n++] = b;
        if (b == 0xFF) {
            if (n >= cap) return false;
            out[n++] = 0x00;
        }
        return true;
    }

    // 32-bit buffered flush: identical byte/stuffing stream to the
    // byte-at-a-time form, but the common no-0xFF window goes out as
    // one bswap'd 4-byte store (SWAR test for a 0xFF lane). Writes are
    // <= 31 bits (a fused code+value pair), so with `bits` < 32 on
    // entry one flush suffices and `bits` stays < 32 between calls.
    inline bool write(uint32_t value, int length) {
        if (length == 0) return true;
        reg = (reg << length) | (value & ((1u << length) - 1));
        bits += length;
        if (bits >= 32) {
            bits -= 32;
            uint32_t word = (uint32_t)(reg >> bits);
            reg &= ((uint64_t)1 << bits) - 1;
            uint32_t inv = ~word;
            if (((inv - 0x01010101u) & ~inv & 0x80808080u) == 0) {
                if (n + 4 > cap) return false;
                uint32_t be = __builtin_bswap32(word);
                std::memcpy(out + n, &be, 4);
                n += 4;
            } else {
                for (int s = 24; s >= 0; s -= 8)
                    if (!put_byte((uint8_t)(word >> s))) return false;
            }
        }
        return true;
    }

    bool finish() {
        if (bits & 7) {
            int pad = 8 - (bits & 7);
            if (!write((1u << pad) - 1, pad)) return false;
        }
        while (bits >= 8) {  // drain whole bytes left in the window
            bits -= 8;
            if (!put_byte((uint8_t)(reg >> bits))) return false;
        }
        reg = 0;
        return true;
    }
};

struct EncComp {
    const int16_t* blocks;   // MCU-ordered [n, 64]
    int per_mcu;
    const uint16_t* dc_codes;
    const uint8_t* dc_sizes;
    const uint16_t* ac_codes;
    const uint8_t* ac_sizes;
    int32_t predictor;
    int64_t cursor;
};

static inline bool emit_run_length(BitPacker& bp, const uint16_t* codes,
                                   const uint8_t* sizes, int run, int value,
                                   bool* missing) {
    int a = value, b = value;
    if (a < 0) {
        a = -value;
        b = value - 1;
    }
    int bit_count = a ? 32 - __builtin_clz((unsigned)a) : 0;
    int symbol = (run << 4) | bit_count;
    int size = sizes[symbol];
    if (size == 0) { *missing = true; return false; }
    // code then value bits, fused into one write (<= 16+15 bits) —
    // identical bit stream, one flush check instead of two
    uint32_t v = ((uint32_t)codes[symbol] << bit_count) |
                 ((uint32_t)b & ((1u << bit_count) - 1));
    return bp.write(v, size + bit_count);
}

static inline bool emit_block(BitPacker& bp, EncComp& c, const int16_t* block,
                              bool* missing) {
    int value = block[0];
    int t = value - c.predictor;
    c.predictor = value;
    if (!emit_run_length(bp, c.dc_codes, c.dc_sizes, 0, t, missing)) return false;

    int run = 0;
    for (int i = 1; i < 64; ++i) {
        int v = block[i];
        if (v == 0) {
            ++run;
        } else {
            while (run > 15) {
                if (c.ac_sizes[0xF0] == 0) { *missing = true; return false; }
                if (!bp.write(c.ac_codes[0xF0], c.ac_sizes[0xF0])) return false;
                run -= 16;
            }
            if (!emit_run_length(bp, c.ac_codes, c.ac_sizes, run, v, missing)) return false;
            run = 0;
        }
    }
    if (run > 0) {
        if (c.ac_sizes[0] == 0) { *missing = true; return false; }
        if (!bp.write(c.ac_codes[0], c.ac_sizes[0])) return false;
    }
    return true;
}

}  // namespace

extern "C" {

// Emit one entropy segment covering `n_mcus` MCUs. `blocks[i]` points
// at component i's first block OF THIS SEGMENT (MCU order). Returns
// bytes written, -1 on capacity overflow, -2 on missing Huffman code.
int64_t jpx_encode_segment(
    int32_t n_comps,
    const int16_t** blocks, const int32_t* per_mcu,
    const uint16_t** dc_codes, const uint8_t** dc_sizes,
    const uint16_t** ac_codes, const uint8_t** ac_sizes,
    int64_t n_mcus,
    uint8_t* out, int64_t capacity) {
    std::vector<EncComp> comps(n_comps);
    for (int i = 0; i < n_comps; ++i) {
        comps[i] = EncComp{blocks[i], per_mcu[i], dc_codes[i], dc_sizes[i],
                           ac_codes[i], ac_sizes[i], 0, 0};
    }
    BitPacker bp{out, capacity, 0, 0, 0};
    bool missing = false;
    for (int64_t m = 0; m < n_mcus; ++m) {
        for (int ci = 0; ci < n_comps; ++ci) {
            EncComp& c = comps[ci];
            for (int b = 0; b < c.per_mcu; ++b) {
                const int16_t* block = c.blocks + c.cursor * 64;
                ++c.cursor;
                if (!emit_block(bp, c, block, &missing)) {
                    return missing ? -2 : -1;
                }
            }
        }
    }
    if (!bp.finish()) return -1;
    return bp.n;
}

// Carry-state variant of jpx_encode_segment for STREAMING encode: the
// scan is emitted stripe by stripe without ever materializing all the
// blocks (the pull-based JpegBlockInputReader contract,
// yigolden/JpegLibrary/src/JpegLibrary/JpegBlockInputReader.cs:27 +
// JpegEncoder.WriteScanData, JpegEncoder.cs:662-741). DC predictors
// and the partial-byte bit register are carried in/out across calls;
// with `finalize` the tail is 1-padded and flushed like a segment end.
// Chained calls are bit-identical to one jpx_encode_segment over the
// concatenated blocks (Huffman emission is deterministic per (block,
// predictor) and stuffing applies per completed byte).
// Returns bytes written, -1 on capacity overflow, -2 on missing code.
int64_t jpx_encode_segment_carry(
    int32_t n_comps,
    const int16_t** blocks, const int32_t* per_mcu,
    const uint16_t** dc_codes, const uint8_t** dc_sizes,
    const uint16_t** ac_codes, const uint8_t** ac_sizes,
    int64_t n_mcus,
    uint8_t* out, int64_t capacity,
    int32_t* predictors, uint64_t* carry_reg, int32_t* carry_bits,
    int32_t finalize) {
    std::vector<EncComp> comps(n_comps);
    for (int i = 0; i < n_comps; ++i) {
        comps[i] = EncComp{blocks[i], per_mcu[i], dc_codes[i], dc_sizes[i],
                           ac_codes[i], ac_sizes[i], predictors[i], 0};
    }
    BitPacker bp{out, capacity, 0, *carry_reg, *carry_bits};
    bool missing = false;
    for (int64_t m = 0; m < n_mcus; ++m) {
        for (int ci = 0; ci < n_comps; ++ci) {
            EncComp& c = comps[ci];
            for (int b = 0; b < c.per_mcu; ++b) {
                const int16_t* block = c.blocks + c.cursor * 64;
                ++c.cursor;
                if (!emit_block(bp, c, block, &missing)) {
                    return missing ? -2 : -1;
                }
            }
        }
    }
    if (finalize) {
        if (!bp.finish()) return -1;
        *carry_reg = 0;
        *carry_bits = 0;
    } else {
        *carry_reg = bp.reg;
        *carry_bits = bp.bits;
    }
    for (int i = 0; i < n_comps; ++i) predictors[i] = comps[i].predictor;
    return bp.n;
}

// Emit one entropy segment as an UNSTUFFED bitstream (no 0xFF 0x00
// insertion, no final padding) — the per-chunk phase of the parallel
// scan emitter below. Returns total bits written, -1 overflow, -2
// missing code.
static int64_t emit_chunk_unstuffed(EncComp* comps, int n_comps,
                                    int64_t n_mcus,
                                    uint8_t* out, int64_t cap_bytes) {
    struct RawPacker {
        uint8_t* out;
        int64_t cap;
        int64_t n;
        uint64_t reg;
        int bits;
        // 32-bit bulk flush: same byte stream as the byte-at-a-time
        // form (no stuffing here), one bswap'd store per 4 output
        // bytes instead of four shifts+stores. Writes are <= 31 bits
        // (fused code+value), so one flush keeps bits < 32.
        inline bool write(uint32_t value, int length) {
            if (length == 0) return true;
            reg = (reg << length) | (value & ((1u << length) - 1));
            bits += length;
            if (bits >= 32) {
                bits -= 32;
                if (n + 4 > cap) return false;
                uint32_t be = __builtin_bswap32((uint32_t)(reg >> bits));
                std::memcpy(out + n, &be, 4);
                n += 4;
                reg &= ((uint64_t)1 << bits) - 1;
            }
            return true;
        }
    };
    RawPacker bp{out, cap_bytes, 0, 0, 0};
    bool missing = false;

    // The BitPacker/RawPacker interfaces match; reuse emit_block by
    // templating through a local lambda-based shim is more churn than
    // value — duplicate the tiny symbol loop against RawPacker.
    auto emit_rl = [&](const uint16_t* codes, const uint8_t* sizes, int run,
                       int value) -> bool {
        int a = value, b = value;
        if (a < 0) { a = -value; b = value - 1; }
        int bit_count = a ? 32 - __builtin_clz((unsigned)a) : 0;
        int symbol = (run << 4) | bit_count;
        int size = sizes[symbol];
        if (size == 0) { missing = true; return false; }
        uint32_t v = ((uint32_t)codes[symbol] << bit_count) |
                     ((uint32_t)b & ((1u << bit_count) - 1));
        return bp.write(v, size + bit_count);
    };

    for (int64_t m = 0; m < n_mcus; ++m) {
        for (int ci = 0; ci < n_comps; ++ci) {
            EncComp& c = comps[ci];
            for (int b = 0; b < c.per_mcu; ++b) {
                const int16_t* block = c.blocks + c.cursor * 64;
                ++c.cursor;
                int value = block[0];
                int t = value - c.predictor;
                c.predictor = value;
                if (!emit_rl(c.dc_codes, c.dc_sizes, 0, t)) return missing ? -2 : -1;
                int run = 0;
                for (int i = 1; i < 64; ++i) {
                    int v = block[i];
                    if (v == 0) { ++run; continue; }
                    while (run > 15) {
                        if (c.ac_sizes[0xF0] == 0) return -2;
                        if (!bp.write(c.ac_codes[0xF0], c.ac_sizes[0xF0])) return -1;
                        run -= 16;
                    }
                    if (!emit_rl(c.ac_codes, c.ac_sizes, run, v)) return missing ? -2 : -1;
                    run = 0;
                }
                if (run > 0) {
                    if (c.ac_sizes[0] == 0) return -2;
                    if (!bp.write(c.ac_codes[0], c.ac_sizes[0])) return -1;
                }
            }
        }
    }
    int64_t total_bits = bp.n * 8 + bp.bits;
    while (bp.bits >= 8) {  // residue of the 32-bit flush window
        bp.bits -= 8;
        if (bp.n >= bp.cap) return -1;
        bp.out[bp.n++] = (uint8_t)(bp.reg >> bp.bits);
    }
    if (bp.bits > 0) {
        if (bp.n >= bp.cap) return -1;
        bp.out[bp.n++] = (uint8_t)(bp.reg << (8 - bp.bits));  // left-justified tail
    }
    return total_bits;
}

// Merge unstuffed bit chunks: shift-OR them together, 1-pad the final
// partial byte (ExitBitMode semantics), then apply 0xFF 0x00 stuffing
// into the caller's buffer. Returns bytes written or -1 on overflow.
static int64_t merge_stuff_chunks(const uint8_t* const* bufs,
                                  const int64_t* nbits, int n,
                                  uint8_t* out, int64_t capacity) {
    int64_t total_bits = 0;
    for (int i = 0; i < n; ++i) total_bits += nbits[i];
    std::vector<uint8_t> merged((size_t)((total_bits + 7) / 8) + 8, 0);
    int64_t off_bits = 0;
    for (int i = 0; i < n; ++i) {
        if (nbits[i] == 0) continue;
        int64_t byte_off = off_bits >> 3;
        int shift = (int)(off_bits & 7);
        int64_t nbytes = (nbits[i] + 7) / 8;
        if (shift == 0) {
            std::memcpy(merged.data() + byte_off, bufs[i], (size_t)nbytes);
        } else {
            uint8_t* dst = merged.data() + byte_off;
            const uint8_t* src = bufs[i];
            // dst[0] already holds `shift` valid high bits
            uint32_t carry = dst[0] >> (8 - shift);
            for (int64_t j = 0; j < nbytes; ++j) {
                uint32_t v = (carry << (8 - shift)) | (src[j] >> shift);
                dst[j] = (uint8_t)v;
                carry = src[j] & ((1u << shift) - 1);
            }
            dst[nbytes] = (uint8_t)(carry << (8 - shift));
        }
        off_bits += nbits[i];
    }
    // 1-pad the final partial byte (ExitBitMode semantics).
    if (off_bits & 7) {
        int pad = 8 - (int)(off_bits & 7);
        merged[off_bits >> 3] |= (uint8_t)((1u << pad) - 1);
        off_bits += pad;
    }
    // Stuffing pass into the caller's buffer.
    int64_t n_out = 0;
    int64_t n_merged = off_bits >> 3;
    for (int64_t i = 0; i < n_merged; ++i) {
        if (n_out >= capacity) return -1;
        uint8_t b = merged[(size_t)i];
        out[n_out++] = b;
        if (b == 0xFF) {
            if (n_out >= capacity) return -1;
            out[n_out++] = 0x00;
        }
    }
    return n_out;
}

}  // namespace

extern "C" {

// Parallel single-segment scan emission: MCU chunks pack unstuffed
// bitstreams concurrently (each chunk seeds its DC predictors from the
// PREVIOUS block's DC value, which is available directly in the block
// arrays — the predictor chain needs no sequential walk), then a
// sequential pass bit-shifts the chunks together, 1-pads the tail and
// applies 0xFF 0x00 stuffing. Bit-identical to jpx_encode_segment.
// Returns bytes written, -1 overflow, -2 missing Huffman code.
int64_t jpx_encode_segment_parallel(
    int32_t n_comps,
    const int16_t** blocks, const int32_t* per_mcu,
    const uint16_t** dc_codes, const uint8_t** dc_sizes,
    const uint16_t** ac_codes, const uint8_t** ac_sizes,
    int64_t n_mcus,
    uint8_t* out, int64_t capacity,
    int32_t n_threads) {
    int hw = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = hw > 1 ? hw - 1 : 1;
    int64_t T = std::min<int64_t>(n_threads, std::max<int64_t>(1, n_mcus / 256));
    if (T <= 1) {
        return jpx_encode_segment(n_comps, blocks, per_mcu, dc_codes, dc_sizes,
                                  ac_codes, ac_sizes, n_mcus, out, capacity);
    }

    struct Chunk {
        int64_t first_mcu, n_mcus;
        std::unique_ptr<uint8_t[]> buf;  // uninitialized: packer overwrites
        int64_t cap;
        int64_t bits;
    };
    std::vector<Chunk> chunks(T);
    int64_t per = (n_mcus + T - 1) / T;
    int64_t blocks_per_mcu = 0;
    for (int i = 0; i < n_comps; ++i) blocks_per_mcu += per_mcu[i];
    for (int64_t t = 0; t < T; ++t) {
        chunks[t].first_mcu = t * per;
        chunks[t].n_mcus = std::min(per, n_mcus - t * per);
        if (chunks[t].n_mcus < 0) chunks[t].n_mcus = 0;
        // hard bound: a block is at most 64 codes (<=16 bits) + 63
        // value fields (<=15... DC <=16) => < 256 unstuffed bytes
        chunks[t].cap = chunks[t].n_mcus * blocks_per_mcu * 256 + 64;
        chunks[t].buf.reset(new uint8_t[(size_t)chunks[t].cap]);
        chunks[t].bits = 0;
    }

    std::vector<int64_t> results(T, 0);
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < T; ++t) {
        pool.emplace_back([&, t]() {
            Chunk& ck = chunks[t];
            if (ck.n_mcus == 0) return;
            std::vector<EncComp> local(n_comps);
            for (int i = 0; i < n_comps; ++i) {
                int64_t cursor = ck.first_mcu * per_mcu[i];
                int32_t pred = cursor > 0 ? blocks[i][(cursor - 1) * 64] : 0;
                local[i] = EncComp{blocks[i], per_mcu[i], dc_codes[i], dc_sizes[i],
                                   ac_codes[i], ac_sizes[i], pred, cursor};
            }
            results[t] = emit_chunk_unstuffed(local.data(), n_comps,
                                              ck.n_mcus, ck.buf.get(), ck.cap);
            ck.bits = results[t];
        });
    }
    for (auto& th : pool) th.join();
    for (int64_t r : results)
        if (r < 0) return r;

    std::vector<const uint8_t*> bufs(T);
    std::vector<int64_t> nbits(T);
    for (int64_t t = 0; t < T; ++t) {
        bufs[t] = chunks[t].buf.get();
        nbits[t] = chunks[t].bits;
    }
    return merge_stuff_chunks(bufs.data(), nbits.data(), (int)T, out, capacity);
}

// Pack a lossless (SOF3) sample-difference stream: entry i carries
// category symbol cats[i] (0-16; 16 has no appended bits, the
// t==16 -> 32768 special case) and raw[i] holds the low cats[i]
// EXTEND bits. Entry i uses table pattern[i % pattern_len] — the
// per-MCU component/sample interleave pattern (a plain component
// cycle at 1x1 sampling, runs of h*v per component otherwise).
// Output is the stuffed, 1-padded entropy segment. Returns bytes
// written, -1 overflow, -2 missing code.
int64_t jpx_pack_lossless(
    const uint8_t* cats, const uint16_t* raw, int64_t n,
    const uint8_t* pattern, int64_t pattern_len,
    const uint16_t** codes, const uint8_t** sizes,
    uint8_t* out, int64_t capacity) {
    BitPacker bp{out, capacity, 0, 0, 0};
    for (int64_t i = 0; i < n; ++i) {
        int t = cats[i];
        int ci = pattern[i % pattern_len];
        int size = sizes[ci][t];
        if (size == 0) return -2;
        if (t > 0 && t < 16) {
            uint32_t v = ((uint32_t)codes[ci][t] << t) |
                         ((uint32_t)raw[i] & ((1u << t) - 1));
            if (!bp.write(v, size + t)) return -1;
        } else {
            if (!bp.write(codes[ci][t], size)) return -1;
        }
    }
    if (!bp.finish()) return -1;
    return bp.n;
}

// Restart-segmented lossless packer: the whole scan in ONE call —
// `step` entries per segment, each packed by a fresh BitPacker
// (byte-aligned, restart contract) with RSTn separators, threaded
// over contiguous segment ranges and concatenated in order. Output
// bytes are identical to per-segment jpx_pack_lossless calls joined
// with RSTn markers (the Python loop this replaces paid ~0.13 ms of
// call overhead per segment). Returns bytes written, -1 overflow,
// -2 missing code.
int64_t jpx_pack_lossless_restart(
    const uint8_t* cats, const uint16_t* raw, int64_t n,
    int64_t step,
    const uint8_t* pattern, int64_t pattern_len,
    const uint16_t** codes, const uint8_t** sizes,
    uint8_t* out, int64_t capacity, int32_t n_threads) {
    if (step <= 0) return -1;
    const int64_t n_seg = (n + step - 1) / step;
    int hw = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;
    int64_t T = std::min<int64_t>(n_threads, n_seg);
    if (n < (int64_t)1 << 16) T = 1;

    struct Chunk {
        int64_t g0, g1;
        std::unique_ptr<uint8_t[]> buf;
        int64_t cap, n, status;
    };
    std::vector<Chunk> chunks((size_t)T);
    int64_t per = (n_seg + T - 1) / T;
    for (int64_t t = 0; t < T; ++t) {
        chunks[t].g0 = std::min(n_seg, t * per);
        chunks[t].g1 = std::min(n_seg, (t + 1) * per);
        int64_t entries =
            std::min(n, chunks[t].g1 * step) - chunks[t].g0 * step;
        if (entries < 0) entries = 0;
        chunks[t].cap = entries * 8 + (chunks[t].g1 - chunks[t].g0) * 2 + 64;
        chunks[t].buf.reset(new uint8_t[(size_t)chunks[t].cap]);
        chunks[t].n = 0;
        chunks[t].status = 0;
    }
    auto work = [&](int64_t t) {
        Chunk& ck = chunks[t];
        int64_t pos = 0;
        for (int64_t g = ck.g0; g < ck.g1; ++g) {
            BitPacker bp{ck.buf.get() + pos, ck.cap - pos, 0, 0, 0};
            int64_t i0 = g * step;
            int64_t i1 = std::min(n, i0 + step);
            for (int64_t i = i0; i < i1; ++i) {
                int tt = cats[i];
                int ci = pattern[i % pattern_len];
                int size = sizes[ci][tt];
                if (size == 0) { ck.status = -2; return; }
                if (tt > 0 && tt < 16) {
                    uint32_t v = ((uint32_t)codes[ci][tt] << tt) |
                                 ((uint32_t)raw[i] & ((1u << tt) - 1));
                    if (!bp.write(v, size + tt)) { ck.status = -1; return; }
                } else {
                    if (!bp.write(codes[ci][tt], size)) { ck.status = -1; return; }
                }
            }
            if (!bp.finish()) { ck.status = -1; return; }
            pos += bp.n;
            if (g < n_seg - 1) {
                if (pos + 2 > ck.cap) { ck.status = -1; return; }
                ck.buf[pos++] = 0xFF;
                ck.buf[pos++] = (uint8_t)(0xD0 + (g & 7));
            }
        }
        ck.n = pos;
    };
    if (T <= 1) {
        work(0);
    } else {
        std::vector<std::thread> pool;
        for (int64_t t = 0; t < T; ++t) pool.emplace_back(work, t);
        for (auto& th : pool) th.join();
    }
    int64_t total = 0;
    for (auto& ck : chunks) {
        if (ck.status < 0) return ck.status;
        total += ck.n;
    }
    if (total > capacity) return -1;
    int64_t off = 0;
    for (auto& ck : chunks) {
        std::memcpy(out + off, ck.buf.get(), (size_t)ck.n);
        off += ck.n;
    }
    return total;
}

// DC/AC Huffman symbol histograms for one component's MCU-ordered
// blocks — the native host twin of ops.encode_stage
// .dc_ac_symbol_frequencies (GatherBlockStatistics semantics,
// JpegEncoder.cs:551-601). Chunks count concurrently (DC predictor
// seeds from the previous block's DC value) into local histograms.
int64_t jpx_symbol_histograms(
    const int16_t* blocks, int64_t n_blocks,
    int64_t* dc_freq, int64_t* ac_freq,  // [256] each, caller-zeroed
    int32_t n_threads) {
    int hw = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = hw > 1 ? hw - 1 : 1;
    int64_t T = std::min<int64_t>(n_threads, std::max<int64_t>(1, n_blocks / 4096));

    auto bitcount = [](int32_t v) -> int {
        int a = v < 0 ? -v : v;
        int n = 0;
        while ((a >> n) != 0) ++n;
        return n;
    };

    std::vector<std::vector<int64_t>> dc_local(T, std::vector<int64_t>(256, 0));
    std::vector<std::vector<int64_t>> ac_local(T, std::vector<int64_t>(256, 0));
    int64_t per = (n_blocks + T - 1) / T;

    auto work = [&](int64_t t) {
        int64_t b0 = t * per, b1 = std::min(n_blocks, b0 + per);
        if (b0 >= b1) return;
        int64_t* dcl = dc_local[t].data();
        int64_t* acl = ac_local[t].data();
        int32_t pred = b0 > 0 ? blocks[(b0 - 1) * 64] : 0;
        for (int64_t b = b0; b < b1; ++b) {
            const int16_t* blk = blocks + b * 64;
            int32_t dc = blk[0];
            ++dcl[bitcount(dc - pred)];
            pred = dc;
            int run = 0;
            for (int i = 1; i < 64; ++i) {
                int v = blk[i];
                if (v == 0) { ++run; continue; }
                while (run > 15) { ++acl[0xF0]; run -= 16; }
                ++acl[(run << 4) | bitcount(v)];
                run = 0;
            }
            if (run > 0) ++acl[0x00];  // EOB
        }
    };
    if (T <= 1) {
        work(0);
    } else {
        std::vector<std::thread> pool;
        for (int64_t t = 0; t < T; ++t) pool.emplace_back(work, t);
        for (auto& th : pool) th.join();
    }
    for (int64_t t = 0; t < T; ++t) {
        for (int i = 0; i < 256; ++i) {
            dc_freq[i] += dc_local[t][i];
            ac_freq[i] += ac_local[t][i];
        }
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Progressive (SOF2) Huffman scan EMISSION — the exact inverses of the
// progressive scan decoders above (read_block_prog_dc / _ac /
// _ac_refined), with EOB-run accumulation and the refinement
// correction-bit buffer. Each entry point runs in COUNT mode
// (freq != null: accumulate symbol frequencies for the 2-pass optimal
// table build) or EMIT mode (bit-pack with the supplied tables).
// A capability beyond the reference (Huffman-baseline-only encoder).
// ---------------------------------------------------------------------------

namespace {

struct ProgWriter {
    BitPacker* bp;          // null in count mode
    int64_t* freq;          // [256] symbol histogram in count mode
    const uint16_t* codes;
    const uint8_t* sizes;
    bool missing, overflow;

    bool symbol(int sym) {
        if (freq) { ++freq[sym]; return true; }
        int size = sizes[sym];
        if (size == 0) { missing = true; return false; }
        if (!bp->write(codes[sym], size)) { overflow = true; return false; }
        return true;
    }
    bool bits(uint32_t v, int n) {
        if (n == 0 || freq) return true;
        if (!bp->write(v & ((n >= 32 ? 0xFFFFFFFFu : ((1u << n) - 1))), n)) {
            overflow = true;
            return false;
        }
        return true;
    }
};

// Flush an accumulated EOB run (decoder: eobrun = (1 << r) + bits).
static bool prog_flush_eobrun(ProgWriter& w, int64_t& eobrun,
                              std::vector<uint8_t>* pending_bits) {
    if (eobrun > 0) {
        int r = 0;
        while ((eobrun >> (r + 1)) != 0) ++r;
        if (!w.symbol(r << 4)) return false;
        if (!w.bits((uint32_t)(eobrun - ((int64_t)1 << r)), r)) return false;
        eobrun = 0;
    }
    if (pending_bits) {
        for (uint8_t b : *pending_bits)
            if (!w.bits(b, 1)) return false;
        pending_bits->clear();
    }
    return true;
}

}  // namespace

extern "C" {

// DC scan (interleaved over MCUs). ah == 0: first pass (categories of
// successive (dc >> al) differences); ah != 0: refinement (raw bit al
// of each DC). Per-component tables/frequencies. Returns bytes
// written (0 in count mode), -1 overflow, -2 missing code.
int64_t jpx_encode_prog_dc(
    int32_t n_comps,
    const int16_t** blocks, const int32_t* per_mcu,
    int64_t n_mcus,
    int32_t ah, int32_t al,
    const uint16_t** dc_codes, const uint8_t** dc_sizes,
    int64_t** dc_freqs,        // per comp, null in emit mode
    uint8_t* out, int64_t capacity,
    int64_t ri) {              // restart interval in MCUs (0 = none)
    BitPacker bp{out, capacity, 0, 0, 0};
    const bool emit = dc_freqs == nullptr;
    std::vector<ProgWriter> ws(n_comps);
    std::vector<int32_t> pred(n_comps, 0);
    std::vector<int64_t> cursors(n_comps, 0);
    for (int i = 0; i < n_comps; ++i) {
        ws[i] = ProgWriter{&bp, dc_freqs ? dc_freqs[i] : nullptr,
                           dc_codes ? dc_codes[i] : nullptr,
                           dc_sizes ? dc_sizes[i] : nullptr, false, false};
    }
    const int64_t seg_len = ri > 0 ? ri : n_mcus;
    int64_t m = 0;
    int seg = 0;
    while (m < n_mcus) {
        const int64_t m1 = std::min(n_mcus, m + seg_len);
        for (int i = 0; i < n_comps; ++i) pred[i] = 0;  // fresh per segment
        for (; m < m1; ++m) {
            for (int ci = 0; ci < n_comps; ++ci) {
                for (int b = 0; b < per_mcu[ci]; ++b) {
                    int32_t dc = blocks[ci][cursors[ci] * 64];
                    ++cursors[ci];
                    if (ah == 0) {
                        int32_t v = dc >> al;  // arithmetic shift (T.81 DC point transform)
                        int32_t t = v - pred[ci];
                        pred[ci] = v;
                        int32_t a = t < 0 ? -t : t;
                        int32_t bb = t < 0 ? t - 1 : t;
                        int cat = 0;
                        while ((a >> cat) != 0) ++cat;
                        if (!ws[ci].symbol(cat))
                            return ws[ci].missing ? -2 : -1;
                        if (!ws[ci].bits((uint32_t)bb, cat)) return -1;
                    } else {
                        if (!ws[ci].bits((uint32_t)(dc >> al) & 1, 1)) return -1;
                    }
                }
            }
        }
        if (m < n_mcus && emit) {  // byte-align + RSTn between segments
            if (!bp.finish()) return -1;
            if (bp.n + 2 > capacity) return -1;
            out[bp.n++] = 0xFF;
            out[bp.n++] = (uint8_t)(0xD0 + (seg & 7));
            ++seg;
        } else if (m < n_mcus) {
            ++seg;
        }
    }
    if (!bp.finish()) return -1;
    return dc_freqs ? 0 : bp.n;
}

// AC first scan (ah == 0), one component, band [ss, se], point
// transform al: run-length symbols + EOB runs, magnitudes |v| >> al.
int64_t jpx_encode_prog_ac_first(
    const int16_t* blocks, int64_t n_blocks,
    int32_t ss, int32_t se, int32_t al,
    const uint16_t* ac_codes, const uint8_t* ac_sizes,
    int64_t* ac_freq,
    uint8_t* out, int64_t capacity,
    int64_t ri) {              // restart interval in blocks (0 = none)
    BitPacker bp{out, capacity, 0, 0, 0};
    const bool emit = ac_freq == nullptr;
    ProgWriter w{&bp, ac_freq, ac_codes, ac_sizes, false, false};
    int64_t eobrun = 0;
    const int64_t seg_len = ri > 0 ? ri : n_blocks;
    int64_t next_rst = seg_len;
    int seg = 0;
    for (int64_t b = 0; b < n_blocks; ++b) {
        if (b == next_rst) {  // flush + byte-align + RSTn, fresh state
            if (!prog_flush_eobrun(w, eobrun, nullptr))
                return w.missing ? -2 : -1;
            if (emit) {
                if (!bp.finish()) return -1;
                if (bp.n + 2 > capacity) return -1;
                out[bp.n++] = 0xFF;
                out[bp.n++] = (uint8_t)(0xD0 + (seg & 7));
            }
            ++seg;
            next_rst += seg_len;
        }
        const int16_t* blk = blocks + b * 64;
        int run = 0;
        bool any = false;
        for (int k = ss; k <= se; ++k) {
            int32_t v = blk[k];
            int32_t mag = (v < 0 ? -v : v) >> al;
            if (mag == 0) { ++run; continue; }
            if (!prog_flush_eobrun(w, eobrun, nullptr))
                return w.missing ? -2 : -1;
            while (run > 15) {
                if (!w.symbol(0xF0)) return w.missing ? -2 : -1;
                run -= 16;
            }
            int cat = 0;
            while ((mag >> cat) != 0) ++cat;
            int32_t enc = v < 0 ? -mag : mag;
            int32_t bb = enc < 0 ? enc - 1 : enc;
            if (!w.symbol((run << 4) | cat)) return w.missing ? -2 : -1;
            if (!w.bits((uint32_t)bb, cat)) return -1;
            run = 0;
            any = true;
        }
        if (run > 0 || !any) {
            ++eobrun;
            if (eobrun == 0x7FFF) {
                if (!prog_flush_eobrun(w, eobrun, nullptr))
                    return w.missing ? -2 : -1;
            }
        }
    }
    if (!prog_flush_eobrun(w, eobrun, nullptr)) return w.missing ? -2 : -1;
    if (!bp.finish()) return -1;
    return ac_freq ? 0 : bp.n;
}

// AC refinement scan (ah == al + 1), one component: newly significant
// coefficients (|v| >> al == 1) emit (run, 1) symbols with a sign bit;
// already-significant positions contribute buffered correction bits;
// EOB runs carry the buffered bits of their tail blocks.
int64_t jpx_encode_prog_ac_refine(
    const int16_t* blocks, int64_t n_blocks,
    int32_t ss, int32_t se, int32_t al,
    const uint16_t* ac_codes, const uint8_t* ac_sizes,
    int64_t* ac_freq,
    uint8_t* out, int64_t capacity,
    int64_t ri) {              // restart interval in blocks (0 = none)
    BitPacker bp{out, capacity, 0, 0, 0};
    const bool emit = ac_freq == nullptr;
    ProgWriter w{&bp, ac_freq, ac_codes, ac_sizes, false, false};
    int64_t eobrun = 0;
    std::vector<uint8_t> pending;  // correction bits deferred past EOB flushes
    const int64_t seg_len = ri > 0 ? ri : n_blocks;
    int64_t next_rst = seg_len;
    int seg = 0;

    for (int64_t b = 0; b < n_blocks; ++b) {
        if (b == next_rst) {  // flush (incl. pending) + RSTn, fresh state
            if (!prog_flush_eobrun(w, eobrun, &pending))
                return w.missing ? -2 : -1;
            if (emit) {
                if (!bp.finish()) return -1;
                if (bp.n + 2 > capacity) return -1;
                out[bp.n++] = 0xFF;
                out[bp.n++] = (uint8_t)(0xD0 + (seg & 7));
            }
            ++seg;
            next_rst += seg_len;
        }
        const int16_t* blk = blocks + b * 64;
        // Event buffer since the last emitted symbol, in POSITION order:
        // 0xFF marks a zero-at-this-precision position (counts toward
        // the run), 0/1 is a correction bit for an already-significant
        // position. The decoder consumes correction bits positionally
        // while advancing through a symbol's zeros, so a ZRL must carry
        // exactly the bits that lie before its 16th zero. Fixed stack
        // buffer (band <= 63 events) with a consumed-prefix cursor —
        // a per-block heap vector dominated this loop's profile.
        uint8_t ev[64];
        int ev_n = 0, ev_s = 0;
        int run = 0;
        for (int k = ss; k <= se; ++k) {
            int32_t v = blk[k];
            int32_t t = (v < 0 ? -v : v) >> al;
            if (t == 0) {
                ev[ev_n++] = 0xFF;
                ++run;
                continue;
            }
            if (t > 1) {
                ev[ev_n++] = (uint8_t)(t & 1);
                continue;
            }
            // newly significant (t == 1)
            if (!prog_flush_eobrun(w, eobrun, &pending))
                return w.missing ? -2 : -1;
            while (run > 15) {
                if (!w.symbol(0xF0)) return w.missing ? -2 : -1;
                int zcount = 0;
                int i = ev_s;
                while (i < ev_n && zcount < 16) {
                    if (ev[i] == 0xFF) {
                        ++zcount;
                    } else {
                        if (!w.bits(ev[i], 1)) return -1;
                    }
                    ++i;
                }
                ev_s = i;
                run -= 16;
            }
            if (!w.symbol((run << 4) | 1)) return w.missing ? -2 : -1;
            if (!w.bits(v > 0 ? 1 : 0, 1)) return -1;
            for (int i = ev_s; i < ev_n; ++i) {
                if (ev[i] != 0xFF) {
                    if (!w.bits(ev[i], 1)) return -1;
                }
            }
            ev_n = ev_s = 0;
            run = 0;
        }
        // Tail after the last newly-significant coefficient: any
        // remaining zeros or correction bits require this block to
        // join an EOB run (the decoder's eobrun tail loop reads the
        // corrections for the whole remaining band).
        bool needs_eob = ev_s < ev_n;
        for (int i = ev_s; i < ev_n; ++i) {
            if (ev[i] != 0xFF) pending.push_back(ev[i]);
        }
        if (needs_eob) {
            ++eobrun;
            if (eobrun == 0x7FFF) {
                if (!prog_flush_eobrun(w, eobrun, &pending))
                    return w.missing ? -2 : -1;
            }
        }
    }
    if (!prog_flush_eobrun(w, eobrun, &pending)) return w.missing ? -2 : -1;
    if (!bp.finish()) return -1;
    return ac_freq ? 0 : bp.n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Forward DCT + quantize (encoder host transform hot path)
// ---------------------------------------------------------------------------
//
// The AAN float32 butterfly with the reference's exact dataflow
// (FastFloatingPointDCT.TransformFDCT, FastFloatingPointDCT.cs:346;
// same op order as ops/dct.py::_fdct_1d), vectorized 8 lanes wide per
// stage and threaded over block rows. Compiled with -ffp-contract=off
// so results match the IEEE add/mul sequence (no FMA contraction).

namespace {

static const float kF0_541196 = 0.541196f;
static const float kF1_306563 = 1.306563f;
static const float kF1_175876 = 1.175876f;
static const float kF0_785695 = 0.785695f;
static const float kF1_387040 = 1.387040f;
static const float kF0_275899 = 0.275899f;
static const float kF0_707107 = 0.707107f;

// One 1-D FDCT pass combining rows of x (x[i] is an 8-lane vector).
static inline void fdct_pass(const float x[8][8], float d[8][8]) {
    float t0[8], t1[8], t2[8], t3[8], t4[8], t5[8], t6[8], t7[8];
    float c0[8], c1[8], c2[8], c3[8];
    for (int j = 0; j < 8; ++j) { t0[j] = x[0][j] + x[7][j]; t7[j] = x[0][j] - x[7][j]; }
    for (int j = 0; j < 8; ++j) { t1[j] = x[1][j] + x[6][j]; t6[j] = x[1][j] - x[6][j]; }
    for (int j = 0; j < 8; ++j) { t2[j] = x[2][j] + x[5][j]; t5[j] = x[2][j] - x[5][j]; }
    for (int j = 0; j < 8; ++j) { t3[j] = x[3][j] + x[4][j]; t4[j] = x[3][j] - x[4][j]; }
    for (int j = 0; j < 8; ++j) { c0[j] = t0[j] + t3[j]; c3[j] = t0[j] - t3[j]; }
    for (int j = 0; j < 8; ++j) { c1[j] = t1[j] + t2[j]; c2[j] = t1[j] - t2[j]; }
    for (int j = 0; j < 8; ++j) { d[0][j] = c0[j] + c1[j]; d[4][j] = c0[j] - c1[j]; }
    for (int j = 0; j < 8; ++j) {
        d[2][j] = (kF0_541196 * c2[j]) + (kF1_306563 * c3[j]);
        d[6][j] = (kF0_541196 * c3[j]) - (kF1_306563 * c2[j]);
    }
    for (int j = 0; j < 8; ++j) {
        c3[j] = (kF1_175876 * t4[j]) + (kF0_785695 * t7[j]);
        c0[j] = (kF1_175876 * t7[j]) - (kF0_785695 * t4[j]);
    }
    for (int j = 0; j < 8; ++j) {
        c2[j] = (kF1_387040 * t5[j]) + (kF0_275899 * t6[j]);
        c1[j] = (kF1_387040 * t6[j]) - (kF0_275899 * t5[j]);
    }
    for (int j = 0; j < 8; ++j) { d[3][j] = c0[j] - c2[j]; d[5][j] = c3[j] - c1[j]; }
    for (int j = 0; j < 8; ++j) {
        c0[j] = (c0[j] + c2[j]) * kF0_707107;
        c3[j] = (c3[j] + c1[j]) * kF0_707107;
    }
    for (int j = 0; j < 8; ++j) { d[1][j] = c0[j] + c3[j]; d[7][j] = c0[j] - c3[j]; }
}

static inline void transpose8(const float a[8][8], float b[8][8]) {
    for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 8; ++j) b[j][i] = a[i][j];
}

}  // namespace

extern "C" {

// Forward transform one padded plane: level shift, 2-D AAN FDCT,
// zig-zag, quantize (rint = round-half-even via nearbyintf, matching
// ZigZagAndQuantizeBlock + JpegMathHelper.RoundToInt16,
// JpegEncoder.cs:812-827). Exactly one of plane_u8 / plane_i32 is
// non-null. out: int16 [h/8, w/8, 64] zig-zag. level_shift is
// 1 << (P - 1): 128 for 8-bit, 2048 for the direct 12-bit sample path
// (the reference encoder is 8-bit only, JpegEncoder.cs:108).
void jpx_fdct_quantize(
    const uint8_t* plane_u8, const int32_t* plane_i32,
    int64_t h, int64_t w,
    const float* quant_zz, const uint8_t* zz_to_nat,
    int16_t* out, int32_t n_threads, float level_shift) {
    const int64_t hb = h / 8, wb = w / 8;
    int hw = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = hw > 1 ? hw - 1 : 1;
    int64_t T = std::min<int64_t>(n_threads, std::max<int64_t>(1, hb));
    if (hb * wb < 2048) T = 1;

    auto work = [&](int64_t r0, int64_t r1) {
        float blk[8][8], tmp[8][8], f[8][8];
        for (int64_t by = r0; by < r1; ++by) {
            for (int64_t bx = 0; bx < wb; ++bx) {
                if (plane_u8 != nullptr) {
                    for (int r = 0; r < 8; ++r) {
                        const uint8_t* src = plane_u8 + (by * 8 + r) * w + bx * 8;
                        for (int c = 0; c < 8; ++c)
                            blk[r][c] = (float)src[c] - level_shift;
                    }
                } else {
                    for (int r = 0; r < 8; ++r) {
                        const int32_t* src = plane_i32 + (by * 8 + r) * w + bx * 8;
                        for (int c = 0; c < 8; ++c)
                            blk[r][c] = (float)src[c] - level_shift;
                    }
                }
                // transpose -> pass -> transpose -> pass -> * 0.125
                transpose8(blk, tmp);
                fdct_pass(tmp, f);
                transpose8(f, tmp);
                fdct_pass(tmp, f);
                int16_t* dst = out + (by * wb + bx) * 64;
                for (int zz = 0; zz < 64; ++zz) {
                    int nat = zz_to_nat[zz];
                    float v = f[nat >> 3][nat & 7] * 0.125f;
                    dst[zz] = (int16_t)(int32_t)nearbyintf(v / quant_zz[zz]);
                }
            }
        }
    };
    if (T <= 1) {
        work(0, hb);
        return;
    }
    std::vector<std::thread> pool;
    int64_t step = (hb + T - 1) / T;
    for (int64_t t = 0; t < T; ++t) {
        int64_t b = t * step;
        if (b >= hb) break;
        pool.emplace_back(work, b, std::min(hb, b + step));
    }
    for (auto& th : pool) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused host decode transform: dequant + IDCT + upsample + YCbCr->RGB
// ---------------------------------------------------------------------------
//
// The decode twin of jpx_encode_transform_rgb: one threaded pass turns
// zig-zag coefficient planes into interleaved RGB8, iMCU row stripe at
// a time, so samples never round-trip through full-image float planes.
// Bit-exact to the numpy path (ops/decode_stage.dequantize_idct_shift +
// upsample_duplicate + ops/color.ycbcr_to_rgb): same float32 AAN op
// order as ops/dct.py::_idct_1d (compiled -ffp-contract=off), rint via
// nearbyintf (round half to even), identical fixed-point color
// constants (JpegYCbCrToRgbConverter.cs:67-122 reduction).

namespace {

static const float kI1_175876 = 1.175875602f;
static const float kI1_961571 = -1.961570560f;
static const float kI0_390181 = -0.390180644f;
static const float kI0_899976 = -0.899976223f;
static const float kI2_562915 = -2.562915447f;
static const float kI0_298631 = 0.298631336f;
static const float kI2_053120 = 2.053119869f;
static const float kI3_072711 = 3.072711026f;
static const float kI1_501321 = 1.501321110f;
static const float kI0_541196 = 0.541196100f;
static const float kI1_847759 = -1.847759065f;
static const float kI0_765367 = 0.765366865f;

// One 1-D IDCT pass combining rows of x (x[i] is an 8-lane vector);
// mirrors ops/dct.py::_idct_1d / IDCT8x4_LeftPart+RightPart.
static inline void idct_pass(const float x[8][8], float d[8][8]) {
    float mz0[8], mz1[8], mz2[8], mz3[8], mz4[8];
    float mb0[8], mb1[8], mb2[8], mb3[8];
    float my0[8], my1[8], my2[8], my3[8];
    for (int j = 0; j < 8; ++j) {
        mz0[j] = x[1][j] + x[7][j];
        mz2[j] = x[3][j] + x[7][j];
        mz1[j] = x[3][j] + x[5][j];
        mz3[j] = x[1][j] + x[5][j];
        mz4[j] = (mz0[j] + mz1[j]) * kI1_175876;
    }
    for (int j = 0; j < 8; ++j) {
        mz2[j] = (mz2[j] * kI1_961571) + mz4[j];
        mz3[j] = (mz3[j] * kI0_390181) + mz4[j];
        mz0[j] = mz0[j] * kI0_899976;
        mz1[j] = mz1[j] * kI2_562915;
    }
    for (int j = 0; j < 8; ++j) {
        mb3[j] = ((x[7][j] * kI0_298631) + mz0[j]) + mz2[j];
        mb2[j] = ((x[5][j] * kI2_053120) + mz1[j]) + mz3[j];
        mb1[j] = ((x[3][j] * kI3_072711) + mz1[j]) + mz2[j];
        mb0[j] = ((x[1][j] * kI1_501321) + mz0[j]) + mz3[j];
    }
    for (int j = 0; j < 8; ++j) {
        mz4[j] = (x[2][j] + x[6][j]) * kI0_541196;
        mz0[j] = x[0][j] + x[4][j];
        mz1[j] = x[0][j] - x[4][j];
        mz2[j] = mz4[j] + (x[6][j] * kI1_847759);
        mz3[j] = mz4[j] + (x[2][j] * kI0_765367);
    }
    for (int j = 0; j < 8; ++j) {
        my0[j] = mz0[j] + mz3[j];
        my3[j] = mz0[j] - mz3[j];
        my1[j] = mz1[j] + mz2[j];
        my2[j] = mz1[j] - mz2[j];
    }
    for (int j = 0; j < 8; ++j) {
        d[0][j] = my0[j] + mb0[j];
        d[1][j] = my1[j] + mb1[j];
        d[2][j] = my2[j] + mb2[j];
        d[3][j] = my3[j] + mb3[j];
        d[4][j] = my3[j] - mb3[j];
        d[5][j] = my2[j] - mb2[j];
        d[6][j] = my1[j] - mb1[j];
        d[7][j] = my0[j] - mb0[j];
    }
}

// Dequantize one zig-zag block, 2-D IDCT, level shift, clamp to uint8.
// zz_to_nat: zig-zag index -> natural index (the FDCT's table).
static inline void idct_block_u8(const int16_t* zz, const int32_t* qt,
                                 const uint8_t* zz_to_nat,
                                 uint8_t* dst, int64_t stride) {
    float f[8][8], tmp[8][8];
    for (int i = 0; i < 64; ++i) {
        int nat = zz_to_nat[i];
        f[nat >> 3][nat & 7] = (float)((int32_t)zz[i] * qt[i]);
    }
    transpose8(f, tmp);
    idct_pass(tmp, f);
    transpose8(f, tmp);
    idct_pass(tmp, f);
    for (int r = 0; r < 8; ++r) {
        uint8_t* row = dst + r * stride;
        for (int c = 0; c < 8; ++c) {
            int32_t v = (int32_t)nearbyintf(f[r][c] * 0.125f) + 128;
            row[c] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
        }
    }
}

// Fixed-point YCbCr->RGB constants (ops/color.py _D1-_D4; the
// JpegYCbCrToRgbConverter.cs:67-122 LUT reduction).
static const int32_t kCrR = 91881;    // Cr -> R
static const int32_t kCrG = -46802;   // Cr -> G
static const int32_t kCbB = 116130;   // Cb -> B
static const int32_t kCbG = -22553;   // Cb -> G
static const int32_t kHalf16 = 32768;

static inline uint8_t clamp_u8_i32(int32_t v) {
    return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// Context + per-MCU-row worker for the fused decode transform — shared
// by jpx_decode_transform_rgb (static row-range threading) and
// jpx_decode_rgb_fused (row tasks gated on restart-span completion).
struct XfRgbCtx {
    const int16_t* const* planes;
    const int64_t* plane_wb;
    const int32_t* quants;
    int32_t n_comps;
    const int32_t* comp_h;
    const int32_t* comp_v;
    int32_t max_h, max_v;
    int64_t width, height;
    const uint8_t* zz;
    int32_t mode;
    uint8_t* out;
    std::vector<std::vector<int32_t>> cidx;  // per-comp x -> column map
};

static void xf_rgb_ctx_init(XfRgbCtx& c, const int16_t* const* planes,
                            const int64_t* plane_wb, const int32_t* quants,
                            int32_t n_comps, const int32_t* comp_h,
                            const int32_t* comp_v, int32_t max_h,
                            int32_t max_v, int64_t width, int64_t height,
                            const uint8_t* zz, int32_t mode, uint8_t* out) {
    c.planes = planes;
    c.plane_wb = plane_wb;
    c.quants = quants;
    c.n_comps = n_comps;
    c.comp_h = comp_h;
    c.comp_v = comp_v;
    c.max_h = max_h;
    c.max_v = max_v;
    c.width = width;
    c.height = height;
    c.zz = zz;
    c.mode = mode;
    c.out = out;
    c.cidx.resize(n_comps);
    for (int i = 0; i < n_comps; ++i) {
        int hs = max_h / comp_h[i];
        c.cidx[i].resize(width);
        for (int64_t x = 0; x < width; ++x)
            c.cidx[i][(size_t)x] = (int32_t)(x / hs);
    }
}

struct XfRgbScratch {
    // Per-component stripe sample buffers: v*8 rows of the component
    // plane, one iMCU row at a time.
    std::vector<std::vector<uint8_t>> bufs;
    std::vector<int64_t> bstride;
    void init(const XfRgbCtx& c) {
        bufs.resize(c.n_comps);
        bstride.resize(c.n_comps);
        for (int i = 0; i < c.n_comps; ++i) {
            bstride[i] = c.plane_wb[i] * 8;
            bufs[i].resize((size_t)(c.comp_v[i] * 8) * bstride[i]);
        }
    }
};

static void xform_rgb_rows(const XfRgbCtx& c, XfRgbScratch& sc, int64_t r0,
                           int64_t r1) {
    const int32_t mode = c.mode;
    const int64_t width = c.width;
    uint8_t* out = c.out;
    for (int64_t r = r0; r < r1; ++r) {
        for (int ci = 0; ci < c.n_comps; ++ci) {
            const int v = c.comp_v[ci];
            const int64_t wb = c.plane_wb[ci];
            for (int by = 0; by < v; ++by) {
                const int16_t* src = c.planes[ci] + ((r * v + by) * wb) * 64;
                uint8_t* dst = sc.bufs[ci].data() +
                               (size_t)(by * 8) * sc.bstride[ci];
                for (int64_t bx = 0; bx < wb; ++bx)
                    idct_block_u8(src + bx * 64, c.quants + ci * 64, c.zz,
                                  dst + bx * 8, sc.bstride[ci]);
            }
        }
        const int64_t y_end =
            std::min<int64_t>(c.height, (r + 1) * 8 * c.max_v);
        for (int64_t y0 = r * 8 * (int64_t)c.max_v; y0 < y_end; ++y0) {
            uint8_t* orow = out + y0 * width * 3;
            if (mode == 0) {
                const int vs = c.max_v / c.comp_v[0];
                const uint8_t* yrow =
                    sc.bufs[0].data() +
                    (size_t)(y0 / vs - (int64_t)(r * 8 * c.comp_v[0])) *
                        sc.bstride[0];
                const int32_t* cy = c.cidx[0].data();
                for (int64_t x = 0; x < width; ++x) {
                    uint8_t s = yrow[cy[x]];
                    orow[x * 3] = s;
                    orow[x * 3 + 1] = s;
                    orow[x * 3 + 2] = s;
                }
            } else {
                const uint8_t* rows[3];
                for (int ci = 0; ci < 3; ++ci) {
                    const int vs = c.max_v / c.comp_v[ci];
                    rows[ci] =
                        sc.bufs[ci].data() +
                        (size_t)(y0 / vs - (int64_t)(r * 8 * c.comp_v[ci])) *
                            sc.bstride[ci];
                }
                if (mode == 2) {
                    const int32_t* c0 = c.cidx[0].data();
                    const int32_t* c1 = c.cidx[1].data();
                    const int32_t* c2 = c.cidx[2].data();
                    for (int64_t x = 0; x < width; ++x) {
                        orow[x * 3] = rows[0][c0[x]];
                        orow[x * 3 + 1] = rows[1][c1[x]];
                        orow[x * 3 + 2] = rows[2][c2[x]];
                    }
                } else if (c.max_h / c.comp_h[0] == 1 &&
                           c.max_h / c.comp_h[1] == 2 &&
                           c.max_h / c.comp_h[2] == 2) {
                    // 4:2:0 / 4:2:2 fast lane: luma full-rate, both
                    // chromas half-rate.
                    for (int64_t x = 0; x < width; ++x) {
                        int32_t yv = rows[0][x];
                        int32_t xcb = (int32_t)rows[1][x >> 1] - 128;
                        int32_t xcr = (int32_t)rows[2][x >> 1] - 128;
                        orow[x * 3] =
                            clamp_u8_i32(yv + ((kCrR * xcr + kHalf16) >> 16));
                        orow[x * 3 + 1] = clamp_u8_i32(
                            yv + (((kCbG * xcb + kHalf16) + kCrG * xcr) >> 16));
                        orow[x * 3 + 2] =
                            clamp_u8_i32(yv + ((kCbB * xcb + kHalf16) >> 16));
                    }
                } else {
                    const int32_t* c0 = c.cidx[0].data();
                    const int32_t* c1 = c.cidx[1].data();
                    const int32_t* c2 = c.cidx[2].data();
                    for (int64_t x = 0; x < width; ++x) {
                        int32_t yv = rows[0][c0[x]];
                        int32_t xcb = (int32_t)rows[1][c1[x]] - 128;
                        int32_t xcr = (int32_t)rows[2][c2[x]] - 128;
                        orow[x * 3] =
                            clamp_u8_i32(yv + ((kCrR * xcr + kHalf16) >> 16));
                        orow[x * 3 + 1] = clamp_u8_i32(
                            yv + (((kCbG * xcb + kHalf16) + kCrG * xcr) >> 16));
                        orow[x * 3 + 2] =
                            clamp_u8_i32(yv + ((kCbB * xcb + kHalf16) >> 16));
                    }
                }
            }
        }
    }
}

}  // namespace

extern "C" {

// Fused decode transform to interleaved RGB8.
//   planes: n_comps int16 [Hb, Wb, 64] zig-zag coefficient planes
//           (full MCU grid: Hb = mcus_per_column*v, Wb = mcus_per_line*h)
//   quants: n_comps x 64 int32, zig-zag order
//   mode: 0 = grayscale (1 comp), 1 = YCbCr (3 comps),
//         2 = RGB-coded (3 comps are the channels)
//   out: uint8 [height, width, 3]
// Chroma upsampling is duplication (WriteBlockSlow semantics,
// JpegHuffmanBaselineScanDecoder.cs:238-271). Returns 0 ok / 3 bad args.
int jpx_decode_transform_rgb(
    const int16_t** planes, const int64_t* plane_wb,
    const int32_t* quants,
    int32_t n_comps,
    const int32_t* comp_h, const int32_t* comp_v,
    int32_t max_h, int32_t max_v,
    int64_t width, int64_t height,
    int64_t mcus_per_line, int64_t mcus_per_column,
    const uint8_t* zz_to_nat,
    int32_t mode,
    uint8_t* out,
    int32_t n_threads) {
    if (n_comps <= 0 || n_comps > 4 || width <= 0 || height <= 0) return 3;
    if ((mode == 0 && n_comps != 1) || (mode != 0 && n_comps != 3)) return 3;
    (void)mcus_per_line;

    XfRgbCtx c;
    xf_rgb_ctx_init(c, planes, plane_wb, quants, n_comps, comp_h, comp_v,
                    max_h, max_v, width, height, zz_to_nat, mode, out);

    int hw = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = hw > 1 ? hw - 1 : 1;
    int64_t T = std::min<int64_t>(n_threads, std::max<int64_t>(1, mcus_per_column));
    if (width * height < 1 << 18) T = 1;

    if (T <= 1) {
        XfRgbScratch sc;
        sc.init(c);
        xform_rgb_rows(c, sc, 0, mcus_per_column);
        return 0;
    }
    std::vector<std::thread> pool;
    int64_t step = (mcus_per_column + T - 1) / T;
    for (int64_t t = 0; t < T; ++t) {
        int64_t b = t * step;
        if (b >= mcus_per_column) break;
        pool.emplace_back([&, b, step]() {
            XfRgbScratch sc;
            sc.init(c);
            xform_rgb_rows(c, sc, b, std::min(mcus_per_column, b + step));
        });
    }
    for (auto& th : pool) th.join();
    return 0;
}

// Fully fused baseline decode -> interleaved RGB8: the restart-span
// entropy decode and the per-MCU-row transform share ONE thread pool —
// a row transforms as soon as every span overlapping it has decoded
// (its coefficients still cache-warm), so the transform of early rows
// overlaps the entropy decode of late ones instead of waiting behind a
// phase barrier. planes are caller-provided zeroed scratch (the dense
// coefficient grids). Output is byte-identical to
// jpx_decode_baseline_scan + jpx_decode_transform_rgb by construction
// (same decode_span / xform_rgb_rows bodies). Returns 0 ok, or the
// scanner's error codes (1 EOF / 2 bad code / 3 bad args).
int jpx_decode_rgb_fused(
    const uint8_t* data,
    const int64_t* span_starts, const int64_t* span_ends, int32_t n_spans,
    int64_t restart_interval,
    int64_t mcus_per_line, int64_t mcus_per_column,
    int32_t n_comps,
    const int32_t* comp_h, const int32_t* comp_v,
    const uint8_t* dc_blob, const uint8_t* ac_blob,
    int16_t** planes, const int64_t* plane_wb,
    const int32_t* quants,
    int32_t max_h, int32_t max_v,
    int64_t width, int64_t height,
    const uint8_t* zz_to_nat,
    int32_t mode,
    uint8_t* out,
    int32_t n_threads) {
    if (n_comps <= 0 || n_spans <= 0 || width <= 0 || height <= 0) return 3;
    if ((mode == 0 && n_comps != 1) || (mode != 0 && n_comps != 3)) return 3;

    if (restart_interval <= 0) {
        // No restart seams: the speculative scanner threads internally
        // with no per-span completion signal — run the two stages back
        // to back inside this one call.
        int rc = decode_baseline_scan_impl(
            data, span_starts, span_ends, n_spans, restart_interval,
            mcus_per_line, mcus_per_column, n_comps, comp_h, comp_v, dc_blob,
            ac_blob, planes, plane_wb, n_threads, 0, 0);
        if (rc) return rc;
        return jpx_decode_transform_rgb(
            (const int16_t**)planes, plane_wb, quants, n_comps, comp_h,
            comp_v, max_h, max_v, width, height, mcus_per_line,
            mcus_per_column, zz_to_nat, mode, out, n_threads);
    }

    std::vector<Component> comps(n_comps);
    for (int i = 0; i < n_comps; ++i) {
        comps[i].h = comp_h[i];
        comps[i].v = comp_v[i];
        comps[i].dc = reinterpret_cast<const HuffTable*>(dc_blob) + i;
        comps[i].ac = reinterpret_cast<const HuffTable*>(ac_blob) + i;
        comps[i].plane = planes[i];
        comps[i].wb = plane_wb[i];
    }
    const int64_t total_mcus = mcus_per_line * mcus_per_column;
    std::vector<SpanTask> tasks;
    {
        int64_t mcu = 0;
        for (int32_t s = 0; s < n_spans && mcu < total_mcus; ++s) {
            int64_t n = std::min<int64_t>(restart_interval, total_mcus - mcu);
            tasks.push_back({data + span_starts[s],
                             span_ends[s] - span_starts[s], mcu, n});
            mcu += n;
        }
    }

    XfRgbCtx xc;
    xf_rgb_ctx_init(xc, (const int16_t* const*)planes, plane_wb, quants,
                    n_comps, comp_h, comp_v, max_h, max_v, width, height,
                    zz_to_nat, mode, out);

    const int64_t R = mcus_per_column;
    std::unique_ptr<std::atomic<int32_t>[]> pending(
        new std::atomic<int32_t>[(size_t)R]);
    std::unique_ptr<std::atomic<bool>[]> claimed(
        new std::atomic<bool>[(size_t)R]);
    for (int64_t r = 0; r < R; ++r) {
        pending[r].store(0, std::memory_order_relaxed);
        claimed[r].store(false, std::memory_order_relaxed);
    }
    // Rows with zero covering spans (truncated streams) start ready:
    // their zero coefficients decode to the same mid-gray the tolerant
    // staged path produces.
    for (const auto& t : tasks) {
        int64_t rlo = t.first_mcu / mcus_per_line;
        int64_t rhi = (t.first_mcu + t.n_mcus - 1) / mcus_per_line;
        for (int64_t r = rlo; r <= rhi; ++r)
            pending[r].fetch_add(1, std::memory_order_relaxed);
    }

    int hw = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;
    int T = (int)std::min<int64_t>(n_threads, std::max<int64_t>(1, R));

    std::atomic<int64_t> span_cursor{0};
    std::atomic<int64_t> rows_done{0};
    std::atomic<int> status{0};
    // Per-task error codes: the return value is the FIRST failing
    // task's code in task order, matching the staged scanner (threads
    // may hit different corrupt spans in different orders).
    std::vector<int> task_rc(tasks.size(), 0);

    auto worker = [&]() {
        std::vector<Component> cl = comps;  // thread-local DC predictors
        while (status.load(std::memory_order_relaxed) == 0) {
            int64_t k = span_cursor.fetch_add(1);
            if (k >= (int64_t)tasks.size()) break;
            int rc = decode_span(tasks[k], cl.data(), n_comps, mcus_per_line, 0);
            if (rc) {
                task_rc[(size_t)k] = rc;
                status.store(rc);
                return;
            }
            const SpanTask& t = tasks[k];
            int64_t rlo = t.first_mcu / mcus_per_line;
            int64_t rhi = (t.first_mcu + t.n_mcus - 1) / mcus_per_line;
            for (int64_t r = rlo; r <= rhi; ++r)
                pending[r].fetch_sub(1, std::memory_order_acq_rel);
        }
        XfRgbScratch sc;
        sc.init(xc);
        while (rows_done.load(std::memory_order_relaxed) < R &&
               status.load(std::memory_order_relaxed) == 0) {
            bool found = false;
            for (int64_t r = 0; r < R; ++r) {
                if (pending[r].load(std::memory_order_acquire) == 0 &&
                    !claimed[r].exchange(true, std::memory_order_acq_rel)) {
                    xform_rgb_rows(xc, sc, r, r + 1);
                    rows_done.fetch_add(1);
                    found = true;
                }
            }
            if (!found) std::this_thread::yield();
        }
    };

    if (T <= 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        for (int t = 0; t < T; ++t) pool.emplace_back(worker);
        for (auto& th : pool) th.join();
    }
    for (int rc : task_rc)
        if (rc) return rc;
    return status.load();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fixed-point RGB -> YCbCr (encoder host path)

// ---------------------------------------------------------------------------
//
// Same 16-bit fixed-point arithmetic as ops/color.rgb_to_ycbcr (parity
// with JpegRgbToYCbCrConverter.cs:37-95 incl. the 0.5-epsilon rounding
// fudge); multithreaded over row chunks.

namespace {

struct RgbYcc {
    int32_t yr, yg, yb, cbr, cbg, cbb, crg, crb;
};

static int32_t fix16(double v) { return (int32_t)(v * 65536.0 + 0.5); }

}  // namespace

extern "C" {

// rgb: interleaved uint8 [n, 3]; y/cb/cr: uint8 [n] outputs.
void jpx_rgb_to_ycbcr(const uint8_t* rgb, int64_t n,
                      uint8_t* y_out, uint8_t* cb_out, uint8_t* cr_out,
                      const int32_t* consts /* yr yg yb cbr cbg cbb crg crb */) {
    const int32_t yr = consts[0], yg = consts[1], yb = consts[2];
    const int32_t cbr = consts[3], cbg = consts[4], cbb = consts[5];
    const int32_t crg = consts[6], crb = consts[7];
    const int32_t half = 1 << 15;
    const int32_t fudge = (128 << 16) + half - 1;

    int hw = (int)std::thread::hardware_concurrency();
    int nt = hw > 2 ? hw - 2 : 1;
    if (n < (int64_t)1 << 18) nt = 1;

    auto work = [&](int64_t begin, int64_t end) {
        for (int64_t i = begin; i < end; ++i) {
            int32_t r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
            y_out[i] = (uint8_t)((yr * r + yg * g + (yb * b + half)) >> 16);
            cb_out[i] = (uint8_t)((cbr * r + cbg * g + (cbb * b + fudge)) >> 16);
            cr_out[i] = (uint8_t)(((cbb * r + fudge) + crg * g + crb * b) >> 16);
        }
    };
    if (nt <= 1) {
        work(0, n);
        return;
    }
    std::vector<std::thread> pool;
    int64_t step = (n + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
        int64_t b = t * step;
        if (b >= n) break;
        pool.emplace_back(work, b, std::min(n, b + step));
    }
    for (auto& th : pool) th.join();
}

}  // extern "C"

// Box-filter subsample with the reference rounding
// ((sum + 2^(s-1)) >> s, ReadBlockWithSubsample, JpegEncoder.cs:756-787).
// in: uint8 [h, w] (h % vs == 0, w % hs == 0); out: int32 [h/vs, w/hs].
extern "C" void jpx_box_subsample(const uint8_t* in, int64_t h, int64_t w,
                                  int32_t hs, int32_t vs, int32_t* out) {
    // Round-half-up divide by the box size (== the reference's
    // (sum + 2^(s-1)) >> s for power-of-two boxes; correct for the
    // non-power-of-two factors T.81 also allows, e.g. 3).
    const int32_t n = hs * vs;
    const int32_t delta = n / 2;
    const int64_t oh = h / vs, ow = w / hs;

    int hw = (int)std::thread::hardware_concurrency();
    int nt = hw > 2 ? hw - 2 : 1;
    if (oh * ow < (int64_t)1 << 17) nt = 1;

    auto work = [&](int64_t r0, int64_t r1) {
        for (int64_t oy = r0; oy < r1; ++oy) {
            for (int64_t ox = 0; ox < ow; ++ox) {
                int32_t sum = 0;
                for (int32_t dy = 0; dy < vs; ++dy) {
                    const uint8_t* row = in + (oy * vs + dy) * w + ox * hs;
                    for (int32_t dx = 0; dx < hs; ++dx) sum += row[dx];
                }
                out[oy * ow + ox] = (sum + delta) / n;
            }
        }
    };
    if (nt <= 1) {
        work(0, oh);
        return;
    }
    std::vector<std::thread> pool;
    int64_t step = (oh + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
        int64_t b = t * step;
        if (b >= oh) break;
        pool.emplace_back(work, b, std::min(oh, b + step));
    }
    for (auto& th : pool) th.join();
}

// ---------------------------------------------------------------------------
// Zig-zag block permute: one-pass materialization of a composed
// geometric transform over a coefficient plane. The grid part of the
// transform (block transposes / axis mirrors) arrives as the VIEW's
// element strides (s0/s1 may be negative, s2 is the zig-zag axis);
// the per-block part is a 64-entry gather permutation + sign vector
// (jpegtran semantics: transpose permutes the zig-zag index, mirrors
// flip (-1)^u / (-1)^v). out is contiguous [hb, wb, 64] int16.
// ---------------------------------------------------------------------------

extern "C" void jpx_zz_block_permute(const int16_t* base, int64_t s0,
                                     int64_t s1, int64_t s2, int64_t hb,
                                     int64_t wb, const int32_t* perm,
                                     const int32_t* sign, int16_t* out,
                                     int32_t n_threads) {
    // Pre-fold sign into a signed gather table local to each thread.
    auto work = [&](int64_t r0, int64_t r1) {
        for (int64_t i = r0; i < r1; ++i) {
            const int16_t* row = base + i * s0;
            int16_t* orow = out + i * wb * 64;
            for (int64_t j = 0; j < wb; ++j) {
                const int16_t* blk = row + j * s1;
                int16_t* ob = orow + j * 64;
                for (int z = 0; z < 64; ++z)
                    ob[z] = (int16_t)(blk[perm[z] * s2] * sign[z]);
            }
        }
    };
    int nt = n_threads > 0 ? n_threads : 1;
    if (hb * wb < 1024) nt = 1;
    if (nt <= 1) {
        work(0, hb);
        return;
    }
    std::vector<std::thread> pool;
    int64_t step = (hb + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
        int64_t b = t * step;
        if (b >= hb) break;
        pool.emplace_back(work, b, std::min(hb, b + step));
    }
    for (auto& th : pool) th.join();
}

// ---------------------------------------------------------------------------
// Arithmetic lossless (SOF11 / SOF15), T.81 H.2 — native twins of
// models/arithmetic_lossless.py (which documents the coding model).
// Statistics: 25 contexts x 4 bins + two magnitude-ladder sets
// (X at 100 / 129, mantissa at pos+14) = 158 bins, shared per DC table
// selector. Bit-identical to the Python implementation by construction
// (same ArithState / ArithEncoder register machines).
// ---------------------------------------------------------------------------

static const int H2_STATS = 158;

static inline int h2_classify(int32_t v, int32_t lo, int32_t hi) {
    if (v == 0) return 0;
    int sign = v < 0 ? 1 : 0;
    int32_t mval = (v < 0 ? -v : v) - 1;
    int32_t mcat = 0;
    if (mval) {
        mcat = 1;
        while (mval > 1) { mval >>= 1; mcat <<= 1; }
    }
    if (mcat < lo) return 0;
    if (mcat > hi) return 3 + sign;
    return 1 + sign;
}

static inline int h2_decode_diff(ArithState& s, BitReader& br, uint8_t* st,
                                 int base, bool db_large, int32_t* out) {
    if (s.decode(br, st + base) == 0) { *out = 0; return 0; }
    int sign = s.decode(br, st + base + 1);
    int pos = base + 2 + sign;
    int m = s.decode(br, st + pos);
    if (m != 0) {
        pos = db_large ? 129 : 100;
        while (s.decode(br, st + pos) != 0) {
            m <<= 1;
            if (m == 0x8000) return 2;
            ++pos;
        }
    }
    int v = m;
    pos += 14;
    m >>= 1;
    while (m != 0) {
        if (s.decode(br, st + pos) != 0) v |= m;
        m >>= 1;
    }
    v += 1;
    *out = sign ? -v : v;
    return 0;
}

static inline void h2_encode_diff(ArithEncoder& e, uint8_t* st, int base,
                                  bool db_large, int32_t v) {
    if (v == 0) {
        e.encode(0, st + base);
        return;
    }
    e.encode(1, st + base);
    int sign = v < 0 ? 1 : 0;
    e.encode(sign, st + base + 1);
    int32_t mval = (v < 0 ? -v : v) - 1;
    int pos = base + 2 + sign;
    int32_t mcat;
    if (mval == 0) {
        e.encode(0, st + pos);
        mcat = 0;
    } else {
        e.encode(1, st + pos);
        int k = floor_log2_i32(mval);
        pos = db_large ? 129 : 100;
        for (int i = 0; i < k; ++i) e.encode(1, st + pos + i);
        e.encode(0, st + pos + k);
        pos += k;
        mcat = 1 << k;
    }
    pos += 14;
    for (int32_t m = mcat >> 1; m != 0; m >>= 1) {
        e.encode((mval & m) ? 1 : 0, st + pos);
    }
}

extern "C" {

int jpx_decode_lossless_arith(
    const uint8_t* data,
    const int64_t* span_starts, const int64_t* span_ends, int32_t n_spans,
    int64_t restart_interval,
    int64_t mcus_per_line, int64_t mcus_per_column,
    int32_t n_comps,
    const int32_t* comp_h, const int32_t* comp_v,
    const int32_t* table_ids,
    const int32_t* cond_lo, const int32_t* cond_hi,
    int16_t** planes, const int64_t* plane_widths,
    int32_t predictor_sel, int32_t initial_prediction) {
    if (n_comps <= 0 || n_spans <= 0) return 3;

    // Statistics shared per table selector.
    uint8_t stats_by_id[16][H2_STATS];
    memset(stats_by_id, 0, sizeof(stats_by_id));
    std::vector<uint8_t*> stats(n_comps);
    std::vector<std::vector<int32_t>> diffs(n_comps);
    for (int i = 0; i < n_comps; ++i) {
        int tid = table_ids[i] & 15;
        stats[i] = stats_by_id[tid];
        diffs[i].assign((size_t)(mcus_per_column * comp_v[i]) *
                            (size_t)plane_widths[i],
                        0);
    }

    int span_idx = 0;
    BitReader br;
    br.init(data + span_starts[0], span_ends[0] - span_starts[0]);
    ArithState s;
    s.reset();
    int64_t mcus_before_restart = restart_interval;

    for (int64_t row_mcu = 0; row_mcu < mcus_per_column; ++row_mcu) {
        for (int64_t col_mcu = 0; col_mcu < mcus_per_line; ++col_mcu) {
            bool at_restart_start =
                restart_interval > 0 && mcus_before_restart == restart_interval;
            for (int ci = 0; ci < n_comps; ++ci) {
                int h = comp_h[ci], v = comp_v[ci];
                int64_t width = plane_widths[ci];
                int16_t* plane = planes[ci];
                int32_t* dplane = diffs[ci].data();
                uint8_t* st = stats[ci];
                int32_t lo = cond_lo[ci], hi = cond_hi[ci];
                int64_t offset_x = col_mcu * h;
                int64_t offset_y = row_mcu * v;
                for (int y = 0; y < v; ++y) {
                    int64_t row = offset_y + y;
                    int16_t* scanline = plane + row * width;
                    const int16_t* lastline =
                        (y == 0 && row_mcu == 0) ? nullptr
                                                 : plane + (row - 1) * width;
                    int32_t* drow = dplane + row * width;
                    const int32_t* dlast =
                        row == 0 ? nullptr : dplane + (row - 1) * width;
                    for (int x = 0; x < h; ++x) {
                        int64_t cx = offset_x + x;
                        int32_t da = cx > 0 ? drow[cx - 1] : 0;
                        int32_t db = dlast ? dlast[cx] : 0;
                        int qa = h2_classify(da, lo, hi);
                        int qb = h2_classify(db, lo, hi);
                        int32_t diff;
                        int rc = h2_decode_diff(s, br, st, 4 * (qb * 5 + qa),
                                                qb >= 3, &diff);
                        if (rc != 0) return rc;
                        drow[cx] = diff;
                        int pred;
                        if (row_mcu == 0 || at_restart_start) {
                            if (col_mcu == 0 && x == 0) {
                                pred = initial_prediction;
                            } else {
                                int ra = scanline[cx - 1];
                                int rb = y == 0 ? initial_prediction : lastline[cx];
                                int rc2 = y == 0 ? initial_prediction : lastline[cx - 1];
                                pred = predict_lossless(predictor_sel, ra, rb, rc2);
                            }
                        } else if (col_mcu == 0) {
                            pred = predictor_sel ? lastline[cx] : 0;
                        } else {
                            int ra = scanline[cx - 1];
                            int rb = lastline[cx];
                            int rc2 = lastline[cx - 1];
                            pred = predict_lossless(predictor_sel, ra, rb, rc2);
                        }
                        scanline[cx] = (int16_t)(pred + diff);
                    }
                }
            }

            if (restart_interval > 0) {
                if (--mcus_before_restart == 0) {
                    bool last = row_mcu == mcus_per_column - 1 &&
                                col_mcu == mcus_per_line - 1;
                    if (last) return 0;
                    ++span_idx;
                    if (span_idx >= n_spans) return 0;  // tolerated truncation
                    br.init(data + span_starts[span_idx],
                            span_ends[span_idx] - span_starts[span_idx]);
                    s.reset();
                    memset(stats_by_id, 0, sizeof(stats_by_id));
                    // Conditioning history reset: only the rows the
                    // next segment can READ stale diffs from need
                    // zeroing — the partial rows of the next MCU row
                    // plus the row above (Db). Rows further back are
                    // never read again; rows further down are written
                    // before being read. Equivalent to a full zero
                    // (the Python twin's semantics) at O(width) cost.
                    {
                        bool wrap = col_mcu == mcus_per_line - 1;
                        int64_t next_row_mcu = wrap ? row_mcu + 1 : row_mcu;
                        for (int i = 0; i < n_comps; ++i) {
                            int v = comp_v[i];
                            int64_t width = plane_widths[i];
                            int64_t r0 = next_row_mcu * v - 1;
                            if (r0 < 0) r0 = 0;
                            int64_t r1 = next_row_mcu * v + v;  // exclusive
                            int64_t rows = mcus_per_column * v;
                            if (r1 > rows) r1 = rows;
                            if (r1 > r0)
                                memset(diffs[i].data() + r0 * width, 0,
                                       (size_t)(r1 - r0) * width *
                                           sizeof(int32_t));
                        }
                    }
                    mcus_before_restart = restart_interval;
                }
            }
        }
    }
    return 0;
}

// Encode padded per-component sample planes (int32, component
// resolution on the MCU grid) into one entropy stream with inline RSTn
// markers between restart segments. Returns bytes written, or -1 on
// buffer overflow.
int64_t jpx_encode_lossless_arith(
    const int32_t** planes, const int64_t* plane_widths,
    int64_t mcus_per_line, int64_t mcus_per_column,
    int32_t n_comps,
    const int32_t* comp_h, const int32_t* comp_v,
    const int32_t* table_ids,
    const int32_t* cond_lo, const int32_t* cond_hi,
    int32_t predictor_sel, int32_t initial_prediction,
    int32_t point_transform,
    int64_t restart_interval,
    uint8_t* out, int64_t cap) {
    if (n_comps <= 0) return -2;

    uint8_t stats_by_id[16][H2_STATS];
    memset(stats_by_id, 0, sizeof(stats_by_id));
    std::vector<uint8_t*> stats(n_comps);
    std::vector<std::vector<int32_t>> diffs(n_comps);
    std::vector<std::vector<int16_t>> recon(n_comps);
    for (int i = 0; i < n_comps; ++i) {
        stats[i] = stats_by_id[table_ids[i] & 15];
        size_t sz = (size_t)(mcus_per_column * comp_v[i]) *
                    (size_t)plane_widths[i];
        diffs[i].assign(sz, 0);
        recon[i].assign(sz, 0);
    }

    ArithEncoder e;
    e.init(out, cap);
    int64_t mcus_before_restart = restart_interval;
    int restart_idx = 0;

    for (int64_t row_mcu = 0; row_mcu < mcus_per_column; ++row_mcu) {
        for (int64_t col_mcu = 0; col_mcu < mcus_per_line; ++col_mcu) {
            bool at_restart_start =
                restart_interval > 0 && mcus_before_restart == restart_interval;
            for (int ci = 0; ci < n_comps; ++ci) {
                int h = comp_h[ci], v = comp_v[ci];
                int64_t width = plane_widths[ci];
                const int32_t* plane = planes[ci];
                int16_t* rplane = recon[ci].data();
                int32_t* dplane = diffs[ci].data();
                uint8_t* st = stats[ci];
                int32_t lo = cond_lo[ci], hi = cond_hi[ci];
                int64_t offset_x = col_mcu * h;
                int64_t offset_y = row_mcu * v;
                for (int y = 0; y < v; ++y) {
                    int64_t row = offset_y + y;
                    int16_t* scanline = rplane + row * width;
                    const int16_t* lastline =
                        (y == 0 && row_mcu == 0) ? nullptr
                                                 : rplane + (row - 1) * width;
                    int32_t* drow = dplane + row * width;
                    const int32_t* dlast =
                        row == 0 ? nullptr : dplane + (row - 1) * width;
                    for (int x = 0; x < h; ++x) {
                        int64_t cx = offset_x + x;
                        int pred;
                        if (row_mcu == 0 || at_restart_start) {
                            if (col_mcu == 0 && x == 0) {
                                pred = initial_prediction;
                            } else {
                                int ra = scanline[cx - 1];
                                int rb = y == 0 ? initial_prediction : lastline[cx];
                                int rc2 = y == 0 ? initial_prediction : lastline[cx - 1];
                                pred = predict_lossless(predictor_sel, ra, rb, rc2);
                            }
                        } else if (col_mcu == 0) {
                            pred = predictor_sel ? lastline[cx] : 0;
                        } else {
                            int ra = scanline[cx - 1];
                            int rb = lastline[cx];
                            int rc2 = lastline[cx - 1];
                            pred = predict_lossless(predictor_sel, ra, rb, rc2);
                        }
                        int32_t sample = plane[row * width + cx] >> point_transform;
                        int32_t diff = (int16_t)(sample - pred);
                        int32_t da = cx > 0 ? drow[cx - 1] : 0;
                        int32_t db = dlast ? dlast[cx] : 0;
                        int qa = h2_classify(da, lo, hi);
                        int qb = h2_classify(db, lo, hi);
                        h2_encode_diff(e, st, 4 * (qb * 5 + qa), qb >= 3, diff);
                        if (e.overflow) return -1;
                        drow[cx] = diff;
                        scanline[cx] = (int16_t)(pred + diff);
                    }
                }
            }

            if (restart_interval > 0) {
                if (--mcus_before_restart == 0) {
                    bool last = row_mcu == mcus_per_column - 1 &&
                                col_mcu == mcus_per_line - 1;
                    if (!last) {
                        e.flush();
                        if (e.overflow || e.n + 2 > e.cap) return -1;
                        e.out[e.n++] = 0xFF;
                        e.out[e.n++] = (uint8_t)(0xD0 + (restart_idx & 7));
                        ++restart_idx;
                        e.a = 0x10000;
                        e.c = 0;
                        e.ct = 11;
                        e.pending = -1;
                        e.sc = 0;
                        memset(stats_by_id, 0, sizeof(stats_by_id));
                        // Boundary-rows-only conditioning reset (see
                        // the decoder's restart handler for why this
                        // is equivalent to a full zero).
                        {
                            bool wrap = col_mcu == mcus_per_line - 1;
                            int64_t next_row_mcu = wrap ? row_mcu + 1 : row_mcu;
                            for (int i = 0; i < n_comps; ++i) {
                                int v = comp_v[i];
                                int64_t width = plane_widths[i];
                                int64_t r0 = next_row_mcu * v - 1;
                                if (r0 < 0) r0 = 0;
                                int64_t r1 = next_row_mcu * v + v;
                                int64_t rows = mcus_per_column * v;
                                if (r1 > rows) r1 = rows;
                                if (r1 > r0)
                                    memset(diffs[i].data() + r0 * width, 0,
                                           (size_t)(r1 - r0) * width *
                                               sizeof(int32_t));
                            }
                        }
                        mcus_before_restart = restart_interval;
                    }
                }
            }
        }
    }
    e.flush();
    if (e.overflow) return -1;
    return e.n;
}

// Restart-parallel SOF11/SOF15 encode: every restart segment restarts
// the QM registers, statistics AND the Da/Db conditioning history, so
// segments are independent byte-aligned streams. Key invariant making
// this parallelizable: the coder is lossless, so the reconstruction it
// builds incrementally equals the (point-transformed) SOURCE samples —
// precompute that once, then contiguous segment ranges encode on
// separate threads with thread-local diff planes covering only their
// row span (out-of-segment conditioning reads are 0 by the sequential
// coder's boundary-row zeroing semantics). Byte-identical to
// jpx_encode_lossless_arith. Returns bytes written or -1 on overflow.
int64_t jpx_encode_lossless_arith_restart_parallel(
    const int32_t** planes, const int64_t* plane_widths,
    int64_t mcus_per_line, int64_t mcus_per_column,
    int32_t n_comps,
    const int32_t* comp_h, const int32_t* comp_v,
    const int32_t* table_ids,
    const int32_t* cond_lo, const int32_t* cond_hi,
    int32_t predictor_sel, int32_t initial_prediction,
    int32_t point_transform,
    int64_t restart_interval,
    uint8_t* out, int64_t cap, int32_t n_threads) {
    const int64_t ri = restart_interval;
    const int64_t n_mcus = mcus_per_line * mcus_per_column;
    int hw = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;
    if (ri <= 0 || n_comps <= 0 || n_threads <= 1 || n_mcus < 4096 ||
        n_mcus <= ri)
        return jpx_encode_lossless_arith(
            planes, plane_widths, mcus_per_line, mcus_per_column, n_comps,
            comp_h, comp_v, table_ids, cond_lo, cond_hi, predictor_sel,
            initial_prediction, point_transform, restart_interval, out, cap);

    // Shared read-only reconstruction: (int16)(sample >> pt).
    std::vector<std::vector<int16_t>> recon((size_t)n_comps);
    for (int i = 0; i < n_comps; ++i) {
        size_t sz = (size_t)(mcus_per_column * comp_v[i]) *
                    (size_t)plane_widths[i];
        recon[(size_t)i].resize(sz);
        const int32_t* src = planes[i];
        int16_t* dst = recon[(size_t)i].data();
        for (size_t k = 0; k < sz; ++k)
            dst[k] = (int16_t)(src[k] >> point_transform);
    }

    const int64_t n_seg = (n_mcus + ri - 1) / ri;
    int64_t T = std::min<int64_t>(n_threads, n_seg);
    struct Chunk {
        int64_t g0, g1;
        std::unique_ptr<uint8_t[]> buf;
        int64_t cap, n, status;
    };
    std::vector<Chunk> chunks((size_t)T);
    int64_t per = (n_seg + T - 1) / T;
    int64_t total_samples = 0;
    for (int i = 0; i < n_comps; ++i)
        total_samples += (int64_t)comp_h[i] * comp_v[i];
    for (int64_t t = 0; t < T; ++t) {
        chunks[t].g0 = std::min(n_seg, t * per);
        chunks[t].g1 = std::min(n_seg, (t + 1) * per);
        int64_t mcus = std::min(n_mcus, chunks[t].g1 * ri) - chunks[t].g0 * ri;
        if (mcus < 0) mcus = 0;
        chunks[t].cap = mcus * total_samples * 6 +
                        (chunks[t].g1 - chunks[t].g0) * 2 + 4096;
        chunks[t].buf.reset(new uint8_t[(size_t)chunks[t].cap]);
        chunks[t].n = 0;
        chunks[t].status = 0;
    }

    auto work = [&](int64_t t) {
        Chunk& ck = chunks[t];
        if (ck.g0 >= ck.g1) return;
        // Thread-local diff planes covering this range's rows plus one
        // context row above, zeroed; row indices are offset by row_lo.
        int64_t mrow_lo = (ck.g0 * ri) / mcus_per_line;
        int64_t mrow_hi = ((std::min(n_mcus, ck.g1 * ri) - 1)) / mcus_per_line;
        std::vector<std::vector<int32_t>> diffs((size_t)n_comps);
        std::vector<int64_t> row_lo((size_t)n_comps);
        for (int i = 0; i < n_comps; ++i) {
            int v = comp_v[i];
            row_lo[(size_t)i] = mrow_lo * v - 1 < 0 ? 0 : mrow_lo * v - 1;
            int64_t rows = (mrow_hi + 1) * v - row_lo[(size_t)i];
            diffs[(size_t)i].assign(
                (size_t)rows * (size_t)plane_widths[i], 0);
        }
        uint8_t stats_by_id[16][H2_STATS];
        std::vector<uint8_t*> stats((size_t)n_comps);
        int64_t pos = 0;
        for (int64_t g = ck.g0; g < ck.g1; ++g) {
            int64_t m0 = g * ri;
            int64_t m1 = std::min(n_mcus, m0 + ri);
            // Fresh segment: registers + statistics + conditioning
            // history (zero this segment's context rows — the
            // sequential coder's boundary-row reset semantics).
            memset(stats_by_id, 0, sizeof(stats_by_id));
            for (int i = 0; i < n_comps; ++i)
                stats[(size_t)i] = stats_by_id[table_ids[i] & 15];
            {
                int64_t seg_mrow0 = m0 / mcus_per_line;
                int64_t seg_mrow1 = (m1 - 1) / mcus_per_line;
                for (int i = 0; i < n_comps; ++i) {
                    int v = comp_v[i];
                    int64_t width = plane_widths[i];
                    int64_t r0 = seg_mrow0 * v - 1;
                    if (r0 < row_lo[(size_t)i]) r0 = row_lo[(size_t)i];
                    int64_t r1 = (seg_mrow1 + 1) * v;
                    memset(diffs[(size_t)i].data() +
                               (r0 - row_lo[(size_t)i]) * width,
                           0, (size_t)(r1 - r0) * width * sizeof(int32_t));
                }
            }
            ArithEncoder e;
            e.init(ck.buf.get() + pos, ck.cap - pos);
            for (int64_t m = m0; m < m1; ++m) {
                int64_t row_mcu = m / mcus_per_line;
                int64_t col_mcu = m % mcus_per_line;
                bool at_restart_start = m == m0;
                for (int ci = 0; ci < n_comps; ++ci) {
                    int h = comp_h[ci], v = comp_v[ci];
                    int64_t width = plane_widths[ci];
                    const int16_t* rplane = recon[(size_t)ci].data();
                    int32_t* dplane = diffs[(size_t)ci].data();
                    int64_t rl = row_lo[(size_t)ci];
                    uint8_t* st = stats[(size_t)ci];
                    int32_t lo = cond_lo[ci], hi = cond_hi[ci];
                    int64_t offset_x = col_mcu * h;
                    int64_t offset_y = row_mcu * v;
                    for (int y = 0; y < v; ++y) {
                        int64_t row = offset_y + y;
                        const int16_t* scanline = rplane + row * width;
                        const int16_t* lastline =
                            (y == 0 && row_mcu == 0)
                                ? nullptr
                                : rplane + (row - 1) * width;
                        int32_t* drow = dplane + (row - rl) * width;
                        const int32_t* dlast =
                            row == 0 ? nullptr
                                     : dplane + (row - 1 - rl) * width;
                        for (int x = 0; x < h; ++x) {
                            int64_t cx = offset_x + x;
                            int pred;
                            if (row_mcu == 0 || at_restart_start) {
                                if (col_mcu == 0 && x == 0) {
                                    pred = initial_prediction;
                                } else {
                                    int ra = scanline[cx - 1];
                                    int rb = y == 0 ? initial_prediction
                                                    : lastline[cx];
                                    int rc2 = y == 0 ? initial_prediction
                                                     : lastline[cx - 1];
                                    pred = predict_lossless(predictor_sel, ra,
                                                            rb, rc2);
                                }
                            } else if (col_mcu == 0) {
                                pred = predictor_sel ? lastline[cx] : 0;
                            } else {
                                int ra = scanline[cx - 1];
                                int rb = lastline[cx];
                                int rc2 = lastline[cx - 1];
                                pred = predict_lossless(predictor_sel, ra, rb,
                                                        rc2);
                            }
                            int32_t sample = scanline[cx];  // recon == source
                            int32_t diff = (int16_t)(sample - pred);
                            int32_t da = cx > 0 ? drow[cx - 1] : 0;
                            int32_t db = dlast ? dlast[cx] : 0;
                            int qa = h2_classify(da, lo, hi);
                            int qb = h2_classify(db, lo, hi);
                            h2_encode_diff(e, st, 4 * (qb * 5 + qa), qb >= 3,
                                           diff);
                            if (e.overflow) { ck.status = -1; return; }
                            drow[cx] = diff;
                        }
                    }
                }
            }
            e.flush();
            if (e.overflow) { ck.status = -1; return; }
            pos += e.n;
            if (g < n_seg - 1) {
                if (pos + 2 > ck.cap) { ck.status = -1; return; }
                ck.buf[pos++] = 0xFF;
                ck.buf[pos++] = (uint8_t)(0xD0 + ((g) & 7));
            }
        }
        ck.n = pos;
    };
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < T; ++t) pool.emplace_back(work, t);
    for (auto& th : pool) th.join();
    int64_t total = 0;
    for (auto& ck : chunks) {
        if (ck.status < 0) return ck.status;
        total += ck.n;
    }
    if (total > cap) return -1;
    int64_t off = 0;
    for (auto& ck : chunks) {
        std::memcpy(out + off, ck.buf.get(), (size_t)ck.n);
        off += ck.n;
    }
    return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Restart-parallel arithmetic lossless decode (SOF11/SOF15)
// ---------------------------------------------------------------------------
//
// Each restart span's QM stream is fully self-contained (registers,
// statistics AND the Da/Db conditioning history reset), so spans
// decode diffs concurrently; out-of-span conditioning reads are 0 by
// the sequential decoder's boundary-row zeroing semantics, which here
// falls out of indexing (a span only ever reads its own writes).
// Reconstruction reuses the bit-free prediction pass structure of
// jpx_decode_lossless_restart_parallel. 1x1 sampling only (wrapper
// gates). Returns 0 ok, 2 invalid code, 3 bad args.

extern "C" {

int jpx_decode_lossless_arith_restart_parallel(
    const uint8_t* data,
    const int64_t* span_starts, const int64_t* span_ends, int32_t n_spans,
    int64_t restart_interval,
    int64_t mcus_per_line, int64_t mcus_per_column,
    int32_t n_comps,
    const int32_t* table_ids,
    const int32_t* cond_lo, const int32_t* cond_hi,
    int16_t** planes, const int64_t* plane_widths,
    int32_t predictor_sel, int32_t initial_prediction,
    int32_t n_threads) {
    if (n_comps <= 0 || n_comps > 4 || restart_interval <= 0) return 3;
    const int64_t total_mcus = mcus_per_line * mcus_per_column;

    struct Span {
        int64_t start, end, first_mcu, n_mcus;
    };
    std::vector<Span> spans;
    {
        int64_t mcu = 0;
        for (int32_t s = 0; s < n_spans && mcu < total_mcus; ++s) {
            int64_t nm = std::min<int64_t>(restart_interval, total_mcus - mcu);
            spans.push_back({span_starts[s], span_ends[s], mcu, nm});
            mcu += nm;
        }
    }

    std::unique_ptr<int16_t[]> diffs(new int16_t[(size_t)(total_mcus * n_comps)]);
    std::memset(diffs.get(), 0, (size_t)(total_mcus * n_comps) * sizeof(int16_t));

    int hw = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;
    int T = std::min<int>(n_threads, (int)spans.size());

    std::vector<int> results(spans.size(), 0);
    auto decode_span = [&](const Span& sp, int& rc_out) {
        BitReader br;
        br.init(data + sp.start, sp.end - sp.start);
        ArithState s;
        s.reset();
        uint8_t stats_by_id[16][H2_STATS];
        memset(stats_by_id, 0, sizeof(stats_by_id));
        int16_t* out = diffs.get() + sp.first_mcu * n_comps;
        for (int64_t m = 0; m < sp.n_mcus; ++m) {
            int64_t flat = sp.first_mcu + m;
            int64_t col = flat % mcus_per_line;
            for (int ci = 0; ci < n_comps; ++ci) {
                // In-span conditioning neighbors only; everything else
                // reads as 0 (the sequential boundary-zero semantics).
                int32_t da = (col > 0 && m >= 1) ? out[(m - 1) * n_comps + ci] : 0;
                int32_t db = (m >= mcus_per_line) ? out[(m - mcus_per_line) * n_comps + ci] : 0;
                int qa = h2_classify(da, cond_lo[ci], cond_hi[ci]);
                int qb = h2_classify(db, cond_lo[ci], cond_hi[ci]);
                int32_t d;
                int rc = h2_decode_diff(s, br, stats_by_id[table_ids[ci] & 15],
                                        4 * (qb * 5 + qa), qb >= 3, &d);
                if (rc) { rc_out = rc; return; }
                out[m * n_comps + ci] = (int16_t)d;
            }
        }
        rc_out = 0;
    };
    if (T <= 1) {
        for (size_t k = 0; k < spans.size(); ++k) decode_span(spans[k], results[k]);
    } else {
        std::vector<std::thread> pool;
        for (int tid = 0; tid < T; ++tid) {
            pool.emplace_back([&, tid]() {
                for (size_t k = tid; k < spans.size(); k += T)
                    decode_span(spans[k], results[k]);
            });
        }
        for (auto& th : pool) th.join();
    }
    for (int rc : results)
        if (rc) return rc;

    // Reconstruction: bit-free prediction pass per component.
    std::vector<std::thread> pool;
    for (int ci = 0; ci < n_comps; ++ci) {
        pool.emplace_back([&, ci]() {
            ll_reconstruct_plane(predictor_sel, planes[ci], plane_widths[ci],
                                 diffs.get(), n_comps, ci,
                                 mcus_per_line, mcus_per_column,
                                 restart_interval, initial_prediction);
        });
    }
    for (auto& th : pool) th.join();
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused baseline RGB encode (host hot path)
// ---------------------------------------------------------------------------
//
// One threaded stripe pass over the whole encode transform: fixed-point
// RGB->YCbCr (bit-identical to jpx_rgb_to_ycbcr), zero-pad to the luma
// MCU grid (pad_to_grid semantics), chroma box subsample
// (jpx_box_subsample rounding), AAN FDCT + quantize (the exact
// jpx_fdct_quantize dataflow), with coefficients written directly in
// the interleaved-MCU walk order (mcu_order_blocks layout,
// JpegEncoder.cs:512-536). The staged pipeline reads/writes full
// Y/Cb/Cr planes three times; this pass reads the RGB input once and
// keeps every intermediate stripe L2-resident. Output scans are
// byte-identical to the staged path by construction (same integer
// color transform, same box rounding, same IEEE float op order with
// -ffp-contract=off).
//
// Two entry points share the stripe machinery:
//  - jpx_encode_transform_rgb: transform only, emitting global
//    MCU-ordered block arrays (the 2-pass/optimize-coding input).
//  - jpx_encode_rgb_baseline: transform + Huffman scan emission fused
//    in one pass — coefficients never leave the stripe buffer, so a
//    fixed-table encode touches the image bytes exactly once.

namespace {

// FDCT + quantize one 8x8 block from a uint8 row-major buffer
// (stride elements per row), writing 64 zig-zag int16 coefficients.
// Identical arithmetic to the jpx_fdct_quantize inner loop, but the
// divide+round runs in NATURAL order over a quant table pre-permuted
// to natural order (quant_nat[nat] == quant_zz[zz]) so it vectorizes
// (the zig-zag gather otherwise forces 64 scalar divisions); the final
// int16 scatter to zig-zag positions is cheap. Per-element float ops
// are unchanged, so results are bit-identical.
static inline void fdct_block_u8(const uint8_t* src, int64_t stride,
                                 const float* quant_nat,
                                 const uint8_t* zz_to_nat,
                                 float level_shift, int16_t* dst) {
    float blk[8][8], tmp[8][8], f[8][8];
    for (int r = 0; r < 8; ++r) {
        const uint8_t* row = src + r * stride;
        for (int c = 0; c < 8; ++c) blk[r][c] = (float)row[c] - level_shift;
    }
    transpose8(blk, tmp);
    fdct_pass(tmp, f);
    transpose8(f, tmp);
    fdct_pass(tmp, f);
    int32_t q[64];
    const float* ff = &f[0][0];
    for (int i = 0; i < 64; ++i)
        q[i] = (int32_t)nearbyintf(ff[i] * 0.125f / quant_nat[i]);
    for (int zz = 0; zz < 64; ++zz) dst[zz] = (int16_t)q[zz_to_nat[zz]];
}

struct RgbEncCtx {
    const uint8_t* rgb;
    int64_t h, w;
    int32_t max_h, max_v;
    int64_t mcl, mcc, full_w;
    int stripe_h, per_mcu_y;
    int32_t box_n, box_delta;
    int32_t yr, yg, yb, cbr, cbg, cbb, crg, crb;
    float qn_y[64], qn_cb[64], qn_cr[64];
    const uint8_t* zz;
};

static const int32_t kCcHalf = 1 << 15;
static const int32_t kCcFudge = (128 << 16) + kCcHalf - 1;

static void rgb_ctx_init(RgbEncCtx& c, const uint8_t* rgb, int64_t h,
                         int64_t w, int32_t max_h, int32_t max_v,
                         const float* quant_y, const float* quant_cb,
                         const float* quant_cr, const uint8_t* zz_to_nat,
                         const int32_t* cconsts) {
    c.rgb = rgb;
    c.h = h;
    c.w = w;
    c.max_h = max_h;
    c.max_v = max_v;
    c.mcl = (w + 8 * max_h - 1) / (8 * max_h);
    c.mcc = (h + 8 * max_v - 1) / (8 * max_v);
    c.full_w = c.mcl * 8 * max_h;
    c.stripe_h = 8 * max_v;
    c.per_mcu_y = max_h * max_v;
    c.box_n = max_h * max_v;
    c.box_delta = c.box_n / 2;
    c.yr = cconsts[0]; c.yg = cconsts[1]; c.yb = cconsts[2];
    c.cbr = cconsts[3]; c.cbg = cconsts[4]; c.cbb = cconsts[5];
    c.crg = cconsts[6]; c.crb = cconsts[7];
    // Natural-order divisor tables so the per-block quantize loop
    // vectorizes (see fdct_block_u8).
    for (int zz = 0; zz < 64; ++zz) {
        c.qn_y[zz_to_nat[zz]] = quant_y[zz];
        c.qn_cb[zz_to_nat[zz]] = quant_cb[zz];
        c.qn_cr[zz_to_nat[zz]] = quant_cr[zz];
    }
    c.zz = zz_to_nat;
}

// Per-thread stripe-local planes, zero-filled at init: the zero padding
// regions (right of w, below h) are never overwritten because the
// convert loop only touches real pixels, matching pad_to_grid's zero
// fill. `dirty` tracks whether a full stripe has overwritten the fill
// (the partial bottom stripe then restores it).
struct RgbStripeScratch {
    std::vector<uint8_t> ybuf, cbbuf, crbuf, subcb, subcr;
    bool dirty = false;
    void init(const RgbEncCtx& c) {
        ybuf.assign((size_t)c.stripe_h * c.full_w, 0);
        cbbuf.assign((size_t)c.stripe_h * c.full_w, 0);
        crbuf.assign((size_t)c.stripe_h * c.full_w, 0);
        subcb.resize((size_t)8 * c.mcl * 8);
        subcr.resize((size_t)8 * c.mcl * 8);
        dirty = false;
    }
};

// Convert the RGB rows of stripe `s` into the scratch Y/Cb/Cr planes.
static void convert_stripe_rgb(const RgbEncCtx& c, RgbStripeScratch& sc,
                               int64_t s) {
    const int64_t y0 = s * c.stripe_h;
    const int64_t rows = std::min<int64_t>(c.stripe_h, c.h - y0);
    if (rows < c.stripe_h && sc.dirty) {
        // partial bottom stripe: restore the zero fill that a previous
        // full stripe in this thread overwrote
        std::fill(sc.ybuf.begin(), sc.ybuf.end(), 0);
        std::fill(sc.cbbuf.begin(), sc.cbbuf.end(), 0);
        std::fill(sc.crbuf.begin(), sc.crbuf.end(), 0);
    }
    sc.dirty = true;
    for (int64_t r = 0; r < rows; ++r) {
        const uint8_t* src = c.rgb + ((y0 + r) * c.w) * 3;
        uint8_t* yd = sc.ybuf.data() + r * c.full_w;
        uint8_t* cbd = sc.cbbuf.data() + r * c.full_w;
        uint8_t* crd = sc.crbuf.data() + r * c.full_w;
        // Deinterleave a chunk into channel lanes, then run the
        // fixed-point transform over the lanes — the arithmetic loop
        // vectorizes 8/16-wide where the interleaved form forced
        // scalar code. Integer ops: bit-identical to jpx_rgb_to_ycbcr.
        int32_t rr[64], gg[64], bb[64];
        for (int64_t x = 0; x < c.w;) {
            int64_t n = std::min<int64_t>(64, c.w - x);
            const uint8_t* p = src + 3 * x;
            for (int64_t j = 0; j < n; ++j) {
                rr[j] = p[3 * j];
                gg[j] = p[3 * j + 1];
                bb[j] = p[3 * j + 2];
            }
            for (int64_t j = 0; j < n; ++j) {
                yd[x + j] = (uint8_t)((c.yr * rr[j] + c.yg * gg[j] + (c.yb * bb[j] + kCcHalf)) >> 16);
                cbd[x + j] = (uint8_t)((c.cbr * rr[j] + c.cbg * gg[j] + (c.cbb * bb[j] + kCcFudge)) >> 16);
                crd[x + j] = (uint8_t)(((c.cbb * rr[j] + kCcFudge) + c.crg * gg[j] + c.crb * bb[j]) >> 16);
            }
            x += n;
        }
    }
}

// Transform stripe `s` (convert + subsample + FDCT + quantize).
// Output layout per MCU column `col` of the stripe:
//   Y block k  -> y_base  + col * y_colstride  + k * 64
//   Cb block   -> cb_base + col * cb_colstride
//   Cr block   -> cr_base + col * cr_colstride
// (strides in int16 elements), which expresses both the global
// MCU-ordered arrays and the interleaved per-stripe layout the fused
// emitter walks.
static void transform_stripe_rgb(const RgbEncCtx& c, RgbStripeScratch& sc,
                                 int64_t s,
                                 int16_t* y_base, int64_t y_colstride,
                                 int16_t* cb_base, int64_t cb_colstride,
                                 int16_t* cr_base, int64_t cr_colstride) {
    convert_stripe_rgb(c, sc, s);
    // Luma: max_v block rows of mcl*max_h blocks, written in MCU walk
    // order (k = block_row * max_h + block_col % max_h).
    for (int br = 0; br < c.max_v; ++br) {
        for (int64_t bc = 0; bc < c.mcl * c.max_h; ++bc) {
            int16_t* dst = y_base + (bc / c.max_h) * y_colstride +
                           ((int64_t)br * c.max_h + bc % c.max_h) * 64;
            fdct_block_u8(sc.ybuf.data() + (int64_t)br * 8 * c.full_w + bc * 8,
                          c.full_w, c.qn_y, c.zz, 128.0f, dst);
        }
    }
    // Chroma: box subsample the stripe to one 8-row band, then one
    // block row of mcl blocks per channel. Box sums fit uint8 after
    // the round-half-up divide.
    for (int ch = 0; ch < 2; ++ch) {
        const uint8_t* plane = ch == 0 ? sc.cbbuf.data() : sc.crbuf.data();
        uint8_t* sub = ch == 0 ? sc.subcb.data() : sc.subcr.data();
        if (c.box_n == 1) {
            sub = const_cast<uint8_t*>(plane);
        } else {
            for (int oy = 0; oy < 8; ++oy) {
                uint8_t* orow = sub + (int64_t)oy * c.mcl * 8;
                for (int64_t ox = 0; ox < c.mcl * 8; ++ox) {
                    int32_t sum = 0;
                    for (int dy = 0; dy < c.max_v; ++dy) {
                        const uint8_t* irow = plane +
                            ((int64_t)oy * c.max_v + dy) * c.full_w + ox * c.max_h;
                        for (int dx = 0; dx < c.max_h; ++dx) sum += irow[dx];
                    }
                    orow[ox] = (uint8_t)((sum + c.box_delta) / c.box_n);
                }
            }
        }
        const float* q = ch == 0 ? c.qn_cb : c.qn_cr;
        int16_t* base = ch == 0 ? cb_base : cr_base;
        int64_t stride = ch == 0 ? cb_colstride : cr_colstride;
        for (int64_t bc = 0; bc < c.mcl; ++bc) {
            fdct_block_u8(sub + bc * 8, c.mcl * 8, q, c.zz, 128.0f,
                          base + bc * stride);
        }
    }
}

// Quantized DC values of MCU (s, col) in scan order position — the
// predictor seeds a parallel emitter chunk needs from its predecessor
// chunk's LAST MCU: component 0 takes the last Y block (block row
// max_v-1, col max_h-1), then Cb, Cr. Exactness: the AAN butterfly's
// f[0][0] is the plain sample sum (every intermediate is an integer
// < 2^24, so each float add is exact), hence quantized DC ==
// nearbyintf(sum * 0.125f / q[0]) computed directly.
static void boundary_mcu_dc(const RgbEncCtx& c, int64_t s, int64_t col,
                            int32_t dc[3]) {
    const int pw = 8 * c.max_h;           // patch width (one MCU)
    const int ph = c.stripe_h;            // patch height
    uint8_t py[64 * 16], pcb[64 * 16], pcr[64 * 16];  // up to 4x4 sampling
    std::memset(py, 0, (size_t)ph * pw);
    std::memset(pcb, 0, (size_t)ph * pw);
    std::memset(pcr, 0, (size_t)ph * pw);
    const int64_t y0 = s * (int64_t)c.stripe_h;
    const int64_t x0 = col * (int64_t)pw;
    const int64_t rows = std::min<int64_t>(ph, c.h - y0);
    const int64_t cols = std::min<int64_t>(pw, c.w - x0);
    for (int64_t r = 0; r < rows; ++r) {
        const uint8_t* src = c.rgb + ((y0 + r) * c.w + x0) * 3;
        for (int64_t x = 0; x < cols; ++x) {
            int32_t rr = src[3 * x], gg = src[3 * x + 1], bb = src[3 * x + 2];
            py[r * pw + x] = (uint8_t)((c.yr * rr + c.yg * gg + (c.yb * bb + kCcHalf)) >> 16);
            pcb[r * pw + x] = (uint8_t)((c.cbr * rr + c.cbg * gg + (c.cbb * bb + kCcFudge)) >> 16);
            pcr[r * pw + x] = (uint8_t)(((c.cbb * rr + kCcFudge) + c.crg * gg + c.crb * bb) >> 16);
        }
    }
    // Last Y block of the MCU.
    int64_t sum = 0;
    for (int r = 0; r < 8; ++r) {
        const uint8_t* row = py + ((c.max_v - 1) * 8 + r) * pw + (c.max_h - 1) * 8;
        for (int x = 0; x < 8; ++x) sum += (int32_t)row[x] - 128;
    }
    dc[0] = (int32_t)nearbyintf((float)sum * 0.125f / c.qn_y[0]);
    // Chroma blocks: 8x8 after box subsample of the whole patch.
    for (int ch = 0; ch < 2; ++ch) {
        const uint8_t* plane = ch == 0 ? pcb : pcr;
        int64_t csum = 0;
        for (int oy = 0; oy < 8; ++oy) {
            for (int ox = 0; ox < 8; ++ox) {
                int32_t bsum = 0;
                for (int dy = 0; dy < c.max_v; ++dy) {
                    const uint8_t* irow = plane + (oy * c.max_v + dy) * pw + ox * c.max_h;
                    for (int dx = 0; dx < c.max_h; ++dx) bsum += irow[dx];
                }
                csum += (bsum + c.box_delta) / c.box_n - 128;
            }
        }
        dc[1 + ch] = (int32_t)nearbyintf(
            (float)csum * 0.125f / (ch == 0 ? c.qn_cb[0] : c.qn_cr[0]));
    }
}

// Unstuffed bit sink with the 32-bit bulk flush (same byte stream as
// RawPacker in emit_chunk_unstuffed).
struct RawSink {
    uint8_t* out;
    int64_t cap;
    int64_t n;
    uint64_t reg;
    int bits;
    inline bool write(uint32_t value, int length) {
        if (length == 0) return true;
        reg = (reg << length) | (value & ((1u << length) - 1));
        bits += length;
        if (bits >= 32) {
            bits -= 32;
            if (n + 4 > cap) return false;
            uint32_t be = __builtin_bswap32((uint32_t)(reg >> bits));
            std::memcpy(out + n, &be, 4);
            n += 4;
            reg &= ((uint64_t)1 << bits) - 1;
        }
        return true;
    }
    // Flush the residue; returns total bits emitted (the tail byte is
    // left-justified like emit_chunk_unstuffed's).
    int64_t finish_unstuffed() {
        int64_t total = n * 8 + bits;
        while (bits >= 8) {
            bits -= 8;
            if (n >= cap) return -1;
            out[n++] = (uint8_t)(reg >> bits);
        }
        if (bits > 0) {
            if (n >= cap) return -1;
            out[n++] = (uint8_t)(reg << (8 - bits));
        }
        return total;
    }
};

// Huffman-emit one block against any sink exposing write(value, len).
template <class Sink>
static inline bool emit_block_sink(Sink& bp, const uint16_t* dc_codes,
                                   const uint8_t* dc_sizes,
                                   const uint16_t* ac_codes,
                                   const uint8_t* ac_sizes,
                                   int32_t& predictor, const int16_t* block,
                                   bool* missing) {
    auto emit_rl = [&](const uint16_t* codes, const uint8_t* sizes, int run,
                       int value) -> bool {
        int a = value, b = value;
        if (a < 0) { a = -value; b = value - 1; }
        int bit_count = a ? 32 - __builtin_clz((unsigned)a) : 0;
        int symbol = (run << 4) | bit_count;
        int size = sizes[symbol];
        if (size == 0) { *missing = true; return false; }
        uint32_t v = ((uint32_t)codes[symbol] << bit_count) |
                     ((uint32_t)b & ((1u << bit_count) - 1));
        return bp.write(v, size + bit_count);
    };
    int value = block[0];
    int t = value - predictor;
    predictor = value;
    if (!emit_rl(dc_codes, dc_sizes, 0, t)) return false;
    int run = 0;
    for (int i = 1; i < 64; ++i) {
        int v = block[i];
        if (v == 0) { ++run; continue; }
        while (run > 15) {
            if (ac_sizes[0xF0] == 0) { *missing = true; return false; }
            if (!bp.write(ac_codes[0xF0], ac_sizes[0xF0])) return false;
            run -= 16;
        }
        if (!emit_rl(ac_codes, ac_sizes, run, v)) return false;
        run = 0;
    }
    if (run > 0) {
        if (ac_sizes[0] == 0) { *missing = true; return false; }
        if (!bp.write(ac_codes[0], ac_sizes[0])) return false;
    }
    return true;
}

// DC/AC symbol histogram for one MCU-ordered block — the per-block
// body of jpx_symbol_histograms / ops.encode_stage
// .dc_ac_symbol_frequencies, so the fused transform can produce the
// optimize-coding statistics without a second pass over the
// coefficient arrays.
static inline void hist_block(const int16_t* b, int32_t& pred,
                              int64_t* dcl, int64_t* acl) {
    int32_t dc = b[0];
    int32_t t = dc - pred;
    pred = dc;
    int32_t a = t < 0 ? -t : t;
    ++dcl[a ? 32 - __builtin_clz((unsigned)a) : 0];
    int run = 0;
    for (int i = 1; i < 64; ++i) {
        int32_t v = b[i];
        if (v == 0) { ++run; continue; }
        while (run > 15) { ++acl[0xF0]; run -= 16; }
        int32_t m = v < 0 ? -v : v;
        ++acl[(run << 4) | (32 - __builtin_clz((unsigned)m))];
        run = 0;
    }
    if (run > 0) ++acl[0];
}

// ---------------------------------------------------------------------------
// 4-component (CMYK / YCCK) stripe machinery — the ink twin of
// convert/transform_stripe_rgb. Component layout (encode_cmyk,
// jcparam.c convention): comp 0 (Y-of-CMY or inverted C) and comp 3
// (inverted K) at (max_h, max_v); comps 1/2 (Cb/Cr or inverted M/Y)
// at 1x1. kbuf is the caller-managed 4th stripe plane (same zero-fill
// discipline as RgbStripeScratch.dirty).
// ---------------------------------------------------------------------------

static void convert_stripe_cmyk(const RgbEncCtx& c, RgbStripeScratch& sc,
                                uint8_t* kbuf, bool& kdirty,
                                const uint8_t* ink, int32_t ycck,
                                int64_t s) {
    const int64_t y0 = s * c.stripe_h;
    const int64_t rows = std::min<int64_t>(c.stripe_h, c.h - y0);
    if (rows < c.stripe_h) {
        if (sc.dirty) {
            std::fill(sc.ybuf.begin(), sc.ybuf.end(), 0);
            std::fill(sc.cbbuf.begin(), sc.cbbuf.end(), 0);
            std::fill(sc.crbuf.begin(), sc.crbuf.end(), 0);
        }
        if (kdirty) std::memset(kbuf, 0, (size_t)c.stripe_h * c.full_w);
    }
    sc.dirty = true;
    kdirty = true;
    for (int64_t r = 0; r < rows; ++r) {
        const uint8_t* src = ink + ((y0 + r) * c.w) * 4;
        uint8_t* d0 = sc.ybuf.data() + r * c.full_w;
        uint8_t* d1 = sc.cbbuf.data() + r * c.full_w;
        uint8_t* d2 = sc.crbuf.data() + r * c.full_w;
        uint8_t* d3 = kbuf + r * c.full_w;
        int32_t rr[64], gg[64], bb[64], kk[64];
        for (int64_t x = 0; x < c.w;) {
            int64_t n = std::min<int64_t>(64, c.w - x);
            const uint8_t* p = src + 4 * x;
            for (int64_t j = 0; j < n; ++j) {
                rr[j] = p[4 * j];
                gg[j] = p[4 * j + 1];
                bb[j] = p[4 * j + 2];
                kk[j] = p[4 * j + 3];
            }
            if (ycck) {
                for (int64_t j = 0; j < n; ++j) {
                    d0[x + j] = (uint8_t)((c.yr * rr[j] + c.yg * gg[j] + (c.yb * bb[j] + kCcHalf)) >> 16);
                    d1[x + j] = (uint8_t)((c.cbr * rr[j] + c.cbg * gg[j] + (c.cbb * bb[j] + kCcFudge)) >> 16);
                    d2[x + j] = (uint8_t)(((c.cbb * rr[j] + kCcFudge) + c.crg * gg[j] + c.crb * bb[j]) >> 16);
                    d3[x + j] = (uint8_t)(255 - kk[j]);
                }
            } else {
                for (int64_t j = 0; j < n; ++j) {
                    d0[x + j] = (uint8_t)(255 - rr[j]);
                    d1[x + j] = (uint8_t)(255 - gg[j]);
                    d2[x + j] = (uint8_t)(255 - bb[j]);
                    d3[x + j] = (uint8_t)(255 - kk[j]);
                }
            }
            x += n;
        }
    }
}

// Transform stripe `s` for the 4-component layout; same base+colstride
// output contract as transform_stripe_rgb, one (base, stride) pair per
// component, expressing both the global MCU-ordered arrays and the
// fused emitter's interleaved per-stripe layout.
static void transform_stripe_cmyk(const RgbEncCtx& c, RgbStripeScratch& sc,
                                  uint8_t* kbuf, bool& kdirty,
                                  const uint8_t* ink, int32_t ycck,
                                  const float* qn3, int64_t s,
                                  int16_t* b0, int64_t cs0,
                                  int16_t* b1, int64_t cs1,
                                  int16_t* b2, int64_t cs2,
                                  int16_t* b3, int64_t cs3) {
    convert_stripe_cmyk(c, sc, kbuf, kdirty, ink, ycck, s);
    struct Full {
        const uint8_t* buf;
        const float* q;
        int16_t* base;
        int64_t cs;
    };
    Full fulls[2] = {{sc.ybuf.data(), c.qn_y, b0, cs0}, {kbuf, qn3, b3, cs3}};
    for (auto& f : fulls) {
        for (int br = 0; br < c.max_v; ++br) {
            for (int64_t bc = 0; bc < c.mcl * c.max_h; ++bc) {
                int16_t* dst = f.base + (bc / c.max_h) * f.cs +
                               ((int64_t)br * c.max_h + bc % c.max_h) * 64;
                fdct_block_u8(f.buf + (int64_t)br * 8 * c.full_w + bc * 8,
                              c.full_w, f.q, c.zz, 128.0f, dst);
            }
        }
    }
    for (int ch = 0; ch < 2; ++ch) {
        const uint8_t* plane = ch == 0 ? sc.cbbuf.data() : sc.crbuf.data();
        uint8_t* sub = ch == 0 ? sc.subcb.data() : sc.subcr.data();
        if (c.box_n == 1) {
            sub = const_cast<uint8_t*>(plane);
        } else {
            for (int oy = 0; oy < 8; ++oy) {
                uint8_t* orow = sub + (int64_t)oy * c.mcl * 8;
                for (int64_t ox = 0; ox < c.mcl * 8; ++ox) {
                    int32_t sum = 0;
                    for (int dy = 0; dy < c.max_v; ++dy) {
                        const uint8_t* irow = plane +
                            ((int64_t)oy * c.max_v + dy) * c.full_w + ox * c.max_h;
                        for (int dx = 0; dx < c.max_h; ++dx) sum += irow[dx];
                    }
                    orow[ox] = (uint8_t)((sum + c.box_delta) / c.box_n);
                }
            }
        }
        const float* q = ch == 0 ? c.qn_cb : c.qn_cr;
        int16_t* base = ch == 0 ? b1 : b2;
        int64_t stride = ch == 0 ? cs1 : cs2;
        for (int64_t bc = 0; bc < c.mcl; ++bc) {
            fdct_block_u8(sub + bc * 8, c.mcl * 8, q, c.zz, 128.0f,
                          base + bc * stride);
        }
    }
}

// Quantized DCs of MCU (s, col), 4-component layout — the chunk
// predictor seeds for the fused CMYK emitter (same exactness argument
// as boundary_mcu_dc: the AAN f[0][0] is the plain integer sample sum).
static void boundary_mcu_dc_cmyk(const RgbEncCtx& c, const uint8_t* ink,
                                 int32_t ycck, const float* qn3,
                                 int64_t s, int64_t col, int32_t dc[4]) {
    const int pw = 8 * c.max_h;
    const int ph = c.stripe_h;
    uint8_t p0[64 * 16], p1[64 * 16], p2[64 * 16], p3[64 * 16];
    std::memset(p0, 0, (size_t)ph * pw);
    std::memset(p1, 0, (size_t)ph * pw);
    std::memset(p2, 0, (size_t)ph * pw);
    std::memset(p3, 0, (size_t)ph * pw);
    const int64_t y0 = s * (int64_t)c.stripe_h;
    const int64_t x0 = col * (int64_t)pw;
    const int64_t rows = std::min<int64_t>(ph, c.h - y0);
    const int64_t cols = std::min<int64_t>(pw, c.w - x0);
    for (int64_t r = 0; r < rows; ++r) {
        const uint8_t* src = ink + ((y0 + r) * c.w + x0) * 4;
        for (int64_t x = 0; x < cols; ++x) {
            int32_t rr = src[4 * x], gg = src[4 * x + 1];
            int32_t bb = src[4 * x + 2], kk = src[4 * x + 3];
            if (ycck) {
                p0[r * pw + x] = (uint8_t)((c.yr * rr + c.yg * gg + (c.yb * bb + kCcHalf)) >> 16);
                p1[r * pw + x] = (uint8_t)((c.cbr * rr + c.cbg * gg + (c.cbb * bb + kCcFudge)) >> 16);
                p2[r * pw + x] = (uint8_t)(((c.cbb * rr + kCcFudge) + c.crg * gg + c.crb * bb) >> 16);
            } else {
                p0[r * pw + x] = (uint8_t)(255 - rr);
                p1[r * pw + x] = (uint8_t)(255 - gg);
                p2[r * pw + x] = (uint8_t)(255 - bb);
            }
            p3[r * pw + x] = (uint8_t)(255 - kk);
        }
    }
    // Full-resolution comps 0/3: last block of the MCU in scan order.
    struct Full { const uint8_t* p; float q0; int idx; };
    Full fulls[2] = {{p0, c.qn_y[0], 0}, {p3, qn3[0], 3}};
    for (auto& f : fulls) {
        int64_t sum = 0;
        for (int r = 0; r < 8; ++r) {
            const uint8_t* row =
                f.p + ((c.max_v - 1) * 8 + r) * pw + (c.max_h - 1) * 8;
            for (int x = 0; x < 8; ++x) sum += (int32_t)row[x] - 128;
        }
        dc[f.idx] = (int32_t)nearbyintf((float)sum * 0.125f / f.q0);
    }
    // 1x1 comps 1/2: one box-subsampled block.
    for (int ch = 0; ch < 2; ++ch) {
        const uint8_t* plane = ch == 0 ? p1 : p2;
        int64_t csum = 0;
        for (int oy = 0; oy < 8; ++oy) {
            for (int ox = 0; ox < 8; ++ox) {
                int32_t bsum = 0;
                for (int dy = 0; dy < c.max_v; ++dy) {
                    const uint8_t* irow =
                        plane + (oy * c.max_v + dy) * pw + ox * c.max_h;
                    for (int dx = 0; dx < c.max_h; ++dx) bsum += irow[dx];
                }
                csum += (bsum + c.box_delta) / c.box_n - 128;
            }
        }
        dc[1 + ch] = (int32_t)nearbyintf(
            (float)csum * 0.125f / (ch == 0 ? c.qn_cb[0] : c.qn_cr[0]));
    }
}

}  // namespace

extern "C" {

// rgb: interleaved uint8 [h, w, 3]. max_h/max_v: luma sampling factors
// (chroma is 1x1, the encode_rgb component layout). quants: three
// [64] float zig-zag divisor tables (Y, Cb, Cr components in frame
// order). Outputs are MCU-walk-ordered int16 block arrays:
// out_y [n_mcus * max_h*max_v, 64], out_cb/out_cr [n_mcus, 64].
// `hists` (optional, else null): int64[3 * 512], per component a
// DC[256] + AC[256] symbol histogram accumulated IN the transform
// pass (same statistics as jpx_symbol_histograms over the outputs —
// thread-boundary DC predictors seed from the predecessor MCU's exact
// DC via boundary_mcu_dc, so no second pass over the coefficients is
// needed for optimize-coding). Caller zeroes the array.
void jpx_encode_transform_rgb(
    const uint8_t* rgb, int64_t h, int64_t w,
    int32_t max_h, int32_t max_v,
    const float* quant_y, const float* quant_cb, const float* quant_cr,
    const uint8_t* zz_to_nat, const int32_t* cconsts,
    int16_t* out_y, int16_t* out_cb, int16_t* out_cr,
    int64_t* hists,
    int32_t n_threads) {
    RgbEncCtx c;
    rgb_ctx_init(c, rgb, h, w, max_h, max_v, quant_y, quant_cb, quant_cr,
                 zz_to_nat, cconsts);

    int hw = (int)std::thread::hardware_concurrency();
    // Whole-pass compute burst with the GIL released: use every core
    // (the per-stage native calls leave one free for the caller, but
    // here the caller is blocked inside this one call anyway).
    if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;
    int64_t T = std::min<int64_t>(n_threads, c.mcc);
    if (c.mcc * c.mcl * c.per_mcu_y < 2048) T = 1;

    std::vector<std::vector<int64_t>> hist_local;
    if (hists) hist_local.assign((size_t)T, std::vector<int64_t>(3 * 512, 0));

    auto work = [&](int64_t t, int64_t s0, int64_t s1) {
        RgbStripeScratch sc;
        sc.init(c);
        int32_t preds[3] = {0, 0, 0};
        if (hists && s0 > 0) boundary_mcu_dc(c, s0 - 1, c.mcl - 1, preds);
        for (int64_t s = s0; s < s1; ++s) {
            transform_stripe_rgb(
                c, sc, s,
                out_y + s * c.mcl * c.per_mcu_y * 64, (int64_t)c.per_mcu_y * 64,
                out_cb + s * c.mcl * 64, 64,
                out_cr + s * c.mcl * 64, 64);
            if (hists) {
                int64_t* hl = hist_local[(size_t)t].data();
                const int16_t* by = out_y + s * c.mcl * c.per_mcu_y * 64;
                for (int64_t i = 0; i < c.mcl * c.per_mcu_y; ++i)
                    hist_block(by + i * 64, preds[0], hl, hl + 256);
                const int16_t* bcb = out_cb + s * c.mcl * 64;
                const int16_t* bcr = out_cr + s * c.mcl * 64;
                for (int64_t i = 0; i < c.mcl; ++i) {
                    hist_block(bcb + i * 64, preds[1], hl + 512, hl + 768);
                    hist_block(bcr + i * 64, preds[2], hl + 1024, hl + 1280);
                }
            }
        }
    };
    if (T <= 1) {
        work(0, 0, c.mcc);
    } else {
        std::vector<std::thread> pool;
        int64_t step = (c.mcc + T - 1) / T;
        for (int64_t t = 0; t < T; ++t) {
            int64_t b = t * step;
            if (b >= c.mcc) break;
            pool.emplace_back(work, t, b, std::min(c.mcc, b + step));
        }
        for (auto& th : pool) th.join();
    }
    if (hists) {
        for (auto& hv : hist_local)
            for (int i = 0; i < 3 * 512; ++i) hists[i] += hv[(size_t)i];
    }
}

// Fused 4-component ink transform (Adobe CMYK / YCCK encode): the
// encode_cmyk transform stage in one threaded stripe pass.
//  ycck == 0: plain CMYK — four 1x1 components storing 255 - ink
//             (max_h == max_v == 1).
//  ycck == 1: YCCK — Y/Cb/Cr from the fixed-point RGB->YCbCr transform
//             applied to the UN-inverted C/M/Y channels (the
//             to_cmyk8/PIL convention), K stored inverted at full
//             (luma) resolution; Cb/Cr box-subsampled like encode_rgb.
// Outputs are MCU-walk-ordered block arrays in frame order:
// out0 (Y or C) and out3 (K) at [n_mcus * max_h*max_v, 64]; out1/out2
// at [n_mcus, 64] (or full-res when plain CMYK). Byte-identical to the
// staged ops.color + forward_component pipeline.
void jpx_encode_transform_cmyk(
    const uint8_t* ink, int64_t h, int64_t w,
    int32_t max_h, int32_t max_v, int32_t ycck,
    const float* quant0, const float* quant1, const float* quant2,
    const float* quant3,
    const uint8_t* zz_to_nat, const int32_t* cconsts,
    int16_t* out0, int16_t* out1, int16_t* out2, int16_t* out3,
    int32_t n_threads) {
    RgbEncCtx c;
    rgb_ctx_init(c, nullptr, h, w, max_h, max_v, quant0, quant1, quant2,
                 zz_to_nat, cconsts);
    float qn3[64];
    for (int zz = 0; zz < 64; ++zz) qn3[zz_to_nat[zz]] = quant3[zz];

    int hw = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;
    int64_t T = std::min<int64_t>(n_threads, c.mcc);
    if (c.mcc * c.mcl * c.per_mcu_y < 2048) T = 1;

    auto work = [&](int64_t s0, int64_t s1) {
        RgbStripeScratch sc;
        sc.init(c);
        std::vector<uint8_t> kbuf((size_t)c.stripe_h * c.full_w, 0);
        bool kdirty = false;
        for (int64_t s = s0; s < s1; ++s) {
            // Global MCU-ordered layouts expressed via the shared
            // base+colstride stripe contract (see transform_stripe_rgb).
            transform_stripe_cmyk(
                c, sc, kbuf.data(), kdirty, ink, ycck, qn3, s,
                out0 + s * c.mcl * c.per_mcu_y * 64, (int64_t)c.per_mcu_y * 64,
                out1 + s * c.mcl * 64, 64,
                out2 + s * c.mcl * 64, 64,
                out3 + s * c.mcl * c.per_mcu_y * 64, (int64_t)c.per_mcu_y * 64);
        }
    };
    if (T <= 1) {
        work(0, c.mcc);
        return;
    }
    std::vector<std::thread> pool;
    int64_t step = (c.mcc + T - 1) / T;
    for (int64_t t = 0; t < T; ++t) {
        int64_t b = t * step;
        if (b >= c.mcc) break;
        pool.emplace_back(work, b, std::min(c.mcc, b + step));
    }
    for (auto& th : pool) th.join();
}

// Fully fused fixed-table baseline scan: transform + Huffman emission
// in one threaded pass (the scan entropy bytes, including RSTn
// separators when restart_interval > 0, land in `out`; headers are the
// caller's). Byte-identical to jpx_encode_transform_rgb +
// jpx_encode_segment_parallel / the per-segment restart loop:
//  - restart_interval == 0: stripe-range chunks emit unstuffed bit
//    streams seeded with the predecessor MCU's exact DC values
//    (boundary_mcu_dc), then merge_stuff_chunks joins them.
//  - restart_interval > 0: segment-range chunks emit stuffed
//    byte-aligned streams with trailing RSTn, concatenated in order.
// dc/ac tables are per component (3). Returns bytes written, -1 on
// capacity overflow, -2 on a missing Huffman code.
int64_t jpx_encode_rgb_baseline(
    const uint8_t* rgb, int64_t h, int64_t w,
    int32_t max_h, int32_t max_v,
    const float* quant_y, const float* quant_cb, const float* quant_cr,
    const uint8_t* zz_to_nat, const int32_t* cconsts,
    const uint16_t** dc_codes, const uint8_t** dc_sizes,
    const uint16_t** ac_codes, const uint8_t** ac_sizes,
    int64_t restart_interval,
    uint8_t* out, int64_t capacity,
    int32_t n_threads) {
    RgbEncCtx c;
    rgb_ctx_init(c, rgb, h, w, max_h, max_v, quant_y, quant_cb, quant_cr,
                 zz_to_nat, cconsts);
    const int64_t n_mcus = c.mcl * c.mcc;
    const int bpm = c.per_mcu_y + 2;  // blocks per MCU in scan order

    int hw = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;

    // Per-chunk worst case: < 256 unstuffed bytes per block (64 codes
    // <= 16 bits + value fields), doubled for stuffing headroom on the
    // restart path.
    auto chunk_cap = [&](int64_t mcus) {
        return mcus * (int64_t)bpm * 512 + 128;
    };

    // comp index for scan-order block k of an MCU
    auto comp_of = [&](int k) { return k < c.per_mcu_y ? 0 : (k - c.per_mcu_y + 1); };

    if (restart_interval <= 0) {
        int64_t T = std::min<int64_t>(n_threads, c.mcc);
        if (n_mcus * c.per_mcu_y < 2048) T = 1;
        struct Chunk {
            int64_t s0, s1;
            std::unique_ptr<uint8_t[]> buf;
            int64_t cap;
            int64_t bits;
            int64_t status;
        };
        std::vector<Chunk> chunks((size_t)T);
        int64_t step = (c.mcc + T - 1) / T;
        for (int64_t t = 0; t < T; ++t) {
            chunks[t].s0 = std::min(c.mcc, t * step);
            chunks[t].s1 = std::min(c.mcc, (t + 1) * step);
            chunks[t].cap = chunk_cap((chunks[t].s1 - chunks[t].s0) * c.mcl);
            chunks[t].buf.reset(new uint8_t[(size_t)chunks[t].cap]);
            chunks[t].bits = 0;
            chunks[t].status = 0;
        }
        auto work = [&](int64_t t) {
            Chunk& ck = chunks[t];
            if (ck.s0 >= ck.s1) return;
            RgbStripeScratch sc;
            sc.init(c);
            std::vector<int16_t> coeff((size_t)c.mcl * bpm * 64);
            RawSink rp{ck.buf.get(), ck.cap, 0, 0, 0};
            int32_t preds[3] = {0, 0, 0};
            if (ck.s0 > 0) boundary_mcu_dc(c, ck.s0 - 1, c.mcl - 1, preds);
            bool missing = false;
            for (int64_t s = ck.s0; s < ck.s1; ++s) {
                transform_stripe_rgb(c, sc, s,
                                     coeff.data(), (int64_t)bpm * 64,
                                     coeff.data() + (int64_t)c.per_mcu_y * 64,
                                     (int64_t)bpm * 64,
                                     coeff.data() + ((int64_t)c.per_mcu_y + 1) * 64,
                                     (int64_t)bpm * 64);
                const int16_t* blockp = coeff.data();
                for (int64_t col = 0; col < c.mcl; ++col) {
                    for (int k = 0; k < bpm; ++k, blockp += 64) {
                        int ci = comp_of(k);
                        if (!emit_block_sink(rp, dc_codes[ci], dc_sizes[ci],
                                             ac_codes[ci], ac_sizes[ci],
                                             preds[ci], blockp, &missing)) {
                            ck.status = missing ? -2 : -1;
                            return;
                        }
                    }
                }
            }
            ck.bits = rp.finish_unstuffed();
            if (ck.bits < 0) ck.status = -1;
        };
        if (T <= 1) {
            work(0);
        } else {
            std::vector<std::thread> pool;
            for (int64_t t = 0; t < T; ++t) pool.emplace_back(work, t);
            for (auto& th : pool) th.join();
        }
        for (auto& ck : chunks)
            if (ck.status < 0) return ck.status;
        std::vector<const uint8_t*> bufs((size_t)T);
        std::vector<int64_t> nbits((size_t)T);
        for (int64_t t = 0; t < T; ++t) {
            bufs[t] = chunks[t].buf.get();
            nbits[t] = chunks[t].bits;
        }
        return merge_stuff_chunks(bufs.data(), nbits.data(), (int)T, out,
                                  capacity);
    }

    // restart_interval > 0: byte-aligned segments, RSTn separators.
    const int64_t ri = restart_interval;
    const int64_t n_seg = (n_mcus + ri - 1) / ri;
    int64_t T = std::min<int64_t>(n_threads, n_seg);
    if (n_mcus * c.per_mcu_y < 2048) T = 1;
    struct SegChunk {
        int64_t g0, g1;
        std::unique_ptr<uint8_t[]> buf;
        int64_t cap;
        int64_t n;
        int64_t status;
    };
    std::vector<SegChunk> chunks((size_t)T);
    int64_t per = (n_seg + T - 1) / T;
    for (int64_t t = 0; t < T; ++t) {
        chunks[t].g0 = std::min(n_seg, t * per);
        chunks[t].g1 = std::min(n_seg, (t + 1) * per);
        int64_t mcus = std::min(n_mcus, chunks[t].g1 * ri) - chunks[t].g0 * ri;
        if (mcus < 0) mcus = 0;
        chunks[t].cap = chunk_cap(mcus) + (chunks[t].g1 - chunks[t].g0) * 2;
        chunks[t].buf.reset(new uint8_t[(size_t)chunks[t].cap]);
        chunks[t].n = 0;
        chunks[t].status = 0;
    }
    auto work = [&](int64_t t) {
        SegChunk& ck = chunks[t];
        if (ck.g0 >= ck.g1) return;
        RgbStripeScratch sc;
        sc.init(c);
        std::vector<int16_t> coeff((size_t)c.mcl * bpm * 64);
        int64_t cached_s = -1;
        BitPacker bp{ck.buf.get(), ck.cap, 0, 0, 0};
        bool missing = false;
        for (int64_t g = ck.g0; g < ck.g1; ++g) {
            int64_t m0 = g * ri;
            int64_t m1 = std::min(n_mcus, m0 + ri);
            int32_t preds[3] = {0, 0, 0};
            for (int64_t m = m0; m < m1; ++m) {
                int64_t s = m / c.mcl;
                int64_t col = m % c.mcl;
                if (s != cached_s) {
                    transform_stripe_rgb(
                        c, sc, s,
                        coeff.data(), (int64_t)bpm * 64,
                        coeff.data() + (int64_t)c.per_mcu_y * 64,
                        (int64_t)bpm * 64,
                        coeff.data() + ((int64_t)c.per_mcu_y + 1) * 64,
                        (int64_t)bpm * 64);
                    cached_s = s;
                }
                const int16_t* blockp = coeff.data() + col * (int64_t)bpm * 64;
                for (int k = 0; k < bpm; ++k, blockp += 64) {
                    int ci = comp_of(k);
                    if (!emit_block_sink(bp, dc_codes[ci], dc_sizes[ci],
                                         ac_codes[ci], ac_sizes[ci],
                                         preds[ci], blockp, &missing)) {
                        ck.status = missing ? -2 : -1;
                        return;
                    }
                }
            }
            if (!bp.finish()) { ck.status = -1; return; }
            if (g < n_seg - 1) {  // RSTn between segments (not after last)
                if (bp.n + 2 > bp.cap) { ck.status = -1; return; }
                bp.out[bp.n++] = 0xFF;
                bp.out[bp.n++] = (uint8_t)(0xD0 + (g & 7));
            }
        }
        ck.n = bp.n;
    };
    if (T <= 1) {
        work(0);
    } else {
        std::vector<std::thread> pool;
        for (int64_t t = 0; t < T; ++t) pool.emplace_back(work, t);
        for (auto& th : pool) th.join();
    }
    int64_t total = 0;
    for (auto& ck : chunks) {
        if (ck.status < 0) return ck.status;
        total += ck.n;
    }
    if (total > capacity) return -1;
    int64_t off = 0;
    for (auto& ck : chunks) {
        std::memcpy(out + off, ck.buf.get(), (size_t)ck.n);
        off += ck.n;
    }
    return total;
}

// Bufferless band encode: one horizontal band of whole MCU rows
// (band-local RGB buffer) -> stuffed scan bytes, with the carried
// state (per-component absolute DC predictors + the partial-byte bit
// remainder) threaded through `state` so a pull-reader caller can
// feed bands sequentially with O(band) host memory and produce a scan
// byte-identical to the whole-image jpx_encode_rgb_baseline. Bands
// MUST be multiples of 8*max_v rows except the last. No restart
// support (restart streams keep the staged path — their segments are
// byte-aligned and do not benefit from carry threading).
//
// state layout (int64[6]):
//   [0..2] per-component absolute DC predictors
//   [3]    bit remainder, LEFT-justified in the low byte
//   [4]    remainder bit count (0..7)
//   [5]    reserved (0)
//
// Returns stuffed bytes written, or -1 capacity / -2 missing code.
int64_t jpx_encode_rgb_band(
    const uint8_t* rgb, int64_t band_h, int64_t w,
    int32_t max_h, int32_t max_v,
    const float* quant_y, const float* quant_cb, const float* quant_cr,
    const uint8_t* zz_to_nat, const int32_t* cconsts,
    const uint16_t** dc_codes, const uint8_t** dc_sizes,
    const uint16_t** ac_codes, const uint8_t** ac_sizes,
    int64_t* state, int32_t is_last,
    uint8_t* out, int64_t capacity,
    int32_t n_threads) {
    RgbEncCtx c;
    rgb_ctx_init(c, rgb, band_h, w, max_h, max_v, quant_y, quant_cb,
                 quant_cr, zz_to_nat, cconsts);
    const int bpm = c.per_mcu_y + 2;

    int hw = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;
    int64_t T = std::min<int64_t>(n_threads, c.mcc);
    if (c.mcc * c.mcl * c.per_mcu_y < 2048) T = 1;

    struct Chunk {
        int64_t s0, s1;
        std::unique_ptr<uint8_t[]> buf;
        int64_t cap;
        int64_t bits;
        int64_t status;
    };
    std::vector<Chunk> chunks((size_t)T);
    int64_t step = (c.mcc + T - 1) / T;
    for (int64_t t = 0; t < T; ++t) {
        chunks[t].s0 = std::min(c.mcc, t * step);
        chunks[t].s1 = std::min(c.mcc, (t + 1) * step);
        // Optimistic capacity (raw band bytes cover natural content
        // severalfold); a chunk that overflows re-runs alone at the
        // worst case below — keeping the steady-state working set
        // O(band), not O(band worst case).
        int64_t raw = (chunks[t].s1 - chunks[t].s0) * 8 * max_v * w * 3;
        chunks[t].cap = raw + 4096;
        chunks[t].buf.reset(new uint8_t[(size_t)chunks[t].cap]);
        chunks[t].bits = 0;
        chunks[t].status = 0;
    }
    auto comp_of = [&](int k) {
        return k < c.per_mcu_y ? 0 : (k - c.per_mcu_y + 1);
    };
    // Snapshot the carried predictors BEFORE launching threads and
    // publish the band-final ones AFTER the join: chunk 0 reads the
    // incoming state and chunk T-1 produces the outgoing one, and with
    // T > 1 those run concurrently (a direct state[] hand-off raced).
    const int32_t preds_in[3] = {
        (int32_t)state[0], (int32_t)state[1], (int32_t)state[2]};
    int32_t preds_out[3] = {preds_in[0], preds_in[1], preds_in[2]};
    auto work = [&](int64_t t) {
        Chunk& ck = chunks[t];
        if (ck.s0 >= ck.s1) return;
        RgbStripeScratch sc;
        sc.init(c);
        std::vector<int16_t> coeff((size_t)c.mcl * bpm * 64);
        RawSink rp{ck.buf.get(), ck.cap, 0, 0, 0};
        int32_t preds[3];
        if (ck.s0 > 0) {
            preds[0] = preds[1] = preds[2] = 0;
            boundary_mcu_dc(c, ck.s0 - 1, c.mcl - 1, preds);
        } else {
            preds[0] = preds_in[0];
            preds[1] = preds_in[1];
            preds[2] = preds_in[2];
        }
        bool missing = false;
        for (int64_t s = ck.s0; s < ck.s1; ++s) {
            transform_stripe_rgb(c, sc, s,
                                 coeff.data(), (int64_t)bpm * 64,
                                 coeff.data() + (int64_t)c.per_mcu_y * 64,
                                 (int64_t)bpm * 64,
                                 coeff.data() + ((int64_t)c.per_mcu_y + 1) * 64,
                                 (int64_t)bpm * 64);
            const int16_t* blockp = coeff.data();
            for (int64_t col = 0; col < c.mcl; ++col) {
                for (int k = 0; k < bpm; ++k, blockp += 64) {
                    int ci = comp_of(k);
                    if (!emit_block_sink(rp, dc_codes[ci], dc_sizes[ci],
                                         ac_codes[ci], ac_sizes[ci],
                                         preds[ci], blockp, &missing)) {
                        ck.status = missing ? -2 : -1;
                        return;
                    }
                }
            }
        }
        ck.bits = rp.finish_unstuffed();
        if (ck.bits < 0) ck.status = -1;
        // Publish the band-final predictors from the chunk that ENDS
        // the band. NOT "t == T-1": ceil-division chunking can leave
        // trailing EMPTY chunks (e.g. mcc=16, T=12 -> step=2 covers
        // the band by chunk 7), and an empty last chunk would return
        // above without publishing — every later band would then
        // encode wrong DC diffs (silent corruption on hosts whose
        // thread count doesn't divide the band's MCU rows).
        if (ck.s1 == c.mcc) {
            preds_out[0] = preds[0];
            preds_out[1] = preds[1];
            preds_out[2] = preds[2];
        }
    };
    if (T <= 1) {
        work(0);
    } else {
        std::vector<std::thread> pool;
        for (int64_t t = 0; t < T; ++t) pool.emplace_back(work, t);
        for (auto& th : pool) th.join();
    }
    for (int64_t t = 0; t < T; ++t) {
        Chunk& ck = chunks[t];
        if (ck.status == -1) {  // optimistic capacity overflow only
            ck.cap = (ck.s1 - ck.s0) * c.mcl * (int64_t)bpm * 512 + 128;
            ck.buf.reset(new uint8_t[(size_t)ck.cap]);
            ck.status = 0;
            ck.bits = 0;
            work(t);  // deterministic: chunks are independent
        }
    }
    for (auto& ck : chunks)
        if (ck.status < 0) return ck.status;
    state[0] = preds_out[0];
    state[1] = preds_out[1];
    state[2] = preds_out[2];

    // Merge with the carried bit remainder seeded in front; stuff
    // only complete bytes unless this is the last band (then 1-pad).
    int64_t total_bits = state[4];
    for (auto& ck : chunks) total_bits += ck.bits;
    std::vector<uint8_t> merged((size_t)((total_bits + 7) / 8) + 8, 0);
    merged[0] = (uint8_t)state[3];
    int64_t off_bits = state[4];
    for (auto& ck : chunks) {
        if (ck.bits == 0) continue;
        int64_t byte_off = off_bits >> 3;
        int shift = (int)(off_bits & 7);
        int64_t nbytes = (ck.bits + 7) / 8;
        if (shift == 0) {
            std::memcpy(merged.data() + byte_off, ck.buf.get(),
                        (size_t)nbytes);
        } else {
            uint8_t* dst = merged.data() + byte_off;
            const uint8_t* src = ck.buf.get();
            uint32_t carry = dst[0] >> (8 - shift);
            for (int64_t j = 0; j < nbytes; ++j) {
                uint32_t v = (carry << (8 - shift)) | (src[j] >> shift);
                dst[j] = (uint8_t)v;
                carry = src[j] & ((1u << shift) - 1);
            }
            dst[nbytes] = (uint8_t)(carry << (8 - shift));
        }
        off_bits += ck.bits;
    }
    if (is_last && (off_bits & 7)) {
        int pad = 8 - (int)(off_bits & 7);
        merged[off_bits >> 3] |= (uint8_t)((1u << pad) - 1);
        off_bits += pad;
    }
    int64_t n_full = off_bits >> 3;
    int64_t n_out = 0;
    for (int64_t i = 0; i < n_full; ++i) {
        if (n_out >= capacity) return -1;
        uint8_t b = merged[(size_t)i];
        out[n_out++] = b;
        if (b == 0xFF) {
            if (n_out >= capacity) return -1;
            out[n_out++] = 0x00;
        }
    }
    state[4] = off_bits & 7;
    state[3] = state[4] ? merged[(size_t)n_full] : 0;
    return n_out;
}

// Fully fused fixed-table 4-component (CMYK / YCCK) baseline scan —
// the ink twin of jpx_encode_rgb_baseline: transform + Huffman
// emission per stripe-range thread in ONE pass, coefficients never
// leave the stripe buffer. Byte-identical to
// jpx_encode_transform_cmyk + jpx_encode_segment_parallel / the
// segmented restart emitter (shared transform_stripe_cmyk +
// emit_block_sink machinery; chunk DC seeds via boundary_mcu_dc_cmyk,
// exact for the same reason as the RGB path). dc/ac table pointer
// arrays carry FOUR entries, in component order.
int64_t jpx_encode_cmyk_baseline(
    const uint8_t* ink, int64_t h, int64_t w,
    int32_t max_h, int32_t max_v, int32_t ycck,
    const float* quant0, const float* quant1, const float* quant2,
    const float* quant3,
    const uint8_t* zz_to_nat, const int32_t* cconsts,
    const uint16_t** dc_codes, const uint8_t** dc_sizes,
    const uint16_t** ac_codes, const uint8_t** ac_sizes,
    int64_t restart_interval,
    uint8_t* out, int64_t capacity,
    int32_t n_threads) {
    RgbEncCtx c;
    rgb_ctx_init(c, nullptr, h, w, max_h, max_v, quant0, quant1, quant2,
                 zz_to_nat, cconsts);
    float qn3[64];
    for (int zz = 0; zz < 64; ++zz) qn3[zz_to_nat[zz]] = quant3[zz];
    const int64_t n_mcus = c.mcl * c.mcc;
    const int bpm = 2 * c.per_mcu_y + 2;  // blocks per MCU in scan order
    const int64_t kb = (int64_t)c.stripe_h * c.full_w;

    int hw = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;

    auto chunk_cap = [&](int64_t mcus) {
        return mcus * (int64_t)bpm * 512 + 128;
    };
    // comp index for scan-order block k of an MCU: comp0 blocks, one
    // Cb, one Cr, comp3 (K) blocks.
    auto comp_of = [&](int k) {
        if (k < c.per_mcu_y) return 0;
        if (k < c.per_mcu_y + 2) return k - c.per_mcu_y + 1;
        return 3;
    };
    // Stripe coeff layout per MCU column (all strides bpm*64).
    auto stripe_transform = [&](RgbStripeScratch& sc, uint8_t* kbuf,
                                bool& kdirty, int16_t* coeff, int64_t s) {
        transform_stripe_cmyk(
            c, sc, kbuf, kdirty, ink, ycck, qn3, s,
            coeff, (int64_t)bpm * 64,
            coeff + (int64_t)c.per_mcu_y * 64, (int64_t)bpm * 64,
            coeff + ((int64_t)c.per_mcu_y + 1) * 64, (int64_t)bpm * 64,
            coeff + ((int64_t)c.per_mcu_y + 2) * 64, (int64_t)bpm * 64);
    };

    if (restart_interval <= 0) {
        int64_t T = std::min<int64_t>(n_threads, c.mcc);
        if (n_mcus * c.per_mcu_y < 2048) T = 1;
        struct Chunk {
            int64_t s0, s1;
            std::unique_ptr<uint8_t[]> buf;
            int64_t cap;
            int64_t bits;
            int64_t status;
        };
        std::vector<Chunk> chunks((size_t)T);
        int64_t step = (c.mcc + T - 1) / T;
        for (int64_t t = 0; t < T; ++t) {
            chunks[t].s0 = std::min(c.mcc, t * step);
            chunks[t].s1 = std::min(c.mcc, (t + 1) * step);
            chunks[t].cap = chunk_cap((chunks[t].s1 - chunks[t].s0) * c.mcl);
            chunks[t].buf.reset(new uint8_t[(size_t)chunks[t].cap]);
            chunks[t].bits = 0;
            chunks[t].status = 0;
        }
        auto work = [&](int64_t t) {
            Chunk& ck = chunks[t];
            if (ck.s0 >= ck.s1) return;
            RgbStripeScratch sc;
            sc.init(c);
            std::vector<uint8_t> kbuf((size_t)kb, 0);
            bool kdirty = false;
            std::vector<int16_t> coeff((size_t)c.mcl * bpm * 64);
            RawSink rp{ck.buf.get(), ck.cap, 0, 0, 0};
            int32_t preds[4] = {0, 0, 0, 0};
            if (ck.s0 > 0)
                boundary_mcu_dc_cmyk(c, ink, ycck, qn3, ck.s0 - 1,
                                     c.mcl - 1, preds);
            bool missing = false;
            for (int64_t s = ck.s0; s < ck.s1; ++s) {
                stripe_transform(sc, kbuf.data(), kdirty, coeff.data(), s);
                const int16_t* blockp = coeff.data();
                for (int64_t col = 0; col < c.mcl; ++col) {
                    for (int k = 0; k < bpm; ++k, blockp += 64) {
                        int ci = comp_of(k);
                        if (!emit_block_sink(rp, dc_codes[ci], dc_sizes[ci],
                                             ac_codes[ci], ac_sizes[ci],
                                             preds[ci], blockp, &missing)) {
                            ck.status = missing ? -2 : -1;
                            return;
                        }
                    }
                }
            }
            ck.bits = rp.finish_unstuffed();
            if (ck.bits < 0) ck.status = -1;
        };
        if (T <= 1) {
            work(0);
        } else {
            std::vector<std::thread> pool;
            for (int64_t t = 0; t < T; ++t) pool.emplace_back(work, t);
            for (auto& th : pool) th.join();
        }
        for (auto& ck : chunks)
            if (ck.status < 0) return ck.status;
        std::vector<const uint8_t*> bufs((size_t)T);
        std::vector<int64_t> nbits((size_t)T);
        for (int64_t t = 0; t < T; ++t) {
            bufs[t] = chunks[t].buf.get();
            nbits[t] = chunks[t].bits;
        }
        return merge_stuff_chunks(bufs.data(), nbits.data(), (int)T, out,
                                  capacity);
    }

    // restart_interval > 0: byte-aligned segments, RSTn separators.
    const int64_t ri = restart_interval;
    const int64_t n_seg = (n_mcus + ri - 1) / ri;
    int64_t T = std::min<int64_t>(n_threads, n_seg);
    if (n_mcus * c.per_mcu_y < 2048) T = 1;
    struct SegChunk {
        int64_t g0, g1;
        std::unique_ptr<uint8_t[]> buf;
        int64_t cap;
        int64_t n;
        int64_t status;
    };
    std::vector<SegChunk> chunks((size_t)T);
    int64_t per = (n_seg + T - 1) / T;
    for (int64_t t = 0; t < T; ++t) {
        chunks[t].g0 = std::min(n_seg, t * per);
        chunks[t].g1 = std::min(n_seg, (t + 1) * per);
        int64_t mcus = std::min(n_mcus, chunks[t].g1 * ri) - chunks[t].g0 * ri;
        if (mcus < 0) mcus = 0;
        chunks[t].cap = chunk_cap(mcus) + (chunks[t].g1 - chunks[t].g0) * 2;
        chunks[t].buf.reset(new uint8_t[(size_t)chunks[t].cap]);
        chunks[t].n = 0;
        chunks[t].status = 0;
    }
    auto work = [&](int64_t t) {
        SegChunk& ck = chunks[t];
        if (ck.g0 >= ck.g1) return;
        RgbStripeScratch sc;
        sc.init(c);
        std::vector<uint8_t> kbuf((size_t)kb, 0);
        bool kdirty = false;
        std::vector<int16_t> coeff((size_t)c.mcl * bpm * 64);
        int64_t cached_s = -1;
        BitPacker bp{ck.buf.get(), ck.cap, 0, 0, 0};
        bool missing = false;
        for (int64_t g = ck.g0; g < ck.g1; ++g) {
            int64_t m0 = g * ri;
            int64_t m1 = std::min(n_mcus, m0 + ri);
            int32_t preds[4] = {0, 0, 0, 0};
            for (int64_t m = m0; m < m1; ++m) {
                int64_t s = m / c.mcl;
                int64_t col = m % c.mcl;
                if (s != cached_s) {
                    stripe_transform(sc, kbuf.data(), kdirty, coeff.data(), s);
                    cached_s = s;
                }
                const int16_t* blockp = coeff.data() + col * (int64_t)bpm * 64;
                for (int k = 0; k < bpm; ++k, blockp += 64) {
                    int ci = comp_of(k);
                    if (!emit_block_sink(bp, dc_codes[ci], dc_sizes[ci],
                                         ac_codes[ci], ac_sizes[ci],
                                         preds[ci], blockp, &missing)) {
                        ck.status = missing ? -2 : -1;
                        return;
                    }
                }
            }
            if (!bp.finish()) { ck.status = -1; return; }
            if (g < n_seg - 1) {  // RSTn between segments (not after last)
                if (bp.n + 2 > bp.cap) { ck.status = -1; return; }
                bp.out[bp.n++] = 0xFF;
                bp.out[bp.n++] = (uint8_t)(0xD0 + (g & 7));
            }
        }
        ck.n = bp.n;
    };
    if (T <= 1) {
        work(0);
    } else {
        std::vector<std::thread> pool;
        for (int64_t t = 0; t < T; ++t) pool.emplace_back(work, t);
        for (auto& th : pool) th.join();
    }
    int64_t total = 0;
    for (auto& ck : chunks) {
        if (ck.status < 0) return ck.status;
        total += ck.n;
    }
    if (total > capacity) return -1;
    int64_t off = 0;
    for (auto& ck : chunks) {
        std::memcpy(out + off, ck.buf.get(), (size_t)ck.n);
        off += ck.n;
    }
    return total;
}

}  // extern "C"

extern "C" {

// Lossless (SOF3) 1x1-sampling encode stage: per-sample prediction
// differences + category histogram for one component plane, threaded
// over rows (prediction reads ORIGINAL samples — lossless encode's
// reconstruction equals the source — so rows are independent).
// Semantics mirror models/lossless._lossless_diffs at v=h=1 plus the
// restart re-prediction fix-up (restart-start samples re-predict
// row-0 style with Rb=Rc=init; column 0 from init):
//   row 0:          Rb = Rc = init; col 0 -> init
//   col 0, row >=1: Rb regardless of selector
//   restart start:  col 0 -> init, else row-0-style predictor
// Exactly one of p8/p16 is non-null. diffs_out: int16 (mod-2^16
// wrapped); hist: int64[256] category histogram, caller-zeroed.

}  // extern "C"

namespace {

// Hot body for a row range, templated on the predictor selector and
// the source sample type so the inner loop carries no per-sample
// switch or `idx % ri` (restart boundaries are computed per row and
// rows split into boundary-free runs, mirroring ll_reconstruct_plane_t).
template <int SEL, typename SrcT>
static void ll_diffs_hist_rows(const SrcT* src, int64_t h, int64_t w,
                               int32_t pt, int32_t init, int64_t ri,
                               int64_t r0, int64_t r1,
                               int16_t* diffs_out, int64_t* hl) {
    auto sample = [&](int64_t r, int64_t c) -> int32_t {
        return (int32_t)src[r * w + c] >> pt;
    };
    auto emit = [&](int16_t* drow, int64_t c, int32_t s, int32_t pred) {
        int16_t d = (int16_t)(s - pred);
        drow[c] = d;
        int cat;
        if (d == -32768) {
            cat = 16;
        } else {
            int32_t mag = d < 0 ? -(int32_t)d : (int32_t)d;
            cat = mag ? 32 - __builtin_clz((unsigned)mag) : 0;
        }
        ++hl[cat];
    };
    for (int64_t r = r0; r < r1; ++r) {
        int16_t* drow = diffs_out + r * w;
        int64_t next_b = w;  // col of the next restart boundary this row
        if (ri > 0) {
            int64_t rem = (r * w) % ri;
            next_b = rem == 0 ? 0 : ri - rem;
        }
        if (r == 0) {
            // Row 0: Rb = Rc = init everywhere; a restart boundary
            // predicts identically (col 0 -> init, else init-based).
            int32_t left = sample(0, 0);
            emit(drow, 0, left, init);
            for (int64_t c = 1; c < w; ++c) {
                int32_t s = sample(0, c);
                emit(drow, c, s, ll_predict_t<SEL>(left, init, init));
                left = s;
            }
            continue;
        }
        int32_t left = sample(r, 0);
        if (next_b == 0) {  // restart boundary at col 0 -> init
            emit(drow, 0, left, init);
            next_b = ri;
        } else {
            emit(drow, 0, left, sample(r - 1, 0));  // Rb regardless of SEL
        }
        int64_t c = 1;
        while (c < w) {
            const int64_t run_end = next_b < w ? next_b : w;
            for (; c < run_end; ++c) {
                int32_t s = sample(r, c);
                emit(drow, c, s,
                     ll_predict_t<SEL>(left, sample(r - 1, c),
                                       sample(r - 1, c - 1)));
                left = s;
            }
            if (c < w) {  // restart boundary mid-row
                int32_t s = sample(r, c);
                emit(drow, c, s, ll_predict_t<SEL>(left, init, init));
                left = s;
                ++c;
                next_b += ri;
            }
        }
    }
}

template <typename SrcT>
static void ll_diffs_hist_dispatch(const SrcT* src, int64_t h, int64_t w,
                                   int32_t pt, int32_t sel, int32_t init,
                                   int64_t ri, int64_t r0, int64_t r1,
                                   int16_t* diffs_out, int64_t* hl) {
    switch (sel) {
        case 1: ll_diffs_hist_rows<1>(src, h, w, pt, init, ri, r0, r1, diffs_out, hl); break;
        case 2: ll_diffs_hist_rows<2>(src, h, w, pt, init, ri, r0, r1, diffs_out, hl); break;
        case 3: ll_diffs_hist_rows<3>(src, h, w, pt, init, ri, r0, r1, diffs_out, hl); break;
        case 4: ll_diffs_hist_rows<4>(src, h, w, pt, init, ri, r0, r1, diffs_out, hl); break;
        case 5: ll_diffs_hist_rows<5>(src, h, w, pt, init, ri, r0, r1, diffs_out, hl); break;
        case 6: ll_diffs_hist_rows<6>(src, h, w, pt, init, ri, r0, r1, diffs_out, hl); break;
        default: ll_diffs_hist_rows<7>(src, h, w, pt, init, ri, r0, r1, diffs_out, hl); break;
    }
}

}  // namespace

extern "C" {

int64_t jpx_lossless_diffs_hist(
    const uint8_t* p8, const uint16_t* p16,
    int64_t h, int64_t w,
    int32_t pt, int32_t sel, int32_t init,
    int64_t ri,
    int16_t* diffs_out, int64_t* hist,
    int32_t n_threads) {
    if (sel < 1 || sel > 7) return -1;
    int hw_ = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = hw_ > 0 ? hw_ : 1;
    int64_t T = std::min<int64_t>(n_threads, h);
    if (h * w < (int64_t)1 << 16) T = 1;

    std::vector<std::vector<int64_t>> hist_local((size_t)T,
                                                 std::vector<int64_t>(256, 0));
    std::vector<std::thread> pool;
    int64_t step = (h + T - 1) / T;
    auto work = [&](int64_t t) {
        int64_t r0 = t * step, r1 = std::min(h, r0 + step);
        int64_t* hl = hist_local[(size_t)t].data();
        if (p8) {
            ll_diffs_hist_dispatch(p8, h, w, pt, sel, init, ri, r0, r1,
                                   diffs_out, hl);
        } else {
            ll_diffs_hist_dispatch(p16, h, w, pt, sel, init, ri, r0, r1,
                                   diffs_out, hl);
        }
    };
    if (T <= 1) {
        work(0);
    } else {
        for (int64_t t = 0; t < T; ++t) pool.emplace_back(work, t);
        for (auto& th : pool) th.join();
    }
    for (auto& hv : hist_local)
        for (int i = 0; i < 256; ++i) hist[i] += hv[(size_t)i];
    return 0;
}

// Pack interleaved 1x1 lossless diff planes into the scan's entropy
// bytes in one threaded call. Walk order: pixel-major, components
// inner (the 1x1 interleaved MCU walk). restart_interval (pixels) > 0
// emits byte-aligned segments + RSTn (threaded over segment ranges);
// 0 packs chunk bit-streams concurrently and shift-merges them
// (merge_stuff_chunks), identical bytes to a sequential pack.

}  // extern "C"

namespace {

// One lossless diff symbol (category code + raw magnitude bits fused
// into a single sink write). Returns false with status -2 (missing
// code) or -1 (capacity).
template <class Sink>
static inline bool ll_emit_one(Sink& bp, int32_t d, const uint16_t* code,
                               const uint8_t* size, int64_t& status) {
    int cat;
    uint32_t raw = 0;
    if (d == -32768) {
        cat = 16;
    } else {
        int32_t mag = d < 0 ? -d : d;
        cat = mag ? 32 - __builtin_clz((unsigned)mag) : 0;
        raw = (uint32_t)(d < 0 ? d - 1 : d);
    }
    int sz = size[cat];
    if (sz == 0) { status = -2; return false; }
    if (cat > 0 && cat < 16) {
        uint32_t v = ((uint32_t)code[cat] << cat) | (raw & ((1u << cat) - 1));
        if (!bp.write(v, sz + cat)) { status = -1; return false; }
    } else {
        if (!bp.write(code[cat], sz)) { status = -1; return false; }
    }
    return true;
}

// Emit pixels [i0, i1) of all components. NC-specialized so the plane
// and table pointers live in registers instead of re-loading through
// the pointer arrays on every symbol (the component loop unrolls).
template <int NC, class Sink>
static bool ll_emit_range(Sink& bp, const int16_t* const* diffs,
                          const uint16_t* const* codes,
                          const uint8_t* const* sizes,
                          int64_t i0, int64_t i1, int64_t& status) {
    const int16_t* dp[NC];
    const uint16_t* cp[NC];
    const uint8_t* sp[NC];
    for (int c = 0; c < NC; ++c) {
        dp[c] = diffs[c];
        cp[c] = codes[c];
        sp[c] = sizes[c];
    }
    for (int64_t i = i0; i < i1; ++i)
        for (int c = 0; c < NC; ++c)
            if (!ll_emit_one(bp, dp[c][i], cp[c], sp[c], status)) return false;
    return true;
}

template <class Sink>
static bool ll_emit_range_gen(Sink& bp, const int16_t* const* diffs,
                              const uint16_t* const* codes,
                              const uint8_t* const* sizes, int n_comps,
                              int64_t i0, int64_t i1, int64_t& status) {
    for (int64_t i = i0; i < i1; ++i)
        for (int c = 0; c < n_comps; ++c)
            if (!ll_emit_one(bp, diffs[c][i], codes[c], sizes[c], status))
                return false;
    return true;
}

template <class Sink>
static inline bool ll_emit_dispatch(Sink& bp, const int16_t* const* diffs,
                                    const uint16_t* const* codes,
                                    const uint8_t* const* sizes, int n_comps,
                                    int64_t i0, int64_t i1, int64_t& status) {
    switch (n_comps) {
        case 1: return ll_emit_range<1>(bp, diffs, codes, sizes, i0, i1, status);
        case 2: return ll_emit_range<2>(bp, diffs, codes, sizes, i0, i1, status);
        case 3: return ll_emit_range<3>(bp, diffs, codes, sizes, i0, i1, status);
        case 4: return ll_emit_range<4>(bp, diffs, codes, sizes, i0, i1, status);
        default:
            return ll_emit_range_gen(bp, diffs, codes, sizes, n_comps, i0, i1,
                                     status);
    }
}

// Per-calling-thread reusable emit chunk buffers (the MemoryPool
// discipline: fresh ~25 MB allocations per call cost more in page
// faults than the emit itself). Memory is UNINITIALIZED — a
// std::vector resize would zero-fill the whole worst-case capacity —
// and buffers above kRetain are released after the call instead of
// being pinned for the thread's lifetime (worst-case caps are
// ~8 bytes/symbol, so one large encode must not pin gigabytes).
struct LlPackScratch {
    static constexpr int64_t kRetain = 32 << 20;
    struct Buf {
        std::unique_ptr<uint8_t[]> p;
        int64_t cap = 0;
    };
    std::vector<Buf> bufs;

    uint8_t* get(size_t t, int64_t cap) {
        if (bufs.size() <= t) bufs.resize(t + 1);
        Buf& b = bufs[t];
        if (b.cap < cap) {
            b.p.reset(new uint8_t[(size_t)cap]);
            b.cap = cap;
        }
        return b.p.get();
    }
    void trim() {
        for (Buf& b : bufs)
            if (b.cap > kRetain) {
                b.p.reset();
                b.cap = 0;
            }
    }
};

struct LlPackTrimGuard {
    LlPackScratch& s;
    ~LlPackTrimGuard() { s.trim(); }
};

static thread_local LlPackScratch g_ll_pack_scratch;

}  // namespace

extern "C" {

// Whole restart-segmented baseline scan in ONE call: `ri` MCUs per
// segment, fresh DC predictors each, byte-aligned RSTn separators,
// threaded over segment ranges with reusable per-thread chunk buffers
// (the per-segment-native-call form cost ~100 us of wrapper overhead
// PER SEGMENT). Byte-identical to per-segment jpx_encode_segment
// calls joined with RSTn. Returns bytes written, -1 capacity, -2
// missing Huffman code.
int64_t jpx_encode_segments_rst(
    int32_t n_comps,
    const int16_t** blocks, const int32_t* per_mcu,
    const uint16_t** dc_codes, const uint8_t** dc_sizes,
    const uint16_t** ac_codes, const uint8_t** ac_sizes,
    int64_t n_mcus, int64_t ri,
    uint8_t* out, int64_t capacity, int32_t n_threads) {
    if (ri <= 0 || n_comps <= 0) return -3;
    const int64_t n_seg = (n_mcus + ri - 1) / ri;
    int hw_ = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = hw_ > 0 ? hw_ : 1;
    int64_t T = std::min<int64_t>(n_threads, n_seg);
    int32_t cpm = 0;
    for (int i = 0; i < n_comps; ++i) cpm += per_mcu[i];
    if (n_mcus * cpm < (int64_t)1 << 12) T = 1;

    struct Chunk {
        int64_t g0, g1;
        uint8_t* buf;
        int64_t cap, n, status;
    };
    std::vector<Chunk> chunks((size_t)T);
    LlPackTrimGuard trim_guard{g_ll_pack_scratch};
    const int64_t per = (n_seg + T - 1) / T;
    for (int64_t t = 0; t < T; ++t) {
        chunks[t].g0 = std::min(n_seg, t * per);
        chunks[t].g1 = std::min(n_seg, (t + 1) * per);
        int64_t mcus = std::min(n_mcus, chunks[t].g1 * ri) - chunks[t].g0 * ri;
        if (mcus < 0) mcus = 0;
        chunks[t].cap = mcus * (int64_t)cpm * 512 +
                        (chunks[t].g1 - chunks[t].g0) * 2 + 64;
        chunks[t].buf = g_ll_pack_scratch.get((size_t)t, chunks[t].cap);
        chunks[t].n = 0;
        chunks[t].status = 0;
    }
    auto work = [&](int64_t t) {
        Chunk& ck = chunks[t];
        int64_t pos = 0;
        std::vector<EncComp> comps(n_comps);
        for (int64_t g = ck.g0; g < ck.g1; ++g) {
            const int64_t m0 = g * ri;
            const int64_t m1 = std::min(n_mcus, m0 + ri);
            for (int i = 0; i < n_comps; ++i) {
                comps[i] = EncComp{blocks[i] + m0 * per_mcu[i] * 64,
                                   per_mcu[i], dc_codes[i], dc_sizes[i],
                                   ac_codes[i], ac_sizes[i], 0, 0};
            }
            BitPacker bp{ck.buf + pos, ck.cap - pos, 0, 0, 0};
            bool missing = false;
            for (int64_t m = m0; m < m1; ++m) {
                for (int ci = 0; ci < n_comps; ++ci) {
                    EncComp& c = comps[ci];
                    for (int b = 0; b < c.per_mcu; ++b) {
                        const int16_t* block = c.blocks + c.cursor * 64;
                        ++c.cursor;
                        if (!emit_block(bp, c, block, &missing)) {
                            ck.status = missing ? -2 : -1;
                            return;
                        }
                    }
                }
            }
            if (!bp.finish()) { ck.status = -1; return; }
            pos += bp.n;
            if (g < n_seg - 1) {
                if (pos + 2 > ck.cap) { ck.status = -1; return; }
                ck.buf[pos++] = 0xFF;
                ck.buf[pos++] = (uint8_t)(0xD0 + (g & 7));
            }
        }
        ck.n = pos;
    };
    if (T <= 1) {
        work(0);
    } else {
        std::vector<std::thread> pool;
        for (int64_t t = 0; t < T; ++t) pool.emplace_back(work, t);
        for (auto& th : pool) th.join();
    }
    int64_t total = 0;
    for (auto& ck : chunks) {
        if (ck.status < 0) return ck.status;
        total += ck.n;
    }
    if (total > capacity) return -1;
    int64_t off = 0;
    for (auto& ck : chunks) {
        std::memcpy(out + off, ck.buf, (size_t)ck.n);
        off += ck.n;
    }
    return total;
}

int64_t jpx_pack_lossless_diffs(
    const int16_t** diffs, int32_t n_comps, int64_t n_px,
    int64_t ri,
    const uint16_t** codes, const uint8_t** sizes,
    uint8_t* out, int64_t capacity, int32_t n_threads) {
    int hw_ = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = hw_ > 0 ? hw_ : 1;

    if (ri > 0) {
        const int64_t n_seg = (n_px + ri - 1) / ri;
        int64_t T = std::min<int64_t>(n_threads, n_seg);
        if (n_px * n_comps < (int64_t)1 << 16) T = 1;
        struct Chunk {
            int64_t g0, g1;
            uint8_t* buf;
            int64_t cap, n, status;
        };
        std::vector<Chunk> chunks((size_t)T);
        LlPackTrimGuard trim_guard{g_ll_pack_scratch};
        int64_t per = (n_seg + T - 1) / T;
        for (int64_t t = 0; t < T; ++t) {
            chunks[t].g0 = std::min(n_seg, t * per);
            chunks[t].g1 = std::min(n_seg, (t + 1) * per);
            int64_t px = std::min(n_px, chunks[t].g1 * ri) - chunks[t].g0 * ri;
            if (px < 0) px = 0;
            chunks[t].cap = px * n_comps * 8 +
                            (chunks[t].g1 - chunks[t].g0) * 2 + 64;
            chunks[t].buf = g_ll_pack_scratch.get((size_t)t, chunks[t].cap);
            chunks[t].n = 0;
            chunks[t].status = 0;
        }
        auto work = [&](int64_t t) {
            Chunk& ck = chunks[t];
            int64_t pos = 0;
            for (int64_t g = ck.g0; g < ck.g1; ++g) {
                BitPacker bp{ck.buf + pos, ck.cap - pos, 0, 0, 0};
                int64_t i1 = std::min(n_px, (g + 1) * ri);
                if (!ll_emit_dispatch(bp, diffs, codes, sizes, n_comps,
                                      g * ri, i1, ck.status))
                    return;
                if (!bp.finish()) { ck.status = -1; return; }
                pos += bp.n;
                if (g < n_seg - 1) {
                    if (pos + 2 > ck.cap) { ck.status = -1; return; }
                    ck.buf[pos++] = 0xFF;
                    ck.buf[pos++] = (uint8_t)(0xD0 + (g & 7));
                }
            }
            ck.n = pos;
        };
        if (T <= 1) {
            work(0);
        } else {
            std::vector<std::thread> pool;
            for (int64_t t = 0; t < T; ++t) pool.emplace_back(work, t);
            for (auto& th : pool) th.join();
        }
        int64_t total = 0;
        for (auto& ck : chunks) {
            if (ck.status < 0) return ck.status;
            total += ck.n;
        }
        if (total > capacity) return -1;
        int64_t off = 0;
        for (auto& ck : chunks) {
            std::memcpy(out + off, ck.buf, (size_t)ck.n);
            off += ck.n;
        }
        return total;
    }

    // No restarts: unstuffed chunks + shift-merge.
    int64_t T = std::min<int64_t>(n_threads, std::max<int64_t>(1, n_px / 4096));
    struct Chunk {
        int64_t i0, i1;
        uint8_t* buf;
        int64_t cap, bits, status;
    };
    std::vector<Chunk> chunks((size_t)T);
    LlPackTrimGuard trim_guard{g_ll_pack_scratch};
    int64_t per = (n_px + T - 1) / T;
    for (int64_t t = 0; t < T; ++t) {
        chunks[t].i0 = std::min(n_px, t * per);
        chunks[t].i1 = std::min(n_px, (t + 1) * per);
        chunks[t].cap = (chunks[t].i1 - chunks[t].i0) * n_comps * 8 + 64;
        chunks[t].buf = g_ll_pack_scratch.get((size_t)t, chunks[t].cap);
        chunks[t].bits = 0;
        chunks[t].status = 0;
    }
    auto work = [&](int64_t t) {
        Chunk& ck = chunks[t];
        RawSink rp{ck.buf, ck.cap, 0, 0, 0};
        if (!ll_emit_dispatch(rp, diffs, codes, sizes, n_comps,
                              ck.i0, ck.i1, ck.status))
            return;
        ck.bits = rp.finish_unstuffed();
        if (ck.bits < 0) ck.status = -1;
    };
    if (T <= 1) {
        work(0);
    } else {
        std::vector<std::thread> pool;
        for (int64_t t = 0; t < T; ++t) pool.emplace_back(work, t);
        for (auto& th : pool) th.join();
    }
    std::vector<const uint8_t*> bufs((size_t)T);
    std::vector<int64_t> nbits((size_t)T);
    for (int64_t t = 0; t < T; ++t) {
        if (chunks[t].status < 0) return chunks[t].status;
        bufs[t] = chunks[t].buf;
        nbits[t] = chunks[t].bits;
    }
    return merge_stuff_chunks(bufs.data(), nbits.data(), (int)T, out, capacity);
}

}  // extern "C"

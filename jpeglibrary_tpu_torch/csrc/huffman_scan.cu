// K3: the baseline Huffman entropy decode of restart segments, one symbol
// at a time per segment, into dense zig-zag coefficients.
//
// Replaces jpeglibrary_tpu/ops/device_scan.py:121-245 (_compiled_decoder),
// an XLA lax.while_loop (not Pallas) whose lanes are the segments and
// whose every step decodes one symbol per live lane. This kernel computes
// exactly that loop, lane by lane:
//
// - a 16-bit peek at the segment's bit position; the 8-bit lookahead
//   (size << 8 | value), else the slow path: size = 9 + the leading run of
//   code16 > maxcode[9..16], capped at 16, and values[(valoffset[size] +
//   (code16 >> (16 - size))) & 0xFF];
// - DC (k == 0): t = symbol, diff = EXTEND(t value bits, t), the
//   component's predictor += diff, the coefficient is the predictor;
// - AC: r = symbol >> 4, s = symbol & 15; emit at min(k + r, 63) when
//   s > 0; EOB moves k to 64, ZRL to k + 16, a coefficient to its position
//   + 1; k >= 64 advances the block;
// - predictors start at 0 in every segment; a byte past the row's width
//   reads the row's last byte and block indices are clamped to the output
//   (JAX clamps its gathers); shifts by amounts outside [0, 32) follow
//   XLA (0, or the sign for a right shift), so a corrupt stream decodes to
//   the JAX loop's numbers and never reads or writes out of bounds.
//
// JAX adds each emission into a zeroed output (.at[].add). Within a
// segment the emitted positions strictly increase (k only grows inside a
// block, blocks only advance), so each output element takes at most one
// emission, and a store into the row the wrapper zeroed gives the same
// result without a read.
//
// What bounds it on Hopper: not bytes. A segment's symbols form one chain
// of dependent steps (the lookup needs the bit position, the next position
// needs the lookup), so the time is about the most symbols any one thread
// walks times the latency of one step, and the restart interval decides
// how many threads share the work. A stream without restart markers is one
// segment and so one thread.
//
// First design, simple and right: one thread per segment, 128 threads a
// block. The 2 * n_comps tables and comp_of sit in shared memory (at most
// 8 slots x (256 + 18 + 19 + 256) int32, 17.6 KB); the predictors too, one
// column per thread. Each thread keeps a 64-bit window of its row, refilled
// with 8 byte loads whenever fewer than 32 bits are left ahead of its
// position: one 32-bit extract then serves the code and its value bits.
// Each thread writes only its own output row, so no atomics are needed.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxComps = 4;   // components in one scan (T.81 B.2.3)
constexpr int kMaxTables = 2 * kMaxComps;
constexpr int kMaxBpm = 10;    // blocks in one MCU (T.81 B.2.3)

struct Tables {
  int lookahead[kMaxTables][256];
  int maxcode[kMaxTables][18];
  int valoffset[kMaxTables][19];
  int values[kMaxTables][256];
};

// XLA's shift semantics on int32: 0 for a left shift by an amount outside
// [0, 32).
__device__ __forceinline__ int shl(int x, int n) {
  return (n < 0 || n >= 32) ? 0 : static_cast<int>(static_cast<unsigned>(x) << n);
}

// The n value bits that follow a code of `size` bits at the start of
// `bits32` (JAX's read_bits at bit1 = bit + size): 0 for n <= 0 and, as
// XLA's out-of-range shifts make it, for n > 16.
__device__ __forceinline__ int read_bits(unsigned bits32, int size, int n) {
  if (n <= 0 || n > 16) return 0;
  const unsigned peek16 = (bits32 << size) >> 16;
  return static_cast<int>(peek16 >> (16 - n));
}

// ITU-T T.81 EXTEND, as the JAX loop computes it in int32 (t > 0).
__device__ __forceinline__ int extend(int v, int t) {
  const int vt = shl(1, t - 1);
  return v < vt ? static_cast<int>(static_cast<unsigned>(v) - static_cast<unsigned>(shl(1, t)) + 1u)
                : v;
}

// The 8 bytes of `row` from `byte` on, big-endian; bytes past the row's
// width read its last byte.
__device__ __forceinline__ uint64_t load_window(const uint8_t* __restrict__ row, int64_t byte,
                                                int64_t width) {
  uint64_t w = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int64_t i = byte + j < width ? byte + j : width - 1;
    w = (w << 8) | __ldg(row + i);
  }
  return w;
}

__global__ void __launch_bounds__(kThreads) huffman_scan_kernel(
    const uint8_t* __restrict__ buf, int64_t width, int64_t n_segs,
    const int* __restrict__ comp_of, int bpm, int n_comps,
    const int* __restrict__ mcu_counts,
    const int* __restrict__ lookahead, const int* __restrict__ maxcode,
    const int* __restrict__ valoffset, const int* __restrict__ values,
    int* __restrict__ out, int64_t max_blocks) {
  __shared__ Tables tab;
  __shared__ int s_comp_of[kMaxBpm];
  __shared__ int s_pred[kMaxComps][kThreads];
  const int tid = threadIdx.x;
  const int n_tables = 2 * n_comps;
  for (int i = tid; i < n_tables * 256; i += kThreads) {
    tab.lookahead[i >> 8][i & 255] = lookahead[i];
    tab.values[i >> 8][i & 255] = values[i];
  }
  for (int i = tid; i < n_tables * 18; i += kThreads) tab.maxcode[i / 18][i % 18] = maxcode[i];
  for (int i = tid; i < n_tables * 19; i += kThreads) tab.valoffset[i / 19][i % 19] = valoffset[i];
  if (tid < bpm) {
    // prepare_scan's comp_of is always a component of the scan; the clamp
    // keeps a bad one inside the tables.
    const int c = comp_of[tid];
    s_comp_of[tid] = c < 0 ? 0 : (c >= n_comps ? n_comps - 1 : c);
  }
#pragma unroll
  for (int c = 0; c < kMaxComps; ++c) s_pred[c][tid] = 0;
  __syncthreads();

  const int64_t seg = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
  if (seg >= n_segs) return;
  const uint8_t* __restrict__ row = buf + seg * width;
  int* __restrict__ orow = out + seg * max_blocks * 64;
  const int64_t blocks_total = static_cast<int64_t>(mcu_counts[seg]) * bpm;

  int64_t bit = 0;          // the segment's bit position
  int64_t win_bit = 0;      // the bit position of the window's first bit
  uint64_t window = load_window(row, 0, width);
  int64_t block = 0;        // segment-local block ordinal
  int k = 0;                // zig-zag index within the block
  int in_mcu = 0;           // block % bpm
  int comp = s_comp_of[0];
  while (block < blocks_total) {
    if (bit - win_bit > 32) {
      win_bit = bit & ~int64_t{7};
      window = load_window(row, bit >> 3, width);
    }
    const unsigned bits32 = static_cast<unsigned>(window >> (32 - (bit - win_bit)));
    const int code16 = static_cast<int>(bits32 >> 16);
    const int tbl = 2 * comp + (k != 0);
    const int entry = tab.lookahead[tbl][code16 >> 8];
    int size = entry >> 8;
    int sym = entry & 0xFF;
    if (size == 0) {
      size = 9;
      while (size <= 16 && code16 > tab.maxcode[tbl][size]) ++size;
      size = size > 16 ? 16 : size;
      sym = tab.values[tbl][(tab.valoffset[tbl][size] + (code16 >> (16 - size))) & 0xFF];
    }
    const int64_t base = (block < max_blocks ? block : max_blocks - 1) * 64;
    if (k == 0) {
      const int diff = sym > 0 ? extend(read_bits(bits32, size, sym), sym) : 0;
      const int pred = static_cast<int>(static_cast<unsigned>(s_pred[comp][tid]) +
                                        static_cast<unsigned>(diff));
      s_pred[comp][tid] = pred;
      orow[base] = pred;
      bit += size + sym;
      k = 1;
    } else {
      const int r = sym >> 4;
      const int s = sym & 15;
      const int emit = k + r < 63 ? k + r : 63;
      bit += size + s;
      if (s > 0) {
        orow[base + emit] = extend(read_bits(bits32, size, s), s);
        k = emit + 1;
      } else {
        k = r == 0 ? 64 : k + 16;  // EOB : ZRL
      }
    }
    if (k >= 64) {
      k = 0;
      ++block;
      in_mcu = in_mcu + 1 == bpm ? 0 : in_mcu + 1;
      comp = s_comp_of[in_mcu];
    }
  }
}

}  // namespace

// buf [n_segs, width] uint8, each row one unstuffed segment padded with
// 0xFF; comp_of [bpm] int32; mcu_counts [n_segs] int32; lookahead and
// values [2 * n_comps, 256], maxcode [2 * n_comps, 18], valoffset
// [2 * n_comps, 19] int32; out [n_segs, max_blocks * 64] int32, zeroed by
// the caller; all contiguous device memory. Launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for a shape the kernel
// does not take).
extern "C" int jpx_huffman_scan(const void* buf, int64_t width, int64_t n_segs,
                                const void* comp_of, int bpm, int n_comps,
                                const void* mcu_counts, const void* lookahead,
                                const void* maxcode, const void* valoffset, const void* values,
                                void* out, int64_t max_blocks, void* stream) {
  if (n_segs <= 0) return 0;
  if (width < 1 || bpm < 1 || bpm > kMaxBpm || n_comps < 1 || n_comps > kMaxComps ||
      max_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t grid = (n_segs + kThreads - 1) / kThreads;
  if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  huffman_scan_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), width, n_segs, static_cast<const int*>(comp_of), bpm,
      n_comps, static_cast<const int*>(mcu_counts), static_cast<const int*>(lookahead),
      static_cast<const int*>(maxcode), static_cast<const int*>(valoffset),
      static_cast<const int*>(values), static_cast<int*>(out), max_blocks);
  return static_cast<int>(cudaGetLastError());
}

// K3: the baseline Huffman entropy decode of restart segments into dense
// zig-zag coefficients, as a self-synchronising subsequence decoder
// (Weissenberger and Schmidt, "Accelerating JPEG Decompression on GPUs",
// arXiv 2111.09219, in its simplest exact form).
//
// Replaces jpeglibrary_tpu/ops/device_scan.py:121-245 (_compiled_decoder),
// an XLA lax.while_loop (not Pallas) whose lanes are the segments and
// whose every step decodes one symbol per live lane. The step here is that
// loop's, unchanged:
//
// - a 16-bit peek at the bit position; the 8-bit lookahead
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
// The algorithm. A segment's symbols form one chain of dependent steps (the
// lookup needs the bit position, the next position needs the lookup), so
// one thread per segment leaves a stream without restart markers on one
// thread. Instead each row of n_sub = ceil(8 W / L) subsequences of L bits
// is decoded by one thread per subsequence. At a code boundary the decoder's
// state is (bit, k, m): the bit position, the zig-zag index and the block's
// index within its MCU (which gives the component, and with k != 0 the
// table). Subsequence j owns every symbol whose first bit lies in
// [j L, (j + 1) L); the last subsequence of a row owns everything after,
// up to the row's block budget.
//
// 1. Sync rounds (sync_kernel, one launch a round, one thread per
//    subsequence but the last of each row). Round 0 starts thread j at the
//    guess (j L, 0, 0), subsequence 0 at the exact (0, 0, 0). Each round a
//    thread decodes while bit < (j + 1) L and records its exit state E_j,
//    the blocks it completed and the sum of its DC differences per
//    component (int32, wrapping); it stores nothing into the output. In a
//    later round every j >= 1 whose start differs from E_{j-1} of the
//    previous round takes that as its start and decodes again; the others
//    carry their exit over (the exits live in two buffers, read one, write
//    the other). The rounds stop when no start changed: a device flag, read
//    by the host (4 bytes) after each round.
//    Why the result is exact: a subsequence's exit, blocks and DC sums are
//    a function of its start alone. Subsequence 0 starts exactly; if
//    subsequences 0..r-1 start exactly after round r-1, their exits are the
//    sequential walk's, and subsequence r takes the exact start in round r.
//    So the fixed point is the sequential walk's states, for any stream,
//    corrupt ones included, reached in at most n_sub rounds. A start at or
//    past its subsequence's end (a corrupt DC symbol advances up to 271
//    bits) decodes nothing and exits where it starts, so every L is right.
// 2. Offsets (the wrapper, torch.cumsum): exclusive prefix sums along each
//    row of the blocks (the block index at each subsequence's start) and of
//    the DC sums (the predictors there, low 32 bits).
// 3. Write pass (write_kernel, one thread per subsequence, all of them):
//    from its exact start, block index and predictors, each thread decodes
//    while bit < (j + 1) L (the last one without a bit limit) and its block
//    is below the row's budget, and stores its emissions into the output
//    the wrapper zeroed, as the JAX loop adds them: along the walk the
//    emitted positions strictly increase (k only grows inside a block,
//    blocks only advance), so each output element takes at most one
//    emission. A block that straddles two subsequences is written by both,
//    at disjoint positions; no atomics are needed.
//
// What bounds it on Hopper: not bytes. Each pass costs the symbols of the
// longest subsequence times the latency of one step, so L trades the
// length of that chain against the rounds that re-decode subsequences whose
// guessed start had not synchronised by their end. The 2 * n_comps tables
// and comp_of sit in shared memory (at most 8 slots x (256 + 18 + 19 + 256)
// int32, 17.6 KB); the predictors too, one column per thread. Each thread
// keeps a 64-bit window of its row, refilled with 8 byte loads whenever
// fewer than 32 bits are left ahead of its position: one 32-bit extract then
// serves the code and its value bits. A round's CTA whose threads all carry
// their exits over loads no tables.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxComps = 4;   // components in one scan (T.81 B.2.3)
constexpr int kMaxTables = 2 * kMaxComps;
constexpr int kMaxBpm = 10;    // blocks in one MCU (T.81 B.2.3)
constexpr int64_t kNoEnd = INT64_MAX;

struct Tables {
  int lookahead[kMaxTables][256];
  int maxcode[kMaxTables][18];
  int valoffset[kMaxTables][19];
  int values[kMaxTables][256];
};

struct Shared {
  Tables tab;
  int comp_of[kMaxBpm];
  int pred[kMaxComps][kThreads];
};

// A state (bit, k, m) in one word: k < 64 and m < kMaxBpm.
__device__ __forceinline__ int64_t pack_state(int64_t bit, int k, int m) {
  return (bit << 10) | (k << 4) | m;
}

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

// The tables and comp_of into shared memory, by the whole CTA.
__device__ __forceinline__ void load_tables(Shared& sh, const int* __restrict__ comp_of, int bpm,
                                            int n_comps, const int* __restrict__ lookahead,
                                            const int* __restrict__ maxcode,
                                            const int* __restrict__ valoffset,
                                            const int* __restrict__ values) {
  const int tid = threadIdx.x;
  const int n_tables = 2 * n_comps;
  for (int i = tid; i < n_tables * 256; i += kThreads) {
    sh.tab.lookahead[i >> 8][i & 255] = lookahead[i];
    sh.tab.values[i >> 8][i & 255] = values[i];
  }
  for (int i = tid; i < n_tables * 18; i += kThreads) sh.tab.maxcode[i / 18][i % 18] = maxcode[i];
  for (int i = tid; i < n_tables * 19; i += kThreads) {
    sh.tab.valoffset[i / 19][i % 19] = valoffset[i];
  }
  if (tid < bpm) {
    // prepare_scan's comp_of is always a component of the scan; the clamp
    // keeps a bad one inside the tables.
    const int c = comp_of[tid];
    sh.comp_of[tid] = c < 0 ? 0 : (c >= n_comps ? n_comps - 1 : c);
  }
}

// One thread's walk along its row: where it is and what it has done.
struct Walk {
  const uint8_t* __restrict__ row;
  int64_t width;
  int64_t bit;      // the row's bit position
  int64_t win_bit;  // the bit position of the window's first bit
  uint64_t window;
  int64_t block;    // block index (row-local in the write pass, a count in a sync round)
  int k;            // zig-zag index within the block
  int in_mcu;       // the block's index within its MCU
  int comp;

  __device__ __forceinline__ void start(const Shared& sh, int64_t bit0, int k0, int m0,
                                        int64_t block0) {
    bit = bit0;
    win_bit = bit0 & ~int64_t{7};
    window = load_window(row, bit0 >> 3, width);
    k = k0;
    in_mcu = m0;
    comp = sh.comp_of[m0];
    block = block0;
  }

  // One symbol: the JAX loop's step. With kStore the emission goes to
  // orow (block clamped to max_blocks - 1); the predictors are the
  // thread's column of sh.pred.
  template <bool kStore>
  __device__ __forceinline__ void step(Shared& sh, int bpm, int* __restrict__ orow,
                                       int64_t max_blocks) {
    const int tid = threadIdx.x;
    if (bit - win_bit > 32) {
      win_bit = bit & ~int64_t{7};
      window = load_window(row, bit >> 3, width);
    }
    const unsigned bits32 = static_cast<unsigned>(window >> (32 - (bit - win_bit)));
    const int code16 = static_cast<int>(bits32 >> 16);
    const int tbl = 2 * comp + (k != 0);
    const int entry = sh.tab.lookahead[tbl][code16 >> 8];
    int size = entry >> 8;
    int sym = entry & 0xFF;
    if (size == 0) {
      size = 9;
      while (size <= 16 && code16 > sh.tab.maxcode[tbl][size]) ++size;
      size = size > 16 ? 16 : size;
      sym = sh.tab.values[tbl][(sh.tab.valoffset[tbl][size] + (code16 >> (16 - size))) & 0xFF];
    }
    const int64_t base = (block < max_blocks ? block : max_blocks - 1) * 64;
    if (k == 0) {
      const int diff = sym > 0 ? extend(read_bits(bits32, size, sym), sym) : 0;
      const int pred = static_cast<int>(static_cast<unsigned>(sh.pred[comp][tid]) +
                                        static_cast<unsigned>(diff));
      sh.pred[comp][tid] = pred;
      if (kStore) orow[base] = pred;
      bit += size + sym;
      k = 1;
    } else {
      const int r = sym >> 4;
      const int s = sym & 15;
      const int emit = k + r < 63 ? k + r : 63;
      bit += size + s;
      if (s > 0) {
        if (kStore) orow[base + emit] = extend(read_bits(bits32, size, s), s);
        k = emit + 1;
      } else {
        k = r == 0 ? 64 : k + 16;  // EOB : ZRL
      }
    }
    if (k >= 64) {
      k = 0;
      ++block;
      in_mcu = in_mcu + 1 == bpm ? 0 : in_mcu + 1;
      comp = sh.comp_of[in_mcu];
    }
  }
};

// One sync round over every subsequence t = row * n_sub + j, j < n_sub - 1.
__global__ void __launch_bounds__(kThreads) sync_kernel(
    const uint8_t* __restrict__ buf, int64_t width, int64_t n_rows, int64_t n_sub,
    int64_t sub_bits, const int* __restrict__ comp_of, int bpm, int n_comps,
    const int* __restrict__ lookahead, const int* __restrict__ maxcode,
    const int* __restrict__ valoffset, const int* __restrict__ values, int round,
    int64_t* __restrict__ starts, const int64_t* __restrict__ exit_prev,
    int64_t* __restrict__ exit_next, int64_t* __restrict__ n_blk, int* __restrict__ dsum,
    int* __restrict__ changed) {
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
  const int64_t row = t / n_sub;
  const int64_t j = t - row * n_sub;
  bool work = false;
  int64_t start = 0;
  if (row < n_rows && j < n_sub - 1) {
    if (round == 0) {
      start = j == 0 ? 0 : pack_state(j * sub_bits, 0, 0);
      work = true;
    } else if (j > 0 && exit_prev[t - 1] != starts[t]) {
      start = exit_prev[t - 1];
      work = true;
    } else {
      exit_next[t] = exit_prev[t];
    }
  }
  if (!__syncthreads_or(work)) return;
  load_tables(sh, comp_of, bpm, n_comps, lookahead, maxcode, valoffset, values);
#pragma unroll
  for (int c = 0; c < kMaxComps; ++c) sh.pred[c][tid] = 0;
  __syncthreads();
  if (!work) return;
  if (round > 0) *changed = 1;
  starts[t] = start;

  Walk w;
  w.row = buf + row * width;
  w.width = width;
  w.start(sh, start >> 10, static_cast<int>((start >> 4) & 63), static_cast<int>(start & 15), 0);
  const int64_t end = (j + 1) * sub_bits;
  while (w.bit < end) w.step<false>(sh, bpm, nullptr, 1);
  const int64_t exit_state = pack_state(w.bit, w.k, w.in_mcu);
  exit_next[t] = exit_state;
  n_blk[t] = w.block;
  for (int c = 0; c < n_comps; ++c) dsum[t * n_comps + c] = sh.pred[c][tid];
  if (j == n_sub - 2) starts[t + 1] = exit_state;  // the last subsequence's start
}

// The write pass over every subsequence t = row * n_sub + j.
__global__ void __launch_bounds__(kThreads) write_kernel(
    const uint8_t* __restrict__ buf, int64_t width, int64_t n_rows, int64_t n_sub,
    int64_t sub_bits, const int* __restrict__ comp_of, int bpm, int n_comps,
    const int* __restrict__ mcu_counts, const int* __restrict__ lookahead,
    const int* __restrict__ maxcode, const int* __restrict__ valoffset,
    const int* __restrict__ values, const int64_t* __restrict__ starts,
    const int64_t* __restrict__ block0, const int* __restrict__ pred0, int* __restrict__ out,
    int64_t max_blocks) {
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  load_tables(sh, comp_of, bpm, n_comps, lookahead, maxcode, valoffset, values);
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
  const int64_t row = t / n_sub;
  const int64_t j = t - row * n_sub;
  const bool live = row < n_rows;
#pragma unroll
  for (int c = 0; c < kMaxComps; ++c) {
    sh.pred[c][tid] = live && c < n_comps ? pred0[t * n_comps + c] : 0;
  }
  __syncthreads();
  if (!live) return;
  const int64_t budget = static_cast<int64_t>(mcu_counts[row]) * bpm;
  const int64_t block = block0[t];
  if (block >= budget) return;

  const int64_t start = starts[t];
  Walk w;
  w.row = buf + row * width;
  w.width = width;
  w.start(sh, start >> 10, static_cast<int>((start >> 4) & 63), static_cast<int>(block % bpm),
          block);
  const int64_t end = j == n_sub - 1 ? kNoEnd : (j + 1) * sub_bits;
  int* __restrict__ orow = out + row * max_blocks * 64;
  while (w.bit < end && w.block < budget) w.step<true>(sh, bpm, orow, max_blocks);
}

bool bad_shape(int64_t width, int64_t n_rows, int64_t n_sub, int64_t sub_bits, int bpm,
               int n_comps) {
  return width < 1 || n_rows < 0 || n_sub < 1 || sub_bits < 8 || bpm < 1 || bpm > kMaxBpm ||
         n_comps < 1 || n_comps > kMaxComps || (n_sub - 1) * sub_bits >= 8 * width ||
         n_sub * sub_bits < 8 * width || n_rows * n_sub / kThreads >= 0x7FFFFFFF ||
         8 * width >= (int64_t{1} << 52);
}

}  // namespace

// The sync rounds. buf [n_rows, width] uint8, each row one unstuffed
// segment padded with 0xFF; n_sub = ceil(8 width / sub_bits); comp_of [bpm]
// int32; lookahead and values [2 * n_comps, 256], maxcode [2 * n_comps,
// 18], valoffset [2 * n_comps, 19] int32. Scratch, all [n_rows * n_sub]:
// starts int64, zeroed by the caller (the packed start states, exact when
// this returns); exits int64 [2 * n_rows * n_sub]; n_blk int64 and dsum
// int32 [n_rows * n_sub * n_comps], both zeroed (the blocks and DC sums of
// each subsequence from its start); flag, one int32. All contiguous device
// memory. Runs the rounds on `stream`, reading the flag after each from
// round 1 on (so it synchronises the stream), and writes their count to
// *rounds. Returns 0, a CUDA error, cudaErrorInvalidValue for a shape the
// kernels do not take, or -1 if n_sub rounds did not settle (they always
// do: see the argument above).
extern "C" int jpx_huffman_sync(const void* buf, int64_t width, int64_t n_rows, int64_t n_sub,
                                int64_t sub_bits, const void* comp_of, int bpm, int n_comps,
                                const void* lookahead, const void* maxcode,
                                const void* valoffset, const void* values, void* starts,
                                void* exits, void* n_blk, void* dsum, void* flag, int* rounds,
                                void* stream) {
  *rounds = 0;
  if (bad_shape(width, n_rows, n_sub, sub_bits, bpm, n_comps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0 || n_sub < 2) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t total = n_rows * n_sub;
  const auto grid = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  auto* ex = static_cast<int64_t*>(exits);
  for (int64_t r = 0; r < n_sub; ++r) {
    if (r > 0) {
      const cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int), s);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    sync_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(buf), width, n_rows, n_sub, sub_bits,
        static_cast<const int*>(comp_of), bpm, n_comps, static_cast<const int*>(lookahead),
        static_cast<const int*>(maxcode), static_cast<const int*>(valoffset),
        static_cast<const int*>(values), static_cast<int>(r), static_cast<int64_t*>(starts),
        ex + ((r + 1) & 1) * total, ex + (r & 1) * total, static_cast<int64_t*>(n_blk),
        static_cast<int*>(dsum), static_cast<int*>(flag));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    *rounds = static_cast<int>(r + 1);
    if (r == 0) continue;
    int changed = 0;
    err = cudaMemcpyAsync(&changed, flag, sizeof(int), cudaMemcpyDeviceToHost, s);
    if (err == cudaSuccess) err = cudaStreamSynchronize(s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!changed) return 0;
  }
  return -1;
}

// The write pass: the arguments of jpx_huffman_sync, with mcu_counts
// [n_rows] int32, its exact starts, block0 int64 [n_rows * n_sub] and
// pred0 int32 [n_rows * n_sub * n_comps] (the block index and predictors at
// each subsequence's start), into out [n_rows, max_blocks * 64] int32,
// zeroed by the caller. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not take).
extern "C" int jpx_huffman_write(const void* buf, int64_t width, int64_t n_rows, int64_t n_sub,
                                 int64_t sub_bits, const void* comp_of, int bpm, int n_comps,
                                 const void* mcu_counts, const void* lookahead,
                                 const void* maxcode, const void* valoffset, const void* values,
                                 const void* starts, const void* block0, const void* pred0,
                                 void* out, int64_t max_blocks, void* stream) {
  if (bad_shape(width, n_rows, n_sub, sub_bits, bpm, n_comps) || max_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  const int64_t total = n_rows * n_sub;
  write_kernel<<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), width, n_rows, n_sub, sub_bits,
      static_cast<const int*>(comp_of), bpm, n_comps, static_cast<const int*>(mcu_counts),
      static_cast<const int*>(lookahead), static_cast<const int*>(maxcode),
      static_cast<const int*>(valoffset), static_cast<const int*>(values),
      static_cast<const int64_t*>(starts), static_cast<const int64_t*>(block0),
      static_cast<const int*>(pred0), static_cast<int*>(out), max_blocks);
  return static_cast<int>(cudaGetLastError());
}

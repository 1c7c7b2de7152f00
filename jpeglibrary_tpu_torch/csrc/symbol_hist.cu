// K5: the DC and AC Huffman symbol histograms of zig-zag blocks in MCU walk
// order, summed over a batch of DC predictor chains.
//
// Counterpart of the JAX package's device symbol statistics,
// jpeglibrary_tpu/ops/encode_stage.py:330 symbol_histograms_device, an XLA
// program (16-compare bit counts, a cummax over the 63 AC positions and two
// scatter-adds into 256 bins), not a Pallas kernel. Its plain PyTorch
// version is jpeglibrary_tpu_torch/ops/encode_stage.py
// symbol_histograms_plain, and this kernel's result equals it bit for bit:
//
//   blocks [B, N, 64] int16 or int32, row b one DC predictor chain; blocks
//   at n >= n_valid[b] count nothing;
//   DC: bits(|dc[n] - dc[n - 1]|), dc[-1] = prev_dc[b] (0 without prev_dc);
//   AC: for each non-zero coefficient at zig-zag position p (1..63),
//       run = the zeros since the previous non-zero AC (or since p = 0),
//       symbol ((run % 16) << 4) | bits(|v|), and run / 16 ZRLs in 0xF0;
//   EOB: one in bin 0 per block whose coefficient 63 is zero;
//   bits(a) = #{k in 0..15 : a >= 2^k} = min(32 - clz(a), 16) for a > 0,
//       and 0 for a <= 0: the int32 |INT_MIN| stays negative in the plain
//       version's abs, so it counts 0 bits there too. A size of 16 sets
//       bit 4 of the symbol, the run's lowest bit, as the plain `|` does.
//
// The sums are integers, so the result does not depend on the order of the
// atomics.
//
// What bounds it on Hopper: its bound is bytes. It reads 128 B of int16
// coefficients a block (256 B as int32) and writes 2 KB: full_step's
// 8 x 65,536 luma blocks are 67.1 MB, 20.0 us at 3.35 TB/s. The plain
// version spends most of its time in index_add_ atomics that add a zero
// weight for every zero coefficient into bin 0. What holds this kernel
// above its bound is the integer work per coefficient and the shared-memory
// atomics, so the design keeps both short.
//
// Design: a warp takes 4 consecutive blocks at a time (of the flattened
// [B * N] blocks), lane l holding the 8 coefficients [8 (l % 8), +8) of block
// l / 8 from one 16-byte load (two as int32), so a warp reads 512 contiguous
// bytes (1,024); it issues the loads of kUnroll such groups before it counts
// any. Each lane builds the 8 bits of its part of the block's non-zero mask;
// three xor-shuffles OR them into the block's 64-bit mask in all 8 of its
// lanes. A lane's first non-zero AC coefficient takes its run from the
// previous set bit, 63 - clzll of the mask's bits below the lane's part
// with the DC bit cleared; the rest take it from the lane's own previous
// non-zero. The lane holding position 63 adds the EOB; the lane holding the
// DC takes the previous block's DC from the lane 8 below (one global load
// for the first block of the warp's four). A block's row is a multiply and
// a shift (no division). Only non-zero contributions are added, into one
// private pair of histograms per warp in shared memory, so that bin 0 and
// the short symbols are not one hot address for the whole CTA; at the end
// each CTA sums its warps' copies and adds each non-empty bin to the output
// with one global atomicAdd. The grid is one wave of resident CTAs, each
// looping over its share of the blocks.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerWarp = 4;  // 8 lanes a block
constexpr int kUnroll = 2;         // groups of 4 blocks a warp loads at once
constexpr int kBins = 512;  // DC [0, 256), AC [256, 512)
// Block indices are 32-bit: the grid's warps step over groups of 4 blocks
// with unsigned arithmetic, which stays exact below 2^31 blocks.
constexpr int64_t kMaxBlocks = (int64_t{1} << 31) - 1;

// The plain version's bit count of an int32 after its abs: 16 threshold
// compares, so 0 for 0 and for the negative |INT_MIN|, capped at 16.
__device__ __forceinline__ int bit_count(int32_t v) {
  const uint32_t u = v < 0 ? 0u - static_cast<uint32_t>(v) : static_cast<uint32_t>(v);
  if (u == 0 || u > 0x7FFFFFFFu) return 0;
  return min(32 - __clz(static_cast<int>(u)), 16);
}

// The same for a coefficient of type T: an int16's |v| is at most 2^15, so
// neither the cap nor |INT_MIN| can arise.
template <typename T>
__device__ __forceinline__ int coef_bits(int32_t v) {
  return bit_count(v);
}

template <>
__device__ __forceinline__ int coef_bits<int16_t>(int32_t v) {
  return 32 - __clz(abs(v));
}

// The 8 coefficients [8 part, 8 part + 8) of a block as int32.
__device__ __forceinline__ void load_part(const int16_t* p, int32_t v[8]) {
  const int4 raw = __ldg(reinterpret_cast<const int4*>(p));
  const uint32_t w[4] = {static_cast<uint32_t>(raw.x), static_cast<uint32_t>(raw.y),
                         static_cast<uint32_t>(raw.z), static_cast<uint32_t>(raw.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = static_cast<int16_t>(w[i] & 0xFFFFu);
    v[2 * i + 1] = static_cast<int16_t>(w[i] >> 16);
  }
}

__device__ __forceinline__ void load_part(const int32_t* p, int32_t v[8]) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(p));
  const int4 b = __ldg(reinterpret_cast<const int4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// floor(t / d) for t < 2^31 as one multiply and a shift (Granlund and
// Montgomery 1994, Theorem 4.2 with N = 31): l = ceil(log2 d) and
// m = ceil(2^(31 + l) / d) < 2^32 give 2^(31+l) <= m d <= 2^(31+l) + 2^l.
struct Divider {
  uint32_t m;
  uint32_t shift;  // 31 + l

  __device__ __forceinline__ uint32_t divide(uint32_t t) const {
    return static_cast<uint32_t>((static_cast<uint64_t>(t) * m) >> shift);
  }
};

Divider make_divider(uint32_t d) {
  uint32_t l = 0;
  while ((uint64_t{1} << l) < d) ++l;
  const uint64_t m = ((uint64_t{1} << (31 + l)) + d - 1) / d;
  return Divider{static_cast<uint32_t>(m), 31 + l};
}

// One lane's part of block t: its DC symbol (part 0), the AC symbols and
// ZRLs of its 8 coefficients, the block's EOB (part 7). `mask` is the
// block's non-zero mask, `dc_below` the DC of block t - 1 where that block
// lies in the lanes 8 below.
template <typename T>
__device__ __forceinline__ void count_part(const T* __restrict__ blocks,
                                           const int32_t* __restrict__ n_valid,
                                           const int32_t* __restrict__ prev_dc, uint32_t t,
                                           int lane, const int32_t v[8], uint64_t mask,
                                           int32_t dc_below, uint32_t n_cols, Divider rows,
                                           int32_t* dc_hist, int32_t* ac_hist) {
  const int part = lane % 8;
  const uint32_t row = rows.divide(t);
  const uint32_t n = t - row * n_cols;
  if (n_valid != nullptr && static_cast<int32_t>(n) >= n_valid[row]) return;  // padding

  if (part == 0) {
    int32_t prev;
    if (n == 0) {
      prev = prev_dc != nullptr ? prev_dc[row] : 0;
    } else if (lane >= 8) {
      prev = dc_below;
    } else {
      prev = static_cast<int32_t>(blocks[static_cast<size_t>(t - 1) * 64]);
    }
    const int32_t diff =
        static_cast<int32_t>(static_cast<uint32_t>(v[0]) - static_cast<uint32_t>(prev));
    atomicAdd(&dc_hist[bit_count(diff)], 1);
  }
  // The previous non-zero AC position below this lane's part (0, the DC's,
  // for none), then carried along the part.
  const uint64_t below = mask & ((1ull << (8 * part)) - 1) & ~1ull;
  int prev_p = below != 0 ? 63 - __clzll(static_cast<long long>(below)) : 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int p = part * 8 + j;
    if (p == 0 || v[j] == 0) continue;
    const int run = p - prev_p - 1;
    prev_p = p;
    atomicAdd(&ac_hist[((run & 15) << 4) | coef_bits<T>(v[j])], 1);
    if (run >= 16) atomicAdd(&ac_hist[0xF0], run >> 4);
  }
  if (part == 7 && v[7] == 0) atomicAdd(&ac_hist[0], 1);  // EOB
}

template <typename T>
__global__ void __launch_bounds__(kThreads) symbol_hist_kernel(
    const T* __restrict__ blocks, const int32_t* __restrict__ n_valid,
    const int32_t* __restrict__ prev_dc, uint32_t total, uint32_t n_cols, Divider rows,
    int32_t* __restrict__ out) {
  __shared__ int32_t s_hist[kWarps][kBins];
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) (&s_hist[0][0])[i] = 0;
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int part = lane % 8;  // coefficients [8 part, 8 part + 8)
  const uint32_t n_groups = (total + kBlocksPerWarp - 1) / kBlocksPerWarp;

  // A warp takes kUnroll consecutive groups of 4 blocks at a time, all
  // loads first. g0 is the same for the 32 lanes of a warp, so every
  // shuffle below has the whole warp.
  for (uint32_t g0 = (blockIdx.x * kWarps + warp) * kUnroll; g0 < n_groups;
       g0 += gridDim.x * kWarps * kUnroll) {
    uint32_t t[kUnroll];
    int32_t v[kUnroll][8];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      t[k] = (g0 + k) * kBlocksPerWarp + lane / 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) v[k][j] = 0;
      if (t[k] < total) load_part(blocks + static_cast<size_t>(t[k]) * 64 + part * 8, v[k]);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      uint32_t bits8 = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) bits8 |= static_cast<uint32_t>(v[k][j] != 0) << j;
      uint64_t mask = static_cast<uint64_t>(bits8) << (8 * part);
      mask |= __shfl_xor_sync(0xFFFFFFFFu, mask, 1);
      mask |= __shfl_xor_sync(0xFFFFFFFFu, mask, 2);
      mask |= __shfl_xor_sync(0xFFFFFFFFu, mask, 4);
      const int32_t dc_below = __shfl_up_sync(0xFFFFFFFFu, v[k][0], 8);  // block t - 1's DC
      if (t[k] < total) {
        count_part(blocks, n_valid, prev_dc, t[k], lane, v[k], mask, dc_below, n_cols, rows,
                   s_hist[warp], s_hist[warp] + 256);
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kBins; i += kThreads) {
    int32_t sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += s_hist[w][i];
    if (sum != 0) atomicAdd(&out[i], sum);
  }
}

template <typename T>
int launch(const void* blocks, const void* n_valid, const void* prev_dc, int64_t n_rows,
           int64_t n_cols, void* out, void* stream) {
  if (n_rows < 0 || n_cols < 0 || reinterpret_cast<uintptr_t>(blocks) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = n_rows * n_cols;
  if (total == 0) return 0;
  if (total > kMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);
  // One wave: as many CTAs as the SMs hold at once (registers and shared
  // memory decide it), each looping over its share of the groups.
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, symbol_hist_kernel<T>, kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_groups = (total + kBlocksPerWarp - 1) / kBlocksPerWarp;
  int64_t grid = (n_groups + kWarps * kUnroll - 1) / (kWarps * kUnroll);
  if (grid > static_cast<int64_t>(sms) * per_sm) grid = static_cast<int64_t>(sms) * per_sm;
  symbol_hist_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(blocks), static_cast<const int32_t*>(n_valid),
      static_cast<const int32_t*>(prev_dc), static_cast<uint32_t>(total),
      static_cast<uint32_t>(n_cols), make_divider(static_cast<uint32_t>(n_cols)),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// blocks [n_rows, n_cols, 64] zig-zag coefficients (int16 or int32),
// contiguous and 16-byte aligned; n_valid [n_rows] int32 in [0, n_cols] or
// null (every block counts); prev_dc [n_rows] int32 or null (every chain
// starts from 0); out [2, 256] int32 (DC, then AC), zeroed by the caller and
// added to. All device memory. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for arguments the kernel does
// not take).
extern "C" int jpx_symbol_histograms_i16(const void* blocks, const void* n_valid,
                                         const void* prev_dc, int64_t n_rows, int64_t n_cols,
                                         void* out, void* stream) {
  return launch<int16_t>(blocks, n_valid, prev_dc, n_rows, n_cols, out, stream);
}

extern "C" int jpx_symbol_histograms_i32(const void* blocks, const void* n_valid,
                                         const void* prev_dc, int64_t n_rows, int64_t n_cols,
                                         void* out, void* stream) {
  return launch<int32_t>(blocks, n_valid, prev_dc, n_rows, n_cols, out, stream);
}

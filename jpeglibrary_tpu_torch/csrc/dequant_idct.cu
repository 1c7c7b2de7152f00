// K1: dequantize + un-zigzag + 2-D IDCT + round + level shift, for a
// batch of 8x8 JPEG blocks, at full size or reduced to n x n (n = 4, 2, 1).
//
// Replaces jpeglibrary_tpu/ops/pallas_kernels.py::_kernel, the Pallas
// kernel of the TPU decode transform, and the reduced-IDCT matvecs of the
// JAX scaled decode (ops/decode_stage.py::component_plane_scaled). Same
// arithmetic:
//
//   out[t, k] = rint( sum_zz fl(c[t, zz] * q[t / bpt, zz]) * K[zz, k] ) + level_shift
//
// where K is the [64, W] fp32 matrix, W = n * n: at n = 8 the [64, 64] map
// of host/ops/decode_stage.fused_transform_matrix (un-zigzag, both 1-D AAN
// IDCT passes and the 1/8 scale folded into one linear map); at n < 8 the
// folded reduced IDCT of scaled_folded_matrix(n). Block t dequantizes with
// table t / bpt (bpt = blocks per table), so one launch covers a batch of
// images that each carry their own tables.
//
// What bounds it on Hopper. At W = 64 a block is 4,096 FFMA: 0.122 ns at
// 67 TFLOP/s, against 0.115 ns for its bytes (128 B of int16 coefficients
// in, 256 B of int32 samples out, at 3.35 TB/s) and 0.076 ns for the plane
// store's (128 B out). So the product bounds it, and the kernel is a
// matter of issuing FFMA back to back: every other instruction, shared
// load, barrier and stall takes a slot from them. At W < 64 the FFMA work
// and the writes shrink with W and the coefficient reads (16.8 MB per
// 65,536 blocks) are the bound.
//
// W = 64 (dequant_idct_kernel<T, 64>, and dequant_idct_plane_kernel):
//
// 1. Warps that walk alone. A CTA of kWarps warps fills an SM (one CTA an
//    SM, kWarps x 32 threads under the 65,536 registers); it stages K once
//    (16 KB), and after that one barrier each warp walks its own tiles of
//    32 blocks (tile warp * grid + cta, then every kWarps * grid) with no
//    CTA barrier, ordered by __syncwarp alone. A warp has one raw stage,
//    filled by its own lanes' 16-byte cp.async, and a float tile of its
//    own: once a tile is converted, the next tile's copy goes into the
//    stage and lands while this one is multiplied. One warp's conversion
//    or stores overlap the other warps' FFMA, and no warp waits for the
//    slowest of the CTA.
// 2. One conversion per element, as below (item 2 of W < 64), per warp
//    tile, into the float tile for both coefficient types.
// 3. An 8 x 8 register tile. Lane (r, c) = (lane / 8, lane % 8) computes
//    blocks r, r + 4, ..., r + 28 of the tile by columns 4c .. 4c + 3 and
//    32 + 4c .. 32 + 4c + 3. Per 4 zig-zag steps it loads K's 4 steps of
//    its 8 columns (8 loads of 16 B, kept in 32 registers) and each of its
//    blocks' 4 steps (8 loads): 16 loads per 256 FFMA, where the 8 x 4
//    tile took 12 per 128. Each load is one wavefront: the 8 columns of
//    lanes read 128 consecutive bytes of K, the 4 rows of lanes 4 blocks
//    68 floats (4 banks) apart, each as a broadcast to the lanes that
//    share it.
// 4. Epilogue: a warp vote on the largest |sum| (below 2^22 on every real
//    block) takes rint and the shift in two full-rate operations; the
//    plane store clamps with one DPX min/max and packs two samples with
//    one byte permute. The int32 store writes two 16-byte runs of a block
//    a lane (8 lanes, 128 B of one block); the plane store two 8-byte runs
//    of two plane rows, 4 blocks side by side a row of lanes (64 B of each
//    plane row).
//
// W < 64 (dequant_idct_kernel<T, 16 | 4 | 1>):
//
// 1. Asynchronous, wide staging. A persistent grid (SMs x resident CTAs)
//    walks tiles of 128 blocks; each tile (32 KB of int32, 16 KB of int16,
//    contiguous) is copied into shared memory by 16-byte cp.async into one
//    of two stages, so the next tile's bytes are in flight while this one is
//    converted and computed. The staged rows are padded by 16 B, which puts
//    neighbouring blocks on different banks.
// 2. One conversion per element. Each 16-byte chunk of the raw tile is read
//    once, converted to fp32 and dequantized (__fmul_rn) into a float tile
//    [block][zz]: in place for int32, into a tile of its own for int16. A
//    thread's chunks all hold the same zig-zag entries, so while a tile's
//    blocks share one table its quant entries sit in registers; a tile that
//    straddles two tables looks each block's table up. I2F and F2I run at
//    an eighth of the FFMA rate, so values below 2^22 (every real
//    coefficient and sample; a warp vote checks) convert and round with an
//    add of 1.5 * 2^23 instead, which gives the same results.
// 3. Register tiling with smaller thread tiles (Shape below): 2 blocks x 4
//    columns at W = 16, 1 x 4 at W = 4, 1 x 1 at W = 1 (4 lanes' blocks
//    gathered by shuffles into one 16-byte store). Their FFMA work is small
//    beside the coefficient reads.
//
// Measured on an H100 at 700 W (tools/k1_probe.py, L2 flushed; see
// PERF.md): 0.211-0.220 ns a block on the large launches (0.8-2 M
// blocks), 56-58% of the FFMA floor, and 0.254-0.259 ns on the chroma's
// 196-262 K blocks
// (47-48%: each warp walks 4-5 tiles, so the first tile's wait and the
// last round, where few warps are left, weigh more), in 146-154 registers
// and no spills. The first W = 64 design (a CTA-wide tile of 128 blocks,
// 8 x 4 a thread, two barriers a tile, 2 CTAs of 8 warps an SM) took
// 0.254-0.289 ns a block, 42-48% of the floor. What is left: the FFMA are
// 91% of the product loop's instructions by its SASS (the loads and the
// loop's own take the rest), fewer with the conversion and the epilogue,
// and ptxas's register allocation puts about a quarter of them on a
// register bank conflict; the first 8 x 8 loop with its loads hoisted
// out, FFMA on register operands alone, reached 63%. Fewer registers (16 warps at 128)
// raised the conflicts to 60% and ran 10% slower.
//
// Each accumulator sums zz = 0..63 in ascending order with one fp32 FFMA
// per step from 0.0f, so the outputs equal the first design's bit for bit
// in every layout. Tensor cores (wgmma, 3xTF32) are not used: 3xTF32
// would need its own proof of the 1-LSB contract.
//
// The plane store (dequant_idct_plane_kernel, W = 64 only): the same tiles
// and product, but each sample is clamped to [0, max_sample] and stored as
// uint16 into a raster plane [rows * 8, wb * 8], block t at block row t / wb
// and column t % wb: the decoded plane of a batch of one-component frames
// (parallel/sharding.py gray_step), 2 B a sample where the int32 blocks
// take 4, with no layout pass after it.
//
// Precision: full fp32 FFMA, no TF32 and no fast-math. The dequant product
// is rounded on its own (__fmul_rn) before the dot, as the JAX kernel
// rounds it, so the compiler cannot contract it into the first FMA.
// Rounding is half to even (__float2int_rn), as jnp.rint.
//
// Bound through a plain C interface (ctypes); see ops/_build.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // W < 64: threads a CTA
constexpr int kTile = 128;      // W < 64: blocks a CTA tile
constexpr int kWarps = 12;      // W = 64: warps a CTA, one CTA an SM
constexpr int kWarpTile = 32;   // W = 64: blocks a warp tile
constexpr int kPitch = 68;      // floats per row of the float tile (16 B of padding)
constexpr int kMaxDevices = 64;

// The raw tile of one coefficient type, kBlocks rows of 64 zig-zag entries
// staged by kLanes threads, 16 bytes at a time, into rows padded by one
// chunk. In the CTA walk int32 rows convert to fp32 in place (the float
// tile is the stage itself) and int16 rows into a separate float tile; a
// warp converts either into a float tile of its own.
template <typename CoeffT, int kBlocks, int kLanes>
struct Raw {
  static constexpr int kTileBlocks = kBlocks;
  static constexpr int kThreadsPerTile = kLanes;
  static constexpr bool kInPlace = sizeof(CoeffT) == 4;
  static constexpr int kRowBytes = 64 * static_cast<int>(sizeof(CoeffT));  // 256 or 128
  static constexpr int kRowPitch = kRowBytes + 16;                         // 272 or 144
  static constexpr int kChunksPerRow = kRowBytes / 16;                     // 16 or 8
  static constexpr int kPerChunk = 16 / static_cast<int>(sizeof(CoeffT));   // 4 or 8 entries
  static constexpr int kChunksPerThread = kBlocks * kChunksPerRow / kLanes;
  static constexpr int kStageBytes = kBlocks * kRowPitch;
  static_assert(kBlocks * kChunksPerRow % kLanes == 0, "whole chunks per thread");
  static_assert(kLanes % kChunksPerRow == 0, "a thread keeps its zig-zag entries");
  static_assert(!kInPlace || kRowPitch == kPitch * 4, "in place, a raw row is a float row");
};

template <typename CoeffT>
using CtaRaw = Raw<CoeffT, kTile, kThreads>;  // W < 64: a CTA's tile
template <typename CoeffT>
using WarpRaw = Raw<CoeffT, kWarpTile, 32>;   // W = 64: a warp's tile

// The CTA of an instantiation.
template <int W>
struct Layout {
  static constexpr int kCtaThreads = W == 64 ? 32 * kWarps : kThreads;
  static constexpr int kMinCtas = W == 64 ? 1 : 2;  // resident CTAs an SM, for the registers
  static constexpr int kTileBlocks = W == 64 ? kWarpTile : kTile;
};

// The thread tile at output width W < 64: kRows blocks (g, g + kRowStride,
// ... for block group g) by kCols consecutive columns. kWorkers threads
// cover the tile's kTile x W samples: all of the CTA at W = 16, half of it
// at W = 4 and 1.
template <int W>
struct Shape {
  static_assert(W < 64, "W = 64 has its own warp tiles");
  static constexpr int kRows = W == 16 ? 2 : 1;
  static constexpr int kCols = W == 1 ? 1 : 4;  // at W = 1, 4 lanes meet in one store
  static constexpr int kColGroups = W / kCols;
  static constexpr int kRowStride = kTile / kRows;  // the number of block groups
  static constexpr int kWorkers = kColGroups * kRowStride;  // 256, 128, 128
  static_assert(kWorkers % 32 == 0 && kWorkers <= kThreads, "whole warps, one tile each");
};

// W = 64: a warp's raw stage and float tile.
template <typename CoeffT>
__host__ __device__ constexpr int warp_bytes() {
  return WarpRaw<CoeffT>::kStageBytes + kWarpTile * kPitch * 4;
}

template <typename CoeffT, int W>
constexpr int shared_bytes() {
  using R = CtaRaw<CoeffT>;
  return W == 64 ? 64 * 64 * 4 + kWarps * warp_bytes<CoeffT>()
                 : 64 * W * 4 + 2 * R::kStageBytes + (R::kInPlace ? 0 : kTile * kPitch * 4);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;  // 0 fills the chunk with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying tile `tile` of R's size into `stage` (nothing past the last
// tile); `tid` is the thread's index among R's threads.
template <class R>
__device__ __forceinline__ void issue_tile(unsigned char* stage, const unsigned char* coeffs,
                                           int64_t tile, int64_t n_tiles, int64_t n_blocks,
                                           int tid) {
  if (tile >= n_tiles) return;
  const int64_t first = tile * R::kTileBlocks;
#pragma unroll
  for (int k = 0; k < R::kChunksPerThread; ++k) {
    const int g = tid + k * R::kThreadsPerTile;
    const int b = g / R::kChunksPerRow;
    const int u = g % R::kChunksPerRow;
    const bool valid = first + b < n_blocks;
    const unsigned char* src = valid ? coeffs + (first + b) * R::kRowBytes + 16 * u : coeffs;
    cp_async16(stage + b * R::kRowPitch + 16 * u, src, valid);
  }
  cp_async_commit();
}

template <int E>
__device__ __forceinline__ void load_quant(float (&q)[E], const int32_t* __restrict__ quant,
                                           int64_t table, int zz0) {
  const int4* row = reinterpret_cast<const int4*>(quant + table * 64 + zz0);
#pragma unroll
  for (int i = 0; i < E / 4; ++i) {
    const int4 v = __ldg(row + i);
    q[4 * i] = static_cast<float>(v.x);
    q[4 * i + 1] = static_cast<float>(v.y);
    q[4 * i + 2] = static_cast<float>(v.z);
    q[4 * i + 3] = static_cast<float>(v.w);
  }
}

// Exact int -> float for |x| < 2^22 in two full-rate operations: x lands in
// the mantissa of 1.5 * 2^23, which is then subtracted. (I2F runs at an
// eighth of the FFMA rate.)
__device__ __forceinline__ float small_to_float(int x) {
  return __fsub_rn(__int_as_float(0x4B400000 + x), 12582912.0f);
}

__device__ __forceinline__ bool is_small(int x) {  // -2^22 <= x < 2^22
  return static_cast<unsigned>(x + (1 << 22)) < (1u << 23);
}

// rint(a) + shift for |a| < 2^22 - 1 in two full-rate operations: adding
// 1.5 * 2^23 rounds a to an integer, half to even, as F2I.RN does.
__device__ __forceinline__ int small_rint(float a, int shift) {
  return __float_as_int(__fadd_rn(a, 12582912.0f)) - (0x4B400000 - shift);
}

__device__ __forceinline__ bool rint_is_small(float a) { return fabsf(a) < 4194000.0f; }

template <bool kSmall>
__device__ __forceinline__ float to_float(int x) {
  return kSmall ? small_to_float(x) : static_cast<float>(x);
}

template <bool kSmall>
__device__ __forceinline__ int rint_shift(float a, int shift) {
  return kSmall ? small_rint(a, shift) : __float2int_rn(a) + shift;
}

template <bool kSmall>
__device__ __forceinline__ void unpack(const int4 v, float (&c)[4]) {  // int32 entries
  c[0] = to_float<kSmall>(v.x);
  c[1] = to_float<kSmall>(v.y);
  c[2] = to_float<kSmall>(v.z);
  c[3] = to_float<kSmall>(v.w);
}

template <bool kSmall>
__device__ __forceinline__ void unpack(const int4 v, float (&c)[8]) {  // int16 entries
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c[2 * i] = small_to_float(static_cast<int16_t>(w[i] & 0xFFFF));
    c[2 * i + 1] = small_to_float(w[i] >> 16);
  }
}

// Raw stage -> dequantized float tile [block][zz] (the stage itself for
// int32). The thread's chunks hold zig-zag entries zz0 .. zz0 + E - 1 of
// their blocks, and only the thread reads and writes them. Entries below
// 2^22 in magnitude (int16 always, int32 where the warp's all are) take the
// full-rate conversion; the result is the same float.
template <typename CoeffT, class R, bool kSmall, bool kOneTable>
__device__ __forceinline__ void convert_chunks(
    float* tile_s, const int4 (&v)[R::kChunksPerThread],
    const int32_t* __restrict__ quant, const float (&q_tile)[R::kPerChunk],
    int64_t first, int rows, int64_t blocks_per_table, int tid, int zz0) {
  constexpr int E = R::kPerChunk;
#pragma unroll
  for (int k = 0; k < R::kChunksPerThread; ++k) {
    const int b = (tid + k * R::kThreadsPerTile) / R::kChunksPerRow;
    float c[E];
    unpack<kSmall>(v[k], c);
    float q[E];
    if constexpr (kOneTable) {
#pragma unroll
      for (int e = 0; e < E; ++e) q[e] = q_tile[e];
    } else if (b < rows) {
      load_quant(q, quant, (first + b) / blocks_per_table, zz0);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) q[e] = 0.0f;
    }
    float* dst = tile_s + b * kPitch + zz0;
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      *reinterpret_cast<float4*>(dst + 4 * i) = make_float4(
          __fmul_rn(c[4 * i], q[4 * i]), __fmul_rn(c[4 * i + 1], q[4 * i + 1]),
          __fmul_rn(c[4 * i + 2], q[4 * i + 2]), __fmul_rn(c[4 * i + 3], q[4 * i + 3]));
    }
  }
}

template <typename CoeffT, class R>
__device__ __forceinline__ void convert_tile(
    float* tile_s, const unsigned char* stage, const int32_t* __restrict__ quant,
    const float (&q_tile)[R::kPerChunk], bool one_table, int64_t first, int rows,
    int64_t blocks_per_table, int tid, int zz0) {
  int4 v[R::kChunksPerThread];
  bool small = true;
#pragma unroll
  for (int k = 0; k < R::kChunksPerThread; ++k) {
    const int g = tid + k * R::kThreadsPerTile;
    v[k] = *reinterpret_cast<const int4*>(stage + (g / R::kChunksPerRow) * R::kRowPitch
                                          + 16 * (g % R::kChunksPerRow));
    small = small && is_small(v[k].x) && is_small(v[k].y) && is_small(v[k].z)
            && is_small(v[k].w);
  }
  // Both conditions are the same for the whole warp, so each call runs one
  // straight-line path.
  small = sizeof(CoeffT) == 2 || __all_sync(0xFFFFFFFFu, small);
  if (one_table) {
    if (small) {
      convert_chunks<CoeffT, R, true, true>(tile_s, v, quant, q_tile, first, rows,
                                            blocks_per_table, tid, zz0);
    } else {
      convert_chunks<CoeffT, R, false, true>(tile_s, v, quant, q_tile, first, rows,
                                             blocks_per_table, tid, zz0);
    }
  } else if (small) {
    convert_chunks<CoeffT, R, true, false>(tile_s, v, quant, q_tile, first, rows,
                                           blocks_per_table, tid, zz0);
  } else {
    convert_chunks<CoeffT, R, false, false>(tile_s, v, quant, q_tile, first, rows,
                                            blocks_per_table, tid, zz0);
  }
}

__device__ __forceinline__ void split(const float4 v, float* out) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// Round, shift and store the thread's samples as int32 blocks [n_blocks,
// W], 16 bytes per store.
template <int W>
struct BlockStore {
  int32_t* __restrict__ out;
  int level_shift;

  // W < 64: the Shape<W> tile of the CTA walk.
  template <bool kSmall, int kRows, int kCols>
  __device__ __forceinline__ void put(const float (&acc)[kRows][kCols], int64_t first, int rows,
                                      int b0, int cg) const {
    using S = Shape<W>;
    if constexpr (W == 1) {  // lanes 4m .. 4m + 3 hold 4 consecutive blocks' samples
      const int64_t t = first + b0;
      const int s = rint_shift<kSmall>(acc[0][0], level_shift);
      const int s1 = __shfl_down_sync(0xFFFFFFFFu, s, 1);
      const int s2 = __shfl_down_sync(0xFFFFFFFFu, s, 2);
      const int s3 = __shfl_down_sync(0xFFFFFFFFu, s, 3);
      if ((b0 & ~3) + 3 < rows) {
        if ((b0 & 3) == 0) *reinterpret_cast<int4*>(out + t) = make_int4(s, s1, s2, s3);
      } else if (b0 < rows) {
        out[t] = s;
      }
    } else {  // 4 consecutive columns of a block per store
#pragma unroll
      for (int j = 0; j < S::kRows; ++j) {
        const int b = b0 + j * S::kRowStride;
        if (b < rows) {
          const float* a = acc[j];
          *reinterpret_cast<int4*>(out + (first + b) * W + 4 * cg) = make_int4(
              rint_shift<kSmall>(a[0], level_shift), rint_shift<kSmall>(a[1], level_shift),
              rint_shift<kSmall>(a[2], level_shift), rint_shift<kSmall>(a[3], level_shift));
        }
      }
    }
  }

  // W = 64: lane (r, c)'s blocks r + 4j of the warp tile, columns 4c ..
  // 4c + 3 (acc[j][0..3]) and 32 + 4c .. 32 + 4c + 3 (acc[j][4..7]).
  template <bool kSmall>
  __device__ __forceinline__ void put_warp(const float (&acc)[8][8], int64_t first, int rows,
                                           int r, int c) const {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (r + 4 * j < rows) {
        int32_t* at = out + (first + r + 4 * j) * 64 + 4 * c;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* a = acc[j] + 4 * h;
          *reinterpret_cast<int4*>(at + 32 * h) = make_int4(
              rint_shift<kSmall>(a[0], level_shift), rint_shift<kSmall>(a[1], level_shift),
              rint_shift<kSmall>(a[2], level_shift), rint_shift<kSmall>(a[3], level_shift));
        }
      }
    }
  }
};

// Round, shift, clamp to [0, max_sample] and store the thread's samples as
// uint16 into the raster plane, 8 bytes per store: block t of the launch is
// block (t / wb, t % wb) of the plane [n_blocks / wb * 8, wb * 8]. Block
// indices fit 32 bits (the launcher checks).
struct PlaneStore {
  uint16_t* __restrict__ out;
  unsigned wb;  // blocks a block row
  int level_shift;
  int max_sample;

  // Two samples packed into a word. The fast path takes rint, the shift and
  // the clamp in an add and one DPX operation, max(min(x + y, z), 0).
  template <bool kSmall>
  __device__ __forceinline__ unsigned pair(float a0, float a1) const {
    int s0, s1;
    if constexpr (kSmall) {
      s0 = __viaddmin_s32_relu(__float_as_int(__fadd_rn(a0, 12582912.0f)),
                               level_shift - 0x4B400000, max_sample);
      s1 = __viaddmin_s32_relu(__float_as_int(__fadd_rn(a1, 12582912.0f)),
                               level_shift - 0x4B400000, max_sample);
    } else {
      s0 = min(max(__float2int_rn(a0) + level_shift, 0), max_sample);
      s1 = min(max(__float2int_rn(a1) + level_shift, 0), max_sample);
    }
    return __byte_perm(s0, s1, 0x5410);  // the low halves: s0 | s1 << 16
  }

  // Lane (r, c)'s blocks r + 4j of the warp tile: columns 4c .. 4c + 3 are
  // row c / 2 of a block from column 4 (c % 2), columns 32 + 4c .. 32 + 4c
  // + 3 the same columns of row 4 + c / 2.
  template <bool kSmall>
  __device__ __forceinline__ void put_warp(const float (&acc)[8][8], int64_t first, int rows,
                                           int r, int c) const {
    const unsigned t0 = static_cast<unsigned>(first) + r;
    unsigned block_row = t0 / wb;
    unsigned col = t0 - block_row * wb;
    const int64_t pitch = static_cast<int64_t>(wb) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (r + 4 * j < rows) {
        const float* a = acc[j];
        uint16_t* at = out + (static_cast<int64_t>(block_row) * 8 + c / 2) * pitch + col * 8
                       + 4 * (c & 1);
        *reinterpret_cast<uint2*>(at) =
            make_uint2(pair<kSmall>(a[0], a[1]), pair<kSmall>(a[2], a[3]));
        *reinterpret_cast<uint2*>(at + 4 * pitch) =
            make_uint2(pair<kSmall>(a[4], a[5]), pair<kSmall>(a[6], a[7]));
      }
      col += 4;  // the lane's next block
      while (col >= wb) {
        col -= wb;
        ++block_row;
      }
    }
  }
};

// W < 64: the thread's samples of the CTA tile, each summed over zz = 0..63
// in order.
template <int W, class Store>
__device__ __forceinline__ void compute_tile(const float* k_s, const float* tile_s,
                                             const Store& store, int64_t first, int rows,
                                             int tid) {
  using S = Shape<W>;
  if (tid >= S::kWorkers) return;
  const int cg = tid % S::kColGroups;
  const int b0 = tid / S::kColGroups;
  float acc[S::kRows][S::kCols];
#pragma unroll
  for (int j = 0; j < S::kRows; ++j) {
#pragma unroll
    for (int c = 0; c < S::kCols; ++c) acc[j][c] = 0.0f;
  }

  // All 16 steps unrolled, so each thread's loads are in flight together.
#pragma unroll
  for (int zq = 0; zq < 16; ++zq) {  // zig-zag steps 4 zq .. 4 zq + 3
    float d[S::kRows][4];
#pragma unroll
    for (int j = 0; j < S::kRows; ++j) {
      split(*reinterpret_cast<const float4*>(tile_s + (b0 + j * S::kRowStride) * kPitch
                                              + 4 * zq), d[j]);
    }
    float k[4][S::kCols];
    if constexpr (W == 1) {  // K is one column: 4 steps in one load
      float kv[4];
      split(*reinterpret_cast<const float4*>(k_s + 4 * zq), kv);
#pragma unroll
      for (int i = 0; i < 4; ++i) k[i][0] = kv[i];
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        split(*reinterpret_cast<const float4*>(k_s + (4 * zq + i) * W + 4 * cg), k[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < S::kRows; ++j) {
#pragma unroll
        for (int c = 0; c < S::kCols; ++c) acc[j][c] = __fmaf_rn(d[j][i], k[i][c], acc[j][c]);
      }
    }
  }

  bool small = true;
#pragma unroll
  for (int j = 0; j < S::kRows; ++j) {
#pragma unroll
    for (int c = 0; c < S::kCols; ++c) small = small && rint_is_small(acc[j][c]);
  }
  if (__all_sync(0xFFFFFFFFu, small)) {
    store.template put<true>(acc, first, rows, b0, cg);
  } else {
    store.template put<false>(acc, first, rows, b0, cg);
  }
}

// W = 64: lane (r, c)'s 8 x 8 samples of the warp tile, each summed over
// zz = 0..63 in order.
template <class Store>
__device__ __forceinline__ void compute_warp_tile(const float* k_s, const float* tile_s,
                                                  const Store& store, int64_t first, int rows,
                                                  int lane) {
  const int r = lane / 8;
  const int c = lane % 8;
  float acc[8][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[j][n] = 0.0f;
  }
  const float* d_at = tile_s + r * kPitch;  // block r + 4j at + 4j * kPitch
  const float* k_at = k_s + 4 * c;          // step zz at + zz * 64, the second half + 32

  // K stays in registers for 4 steps (32 of them); each block's 4 steps
  // are one load, each used by 8 FFMA in a row. Held this way, ptxas gives
  // the FFMA fewer register bank conflicts than with the blocks' steps held
  // and K loaded a step at a time (24% against 35% of them, by its SASS).
#pragma unroll 2
  for (int zq = 0; zq < 16; ++zq) {  // zig-zag steps 4 zq .. 4 zq + 3
    float k[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      split(*reinterpret_cast<const float4*>(k_at + (4 * zq + i) * 64), k[i]);
      split(*reinterpret_cast<const float4*>(k_at + (4 * zq + i) * 64 + 32), k[i] + 4);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float d[4];
      split(*reinterpret_cast<const float4*>(d_at + 4 * j * kPitch + 4 * zq), d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[j][n] = __fmaf_rn(d[i], k[i][n], acc[j][n]);
      }
    }
  }

  // rint_is_small on the largest magnitude: one FMNMX a sample. The sums
  // are finite (integer inputs below 2^31 times the matrix), so no NaN can
  // slip past the max.
  float largest = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int n = 0; n < 8; ++n) largest = fmaxf(largest, fabsf(acc[j][n]));
  }
  if (__all_sync(0xFFFFFFFFu, rint_is_small(largest))) {
    store.template put_warp<true>(acc, first, rows, r, c);
  } else {
    store.template put_warp<false>(acc, first, rows, r, c);
  }
}

// W < 64: the persistent walk of the CTA over tiles of 128 blocks, each
// stored by `store`.
template <typename CoeffT, int W, class Store>
__device__ __forceinline__ void walk_tiles(const CoeffT* __restrict__ coeffs,
                                           const int32_t* __restrict__ quant,
                                           const float* __restrict__ matrix,
                                           int64_t n_blocks, int64_t blocks_per_table,
                                           const Store& store) {
  using R = CtaRaw<CoeffT>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);
  unsigned char* stages = reinterpret_cast<unsigned char*>(k_s + 64 * W);
  float* float_s = reinterpret_cast<float*>(stages + 2 * R::kStageBytes);  // int16 only

  const int tid = threadIdx.x;
  const int64_t n_tiles = (n_blocks + kTile - 1) / kTile;
  const int64_t step = gridDim.x;
  const auto* bytes = reinterpret_cast<const unsigned char*>(coeffs);

  int64_t tile = blockIdx.x;
  issue_tile<R>(stages, bytes, tile, n_tiles, n_blocks, tid);
  for (int i = tid; i < 64 * W; i += kThreads) k_s[i] = matrix[i];  // while the tile arrives

  constexpr int E = R::kPerChunk;
  const int zz0 = E * (tid % R::kChunksPerRow);
  float q_tile[E];
  int64_t q_table = -1;
  for (int it = 0; tile < n_tiles; ++it, tile += step) {
    const int64_t first = tile * kTile;
    const int rows = static_cast<int>(n_blocks - first < kTile ? n_blocks - first : kTile);
    const int64_t table0 = first / blocks_per_table;
    const bool one_table = (first + rows - 1) / blocks_per_table == table0;
    if (one_table && table0 != q_table) {
      load_quant(q_tile, quant, table0, zz0);
      q_table = table0;
    }
    unsigned char* stage = stages + (it & 1) * R::kStageBytes;
    float* tile_s = R::kInPlace ? reinterpret_cast<float*>(stage) : float_s;
    cp_async_wait_all();  // this tile has landed (the only group in flight)
    __syncthreads();      // every thread's copies; the last tile's compute is done
    // The next tile streams in while this one is converted and computed.
    issue_tile<R>(stages + ((it + 1) & 1) * R::kStageBytes, bytes, tile + step, n_tiles,
                  n_blocks, tid);
    convert_tile<CoeffT, R>(tile_s, stage, quant, q_tile, one_table, first, rows,
                            blocks_per_table, tid, zz0);
    __syncthreads();
    compute_tile<W>(k_s, tile_s, store, first, rows, tid);
  }
}

// W = 64: each warp's walk over its own tiles of 32 blocks (tile warp *
// grid + cta, then every kWarps * grid), each stored by `store`. The CTA
// meets at one barrier, once K is staged. A warp has one raw stage: once a
// tile is converted into the float tile, the next tile's copy goes into
// it and lands while this one is multiplied.
template <typename CoeffT, class Store>
__device__ __forceinline__ void walk_warp_tiles(const CoeffT* __restrict__ coeffs,
                                                const int32_t* __restrict__ quant,
                                                const float* __restrict__ matrix,
                                                int64_t n_blocks, int64_t blocks_per_table,
                                                const Store& store) {
  using R = WarpRaw<CoeffT>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  unsigned char* stage = smem + 64 * 64 * 4 + warp * warp_bytes<CoeffT>();
  float* tile_s = reinterpret_cast<float*>(stage + R::kStageBytes);

  const int64_t n_tiles = (n_blocks + kWarpTile - 1) / kWarpTile;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps;
  const auto* bytes = reinterpret_cast<const unsigned char*>(coeffs);

  int64_t tile = static_cast<int64_t>(warp) * gridDim.x + blockIdx.x;
  issue_tile<R>(stage, bytes, tile, n_tiles, n_blocks, lane);
  for (int i = threadIdx.x; i < 64 * 64; i += 32 * kWarps) k_s[i] = matrix[i];
  __syncthreads();  // K is staged; from here on each warp walks alone

  constexpr int E = R::kPerChunk;
  const int zz0 = E * (lane % R::kChunksPerRow);
  float q_tile[E];
  int64_t q_table = -1;
  for (; tile < n_tiles; tile += step) {
    const int64_t first = tile * kWarpTile;
    const int rows =
        static_cast<int>(n_blocks - first < kWarpTile ? n_blocks - first : kWarpTile);
    const int64_t table0 = first / blocks_per_table;
    const bool one_table = (first + rows - 1) / blocks_per_table == table0;
    if (one_table && table0 != q_table) {
      load_quant(q_tile, quant, table0, zz0);
      q_table = table0;
    }
    cp_async_wait_all();  // this tile has landed (the only group in flight)
    __syncwarp();         // every lane's copies; the last tile's product is done
    convert_tile<CoeffT, R>(tile_s, stage, quant, q_tile, one_table, first, rows,
                            blocks_per_table, lane, zz0);
    __syncwarp();  // the float tile is whole and the stage free
    issue_tile<R>(stage, bytes, tile + step, n_tiles, n_blocks, lane);
    compute_warp_tile(k_s, tile_s, store, first, rows, lane);
  }
}

template <typename CoeffT, int W>
__global__ void __launch_bounds__(Layout<W>::kCtaThreads, Layout<W>::kMinCtas)
dequant_idct_kernel(const CoeffT* __restrict__ coeffs,
                    const int32_t* __restrict__ quant,
                    const float* __restrict__ matrix,
                    int32_t* __restrict__ out,
                    int64_t n_blocks, int64_t blocks_per_table, int level_shift) {
  if constexpr (W == 64) {
    walk_warp_tiles<CoeffT>(coeffs, quant, matrix, n_blocks, blocks_per_table,
                            BlockStore<64>{out, level_shift});
  } else {
    walk_tiles<CoeffT, W>(coeffs, quant, matrix, n_blocks, blocks_per_table,
                          BlockStore<W>{out, level_shift});
  }
}

template <typename CoeffT>
__global__ void __launch_bounds__(Layout<64>::kCtaThreads, Layout<64>::kMinCtas)
dequant_idct_plane_kernel(const CoeffT* __restrict__ coeffs,
                          const int32_t* __restrict__ quant,
                          const float* __restrict__ matrix,
                          uint16_t* __restrict__ out,
                          int64_t n_blocks, int64_t blocks_per_table, unsigned width_blocks,
                          int level_shift, int max_sample) {
  walk_warp_tiles<CoeffT>(coeffs, quant, matrix, n_blocks, blocks_per_table,
                          PlaneStore{out, width_blocks, level_shift, max_sample});
}

// CTAs of one instantiation that fit on an SM of `device`, found once per
// device (the dynamic shared memory limit is raised on the same visit).
template <typename CoeffT, int W, bool kPlane>
cudaError_t ctas_per_sm(int device, int* out) {
  static_assert(!kPlane || W == 64, "the plane store is of full blocks");
  static int known[kMaxDevices] = {};
  if (device < kMaxDevices && known[device] > 0) {
    *out = known[device];
    return cudaSuccess;
  }
  const void* kernel;
  if constexpr (kPlane) {
    kernel = reinterpret_cast<const void*>(dequant_idct_plane_kernel<CoeffT>);
  } else {
    kernel = reinterpret_cast<const void*>(dequant_idct_kernel<CoeffT, W>);
  }
  constexpr int smem = shared_bytes<CoeffT, W>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, Layout<W>::kCtaThreads, smem);
  if (err != cudaSuccess) return err;
  if (n < 1) return cudaErrorInvalidConfiguration;
  if (device < kMaxDevices) known[device] = n;
  *out = n;
  return cudaSuccess;
}

// The persistent grid: one CTA a tile (a CTA's at W < 64, a warp's at W =
// 64), at most as many as fit on the SMs.
template <typename CoeffT, int W, bool kPlane>
cudaError_t grid_size(int64_t n_blocks, int64_t* grid) {
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = ctas_per_sm<CoeffT, W, kPlane>(device, &per_sm);
  if (err != cudaSuccess) return err;
  constexpr int kBlocks = Layout<W>::kTileBlocks;
  const int64_t n_tiles = (n_blocks + kBlocks - 1) / kBlocks;
  const int64_t slots = static_cast<int64_t>(sms) * per_sm;
  *grid = n_tiles < slots ? n_tiles : slots;
  return cudaSuccess;
}

template <typename CoeffT, int W>
int launch_width(const void* coeffs, const void* quant, const void* matrix, void* out,
                 int64_t n_blocks, int64_t blocks_per_table, int level_shift,
                 cudaStream_t stream) {
  int64_t grid = 0;
  const cudaError_t err = grid_size<CoeffT, W, false>(n_blocks, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  dequant_idct_kernel<CoeffT, W><<<static_cast<unsigned>(grid), Layout<W>::kCtaThreads,
                                   shared_bytes<CoeffT, W>(), stream>>>(
      static_cast<const CoeffT*>(coeffs), static_cast<const int32_t*>(quant),
      static_cast<const float*>(matrix), static_cast<int32_t*>(out), n_blocks,
      blocks_per_table, level_shift);
  return static_cast<int>(cudaGetLastError());
}

template <typename CoeffT>
int launch(const void* coeffs, const void* quant, const void* matrix, void* out,
           int64_t n_blocks, int64_t blocks_per_table, int out_width, int level_shift,
           void* stream) {
  if (n_blocks <= 0) return 0;
  if (blocks_per_table <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies, quant rows and stores.
  const auto addresses = reinterpret_cast<uintptr_t>(coeffs) | reinterpret_cast<uintptr_t>(quant)
                         | reinterpret_cast<uintptr_t>(out);
  if (addresses & 15) return static_cast<int>(cudaErrorMisalignedAddress);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (out_width) {
    case 64:
      return launch_width<CoeffT, 64>(coeffs, quant, matrix, out, n_blocks,
                                      blocks_per_table, level_shift, s);
    case 16:
      return launch_width<CoeffT, 16>(coeffs, quant, matrix, out, n_blocks,
                                      blocks_per_table, level_shift, s);
    case 4:
      return launch_width<CoeffT, 4>(coeffs, quant, matrix, out, n_blocks,
                                     blocks_per_table, level_shift, s);
    case 1:
      return launch_width<CoeffT, 1>(coeffs, quant, matrix, out, n_blocks,
                                     blocks_per_table, level_shift, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_plane(const void* coeffs, const void* quant, const void* matrix, void* out,
                 int64_t n_blocks, int64_t blocks_per_table, int64_t width_blocks,
                 int level_shift, int max_sample, void* stream) {
  if (n_blocks <= 0) return 0;
  if (blocks_per_table <= 0 || width_blocks <= 0 || n_blocks % width_blocks != 0
      || n_blocks + kTile >= (int64_t{1} << 31) || max_sample < 0 || max_sample > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // 16-byte copies and quant rows; 8-byte stores at multiples of 8 samples.
  const auto addresses = reinterpret_cast<uintptr_t>(coeffs) | reinterpret_cast<uintptr_t>(quant);
  if ((addresses & 15) || (reinterpret_cast<uintptr_t>(out) & 7)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  int64_t grid = 0;
  const cudaError_t err = grid_size<int16_t, 64, true>(n_blocks, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  dequant_idct_plane_kernel<int16_t><<<static_cast<unsigned>(grid), Layout<64>::kCtaThreads,
                                       shared_bytes<int16_t, 64>(),
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(coeffs), static_cast<const int32_t*>(quant),
      static_cast<const float*>(matrix), static_cast<uint16_t*>(out), n_blocks,
      blocks_per_table, static_cast<unsigned>(width_blocks), level_shift, max_sample);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coeffs [n_blocks, 64] zig-zag (int32 or int16); quant [G, 64] int32 zig-zag
// with G = ceil(n_blocks / blocks_per_table), block t taking row
// t / blocks_per_table; matrix [64, out_width] fp32; out [n_blocks,
// out_width] int32 row-major n x n samples (out_width = n * n, one of 64,
// 16, 4, 1); all contiguous device memory, coeffs, quant and out 16-byte
// aligned. Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for an unknown width, cudaErrorMisalignedAddress
// for an unaligned pointer).
extern "C" int jpx_dequant_idct_i32(const void* coeffs, const void* quant,
                                    const void* matrix, void* out,
                                    int64_t n_blocks, int64_t blocks_per_table,
                                    int out_width, int level_shift, void* stream) {
  return launch<int32_t>(coeffs, quant, matrix, out, n_blocks, blocks_per_table,
                         out_width, level_shift, stream);
}

extern "C" int jpx_dequant_idct_i16(const void* coeffs, const void* quant,
                                    const void* matrix, void* out,
                                    int64_t n_blocks, int64_t blocks_per_table,
                                    int out_width, int level_shift, void* stream) {
  return launch<int16_t>(coeffs, quant, matrix, out, n_blocks, blocks_per_table,
                         out_width, level_shift, stream);
}

// coeffs [n_blocks, 64] int16 zig-zag, block t of a raster of block rows of
// width_blocks blocks (n_blocks a multiple of it, below 2^31); quant and
// matrix as above, the matrix [64, 64]; out [n_blocks / width_blocks * 8,
// width_blocks * 8] uint16, the samples clamp(rint(IDCT) + level_shift, 0,
// max_sample) in raster order; all contiguous device memory, coeffs and quant
// 16-byte aligned, out 8-byte aligned. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for sizes it does not take,
// cudaErrorMisalignedAddress for an unaligned pointer).
extern "C" int jpx_dequant_idct_plane_u16(const void* coeffs, const void* quant,
                                          const void* matrix, void* out, int64_t n_blocks,
                                          int64_t blocks_per_table, int64_t width_blocks,
                                          int level_shift, int max_sample, void* stream) {
  return launch_plane(coeffs, quant, matrix, out, n_blocks, blocks_per_table, width_blocks,
                      level_shift, max_sample, stream);
}

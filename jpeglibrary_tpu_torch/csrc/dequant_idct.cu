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
// What bounds it on Hopper: bytes. At W = 64 a block reads 256 B of int32
// coefficients (128 B as int16) and writes 256 B of int32 samples for 4,096
// FFMA: 65,536 blocks move 33.5 MB, 10.0 us at 3.35 TB/s, against 268 M
// FFMA, 8.0 us at 67 TFLOP/s. At W < 64 the FFMA work and the writes shrink
// with W and the coefficient reads (16.8 MB per 65,536 blocks) are the bound.
// The kernel's first design (one scalar load per element, then a barrier,
// then a loop of 17 scalar shared loads per 16 FFMA) kept no bytes in flight
// while it computed and reached 19-33% of that bound. This design:
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
// 3. Register tiling. At W = 64 a thread computes 8 blocks x 4 columns: per
//    4 zig-zag steps it loads 8 float4 of the tile (4 steps of one block
//    each) and 4 float4 of K (4 columns of one step each) for 128 FFMA (the
//    first design: 17 scalar loads per 16 FFMA). The 16 lanes that share
//    blocks read them as one broadcast; a quarter-warp's K loads are 8
//    consecutive float4. K is staged once per CTA. The loop body, unrolled
//    twice, is 256 FFMA and 24 loads. The tile stays [block][zz], not
//    transposed: int32 then converts in place, and 4 zig-zag steps of a
//    block are one 16-byte load all the same.
// 4. 16-byte stores: a thread stores 4 consecutive int32 samples (4 columns
//    of a block; at W = 1, 4 lanes' blocks gathered by shuffles), coalesced
//    along each row.
// 5. The reduced widths keep 1, 2 and 4 with smaller thread tiles (Shape
//    below); their FFMA work is small beside the coefficient reads.
//
// Measured on an H100 (see PERF.md): 39-46% of the bound at 65,536 blocks
// and 52% at 8 x 65,536. Estimated from per-phase clock64 timings and the
// SASS: about a quarter of the issue slots go to staging, conversion and
// the epilogue, and the SMs issue at about three quarters of their rate. A
// warp-wide 16-byte shared load costs an SM about 2 cycles (measured), the
// loop's FFMA 2.7 cycles per load, so shared memory is close to but not at
// its limit.
//
// Each accumulator still sums zz = 0..63 in ascending order with one fp32
// FFMA per step from 0.0f, so the outputs equal the first design's bit for
// bit. Tensor cores (wgmma, 3xTF32) are not used: the bytes, not the FFMA,
// bound the kernel at W = 64, and 3xTF32 would need its own proof of the
// 1-LSB contract. They return once the densify is fused into the load and
// the bytes shrink.
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

constexpr int kThreads = 256;
constexpr int kTile = 128;      // blocks per tile
constexpr int kPitch = 68;      // floats per row of the float tile (16 B of padding)
constexpr int kMaxDevices = 64;

// The raw tile of one coefficient type: rows of 64 zig-zag entries, staged
// 16 bytes at a time into rows padded by one chunk. int32 rows convert to
// fp32 in place (the float tile is the stage itself); int16 rows convert
// into a separate float tile.
template <typename CoeffT>
struct Raw {
  static constexpr bool kInPlace = sizeof(CoeffT) == 4;
  static constexpr int kRowBytes = 64 * static_cast<int>(sizeof(CoeffT));  // 256 or 128
  static constexpr int kRowPitch = kRowBytes + 16;                         // 272 or 144
  static constexpr int kChunksPerRow = kRowBytes / 16;                     // 16 or 8
  static constexpr int kPerChunk = 16 / static_cast<int>(sizeof(CoeffT));   // 4 or 8 entries
  static constexpr int kChunksPerThread = kTile * kChunksPerRow / kThreads;
  static constexpr int kStageBytes = kTile * kRowPitch;
  static_assert(kTile * kChunksPerRow % kThreads == 0, "whole chunks per thread");
  static_assert(kThreads % kChunksPerRow == 0, "a thread keeps its zig-zag entries");
  static_assert(!kInPlace || kRowPitch == kPitch * 4, "in place, a raw row is a float row");
};

// The thread tile at output width W: kRows blocks (g, g + kRowStride, ...
// for block group g) by kCols consecutive columns. kWorkers threads cover
// the tile's kTile x W samples: all of the CTA at W = 64 and 16, half of it
// at W = 4 and 1.
template <int W>
struct Shape {
  static constexpr int kRows = W == 64 ? 8 : (W == 16 ? 2 : 1);  // 8 x 4 at W = 64
  static constexpr int kCols = W == 1 ? 1 : 4;  // at W = 1, 4 lanes meet in one store
  static constexpr int kColGroups = W / kCols;
  static constexpr int kRowStride = kTile / kRows;  // the number of block groups
  static constexpr int kWorkers = kColGroups * kRowStride;  // 256, 256, 128, 128
  static_assert(kWorkers % 32 == 0 && kWorkers <= kThreads, "whole warps, one tile each");
};

template <typename CoeffT, int W>
constexpr int shared_bytes() {
  return 64 * W * 4 + 2 * Raw<CoeffT>::kStageBytes
         + (Raw<CoeffT>::kInPlace ? 0 : kTile * kPitch * 4);
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

// Start copying tile `tile` into `stage` (nothing past the last tile).
template <typename CoeffT>
__device__ __forceinline__ void issue_tile(unsigned char* stage, const unsigned char* coeffs,
                                           int64_t tile, int64_t n_tiles, int64_t n_blocks,
                                           int tid) {
  using R = Raw<CoeffT>;
  if (tile >= n_tiles) return;
  const int64_t first = tile * kTile;
#pragma unroll
  for (int k = 0; k < R::kChunksPerThread; ++k) {
    const int g = tid + k * kThreads;
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
template <typename CoeffT, bool kSmall, bool kOneTable>
__device__ __forceinline__ void convert_chunks(
    float* tile_s, const int4 (&v)[Raw<CoeffT>::kChunksPerThread],
    const int32_t* __restrict__ quant, const float (&q_tile)[Raw<CoeffT>::kPerChunk],
    int64_t first, int rows, int64_t blocks_per_table, int tid, int zz0) {
  using R = Raw<CoeffT>;
  constexpr int E = R::kPerChunk;
#pragma unroll
  for (int k = 0; k < R::kChunksPerThread; ++k) {
    const int b = (tid + k * kThreads) / R::kChunksPerRow;
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

template <typename CoeffT>
__device__ __forceinline__ void convert_tile(
    float* tile_s, const unsigned char* stage, const int32_t* __restrict__ quant,
    const float (&q_tile)[Raw<CoeffT>::kPerChunk], bool one_table, int64_t first, int rows,
    int64_t blocks_per_table, int tid, int zz0) {
  using R = Raw<CoeffT>;
  int4 v[R::kChunksPerThread];
  bool small = true;
#pragma unroll
  for (int k = 0; k < R::kChunksPerThread; ++k) {
    const int g = tid + k * kThreads;
    v[k] = *reinterpret_cast<const int4*>(stage + (g / R::kChunksPerRow) * R::kRowPitch
                                          + 16 * (g % R::kChunksPerRow));
    small = small && is_small(v[k].x) && is_small(v[k].y) && is_small(v[k].z)
            && is_small(v[k].w);
  }
  // Both conditions are the same for the whole warp, so each call runs one
  // straight-line path.
  small = !R::kInPlace || __all_sync(0xFFFFFFFFu, small);
  if (one_table) {
    if (small) {
      convert_chunks<CoeffT, true, true>(tile_s, v, quant, q_tile, first, rows,
                                         blocks_per_table, tid, zz0);
    } else {
      convert_chunks<CoeffT, false, true>(tile_s, v, quant, q_tile, first, rows,
                                          blocks_per_table, tid, zz0);
    }
  } else if (small) {
    convert_chunks<CoeffT, true, false>(tile_s, v, quant, q_tile, first, rows,
                                        blocks_per_table, tid, zz0);
  } else {
    convert_chunks<CoeffT, false, false>(tile_s, v, quant, q_tile, first, rows,
                                         blocks_per_table, tid, zz0);
  }
}

__device__ __forceinline__ void split(const float4 v, float* out) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// Round, shift and store the thread's samples, 16 bytes per store.
template <int W, bool kSmall>
__device__ __forceinline__ void store_tile(const float (&acc)[Shape<W>::kRows][Shape<W>::kCols],
                                           int32_t* __restrict__ out, int64_t first, int rows,
                                           int level_shift, int b0, int cg) {
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

// The thread's samples of the tile, each summed over zz = 0..63 in order.
template <int W>
__device__ __forceinline__ void compute_tile(const float* k_s, const float* tile_s,
                                             int32_t* __restrict__ out, int64_t first,
                                             int rows, int level_shift, int tid) {
  using S = Shape<W>;
  if (tid >= S::kWorkers) return;
  // The narrow widths unroll their 16 steps, so each thread's loads are in
  // flight together; W = 64 unrolls two, a body of 256 FFMA and 24 loads.
  constexpr int kUnroll = W == 64 ? 2 : 16;
  const int cg = tid % S::kColGroups;
  const int b0 = tid / S::kColGroups;
  float acc[S::kRows][S::kCols];
#pragma unroll
  for (int j = 0; j < S::kRows; ++j) {
#pragma unroll
    for (int c = 0; c < S::kCols; ++c) acc[j][c] = 0.0f;
  }

#pragma unroll kUnroll
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
    store_tile<W, true>(acc, out, first, rows, level_shift, b0, cg);
  } else {
    store_tile<W, false>(acc, out, first, rows, level_shift, b0, cg);
  }
}

template <typename CoeffT, int W>
__global__ void __launch_bounds__(kThreads, 2)
dequant_idct_kernel(const CoeffT* __restrict__ coeffs,
                    const int32_t* __restrict__ quant,
                    const float* __restrict__ matrix,
                    int32_t* __restrict__ out,
                    int64_t n_blocks, int64_t blocks_per_table, int level_shift) {
  using R = Raw<CoeffT>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);
  unsigned char* stages = reinterpret_cast<unsigned char*>(k_s + 64 * W);
  float* float_s = reinterpret_cast<float*>(stages + 2 * R::kStageBytes);  // int16 only

  const int tid = threadIdx.x;
  const int64_t n_tiles = (n_blocks + kTile - 1) / kTile;
  const int64_t step = gridDim.x;
  const auto* bytes = reinterpret_cast<const unsigned char*>(coeffs);

  int64_t tile = blockIdx.x;
  issue_tile<CoeffT>(stages, bytes, tile, n_tiles, n_blocks, tid);
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
    issue_tile<CoeffT>(stages + ((it + 1) & 1) * R::kStageBytes, bytes, tile + step,
                       n_tiles, n_blocks, tid);
    convert_tile<CoeffT>(tile_s, stage, quant, q_tile, one_table, first, rows,
                         blocks_per_table, tid, zz0);
    __syncthreads();
    compute_tile<W>(k_s, tile_s, out, first, rows, level_shift, tid);
  }
}

// CTAs of one instantiation that fit on an SM of `device`, found once per
// device (the dynamic shared memory limit is raised on the same visit).
template <typename CoeffT, int W>
cudaError_t ctas_per_sm(int device, int* out) {
  static int known[kMaxDevices] = {};
  if (device < kMaxDevices && known[device] > 0) {
    *out = known[device];
    return cudaSuccess;
  }
  const auto kernel = dequant_idct_kernel<CoeffT, W>;
  constexpr int smem = shared_bytes<CoeffT, W>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (n < 1) return cudaErrorInvalidConfiguration;
  if (device < kMaxDevices) known[device] = n;
  *out = n;
  return cudaSuccess;
}

template <typename CoeffT, int W>
int launch_width(const void* coeffs, const void* quant, const void* matrix, void* out,
                 int64_t n_blocks, int64_t blocks_per_table, int level_shift,
                 cudaStream_t stream) {
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = ctas_per_sm<CoeffT, W>(device, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_tiles = (n_blocks + kTile - 1) / kTile;
  const int64_t slots = static_cast<int64_t>(sms) * per_sm;
  const int64_t grid = n_tiles < slots ? n_tiles : slots;
  dequant_idct_kernel<CoeffT, W><<<static_cast<unsigned>(grid), kThreads,
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

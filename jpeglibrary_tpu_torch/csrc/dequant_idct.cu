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
// of ops/kernels.fused_transform_matrix (un-zigzag, both 1-D AAN IDCT passes
// and the 1/8 scale folded into one linear map); at n < 8 the folded reduced
// IDCT of jpeglibrary_tpu.ops.decode_stage.scaled_folded_matrix(n). Block t
// dequantizes with table t / bpt (bpt = blocks per table), so one launch
// covers a batch of images that each carry their own tables.
//
// What bounds it on Hopper: at W = 64, bytes and shared-memory issue. Per
// output sample it reads 4 B of int32 coefficient (2 B as int16) and writes
// 4 B of int32, against 128 flop (64 FFMA), about 16 flop per byte: near
// the fp32 CUDA-core ridge of an H100 (67 TFLOP/s over 3.35 TB/s, 20
// flop/B). At W < 64 the FFMA work shrinks with W and the coefficient reads
// (256 B per block) dominate, so the narrow variants are bound by bytes.
// The design reads each coefficient from device memory once and writes
// each sample once: a CTA stages the matrix and one tile of dequantized
// blocks in shared memory, and every thread accumulates its samples from
// there in fp32 FFMA.
//
// Thread map, per output width W (Shape below): a CTA of kThreads threads
// owns kTile blocks; thread (group, col) computes output column col of the
// kRows blocks group, group + kGroups, ... So every thread has work at
// every width: 16 blocks per thread at W = 64, 4 at 16, 1 at 4 and 1.
// Where a warp spans several row groups (W < 64), the staged rows are 65
// floats apart, so the groups it reads at one zz fall on different banks.
//
// Precision: full fp32 FFMA, no TF32 and no fast-math. The dequant product
// is rounded on its own (__fmul_rn) before the dot, as the JAX kernel
// rounds it, so the compiler cannot contract it into the first FMA.
// Rounding is half to even (__float2int_rn), as jnp.rint.
//
// Left for later: wgmma/TMA or 3xTF32 for the product, register tiling
// with wide shared loads, and fusing the densify before the kernel and the
// upsample/colour after it.
//
// Bound through a plain C interface (ctypes); see ops/_build.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int W>
struct Shape {
  static constexpr int kThreads = W >= 4 ? 256 : 128;
  static constexpr int kGroups = kThreads / W;          // row groups
  static constexpr int kRows = W >= 16 ? W / 4 : 1;     // blocks per thread
  static constexpr int kTile = kGroups * kRows;         // blocks per CTA: 64, 64, 64, 128
  static constexpr int kStride = W == 64 ? 64 : 65;     // floats per staged block
  static_assert(kThreads % 64 == 0, "each thread loads one zig-zag index");
  static_assert(kTile * 64 % kThreads == 0, "the staging loop has no ragged tail");
};

template <typename CoeffT, int W>
__global__ void __launch_bounds__(Shape<W>::kThreads)
dequant_idct_kernel(const CoeffT* __restrict__ coeffs,
                    const int32_t* __restrict__ quant,
                    const float* __restrict__ matrix,
                    int32_t* __restrict__ out,
                    int64_t n_blocks, int64_t blocks_per_table, int level_shift) {
  using S = Shape<W>;
  __shared__ float k_s[64 * W];
  __shared__ float deq_s[S::kTile * S::kStride];

  const int tid = threadIdx.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * S::kTile;

  for (int i = tid; i < 64 * W; i += S::kThreads) k_s[i] = matrix[i];

  // kThreads is a multiple of 64, so every element this thread loads has
  // the same zig-zag index. While the CTA's blocks share one table (every
  // CTA of a single-table launch, and all but the CTAs that straddle two
  // images in a batch) one quant entry serves them all; otherwise each
  // block looks its table up.
  const int zz_load = tid & 63;
  const int64_t last = (first + S::kTile < n_blocks ? first + S::kTile : n_blocks) - 1;
  const int64_t table0 = first / blocks_per_table;
  const bool one_table = last / blocks_per_table == table0;
  const float q0 = static_cast<float>(quant[table0 * 64 + zz_load]);
  const int64_t limit = n_blocks * 64;
#pragma unroll 4
  for (int e = tid; e < S::kTile * 64; e += S::kThreads) {
    const int64_t g = first * 64 + e;
    float c = 0.0f;
    float q = q0;
    if (g < limit) {
      c = static_cast<float>(coeffs[g]);
      if (!one_table) {
        q = static_cast<float>(quant[((first + (e >> 6)) / blocks_per_table) * 64 + zz_load]);
      }
    }
    deq_s[(e >> 6) * S::kStride + zz_load] = __fmul_rn(c, q);
  }
  __syncthreads();

  // Thread (group, col) owns output column col of blocks group,
  // group + kGroups, ... At W = 64 a warp shares its row group, so deq_s
  // reads are broadcasts and k_s reads hit 32 consecutive banks.
  const int col = tid % W;
  const int group = tid / W;
  float acc[S::kRows];
#pragma unroll
  for (int r = 0; r < S::kRows; ++r) acc[r] = 0.0f;

#pragma unroll 4
  for (int zz = 0; zz < 64; ++zz) {
    const float kv = k_s[zz * W + col];
#pragma unroll
    for (int r = 0; r < S::kRows; ++r) {
      acc[r] = __fmaf_rn(deq_s[(group + r * S::kGroups) * S::kStride + zz], kv, acc[r]);
    }
  }

#pragma unroll
  for (int r = 0; r < S::kRows; ++r) {
    const int64_t t = first + group + r * S::kGroups;
    if (t < n_blocks) out[t * W + col] = __float2int_rn(acc[r]) + level_shift;
  }
}

template <typename CoeffT, int W>
int launch_width(const void* coeffs, const void* quant, const void* matrix, void* out,
                 int64_t n_blocks, int64_t blocks_per_table, int level_shift,
                 cudaStream_t stream) {
  using S = Shape<W>;
  const int64_t grid = (n_blocks + S::kTile - 1) / S::kTile;
  dequant_idct_kernel<CoeffT, W><<<static_cast<unsigned>(grid), S::kThreads, 0, stream>>>(
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
// 16, 4, 1); all contiguous device memory. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unknown width).
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

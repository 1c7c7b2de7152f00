// K1: dequantize + un-zigzag + 2-D IDCT + round + level shift, for a
// batch of 8x8 JPEG blocks.
//
// Replaces jpeglibrary_tpu/ops/pallas_kernels.py::_kernel, the Pallas
// kernel of the TPU decode transform. Same arithmetic:
//
//   out[t, 8i+j] = rint( sum_zz fl(c[t, zz] * q[zz]) * K[zz, 8i+j] ) + level_shift
//
// where K is the [64, 64] fp32 matrix of ops/kernels.fused_transform_matrix
// (un-zigzag, both 1-D AAN IDCT passes and the 1/8 scale folded into one
// linear map).
//
// What bounds it on Hopper: bytes. Per output sample it reads 4 B of int32
// coefficient (2 B as int16) and writes 4 B of int32, against 128 flop
// (64 FFMA), about 16 flop per byte: near the fp32 CUDA-core ridge of an
// H100 (67 TFLOP/s over 3.35 TB/s, 20 flop/B). So the design reads each
// coefficient from device memory once and writes each sample once: a CTA
// stages the 16 KB matrix and one tile of dequantized blocks in shared
// memory, and every thread accumulates its samples from there in fp32 FFMA.
//
// Precision: full fp32 FFMA, no TF32 and no fast-math. The dequant product
// is rounded on its own (__fmul_rn) before the dot, as the JAX kernel
// rounds it, so the compiler cannot contract it into the first FMA.
// Rounding is half to even (__float2int_rn), as jnp.rint.
//
// Left for later: wgmma/TMA or 3xTF32 for the product, and fusing the v2
// densify before the kernel and the upsample/colour after it.
//
// Bound through a plain C interface (ctypes); see ops/_build.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;                             // blocks per CTA
constexpr int kThreads = 256;                         // 64 columns x 4 row groups
constexpr int kRowGroups = kThreads / 64;
constexpr int kRowsPerThread = kTile / kRowGroups;    // 16 accumulators

template <typename CoeffT>
__global__ void __launch_bounds__(kThreads)
dequant_idct_kernel(const CoeffT* __restrict__ coeffs,
                    const int32_t* __restrict__ quant,
                    const float* __restrict__ matrix,
                    int32_t* __restrict__ out,
                    int64_t n_blocks, int level_shift) {
  __shared__ float k_s[64 * 64];
  __shared__ float deq_s[kTile * 64];

  const int tid = threadIdx.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kTile;

  for (int i = tid; i < 64 * 64; i += kThreads) k_s[i] = matrix[i];

  // kThreads is a multiple of 64, so every element this thread loads has
  // the same zig-zag index and needs the same quant entry.
  const float q = static_cast<float>(quant[tid & 63]);
  const int64_t base = first * 64;
  const int64_t limit = n_blocks * 64;
  for (int e = tid; e < kTile * 64; e += kThreads) {
    const int64_t g = base + e;
    const float c = g < limit ? static_cast<float>(coeffs[g]) : 0.0f;
    deq_s[e] = __fmul_rn(c, q);
  }
  __syncthreads();

  // Thread (group, col) owns output column col of rows group, group + 4, ...
  // A warp shares its row group, so deq_s reads are broadcasts and k_s
  // reads hit 32 consecutive banks.
  const int col = tid & 63;
  const int group = tid >> 6;
  float acc[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.0f;

#pragma unroll 4
  for (int zz = 0; zz < 64; ++zz) {
    const float kv = k_s[zz * 64 + col];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      acc[r] = __fmaf_rn(deq_s[(group + r * kRowGroups) * 64 + zz], kv, acc[r]);
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int64_t t = first + group + r * kRowGroups;
    if (t < n_blocks) out[t * 64 + col] = __float2int_rn(acc[r]) + level_shift;
  }
}

template <typename CoeffT>
int launch(const void* coeffs, const void* quant, const void* matrix, void* out,
           int64_t n_blocks, int level_shift, void* stream) {
  if (n_blocks <= 0) return 0;
  const int64_t grid = (n_blocks + kTile - 1) / kTile;
  dequant_idct_kernel<CoeffT><<<static_cast<unsigned>(grid), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const CoeffT*>(coeffs), static_cast<const int32_t*>(quant),
      static_cast<const float*>(matrix), static_cast<int32_t*>(out), n_blocks,
      level_shift);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coeffs [n_blocks, 64] zig-zag (int32 or int16), quant [64] int32 zig-zag,
// matrix [64, 64] fp32, out [n_blocks, 64] int32 row-major 8x8 samples; all
// contiguous device memory. Launches on `stream` and returns cudaGetLastError().
extern "C" int jpx_dequant_idct_i32(const void* coeffs, const void* quant,
                                    const void* matrix, void* out,
                                    int64_t n_blocks, int level_shift,
                                    void* stream) {
  return launch<int32_t>(coeffs, quant, matrix, out, n_blocks, level_shift, stream);
}

extern "C" int jpx_dequant_idct_i16(const void* coeffs, const void* quant,
                                    const void* matrix, void* out,
                                    int64_t n_blocks, int level_shift,
                                    void* stream) {
  return launch<int16_t>(coeffs, quant, matrix, out, n_blocks, level_shift, stream);
}

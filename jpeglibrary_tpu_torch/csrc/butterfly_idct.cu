// K4: the bit-exact decode transform of one component plane: dequantize +
// un-zigzag + the float32 AAN butterfly 2-D IDCT + rint + level shift, with
// the block-to-plane layout fused into the store.
//
// Counterpart of the JAX package's golden-parity device path,
// jpeglibrary_tpu/ops/decode_stage.py:32 dequantize_idct_shift (through
// ops/dct.py:167 idct8x8 and the butterfly pass _idct_1d at dct.py:53)
// followed by blocks_to_plane, which XLA compiles for
// JpegDecoder.decode(xp=jnp): no Pallas kernel lies behind it. Same
// arithmetic, operation by operation:
//
//   natural[j]   = fl32(c[zz(j)] * q[zz(j)])        int32 product, one rounding
//   rows         = IDCT1(each row of natural)       transpose -> 1-D pass
//   cols         = IDCT1(each column of rows)       transpose -> 1-D pass
//   sample[m][k] = rint(cols[m][k] * 0.125) + level_shift
//
// written to out[(by * 8 + m) * (width_blocks * 8) + bx * 8 + k].
//
// Bit-exactness is the contract: the results equal numpy's and XLA's, which
// equal the reference's golden fixtures. The library is compiled with -O3
// and nvcc contracts a * b + c into one FMA (one rounding instead of two),
// so every product, sum and difference of the butterfly is written as an
// explicit __fmul_rn / __fadd_rn / __fsub_rn, which nvcc neither contracts
// nor reorders, in the left-to-right order of dct.py: (my7 * c + mz0) + mz2
// is two ordered adds. __int2float_rn converts the product as numpy's
// astype(float32) does (to nearest, also above 2^24), and __float2int_rn
// rounds half to even, as rint does.
//
// What bounds it on Hopper: bytes. A block reads 128 B of int16
// coefficients (256 B as int32) and writes 256 B of int32 samples for about
// 770 float operations (16 one-dimensional passes of 44, the scale and the
// rounding): 65,536 blocks move 25.2 MB, 7.5 us at 3.35 TB/s, against
// 50 M operations, 0.8 us at 67 TFLOP/s.
//
// First design, simple and right: a CTA of 256 threads takes 32 consecutive
// blocks. Thread t loads the 8 zig-zag coefficients [8 (t % 8), +8) of block
// t / 8 with one 16-byte load (two for int32), so a warp reads 512
// contiguous bytes; it dequantizes and converts them and stores each into
// its natural position of the block's float tile in shared memory. Then
// thread (block, r) runs the first 1-D pass on row r of its block in place,
// and after a barrier thread (block, k) the second on column k, rounds, adds
// the level shift and stores the 8 samples of column k straight into plane
// order: for each output row the 32 lanes of a warp (4 blocks x 8 columns
// of one block row) write 128 contiguous bytes. Rows of the float tile are
// padded to 9 floats, so both the row and the column reads of a warp hit 32
// distinct banks. The last CTA masks the blocks past the end.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlocksPerCta = 32;
constexpr int kThreads = kBlocksPerCta * 8;  // a thread per block row, then per column
constexpr int kRowPitch = 9;                 // floats per staged row: 8 and a pad
constexpr int kBlockPitch = 8 * kRowPitch;

// The natural (row-major) position of each zig-zag index (T.81 Figure A.6).
__device__ const int kZigzagToNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// FastFloatingPointDCT.cs's float32 constants, bit for bit the host copy's
// (jpeglibrary_tpu_torch/host/ops/dct.py), as hexadecimal literals so that
// no decimal rounding intervenes.
constexpr float kC1_175876 = 0x1.2d062ep+0f;
constexpr float kC1_961571 = -0x1.f6297cp+0f;
constexpr float kC0_390181 = -0x1.8f8b84p-2f;
constexpr float kC0_899976 = -0x1.ccc9aep-1f;
constexpr float kC2_562915 = -0x1.480d9ep+1f;
constexpr float kC0_298631 = 0x1.31cc6ap-2f;
constexpr float kC2_053120 = 0x1.06cca2p+1f;
constexpr float kC3_072711 = 0x1.894e98p+1f;
constexpr float kC1_501321 = 0x1.805694p+0f;
constexpr float kC0_541196 = 0x1.1517a8p-1f;
constexpr float kC1_847759 = -0x1.d906bcp+0f;
constexpr float kC0_765367 = 0x1.87de2ap-1f;
constexpr float kC0_125 = 0.125f;

// One 1-D IDCT of x[0..7] into y[0..7]: dct.py's _idct_1d, operation by
// operation (IDCT8x4_LeftPart/RightPart of the reference).
__device__ __forceinline__ void idct_1d(const float x[8], float y[8]) {
  const float my1 = x[1];
  const float my7 = x[7];
  float mz0 = __fadd_rn(my1, my7);

  const float my3 = x[3];
  float mz2 = __fadd_rn(my3, my7);
  const float my5 = x[5];
  float mz1 = __fadd_rn(my3, my5);
  float mz3 = __fadd_rn(my1, my5);

  float mz4 = __fmul_rn(__fadd_rn(mz0, mz1), kC1_175876);

  mz2 = __fadd_rn(__fmul_rn(mz2, kC1_961571), mz4);
  mz3 = __fadd_rn(__fmul_rn(mz3, kC0_390181), mz4);
  mz0 = __fmul_rn(mz0, kC0_899976);
  mz1 = __fmul_rn(mz1, kC2_562915);

  const float mb3 = __fadd_rn(__fadd_rn(__fmul_rn(my7, kC0_298631), mz0), mz2);
  const float mb2 = __fadd_rn(__fadd_rn(__fmul_rn(my5, kC2_053120), mz1), mz3);
  const float mb1 = __fadd_rn(__fadd_rn(__fmul_rn(my3, kC3_072711), mz1), mz2);
  const float mb0 = __fadd_rn(__fadd_rn(__fmul_rn(my1, kC1_501321), mz0), mz3);

  const float my2 = x[2];
  const float my6 = x[6];
  mz4 = __fmul_rn(__fadd_rn(my2, my6), kC0_541196);
  const float my0 = x[0];
  const float my4 = x[4];
  mz0 = __fadd_rn(my0, my4);
  mz1 = __fsub_rn(my0, my4);

  mz2 = __fadd_rn(mz4, __fmul_rn(my6, kC1_847759));
  mz3 = __fadd_rn(mz4, __fmul_rn(my2, kC0_765367));

  const float a0 = __fadd_rn(mz0, mz3);
  const float a3 = __fsub_rn(mz0, mz3);
  const float a1 = __fadd_rn(mz1, mz2);
  const float a2 = __fsub_rn(mz1, mz2);

  y[0] = __fadd_rn(a0, mb0);
  y[1] = __fadd_rn(a1, mb1);
  y[2] = __fadd_rn(a2, mb2);
  y[3] = __fadd_rn(a3, mb3);
  y[4] = __fsub_rn(a3, mb3);
  y[5] = __fsub_rn(a2, mb2);
  y[6] = __fsub_rn(a1, mb1);
  y[7] = __fsub_rn(a0, mb0);
}

// Eight consecutive coefficients from 16-byte aligned memory, as int.
__device__ __forceinline__ void load8(const int16_t* src, int v[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = static_cast<int16_t>(w[i] & 0xFFFFu);
    v[2 * i + 1] = static_cast<int16_t>(w[i] >> 16);
  }
}

__device__ __forceinline__ void load8(const int32_t* src, int v[8]) {
  const int4 lo = __ldg(reinterpret_cast<const int4*>(src));
  const int4 hi = __ldg(reinterpret_cast<const int4*>(src) + 1);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
butterfly_idct_kernel(const T* __restrict__ coeffs, const int* __restrict__ quant,
                      int* __restrict__ out, int64_t n_blocks, int64_t width_blocks,
                      int level_shift) {
  __shared__ float s_tile[kBlocksPerCta * kBlockPitch];
  __shared__ int s_quant[64];
  __shared__ int s_natural[64];
  const int tid = threadIdx.x;
  if (tid < 64) {
    s_quant[tid] = quant[tid];
    s_natural[tid] = kZigzagToNatural[tid];
  }
  __syncthreads();

  const int64_t first = static_cast<int64_t>(blockIdx.x) * kBlocksPerCta;
  const int64_t left = n_blocks - first;
  const int n_here = left < kBlocksPerCta ? static_cast<int>(left) : kBlocksPerCta;
  const int b = tid >> 3;     // the CTA's block
  const int part = tid & 7;   // eighth of the coefficients; then row; then column
  const bool live = b < n_here;
  float* tile = s_tile + b * kBlockPitch;

  // Dequantize (the exact int32 product, then one rounding to float32) and
  // un-zigzag into the block's float tile.
  if (live) {
    int v[8];
    load8(coeffs + (first + b) * 64 + part * 8, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int zz = part * 8 + j;
      const int nat = s_natural[zz];
      tile[(nat >> 3) * kRowPitch + (nat & 7)] = __int2float_rn(v[j] * s_quant[zz]);
    }
  }
  __syncthreads();

  // First pass: row `part` of the block, in place (each thread owns its row).
  if (live) {
    float* row = tile + part * kRowPitch;
    float x[8], y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = row[j];
    idct_1d(x, y);
#pragma unroll
    for (int j = 0; j < 8; ++j) row[j] = y[j];
  }
  __syncthreads();

  // Second pass: column `part`, then the scale, rint and level shift,
  // stored into plane order.
  if (live) {
    const float* col = tile + part;
    float x[8], y[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) x[r] = col[r * kRowPitch];
    idct_1d(x, y);
    const int64_t block = first + b;
    const int64_t by = block / width_blocks;
    const int64_t bx = block - by * width_blocks;
    const int64_t pitch = width_blocks * 8;
    int* dst = out + by * 8 * pitch + bx * 8 + part;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      dst[m * pitch] = __float2int_rn(__fmul_rn(y[m], kC0_125)) + level_shift;
    }
  }
}

template <typename T>
int launch(const void* coeffs, const void* quant, void* out, int64_t n_blocks,
           int64_t width_blocks, int level_shift, void* stream) {
  if (n_blocks <= 0) return 0;
  if (width_blocks < 1 || n_blocks % width_blocks != 0 ||
      reinterpret_cast<uintptr_t>(coeffs) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t grid = (n_blocks + kBlocksPerCta - 1) / kBlocksPerCta;
  if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  butterfly_idct_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(coeffs), static_cast<const int*>(quant), static_cast<int*>(out),
      n_blocks, width_blocks, level_shift);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coeffs [n_blocks, 64] zig-zag coefficients (int16 or int32), the blocks of
// a [n_blocks / width_blocks, width_blocks] grid in row-major order, 16-byte
// aligned; quant [64] int32 zig-zag; out the int32 plane [n_blocks /
// width_blocks * 8, width_blocks * 8]; all contiguous device memory.
// Launches on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue
// for a shape the kernel does not take).
extern "C" int jpx_butterfly_idct_i16(const void* coeffs, const void* quant, void* out,
                                      int64_t n_blocks, int64_t width_blocks, int level_shift,
                                      void* stream) {
  return launch<int16_t>(coeffs, quant, out, n_blocks, width_blocks, level_shift, stream);
}

extern "C" int jpx_butterfly_idct_i32(const void* coeffs, const void* quant, void* out,
                                      int64_t n_blocks, int64_t width_blocks, int level_shift,
                                      void* stream) {
  return launch<int32_t>(coeffs, quant, out, n_blocks, width_blocks, level_shift, stream);
}

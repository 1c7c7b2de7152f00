// K6: full_step's colour round trip. K1's int32 samples of a 4:2:0 or a
// 4:2:2 batch in, the step's RGB output and K2's three uint8 planes out, in
// one pass.
//
// It replaces no TPU kernel: the JAX package's step
// (jpeglibrary_tpu/parallel/sharding.py:70-117) leaves these ops to XLA,
// which fuses them. The port ran them as 66 plain PyTorch
// launches that each read and wrote whole int32 planes. Its plain version,
// jpeglibrary_tpu_torch/ops/color.py round_trip_plain, is that chain,
// and this kernel equals it byte for byte:
//
//   y [B, Hb, Wb, 8, 8] int32, Wb even; cb and cr [B, Hb/VS, Wb/2, 8, 8]
//   int32, with VS = 2 (4:2:0, Hb even: the chroma halved both ways) or
//   VS = 1 (4:2:2: the chroma halved across only). An MCU is 16 luma
//   columns by 8 VS luma rows: VS block rows of 2 luma blocks, and one
//   block of each chroma. Per luma pixel, with Y its sample and Cb, Cr the
//   samples of its chroma cell (2 x VS pixels: the chroma duplicated across,
//   and down at VS = 2), each clamped to [0, 255]:
//     cr_r  = (D1 Cr + (1/2 - 128 D1)) >> 16
//     cb_b  = (D3 Cb + (1/2 - 128 D3)) >> 16
//     g_off = (D4 Cb + D2 Cr + (1/2 - 128 (D4 + D2))) >> 16
//     R, G, B = clamp(Y + cr_r), clamp(Y + g_off), clamp(Y + cb_b)
//     y'  = (Y_R R + Y_G G + Y_B B + 1/2) >> 16
//     cb' = (CB_R R + CB_G G + CB_B B + 128 + 1/2 - 2^-16) >> 16
//     cr' = (CB_B R + CR_G G + CR_B B + 128 + 1/2 - 2^-16) >> 16
//   in 16-bit fixed point, int32 products and arithmetic shifts (ops/color.py
//   ycbcr_to_rgb and rgb_to_ycbcr with the -128 of each chroma sample folded
//   into the offsets, which changes no sum); y', cb', cr' are cast to uint8
//   by their low byte, as .to(torch.uint8) casts them. The wrapper hands the
//   constants over from ops/color.py (ROUND_TRIP_CONSTANTS), so they have
//   one source.
//   Out: rgb [B, H, W, 3] and the y', cb', cr' planes [B, H, W] uint8,
//   H = 8 Hb, W = 8 Wb.
//
// What bounds it on Hopper: bytes. At 4:2:0 a luma pixel reads 4 B of luma
// and 2 B of chroma (a quarter of a pixel's two samples) and writes 3 B of
// RGB and 3 B of planes: 12 B, against some 20 integer operations (the
// chroma terms once per chroma sample; per pixel a clamp, three
// add-and-clamps, nine multiply-adds, and byte permutes to pack). At
// full_step's 67.1 MP that is 0.24 ms at 3.35 TB/s, the operations a fifth
// of that at the SMs' integer rate. At 4:2:2 a luma pixel reads 4 B of
// chroma (half of its two samples), 8 B in all, and writes the same 6 B:
// 14 B, 0.40 ms for a step of 4 x 6000 x 4000. The chain of plain ops it
// replaces moved some 490 B a pixel.
//
// Design: a CTA takes a strip of kMcus = 16 / VS whole MCUs of one MCU row:
// 2,048 luma pixels, 8 VS luma rows by 16 kMcus columns, at either height.
// In K1's layout that is VS + 2 contiguous runs: 2 kMcus luma blocks of each
// of the VS block rows and kMcus blocks of each chroma. The batch's planes
// are one [B H, W] plane whose MCU rows never cross images (Hb is a
// multiple of VS), so one launch covers the batch, a CTA a strip, the last
// strip of a row masked when Wb / 2 is not a multiple of kMcus. Every load
// is a 16-byte streaming load, neighbouring threads on neighbouring chunks.
// Thread t of the 32 kMcus keeps luma chunk t of each block row in
// registers (4 pixels of one row) and stages one chroma chunk in shared
// memory; after a barrier it reads the two chroma samples of its pixels in
// each row, computes their three terms, and converts its 4 VS pixels. Its
// bytes go to shared memory in the output's row-major order: RGB rows of
// 48 kMcus bytes and plane rows of 16 kMcus bytes, each row padded so that
// the warp's 32 stores meet 32 different banks (a row pitch of 12 and of 4
// words, mod 32). After a second barrier the CTA writes whole rows with
// 16-byte stores. y', cb', cr' are bits 16..23 of their sums, picked by a
// byte permute without a shift; the clamps are Hopper's DPX min/max with
// relu. The MCU's height VS is a template parameter, one instantiation
// each: color_round_trip_kernel<2> (256 threads, 32 registers, 17.5 KB of
// shared memory, 8 CTAs resident on an SM) and <1> (512 threads, 30
// registers, 20.75 KB, 4 resident; a strip of 8 MCUs instead moved its
// bytes 6% slower at the 24 MP cell's batch). Many CTAs (24,576 and 32,768
// at the 4:2:0 cells' batches, 48,000 at the 4:2:2 cell's) keep the loads of
// some in flight while others convert and store. On an H100 SXM at 700 W
// the 4:2:0 kernel takes 0.287 ms for 4 x 4096^2 pixels with the L2
// flushed, 84% of the bytes bound, and the 4:2:2 kernel 0.484 ms for 4 x
// 6000 x 4000, 83%.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunks = 16;               // 16-byte chunks of an int32 block
constexpr int kConstants = 17;

constexpr int pad_to(int words, int mod32) { return words + ((mod32 - words % 32) + 32) % 32; }

// A CTA's strip at an MCU height of VS blocks: 2,048 luma pixels at either
// height.
template <int VS>
struct Strip {
  static constexpr int kMcus = 16 / VS;            // MCUs of a strip
  static constexpr int kThreads = 32 * kMcus;      // one a luma chunk of a block row
  static constexpr int kRows = 8 * VS;             // luma rows of an MCU
  // Row pitches of the staged output in 32-bit words, padded to 12 (RGB)
  // and 4 (planes) mod 32: the 32 stores of a warp (8 rows of 4 chunks)
  // then fall in 32 different banks. Both keep rows 16-byte aligned.
  static constexpr int kRgbWords = pad_to(12 * kMcus, 12);
  static constexpr int kPlaneWords = pad_to(4 * kMcus, 4);
};

struct RoundTripConstants {
  int32_t c[kConstants];  // ops/color.py ROUND_TRIP_CONSTANTS, in its order
};

__device__ __forceinline__ int32_t clamp255(int32_t v) {
  return __vimin_s32_relu(v, 255);  // max(min(v, 255), 0)
}

// Bytes 2 of a and b, then of c and d: (x >> 16) cast to uint8 of four sums.
__device__ __forceinline__ uint32_t pack_byte2(int32_t a, int32_t b, int32_t c, int32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0062), __byte_perm(c, d, 0x0062), 0x5410);
}

// Bytes 0 of four values in [0, 255].
__device__ __forceinline__ uint32_t pack_byte0(int32_t a, int32_t b, int32_t c, int32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// The staged strip of n MCUs to the outputs: its kRows rows of RGB (3 n
// chunks each), then of each plane (n chunks each), in whole 16-byte
// chunks, consecutive threads on consecutive chunks of a row.
template <int VS, typename S = Strip<VS>>
__device__ __forceinline__ void store_strip(int n, const uint32_t (*s_rgb)[S::kRgbWords],
                                            const uint32_t (*s_plane)[S::kRows][S::kPlaneWords],
                                            uint8_t* rgb, uint8_t* out_y, uint8_t* out_cb,
                                            uint8_t* out_cr, int64_t row0, int64_t width,
                                            int64_t col0) {
  constexpr int kRows = S::kRows;
  const int rgb_chunks = 3 * n;
  for (int i = threadIdx.x; i < kRows * rgb_chunks + 3 * kRows * n; i += S::kThreads) {
    if (i < kRows * rgb_chunks) {
      const int row = i / rgb_chunks;
      const int c = i - row * rgb_chunks;
      const int4 v = reinterpret_cast<const int4*>(s_rgb[row])[c];
      *reinterpret_cast<int4*>(rgb + ((row0 + row) * width + col0) * 3 + 16 * c) = v;
    } else {
      const int j = i - kRows * rgb_chunks;
      const int plane = j / (kRows * n);
      const int row = (j - plane * kRows * n) / n;
      const int c = j - (plane * kRows + row) * n;
      const int4 v = reinterpret_cast<const int4*>(s_plane[plane][row])[c];
      uint8_t* out = plane == 0 ? out_y : (plane == 1 ? out_cb : out_cr);
      *reinterpret_cast<int4*>(out + (row0 + row) * width + col0 + 16 * c) = v;
    }
  }
}

// VS: the MCU's height in luma blocks, 2 at 4:2:0 and 1 at 4:2:2.
template <int VS>
__global__ void __launch_bounds__(Strip<VS>::kThreads) color_round_trip_kernel(
    const int4* __restrict__ y, const int4* __restrict__ cb, const int4* __restrict__ cr,
    uint8_t* __restrict__ rgb, uint8_t* __restrict__ out_y, uint8_t* __restrict__ out_cb,
    uint8_t* __restrict__ out_cr, int64_t mcus_per_row, int64_t strips_per_row,
    RoundTripConstants k) {
  using S = Strip<VS>;
  constexpr int kMcus = S::kMcus;
  constexpr int kRows = S::kRows;
  __shared__ __align__(16) int32_t s_chroma[2][kMcus * 64];
  __shared__ __align__(16) uint32_t s_rgb[kRows][S::kRgbWords];
  __shared__ __align__(16) uint32_t s_plane[3][kRows][S::kPlaneWords];

  const int t = threadIdx.x;
  const int64_t m = blockIdx.x / strips_per_row;  // MCU row of the batch
  const int64_t mcu0 = (blockIdx.x - m * strips_per_row) * kMcus;
  const int64_t left = mcus_per_row - mcu0;
  const int n = left < kMcus ? static_cast<int>(left) : kMcus;  // MCUs of this strip
  const int64_t blocks_per_row = 2 * mcus_per_row;

  // Loads: luma chunk t of each of the VS block rows into registers, one
  // chroma chunk (Cb for the first half of the threads, Cr for the second)
  // into shared memory.
  const bool has_luma = t < 32 * n;
  int4 luma[VS];
  if (has_luma) {
#pragma unroll
    for (int r = 0; r < VS; ++r) {
      luma[r] = __ldcs(y + ((VS * m + r) * blocks_per_row + 2 * mcu0) * kChunks + t);
    }
  }
  {
    const int comp = t / (kChunks * kMcus);
    const int i = t - comp * kChunks * kMcus;
    if (i < kChunks * n) {
      const int4* src = comp ? cr : cb;
      reinterpret_cast<int4*>(s_chroma[comp])[i] =
          __ldcs(src + (m * mcus_per_row + mcu0) * kChunks + i);
    }
  }
  __syncthreads();

  if (has_luma) {
    // Luma block b of the strip's block row (two a MCU), chunk q: pixel row
    // q / 2 of the block, columns col .. col + 3 of the strip.
    const int b = t / kChunks;
    const int q = t % kChunks;
    const int col = b * 8 + (q % 2) * 4;
    // The chroma samples of those columns: block b / 2, columns
    // (b % 2) * 4 + (q % 2) * 2 and the next, of chroma row row / VS.
    const int chroma_col = (b / 2) * 64 + (b % 2) * 4 + (q % 2) * 2;
#pragma unroll
    for (int r = 0; r < VS; ++r) {
      const int row = r * 8 + q / 2;  // of the strip's kRows
      const int at = chroma_col + (row / VS) * 8;
      const int2 vcb = *reinterpret_cast<const int2*>(&s_chroma[0][at]);
      const int2 vcr = *reinterpret_cast<const int2*>(&s_chroma[1][at]);
      int32_t cr_r[2], cb_b[2], g_off[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int32_t c_b = clamp255(s ? vcb.y : vcb.x);
        const int32_t c_r = clamp255(s ? vcr.y : vcr.x);
        cr_r[s] = (k.c[0] * c_r + k.c[1]) >> 16;
        cb_b[s] = (k.c[2] * c_b + k.c[3]) >> 16;
        g_off[s] = (k.c[4] * c_b + k.c[5] * c_r + k.c[6]) >> 16;
      }
      const int32_t ys[4] = {luma[r].x, luma[r].y, luma[r].z, luma[r].w};
      int32_t R[4], G[4], B[4], Y[4], CB[4], CR[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int32_t yy = clamp255(ys[p]);
        R[p] = __viaddmin_s32_relu(yy, cr_r[p / 2], 255);  // max(min(yy + cr_r, 255), 0)
        G[p] = __viaddmin_s32_relu(yy, g_off[p / 2], 255);
        B[p] = __viaddmin_s32_relu(yy, cb_b[p / 2], 255);
        Y[p] = k.c[7] * R[p] + k.c[8] * G[p] + k.c[9] * B[p] + k.c[10];
        CB[p] = k.c[11] * R[p] + k.c[12] * G[p] + k.c[13] * B[p] + k.c[14];
        CR[p] = k.c[13] * R[p] + k.c[15] * G[p] + k.c[16] * B[p] + k.c[14];
      }
      uint32_t* rgb_row = &s_rgb[row][3 * (col / 4)];
      rgb_row[0] = pack_byte0(R[0], G[0], B[0], R[1]);
      rgb_row[1] = pack_byte0(G[1], B[1], R[2], G[2]);
      rgb_row[2] = pack_byte0(B[2], R[3], G[3], B[3]);
      s_plane[0][row][col / 4] = pack_byte2(Y[0], Y[1], Y[2], Y[3]);
      s_plane[1][row][col / 4] = pack_byte2(CB[0], CB[1], CB[2], CB[3]);
      s_plane[2][row][col / 4] = pack_byte2(CR[0], CR[1], CR[2], CR[3]);
    }
  }
  __syncthreads();

  // Stores; with n a constant for whole strips, so that the chunks' rows and
  // columns come from divisions by constants.
  const int64_t row0 = kRows * m;           // of the batch's [B H, W] planes
  const int64_t width = 16 * mcus_per_row;  // W
  const int64_t col0 = 16 * mcu0;
  if (n == kMcus) {
    store_strip<VS>(kMcus, s_rgb, s_plane, rgb, out_y, out_cb, out_cr, row0, width, col0);
  } else {
    store_strip<VS>(n, s_rgb, s_plane, rgb, out_y, out_cb, out_cr, row0, width, col0);
  }
}

// One launch of the VS instantiation, a CTA a strip.
template <int VS>
int launch(const void* y, const void* cb, const void* cr, void* rgb, void* out_y, void* out_cb,
           void* out_cr, int64_t mcu_rows, int64_t mcus_per_row, const RoundTripConstants& k,
           void* stream) {
  using S = Strip<VS>;
  const int64_t strips_per_row = (mcus_per_row + S::kMcus - 1) / S::kMcus;
  const int64_t grid = mcu_rows * strips_per_row;
  if (grid > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  color_round_trip_kernel<VS><<<static_cast<unsigned>(grid), S::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(y), static_cast<const int4*>(cb), static_cast<const int4*>(cr),
      static_cast<uint8_t*>(rgb), static_cast<uint8_t*>(out_y), static_cast<uint8_t*>(out_cb),
      static_cast<uint8_t*>(out_cr), mcus_per_row, strips_per_row, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y [mcu_rows * vs, 2 mcus_per_row, 8, 8], cb and cr [mcu_rows,
// mcus_per_row, 8, 8] int32 (K1's samples of a batch of 4:2:0 planes at
// vs = 2 or 4:2:2 planes at vs = 1, its images' block rows one after
// another); rgb [mcu_rows * 8 vs, 16 mcus_per_row, 3] and out_y, out_cb,
// out_cr [mcu_rows * 8 vs, 16 mcus_per_row] uint8. All device memory,
// contiguous and 16-byte aligned. constants: host memory, ops/color.py
// ROUND_TRIP_CONSTANTS (17 int32). Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for shapes or a vs the kernel
// does not take).
extern "C" int jpx_color_round_trip(const void* y, const void* cb, const void* cr, void* rgb,
                                    void* out_y, void* out_cb, void* out_cr, int64_t mcu_rows,
                                    int64_t mcus_per_row, int vs, const int32_t* constants,
                                    void* stream) {
  if (mcu_rows < 0 || mcus_per_row < 0 || (vs != 1 && vs != 2) || constants == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mcu_rows == 0 || mcus_per_row == 0) return static_cast<int>(cudaSuccess);
  RoundTripConstants k;
  for (int i = 0; i < kConstants; ++i) k.c[i] = constants[i];
  return vs == 2 ? launch<2>(y, cb, cr, rgb, out_y, out_cb, out_cr, mcu_rows, mcus_per_row, k,
                             stream)
                 : launch<1>(y, cb, cr, rgb, out_y, out_cb, out_cr, mcu_rows, mcus_per_row, k,
                             stream);
}

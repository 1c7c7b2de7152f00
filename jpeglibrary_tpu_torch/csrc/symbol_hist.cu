// K5: the DC and AC Huffman symbol histograms of zig-zag blocks, walked in
// the interleaved MCU order of their component planes, summed over a batch
// of DC predictor chains.
//
// Counterpart of the JAX package's device symbol statistics,
// jpeglibrary_tpu/parallel/sharding.py:60 _mcu_order_batch followed by
// jpeglibrary_tpu/ops/encode_stage.py:330 symbol_histograms_device, an XLA
// program (a permute copy into MCU order, 16-compare bit counts, a cummax
// over the 63 AC positions and two scatter-adds into 256 bins), not a
// Pallas kernel. Its plain PyTorch version is
// jpeglibrary_tpu_torch/ops/encode_stage.py symbol_histograms_plain (after
// that copy), and this kernel's result equals it bit for bit:
//
//   planes: 1 to 4 tensors [B, Hb, Wb, 64] int16 or int32; chain r is image
//   r % B of plane r / B (B Cb chains, then B Cr chains). Block t of a
//   chain is (mr, mc, vv, hh) of t = ((mr * Wb / h + mc) * v + vv) * h + hh,
//   read at plane[b, mr * v + vv, mc * h + hh]: the walk of an (h, v) MCU;
//   blocks at t >= n_valid[r] count nothing;
//   DC: bits(|dc[t] - dc[t - 1]|), dc[-1] = prev_dc[r] (0 without prev_dc);
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
// 8 x 65,536 luma blocks are 67.1 MB, 20.0 us at 3.35 TB/s. What holds it
// above that on dense blocks is its AC atomics, one a non-zero coefficient
// (tools/k5_probe.py takes it apart): the warp's shared-memory atomic
// increment updates one address per pass and counts the lanes that share
// it at once, so it costs what its distinct bins cost. Without them the
// CT series' planes (37 non-zero AC coefficients a block) take half the
// time. The 32-way bank conflicts of the value loads where the lanes stand
// at one position cost nothing measurable; lanes spread over the banks
// (each lane's visits rotated) stand at different positions, meet more
// distinct bins, and ran 1-4% slower. On sparse planes (the 16.8 MP cell's,
// 3-14 non-zeros a block) the loads of the stages hold it.
//
// Design: the blocks are read where they lie. A tile is a run of whole
// MCUs of one MCU row of one plane, 128 blocks: v bulk copies
// (cp.async.bulk, one per block row of the MCU row, each a contiguous run
// of whole blocks), and a 16-byte copy of the block before the tile in the
// walk, for its DC. One producer thread keeps kStages tiles in flight in a
// ring of shared-memory stages, each with a `full` mbarrier that the copies
// complete and an `empty` one that the 4 consumer warps arrive at. Thread k
// of the consumers counts block k of the walk of each tile: the walk's
// index arithmetic is one shared-memory offset a thread, fixed for the
// kernel. A thread builds its block's 64-bit non-zero mask from 16-byte
// loads (the chunks read in a rotated order, so the 8 lanes of a
// shared-memory phase meet 8 different banks; the int16 pairs tested with
// one add, and the flags gathered by a byte permute and a multiply) and
// keeps its DC from chunk 0; the DC before it in the walk is the lane
// before's (a shuffle), read from shared memory by lane 0 alone. It then
// visits the non-zero AC coefficients in ascending order: each run is the
// gap to the visit before, each value loaded a visit ahead, the visits
// unrolled by four after the remainder, so the cost follows the non-zeros
// and not the 63 positions. AC symbols go to private histograms per warp in
// shared memory with one atomic each (the lanes of one atomic on one bin
// are one update); ZRLs and EOBs are counted in registers and added once.
// At the end each CTA sums its warps' copies and adds each non-empty bin to
// the output with one global atomicAdd. The grid is at most one wave of
// resident CTAs, each taking an equal share of the tiles.

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kConsumerWarps = 4;
constexpr int kTileBlocks = 32 * kConsumerWarps;  // one block per consumer thread
constexpr int kThreads = kTileBlocks + 32;        // and one producer warp
constexpr int kStages = 3;
constexpr int kDcBins = 32;    // DC symbols are 0..16
constexpr int kHistInts = kDcBins + 256;  // a warp's DC and AC histograms
constexpr int kMaxPlanes = 4;
constexpr int kMaxMcu = 4;     // h and v
constexpr int64_t kMaxBlocks = (int64_t{1} << 31) - 1;  // walk indices are int32
constexpr int kMaxDevices = 64;

struct Planes {
  const void* p[kMaxPlanes];
};

// The walk, the same for every plane.
struct Walk {
  int64_t batch;
  int64_t hb, wb;         // blocks of a plane
  int h, v;               // the MCU's blocks across and down
  int64_t mcu_cols;       // wb / h
  int tile_mcus;          // MCUs a tile (kTileBlocks / (h v))
  int64_t tiles_per_row;  // tiles of an MCU row
  int64_t tiles_per_chain;
  int64_t n_tiles;
};

// What the producer tells the consumers of a stage's tile.
struct TileInfo {
  int32_t row;   // the chain
  int32_t t0;    // the walk index of the tile's first block
  int32_t mcus;  // MCUs in the tile (the last of an MCU row may be short)
  int32_t pad;
  alignas(16) int32_t pred[4];  // the first 16 bytes of block t0 - 1 (t0 > 0)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from device memory into shared memory, both
// 16-byte aligned, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The plain version's bit count of an int32 after its abs: 16 threshold
// compares, so 0 for 0 and for the negative |INT_MIN|, capped at 16.
__device__ __forceinline__ int bit_count(int32_t v) {
  const uint32_t u = v < 0 ? 0u - static_cast<uint32_t>(v) : static_cast<uint32_t>(v);
  if (u == 0 || u > 0x7FFFFFFFu) return 0;
  return min(32 - __clz(static_cast<int>(u)), 16);
}

// The same for a non-zero coefficient of type T: an int16's |v| is at most
// 2^15, so neither the cap nor |INT_MIN| can arise.
template <typename T>
__device__ __forceinline__ int coef_bits(int32_t v) {
  return bit_count(v);
}

template <>
__device__ __forceinline__ int coef_bits<int16_t>(int32_t v) {
  return 32 - __clz(abs(v));
}

// Bit 15 set where the low int16 of w is non-zero, bit 31 where the high
// one is (the other bits are of no use): the add carries into bit 15 (31)
// exactly when bits 0..14 (16..30) are not all zero, and cannot carry out
// of the low half.
__device__ __forceinline__ uint32_t nonzero_halves(uint32_t w) {
  return ((w & 0x7FFF7FFFu) + 0x7FFF7FFFu) | w;
}

// The top bits of x's 4 bytes as bits 0..3: the multiply by
// 1 + 2^7 + 2^14 + 2^21 moves bit 7 + 8i to bit 28 + i with no two
// partial products on one bit, so nothing carries.
__device__ __forceinline__ uint32_t byte_top_bits(uint32_t x) {
  return ((x & 0x80808080u) * 0x00204081u) >> 28;
}

// The non-zero flags of the 8 (int16) or 4 (int32) coefficients of a
// 16-byte chunk, coefficient i at bit i.
template <typename T>
__device__ __forceinline__ uint32_t chunk_mask(uint4 q);

template <>
__device__ __forceinline__ uint32_t chunk_mask<int16_t>(uint4 q) {
  const uint32_t lo = __byte_perm(nonzero_halves(q.x), nonzero_halves(q.y), 0x7531);
  const uint32_t hi = __byte_perm(nonzero_halves(q.z), nonzero_halves(q.w), 0x7531);
  return byte_top_bits(lo) | (byte_top_bits(hi) << 4);
}

template <>
__device__ __forceinline__ uint32_t chunk_mask<int32_t>(uint4 q) {
  return static_cast<uint32_t>(q.x != 0) | (static_cast<uint32_t>(q.y != 0) << 1) |
         (static_cast<uint32_t>(q.z != 0) << 2) | (static_cast<uint32_t>(q.w != 0) << 3);
}

// A block's 64-bit non-zero mask, bit p for zig-zag position p, and its DC
// coefficient. Lane l reads chunk (j + l) mod chunks in step j: a block is a
// whole number of 128-byte bank rows, so the 8 lanes of a phase of a 16-byte
// load meet 8 different banks whichever blocks they hold; the DC is taken
// from chunk 0 in registers, not read again from its bank.
template <typename T>
__device__ __forceinline__ uint64_t nonzero_mask(const T* blk, int lane, int32_t& dc) {
  constexpr int kChunks = 64 * static_cast<int>(sizeof(T)) / 16;
  constexpr int kPer = 64 / kChunks;
  uint64_t mask = 0;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = (j + lane) & (kChunks - 1);
    const uint4 q = *reinterpret_cast<const uint4*>(blk + c * kPer);
    mask |= static_cast<uint64_t>(chunk_mask<T>(q)) << (c * kPer);
    if (c == 0) dc = static_cast<T>(q.x);
  }
  return mask;
}

// One block: its DC symbol (the difference to the walk's block before it),
// its EOB and its AC symbols. The non-zero AC coefficients are visited in
// ascending zig-zag order, each one's run the gap to the visit before it
// (position 0 before the first), so a run is a subtraction and not a search
// of the mask, and each value is loaded a visit ahead, so that its load
// overlaps the atomic before it. The visits left over from whole fours come
// first and the fours after, unrolled by hand: the same visits with the
// fours first, or unrolled as nvcc chose, ran 7-24% slower on the dense
// planes (tools/k5_probe.py on the cells' planes).
template <typename T>
__device__ __forceinline__ void count_block(const T* blk, uint64_t mask, int32_t diff,
                                            int32_t* dc_hist, int32_t* ac_hist, int& zrl,
                                            int& eob) {
  atomicAdd(&dc_hist[bit_count(diff)], 1);
  eob += static_cast<int>((mask >> 63) ^ 1);
  uint64_t r = mask & ~uint64_t{1};
  int last = 0;
  int p = __ffsll(static_cast<long long>(r)) - 1;  // -1 once past the last
  int32_t v = blk[p & 63];
  const auto visit = [&]() {
    r &= r - 1;
    const int next = __ffsll(static_cast<long long>(r)) - 1;
    const int32_t v_next = blk[next & 63];
    const int run = p - last - 1;
    zrl += run >> 4;
    atomicAdd(&ac_hist[((run & 15) << 4) | coef_bits<T>(v)], 1);
    last = p;
    p = next;
    v = v_next;
  };
  const int n = __popcll(r);
#pragma unroll 1
  for (int i = n & 3; i > 0; --i) visit();
#pragma unroll 1
  for (int i = n >> 2; i > 0; --i) {
    visit();
    visit();
    visit();
    visit();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) symbol_hist_kernel(
    Planes planes, Walk g, const int32_t* __restrict__ n_valid,
    const int32_t* __restrict__ prev_dc, int32_t* __restrict__ out) {
  constexpr int kBlockElems = 64;
  constexpr int kStageElems = kTileBlocks * kBlockElems;
  extern __shared__ __align__(128) unsigned char smem[];
  T* stages = reinterpret_cast<T*>(smem);
  TileInfo* infos = reinterpret_cast<TileInfo*>(stages + kStages * kStageElems);
  uint64_t* full = reinterpret_cast<uint64_t*>(infos + kStages);
  uint64_t* empty = full + kStages;
  int32_t* hist = reinterpret_cast<int32_t*>(empty + kStages);  // [warp][kHistInts]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < kConsumerWarps * kHistInts; i += kThreads) hist[i] = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int hv = g.h * g.v;
  const int64_t row_elems = g.wb * kBlockElems;
  if (warp == kConsumerWarps) {
    // The producer: tile after tile into the ring, once its stage is free.
    if (lane == 0) {
      int i = 0;
      for (int64_t tile = blockIdx.x; tile < g.n_tiles; tile += gridDim.x, ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) + 1) & 1);
        const int64_t r = tile / g.tiles_per_chain;
        const int64_t rem = tile - r * g.tiles_per_chain;
        const int64_t mr = rem / g.tiles_per_row;
        const int64_t mc0 = (rem - mr * g.tiles_per_row) * g.tile_mcus;
        const int mcus = static_cast<int>(min(static_cast<int64_t>(g.tile_mcus), g.mcu_cols - mc0));
        const T* image = static_cast<const T*>(planes.p[r / g.batch]) +
                         (r % g.batch) * g.hb * row_elems;
        const int32_t t0 = static_cast<int32_t>((mr * g.mcu_cols + mc0) * hv);
        infos[s].row = static_cast<int32_t>(r);
        infos[s].t0 = t0;
        infos[s].mcus = mcus;
        const uint32_t bytes = static_cast<uint32_t>(mcus * g.h * kBlockElems * sizeof(T));
        mbar_arrive_expect_tx(&full[s], g.v * bytes + (t0 > 0 ? 16u : 0u));
        T* stage = stages + s * kStageElems;
        for (int vv = 0; vv < g.v; ++vv) {
          bulk_copy(stage + vv * g.tile_mcus * g.h * kBlockElems,
                    image + (mr * g.v + vv) * row_elems + mc0 * g.h * kBlockElems, bytes,
                    &full[s]);
        }
        if (t0 > 0) {  // the walk's block before the tile: the last of the MCU before
          const int64_t pr = mc0 > 0 ? mr * g.v + g.v - 1 : mr * g.v - 1;
          const int64_t pc = mc0 > 0 ? mc0 * g.h - 1 : g.wb - 1;
          bulk_copy(infos[s].pred, image + pr * row_elems + pc * kBlockElems, 16, &full[s]);
        }
      }
    }
    __syncwarp();
  } else {
    // A consumer: block k of each tile's walk, at a fixed offset in the stage.
    const int k = threadIdx.x;
    const int m = k / hv;
    const int vv = k % hv / g.h;
    const int hh = k % g.h;
    const int at = (vv * g.tile_mcus + m) * g.h + hh;
    const int before = k == 0 ? 0 : ((k - 1) % hv / g.h * g.tile_mcus + (k - 1) / hv) * g.h +
                                        (k - 1) % g.h;
    int32_t* dc_hist = hist + warp * kHistInts;
    int32_t* ac_hist = dc_hist + kDcBins;
    int zrl = 0;
    int eob = 0;
    int i = 0;
    for (int64_t tile = blockIdx.x; tile < g.n_tiles; tile += gridDim.x, ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const TileInfo& info = infos[s];
      bool valid = m < info.mcus;
      if (valid && n_valid != nullptr) valid = info.t0 + k < n_valid[info.row];
      const T* stage = stages + s * kStageElems;
      uint64_t mask = 0;
      int32_t dc = 0;
      if (valid) mask = nonzero_mask<T>(stage + at * kBlockElems, lane, dc);
      // The walk's block before thread k's is thread k - 1's, the lane
      // before (which holds a block wherever this lane does), but for lane 0.
      int32_t prev = __shfl_up_sync(0xFFFFFFFFu, dc, 1);
      if (valid) {
        if (lane == 0) {
          if (k > 0) {
            prev = stage[before * kBlockElems];
          } else if (info.t0 > 0) {
            prev = reinterpret_cast<const T*>(info.pred)[0];
          } else {
            prev = prev_dc != nullptr ? prev_dc[info.row] : 0;
          }
        }
        const int32_t diff = static_cast<int32_t>(static_cast<uint32_t>(dc) -
                                                  static_cast<uint32_t>(prev));
        count_block<T>(stage + at * kBlockElems, mask, diff, dc_hist, ac_hist, zrl, eob);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    zrl = __reduce_add_sync(0xFFFFFFFFu, zrl);
    eob = __reduce_add_sync(0xFFFFFFFFu, eob);
    if (lane == 0) {
      if (zrl != 0) atomicAdd(&ac_hist[0xF0], zrl);
      if (eob != 0) atomicAdd(&ac_hist[0], eob);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kHistInts; i += kThreads) {
    int32_t sum = 0;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w) sum += hist[w * kHistInts + i];
    if (sum != 0) atomicAdd(&out[i < kDcBins ? i : 256 + i - kDcBins], sum);
  }
}

template <typename T>
size_t smem_bytes() {
  return kStages * (kTileBlocks * 64 * sizeof(T) + sizeof(TileInfo) + 2 * sizeof(uint64_t)) +
         kConsumerWarps * kHistInts * sizeof(int32_t);
}

template <typename T>
int launch(const void* const* plane_ptrs, int n_planes, int64_t batch, int64_t hb, int64_t wb,
           int h, int v, const void* n_valid, const void* prev_dc, void* out, void* stream) {
  if (n_planes < 1 || n_planes > kMaxPlanes || batch < 0 || hb < 0 || wb < 0 || h < 1 ||
      h > kMaxMcu || v < 1 || v > kMaxMcu || hb % v != 0 || wb % h != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Planes planes{};
  for (int i = 0; i < n_planes; ++i) {
    if (plane_ptrs[i] == nullptr || reinterpret_cast<uintptr_t>(plane_ptrs[i]) % 16 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    planes.p[i] = plane_ptrs[i];
  }
  const int64_t chain = hb * wb;
  const int64_t rows = n_planes * batch;
  if (chain == 0 || rows == 0) return 0;
  if (chain > kMaxBlocks || rows > kMaxBlocks / chain) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Walk g{};
  g.batch = batch;
  g.hb = hb;
  g.wb = wb;
  g.h = h;
  g.v = v;
  g.mcu_cols = wb / h;
  g.tile_mcus = kTileBlocks / (h * v);
  g.tiles_per_row = (g.mcu_cols + g.tile_mcus - 1) / g.tile_mcus;
  g.tiles_per_chain = hb / v * g.tiles_per_row;
  g.n_tiles = rows * g.tiles_per_chain;

  // At most one wave of resident CTAs (shared memory decides it), each
  // taking the same number of tiles.
  const size_t bytes = smem_bytes<T>();
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  // The CTAs an SM holds, asked once a device (the shared-memory limit is
  // set on the function for the device current at the time).
  static int waves[kMaxDevices] = {};
  static std::mutex lock;
  int wave = 0;
  {
    std::lock_guard<std::mutex> guard(lock);
    wave = waves[device];
    if (wave == 0) {
      int sms = 0;
      int per_sm = 0;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(symbol_hist_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(bytes));
      }
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, symbol_hist_kernel<T>,
                                                            kThreads, bytes);
      }
      if (err != cudaSuccess) return static_cast<int>(err);
      if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
      wave = waves[device] = sms * per_sm;
    }
  }
  const int64_t per_cta = (g.n_tiles + wave - 1) / wave;
  const int64_t grid = (g.n_tiles + per_cta - 1) / per_cta;
  symbol_hist_kernel<T><<<static_cast<unsigned>(grid), kThreads, bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      planes, g, static_cast<const int32_t*>(n_valid), static_cast<const int32_t*>(prev_dc),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// planes: n_planes (1..4) pointers to [batch, hb, wb, 64] zig-zag
// coefficients (int16 or int32) of one shape, each contiguous and 16-byte
// aligned, walked in (h, v) MCU order (1 <= h, v <= 4, dividing wb and hb);
// chain r is image r % batch of plane r / batch. n_valid [n_planes batch]
// int32 in [0, hb wb] or null (every block counts); prev_dc [n_planes batch]
// int32 or null (every chain starts from 0); out [2, 256] int32 (DC, then
// AC), zeroed by the caller and added to. All device memory. Launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int jpx_symbol_histograms_i16(const void* plane0, const void* plane1,
                                         const void* plane2, const void* plane3, int n_planes,
                                         int64_t batch, int64_t hb, int64_t wb, int h, int v,
                                         const void* n_valid, const void* prev_dc, void* out,
                                         void* stream) {
  const void* planes[kMaxPlanes] = {plane0, plane1, plane2, plane3};
  return launch<int16_t>(planes, n_planes, batch, hb, wb, h, v, n_valid, prev_dc, out, stream);
}

extern "C" int jpx_symbol_histograms_i32(const void* plane0, const void* plane1,
                                         const void* plane2, const void* plane3, int n_planes,
                                         int64_t batch, int64_t hb, int64_t wb, int h, int v,
                                         const void* n_valid, const void* prev_dc, void* out,
                                         void* stream) {
  const void* planes[kMaxPlanes] = {plane0, plane1, plane2, plane3};
  return launch<int32_t>(planes, n_planes, batch, hb, wb, h, v, n_valid, prev_dc, out, stream);
}

// K7: the Huffman symbol histograms of a progressive scan script (T.81
// G.1.2.2 and G.1.2.3), per image, one pass over each component's blocks
// for every scan the component is in.
//
// No JAX counterpart: the JAX package counts a progressive script on the
// host only (the native emitter's count mode, jpx_encode_prog_dc /
// _ac_first / _ac_refine in host/native/scanner.cpp). The plain PyTorch
// version is jpeglibrary_tpu_torch/ops/encode_stage.py
// progressive_histograms_plain, and this kernel's result equals it, and
// the emitter's counts, bin for bin:
//
//   DC first scan at Al: along the component's interleaved (h, v) MCU chain
//     over its padded plane, the bit length of (dc >> Al) - (dc' >> Al),
//     dc' the chain's block before (0 before each image's first block).
//   AC first scan [Ss, Se] at Al: for each position whose |v| >> Al is not
//     zero, run = the positions since the last such one in the band,
//     run / 16 ZRLs (0xF0) and ((run % 16) << 4) | bits(|v| >> Al).
//   AC refinement [Ss, Se] at Al (Ah = Al + 1): t = |v| >> Al; t == 1 codes
//     run / 16 ZRLs and ((run % 16) << 4) | 1, run counting the positions
//     with t == 0 alone; t > 1 (a correction bit) codes no symbol.
//   EOB runs of an AC scan: a block whose band holds positions after its
//     last symbol joins the run; a block that codes a symbol flushes the
//     run pending before it. A run of L blocks codes L / 0x7FFF symbols
//     0xE0, then (floor(log2(L % 0x7FFF)) << 4) if L % 0x7FFF > 0. Each
//     image's run is flushed at its end. AC scans walk the component's own
//     grid, rows x cols blocks of the padded plane, in raster order.
//
// A coefficient codes at most one symbol over a successive-approximation
// script (the wrapper refuses any other), so each visit below makes at
// most one atomic.
//
// What bounds it on Hopper: bytes, one read of the int16 blocks (128 B a
// block): 0.349 ms a step of the transcode cell (9.14 M blocks). What holds
// it at about 14% of that on the cell's dense blocks (36.6 non-zero AC
// coefficients a luma block) is its visit loop: a shared-memory load, a
// select a scan and an atomic a non-zero coefficient, one chain a lane.
//
// Design: K5's pipeline. A tile is v rows (the DC walk's MCU height) of
// 128 / v blocks of one image's padded plane, v bulk copies, plus the
// first 16 bytes of the block before the tile in the DC walk. One producer
// thread keeps kStages tiles in flight; 4 consumer warps each take 32
// blocks of one row of the tile, a block a lane. A lane builds its block's
// non-zero mask and takes its DC from it, counts its DC symbol (the block
// before it in the walk is the lane before's, or read from the stage),
// then visits the non-zero AC coefficients in ascending order once, each
// value loaded a visit ahead, keeping for every AC scan of the component
// its last coded position and, for a refinement, the correction positions
// since it: the block is read once for all its scans. Symbols go to a
// histogram in shared memory that two warps share; ZRLs are summed in
// registers. The visit loop waits on its loads and atomics, so what moved
// it was warps: 2 stages and 2 histogram copies (42 KB a CTA for the luma,
// room for 5 CTAs, 20 consumer warps, an SM) took 2.405 ms a step of the
// transcode cell's planes where 3 stages and a copy a warp (69 KB, 3 CTAs)
// took 3.395; masks of |v| >> Al walked scan by scan took 5.496.
//
// The EOB runs cross blocks and thread blocks. Inside a warp's 32 blocks
// (a segment of a row) a run between two coding lanes is counted with two
// ballots. What crosses the segment's ends is left to the stitch: the
// joining blocks before its first coding lane (lead), from its last coding
// lane on (trail), and whether it codes at all, one word a segment and
// scan. The stitch (progressive_eobrun_kernel, a second launch) takes one
// chain, one image's scan, a CTA, and scans its segments in raster order
// with the composition of "reset to trail where the segment codes, else
// add lead", so that each coding segment knows the run pending before it.
//
// Each CTA takes a contiguous range of tiles and adds its histograms to
// the output of the tiles' image when the image changes and at its end.

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kConsumerWarps = 4;
constexpr int kTileBlocks = 32 * kConsumerWarps;  // one block per consumer thread
constexpr int kThreads = kTileBlocks + 32;        // and one producer warp
constexpr int kStages = 2;
constexpr int kHistCopies = 2;  // consumer warps w and w + 2 share a histogram copy
constexpr int kMaxAc = 8;            // AC scans of one component
constexpr int kMaxRows = kMaxAc + 1;  // and its DC first scan
constexpr int kSegment = 32;         // blocks of a row a warp counts
constexpr int kMaxEobRun = 0x7FFF;
constexpr int kEobBins = 16;         // EOB-run symbols r << 4, r = 0..14
constexpr int kStitchThreads = 256;
constexpr int kStitchWarps = kStitchThreads / 32;
constexpr int kMaxComps = 4;
constexpr int kMaxDevices = 64;
constexpr int64_t kMaxBlocks = (int64_t{1} << 31) - 1;

struct AcScan {
  int ss, se, refine, al;
};

struct Plan {
  const int16_t* plane;
  int64_t batch, hb, wb;    // blocks of the padded plane
  int64_t rows, cols;       // the AC scans' grid
  int h, v;                 // the DC walk's MCU
  int dc_al;                // the DC first scan's Al (with has_dc)
  int has_dc;
  int n_ac;
  AcScan ac[kMaxAc];
  int n_local;              // histogram rows of this component
  int global_row[kMaxRows];  // its row in the output: the DC first, then the AC scans
  int n_rows_out;           // R
  int tile_cols;            // kTileBlocks / v
  int64_t tiles_per_row, tiles_per_image, n_tiles;
  int64_t segs_per_row;     // ceil(wb / 32)
  uint32_t* summaries;      // [batch, n_ac, hb * segs_per_row]
};

struct TileInfo {
  int32_t image;
  int32_t row0;    // the plane row of the tile's first row
  int32_t c0;      // its first column
  int32_t ncols;   // columns in the tile (the last of a row may be short)
  int32_t has_pred;
  int32_t pad[3];
  alignas(16) int32_t pred[4];  // the first 16 bytes of the DC walk's block before the tile
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

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The 128 consumer threads alone (named barrier 1; the producer warp
// never waits on it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kTileBlocks) : "memory");
}

// Bit 15 (31) set where the low (high) int16 of w is non-zero (K5's test).
__device__ __forceinline__ uint32_t nonzero_halves(uint32_t w) {
  return ((w & 0x7FFF7FFFu) + 0x7FFF7FFFu) | w;
}

__device__ __forceinline__ uint32_t byte_top_bits(uint32_t x) {
  return ((x & 0x80808080u) * 0x00204081u) >> 28;
}

// A block's 64-bit non-zero mask, bit p for zig-zag position p, and its DC
// coefficient. Lane l reads chunk (j + l) mod 8 in step j, as K5 does: a
// block is whole 128-byte bank rows, so the 8 lanes of a phase of a
// 16-byte load meet 8 different banks.
__device__ __forceinline__ uint64_t nonzero_mask(const int16_t* blk, int lane, int32_t& dc) {
  uint64_t mask = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = (j + lane) & 7;
    const uint4 q = *reinterpret_cast<const uint4*>(blk + c * 8);
    const uint32_t lo = __byte_perm(nonzero_halves(q.x), nonzero_halves(q.y), 0x7531);
    const uint32_t hi = __byte_perm(nonzero_halves(q.z), nonzero_halves(q.w), 0x7531);
    mask |= static_cast<uint64_t>(byte_top_bits(lo) | (byte_top_bits(hi) << 4)) << (c * 8);
    if (c == 0) dc = static_cast<int16_t>(q.x);
  }
  return mask;
}

// The bit length of a non-negative int32.
__device__ __forceinline__ int bit_length(int32_t a) { return 32 - __clz(a); }

__global__ void __launch_bounds__(kThreads) progressive_hist_kernel(Plan g,
                                                                    int32_t* __restrict__ out) {
  constexpr int kStageElems = kTileBlocks * 64;
  extern __shared__ __align__(128) unsigned char smem[];
  int16_t* stages = reinterpret_cast<int16_t*>(smem);
  TileInfo* infos = reinterpret_cast<TileInfo*>(stages + kStages * kStageElems);
  uint64_t* full = reinterpret_cast<uint64_t*>(infos + kStages);
  uint64_t* empty = full + kStages;
  int32_t* hist = reinterpret_cast<int32_t*>(empty + kStages);  // [copy][n_local][256]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hist_ints = g.n_local * 256;
  for (int i = threadIdx.x; i < kHistCopies * hist_ints; i += kThreads) hist[i] = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int64_t per_cta = (g.n_tiles + gridDim.x - 1) / gridDim.x;
  const int64_t first = blockIdx.x * per_cta;
  const int64_t last = min(g.n_tiles, first + per_cta);
  const int64_t row_elems = g.wb * 64;

  if (warp == kConsumerWarps) {
    if (lane == 0) {
      int i = 0;
      for (int64_t tile = first; tile < last; ++tile, ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) + 1) & 1);
        const int64_t image = tile / g.tiles_per_image;
        const int64_t rem = tile - image * g.tiles_per_image;
        const int64_t mr = rem / g.tiles_per_row;
        const int64_t c0 = (rem - mr * g.tiles_per_row) * g.tile_cols;
        const int ncols = static_cast<int>(min(static_cast<int64_t>(g.tile_cols), g.wb - c0));
        const int16_t* base = g.plane + image * g.hb * row_elems;
        const bool pred = g.has_dc && (mr > 0 || c0 > 0);
        infos[s].image = static_cast<int32_t>(image);
        infos[s].row0 = static_cast<int32_t>(mr * g.v);
        infos[s].c0 = static_cast<int32_t>(c0);
        infos[s].ncols = ncols;
        infos[s].has_pred = pred;
        const uint32_t bytes = static_cast<uint32_t>(ncols) * 128u;
        mbar_arrive_expect_tx(&full[s], g.v * bytes + (pred ? 16u : 0u));
        int16_t* stage = stages + s * kStageElems;
        for (int vv = 0; vv < g.v; ++vv) {
          bulk_copy(stage + vv * g.tile_cols * 64, base + (mr * g.v + vv) * row_elems + c0 * 64,
                    bytes, &full[s]);
        }
        if (pred) {  // the last block of the MCU before the tile's first
          const int64_t pr = c0 > 0 ? mr * g.v + g.v - 1 : mr * g.v - 1;
          const int64_t pc = c0 > 0 ? c0 - 1 : g.wb - 1;
          bulk_copy(infos[s].pred, base + pr * row_elems + pc * 64, 16, &full[s]);
        }
      }
    }
    __syncwarp();
    return;
  }

  // A consumer: lane `lane` of segment `seg_in_row` of tile row `i`.
  const int segs_in_row = g.tile_cols / kSegment;
  const int i = warp / segs_in_row;
  const int col = (warp % segs_in_row) * kSegment + lane;
  const int jj = col % g.h;
  const int k = i * g.h + jj;  // the block's index in its MCU
  // Where the DC walk's block before it lies in the stage (-1: before the tile).
  int before = -1;
  if (k > 0) {
    before = ((k - 1) / g.h) * g.tile_cols + col - jj + (k - 1) % g.h;
  } else if (col > 0) {
    before = (g.v - 1) * g.tile_cols + col - 1;
  }
  // Whether that block is the lane before's (same row, the column before).
  const bool before_is_left = lane > 0 && (jj > 0 || (k == 0 && g.v == 1));
  const int ac0 = g.has_dc ? 1 : 0;  // the AC scans' first local row
  int32_t* my_hist = hist + warp % kHistCopies * hist_ints;
  const uint32_t below = (1u << lane) - 1u;

  int image = -1;
  int idx = 0;
  for (int64_t tile = first; tile < last; ++tile, ++idx) {
    const int s = idx % kStages;
    mbar_wait(&full[s], (idx / kStages) & 1);
    const TileInfo& info = infos[s];
    if (info.image != image) {
      if (image >= 0) {  // the image's counts so far to its rows
        consumers_sync();
        for (int b = threadIdx.x; b < hist_ints; b += kTileBlocks) {
          int32_t sum = 0;
#pragma unroll
          for (int w = 0; w < kHistCopies; ++w) {
            sum += hist[w * hist_ints + b];
            hist[w * hist_ints + b] = 0;
          }
          if (sum != 0) {
            atomicAdd(&out[(static_cast<int64_t>(image) * g.n_rows_out +
                            g.global_row[b / 256]) * 256 + b % 256], sum);
          }
        }
        consumers_sync();
      }
      image = info.image;
    }
    const int16_t* stage = stages + s * kStageElems;
    const bool in_tile = col < info.ncols;
    const int64_t r = info.row0 + i;
    const int64_t c = info.c0 + col;
    const int16_t* blk = stage + (i * g.tile_cols + col) * 64;
    int32_t dc = 0;
    const uint64_t mask = in_tile ? nonzero_mask(blk, lane, dc) : 0;
    const int32_t left = __shfl_up_sync(0xFFFFFFFFu, dc, 1);
    if (in_tile && g.has_dc) {
      int32_t prev = 0;
      if (before_is_left) {
        prev = left;
      } else if (before >= 0) {
        prev = stage[before * 64];
      } else if (info.has_pred) {
        prev = reinterpret_cast<const int16_t*>(info.pred)[0];
      }
      const int32_t diff = (dc >> g.dc_al) - (prev >> g.dc_al);
      atomicAdd(&my_hist[bit_length(abs(diff))], 1);
    }

    const bool valid = in_tile && r < g.rows && c < g.cols;
    int last_pos[kMaxAc];
    int corr[kMaxAc];
    int zrl[kMaxAc];
#pragma unroll
    for (int a = 0; a < kMaxAc; ++a) {
      last_pos[a] = g.ac[a].ss - 1;
      corr[a] = 0;
      zrl[a] = 0;
    }
    if (valid) {
      // Each value is loaded a visit ahead, so that its load overlaps the
      // visit before (-1 & 63 reads a value of no use once past the last).
      uint64_t rest = mask & ~uint64_t{1};
      int p = __ffsll(static_cast<long long>(rest)) - 1;
      int32_t value = blk[p & 63];
      while (rest != 0) {
        rest &= rest - 1;
        const int next = __ffsll(static_cast<long long>(rest)) - 1;
        const int32_t value_next = blk[next & 63];
        const int bits = bit_length(abs(value));
        int bin = -1;
#pragma unroll
        for (int a = 0; a < kMaxAc; ++a) {
          if (a >= g.n_ac) break;
          const AcScan sc = g.ac[a];
          if (p < sc.ss || p > sc.se || bits <= sc.al) continue;
          if (!sc.refine) {
            const int run = p - last_pos[a] - 1;
            zrl[a] += run >> 4;
            bin = ((ac0 + a) << 8) | ((run & 15) << 4) | (bits - sc.al);
            last_pos[a] = p;
          } else if (bits == sc.al + 1) {
            const int run = p - last_pos[a] - 1 - corr[a];
            zrl[a] += run >> 4;
            bin = ((ac0 + a) << 8) | ((run & 15) << 4) | 1;
            last_pos[a] = p;
            corr[a] = 0;
          } else {
            ++corr[a];
          }
        }
        if (bin >= 0) atomicAdd(&my_hist[bin], 1);
        p = next;
        value = value_next;
      }
    }

    // Per scan: the runs inside the segment, its ZRLs, and what it leaves
    // to the stitch.
    const int64_t seg = info.c0 / kSegment + warp % segs_in_row;
    const bool seg_exists = seg < g.segs_per_row;
#pragma unroll
    for (int a = 0; a < kMaxAc; ++a) {
      if (a >= g.n_ac) break;
      const uint32_t codes = __ballot_sync(0xFFFFFFFFu, valid && last_pos[a] >= g.ac[a].ss);
      const uint32_t joins = __ballot_sync(0xFFFFFFFFu, valid && last_pos[a] < g.ac[a].se);
      const uint32_t earlier = codes & below;
      int run = 0;
      if (((codes >> lane) & 1u) && earlier != 0) {
        const int from = 31 - __clz(earlier);
        run = __popc(joins & below & ~((1u << from) - 1u));
      }
      const int zsum = __reduce_add_sync(0xFFFFFFFFu, zrl[a]);
      int32_t* row_hist = my_hist + (ac0 + a) * 256;
#pragma unroll
      for (int e = 0; e < 6; ++e) {  // runs inside a segment are 1..31 blocks
        const int n = __popc(__ballot_sync(0xFFFFFFFFu, run > 0 && bit_length(run) - 1 == e));
        if (lane == 0 && n != 0) atomicAdd(&row_hist[e << 4], n);
      }
      if (lane == 0) {
        if (zsum != 0) atomicAdd(&row_hist[0xF0], zsum);
        if (seg_exists) {
          uint32_t word;
          if (codes != 0) {
            const int lo = __ffs(codes) - 1;
            const int hi = 31 - __clz(codes);
            const uint32_t lead = __popc(joins & ((1u << lo) - 1u));
            const uint32_t trail = __popc(joins >> hi);
            word = lead | (trail << 8) | (1u << 16);
          } else {
            word = __popc(joins);
          }
          g.summaries[((static_cast<int64_t>(info.image) * g.n_ac + a) * g.hb + r) *
                          g.segs_per_row + seg] = word;
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  consumers_sync();
  if (image >= 0) {
    for (int b = threadIdx.x; b < hist_ints; b += kTileBlocks) {
      int32_t sum = 0;
#pragma unroll
      for (int w = 0; w < kHistCopies; ++w) sum += hist[w * hist_ints + b];
      if (sum != 0) {
        atomicAdd(&out[(static_cast<int64_t>(image) * g.n_rows_out + g.global_row[b / 256]) *
                           256 + b % 256],
                  sum);
      }
    }
  }
}

// The stitch's chains: one image's AC scan of one component each.
struct Chains {
  const uint32_t* summaries[kMaxComps];
  int64_t segs[kMaxComps];               // segments of a chain
  int n_ac[kMaxComps];
  int row[kMaxComps][kMaxAc];            // each AC scan's row in the output
  int64_t first_chain[kMaxComps + 1];    // chains of the components before
  int n_comps;
  int n_rows_out;
};

// What a run of segments does to the run pending before it: reset to
// `add` (it codes; `add` is its trail), or add `add` (it codes nothing;
// `add` is its joining blocks).
struct Step {
  int reset;
  int add;
};

__device__ __forceinline__ Step then(Step a, Step b) {
  return b.reset ? b : Step{a.reset, a.add + b.add};
}

__device__ __forceinline__ int apply(Step f, int pending) {
  return f.reset ? f.add : pending + f.add;
}

__device__ __forceinline__ void count_run(int* bins, int length) {
  if (length <= 0) return;
  const int whole = length / kMaxEobRun;
  const int rest = length % kMaxEobRun;
  if (whole != 0) atomicAdd(&bins[14], whole);
  if (rest != 0) atomicAdd(&bins[bit_length(rest) - 1], 1);
}

__global__ void __launch_bounds__(kStitchThreads) progressive_eobrun_kernel(
    Chains g, int32_t* __restrict__ out) {
  __shared__ Step warp_total[kStitchWarps];
  __shared__ Step warp_before[kStitchWarps];
  __shared__ Step chunk_total;
  __shared__ int bins[kEobBins];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x < kEobBins) bins[threadIdx.x] = 0;

  int c = 0;
  while (c + 1 < g.n_comps && blockIdx.x >= g.first_chain[c + 1]) ++c;
  const int64_t chain = blockIdx.x - g.first_chain[c];
  const int64_t image = chain / g.n_ac[c];
  const int scan = static_cast<int>(chain % g.n_ac[c]);
  const int64_t n = g.segs[c];
  const uint32_t* words = g.summaries[c] + chain * n;
  int pending = 0;  // the run pending before the chunk
  __syncthreads();

  for (int64_t at = 0; at < n; at += kStitchThreads) {
    const int64_t i = at + threadIdx.x;
    const uint32_t word = i < n ? words[i] : 0u;
    const bool codes = (word >> 16) & 1u;
    const int lead = static_cast<int>(word & 0xFFu);
    const Step mine = codes ? Step{1, static_cast<int>((word >> 8) & 0xFFu)} : Step{0, lead};
    Step incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Step o{__shfl_up_sync(0xFFFFFFFFu, incl.reset, d),
                   __shfl_up_sync(0xFFFFFFFFu, incl.add, d)};
      if (lane >= d) incl = then(o, incl);
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    if (threadIdx.x == 0) {
      Step acc{0, 0};
      for (int w = 0; w < kStitchWarps; ++w) {
        warp_before[w] = acc;
        acc = then(acc, warp_total[w]);
      }
      chunk_total = acc;
    }
    __syncthreads();
    Step excl{__shfl_up_sync(0xFFFFFFFFu, incl.reset, 1),
              __shfl_up_sync(0xFFFFFFFFu, incl.add, 1)};
    if (lane == 0) excl = Step{0, 0};
    excl = then(warp_before[warp], excl);
    if (codes) count_run(bins, apply(excl, pending) + lead);
    pending = apply(chunk_total, pending);
    __syncthreads();
  }
  if (threadIdx.x == 0) count_run(bins, pending);  // flushed at the image's end
  __syncthreads();
  if (threadIdx.x < kEobBins && bins[threadIdx.x] != 0) {
    atomicAdd(&out[(image * g.n_rows_out + g.row[c][scan]) * 256 + (threadIdx.x << 4)],
              bins[threadIdx.x]);
  }
}

size_t smem_bytes(int n_local) {
  return kStages * (kTileBlocks * 64 * sizeof(int16_t) + sizeof(TileInfo) +
                    2 * sizeof(uint64_t)) +
         static_cast<size_t>(kHistCopies) * n_local * 256 * sizeof(int32_t);
}

}  // namespace

// One component's pass. plane: [batch, hb, wb, 64] int16 zig-zag, contiguous
// and 16-byte aligned, walked by the DC first scan (dc_row >= 0, at dc_al)
// in (h, v) MCU order (h, v in 1, 2, 4 dividing wb, hb) and by the n_ac
// (<= 8) AC scans over its first rows x cols blocks in raster order. ac:
// host int32 [n_ac, 5] of (ss, se, ah, al, row). out: [batch, n_rows_out,
// 256] int32, zeroed by the caller and added to. summaries: [batch, n_ac,
// hb ceil(wb / 32)] uint32 scratch for jpx_progressive_eobrun. Launches on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for
// arguments it does not take).
extern "C" int jpx_progressive_histograms(const void* plane, int64_t batch, int64_t hb,
                                          int64_t wb, int64_t rows, int64_t cols, int h, int v,
                                          int dc_al, int dc_row, int n_ac, const int32_t* ac,
                                          int n_rows_out, void* summaries, void* out,
                                          void* stream) {
  if (plane == nullptr || reinterpret_cast<uintptr_t>(plane) % 16 != 0 || batch < 0 || hb < 0 ||
      wb < 0 || rows < 0 || rows > hb || cols < 0 || cols > wb || !(h == 1 || h == 2 || h == 4) ||
      !(v == 1 || v == 2 || v == 4) || hb % v != 0 || wb % h != 0 || n_ac < 0 || n_ac > kMaxAc ||
      n_rows_out < 1 || (n_ac > 0 && (summaries == nullptr || ac == nullptr)) ||
      (dc_row >= 0 && (dc_al < 0 || dc_al > 15))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan g{};
  g.plane = static_cast<const int16_t*>(plane);
  g.batch = batch;
  g.hb = hb;
  g.wb = wb;
  g.rows = rows;
  g.cols = cols;
  g.h = h;
  g.v = v;
  g.has_dc = dc_row >= 0;
  g.dc_al = g.has_dc ? dc_al : 0;
  g.n_ac = n_ac;
  g.n_rows_out = n_rows_out;
  int n_local = 0;
  if (g.has_dc) g.global_row[n_local++] = dc_row;
  for (int a = 0; a < n_ac; ++a) {
    const int32_t* e = ac + 5 * a;
    if (e[0] < 1 || e[0] > e[1] || e[1] > 63 || e[3] < 0 || e[3] > 13 ||
        (e[2] != 0 && e[2] != e[3] + 1) || e[4] < 0 || e[4] >= n_rows_out) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    g.ac[a] = AcScan{e[0], e[1], e[2] != 0, e[3]};
    g.global_row[n_local++] = e[4];
  }
  if (n_local == 0) return 0;
  if (g.has_dc && dc_row >= n_rows_out) return static_cast<int>(cudaErrorInvalidValue);
  g.n_local = n_local;
  g.summaries = static_cast<uint32_t*>(summaries);
  g.tile_cols = kTileBlocks / v;
  g.tiles_per_row = (wb + g.tile_cols - 1) / g.tile_cols;
  g.tiles_per_image = hb / v * g.tiles_per_row;
  g.n_tiles = batch * g.tiles_per_image;
  g.segs_per_row = (wb + kSegment - 1) / kSegment;
  if (g.n_tiles == 0) return 0;
  if (hb * wb > kMaxBlocks || batch > kMaxBlocks / (hb * wb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  const size_t bytes = smem_bytes(n_local);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  // The CTAs an SM holds at each histogram size, asked once a device.
  static int waves[kMaxDevices][kMaxRows + 1] = {};
  static std::mutex lock;
  int wave = 0;
  {
    std::lock_guard<std::mutex> guard(lock);
    wave = waves[device][n_local];
    if (wave == 0) {
      int sms = 0;
      int per_sm = 0;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(progressive_hist_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem_bytes(kMaxRows)));
      }
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, progressive_hist_kernel,
                                                            kThreads, bytes);
      }
      if (err != cudaSuccess) return static_cast<int>(err);
      if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
      wave = waves[device][n_local] = sms * per_sm;
    }
  }
  const int64_t per_cta = (g.n_tiles + wave - 1) / wave;
  const int64_t grid = (g.n_tiles + per_cta - 1) / per_cta;
  progressive_hist_kernel<<<static_cast<unsigned>(grid), kThreads, bytes,
                            static_cast<cudaStream_t>(stream)>>>(g, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The stitch of the EOB runs that cross segments, for n_comps (<= 4)
// components of one batch: summaries[c] the scratch of component c's
// jpx_progressive_histograms (hb[c] rows of segs_per_row[c] segments),
// n_ac[c] its AC scans, rows[c * 8 + a] the output row of its scan a (all
// host arrays). Adds to out [batch, n_rows_out, 256] int32.
extern "C" int jpx_progressive_eobrun(int n_comps, const void* const* summaries,
                                      const int64_t* segs, const int32_t* n_ac,
                                      const int32_t* rows, int64_t batch, int n_rows_out,
                                      void* out, void* stream) {
  if (n_comps < 1 || n_comps > kMaxComps || batch < 0 || n_rows_out < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Chains g{};
  g.n_comps = n_comps;
  g.n_rows_out = n_rows_out;
  g.first_chain[0] = 0;
  for (int c = 0; c < n_comps; ++c) {
    if (n_ac[c] < 0 || n_ac[c] > kMaxAc || segs[c] < 0 || segs[c] > kMaxBlocks ||
        (n_ac[c] > 0 && summaries[c] == nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    g.summaries[c] = static_cast<const uint32_t*>(summaries[c]);
    g.segs[c] = segs[c];
    g.n_ac[c] = n_ac[c];
    for (int a = 0; a < n_ac[c]; ++a) {
      if (rows[c * kMaxAc + a] < 0 || rows[c * kMaxAc + a] >= n_rows_out) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      g.row[c][a] = rows[c * kMaxAc + a];
    }
    g.first_chain[c + 1] = g.first_chain[c] + (segs[c] > 0 ? batch * n_ac[c] : 0);
  }
  const int64_t chains = g.first_chain[n_comps];
  if (chains == 0) return 0;
  if (chains > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  progressive_eobrun_kernel<<<static_cast<unsigned>(chains), kStitchThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

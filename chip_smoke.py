"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                       # every phase
    python3 chip_smoke.py --phase device_scan   # the device scan (K3) alone
    python3 chip_smoke.py --phase full_step     # the full step (K5's times and parts) alone
    python3 chip_smoke.py --phase color_round_trip  # K6 alone
    python3 chip_smoke.py --phase gray_step     # the 12-bit one-component step alone
    python3 chip_smoke.py --phase progressive_step  # K7, the transcode's count pass, alone

Drives the port's main paths on the card at the size users run: the
serving decode, a stream of 8 distinct 2048x2048 q75 4:2:0 baseline
JPEGs through ``decode_stream_rgb(..., device="cuda")``, image by image
and in groups; the batch decode ``decode_batch_rgb``; the v1 wires; the
thumbnail decode at 1/2, 1/4 and 1/8; the device encode, the same 8
images through ``encode_rgb(..., device="cuda")``; the device entropy
decode ``decode_baseline_device``; the batch step ``full_step``; the
bit-exact decode ``jtt.decode(data, xp=device).planes``; and the mesh
layer in spawned ranks. In order:

1. environment: the card, its power limit, torch, CUDA, nvcc, triton;
2. build: the CUDA kernels (nvcc, sm_90a) and the native scanner (g++);
3. kernels, each against its plain PyTorch version at the main paths'
   shapes (65,536 and 16,384 blocks: the Y plane and each chroma plane of
   a 2048x2048 4:2:0 image), at level shifts 128 and 2048, max |diff|
   <= 1 on <= 1e-3 of the values:
   K1 (dequantize + IDCT) from int32 and int16 coefficients, and its
   variants: 8 quant tables over 8 x 65,536 blocks (a group of 8 Y
   planes) and over 8 x 65,500 (tiles that straddle two tables), and the
   reduced outputs n = 4, 2, 1 of the thumbnail decode (at n = 2 the
   folded sums sit near .5 ties on about one sample in eight, so there
   every differing sample must be such a near tie);
   K2 (pad + box subsample + FDCT + quantize, the product on the tensor
   cores) on the unpadded planes of K2_SHAPES: the Y and a chroma plane
   of a 2048x2048 image at 1x1 and 2x2, a ragged 2047x1999 plane at 2x2
   and 2x1, 12-bit int32 planes at level shift 2048; plus exact .5 ties
   (blocks constant after the box, q = 16) that must round half to even.
   Each shape is timed against its plain version and against one
   ``torch.matmul`` of the same product (the library yardstick, never
   called by the port): with CUDA events around each call (launch gaps
   included) and as kernel time from ``torch.profiler``, warm and with
   the L2 flushed by a 256 MB write before each call; each against its
   bound (the larger of the bytes over 3.35 TB/s and the product over
   989 TFLOP/s bf16 plus the per-element operations over 67 TFLOP/s);
4. decode slice: the images are synthesised (a numpy gradient plus noise
   per seed) and encoded by the benchmark's numpy baseline encoder
   (``jpegbench/generators/jpeg420.py``); the stream
   decode is held against the port's CPU path (<= 2 RGB levels on <= 1e-4
   of the values; the CPU tests hold that path to the JAX package) and
   against the source image (PSNR), with K1 launched exactly 3 times per
   image; then MP/s end to end (the median of warm runs, each
   bit-identical to the first), and the host-clock times of the
   transform alone and of the host scan alone;
5. batch: ``decode_batch_rgb`` and ``decode_stream_rgb(group=8)`` over
   the same images, K1 launched 3 times per group, each image within the
   contract of the CPU path and equal to the card's single-image output;
   batch MP/s, stream MP/s at group 1, 2, 4 and 8, and the transform's
   host time per image in a group of 8;
5b. overlap: the stream's device workers, each on its own CUDA stream
   with a pinned staging buffer: the 8 images at ``device_workers`` 1 and
   2, at group 1 and 8, every output equal to the card's single-image
   output, K1 launched 3 times per group; MP/s of each setting (the two
   worker counts in turns); then, under ``torch.profiler``, a stream built
   to overlap (8 scan threads, group 1, 2 workers): every HtoD copy of the
   path Pinned -> Device, the path's kernels and copies on at least two
   streams and none on the caller's, and in at least one of
   OVERLAP_TRACES runs a copy of one worker under a kernel of the other;
   with the wire bytes per image and per group of 8, the copies' time and
   the part of it that overlapped;
6. wires: 4 of the images encoded on the card with arithmetic coding,
   which the fused scan declines, through the v1 plane-order wire; and
   the 8 under ``JPX_WIRE=1`` through the v1 MCU wire, grouped; each
   within the contract of the CPU path, with MP/s;
7. thumbnails: ``decode_stream_rgb(scale=1/8)``, ``decode_stream_rgb(
   scale=1/4, group=8)`` and ``decode_batch_rgb(scale=1/2)``, each of
   shape ceil(H*n/8) within the scaled contract (<= 2 levels on < 5%)
   of the CPU path, with source MP/s;
8. encode slice: the same images through ``encode_rgb`` at q75 4:2:0,
   and one more with ``optimize_coding=True``, with K2 launched exactly 3
   times per image; the card's coefficient planes within 1 of the port's
   CPU path on <= 1e-3 of the values, and the bytes equal to the CPU
   path's wherever the planes are; the same bytes on a second run; the
   JPEGs decoded on the card by ``decode_stream_rgb`` at PSNR >= 22 dB
   against the source; the device stage is 3 K2 kernels and nothing else
   (``torch.profiler``); then where an image's encode time goes (host
   colour conversion, upload, device stage, download, host emission) and
   the median per image end to end;
9. K2 at the boxes of T.81's rarer sampling factors (K2_BOXES: a
   component 3 or 4 times finer than another), uint8 and 12-bit int32, on
   a 2048x2048 plane and a ragged 2047x1999 one (int32 samples below zero
   at 3x3 too, where the box division floors), against the plain version
   and timed as in 3; then the path: ``jtt.encode`` of a 2-component
   encoder whose second component takes each box, 8- and 12-bit, one K2
   launch per box, the planes within 1 of the CPU path's;
10. CMYK: ``encode_cmyk`` of a 2048x2048 ink image, plain CMYK and YCCK
   4:2:0, 4 K2 launches each, against the CPU path as in 8;
11. fancy: ``to_rgb8_device(upsample="fancy")`` of the 8 images, 3 K1
   launches each, against the CPU path (<= 2 levels on <= 1e-4);
12. u16: ``transform_mcu2(output="u16")`` of the 8 images, 3 K1 launches
   each, against the CPU path compared as samples (``>> 8`` within 1 on
   <= 1e-4);
13. stripes: ``decode_rgb_stripes`` of one image at 16 MCU rows, 8
   stripes of 3 K1 launches each, bit-equal when concatenated to the
   card's ``to_rgb8_device``; the peak device memory of the stripe walk
   beside the full decode's (``torch.cuda.max_memory_allocated``);
14. device scan (K3, the subsequence decoder): the 8 sources encoded on
   the card at restart intervals of 128, 16 and 4 MCUs (128, 1,024 and
   4,096 segments), and one of the slice's streams without restart
   markers (one segment), through ``decode_baseline_device``, one K3 call
   per image, with its sync rounds and subsequence length logged: every
   image's segments equal to the host scan's coefficients, and through the
   dense transform (K1) RGB equal to the host-scan path's, bit for bit; K3
   equal to its plain version at 16 and 4 (the plain loop steps at ~3 ms
   on the card); by interval, K3's time with its zero fills and sync-flag
   reads (CUDA events, warm and L2-flushed) with ns per symbol, its bound,
   its time at each subsequence length of K3_SUB_BITS with the rounds, the
   host prepass, the upload, the entry end to end and the port's host scan
   of the same images; at ri 0 on a 128x128 corner of source 0, clean and
   with bytes changed, K3 equal to the host scan, its plain version and
   its CPU model (``decode_segments_split_plain``, on the card) with the
   same rounds; K3 equal to its plain version on a corrupt copy of one
   image's segments at ri 4, and to the host scan on gray, 4:4:4 and
   4:2:2 streams. ``--phase device_scan`` runs this phase alone after the
   build, on sources it makes itself;
15. full step: ``full_step`` on the slice's coefficient planes (Y
   [8, 256, 256, 64] int16), 3 K1, 1 K6, 3 K2 and 2 K5 launches, its RGB (2 levels on
   <= 1e-4) and its requantised Y, Cb and Cr (1 on <= 1e-3) against the
   step with the plain versions, the chroma K2 calls also against their
   plain version on the same stacked planes, its four histograms equal to
   the host gather of its own requantised blocks (and to the plain step's
   where the requantised blocks are equal); K5 (the symbol statistics,
   ``csrc/symbol_hist.cu``, reading the step's planes where K2 wrote them:
   the luma walked at MCU (2, 2), Cb and Cr as one call) equal to its plain
   version on the step's own planes and on ``k5_edge_cases`` and
   ``k5_plane_cases`` (there also to its CPU model), 0 bins differing; no
   torch call of the step copying blocks into walk order (no cat of
   [..., 64] blocks, no 6-D permute; ``block_moves``); the step's time
   beside the same step with K5's inputs copied into walk order first and
   with its statistics on their plain version (the step before K5), and its
   kernels by name; its K1 and K2 calls on the luma against their plain
   versions and ``torch.matmul`` in CUDA events, L2 flushed; its K5 calls
   against their plain version in CUDA events, warm and L2-flushed, the
   count of K5 records the profiler keeps of 5 launches, and
   ``tools/k5_probe.py``'s parts of K5 on the step's planes (``k5_parts``).
   Then ``full_step`` on a 4:2:2 batch (the same luma, each chroma block
   row twice: chroma [8, 256, 128, 64]): 3 K1, 1 K6 (its (2, 1)
   instantiation), 3 K2 (the chroma at the 2x1 box, all on the warpgroup
   walk) and 2 K5 launches, counted from 0 just before the step, its
   outputs against the plain step as above and its histograms against the
   host gather with the luma in (2, 1) MCU order.
   ``--phase full_step`` runs this phase alone after the build;
15b. colour round trip: K6 (``kernels.color_round_trip``,
   ``csrc/color_round_trip.cu``) against its plain version
   (``color.round_trip_plain``) on K1-range int32 samples (-300 to
   400, and the int32 extremes) at every benchmark colour cell's shape
   (4:2:0: 4 images of 512 x 512 luma blocks, 256 of 48 x 64; 4:2:2: 4
   of 500 x 750) and two ragged ones of each sampling (MCU rows of 33
   and 13 MCUs), 0 bytes differing in the RGB and the three planes, each
   launch counted under its (hs, vs); K6 timed in CUDA events with the L2
   flushed and warm against its bound (12 B a luma pixel at 4:2:0, 14 B
   at 4:2:2), beside the plain chain; its two records (4:2:0 and 4:2:2,
   at the cells' shapes) carry the K6 launches of phase 15's steps.
   ``--phase color_round_trip`` runs this phase alone after the build
   (its records' launches then None);
15c. gray step: ``gray_step`` (the re-encoding step of one-component
   12-bit frames) and its two new kernel paths: K1's uint16 plane store
   (``kernels.dequantize_idct_plane``) equal to K1's int32 blocks through
   the plain tail (``decode_stage.clamp_plane_u16``), and K2's uint16 load
   equal to its int32 load on the same samples, 0 values differing, at
   GRAY_SHAPES (the benchmark cell's series of 512 slices of 64 x 64
   blocks and two ragged grids); ``gray_step`` on the cell's series with
   1 K1, 1 K2 and 1 K5 launch, its samples and requantised blocks within
   1 of the step with the plain versions on at most GRAY_SHARE of them,
   its histograms equal to K5's plain version on its own blocks; K1's
   plane store, K2's uint16 load, K5 and the whole step timed in CUDA
   events with the L2 flushed (beside their plain versions) and warm
   against their bounds (2 B in and 2 B out a sample for K1 and K2, 6 B a
   sample for the step).
   ``--phase gray_step`` runs this phase alone after the build;
15d. progressive step: K7 (``kernels.progressive_histograms``,
   ``csrc/progressive_hist.cu``), the per-image symbol statistics of
   libjpeg's 10-scan progressive script, against its plain version
   (``encode_stage.progressive_histograms_plain``, image by image), 0 bins
   differing, at PROG_CELL (the benchmark's transcode cell: 32 photo images
   of 4032 x 3024 at q90 from the benchmark's generators), on the same
   batch with its luma flat (EOB runs of 190,512 blocks, past 0x7FFF) and
   at the ragged PROG_RAGGED; ``progressive_step`` on the cell's batch
   with 1 launch a component and 1 of the EOB runs' stitch, counted from
   0; K7 timed in CUDA events, L2 flushed and warm, against its bound (one
   read of the int16 blocks, 128 B a block, and the [B, 11, 256] int32
   histograms' write), beside the plain version and one library read of
   the blocks (``torch.count_nonzero``).
   ``--phase progressive_step`` runs this phase alone after the build;
16. mesh: the mesh layer (``parallel/sharding.py``, ``parallel/distributed.py``
   over ``torch.distributed``) in ranks spawned from here after the build,
   each rank holding each path to its single-device counterpart on the card
   bit for bit, with its K1, K2 and K5 launches counted around each path
   (``mesh_rank``). World 1, NCCL, mesh (1, 1): ``make_sharded_full_step``
   on the step's inputs (3 K1, 3 K2, 2 K5), ``decode_rgb_sharded`` of one image
   through ``assemble_stripes`` (3 K1), ``decode_batch_rgb(mesh=)`` and
   ``decode_batch_rgb_global`` of the 8 images, ``mesh_symbol_frequencies``
   against the host gather (1 K5) and an ``optimize_coding`` encode with the mesh
   (the same bytes), with the host-clock times of the step, the stripe
   decode and the global batch beside their single-device counterparts.
   World 2, gloo, both ranks on cuda:0 (NCCL takes one rank per card):
   the step over meshes (2, 1) and (1, 2), where the boundary DC exchange
   and the histogram all-reduce do real work (3 K1, 3 K2, 2 K5 per rank);
   ``decode_rgb_sharded`` over 2 stripes on the v2 wire, the v1 wire
   (``JPX_WIRE=1``), and progressive and lossless 2048x2048 streams written
   by the host encoders; ``decode_batch_rgb_global`` with 4 images a rank;
   the step's time, logged only (the two ranks share the card's SMs);
17. golden: the bit-exact decode, ``jtt.decode(data,
   xp=device).planes`` (K4, ``csrc/butterfly_idct.cu``, once per component,
   no K1) and ``jtt.decode_region(..., xp=device)`` at two rectangles, on
   the slice's 8 streams, a 12-bit grayscale stream from the host encoder,
   a progressive, an arithmetic and a restart-interval stream, each equal
   to the host numpy path with 0 values differing; K4 equal to its plain
   version (``dct.idct8x8`` in torch ops) on the Y plane of a slice image,
   random int16 and int32 planes and 12-bit planes (quant entries up to
   65,535); K4 timed as in 3 beside its plain version, one ``torch.matmul``
   of the folded IDCT matrix (the same transform, not bit-exact) and its
   bound; the planes' host-clock time beside the host numpy planes'.

Each phase sets the kernels' launch counts to 0 just before the path it
drives and reads them just after. Any failure raises and the script
exits non-zero. The line before the last is a JSON record of the
kernels (K1, one entry per K1 variant, K2, one entry per K2 box of 9,
K3 at each restart interval and on the small ri 0 stream, the K1 and K2
calls of ``full_step``, K4, K5 on ``full_step``'s luma, and K6 at the
16.8 MP cell's shape and at the 24 MP 4:2:2 cell's, K1's plane store, K2's uint16 load and K5 of
``gray_step`` at the CT cell's, K7 at the transcode cell's: launches on the main paths, kernel
time, plain and library time, bound); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits
non-zero before printing any result. Imports neither JAX nor PIL, and
of this repo only the port, ``jpeglibrary_tpu_torch``, and the
benchmark's plain helpers in ``jpegbench/`` (its input encoder, interval
union and peak rates), which import nothing of the port.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# The benchmark's numpy encoder of the decode's inputs, its union of device
# intervals and the H100's published peaks; they import nothing of the port.
from jpegbench.core.peaks import FP32_OPS_PER_S, HBM_BYTES_PER_S, TENSOR_FLOPS_PER_S
from jpegbench.core.trace import union_s
from jpegbench.generators.jpeg420 import encode_420, quantised_planes, synth_image
from jpegbench.reference.tables import ZIGZAG

K1_SOURCE = "jpeglibrary_tpu_torch/csrc/dequant_idct.cu"
K1_REPLACES = "jpeglibrary_tpu/ops/pallas_kernels.py:57"
K2_SOURCE = "jpeglibrary_tpu_torch/csrc/fdct_quant.cu"
K2_REPLACES = "jpeglibrary_tpu/ops/pallas_kernels.py:99"
K3_SOURCE = "jpeglibrary_tpu_torch/csrc/huffman_scan.cu"
K3_REPLACES = "jpeglibrary_tpu/ops/device_scan.py:121"  # _compiled_decoder: XLA, not Pallas
K4_SOURCE = "jpeglibrary_tpu_torch/csrc/butterfly_idct.cu"
K4_REPLACES = "jpeglibrary_tpu/ops/dct.py:167"  # idct8x8, the XLA butterfly of decode(xp=jnp)
K5_SOURCE = "jpeglibrary_tpu_torch/csrc/symbol_hist.cu"
K5_REPLACES = "jpeglibrary_tpu/ops/encode_stage.py:330"  # symbol_histograms_device: XLA, not Pallas
K6_SOURCE = "jpeglibrary_tpu_torch/csrc/color_round_trip.cu"
K6_REPLACES = "jpeglibrary_tpu/parallel/sharding.py:70"  # full_step's colour ops: XLA, no kernel
K7_SOURCE = "jpeglibrary_tpu_torch/csrc/progressive_hist.cu"
# progressive pass 1, the native emitter's count mode on the host: no device code
K7_REPLACES = "jpeglibrary_tpu/models/progressive_encoder.py:292"
# K6's shapes (batch, luma block rows, luma block columns, the chroma's vs):
# at 4:2:0 the benchmark's two 4:2:0 cells, and MCU rows of 33 and 13 MCUs,
# whose last strip is ragged; at 4:2:2 the 24 MP cell's (MCU rows of 375
# MCUs, ragged), and 5 and 9 MCU rows of 33 and 13 MCUs.
K6_SHAPES = ((4, 512, 512, 2), (256, 48, 64, 2), (3, 6, 66, 2), (2, 10, 26, 2),
             (4, 500, 750, 1), (3, 5, 66, 1), (2, 9, 26, 1))
# K6's integer operations a luma pixel as ops/color.py writes them (a clamp
# is two): the luma clamp, three adds with clamps, three products, two adds
# and a shift for each of y, cb and cr; and a chroma cell's (2x2 at 4:2:0,
# 2x1 at 4:2:2): two clamps, the two -128s, and 3 + 3 + 5 for cr_r, cb_b
# and g_off.
K6_OPS_PER_PIXEL = 2 + 3 * 3 + 3 * 7
K6_OPS_PER_CELL = 2 * 2 + 2 + 3 + 3 + 5
# K4's float operations per block: 16 one-dimensional passes of 12
# multiplies, 25 adds and 7 subtracts, and per sample the dequantize
# multiply, the conversion, the 1/8 scale, the rounding and the level shift.
K4_OPS_PER_BLOCK = 16 * 44 + 64 * 5
# gray_step's shapes (slices, block rows, block columns): the benchmark
# cell's series of 512 slices of 512 x 512, and two ragged grids.
GRAY_SHAPES = ((512, 64, 64), (3, 5, 7), (2, 13, 33))
GRAY_SHARE = 1e-3  # samples and blocks within 1 of the plain step on at most this share
# progressive_step's batches (images, height, width): the benchmark's
# transcode cell (32 phone photos of 4032 x 3024, 4:2:0, q90) and a ragged
# size whose luma grid is smaller than its padded plane.
PROG_CELL = (32, 3024, 4032)
PROG_RAGGED = (4, 2999, 4001)
PROG_QUALITY = 90
PROG_CHUNK = 4  # images of content made at a time
GOLDEN_RECTS = ((136, 264, 640, 480), (1, 1031, 2047, 17))  # (x, y, w, h) regions
# The device scan's restart intervals, in MCUs per segment: one MCU row of a
# 2048x2048 4:2:0 image (128 segments), 16 (1,024) and 4 (4,096); and a
# stream without restart markers (one segment) besides. The plain version
# steps once per symbol of the longest segment, some 100 small launches a
# step, so it is timed only where segments are short.
RESTART_INTERVALS = (128, 16, 4)
PLAIN_RIS = (16, 4)
CORRUPT_BYTES = 2000  # changed in one image's 4,096 segments at ri 4
K3_SUB_BITS = (512, 1024, 2048)  # K3's subsequence lengths, each timed on image 0
SMALL_SIZE = 128  # K3 against its plain version at ri 0 on this corner of source 0
SMALL_CORRUPT_BYTES = 40  # changed in the small stream's one segment
K3_OPS_PER_SYMBOL = 24  # integer operations of K3's loop body per symbol, counted in its source
KERNEL_BLOCKS = (65536, 16384)  # Y and each chroma plane of a 2048x2048 4:2:0 image
LEVEL_SHIFTS = (128, 2048)
# K1's variants: (record key, label, quant tables, blocks per table, n).
K1_VARIANTS = (
    ("k1_tables", "8 tables", 8, 65536, 8),  # a group of 8 Y planes
    (None, "8 tables, straddling", 8, 65500, 8),  # CTAs of 64 blocks span two tables
    ("k1_n4", "n=4", 1, 65536, 4),  # the Y plane at 1/2
    ("k1_n2", "n=2", 1, 65536, 2),  # at 1/4
    ("k1_n1", "n=1", 1, 65536, 1),  # at 1/8
)
N_IMAGES = 8
N_ARITH = 4  # images re-encoded with arithmetic coding for the v1 plane-order wire
SIZE = 2048
TIMED_RUNS = 25
STREAM_RUNS = 5  # warm stream runs after the first; host-clock times vary from run to run
STAGE_RUNS = 5  # encode device stages under the profiler that lists their kernels
GROUPS = (1, 2, 4, 8)
MIN_PSNR_DB = 22.0  # the decode against its source image; q75 and the noise give ~24.6 dB
SCALED_SHARE = 0.05  # the JAX package's scaled contract: <= 2 levels on < 5% of the values
SPIN_CYCLES = 2_000_000  # about 1 ms at the H100's clocks
FLUSH_BYTES = 256 << 20  # written between timed calls to empty the 50 MB L2


def log(*args):
    print(*args, flush=True)


def check(ok, what):
    """Fail the run (a check that ``python -O`` keeps, unlike assert)."""
    if not ok:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def device_ms(*fns, runs=TIMED_RUNS, warmup=3, flush=None):
    """Median device milliseconds of each of ``fns``, timed in turns with
    CUDA events, ``runs`` calls each. A spin kernel ahead of each start
    event keeps the card busy while the host enqueues the call, so the
    time excludes the host's launch cost (an idle card would wait for it
    between the events); the device's own gap before and after a launch,
    about 5 us on the H100, stays in it. With ``flush``, a write of all of
    it ahead of the spin kernel empties the L2 before each call."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(runs):
        for fn, ts in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if flush is not None:
                flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
    return [statistics.median(ts) for ts in times]


def kernel_ms(*fns, runs=TIMED_RUNS, rounds=5, flush=None, retries=20):
    """Mean device milliseconds per call of each of ``fns``: the summed
    durations of the kernels the call launched, as ``torch.profiler``
    (CUPTI) records them, so without the launch gaps that the events of
    :func:`device_ms` include. Timed in ``rounds`` turns of ``runs /
    rounds`` calls each. With ``flush``, each call is preceded by a write of
    all of it (its fill kernels are not counted), so the call finds its
    inputs in device memory and not in the L2.

    CUPTI loses kernel records now and then, at times a whole window's
    (on the H100, in one run, every window of one K2 box's calls). A
    function launches the same
    kernels in every window, so a window is full when it holds as many
    records as the most any of the function's windows held; windows short
    of that are timed again, up to ``retries`` more per function, until
    ``rounds`` are full, and the mean is over the full windows alone."""
    activity = [torch.profiler.ProfilerActivity.CUDA]
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    per = runs // rounds

    def window(fn):
        with torch.profiler.profile(activities=activity) as prof:
            for _ in range(per):
                if flush is not None:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "Fill" not in e.key and "Memset" not in e.key]
        return sum(e.count for e in rows), sum(e.self_device_time_total for e in rows)

    windows = [[] for _ in fns]
    for _ in range(rounds):
        for fn, ws in zip(fns, windows):
            ws.append(window(fn))
    out = []
    for fn, ws in zip(fns, windows):
        for _ in range(retries):
            full = max(ws)[0]
            if full and sum(n == full for n, _ in ws) >= rounds:
                break
            ws.append(window(fn))
        full = max(ws)[0]
        if full == 0:
            raise RuntimeError(f"the profiler recorded no kernel in {len(ws)} windows")
        kept = [t for n, t in ws if n == full]
        out.append(sum(kept) / (per * len(kept)) / 1e3)  # profiler microseconds
    return out


def wall_ms(fn, runs=TIMED_RUNS, warmup=3):
    """Median host-clock milliseconds of ``fn`` followed by a synchronise:
    what a caller waits, launch costs included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def timed(fn):
    """``fn()`` and its host-clock seconds to a synchronised card."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def warm_median_s(fn, runs=STREAM_RUNS):
    """Median host-clock seconds of ``runs`` calls of ``fn`` after one
    warm-up call."""
    fn()
    return statistics.median(timed(fn)[1] for _ in range(runs))


def stream(datas, dev, **kwargs):
    import jpeglibrary_tpu_torch as jtt

    return list(jtt.decode_stream_rgb(datas, device=dev, **kwargs))


def reset_counts():
    from jpeglibrary_tpu_torch.ops import kernels

    kernels.dequantize_idct_shift.launches = 0
    kernels.fdct_quantize.launches = 0
    kernels.fdct_quantize.launches_by_box.clear()
    kernels.fdct_quantize.launches_by_walk.clear()
    kernels.huffman_scan.launches = 0
    kernels.butterfly_idct_shift.launches = 0
    kernels.symbol_histograms.launches = 0
    kernels.color_round_trip.launches = 0
    kernels.color_round_trip.launches_by_box.clear()
    kernels.dequantize_idct_plane.launches = 0
    kernels.progressive_histograms.launches = 0
    kernels.progressive_histograms.launches_by_walk.clear()


def check_close(got, want, what, share=1e-4):
    """``got`` within 2 RGB levels of ``want`` on at most ``share`` of the
    values; logs and returns (max |diff|, differing values)."""
    check(got.shape == want.shape, (what, got.shape, want.shape))
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    n_diff = int((d > 0).sum())
    log(f"{what}: max |diff| {int(d.max())}, {n_diff}/{d.size} values differ")
    check(d.max() <= 2 and n_diff <= d.size * share, (what, int(d.max()), n_diff))
    return int(d.max()), n_diff


def phase_environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(smi)  # card name, power limit
    from jpeglibrary_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    nvcc_version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[-1]
    try:
        import triton

        triton_state = f"imports, {triton.__version__}"
    except ImportError as exc:
        triton_state = f"does not import ({exc})"
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"torch.version.cuda {torch.version.cuda}")
    log(f"nvcc {nvcc}: {nvcc_version}")
    log(f"triton {triton_state}")
    log(f"device 0: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    # The plain K1 version runs a float32 matmul; TF32 would break its
    # 1-LSB contract, and the plain version raises while it is allowed.
    # PyTorch's default is already off; set it explicitly.
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")


def phase_build():
    from jpeglibrary_tpu_torch.ops import _build

    t0 = time.perf_counter()
    so = _build.build_library()
    _build.load_library()
    t1 = time.perf_counter()
    _build.load_scanner()
    t2 = time.perf_counter()
    log(f"build: CUDA kernels {t1 - t0:.3f} s ({so.name}), native scanner {t2 - t1:.3f} s")
    ptxas = [ln for ln in so.with_suffix(".log").read_text().splitlines() if "ptxas" in ln]
    for ln in ptxas:
        log(f"  {ln.strip()}")


def bound(n_bytes, mma_flops, other_ops):
    """(bound ms, what bounds it) for a call that moves ``n_bytes``, does
    ``mma_flops`` of matrix product (at the tensor cores' dense bf16 rate)
    and ``other_ops`` per-element operations (at the CUDA cores' fp32
    rate): the least time the card could take for the same work."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (mma_flops / TENSOR_FLOPS_PER_S + other_ops / FP32_OPS_PER_S) * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def k1_bound(n_blocks, n_tables, n, itemsize):
    """K1's bound: coefficients, tables and matrix in, samples out; the
    product's 2 * 64 * w flops per block, per coefficient one dequant
    multiply and per sample one rounding add."""
    w = n * n
    n_bytes = n_blocks * 64 * itemsize + n_tables * 64 * 4 + 64 * w * 4 + n_blocks * w * 4
    return bound(n_bytes, n_blocks * 2 * 64 * w, n_blocks * 64 + n_blocks * w)


def k1_record(key, label, k_ms, p_ms, lib_ms, bound_ms, bound_by, max_abs):
    return {"name": "dequantize_idct_shift" if key == "k1" else f"dequantize_idct_shift[{label}]",
            "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES, "launches": None,
            "max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


def phase_kernel(dev):
    """K1 and its variants against the plain version on the card; returns
    the records, keyed "k1" and by K1_VARIANTS. Each shape is timed warm
    (its inputs in the L2, as the path finds them after the densify) and
    with the L2 flushed; the records carry the flushed times. The library
    yardstick is one ``torch.matmul`` of the pre-dequantized fp32 blocks by
    the same matrix (full fp32, the product cuBLAS computes)."""
    from jpeglibrary_tpu_torch.ops import decode_stage, kernels

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    matrix = kernels.transform_matrix(dev)
    rng = np.random.default_rng(1234)
    worst = 0
    records = {}
    for n in KERNEL_BLOCKS:
        coeffs16 = torch.from_numpy(
            rng.integers(-1024, 1024, size=(n, 64)).astype(np.int16)).to(dev)
        coeffs = coeffs16.to(torch.int32)  # what the densify hands K1
        quant = torch.from_numpy(rng.integers(1, 256, size=64).astype(np.int32)).to(dev)
        for ls in LEVEL_SHIFTS:
            for c in (coeffs, coeffs16):
                got = kernels.dequantize_idct_shift(c, quant, ls)
                want = decode_stage.dequantize_idct_shift(c, quant, n, ls, matrix)
                torch.cuda.synchronize()
                check(got.shape == want.shape == (n, 8, 8) and got.dtype == torch.int32,
                      (tuple(got.shape), got.dtype))
                diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
                max_abs = int(diff.max())
                share = float((diff > 0).double().mean())
                log(f"kernel: K1 vs plain, {n} blocks, {c.dtype}, level_shift {ls}: "
                    f"max |diff| {max_abs}, differing share {share:.3e}")
                check(max_abs <= 1 and share <= 1e-3, (n, c.dtype, ls, max_abs, share))
                worst = max(worst, max_abs)
        deq = (coeffs * quant).to(torch.float32)
        fns = (
            lambda: decode_stage.dequantize_idct_shift(coeffs, quant, n, 128, matrix),
            lambda: kernels.dequantize_idct_shift(coeffs, quant, 128),
            lambda: torch.matmul(deq, matrix),
            lambda: kernels.dequantize_idct_shift(coeffs16, quant, 128),
        )
        p_ev, k_ev, lib_ev, k16_ev = device_ms(*fns)
        log(f"kernel: K1 {n} blocks, warm, CUDA events around each call (launch gaps "
            f"included): K1 {k_ev:.6f} ms, int16 input {k16_ev:.6f} ms, plain "
            f"{p_ev:.6f} ms, torch.matmul {lib_ev:.6f} ms (median of {TIMED_RUNS} in turns)")
        warm = kernel_ms(*fns)
        cold = kernel_ms(*fns, flush=flush)
        b_ms, b_by = k1_bound(n, 1, 8, 4)
        b16_ms, _ = k1_bound(n, 1, 8, 2)
        for what, (p_ms, k_ms, lib_ms, k16_ms) in (("warm", warm), ("L2 flushed", cold)):
            log(f"kernel: K1 {n} blocks int32, {what}: K1 {k_ms:.6f} ms "
                f"({b_ms / k_ms:.1%} of its {b_by} bound {b_ms:.6f} ms), plain {p_ms:.6f} ms, "
                f"torch.matmul of the dequantized fp32 blocks {lib_ms:.6f} ms; int16 input "
                f"{k16_ms:.6f} ms (bound {b16_ms:.6f} ms) (kernel time, mean of {TIMED_RUNS} "
                "in turns)")
        if n == KERNEL_BLOCKS[0]:
            p_ms, k_ms, lib_ms, _ = cold
            records["k1"] = k1_record("k1", "", k_ms, p_ms, lib_ms, b_ms, b_by, worst)

    for key, label, n_tables, per_table, n in K1_VARIANTS:
        # Full-size variants at the K1 check's magnitudes above; the reduced ones at a
        # real decode's (dequantized coefficients up to 2048), where fp32
        # rounding noise is far below the .5 ties' spacing.
        lo, q_hi = (1024, 256) if n == 8 else (64, 32)
        n_blocks = n_tables * per_table
        coeffs = torch.from_numpy(
            rng.integers(-lo, lo, size=(n_blocks, 64)).astype(np.int32)).to(dev)
        quants = torch.from_numpy(
            rng.integers(1, q_hi, size=(n_tables, 64)).astype(np.int32)).to(dev)
        matrix_n = kernels.transform_matrix(dev, n)
        table = torch.arange(n_blocks, device=dev) // per_table
        deq = (coeffs * quants[table]).to(torch.float32)

        def plain():
            return decode_stage.dequantize_idct_shift(coeffs, quants, per_table, 128, matrix_n)

        def kernel():
            return kernels.dequantize_idct_shift(coeffs, quants, 128,
                                                 blocks_per_table=per_table, scale_n=n)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        check(got.shape == want.shape == (n_blocks, n, n) and got.dtype == torch.int32,
              (label, tuple(got.shape), got.dtype))
        diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
        max_abs = int(diff.max())
        share = float((diff > 0).double().mean())
        if n == 2:
            exact = (coeffs.double() * quants[table].double()) @ matrix_n.double()
            near_tie = ((exact - exact.floor() - 0.5).abs() < 1e-3).reshape(got.shape)
            off_tie = int((diff > 0)[~near_tie].sum())
            log(f"kernel: K1 {label}: {float(near_tie.double().mean()):.3e} of the samples "
                f"are near .5 ties; differing samples off them: {off_tie}")
            check(max_abs <= 1 and off_tie == 0, (label, max_abs, off_tie))
        else:
            check(max_abs <= 1 and share <= 1e-3, (label, max_abs, share))
        fns = (plain, kernel, lambda: torch.matmul(deq, matrix_n))
        p_ev, k_ev, lib_ev = device_ms(*fns)
        warm = kernel_ms(*fns)
        cold = kernel_ms(*fns, flush=flush)
        b_ms, b_by = k1_bound(n_blocks, n_tables, n, 4)
        log(f"kernel: K1 {label}, warm, CUDA events around each call: K1 {k_ev:.6f} ms, "
            f"plain {p_ev:.6f} ms, torch.matmul {lib_ev:.6f} ms (median of {TIMED_RUNS})")
        for what, (p_ms, k_ms, lib_ms) in (("warm", warm), ("L2 flushed", cold)):
            log(f"kernel: K1 {label}, {n_tables} x {per_table} blocks -> [{n_blocks}, {n}, {n}], "
                f"{what}: K1 {k_ms:.6f} ms ({b_ms / k_ms:.1%} of its {b_by} bound "
                f"{b_ms:.6f} ms), plain {p_ms:.6f} ms, torch.matmul {lib_ms:.6f} ms "
                f"(kernel time, mean of {TIMED_RUNS} in turns)")
        log(f"kernel: K1 {label}: max |diff| {max_abs}, differing share {share:.3e}")
        if key is None:  # the straddling layout: a check on the "8 tables" record
            records["k1_tables"]["max_abs_err"] = max(records["k1_tables"]["max_abs_err"],
                                                      max_abs)
            continue
        p_ms, k_ms, lib_ms = cold
        records[key] = k1_record(key, label, k_ms, p_ms, lib_ms, b_ms, b_by, max_abs)
    del flush
    return records


def k2_bound(n_blocks, itemsize, plane_samples=None):
    """K2's bound: the unpadded plane (``plane_samples``, by default 64 per
    block: no box), the quant table and the bf16 split of F in, int16
    coefficients out; the product's 2 * 64 * 64 flops per block, per
    sample one box add, per coefficient a level shift and a divide."""
    if plane_samples is None:
        plane_samples = n_blocks * 64
    n_bytes = plane_samples * itemsize + 64 * 4 + 3 * 64 * 64 * 2 + n_blocks * 64 * 2
    return bound(n_bytes, n_blocks * 2 * 64 * 64, plane_samples + n_blocks * 64 * 2)


# K2's shapes: (label, height, width, sample dtype, level shift, hs, vs). The
# first two are the main path's (the Y plane and one chroma plane of a
# 2048x2048 4:2:0 image); a 1999-sample pitch takes the byte copy (uint8) or
# the 4-byte copy (int32) instead of 16-byte cp.async.
K2_SHAPES = (
    ("Y 2048x2048 uint8 1x1", 2048, 2048, torch.uint8, 128, 1, 1),
    ("chroma 2048x2048 uint8 2x2", 2048, 2048, torch.uint8, 128, 2, 2),
    ("ragged 2047x1999 uint8 2x2", 2047, 1999, torch.uint8, 128, 2, 2),
    ("ragged 2047x1999 uint8 2x1", 2047, 1999, torch.uint8, 128, 2, 1),
    ("12-bit 2048x2048 int32 1x1", 2048, 2048, torch.int32, 2048, 1, 1),
    ("12-bit ragged 2047x1999 int32 2x1", 2047, 1999, torch.int32, 2048, 2, 1),
    ("Y 2048x2048 int32 1x1", 2048, 2048, torch.int32, 128, 1, 1),
)


def k2_plain(plane, quant, ls, hs, vs, matrix):
    """K2's plain version on the card: pad_to_grid -> subsample_box ->
    fdct_quantize, as the wrapper runs it for a CPU plane."""
    from jpeglibrary_tpu_torch.ops import encode_stage

    h, w = plane.shape
    hb, wb = -(-h // (8 * vs)), -(-w // (8 * hs))
    padded = encode_stage.pad_to_grid(plane, hb * 8 * vs, wb * 8 * hs)
    return encode_stage.fdct_quantize(encode_stage.subsample_box(padded, hs, vs), quant, ls,
                                      matrix)


def k2_check(label, plane, quant, ls, hs, vs, matrix):
    """K2 against its plain version on one plane: within 1 on <= 1e-3 of
    the values; returns the largest difference."""
    from jpeglibrary_tpu_torch.ops import kernels

    got = kernels.fdct_quantize(plane, quant, ls, hs=hs, vs=vs)
    want = k2_plain(plane, quant, ls, hs, vs, matrix)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == torch.int16,
          (label, tuple(got.shape), got.dtype))
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    max_abs = int(diff.max())
    share = float((diff > 0).double().mean())
    log(f"kernel: K2 vs plain, {label} ({want.shape[0] * want.shape[1]} blocks), level shift "
        f"{ls}: max |diff| {max_abs}, differing share {share:.3e}")
    check(max_abs <= 1 and share <= 1e-3, (label, max_abs, share))
    return max_abs


def k2_times(label, plane, quant, ls, hs, vs, matrix, flush, events=False):
    """K2, its plain version and one ``torch.matmul`` of the subsampled,
    level-shifted blocks cut beforehand, in kernel time warm and with the
    L2 flushed (and with ``events`` in CUDA events too); logs them,
    returns the flushed (plain, K2, matmul) ms and K2's bound."""
    from jpeglibrary_tpu_torch.ops import encode_stage, kernels

    h, w = plane.shape
    hb, wb = -(-h // (8 * vs)), -(-w // (8 * hs))
    sub = encode_stage.subsample_box(
        encode_stage.pad_to_grid(plane, hb * 8 * vs, wb * 8 * hs), hs, vs)
    blocks = (sub.to(torch.float32) - ls).reshape(hb, 8, wb, 8).permute(0, 2, 1, 3)
    blocks = blocks.reshape(-1, 64).contiguous()
    fns = (
        lambda: k2_plain(plane, quant, ls, hs, vs, matrix),
        lambda: kernels.fdct_quantize(plane, quant, ls, hs=hs, vs=vs),
        lambda: torch.matmul(blocks, matrix),
    )
    if events:
        p_ev, k_ev, lib_ev = device_ms(*fns)
        log(f"kernel: K2 {label}, CUDA events around each call (launch gaps included): K2 "
            f"{k_ev:.6f} ms, plain {p_ev:.6f} ms, torch.matmul {lib_ev:.6f} ms (median of "
            f"{TIMED_RUNS} in turns)")
    warm = kernel_ms(*fns)
    cold = kernel_ms(*fns, flush=flush)
    b_ms, b_by = k2_bound(hb * wb, plane.element_size(), h * w)
    for what, (p_ms, k_ms, lib_ms) in (("warm", warm), ("L2 flushed", cold)):
        log(f"kernel: K2 {label}, {what}: K2 {k_ms:.6f} ms ({b_ms / k_ms:.1%} of its "
            f"{b_by} bound {b_ms:.6f} ms), plain (pad, subsample, fdct_quantize) "
            f"{p_ms:.6f} ms, torch.matmul of the pre-cut fp32 blocks {lib_ms:.6f} ms "
            f"(kernel time, mean of {TIMED_RUNS} in turns)")
    return cold, b_ms, b_by


def phase_kernel_fdct(dev):
    """K2 against its plain version on the card at K2_SHAPES and on exact
    ties; each shape timed warm and with the L2 flushed, beside the plain
    version and one ``torch.matmul`` of the subsampled, level-shifted
    blocks cut beforehand (full fp32, the product cuBLAS computes).
    Returns the record, with the Y plane's flushed times."""
    from jpeglibrary_tpu_torch.ops import kernels

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    matrix = kernels.fdct_matrix(dev)
    rng = np.random.default_rng(4321)
    worst = 0
    record = None
    for label, h, w, dtype, ls, hs, vs in K2_SHAPES:
        plane = torch.from_numpy(rng.integers(0, 2 * ls, size=(h, w))).to(dtype).to(dev)
        quant = torch.from_numpy(rng.integers(1, 256, size=64).astype(np.int32)).to(dev)
        worst = max(worst, k2_check(label, plane, quant, ls, hs, vs, matrix))
        (p_ms, k_ms, lib_ms), b_ms, b_by = k2_times(label, plane, quant, ls, hs, vs, matrix,
                                                    flush, events=True)
        if record is None:  # the Y plane, the first shape
            record = {"name": "fdct_quantize", "route": "cuda", "source": K2_SOURCE,
                      "replaces": K2_REPLACES, "launches": None, "max_abs_err": None,
                      "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": lib_ms}
        del plane
    del flush

    # Exact ties: blocks constant after the box, level shift + s, have DC 8s
    # exactly, so q = 16 gives s/2, a .5 for odd s, which must round half to even.
    s = np.arange(-128, 128)
    want_dc = torch.from_numpy(np.rint(s / 2).astype(np.int16))
    q16 = torch.full((64,), 16, dtype=torch.int32, device=dev)
    for ls, dtype, hs, vs in ((128, torch.uint8, 1, 1), (128, torch.int32, 1, 1),
                              (2048, torch.int32, 1, 1), (128, torch.uint8, 2, 2),
                              (2048, torch.int32, 2, 1)):
        plane = np.repeat(np.repeat((ls + s).reshape(16, 16), 8 * vs, 0), 8 * hs, 1)
        plane = torch.from_numpy(plane).to(dtype).to(dev)
        got = kernels.fdct_quantize(plane, q16, ls, hs=hs, vs=vs).reshape(256, 64).cpu()
        plain = k2_plain(plane, q16, ls, hs, vs, matrix).reshape(256, 64).cpu()
        check(torch.equal(got[:, 0], want_dc) and not got[:, 1:].any(), ("ties", ls, dtype, hs))
        check(torch.equal(got, plain), ("ties vs plain", ls, dtype, hs))
    log("kernel: K2 exact ties (128 odd DC values of s/2; uint8 and int32, level shifts "
        "128 and 2048, boxes 1x1, 2x2 and 2x1): all round half to even, equal to the plain "
        "version")
    record["max_abs_err"] = worst
    return record


# K2 at the boxes only T.81's rarer sampling factors give, a component 3 or
# 4 times finer than another (hs, vs), for 8-bit uint8 and 12-bit int32
# samples: (record key suffix, dtype, level shift).
K2_BOXES = ((3, 1), (1, 3), (3, 3), (4, 3), (4, 4))
K2_BOX_KINDS = (("u8", torch.uint8, 128), ("i32", torch.int32, 2048))


def phase_k2_boxes(dev):
    """K2 at K2_BOXES against its plain version on the card: each box and
    sample type on a 2048x2048 plane and a ragged 2047x1999 one, and at 3x3
    on int32 samples down to -30000, whose box sums fall below zero; each
    timed on the 2048x2048 plane. Returns one record per box and type."""
    from jpeglibrary_tpu_torch.ops import encode_stage, kernels

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    matrix = kernels.fdct_matrix(dev)
    rng = np.random.default_rng(5678)
    records = {}
    for hs, vs in K2_BOXES:
        for suffix, dtype, ls in K2_BOX_KINDS:
            label = f"{hs}x{vs} {dtype}".replace("torch.", "")
            quant = torch.from_numpy(rng.integers(1, 256, size=64).astype(np.int32)).to(dev)
            ragged = torch.from_numpy(rng.integers(0, 2 * ls, size=(2047, 1999))).to(dtype)
            worst = k2_check(f"ragged 2047x1999 {label}", ragged.to(dev), quant, ls, hs, vs,
                             matrix)
            if dtype == torch.int32 and (hs, vs) == (3, 3):
                signed = torch.from_numpy(
                    rng.integers(-30000, 30000, size=(2047, 1999)).astype(np.int32)).to(dev)
                hb, wb = -(-2047 // 24), -(-1999 // 24)
                sums = encode_stage.subsample_box(
                    encode_stage.pad_to_grid(signed, hb * 24, wb * 24), 3, 3)
                log(f"kernel: K2 3x3 int32 samples in [-30000, 30000): "
                    f"{float((sums < 0).double().mean()):.3f} of the boxes are negative")
                worst = max(worst, k2_check(f"ragged 2047x1999 {label}, signed samples",
                                            signed, quant, ls, hs, vs, matrix))
                del signed, sums
            plane = torch.from_numpy(rng.integers(0, 2 * ls, size=(SIZE, SIZE))).to(dtype).to(dev)
            worst = max(worst, k2_check(f"{SIZE}x{SIZE} {label}", plane, quant, ls, hs, vs,
                                        matrix))
            (p_ms, k_ms, lib_ms), b_ms, b_by = k2_times(f"{SIZE}x{SIZE} {label}", plane, quant,
                                                        ls, hs, vs, matrix, flush)
            records[(dtype, hs, vs)] = {
                "name": f"fdct_quantize[{hs}x{vs} {suffix}]", "route": "cuda",
                "source": K2_SOURCE, "replaces": K2_REPLACES, "launches": None,
                "max_abs_err": worst, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms}
            del plane, ragged
    del flush
    # Exact ties at the new boxes, as in phase_kernel_fdct.
    s = np.arange(-128, 128)
    want_dc = torch.from_numpy(np.rint(s / 2).astype(np.int16))
    q16 = torch.full((64,), 16, dtype=torch.int32, device=dev)
    for hs, vs in K2_BOXES:
        for _, dtype, ls in K2_BOX_KINDS:
            plane = np.repeat(np.repeat((ls + s).reshape(16, 16), 8 * vs, 0), 8 * hs, 1)
            plane = torch.from_numpy(plane).to(dtype).to(dev)
            got = kernels.fdct_quantize(plane, q16, ls, hs=hs, vs=vs).reshape(256, 64).cpu()
            check(torch.equal(got[:, 0], want_dc) and not got[:, 1:].any(),
                  ("ties", hs, vs, dtype))
    log(f"kernel: K2 exact ties at boxes {K2_BOXES}, uint8 and int32: all round half to even")
    return records


def box_encoder(planes, hs, vs, precision):
    """A 2-component encoder whose second component is sampled hs x vs
    coarser than the first (luma (hs, vs), chroma 1x1), with optimized
    Huffman tables: the layout whose chroma plane K2 boxes by (hs, vs)."""
    import jpeglibrary_tpu_torch as jtt
    from jpeglibrary_tpu_torch.host.syntax.quantization import (
        scale_by_quality,
        standard_luminance_table,
    )

    encoder = jtt.JpegEncoder()
    encoder.sample_precision = precision
    encoder.set_quantization_table(scale_by_quality(standard_luminance_table(0), 75))
    encoder.set_huffman_table(True, 0)
    encoder.set_huffman_table(False, 0)
    encoder.add_component(1, 0, 0, 0, hs, vs)
    encoder.add_component(2, 0, 0, 0, 1, 1)
    encoder.set_input(planes)
    return encoder


def check_encode_planes(label, encoder, data, dev):
    """The card's coefficient planes of ``encoder`` within 1 of the CPU
    path's on <= 1e-3 of the values, ``data`` its emission, and equal to
    the CPU path's bytes wherever the planes are equal."""
    from jpeglibrary_tpu_torch.models import encoder as port_encoder

    card = port_encoder.coefficient_planes(encoder, device=dev)
    cpu = port_encoder.coefficient_planes(encoder, device="cpu")
    n_diff = n_all = max_abs = 0
    for g, w in zip(card, cpu):
        d = np.abs(g.astype(np.int32) - w)
        n_diff += int((d > 0).sum())
        n_all += d.size
        max_abs = max(max_abs, int(d.max()))
    check(port_encoder.emit(encoder, card) == data, (label, "the planes emit other bytes"))
    same = n_diff == 0 and port_encoder.emit(encoder, cpu) == data
    log(f"{label}: coefficients vs CPU path max |diff| {max_abs}, {n_diff}/{n_all} differ; "
        f"bytes {'equal to' if same else 'differ from'} the CPU path's")
    check(max_abs <= 1 and n_diff <= n_all * 1e-3, (label, max_abs, n_diff))
    check(n_diff > 0 or same, (label, "equal planes, other bytes"))


def phase_encode_boxes(records, sources, dev):
    """The device encode through every box of K2_BOXES: ``jtt.encode`` of
    box_encoder over two 2048x2048 planes, at 8 and 12 bits; one K2 launch
    for each (sample type, box), the planes against the CPU path."""
    import jpeglibrary_tpu_torch as jtt
    from jpeglibrary_tpu_torch.ops import kernels

    y, c = sources[0][..., 0], sources[0][..., 1]
    jobs = []
    for hs, vs in K2_BOXES:
        for precision in (8, 12):
            planes = [y, c] if precision == 8 else [y.astype(np.int32) * 16,
                                                    c.astype(np.int32) * 16]
            jobs.append((hs, vs, precision, box_encoder(planes, hs, vs, precision)))
    reset_counts()
    datas = [jtt.encode(enc, device=dev) for _, _, _, enc in jobs]
    by_box = dict(kernels.fdct_quantize.launches_by_box)
    log(f"encode boxes: {len(jobs)} encodes, K2 launches by (dtype, hs, vs): "
        + ", ".join(f"{str(k[0]).replace('torch.', '')} {k[1]}x{k[2]}: {n}"
                    for k, n in sorted(by_box.items(), key=str)))
    for key, rec in records.items():
        launches = by_box.get(key, 0)
        check(launches == 1, (rec["name"], "launches", launches))
        rec["launches"] = launches
    for (hs, vs, precision, enc), data in zip(jobs, datas):
        res = jtt.decode(data)
        check((res.width, res.height) == (SIZE, SIZE), (hs, vs, res.width, res.height))
        check_encode_planes(f"encode boxes: luma {hs}x{vs}, {precision}-bit, {len(data)} bytes",
                            enc, data, dev)


def phase_cmyk(sources, dev):
    """``encode_cmyk`` on the card, plain CMYK (1x1) and YCCK 4:2:0, of
    one 2048x2048 ink image: 4 K2 launches each, the planes against the
    CPU path. Returns the launches."""
    import jpeglibrary_tpu_torch as jtt
    from jpeglibrary_tpu_torch.models import encoder as port_encoder
    from jpeglibrary_tpu_torch.ops import kernels

    ink = np.concatenate([sources[1], sources[2][..., :1]], axis=-1)
    jobs = (("CMYK", {}), ("YCCK 4:2:0", {"ycck": True, "subsampling": "420"}))
    reset_counts()
    datas = [jtt.encode_cmyk(ink, 75, device=dev, **kw) for _, kw in jobs]
    launches = kernels.fdct_quantize.launches
    log(f"cmyk: encode_cmyk of a {SIZE}x{SIZE} ink image, CMYK and YCCK: K2 launches {launches}")
    check(launches == 4 * len(jobs), f"K2 launches {launches}")
    for (label, kw), data in zip(jobs, datas):
        fidelity = psnr(jtt.decode(data).to_cmyk8(), ink)
        log(f"cmyk: {label}: {len(data)} bytes, PSNR of the decoded ink {fidelity:.2f} dB")
        check(fidelity >= MIN_PSNR_DB, (label, fidelity))
        check_encode_planes(f"cmyk: {label}", port_encoder.cmyk_encoder(ink, 75, **kw), data,
                            dev)
    med = warm_median_s(lambda: jtt.encode_cmyk(ink, 75, device=dev, ycck=True))
    log(f"cmyk: encode_cmyk YCCK 4:2:0 median {med * 1e3:.6f} ms of {STREAM_RUNS} warm runs")
    return launches


def check_u16_close(got, want, precision, what):
    """u16 outputs compared as samples (``>> (16 - precision)``): within 1
    on <= 1e-4; a sample one below 0, which the writer wraps to the top
    against the other's 0, counts as the 1-LSB difference it is."""
    check(got.shape == want.shape and got.dtype == want.dtype == np.uint16,
          (what, got.shape, want.shape, got.dtype))
    shift = 16 - precision
    a, b = got.astype(np.int64) >> shift, want.astype(np.int64) >> shift
    top = (1 << precision) - 1
    wrapped = ((a == top) & (b == 0)) | ((a == 0) & (b == top))
    d = np.where(wrapped, 1, np.abs(a - b))
    n_diff = int((d > 0).sum())
    log(f"{what}: max sample |diff| {int(d.max())}, {n_diff}/{d.size} samples differ")
    check(d.max() <= 1 and n_diff <= d.size * 1e-4, (what, int(d.max()), n_diff))


def phase_fancy_u16(sl, dev):
    """Fancy upsampling and the u16 output of the 8 images on the card,
    each against the port's CPU path, 3 K1 launches an image."""
    import jpeglibrary_tpu_torch as jtt
    from jpeglibrary_tpu_torch.models.decoder import quant_tables
    from jpeglibrary_tpu_torch.ops import kernels
    from jpeglibrary_tpu_torch.parallel.batch import scan

    results = [scan(d) for d in sl["datas"]]
    gold = [jtt.to_rgb8_device(r, device="cpu", upsample="fancy").numpy() for r in results]
    reset_counts()
    outs = [jtt.to_rgb8_device(r, device=dev, upsample="fancy") for r in results]
    torch.cuda.synchronize()
    launches = kernels.dequantize_idct_shift.launches
    log(f"fancy: to_rgb8_device(upsample='fancy') of {N_IMAGES} images: K1 launches {launches}")
    check(launches == 3 * N_IMAGES, f"K1 launches {launches}")
    for i, (out, g) in enumerate(zip(outs, gold)):
        check(out.dtype == torch.uint8 and tuple(out.shape) == (3, SIZE, SIZE), out.shape)
        check_close(out.cpu().numpy(), g, f"fancy: image {i} vs CPU path")
        d = np.abs(out.cpu().numpy().astype(np.int16) - sl["outs"][i].cpu().numpy())
        log(f"fancy: image {i}: {float((d > 0).mean()):.3f} of the values differ from the "
            "duplicate upsampling's")
    fancy_ms = wall_ms(lambda: [jtt.to_rgb8_device(r, device=dev, upsample="fancy")
                                for r in results], runs=5)
    dup_ms = wall_ms(lambda: [jtt.to_rgb8_device(r, device=dev) for r in results], runs=5)
    log(f"fancy: {N_IMAGES} images, fancy {fancy_ms / N_IMAGES:.6f} ms per image, duplicate "
        f"{dup_ms / N_IMAGES:.6f} ms per image (host clock to a synchronised result, "
        "median of 5)")

    def u16(r, device):
        return jtt.transform_mcu2(r.packed_mcu2, quant_tables(r), r.geometry, device,
                                  output="u16")

    gold = [u16(r, "cpu").numpy() for r in results]
    reset_counts()
    outs = [u16(r, dev) for r in results]
    torch.cuda.synchronize()
    launches = kernels.dequantize_idct_shift.launches
    log(f"u16: transform_mcu2(output='u16') of {N_IMAGES} images: K1 launches {launches}; "
        f"dtype {outs[0].dtype} on torch {torch.__version__}")
    check(launches == 3 * N_IMAGES, f"K1 launches {launches}")
    for i, (out, g) in enumerate(zip(outs, gold)):
        check(out.dtype == torch.uint16 and tuple(out.shape) == (SIZE, SIZE, 3), out.shape)
        check_u16_close(out.cpu().numpy(), g, 8, f"u16: image {i} vs CPU path")


def phase_stripes(sl, dev):
    """The stripe walk of one image at 16 MCU rows against the card's full
    decode: 8 stripes, 3 K1 launches each, bit-equal when concatenated;
    the peak device memory of each."""
    import jpeglibrary_tpu_torch as jtt
    from jpeglibrary_tpu_torch.ops import kernels
    from jpeglibrary_tpu_torch.parallel.batch import scan

    data = sl["datas"][0]
    res = scan(data)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    full = jtt.to_rgb8_device(res, device=dev)
    torch.cuda.synchronize()
    full_peak = torch.cuda.max_memory_allocated() - base
    full = full.cpu()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    stripes = []
    for y0, stripe in jtt.decode_rgb_stripes(data, device=dev, stripe_mcu_rows=16):
        check(y0 == sum(s.shape[1] for s in stripes), ("stripe y0", y0))
        check(stripe.device.type == dev.type and stripe.dtype == torch.uint8, stripe.device)
        stripes.append(stripe.cpu())  # the consumer takes each stripe off the card
    torch.cuda.synchronize()
    stripe_peak = torch.cuda.max_memory_allocated() - base
    launches = kernels.dequantize_idct_shift.launches
    log(f"stripes: decode_rgb_stripes(stripe_mcu_rows=16) of a {SIZE}x{SIZE} 4:2:0 image: "
        f"{len(stripes)} stripes of {stripes[0].shape[1]} rows, K1 launches {launches}")
    check(len(stripes) == SIZE // 256 and launches == 3 * len(stripes), (len(stripes), launches))
    check(torch.equal(torch.cat(stripes, dim=1), full), "the stripes differ from the full decode")
    log(f"stripes: concatenated stripes equal the card's full to_rgb8_device; peak device "
        f"memory above the start (torch.cuda.max_memory_allocated): stripe walk "
        f"{stripe_peak} B, full decode {full_peak} B ({stripe_peak / full_peak:.3f} of it)")
    walk_s = warm_median_s(lambda: [s for _, s in jtt.decode_rgb_stripes(
        data, device=dev, stripe_mcu_rows=16)])
    full_s = warm_median_s(lambda: jtt.to_rgb8_device(scan(data), device=dev))
    log(f"stripes: stripe walk median {walk_s * 1e3:.6f} ms, full decode (scan + transform) "
        f"median {full_s * 1e3:.6f} ms, host clock, {STREAM_RUNS} warm runs")
    return launches


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


def phase_slice(record, dev):
    """The stream decode, image by image; returns the slice's sources,
    JPEGs, CPU goldens and card outputs for the later phases."""
    import jpeglibrary_tpu_torch as jtt
    from jpeglibrary_tpu_torch.ops import kernels
    from jpeglibrary_tpu_torch.parallel.batch import scan

    t0 = time.perf_counter()
    sources = [synth_image(seed, SIZE) for seed in range(N_IMAGES)]
    datas = [encode_420(rgb, 75) for rgb in sources]
    t1 = time.perf_counter()
    # The golden is the port's CPU path (plain PyTorch versions of the
    # kernels), which the CPU tests hold to the JAX package's host decode.
    goldens = [jtt.to_rgb8_device(scan(d), device="cpu").numpy() for d in datas]
    t2 = time.perf_counter()
    log(f"slice: {N_IMAGES} images {SIZE}x{SIZE} q75 4:2:0, "
        f"{sum(map(len, datas))} JPEG bytes; encode {t1 - t0:.3f} s, "
        f"CPU golden decode {t2 - t1:.3f} s")
    mp = N_IMAGES * SIZE * SIZE / 1e6

    def run():
        return timed(lambda: stream(datas, dev))

    reset_counts()
    outs, secs = run()
    launches = kernels.dequantize_idct_shift.launches
    log(f"slice: stream run 1 {secs:.6f} s, {mp / secs:.3f} MP/s end to end; "
        f"K1 launches {launches}, K2 launches {kernels.fdct_quantize.launches}")
    check(launches == 3 * N_IMAGES, f"K1 launches {launches}")
    check(kernels.fdct_quantize.launches == 0, "the decode launched K2")
    record["launches"] = launches

    for i, (out, gold) in enumerate(zip(outs, goldens)):
        check(out.device.type == dev.type and out.dtype == torch.uint8, (out.device, out.dtype))
        check(tuple(out.shape) == (3, SIZE, SIZE), tuple(out.shape))
        got = out.cpu().numpy()
        d = np.abs(got.astype(np.int16) - gold.astype(np.int16))
        n_diff = int((d > 0).sum())
        fidelity = psnr(got, np.moveaxis(sources[i], -1, 0))
        log(f"slice: image {i}: max |diff| vs CPU golden {int(d.max())}, "
            f"{n_diff}/{d.size} values differ; PSNR vs the source {fidelity:.2f} dB")
        check(d.max() <= 2 and n_diff <= d.size * 1e-4, (i, int(d.max()), n_diff))
        check(fidelity >= MIN_PSNR_DB, (i, fidelity))

    warm = []
    for _ in range(STREAM_RUNS):
        outs2, secs2 = run()
        check(all(torch.equal(a, b) for a, b in zip(outs, outs2)), "a later run differs")
        warm.append(secs2)
    med = statistics.median(warm)
    log(f"slice: stream runs 2-{STREAM_RUNS + 1}: median {med:.6f} s, {mp / med:.3f} MP/s "
        f"end to end (runs: {', '.join(f'{s:.6f}' for s in warm)} s); "
        "each bit-identical to run 1")

    res = scan(datas[0])
    payload, quants = jtt.device_inputs(res, dev)
    t_ms = wall_ms(lambda: jtt.transform_mcu2(payload, quants, res.geometry, dev))
    log(f"slice: transform alone (payload on the device) {t_ms:.6f} ms host clock "
        f"to synchronised result (median of {TIMED_RUNS}), "
        f"{SIZE * SIZE / 1e6 / (t_ms * 1e-3):.3f} MP/s")

    scan_s = []
    for d in datas:
        start = time.perf_counter()
        scan(d)
        scan_s.append(time.perf_counter() - start)
    med = statistics.median(scan_s)
    log(f"slice: host scan alone {med * 1e3:.6f} ms per image (median of {N_IMAGES}), "
        f"{SIZE * SIZE / 1e6 / med:.3f} MP/s, one image at a time")
    return {"sources": sources, "datas": datas, "goldens": goldens, "outs": outs}


def phase_batch(records, sl, dev):
    """``decode_batch_rgb`` and the grouped stream over the slice's images:
    one group of 8, K1 launched 3 times for it, every image equal to the
    card's single-image output; then the throughputs."""
    import jpeglibrary_tpu_torch as jtt
    from jpeglibrary_tpu_torch.ops import kernels
    from jpeglibrary_tpu_torch.parallel.batch import group_wire, scan

    datas, goldens, singles = sl["datas"], sl["goldens"], sl["outs"]
    mp = N_IMAGES * SIZE * SIZE / 1e6

    reset_counts()
    outs = jtt.decode_batch_rgb(datas, device=dev)
    launches = kernels.dequantize_idct_shift.launches
    log(f"batch: decode_batch_rgb over {N_IMAGES} images: K1 launches {launches}")
    check(launches == 3, f"decode_batch_rgb launched K1 {launches} times")
    records["k1_tables"]["launches"] = launches
    for i, out in enumerate(outs):
        check(isinstance(out, np.ndarray) and out.dtype == np.uint8
              and out.shape == (SIZE, SIZE, 3), (i, type(out), getattr(out, "shape", None)))
        got = np.moveaxis(out, -1, 0)
        check_close(got, goldens[i], f"batch: image {i} vs CPU golden")
        check(np.array_equal(got, singles[i].cpu().numpy()),
              (i, "decode_batch_rgb differs from the card's single-image output"))
    batch_s = warm_median_s(lambda: jtt.decode_batch_rgb(datas, device=dev))
    log(f"batch: decode_batch_rgb median {batch_s:.6f} s of {STREAM_RUNS} warm runs, "
        f"{mp / batch_s:.3f} MP/s end to end (bytes in, HWC uint8 on the host out)")

    reset_counts()
    outs = stream(datas, dev, group=N_IMAGES)
    launches = kernels.dequantize_idct_shift.launches
    log(f"batch: decode_stream_rgb(group={N_IMAGES}): K1 launches {launches}")
    check(launches == 3, f"the grouped stream launched K1 {launches} times")
    for i, (out, single) in enumerate(zip(outs, singles)):
        check(out.device.type == dev.type and torch.equal(out, single),
              (i, "the grouped stream differs from the card's single-image output"))
    log(f"batch: all {N_IMAGES} grouped outputs equal the single-image outputs")

    rates = {}
    for g in GROUPS:
        med = warm_median_s(lambda: stream(datas, dev, group=g))
        rates[g] = mp / med
        log(f"batch: stream group={g}: median {med:.6f} s of {STREAM_RUNS} warm runs, "
            f"{rates[g]:.3f} MP/s end to end")
    log("batch: stream MP/s by group: "
        + ", ".join(f"{g}: {r:.3f}" for g, r in rates.items()))

    results = [scan(d) for d in datas]
    geometry = results[0].geometry
    transform, stacked, quants = group_wire(results, geometry)
    stacked = torch.from_numpy(stacked).to(dev)
    quants = torch.from_numpy(quants).to(dev)
    group_ms = wall_ms(lambda: transform(stacked, quants, geometry, dev))
    one_ms = wall_ms(lambda: transform(stacked[0], quants[0], geometry, dev))
    log(f"batch: transform alone (payloads on the device), group of {N_IMAGES}: "
        f"{group_ms:.6f} ms, {group_ms / N_IMAGES:.6f} ms per image; one image "
        f"{one_ms:.6f} ms (host clock to a synchronised result, median of {TIMED_RUNS})")


OVERLAP_GROUPS = (1, 8)
OVERLAP_WORKERS = (1, 2)
OVERLAP_TRACES = 8  # traced runs of the stream built to overlap; a copy lands under the
# other worker's kernels in some (on an H100 one run in three had none: the
# transform's ops reach the card sparsely while 8 scan threads hold the host)
MARK_CYCLES = 100_000  # the spin kernels that mark the caller's stream in a trace


def device_trace(fn):
    """The device events (kernels, copies, fills) of ``fn()`` under
    ``torch.profiler``, from its Chrome trace. A spin kernel on the calling
    thread's stream before and one after mark that stream: the path never
    spins, and CUPTI may drop either record (it dropped a session's first
    records on the H100 after the earlier phases' sessions)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(MARK_CYCLES)
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def overlap_stats(events):
    """What a traced stream run shows: the caller's stream (the marking
    spin kernels'), the other streams the path's kernels and copies ran
    on, how many ran on the caller's, the HtoD copies and those not from
    pinned memory, the copies' time and the part of it during which a
    kernel ran on another of the path's streams, and the time some kernel
    of the path ran within the path's span (microseconds, each instant
    counted once)."""
    def stream_of(e):
        return e.get("args", {}).get("stream", e.get("tid"))

    marks = [e for e in events if "spin_kernel" in e["name"]]
    caller = stream_of(marks[0]) if marks else None
    path = [e for e in events if "spin_kernel" not in e["name"]]
    kernels = [(stream_of(e), e["ts"], e["ts"] + e["dur"]) for e in path if e["cat"] == "kernel"]
    copies = [e for e in path if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]]
    overlap = sum(union_s([(k0, k1) for ks, k0, k1 in kernels if ks not in (stream_of(c), caller)],
                          c["ts"], c["ts"] + c["dur"]) for c in copies)
    start = min((e["ts"] for e in path), default=0.0)
    end = max((e["ts"] + e["dur"] for e in path), default=0.0)
    return {"marks": len(marks), "caller": caller,
            "streams": sorted({stream_of(e) for e in path} - {caller}),
            "on_caller": sum(stream_of(e) == caller for e in path),
            "htod": len(copies),
            "pageable": sorted({c["name"] for c in copies if "Pinned" not in c["name"]}),
            "copy_us": float(sum(c["dur"] for c in copies)), "overlap_us": overlap,
            "busy_us": union_s([(k0, k1) for _, k0, k1 in kernels], start, end),
            "span_us": end - start}


def phase_overlap(sl, dev):
    """The stream's device workers (``device_workers``), each on its own
    CUDA stream with a pinned staging buffer: outputs and launches at 1
    and 2 workers, group 1 and 8; MP/s in turns; then the profiler's view
    of a stream built to overlap. Returns the MP/s by (group, workers)."""
    from jpeglibrary_tpu_torch.models.decoder import quant_tables
    from jpeglibrary_tpu_torch.ops import kernels
    from jpeglibrary_tpu_torch.parallel.batch import group_wire, scan

    datas, singles = sl["datas"], sl["outs"]
    mp = len(datas) * SIZE * SIZE / 1e6
    results = [scan(d) for d in datas]
    per_image = [r.packed_mcu2.nbytes + quant_tables(r).nbytes for r in results]
    _, stacked, quants = group_wire(results, results[0].geometry)
    log(f"overlap: wire bytes per image (v2 payload and quant tables): "
        f"{', '.join(map(str, per_image))}; group of {len(datas)}: "
        f"{stacked.nbytes + quants.nbytes}")

    for g in OVERLAP_GROUPS:
        for w in OVERLAP_WORKERS:
            reset_counts()
            outs = stream(datas, dev, group=g, device_workers=w)
            launches = kernels.dequantize_idct_shift.launches
            want = 3 * -(-len(datas) // g)
            log(f"overlap: group={g} device_workers={w}: K1 launches {launches} (want {want})")
            check(launches == want, ("overlap K1 launches", g, w, launches))
            check(len(outs) == len(singles) and all(
                o.device.type == dev.type and torch.equal(o, s) for o, s in zip(outs, singles)),
                ("overlap: an output differs from the card's single-image output", g, w))
    log(f"overlap: every output at device_workers {OVERLAP_WORKERS}, group {OVERLAP_GROUPS} "
        "equals the card's single-image output")

    rates = {}
    for g in OVERLAP_GROUPS:
        secs = {w: [] for w in OVERLAP_WORKERS}
        for w in OVERLAP_WORKERS:
            stream(datas, dev, group=g, device_workers=w)
        for _ in range(STREAM_RUNS):
            for w in OVERLAP_WORKERS:
                secs[w].append(timed(lambda: stream(datas, dev, group=g, device_workers=w))[1])
        for w in OVERLAP_WORKERS:
            med = statistics.median(secs[w])
            rates[(g, w)] = mp / med
            log(f"overlap: stream group={g} device_workers={w}: median {med:.6f} s of "
                f"{STREAM_RUNS} warm runs in turns, {rates[(g, w)]:.3f} MP/s end to end "
                f"(runs: {', '.join(f'{x:.6f}' for x in secs[w])} s)")

    def overlapped():
        return stream(datas, dev, group=1, device_workers=2, scan_workers=len(datas))

    overlapped()
    traces = []
    for i in range(OVERLAP_TRACES):
        st = overlap_stats(device_trace(overlapped))
        share = st["overlap_us"] / st["copy_us"] if st["copy_us"] else 0.0
        log(f"overlap: traced run {i + 1} (scan_workers={len(datas)}, group=1, "
            f"device_workers=2): {st['htod']} HtoD copies, pageable {st['pageable']}; "
            f"path streams {st['streams']}, caller's stream {st['caller']} ({st['marks']} "
            f"marks) with {st['on_caller']} of the path's events; copies "
            f"{st['copy_us']:.3f} us, under the other worker's kernels {st['overlap_us']:.3f} us "
            f"({100 * share:.1f}%); kernels busy {st['busy_us']:.3f} us of the path's "
            f"{st['span_us']:.3f} us on the card")
        traces.append(st)
    check(sum(st["htod"] for st in traces) > 0, "overlap: the profiler recorded no HtoD copy")
    check(all(not st["pageable"] for st in traces),
          ("overlap: a copy of the path is pageable", [st["pageable"] for st in traces]))
    check(any(st["caller"] is not None and len(st["streams"]) >= 2 and st["on_caller"] == 0
              and st["overlap_us"] > 0 for st in traces),
          ("overlap: no traced run had two streams, none on the caller's, and a copy under "
           "the other worker's kernels",
           [(st["streams"], st["on_caller"], st["overlap_us"]) for st in traces]))
    return rates


def phase_wires(records, sl, dev):
    """The v1 wires on the card: arithmetic-coded streams, which the fused
    scan declines, through the v1 plane-order wire; and the slice's
    images under ``JPX_WIRE=1`` through the v1 MCU wire, grouped."""
    import jpeglibrary_tpu_torch as jtt
    from jpeglibrary_tpu_torch.ops import kernels
    from jpeglibrary_tpu_torch.parallel.batch import scan

    sources = sl["sources"][:N_ARITH]
    arith = [jtt.encode_rgb(rgb, 75, arithmetic=True, device=dev) for rgb in sources]
    cpu = []
    for i, data in enumerate(arith):
        res = scan(data)
        check(res.packed_mcu2 is None and res.packed_mcu is None,
              (i, "the arithmetic stream left the scan with a fused-scan payload"))
        cpu.append(jtt.to_rgb8_device(res, device="cpu").numpy())
    reset_counts()
    outs = stream(arith, dev)
    launches = kernels.dequantize_idct_shift.launches
    log(f"wires: {N_ARITH} arithmetic-coded images ({sum(map(len, arith))} bytes) on the "
        f"v1 plane-order wire: K1 launches {launches}")
    check(launches == 3 * N_ARITH, f"K1 launches {launches}")
    for i, (out, gold) in enumerate(zip(outs, cpu)):
        got = out.cpu().numpy()
        check_close(got, gold, f"wires: arithmetic image {i} vs CPU path")
        fidelity = psnr(got, np.moveaxis(sources[i], -1, 0))
        check(fidelity >= MIN_PSNR_DB, (i, fidelity))
    med = warm_median_s(lambda: stream(arith, dev))
    log(f"wires: arithmetic stream median {med:.6f} s of {STREAM_RUNS} warm runs, "
        f"{N_ARITH * SIZE * SIZE / 1e6 / med:.3f} MP/s end to end")

    saved = os.environ.get("JPX_WIRE")
    os.environ["JPX_WIRE"] = "1"  # the JAX package's own switch to the v1 MCU wire
    try:
        res = scan(sl["datas"][0])
        check(res.packed_mcu is not None and res.packed_mcu2 is None, "JPX_WIRE=1 gave no v1")
        reset_counts()
        outs = stream(sl["datas"], dev, group=N_IMAGES)
        launches = kernels.dequantize_idct_shift.launches
        log(f"wires: v1 MCU wire, group={N_IMAGES}: K1 launches {launches}")
        check(launches == 3, f"K1 launches {launches}")
        for i, (out, gold, single) in enumerate(zip(outs, sl["goldens"], sl["outs"])):
            check_close(out.cpu().numpy(), gold, f"wires: v1 image {i} vs CPU golden")
            check(torch.equal(out, single), (i, "the v1 wire differs from the v2 wire"))
        med = warm_median_s(lambda: stream(sl["datas"], dev, group=N_IMAGES))
        log(f"wires: v1 MCU wire grouped stream median {med:.6f} s of {STREAM_RUNS} warm "
            f"runs, {N_IMAGES * SIZE * SIZE / 1e6 / med:.3f} MP/s end to end")
    finally:
        if saved is None:
            del os.environ["JPX_WIRE"]
        else:
            os.environ["JPX_WIRE"] = saved


def phase_thumbnails(records, sl, dev):
    """The scaled decode at 1/8 (stream), 1/4 (grouped stream) and 1/2
    (batch), each against the port's CPU path at that scale."""
    import jpeglibrary_tpu_torch as jtt
    from jpeglibrary_tpu_torch.ops import kernels
    from jpeglibrary_tpu_torch.parallel.batch import scan

    datas = sl["datas"]
    mp = N_IMAGES * SIZE * SIZE / 1e6
    results = [scan(d) for d in datas]
    runs = (
        ("k1_n1", 0.125, 3 * N_IMAGES, "decode_stream_rgb(scale=1/8)",
         lambda: stream(datas, dev, scale=0.125)),
        ("k1_n2", 0.25, 3, f"decode_stream_rgb(scale=1/4, group={N_IMAGES})",
         lambda: stream(datas, dev, scale=0.25, group=N_IMAGES)),
        ("k1_n4", 0.5, 3, "decode_batch_rgb(scale=1/2)",
         lambda: jtt.decode_batch_rgb(datas, device=dev, scale=0.5)),
    )
    for key, scale, want_launches, label, run in runs:
        side = -(-SIZE * int(8 * scale) // 8)
        gold = [jtt.to_rgb8_device(r, device="cpu", scale=scale).numpy() for r in results]
        reset_counts()
        outs = run()
        launches = kernels.dequantize_idct_shift.launches
        log(f"thumbnails: {label}: K1 launches {launches}")
        check(launches == want_launches, f"{label}: K1 launches {launches}")
        records[key]["launches"] = launches
        for i, out in enumerate(outs):
            got = out.cpu().numpy() if torch.is_tensor(out) else np.moveaxis(out, -1, 0)
            check(got.shape == (3, side, side), (label, i, got.shape))
            check_close(got, gold[i], f"thumbnails: {label} image {i} vs CPU path",
                        share=SCALED_SHARE)
        med = warm_median_s(run)
        log(f"thumbnails: {label} median {med:.6f} s of {STREAM_RUNS} warm runs, "
            f"{mp / med:.3f} source MP/s end to end, output {side}x{side}")


def phase_encode(record, sources, dev):
    """The device encode of ``sources`` on the card, held against the
    port's CPU path (which the CPU tests hold to the JAX package's device
    encode) and against the sources after a decode on the card."""
    import jpeglibrary_tpu_torch as jtt
    from jpeglibrary_tpu_torch.models import encoder as port_encoder
    from jpeglibrary_tpu_torch.ops import encode_stage, kernels

    jobs = [(rgb, {}) for rgb in sources] + [(sources[0], {"optimize_coding": True})]

    def run():
        datas, secs = [], []
        for rgb, kwargs in jobs:
            start = time.perf_counter()
            datas.append(jtt.encode_rgb(rgb, 75, device=dev, **kwargs))
            secs.append(time.perf_counter() - start)
        return datas, secs

    reset_counts()
    datas, secs1 = run()
    launches = kernels.fdct_quantize.launches
    log(f"encode: run 1, {len(jobs)} images ({N_IMAGES} q75 4:2:0, one more with "
        f"optimize_coding): {sum(secs1):.6f} s, {sum(map(len, datas))} JPEG bytes; "
        f"K2 launches {launches}, K1 launches {kernels.dequantize_idct_shift.launches}")
    check(launches == 3 * len(jobs), f"K2 launches {launches}")
    check(kernels.dequantize_idct_shift.launches == 0, "the encode launched K1")
    record["launches"] = launches

    datas2, secs2 = run()
    check(datas2 == datas, "a second encode run gave other bytes")
    med = statistics.median(secs2[:N_IMAGES])
    log(f"encode: run 2 bit-identical to run 1; encode_rgb end to end {med * 1e3:.6f} ms "
        f"per image (median of {N_IMAGES}), {SIZE * SIZE / 1e6 / med:.3f} MP/s, "
        "one image at a time")

    colour_s, emit_s = [], []
    for i, ((rgb, kwargs), data) in enumerate(zip(jobs, datas)):
        enc = port_encoder.rgb_encoder(rgb, 75, **kwargs)
        start = time.perf_counter()
        port_encoder.sample_planes(enc)
        colour_s.append(time.perf_counter() - start)
        card = port_encoder.coefficient_planes(enc, device=dev)
        cpu = port_encoder.coefficient_planes(enc, device="cpu")
        n_diff = n_all = max_abs = 0
        for g, w in zip(card, cpu):
            d = np.abs(g.astype(np.int32) - w)
            n_diff += int((d > 0).sum())
            n_all += d.size
            max_abs = max(max_abs, int(d.max()))
        start = time.perf_counter()
        card_bytes = port_encoder.emit(enc, card)
        emit_s.append(time.perf_counter() - start)
        check(card_bytes == data, (i, "the planes emit other bytes than encode_rgb"))
        same = n_diff == 0 and port_encoder.emit(enc, cpu) == data
        log(f"encode: image {i} {kwargs or ''}: coefficients vs CPU path max |diff| "
            f"{max_abs}, {n_diff}/{n_all} differ; bytes "
            f"{'equal to' if same else 'differ from'} the CPU path's")
        check(max_abs <= 1 and n_diff <= n_all * 1e-3, (i, max_abs, n_diff))
        check(n_diff > 0 or same, (i, "equal planes, other bytes"))

    outs = list(jtt.decode_stream_rgb(datas, device=dev))
    for i, (out, (rgb, kwargs)) in enumerate(zip(outs, jobs)):
        check(out.device.type == dev.type and tuple(out.shape) == (3, SIZE, SIZE),
              (out.device, tuple(out.shape)))
        fidelity = psnr(out.cpu().numpy(), np.moveaxis(rgb, -1, 0))
        log(f"encode: image {i} decoded on the card: PSNR vs the source {fidelity:.2f} dB")
        check(fidelity >= MIN_PSNR_DB, (i, fidelity))

    # Where one image's time goes; the planes of the first image.
    enc = port_encoder.rgb_encoder(sources[0], 75)
    planes = port_encoder.sample_planes(enc)
    host_planes = [torch.from_numpy(p) for p in planes]
    up_ms = wall_ms(lambda: torch.cat([p.reshape(-1) for p in host_planes]).to(dev))
    dev_planes = [p.to(dev) for p in host_planes]
    quants = port_encoder.device_quants(enc, dev)
    mpl = mpc = SIZE // 16
    comp_params = ((2, 2, 1, 1), (1, 1, 2, 2), (1, 1, 2, 2))
    fwd_ms = wall_ms(lambda: encode_stage.forward(dev_planes, quants, comp_params,
                                                  mpl, mpc, 128, dev))
    def stage():
        return [encode_stage.forward_component(p, q, *cp, mpl, mpc, 128)
                for p, q, cp in zip(dev_planes, quants, comp_params)]

    # The stage is K2 alone: the pad and the box run inside its load. The
    # runtime API's launches count every kernel of the window; CUPTI's kernel
    # records can miss the first few after the profiler starts, or all of a
    # window's, so they only name the kernels, and a window without one is
    # run again.
    stage()
    torch.cuda.synchronize()
    for window in range(1, 11):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(STAGE_RUNS):
                stage()
            torch.cuda.synchronize()
        events = prof.key_averages()
        api_launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
        kernels_seen = {e.key: e.count for e in events
                        if e.device_type == torch.autograd.DeviceType.CUDA}
        if kernels_seen:
            break
    log(f"encode: the device stage over {STAGE_RUNS} runs: {api_launches} kernel launches; "
        f"kernels recorded: {kernels_seen} (profiler window {window})")
    check(api_launches == 3 * STAGE_RUNS and kernels_seen
          and all("fdct_quant" in k for k in kernels_seen),
          ("the device stage ran other kernels than 3 x K2", api_launches, kernels_seen))
    (stage_ms,) = device_ms(stage)
    (stage_kernel_ms,) = kernel_ms(stage)
    outs = stage()
    down_ms = wall_ms(lambda: torch.cat([o.reshape(-1) for o in outs]).cpu())
    log(f"encode: one image's parts: host colour {statistics.median(colour_s) * 1e3:.6f} ms "
        f"(median of {len(jobs)}); upload {up_ms:.6f} ms (host clock); device stage "
        f"(3 x K2 with the pad and box fused) {stage_ms:.6f} ms (CUDA events), "
        f"{stage_kernel_ms:.6f} ms (kernel time, warm); download "
        f"{down_ms:.6f} ms (host clock); forward with the planes on the card "
        f"{fwd_ms:.6f} ms (host clock to the int16 planes on the host, median of "
        f"{TIMED_RUNS}); host emission {statistics.median(emit_s) * 1e3:.6f} ms "
        f"(median of {len(jobs)})")


def segment_symbols(coeffs, n_blocks):
    """The Huffman symbols each row of the device scan's output took to
    decode (int64 [segments]), of its first ``n_blocks`` blocks: per block
    one DC symbol, one per non-zero AC coefficient, a ZRL per 16 zeros
    ahead of one, and an EOB unless its last coefficient is non-zero."""
    blocks = coeffs.reshape(coeffs.shape[0], -1, 64)
    nz = blocks[..., 1:] != 0
    col = torch.arange(63, device=coeffs.device)
    last = torch.cummax(torch.where(nz, col, -1), dim=-1).values
    prev = torch.cat([torch.full_like(last[..., :1], -1), last[..., :-1]], dim=-1)
    zrl = ((col - prev - 1) // 16 * nz).sum(-1)
    per_block = 1 + nz.sum(-1) + zrl + (last[..., -1] < 62)
    valid = torch.arange(blocks.shape[1], device=coeffs.device)[None] < n_blocks[:, None]
    return (per_block * valid).sum(-1)


def k3_bound(buf_bytes, out_bytes, n_tables, symbols):
    """K3's bound: the segment matrix and the tables in, the int32 output
    written once (the wrapper's zero fill is its choice, not the
    function's work); K3_OPS_PER_SYMBOL integer operations per symbol
    decoded (at the CUDA cores' fp32 rate, which their int32 rate does not
    exceed)."""
    n_bytes = buf_bytes + n_tables * (256 + 18 + 19 + 256) * 4 + out_bytes
    return bound(n_bytes, 0, symbols * K3_OPS_PER_SYMBOL)


def k3_args(buf, const, dev):
    """K3's wrapper arguments for :func:`prepare_scan`'s output, on ``dev``:
    (tensors, max_blocks)."""
    arrays = (buf, const["comp_of"], const["mcu_counts"], *const["tables"])
    return ([torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays],
            int(const["mcu_counts"].max()) * const["bpm"])


def k3_sub_bits_ms(args, max_blocks, want, flush, runs):
    """K3 at each subsequence length of K3_SUB_BITS on one image's segments:
    {L: (flushed ms, sync rounds)}, each output equal to ``want``."""
    from jpeglibrary_tpu_torch.ops import kernels

    out = {}
    for sub_bits in K3_SUB_BITS:
        def call():
            return kernels.huffman_scan(*args, max_blocks=max_blocks, sub_bits=sub_bits)

        check(torch.equal(call(), want), (sub_bits, "K3 differs at this subsequence length"))
        rounds = kernels.huffman_scan.rounds
        (ms,) = device_ms(call, runs=runs, warmup=1, flush=flush)
        out[sub_bits] = (ms, rounds)
    return out


def k3_small_checks(rgb, dev, flush):
    """K3 at ri 0 on a small stream, where the plain version runs: the
    stream through ``decode_baseline_device``, equal to the host scan, to
    the plain version and to the CPU model of the algorithm
    (``decode_segments_split_plain``, run here on the card) with the same
    sync rounds; then the same on a copy with bytes changed. Returns K3's
    record for the stream."""
    import jpeglibrary_tpu_torch as jtt
    from jpeglibrary_tpu_torch.ops import device_scan, kernels

    data = encode_420(rgb, 75)
    buf, const, geo = device_scan.scan_inputs(data)
    reset_counts()
    coeffs, _ = device_scan.decode_baseline_device(data, device=dev)
    torch.cuda.synchronize()
    launches, rounds = kernels.huffman_scan.launches, kernels.huffman_scan.rounds
    check(launches == 1, ("small ri 0: K3 launches", launches))
    res = jtt.decode(data, sparse_direct=True)
    want = device_scan.segment_rows([res.coefficients[c.component_index]
                                     for c in geo.components], geo, 0)
    check(torch.equal(coeffs.cpu(), torch.from_numpy(want)), "small ri 0: K3 differs from the "
                                                              "host scan")
    args, max_blocks = k3_args(buf, const, dev)
    sub_bits = kernels.HUFFMAN_SUB_BITS
    plain, secs = timed(lambda: device_scan.decode_segments_plain(*args, max_blocks))
    max_abs = int((plain - coeffs).abs().max())
    check(max_abs == 0, ("small ri 0: K3 differs from its plain version", max_abs))
    model, model_rounds = device_scan.decode_segments_split_plain(*args, max_blocks, sub_bits)
    check(torch.equal(model, coeffs) and model_rounds == rounds,
          ("small ri 0: K3 differs from its CPU model", model_rounds, rounds))
    n_sub = device_scan.subsequence_count(buf.shape[1], sub_bits)
    (cold,) = device_ms(lambda: kernels.huffman_scan(*args, max_blocks=max_blocks),
                        warmup=1, flush=flush)
    symbols = int(segment_symbols(coeffs, torch.from_numpy(const["mcu_counts"]).to(dev)
                                  * const["bpm"]).sum())
    b_ms, b_by = k3_bound(buf.nbytes, coeffs.numel() * 4, 2 * const["n_comps"], symbols)
    log(f"device scan: ri 0, {rgb.shape[1]}x{rgb.shape[0]}: {buf.shape[1] - 8} bytes, "
        f"{symbols} symbols, L {sub_bits} bits, {n_sub} subsequences, {rounds} sync rounds; "
        f"K3 equals the host scan, its plain version ({secs * 1e3:.3f} ms, host clock, one "
        f"run) and its CPU model ({model_rounds} rounds); K3 {cold:.6f} ms L2 flushed "
        f"(CUDA events, median of {TIMED_RUNS}), {b_ms / cold:.4%} of its {b_by} bound "
        f"{b_ms:.6f} ms")

    rng = np.random.default_rng(11)
    bad = buf.copy()
    flips = rng.choice(bad.size - 8, SMALL_CORRUPT_BYTES, replace=False)
    bad.reshape(-1)[flips] ^= rng.integers(1, 256, SMALL_CORRUPT_BYTES).astype(np.uint8)
    args, max_blocks = k3_args(bad, const, dev)
    got = kernels.huffman_scan(*args, max_blocks=max_blocks)
    bad_rounds = kernels.huffman_scan.rounds
    check(torch.equal(got, device_scan.decode_segments_plain(*args, max_blocks)),
          "small ri 0: K3 differs from its plain version on a corrupt stream")
    model, model_rounds = device_scan.decode_segments_split_plain(*args, max_blocks, sub_bits)
    check(torch.equal(model, got) and model_rounds == bad_rounds,
          ("small ri 0, corrupt: K3 differs from its CPU model", model_rounds, bad_rounds))
    log(f"device scan: ri 0, {rgb.shape[1]}x{rgb.shape[0]}, {SMALL_CORRUPT_BYTES} bytes "
        f"changed: {bad_rounds} sync rounds, K3 equal to its plain version and its CPU model; "
        f"{int((got != coeffs).sum())} coefficients decode otherwise")
    return {"name": f"huffman_scan[ri=0,{rgb.shape[1]}x{rgb.shape[0]}]", "route": "cuda",
            "source": K3_SOURCE, "replaces": K3_REPLACES, "launches": launches,
            "max_abs_err": max_abs, "ms": cold, "plain_ms": secs * 1e3, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


def phase_device_scan(sources, datas, dev):
    """K3, the device entropy decode: ``decode_baseline_device`` of the
    sources encoded on the card at RESTART_INTERVALS, and of one of
    ``datas`` (no restart markers: one segment), each image's segments
    equal to the host scan's coefficients, and, through the dense transform
    (K1), RGB equal to the host-scan path's; K3 equal to its plain version
    at PLAIN_RIS and at ri 0 on a small stream, clean and corrupt; then the
    times by restart interval, at the subsequence lengths of K3_SUB_BITS
    too, with the sync rounds. Returns one record per interval and one for
    the small stream; where the plain version is not run (it would take
    minutes to hours), the record's ``plain_ms`` and ``max_abs_err`` are
    None and K3 is held to the host scan alone."""
    import jpeglibrary_tpu_torch as jtt
    from jpeglibrary_tpu_torch.models.decoder import quant_tables
    from jpeglibrary_tpu_torch.ops import device_scan, kernels

    start = time.perf_counter()
    streams = {ri: [jtt.encode_rgb(rgb, 75, device=dev, restart_interval=ri) for rgb in sources]
               for ri in RESTART_INTERVALS}
    streams[0] = datas[:1]
    log(f"device scan: {len(RESTART_INTERVALS) * len(sources)} encodes on the card at restart "
        f"intervals {RESTART_INTERVALS} in {time.perf_counter() - start:.3f} s")
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    records = {}
    for ri, batch in streams.items():
        prep_s, host_s, inputs, results = [], [], [], []
        for data in batch:
            t0 = time.perf_counter()
            inputs.append(device_scan.scan_inputs(data))
            t1 = time.perf_counter()
            results.append(jtt.decode(data, sparse_direct=True))
            prep_s.append(t1 - t0)
            host_s.append(time.perf_counter() - t1)
        reset_counts()
        outs, rounds = [], []
        for data in batch:
            outs.append(device_scan.decode_baseline_device(data, device=dev))
            rounds.append(kernels.huffman_scan.rounds)
        torch.cuda.synchronize()
        launches = kernels.huffman_scan.launches
        n_sub = device_scan.subsequence_count(inputs[0][0].shape[1], kernels.HUFFMAN_SUB_BITS)
        log(f"device scan: ri {ri}: decode_baseline_device of {len(batch)} images: K3 launches "
            f"{launches}; L {kernels.HUFFMAN_SUB_BITS} bits, {n_sub} subsequences a row "
            f"(image 0), sync rounds by image {rounds}")
        check(launches == len(batch), (ri, "K3 launches", launches))

        for i, ((coeffs, geo), (_, const, _), res) in enumerate(zip(outs, inputs, results)):
            check(coeffs.device.type == dev.type and coeffs.dtype == torch.int32, coeffs.dtype)
            want = torch.from_numpy(device_scan.segment_rows(
                [res.coefficients[c.component_index] for c in geo.components], geo, ri))
            got = coeffs.cpu()
            check(got.shape == want.shape, (ri, i, tuple(got.shape), tuple(want.shape)))
            check(torch.equal(got, want), (ri, i, "K3 differs from the host scan",
                                           int((got != want).sum())))
            rgb = jtt.transform_dense(device_scan.segment_planes(coeffs, const, geo),
                                      quant_tables(res), geo, dev)
            check(torch.equal(rgb, jtt.to_rgb8_device(res, device=dev)),
                  (ri, i, "K3's planes through K1 differ from the host-scan path"))
        log(f"device scan: ri {ri}: every image's segments equal the host scan's coefficients, "
            "and through the dense transform (K1) its RGB equals to_rgb8_device of the host "
            "scan, bit for bit")

        buf, const, _ = inputs[0]
        args, max_blocks = k3_args(buf, const, dev)
        coeffs = outs[0][0]

        def kernel():
            return kernels.huffman_scan(*args, max_blocks=max_blocks)

        plain_ms = max_abs = None
        if ri in PLAIN_RIS:
            plain, secs = timed(lambda: device_scan.decode_segments_plain(*args, max_blocks))
            max_abs = int((plain - coeffs).abs().max())
            plain_ms = secs * 1e3
            check(max_abs == 0, (ri, "K3 differs from its plain version", max_abs))
            log(f"device scan: ri {ri}: K3 equals its plain version on the card, image 0 "
                f"(plain {plain_ms:.3f} ms, host clock, one run)")
        # CUDA events around the wrapper: its zero fills, the offsets' cumsum,
        # the host's reads of the sync flag and the launch gaps are in the
        # time, as they are in the path. The profiler's records missed calls
        # of K3's first design here, so K3 is timed by events alone.
        (warm,) = device_ms(kernel, warmup=1)
        (cold,) = device_ms(kernel, warmup=1, flush=flush)
        by_sub_bits = k3_sub_bits_ms(args, max_blocks, coeffs, flush, TIMED_RUNS)
        up_ms = wall_ms(lambda: torch.from_numpy(buf).to(dev))
        e2e_ms = wall_ms(lambda: device_scan.decode_baseline_device(batch[0], device=dev),
                         runs=5, warmup=1)
        counts = torch.from_numpy(const["mcu_counts"]).to(dev)
        symbols = segment_symbols(coeffs, counts * const["bpm"])
        longest, total = int(symbols.max()), int(symbols.sum())
        n_tables = 2 * const["n_comps"]
        b_ms, b_by = k3_bound(buf.nbytes, coeffs.numel() * 4, n_tables, total)
        log(f"device scan: ri {ri}: {buf.shape[0]} segments, the longest {buf.shape[1] - 8} "
            f"bytes; {total} symbols, at most {longest} in one segment; K3 with its zero fill "
            f"{cold:.6f} ms L2 flushed, {warm:.6f} ms warm (CUDA events, median of "
            f"{TIMED_RUNS}; {warm * 1e6 / longest:.3f} ns per symbol of the longest segment, "
            f"{warm * 1e6 / total:.3f} ns per symbol; {b_ms / cold:.2%} of its {b_by} bound "
            f"{b_ms:.6f} ms); host prepass (container walk + prepare_scan) "
            f"{statistics.median(prep_s) * 1e3:.6f} ms, upload {up_ms:.6f} ms, "
            f"decode_baseline_device end to end {e2e_ms:.6f} ms (host clock, synchronised); "
            f"the port's host scan JpegDecoder.decode(sparse_direct=True) "
            f"{statistics.median(host_s) * 1e3:.6f} ms (median of {len(batch)} images)")
        log(f"device scan: ri {ri}: K3 by subsequence length, L2 flushed (CUDA events, median "
            f"of {TIMED_RUNS}), image 0: " + "; ".join(
                f"L {sb}: {ms:.6f} ms, {r} sync rounds" for sb, (ms, r) in by_sub_bits.items()))
        records[ri] = {
            "name": f"huffman_scan[ri={ri}]", "route": "cuda", "source": K3_SOURCE,
            "replaces": K3_REPLACES, "launches": launches, "max_abs_err": max_abs,
            "ms": cold, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}
        if ri == PLAIN_RIS[-1]:
            corrupt = (buf, const, coeffs)

    records["small"] = k3_small_checks(sources[0][:SMALL_SIZE, :SMALL_SIZE], dev, flush)
    del flush

    # A corrupt stream: bytes changed in the segments send the walk down codes
    # the tables do not hold and past the rows' ends; K3 must still give its
    # plain version's numbers (the JAX loop's), reading and writing nothing
    # out of bounds.
    buf, const, clean = corrupt
    rng = np.random.default_rng(7)
    flips = rng.choice(buf.size, CORRUPT_BYTES, replace=False)
    bad = buf.copy()
    bad.reshape(-1)[flips] ^= rng.integers(1, 256, CORRUPT_BYTES).astype(np.uint8)
    args, max_blocks = k3_args(bad, const, dev)
    got = kernels.huffman_scan(*args, max_blocks=max_blocks)
    want = device_scan.decode_segments_plain(*args, max_blocks)
    changed = int((got != clean).any(dim=1).sum())
    check(torch.equal(got, want), "K3 differs from its plain version on a corrupt stream")
    log(f"device scan: ri {PLAIN_RIS[-1]}, {CORRUPT_BYTES} bytes of image 0's segments changed: "
        f"{changed} of {buf.shape[0]} segments decode otherwise, K3 equal to its plain version "
        f"({kernels.huffman_scan.rounds} sync rounds)")

    # The other layouts: one component, and 4:4:4 and 4:2:2 MCUs.
    layouts = (
        ("gray", jtt.encode_gray(sources[0][..., 1], 75, device=dev, restart_interval=4)),
        ("4:4:4", jtt.encode_rgb(sources[0], 75, device=dev, subsampling="444",
                                 restart_interval=4)),
        ("4:2:2", jtt.encode_rgb(sources[0], 75, device=dev, subsampling="422",
                                 restart_interval=4)),
    )
    for label, data in layouts:
        coeffs, geo = device_scan.decode_baseline_device(data, device=dev)
        res = jtt.decode(data, sparse_direct=True)
        want = device_scan.segment_rows(
            [res.coefficients[c.component_index] for c in geo.components], geo, 4)
        check(torch.equal(coeffs.cpu(), torch.from_numpy(want)), (label, "K3 differs from the "
                                                                   "host scan"))
    log(f"device scan: {', '.join(label for label, _ in layouts)} at ri 4: K3 equals the host "
        "scan's coefficients")
    return records


ZERO_RUNS = (15, 16, 31, 32, 47, 48, 62)  # runs at and about the ZRL steps, and the longest


def k5_edge_cases(seed=13):
    """The symbol statistics' edge batch, from ``seed`` with numpy: a list
    of (label, blocks [B, N, 64], n_valid [B] or None, prev_dc [B] or
    None). The card holds K5 to its plain version on it; the CPU tests
    hold the plain version and the CPU model to the JAX package's
    ``symbol_histograms_device`` and the host gather on the same batch."""
    rng = np.random.default_rng(seed)

    def sparse(lo, hi, shape, share, dtype=np.int16):
        x = rng.integers(lo, hi, size=shape).astype(dtype)
        x[..., 1:] *= (rng.random(shape[:-1] + (63,)) < share).astype(dtype)
        return x

    extremes = sparse(-32768, 32768, (2, 24, 64), 0.3)
    extremes[..., 0] = np.where(np.arange(24) % 2, 32767, -32768)  # DC steps of 65,535
    extremes[0, :, 5], extremes[1, :, 63] = -32768, 32767
    wide = np.zeros((2, 16, 64), np.int32)  # sizes past 16 bits alias into the run nibble
    values = np.array([1 << 15, 1 << 16, -(1 << 20), (1 << 31) - 1, -(1 << 31), 3], np.int64)
    picks = rng.integers(0, len(values), size=wide.shape)
    wide[...] = np.where(rng.random(wide.shape) < 0.4, values[picks], 0).astype(np.int32)
    runs = np.zeros((1, 2 * len(ZERO_RUNS), 64), np.int16)
    for i, r in enumerate(ZERO_RUNS):
        runs[0, 2 * i, 0] = rng.integers(-500, 500)
        runs[0, 2 * i, r + 1] = rng.integers(1, 40)  # r zeros from the start of the AC
        runs[0, 2 * i + 1, 1] = -7
        if r + 2 <= 63:
            runs[0, 2 * i + 1, r + 2] = rng.integers(-40, -1)  # r zeros after a non-zero
    tails = sparse(-60, 60, (3, 12, 64), 0.5)
    tails[0, ::2, 63] = rng.integers(1, 9, size=6)  # a non-zero last coefficient: no EOB
    tails[1] = 0  # a row of all-zero blocks
    tails[2, 3:7] = 0
    valid = sparse(-300, 300, (3, 40, 64), 0.2)
    chained = sparse(-1000, 1000, (4, 20, 64), 0.2)
    cases = [
        ("int16 extremes", extremes, None, None),
        ("int32 sizes above 16", wide, None, None),
        ("zero runs", runs, None, None),
        ("last coefficient and all-zero blocks", tails, None, None),
        ("N = 1", sparse(-300, 300, (5, 1, 64), 0.3), None, None),
        ("n_valid 0, partial, full", valid, np.array([0, 17, 40]), None),
        ("prev_dc", chained, None, np.array([-2047, 0, 5, 1023], np.int32)),
        ("prev_dc and n_valid", chained, np.array([20, 0, 1, 13]),
         np.array([7, -7, 300, -32768], np.int32)),
    ]
    # Dense blocks, where a warp's 32 lanes stand at the same positions: every
    # AC coefficient non-zero (rows of 200 blocks, two tiles), sizes 1 to 11.
    dense = rng.integers(1, 2048, size=(2, 200, 64)) * rng.choice([-1, 1], size=(2, 200, 64))
    dense = dense.astype(np.int16)
    lone = np.zeros((1, 2 * 63, 64), np.int16)  # one non-zero AC at each position 1..63
    lone[0, :, 0] = rng.integers(-900, 900, size=2 * 63)
    lone[0, np.arange(2 * 63), 1 + np.arange(2 * 63) % 63] = rng.integers(1, 300, size=2 * 63)
    ends = np.zeros((2, 40, 64), np.int16)  # non-zeros only at 1 and 63: a run of 61
    ends[..., 0] = rng.integers(-50, 50, size=(2, 40))
    ends[..., 1], ends[..., 63] = rng.integers(1, 99, size=(2, 40)), -rng.integers(1, 99, size=(2, 40))
    floor = np.full((2, 70, 64), -32768, np.int16)  # every coefficient int16's -32768
    floor[1, :, 0] = rng.integers(-32768, 32768, size=70)
    sizes = np.int64(1) << rng.integers(0, 17, size=(2, 150, 64))  # int32 sizes 1 to 17
    wide_dense = (sizes + rng.integers(0, 2, size=sizes.shape)) * rng.choice([-1, 1], sizes.shape)
    cut = rng.integers(-700, 700, size=(4, 160, 64)).astype(np.int16)
    cut[..., 1:] |= 1  # dense; n_valid ends inside a warp's 32 blocks
    return cases + [
        ("every AC coefficient non-zero", dense, None, None),
        ("a lone non-zero at each position 1..63", lone, None, None),
        ("non-zeros only at 1 and 63", ends, None, np.array([3, -3], np.int32)),
        ("every coefficient -32768", floor, None, None),
        ("int32 dense, sizes to 16 and past", wide_dense.astype(np.int32), None, None),
        ("dense, n_valid inside a warp", cut, np.array([45, 129, 1, 160]),
         np.array([-1, 2047, 0, 5], np.int32)),
    ]


def k5_plane_cases(seed=14):
    """K5's edge batch on component planes read in place, from ``seed``
    with numpy: a list of (label, planes (one [B, Hb, Wb, 64] array or a
    tuple of them), n_valid [R] or None, prev_dc [R] or None, mcu). Rows
    wider than one of the kernel's tiles (128 blocks) and MCU rows that
    end in a short tile; int32 values past 16 bits. The card holds K5 to
    its plain version and CPU model on it; the CPU tests hold both to the
    JAX package's ``_mcu_order_batch`` + ``symbol_histograms_device``."""
    rng = np.random.default_rng(seed)

    def sparse(shape, lo=-900, hi=900, share=0.25, dtype=np.int16):
        x = rng.integers(lo, hi, size=shape).astype(dtype)
        x[..., 1:] *= (rng.random(shape[:-1] + (63,)) < share).astype(dtype)
        return x

    wide = sparse((2, 4, 70, 64), dtype=np.int32)
    wide[0, 1, 3, 5], wide[1, 2, 7, 9], wide[1, 3, 69, 63] = -(1 << 31), 1 << 20, -(1 << 17)
    luma = sparse((2, 6, 74, 64))  # 37 MCUs a row at (2, 2): tiles of 32 and 5 MCUs
    cases = [
        ("plane at MCU (2, 2)", luma, None, None, (2, 2)),
        ("plane at MCU (2, 2), n_valid and prev_dc", luma, np.array([444, 101]),
         np.array([-2047, 300], np.int32), (2, 2)),
        ("int32 plane at MCU (2, 1), sizes above 16", wide, None, np.array([5, -5], np.int32),
         (2, 1)),
        ("plane at MCU (1, 2)", sparse((3, 4, 131, 64)), np.array([0, 524, 17]), None, (1, 2)),
        ("two planes at MCU (1, 1)", (sparse((3, 2, 150, 64)), sparse((3, 2, 150, 64), share=0.05)),
         np.array([300, 299, 0, 1, 150, 7]), np.array([1, -2, 3, -4, 5, -6], np.int32), (1, 1)),
        ("plane at MCU (4, 4)", sparse((1, 8, 36, 64)), None, np.array([9], np.int32), (4, 4)),
    ]
    dense_gray = sparse((3, 2, 150, 64), lo=-2047, hi=2048, share=1.0)  # the CT cell's walk
    dense_gray[..., 1:] |= 1
    dense_422 = sparse((2, 3, 74, 64), share=1.0)  # the 4:2:2 luma's walk: 37 MCUs a row
    dense_422[..., 1:] |= 1
    return cases + [
        ("dense plane at MCU (1, 1), n_valid inside a warp", dense_gray,
         np.array([300, 45, 161]), np.array([2047, -2048, 0], np.int32), (1, 1)),
        ("dense plane at MCU (2, 1)", dense_422, np.array([444, 77]), None, (2, 1)),
    ]


def k5_bound(n_blocks, itemsize, n_rows=0):
    """K5's bound: the blocks read once (and [n_rows] int32 n_valid and
    prev_dc where given), the [2, 256] int32 histograms written once; one
    non-zero test per coefficient."""
    return bound(n_blocks * 64 * itemsize + 2 * n_rows * 4 + 2 * 256 * 4, 0, n_blocks * 64)


def block_moves(fn):
    """Run ``fn`` and return the torch calls in it that copy [..., 64]
    coefficient blocks into MCU walk order, as (op, shapes): a cat or stack
    of such blocks, or a permute of a 6-D tensor (the walk's); seen by a
    ``TorchFunctionMode`` around the call."""
    from torch.overrides import TorchFunctionMode

    lists = (torch.cat, torch.concat, torch.stack)
    permutes = (torch.permute, torch.Tensor.permute)
    seen = []

    class Watch(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in lists and args:
                shapes = [tuple(x.shape) for x in args[0] if torch.is_tensor(x)]
                if any(len(s) > 1 and s[-1] == 64 for s in shapes):
                    seen.append((func.__name__, shapes))
            elif func in permutes and args and torch.is_tensor(args[0]) and args[0].dim() == 6:
                seen.append((func.__name__, [tuple(args[0].shape)]))
            return func(*args, **(kwargs or {}))

    with Watch():
        fn()
    return seen


def k5_parts(step_k5, flush):
    """``tools/k5_probe.py``'s breakdown of K5 on the step's own planes:
    the kernel's variants with parts cut out, the read yardstick and a
    torch copy, L2-flushed, in CUDA events (the variants built here, one
    nvcc a variant, all started together)."""
    import importlib.util
    import pathlib
    import tempfile

    path = pathlib.Path(__file__).resolve().parent / "tools" / "k5_probe.py"
    spec = importlib.util.spec_from_file_location("k5_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        libs = probe.build(probe.sources(), pathlib.Path(tmp))
        log(f"full step: K5's parts: {len(libs)} variants built in "
            f"{time.perf_counter() - t0:.3f} s")
        for label, x, mcu in step_k5:
            probe.time_parts(libs, f"full step: K5's parts on the {label}",
                             x if isinstance(x, tuple) else (x,), mcu, flush,
                             modes=("L2 flushed",))


def plain_step_kernels(dev):
    """K1's and K2's plain versions on ``dev``, in the forms ``_step`` calls
    them as ``k1`` and ``k2``."""
    from jpeglibrary_tpu_torch.ops import decode_stage, kernels

    idct = kernels.transform_matrix(dev)
    fdct = kernels.fdct_matrix(dev)

    def k1_plain(c, q, ls):
        return decode_stage.dequantize_idct_shift(
            c.reshape(-1, 64), q, c.numel() // 64, ls, idct).reshape(c.shape[:-1] + (8, 8))

    def k2_plain_call(plane, q, ls, *, hs=1, vs=1, blocks=None):
        return k2_plain(plane, q, ls, hs, vs, fdct)

    return k1_plain, k2_plain_call


def check_requants(label, requants, plain_requants):
    """The step's requantised Y, Cb and Cr against the plain step's: within
    1 on <= 1e-3 of the values."""
    for name, got_q, want_q in zip(("Y", "Cb", "Cr"), requants, plain_requants):
        check(got_q.shape == want_q.shape and got_q.dtype == torch.int16, (name, got_q.shape))
        d = (got_q.to(torch.int32) - want_q.to(torch.int32)).abs()
        n_diff = int((d > 0).sum())
        log(f"{label}: requantised {name} {tuple(got_q.shape)} vs plain: max |diff| "
            f"{int(d.max())}, {n_diff}/{d.numel()} differ")
        check(int(d.max()) <= 1 and n_diff <= d.numel() * 1e-3,
              ("requant", label, name, int(d.max()), n_diff))


def host_histograms(requants, mcu):
    """The step's four histograms gathered on the host from its requantised
    blocks: the luma in ``mcu`` (h, v) MCU order, each chroma image a raster
    chain."""
    from jpeglibrary_tpu_torch.host.ops import encode_stage as host_encode_stage

    want = np.zeros((4, 256), np.int64)
    for img in requants[0].cpu().numpy():
        dc, ac = host_encode_stage.dc_ac_symbol_frequencies(
            host_encode_stage.mcu_order_blocks(img, *mcu))
        want[0] += dc
        want[1] += ac
    for plane in requants[1:]:
        for img in plane.cpu().numpy():
            dc, ac = host_encode_stage.dc_ac_symbol_frequencies(img.reshape(-1, 64))
            want[2] += dc
            want[3] += ac
    return want


def phase_full_step(inputs, dev):
    """``full_step`` on the slice's images' coefficient planes at full width
    (Y [8, 256, 256, 64] int16, chroma [8, 128, 128, 64]): K1 and K2 launched
    3 times each and K6 once, RGB and the requantised Y, Cb and Cr against the step
    with their plain versions on the card, the chroma K2 calls against
    their plain version on the step's own planes, the four histograms
    equal to the host gather of the step's own requantised blocks, K5
    launched twice and equal to its plain version on the step's own
    statistics inputs and on :func:`k5_edge_cases`. Then the step's time,
    its kernels, and records for its K1 and K2 calls on the luma and its
    K5 call on the luma, returned with the step's K6 launches."""
    from jpeglibrary_tpu_torch.ops import color, encode_stage, kernels
    from jpeglibrary_tpu_torch.parallel import full_step, sharding

    (y, cb, cr), (q_luma, q_chroma) = inputs
    args = [torch.from_numpy(a).to(dev) for a in (y, cb, cr, q_luma, q_chroma)]
    reset_counts()
    rgb, requant, hists = full_step(*args, device=dev)
    torch.cuda.synchronize()
    k1_launches = kernels.dequantize_idct_shift.launches
    k6_launches = kernels.color_round_trip.launches
    k2_launches = kernels.fdct_quantize.launches
    k5_launches = kernels.symbol_histograms.launches
    log(f"full step: full_step over {y.shape[0]} images, Y {tuple(y.shape)} chroma "
        f"{tuple(cb.shape)} int16: K1 launches {k1_launches}, K6 launches {k6_launches}, "
        f"K2 launches {k2_launches}, K5 launches {k5_launches}")
    check((k1_launches, k6_launches, k2_launches, k5_launches) == (3, 1, 3, 2),
          ("full_step launches", k1_launches, k6_launches, k2_launches, k5_launches))
    k2_walks = dict(kernels.fdct_quantize.launches_by_walk)
    log(f"full step: K2 launches by walk {k2_walks}")
    check(k2_walks == {"warpgroups": 3}, ("full_step's K2 walks", k2_walks))
    b = y.shape[0]
    check(tuple(rgb.shape) == (b, SIZE, SIZE, 3) and rgb.dtype == torch.uint8, rgb.shape)
    check(requant.shape == args[0].shape and requant.dtype == torch.int16, requant.shape)

    idct = kernels.transform_matrix(dev)
    fdct = kernels.fdct_matrix(dev)
    k1_plain, k2_plain_call = plain_step_kernels(dev)

    # full_step hands back the requantised luma alone, as the JAX step does:
    # the step runs once more through _step with the same kernels for its
    # chroma, its other outputs equal to full_step's.
    rgb_, requants, hists_ = sharding._step(*args, kernels.dequantize_idct_shift,
                                            kernels.fdct_quantize)
    check(torch.equal(rgb_, rgb) and torch.equal(requants[0], requant)
          and torch.equal(hists_, hists), "_step's outputs differ from full_step's")
    plain_rgb, plain_requants, plain_hists = sharding._step(
        *args, k1_plain, k2_plain_call, k5=encode_stage.symbol_histograms_plain,
        k6=color.round_trip_plain)
    check_close(rgb.cpu().numpy(), plain_rgb.cpu().numpy(), "full step: RGB vs plain")
    check_requants("full step", requants, plain_requants)
    # The step's chroma K2 calls, 2x2 boxes of [B*H, W] planes with block rows
    # from every image, against their plain version on the same planes.
    _, cb2, cr2 = color.rgb_to_ycbcr(rgb[..., 0], rgb[..., 1], rgb[..., 2])
    for name, plane in (("Cb", cb2), ("Cr", cr2)):
        k2_check(f"full step {name} stacked", plane.reshape(b * SIZE, SIZE), args[4], 128, 2, 2,
                 fdct)

    want = host_histograms(requants, (2, 2))
    check(np.array_equal(hists.cpu().numpy(), want), "full_step's histograms differ from the "
          "host gather of its requantised blocks")
    same = all(torch.equal(g, w) for g, w in zip(requants, plain_requants))
    check(not same or torch.equal(plain_hists, hists),
          "the plain step's histograms differ where its requantised blocks are equal")
    log(f"full step: the 4 histograms equal the host gather of the step's own requantised "
        f"blocks ({int(want[0].sum())} luma and {int(want[2].sum())} chroma DC symbols); "
        f"the plain step's requantised blocks {'equal' if same else 'differ from'} the step's, "
        f"its histograms {'equal' if torch.equal(plain_hists, hists) else 'differ'}")

    # K5 against its plain version, exactly: on the planes _step hands it
    # where K2 wrote them (the luma walked at MCU (2, 2), the two chroma
    # planes as one call) and on the edge batches, flat and as planes,
    # there also against its CPU model (run here on the card's tensors).
    step_k5 = [("step luma", requants[0], (2, 2)), ("step chroma", tuple(requants[1:]), (1, 1))]

    def on_dev(a):
        if isinstance(a, (tuple, list)):
            return tuple(on_dev(x) for x in a)
        return None if a is None else torch.from_numpy(a).to(dev)

    k5_diff = 0
    for label, x, n_valid, prev_dc, mcu in [(label, x, None, None, mcu)
                                            for label, x, mcu in step_k5] + [
            (label, *map(on_dev, case), (1, 1)) for label, *case in k5_edge_cases()] + [
            (label, *map(on_dev, case), mcu) for label, *case, mcu in k5_plane_cases()]:
        got = kernels.symbol_histograms(x, n_valid, prev_dc, mcu=mcu)
        wants = [encode_stage.symbol_histograms_plain(x, n_valid, prev_dc, mcu=mcu)]
        if not label.startswith("step"):
            wants.append(encode_stage.symbol_histograms_model(x, n_valid, prev_dc, mcu=mcu))
        first = x[0] if isinstance(x, tuple) else x
        shape = (f"{len(x)} x " if isinstance(x, tuple) else "") + f"{tuple(first.shape)}"
        for what, want in zip(("plain version", "CPU model"), wants):
            d = torch.stack(got).to(torch.int64) - torch.stack(want).to(torch.int64)
            n_diff = int((d != 0).sum())
            k5_diff = max(k5_diff, int(d.abs().max()))
            log(f"full step: K5 {label} {shape} {str(first.dtype)[6:]} at MCU {mcu} vs its "
                f"{what}: {n_diff}/512 bins differ")
            check(n_diff == 0, ("K5 differs from its " + what, label, n_diff))

    def step():
        return full_step(*args, device=dev)

    def step_plain_statistics():  # the step as it ran before K5: its statistics plain
        return sharding._step(*args, kernels.dequantize_idct_shift, kernels.fdct_quantize,
                              k5=encode_stage.symbol_histograms_plain)

    def k5_after_copies(blocks, n_valid=None, prev_dc=None, *, mcu=(1, 1)):
        return kernels.symbol_histograms(encode_stage.mcu_walk(blocks, mcu), n_valid, prev_dc)

    def step_with_copies():  # the statistics' inputs copied into walk order first
        return sharding._step(*args, kernels.dequantize_idct_shift, kernels.fdct_quantize,
                              k5=k5_after_copies)

    step_ms = wall_ms(step, runs=5, warmup=1)
    copies_ms = wall_ms(step_with_copies, runs=5, warmup=1)
    before_ms = wall_ms(step_plain_statistics, runs=5, warmup=1)
    step_kernel_ms, copies_kernel_ms, before_kernel_ms = kernel_ms(
        step, step_with_copies, step_plain_statistics, runs=5)
    log(f"full step: {step_ms:.6f} ms per step of {b} images (host clock, synchronised, median "
        f"of 5), {step_kernel_ms:.6f} ms of kernels (warm, mean of 5); with K5's inputs copied "
        f"into walk order first (the MCU-order copy and the chroma cat) {copies_ms:.6f} ms, "
        f"{copies_kernel_ms:.6f} ms of kernels; with the statistics on their plain version (the "
        f"step before K5) {before_ms:.6f} ms, {before_kernel_ms:.6f} ms of kernels")
    # No op of the step moves the requantised blocks for the statistics: no
    # cat of [..., 64] blocks, no 6-D permute (the MCU-order copy's).
    moves = block_moves(step)
    log(f"full step: torch calls of one step that copy blocks into walk order: "
        f"{moves if moves else 'none'} (with the copies put back: "
        f"{len(block_moves(step_with_copies))})")
    check(not moves, ("full_step copies its blocks for the statistics", moves))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    log("full step: one step's kernel time by kernel, the largest: " + "; ".join(
        f"{e.key[:90]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms" for e in rows[:6]))

    # The step's K1 and K2 calls on the luma, each beside its plain version
    # and one torch.matmul (as in the kernel phases), in CUDA events with the
    # L2 flushed: the profiler once recorded none of this K2's calls here.
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    coeffs, quant = args[0], args[3]
    n_blocks = coeffs.numel() // 64
    k1_diff = int((kernels.dequantize_idct_shift(coeffs, quant, 128)
                   - k1_plain(coeffs, quant, 128)).abs().max())
    check(k1_diff <= 1, ("full step K1", k1_diff))
    deq = (coeffs.reshape(-1, 64).to(torch.int32) * quant).to(torch.float32)
    y2 = color.rgb_to_ycbcr(rgb[..., 0], rgb[..., 1], rgb[..., 2])[0].reshape(b * SIZE, SIZE)
    k2_diff = k2_check("full step Y", y2, quant, 128, 1, 1, fdct)
    cut = (y2.to(torch.float32) - 128).reshape(-1, 8, SIZE // 8, 8).permute(0, 2, 1, 3)
    cut = cut.reshape(-1, 64).contiguous()
    times = device_ms(lambda: k1_plain(coeffs, quant, 128),
                      lambda: kernels.dequantize_idct_shift(coeffs, quant, 128),
                      lambda: torch.matmul(deq, idct),
                      lambda: k2_plain(y2, quant, 128, 1, 1, fdct),
                      lambda: kernels.fdct_quantize(y2, quant, 128),
                      lambda: torch.matmul(cut, fdct), flush=flush)
    # The step's K5 calls on its planes in place, beside their plain version
    # (which copies them into walk order first) in CUDA events, warm and
    # L2-flushed, as the step's other calls: in this process the profiler has
    # kept only some of K5's launches (the count is logged below).
    k5_ms = {}
    for label, x, mcu in step_k5:
        fns = (lambda: encode_stage.symbol_histograms_plain(x, mcu=mcu),
               lambda: kernels.symbol_histograms(x, mcu=mcu))
        n_k5 = sum(q.numel() for q in (x if isinstance(x, tuple) else (x,))) // 64
        b_ms, b_by = k5_bound(n_k5, 2)
        timings = {"warm": device_ms(*fns), "L2 flushed": device_ms(*fns, flush=flush)}
        for what, (p_ms, k_ms) in timings.items():
            log(f"full step: K5 on the {label} ({n_k5} int16 blocks in place, MCU {mcu}), "
                f"{what}: {k_ms:.6f} ms ({b_ms / k_ms:.1%} of its {b_by} bound {b_ms:.6f} ms), "
                f"plain {p_ms:.6f} ms (CUDA events, median of {TIMED_RUNS} in turns)")
        k5_ms[label] = (timings["L2 flushed"], (b_ms, b_by))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            kernels.symbol_histograms(requants[0], mcu=(2, 2))
        torch.cuda.synchronize()
    recorded = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and "symbol_hist" in e.key)
    log(f"full step: the profiler recorded {recorded} of 5 K5 launches in one window")
    if dev.type == "cuda":
        k5_parts(step_k5, flush)
    del flush
    records = {}
    for key, name, source, replaces, launches, diff, (p_ms, k_ms, lib_ms), (b_ms, b_by) in (
            ("k1", "dequantize_idct_shift", K1_SOURCE, K1_REPLACES, k1_launches, k1_diff,
             times[:3], k1_bound(n_blocks, 1, 8, 2)),
            ("k2", "fdct_quantize", K2_SOURCE, K2_REPLACES, k2_launches, k2_diff, times[3:],
             k2_bound(n_blocks, 1))):
        log(f"full step: {name} on the Y plane ({n_blocks} blocks), L2 flushed: {k_ms:.6f} ms "
            f"({b_ms / k_ms:.1%} of its {b_by} bound {b_ms:.6f} ms), plain {p_ms:.6f} ms, "
            f"torch.matmul {lib_ms:.6f} ms (CUDA events, median of {TIMED_RUNS} in turns); "
            f"max |diff| against plain {diff}")
        records[key] = {
            "name": f"{name}[full_step]", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": diff, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    (p_ms, k_ms), (b_ms, b_by) = k5_ms["step luma"]
    records["k5"] = {
        "name": "symbol_histograms[full_step]", "route": "cuda", "source": K5_SOURCE,
        "replaces": K5_REPLACES, "launches": k5_launches, "max_abs_err": k5_diff, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    return records, k6_launches


def inputs_422(inputs):
    """4:2:2 inputs of ``full_step`` from 4:2:0 ones: the luma and the
    tables as they are, each chroma block row twice ([B, Hb, Wb/2, 64]),
    the chroma of a 4:2:2 frame whose every pair of chroma rows repeats."""
    (y, cb, cr), tables = inputs
    return (y, np.repeat(cb, 2, axis=1), np.repeat(cr, 2, axis=1)), tables


def phase_full_step_422(inputs, dev):
    """``full_step`` on a 4:2:2 batch (:func:`inputs_422` of the slice's
    planes): 3 K1, 1 K6 (its (2, 1) instantiation), 3 K2 (the chroma's two
    at the 2x1 box, all three on the warpgroup walk) and 2 K5 launches,
    counted from 0 just before the step; RGB and the requantised Y, Cb and
    Cr against the step with the plain versions, as phase 15 holds the
    4:2:0 step; the four histograms equal to the host gather of the step's
    own requantised blocks, the luma in (2, 1) MCU order. Returns the
    step's K6 launches."""
    from jpeglibrary_tpu_torch.ops import color, encode_stage, kernels
    from jpeglibrary_tpu_torch.parallel import full_step, sharding

    (y, cb, cr), (q_luma, q_chroma) = inputs_422(inputs)
    args = [torch.from_numpy(a).to(dev) for a in (y, cb, cr, q_luma, q_chroma)]
    reset_counts()
    rgb, requant, hists = full_step(*args, device=dev)
    torch.cuda.synchronize()
    launches = (kernels.dequantize_idct_shift.launches, kernels.color_round_trip.launches,
                kernels.fdct_quantize.launches, kernels.symbol_histograms.launches)
    k6_box = dict(kernels.color_round_trip.launches_by_box)
    k2_box = {(str(dtype)[6:], hs, vs): n for (dtype, hs, vs), n
              in kernels.fdct_quantize.launches_by_box.items()}
    k2_walks = dict(kernels.fdct_quantize.launches_by_walk)
    log(f"full step 4:2:2: full_step over {y.shape[0]} images, Y {tuple(y.shape)} chroma "
        f"{tuple(cb.shape)} int16: K1, K6, K2, K5 launches {launches}; K6 by box {k6_box}, "
        f"K2 by box {k2_box}, K2 by walk {k2_walks}")
    check(launches == (3, 1, 3, 2), ("full_step 4:2:2 launches", *launches))
    check(k6_box == {(2, 1): 1}, ("full_step 4:2:2 K6 boxes", k6_box))
    check(k2_box == {("uint8", 1, 1): 1, ("uint8", 2, 1): 2}, ("full_step 4:2:2 K2 boxes", k2_box))
    check(k2_walks == {"warpgroups": 3}, ("full_step 4:2:2 K2 walks", k2_walks))
    b, hb, wb = y.shape[:3]
    check(tuple(rgb.shape) == (b, hb * 8, wb * 8, 3) and rgb.dtype == torch.uint8, rgb.shape)
    check(requant.shape == args[0].shape and requant.dtype == torch.int16, requant.shape)

    k1_plain, k2_plain_call = plain_step_kernels(dev)
    rgb_, requants, hists_ = sharding._step(*args, kernels.dequantize_idct_shift,
                                            kernels.fdct_quantize)
    check(torch.equal(rgb_, rgb) and torch.equal(requants[0], requant)
          and torch.equal(hists_, hists), "4:2:2 _step's outputs differ from full_step's")
    plain_rgb, plain_requants, _ = sharding._step(
        *args, k1_plain, k2_plain_call, k5=encode_stage.symbol_histograms_plain,
        k6=color.round_trip_plain)
    check_close(rgb.cpu().numpy(), plain_rgb.cpu().numpy(), "full step 4:2:2: RGB vs plain")
    check_requants("full step 4:2:2", requants, plain_requants)
    want = host_histograms(requants, (2, 1))
    check(np.array_equal(hists.cpu().numpy(), want), "4:2:2 full_step's histograms differ "
          "from the host gather of its requantised blocks in (2, 1) MCU order")
    log(f"full step 4:2:2: the 4 histograms equal the host gather of the step's own "
        f"requantised blocks, the luma in (2, 1) MCU order ({int(want[0].sum())} luma and "
        f"{int(want[2].sum())} chroma DC symbols)")
    return launches[1]


def k6_bound(n_pixels, vs=2):
    """K6's bound: per luma pixel its int32 luma sample and 1 / (2 vs) of
    its two int32 chroma samples in, 3 B of RGB and 3 B of planes out (12
    B at 4:2:0, 14 B at 4:2:2); the integer operations of
    ``ops/color.py``'s formulas, a chroma cell of 2 vs pixels."""
    n_bytes = (4 + 8 // (2 * vs) + 6) * n_pixels
    return bound(n_bytes, 0, n_pixels * K6_OPS_PER_PIXEL
                 + n_pixels // (2 * vs) * K6_OPS_PER_CELL)


def k6_samples(b, hb, wb, dev, seed, vs=2):
    """K1-range int32 samples of a batch of 4:2:0 (``vs`` 2) or 4:2:2
    (``vs`` 1) images, luma [b, hb, wb, 8, 8] and two chroma [b, hb/vs,
    wb/2, 8, 8]: uniform in [-300, 400], with the int32 extremes and the
    clamp's edges planted in each."""
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    chroma = (b, hb // vs, wb // 2, 8, 8)
    for shape in ((b, hb, wb, 8, 8), chroma, chroma):
        x = torch.randint(-300, 401, shape, generator=g, device=dev, dtype=torch.int32)
        flat = x.view(-1)
        edges = torch.tensor([-2**31, 2**31 - 1, -1, 0, 255, 256], dtype=torch.int32, device=dev)
        flat[:edges.numel()] = edges
        out.append(x)
    return out


def phase_color_round_trip(dev, launches=(None, None)):
    """K6 against its plain version at :data:`K6_SHAPES`, 0 bytes
    differing, each launch counted under its sampling; its time against its
    bound beside the plain chain's, in CUDA events, with the L2 flushed and
    warm. Returns K6's records at the 16.8 MP cell's shape (4:2:0) and at
    the 24 MP cell's (4:2:2), with ``launches`` those of the full-step
    phase's 4:2:0 and 4:2:2 steps (None when this phase runs alone)."""
    from jpeglibrary_tpu_torch.ops import color, kernels

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    records = {}
    for i, (b, hb, wb, vs) in enumerate(K6_SHAPES):
        samples = k6_samples(b, hb, wb, dev, seed=60 + i, vs=vs)
        kernels.color_round_trip.launches_by_box.clear()
        got = kernels.color_round_trip(*samples)
        want = color.round_trip_plain(*samples)
        torch.cuda.synchronize()
        by_box = dict(kernels.color_round_trip.launches_by_box)
        n_diff = sum(int((g != w).sum()) for g, w in zip(got, want))
        n_bytes = sum(w.numel() for w in want)
        sampling = "4:2:0" if vs == 2 else "4:2:2"
        label = f"{sampling} {b} x {hb} x {wb} luma blocks ({wb // 2} MCUs a row)"
        log(f"K6 {label}: {n_diff}/{n_bytes} output bytes differ from the plain version; "
            f"launches by box {by_box}")
        check(n_diff == 0 and all(g.shape == w.shape and g.dtype == w.dtype
                                  for g, w in zip(got, want)), ("K6 differs", label, n_diff))
        if dev.type == "cuda":
            check(by_box == {(2, vs): 1}, ("K6 launches by box", label, by_box))
        del got, want
        n_pixels = b * hb * wb * 64
        b_ms, b_by = k6_bound(n_pixels, vs)
        fns = (lambda: color.round_trip_plain(*samples),
               lambda: kernels.color_round_trip(*samples))
        timings = {"L2 flushed": device_ms(*fns, flush=flush), "warm": device_ms(*fns)}
        rate = (4 + 4 // vs + 6) * n_pixels
        for what, (p_ms, k_ms) in timings.items():
            log(f"K6 {label}, {what}: {k_ms:.6f} ms ({b_ms / k_ms:.1%} of its {b_by} bound "
                f"{b_ms:.6f} ms, {rate / k_ms / 1e9:.3f} TB/s), plain {p_ms:.6f} ms "
                f"(CUDA events, median of {TIMED_RUNS} in turns)")
        if vs not in records:
            p_ms, k_ms = timings["L2 flushed"]
            name = "color_round_trip[full_step]" if vs == 2 else "color_round_trip[full_step 4:2:2]"
            records[vs] = {"name": name, "route": "cuda", "source": K6_SOURCE,
                           "replaces": K6_REPLACES, "launches": launches[2 - vs],
                           "max_abs_err": n_diff, "ms": k_ms, "plain_ms": p_ms,
                           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        del samples
    del flush
    return [records[2], records[1]]


def gray_coefficients(b, hb, wb, dev, seed):
    """Random int16 coefficients [b, hb, wb, 64] at a 12-bit frame's scale,
    made on ``dev``; their decode leaves [0, 4095] now and then on both
    sides, so the clamp is met."""
    g = torch.Generator(device=dev).manual_seed(seed)
    c = torch.randn((b, hb, wb, 64), generator=g, device=dev) * 60
    c = c / (1 + torch.arange(64, device=dev) / 8)
    c[..., 0] = torch.randint(-2800, 2800, (b, hb, wb), generator=g, device=dev)
    return c.round().to(torch.int16)


def gray_table(dev):
    """The Annex K luminance table at IJG quality 90, the CT cell's, int32
    zig-zag on ``dev``."""
    from jpeglibrary_tpu_torch.host.syntax.quantization import (
        scale_by_quality, standard_luminance_table)

    elements = scale_by_quality(standard_luminance_table(), 90).elements
    return torch.from_numpy(elements.astype(np.int32)).to(dev)


def phase_gray_step(dev):
    """K1's plane store and K2's uint16 load against their int32 paths at
    :data:`GRAY_SHAPES`, 0 values differing; ``gray_step`` at the cell's
    series against the plain step, with its launches; the kernels' and the
    step's times against their bounds. Returns the records of K1's plane
    store, K2's uint16 load and K5 in the step."""
    from jpeglibrary_tpu_torch.ops import decode_stage, encode_stage, kernels
    from jpeglibrary_tpu_torch.parallel import sharding

    q = gray_table(dev)
    for i, (b, hb, wb) in enumerate(GRAY_SHAPES):
        c = gray_coefficients(b, hb, wb, dev, seed=70 + i)
        got = kernels.dequantize_idct_plane(c, q, 12)
        want = decode_stage.clamp_plane_u16(kernels.dequantize_idct_shift(c, q, 2048), 12)
        plane = got.view(b * hb * 8, wb * 8)
        k2 = [kernels.fdct_quantize(x, q, 2048, blocks=(b * hb, wb))
              for x in (plane, plane.to(torch.int32))]
        torch.cuda.synchronize()
        n1, n2 = int((got != want).sum()), int((k2[0] != k2[1]).sum())
        clamped = int(((want == 0) | (want == 4095)).sum())
        log(f"gray {b} x {hb} x {wb} blocks: K1's plane store {n1}/{want.numel()} samples "
            f"differ from K1's int32 blocks through the plain tail ({clamped} clamped); "
            f"K2's uint16 load {n2}/{k2[1].numel()} coefficients differ from its int32 load")
        check(n1 == 0 and got.dtype == torch.uint16 and n2 == 0, ("gray", (b, hb, wb), n1, n2))
        del c, got, want, plane, k2

    b, hb, wb = GRAY_SHAPES[0]
    n, samples = b * hb * wb, b * hb * wb * 64
    c = gray_coefficients(b, hb, wb, dev, seed=79)
    reset_counts()
    out = sharding.gray_step(c, q, device=dev)
    torch.cuda.synchronize()
    launches = (kernels.dequantize_idct_plane.launches, kernels.fdct_quantize.launches,
                kernels.symbol_histograms.launches)
    k2_walks = dict(kernels.fdct_quantize.launches_by_walk)
    log(f"gray_step launches (K1 plane, K2, K5): {launches}; K2's by walk {k2_walks}")
    check(launches == (1, 1, 1), ("gray_step launches", launches))
    check(k2_walks == {"warpgroups": 1}, ("gray_step's K2 walks", k2_walks))

    def plain_k1(coeffs, quant, precision):
        blocks = decode_stage.dequantize_idct_shift(coeffs, quant, n, 1 << (precision - 1),
                                                    kernels.transform_matrix(dev))
        return decode_stage.clamp_plane_u16(blocks.reshape(b, hb, wb, 8, 8), precision)

    def plain_k2(plane, quant, level_shift, *, hs=1, vs=1, blocks=None):  # K2's signature, 1x1
        return encode_stage.fdct_quantize(plane, quant, level_shift, kernels.fdct_matrix(dev))

    plain = sharding._gray_step(c, q, 12, plain_k1, plain_k2,
                                k5=encode_stage.symbol_histograms_plain)
    worst = {}  # each record's max |diff| against its plain version in the step
    for what, g, w in (("samples", out[0], plain[0]), ("requantised blocks", out[1], plain[1])):
        d = (g.to(torch.int32) - w.to(torch.int32)).abs()
        n_diff, max_abs = int((d > 0).sum()), int(d.max())
        worst[what] = max_abs
        log(f"gray_step {what}: max |diff| {max_abs} against the plain step, "
            f"{n_diff}/{d.numel()} differ")
        check(max_abs <= 1 and n_diff <= GRAY_SHARE * d.numel(), ("gray_step", what, n_diff))
    own = torch.stack(encode_stage.symbol_histograms_plain(out[1]))
    n_bins = int((out[2] != own).sum())
    log(f"gray_step histograms: {n_bins} of 512 bins differ from K5's plain version on the "
        f"step's own blocks; {int(out[2][0].sum())} DC and {int(out[2][1].sum())} AC symbols")
    check(n_bins == 0, ("gray_step histograms", n_bins))
    worst["histograms"] = n_bins

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    plane = out[0].view(b * hb * 8, wb * 8)
    # name: (the call, its plain version, its bound)
    calls = {
        "K1 plane store": (lambda: kernels.dequantize_idct_plane(c, q, 12),
                           lambda: plain_k1(c, q, 12),
                           bound(4 * samples + 256, n * 2 * 64 * 64, 4 * samples)),
        "K2 uint16 load": (lambda: kernels.fdct_quantize(plane, q, 2048, blocks=(b * hb, wb)),
                           lambda: plain_k2(plane, q, 2048),
                           bound(4 * samples + 256, n * 2 * 64 * 64, 2 * samples)),
        "K5": (lambda: encode_stage.symbol_histograms_device(out[1]),
               lambda: encode_stage.symbol_histograms_plain(out[1]),
               bound(2 * samples + 2048, 0, samples)),
        "gray_step": (lambda: sharding.gray_step(c, q, device=dev),
                      lambda: sharding._gray_step(c, q, 12, plain_k1, plain_k2,
                                                  k5=encode_stage.symbol_histograms_plain),
                      bound(6 * samples, 0, 0)),
    }
    times = {}
    for name, (fn, plain_fn, (b_ms, b_by)) in calls.items():
        p_ms, k_ms = device_ms(plain_fn, fn, flush=flush)
        warm = device_ms(fn)[0]
        times[name] = (k_ms, p_ms)
        log(f"gray {name} at {b} x {hb} x {wb} blocks: {k_ms:.6f} ms flushed "
            f"({b_ms / k_ms:.1%} of its {b_by} bound {b_ms:.6f} ms), {warm:.6f} ms warm, "
            f"plain {p_ms:.6f} ms flushed (CUDA events, median of {TIMED_RUNS} in turns)")
    del flush

    def record(name, source, replaces, key, err, b_ms, b_by, n_launches):
        k_ms, p_ms = times[key]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n_launches, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    return [record("dequantize_idct_plane[gray_step]", K1_SOURCE, K1_REPLACES,
                   "K1 plane store", worst["samples"], *calls["K1 plane store"][2], launches[0]),
            record("fdct_quantize[gray_step, uint16]", K2_SOURCE, K2_REPLACES, "K2 uint16 load",
                   worst["requantised blocks"], *calls["K2 uint16 load"][2], launches[1]),
            record("symbol_histograms[gray_step]", K5_SOURCE, K5_REPLACES, "K5",
                   worst["histograms"], *calls["K5"][2], launches[2])]


def prog_photo_planes(b, height, width, dev, seed):
    """The transcode cell's content: ``b`` photo-like images from the
    benchmark's generators (``content.photo``, ``coefficients.
    quantised_planes``) at :data:`PROG_QUALITY`, made on ``dev`` a few at a
    time; int16 (y, cb, cr) zig-zag planes padded to whole MCUs."""
    from jpegbench.generators import coefficients, content
    from jpegbench.reference.tables import quant_tables_zz

    qy, qc = (torch.from_numpy(q).to(dev) for q in quant_tables_zz(PROG_QUALITY))
    g = torch.Generator(device=dev).manual_seed(seed)
    parts = [coefficients.quantised_planes(content.photo(g, min(PROG_CHUNK, b - i), height,
                                                         width), qy, qc)
             for i in range(0, b, PROG_CHUNK)]
    return [torch.cat(p) for p in zip(*parts)]


def prog_random_planes(b, height, width, dev, seed, density=0.3):
    """Random 4:2:0 int16 planes padded to whole MCUs: a share ``density``
    of the AC coefficients non-zero, magnitudes falling with the zig-zag
    position, both signs."""
    g = torch.Generator(device=dev).manual_seed(seed)
    hb, wb = 2 * -(-height // 16), 2 * -(-width // 16)
    decay = torch.exp(-torch.arange(64, device=dev) / 16.0) * 12
    out = []
    for shape in ((b, hb, wb, 64), (b, hb // 2, wb // 2, 64), (b, hb // 2, wb // 2, 64)):
        x = torch.randn(shape, generator=g, device=dev) * decay
        keep = torch.rand(shape, generator=g, device=dev) < density
        keep[..., 0] = True
        out.append((x * keep).round().clamp(-2047, 2047).to(torch.int16))
    return out


def prog_bins_off(planes, size, script, what):
    """K7's wrapper against its plain version, image by image (the plain
    version's int64 temporaries of a whole cell batch would not fit
    beside it): checks 0 bins differing and returns K7's histograms."""
    from jpeglibrary_tpu_torch.ops import encode_stage, kernels

    got = kernels.progressive_histograms(*planes, script, size=size)
    n_diff = 0
    for i in range(got.shape[0]):
        want = encode_stage.progressive_histograms_plain(*(p[i:i + 1] for p in planes), script,
                                                         size=size)
        n_diff += int((got[i:i + 1] != want).sum())
    torch.cuda.synchronize()
    log(f"K7 {what}: {n_diff} of {got.numel()} bins differ from the plain version; "
        f"{int(got.sum())} symbols, {int(got[..., 0xE0].sum())} runs of 0x7FFF blocks")
    check(n_diff == 0 and got.dtype == torch.int32, ("K7 differs", what, n_diff))
    return got, n_diff


def phase_progressive_step(dev):
    """K7 (``kernels.progressive_histograms``) against its plain version,
    0 bins differing: on the transcode cell's batch of photo content, on
    the same shape with a flat luma (EOB runs past 0x7FFF blocks, split and
    stitched at the card's full width) and at a ragged size; one
    ``progressive_step`` on the cell's batch with its launches counted from
    0 (y, cb, cr, eobrun 1 each); K7 timed in CUDA events, L2 flushed and
    warm, against its bound (one read of the int16 blocks and the
    histograms' write), beside the plain version image by image and one
    library read of the same blocks (``torch.count_nonzero``). Returns K7's
    record."""
    from jpeglibrary_tpu_torch.host.models.progressive_encoder import SCRIPT_3
    from jpeglibrary_tpu_torch.ops import encode_stage, kernels
    from jpeglibrary_tpu_torch.parallel import sharding

    b, height, width = PROG_CELL
    size = (height, width)
    t0 = time.perf_counter()
    planes = prog_photo_planes(b, height, width, dev, seed=90)
    nonzero = (sum(int((p[..., 1:] != 0).sum()) for p in planes)
               / sum(p[..., 0].numel() for p in planes))
    log(f"progressive step: {b} photo images of {width} x {height} at q{PROG_QUALITY}, "
        f"luma {tuple(planes[0].shape)}, chroma {tuple(planes[1].shape)}, made in "
        f"{time.perf_counter() - t0:.3f} s; {nonzero:.3f} non-zero AC coefficients a block")
    _, worst = prog_bins_off(planes, size, SCRIPT_3, f"cell batch {b} x {width} x {height}")

    flat = [planes[0].clone(), planes[1], planes[2]]
    flat[0][..., 1:] = 0
    got, n_diff = prog_bins_off(flat, size, SCRIPT_3, "cell batch, flat luma")
    worst = max(worst, n_diff)
    n_grid = -(-height // 8) * -(-width // 8)
    long_runs = int(got[:, 3:, 0xE0].sum())  # the AC rows; the luma's runs pass 0x7FFF
    log(f"K7 flat luma: {n_grid} luma blocks an image, {long_runs} runs of 0x7FFF blocks")
    check(n_grid <= 0x7FFF or long_runs > 0, ("K7 flat luma: no run past 0x7FFF", long_runs))
    del flat, got

    rb, rh, rw = PROG_RAGGED
    ragged = prog_random_planes(rb, rh, rw, dev, seed=91)
    _, n_diff = prog_bins_off(ragged, (rh, rw), SCRIPT_3, f"ragged {rb} x {rw} x {rh}")
    worst = max(worst, n_diff)
    del ragged

    reset_counts()
    out = sharding.progressive_step(*planes, size=size, device=dev)
    torch.cuda.synchronize()
    launches = kernels.progressive_histograms.launches
    by_walk = dict(kernels.progressive_histograms.launches_by_walk)
    log(f"progressive_step launches: {launches}, by walk {by_walk}; "
        f"histograms {tuple(out.shape)}")
    check(launches == 4 and by_walk == {"y": 1, "cb": 1, "cr": 1, "eobrun": 1},
          ("progressive_step launches", launches, by_walk))

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    n_blocks = sum(p.shape[0] * p.shape[1] * p.shape[2] for p in planes)
    b_ms, b_by = bound(n_blocks * 128 + out.numel() * 4, 0, 0)

    def k7():
        return kernels.progressive_histograms(*planes, SCRIPT_3, size=size)

    def library():
        return [torch.count_nonzero(p) for p in planes]

    def plain():
        return [encode_stage.progressive_histograms_plain(*(p[i:i + 1] for p in planes),
                                                          SCRIPT_3, size=size)
                for i in range(b)]

    k_ms, lib_ms = device_ms(k7, library, flush=flush)
    warm = device_ms(k7)[0]
    p_ms = device_ms(plain, runs=3, warmup=1, flush=flush)[0]
    log(f"K7 at the cell's batch: {k_ms:.6f} ms flushed ({b_ms / k_ms:.1%} of its {b_by} "
        f"bound {b_ms:.6f} ms, {n_blocks * 128 / k_ms / 1e9:.3f} TB/s of blocks), "
        f"{warm:.6f} ms warm; one library read of the blocks {lib_ms:.6f} ms, the plain "
        f"version image by image {p_ms:.6f} ms (CUDA events, L2 flushed, median of "
        f"{TIMED_RUNS} in turns, the plain of 3)")
    del flush, planes, out
    return {"name": "progressive_histograms[progressive_step]", "route": "cuda",
            "source": K7_SOURCE, "replaces": K7_REPLACES, "launches": launches,
            "max_abs_err": worst, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


MESH_TIMEOUT_S = 180  # each world's own limit; a hung rendezvous fails the phase
MESH_DEVICE = "cuda"  # the ranks' device type ("cpu" only to rehearse the phase's code)
MESH_RUNS = 5  # host-clock runs of each timed mesh path, after one warm-up


def equal_to(got, want, what):
    """Check ``got`` equal to ``want`` bit for bit (tensors or arrays)."""
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = want.cpu().numpy() if torch.is_tensor(want) else np.asarray(want)
    check(got.shape == want.shape and got.dtype == want.dtype,
          (what, got.shape, got.dtype, want.shape, want.dtype))
    n_diff = int((got != want).sum())
    check(n_diff == 0, f"{what}: {n_diff} of {got.size} values differ")


def mesh_rank(world, datas):
    """One rank of the mesh phase, in a world spawned by
    ``distributed.spawn`` (world 1 over NCCL, world 2 over gloo with both
    ranks on cuda:0): each mesh path against its single-device
    counterpart on the same card, bit for bit, with the rank's K1, K2 and
    K5 launches around each; in world 1 the host-clock times of both, in
    world 2 only the step's (logged only: its two ranks share the card).
    Returns the rank's log lines and launches."""
    import torch.distributed as dist

    import jpeglibrary_tpu_torch as jtt
    from jpeglibrary_tpu_torch.host.models.lossless import encode_lossless
    from jpeglibrary_tpu_torch.host.models.progressive_encoder import encode_progressive_rgb
    from jpeglibrary_tpu_torch.host.ops import encode_stage as host_encode_stage
    from jpeglibrary_tpu_torch.models.encoder import rgb_encoder
    from jpeglibrary_tpu_torch.ops import kernels
    from jpeglibrary_tpu_torch.parallel import distributed, full_step, sharding
    from jpeglibrary_tpu_torch.parallel.batch import scan
    from jpeglibrary_tpu_torch.parallel.collectives import full_tensor

    torch.backends.cuda.matmul.allow_tf32 = False
    rank, size = dist.get_rank(), dist.get_world_size()
    data_mesh = sharding.make_mesh(size, stripe=1, device_type=MESH_DEVICE)
    dev = sharding.mesh_device(data_mesh)
    lines, launches = [], {}

    def note(text):
        lines.append(f"mesh: world {world} ({dist.get_backend()}), rank {rank}: {text}")

    def counted(key, fn):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        launches[key] = (kernels.dequantize_idct_shift.launches, kernels.fdct_quantize.launches,
                         kernels.symbol_histograms.launches)
        return out

    def host_ms(fn):
        fn()
        return statistics.median(timed(fn)[1] * 1e3 for _ in range(MESH_RUNS))

    (y, cb, cr), (q_luma, q_chroma) = step_inputs(datas)
    args = [torch.from_numpy(a).to(dev) for a in (y, cb, cr, q_luma, q_chroma)]
    want = full_step(*args, device=dev)
    meshes = [(1, 1)] if world == 1 else [(2, 1), (2, 2)]
    for n, stripe in meshes:
        mesh = sharding.make_mesh(n, stripe=stripe, device_type=MESH_DEVICE)
        step = sharding.make_sharded_full_step(mesh)
        got = counted(f"step {n}x{stripe}", lambda: step(*args))
        for name, g, w in zip(("rgb", "requant_y", "hists"), got, want):
            equal_to(full_tensor(g), w, f"sharded step {n}x{stripe} {name}")
        k1, k2, k5 = launches[f"step {n}x{stripe}"]
        check((k1, k2, k5) == (3, 3, 2), ("sharded step launches", n, stripe, k1, k2, k5))
        note(f"make_sharded_full_step on mesh {dict(zip(sharding.MESH_DIMS, mesh.shape))}, "
             f"Y {tuple(y.shape)}, local RGB {tuple(got[0].to_local().shape)}: RGB, requantised "
             f"Y and the 4 histograms equal full_step's bit for bit; K1 {k1}, K2 {k2}, K5 {k5} "
             "launches")
        sharded_ms, single_ms = host_ms(lambda: step(*args)), host_ms(
            lambda: full_step(*args, device=dev))
        note(f"sharded step {sharded_ms:.6f} ms, full_step {single_ms:.6f} ms per step of "
             f"{y.shape[0]} images (host clock, synchronised, median of {MESH_RUNS})")
    mesh = sharding.make_mesh(size, stripe=size, device_type=MESH_DEVICE)  # stripes on all

    def single_rgb(data, sparse=True):
        return jtt.to_rgb8_device(scan(data), device=dev, sparse=sparse)

    def sharded_rgb(data):
        return sharding.assemble_stripes(*sharding.decode_rgb_sharded(data, mesh))

    sources = {"v2": (datas[0], False)}
    if world == 2:
        sources["v1"] = (datas[0], True)
        start = time.perf_counter()
        img = synth_image(0, SIZE)
        sources["progressive"] = (encode_progressive_rgb(img, 75), False)
        sources["lossless"] = (encode_lossless(img, predictor=1), False)
        note(f"progressive and lossless {SIZE}x{SIZE} sources written by the host encoders in "
             f"{time.perf_counter() - start:.3f} s")
    for mode, (data, v1) in sources.items():
        if v1:
            os.environ["JPX_WIRE"] = "1"
        try:
            got = counted(f"stripes {mode}", lambda: sharded_rgb(data))
            if mode == "lossless":
                res = scan(data)
                ref = np.moveaxis(res.to_rgb8(), -1, 0)
            else:
                ref = single_rgb(data, sparse=mode != "progressive")
            equal_to(got, ref, f"decode_rgb_sharded {mode}")
            k1 = launches[f"stripes {mode}"][0]
            check(k1 == (0 if mode == "lossless" else 3), ("stripe K1 launches", mode, k1))
            note(f"decode_rgb_sharded {mode} {SIZE}x{SIZE} over {size} stripes: equal to the "
                 f"single-device decode bit for bit; K1 {k1} launches")
            if world == 1:
                note(f"decode_rgb_sharded {host_ms(lambda: sharded_rgb(data)):.6f} ms, scan + "
                     f"to_rgb8_device {host_ms(lambda: single_rgb(data)):.6f} ms (host clock, "
                     f"median of {MESH_RUNS})")
        finally:
            os.environ.pop("JPX_WIRE", None)

    batch = jtt.decode_batch_rgb(datas, device=dev)
    if world == 1:
        got = counted("batch mesh", lambda: jtt.decode_batch_rgb(datas, mesh=data_mesh))
        for i, (g, w) in enumerate(zip(got, batch)):
            equal_to(g, w, f"decode_batch_rgb(mesh=) image {i}")
        check(launches["batch mesh"][0] == 3, ("batch mesh K1 launches", launches["batch mesh"]))
        note(f"decode_batch_rgb(mesh=) of {len(datas)} images equal to decode_batch_rgb; "
             f"K1 {launches['batch mesh'][0]} launches")
    block = distributed.local_batch_block(len(datas))
    got = counted("global", lambda: distributed.decode_batch_rgb_global(
        datas, device_type=MESH_DEVICE))
    for i, g in zip(block, got.to_local()):
        equal_to(g.permute(1, 2, 0), batch[i], f"decode_batch_rgb_global image {i}")
    check(launches["global"][0] == 3, ("global batch K1 launches", launches["global"]))
    note(f"decode_batch_rgb_global of {len(datas)} images, images {block.start}-{block.stop - 1} "
         f"here: equal to decode_batch_rgb bit for bit; K1 {launches['global'][0]} launches")
    if world == 1:
        global_ms = host_ms(lambda: distributed.decode_batch_rgb_global(
            datas, device_type=MESH_DEVICE))
        batch_ms = host_ms(lambda: jtt.decode_batch_rgb(datas, device=dev))
        note(f"decode_batch_rgb_global {global_ms:.6f} ms, decode_batch_rgb {batch_ms:.6f} ms "
             f"per batch of {len(datas)} (host clock, median of {MESH_RUNS})")
        res = scan(datas[0])
        y_plane = res.coefficients[res.geometry.components[0].component_index]
        blocks = host_encode_stage.mcu_order_blocks(y_plane, 2, 2)
        got = counted("statistics", lambda: sharding.mesh_symbol_frequencies(blocks, data_mesh))
        for g, w in zip(got, host_encode_stage.dc_ac_symbol_frequencies(blocks)):
            equal_to(g, w, "mesh_symbol_frequencies")
        k5 = launches["statistics"][2]
        check(k5 == 1, ("mesh statistics K5 launches", launches["statistics"]))
        note(f"mesh_symbol_frequencies of {len(blocks)} luma blocks equal to the host gather; "
             f"K5 {k5} launches")
        img = synth_image(0, SIZE)
        plain = jtt.encode(rgb_encoder(img, 75, optimize_coding=True), device=dev)
        encoder = rgb_encoder(img, 75, optimize_coding=True)
        encoder.mesh = data_mesh
        check(jtt.encode(encoder, device=dev) == plain, "the mesh's encode bytes differ")
        note(f"optimize_coding encode with the mesh: the same {len(plain)} bytes as without")
    return {"lines": lines, "launches": launches}


def phase_mesh(sl):
    """The mesh layer on the card: world 1 (NCCL, mesh (1, 1)) and world 2
    (gloo, both ranks on cuda:0, meshes (2, 1) and (1, 2)), spawned from
    here after the kernels were built, each rank holding each mesh path to
    its single-device counterpart bit for bit (``mesh_rank``). A rank's
    failure fails the phase."""
    from jpeglibrary_tpu_torch.parallel import distributed

    for world, backend in ((1, "nccl"), (2, "gloo")):
        start = time.perf_counter()
        ranks = distributed.spawn(mesh_rank, world, world, sl["datas"], backend=backend,
                                  timeout=MESH_TIMEOUT_S)
        for r in ranks:
            for line in r["lines"]:
                log(line)
        log(f"mesh: world {world} over {backend}: {time.perf_counter() - start:.3f} s with the "
            f"spawn; launches (K1, K2, K5) by rank and path: {[r['launches'] for r in ranks]}")


def k4_bound(n_blocks, itemsize):
    """K4's bound: the coefficients and the quant table in, the int32 plane
    out; K4_OPS_PER_BLOCK float operations per block."""
    n_bytes = n_blocks * 64 * itemsize + 64 * 4 + n_blocks * 64 * 4
    return bound(n_bytes, 0, n_blocks * K4_OPS_PER_BLOCK)


def k4_check(label, coeffs, quant, ls):
    """K4 against its plain version on the card, bit for bit: 0 samples may
    differ. Returns the plain plane."""
    from jpeglibrary_tpu_torch.ops import decode_stage, kernels

    got = kernels.butterfly_idct_shift(coeffs, quant, ls)
    want = decode_stage.blocks_to_plane(
        decode_stage.dequantize_idct_shift_exact(coeffs, quant, ls))
    torch.cuda.synchronize()
    hb, wb = coeffs.shape[0], coeffs.shape[1]
    check(got.dtype == torch.int32 and tuple(got.shape) == tuple(want.shape) == (hb * 8, wb * 8),
          (label, got.dtype, tuple(got.shape)))
    n_diff = int((got != want).sum())
    log(f"golden: K4 vs plain, {label} ({hb * wb} blocks, {coeffs.dtype}, level shift {ls}): "
        f"{n_diff}/{got.numel()} samples differ")
    check(n_diff == 0, (label, n_diff))
    return want


def gray12_stream(plane, dev):
    """A 12-bit grayscale stream of ``plane`` (int32 samples) with optimized
    Huffman tables, through the host encoder's emission
    (``sample_precision = 12``), its transform on the card."""
    import jpeglibrary_tpu_torch as jtt
    from jpeglibrary_tpu_torch.host.syntax.quantization import (
        scale_by_quality,
        standard_luminance_table,
    )

    encoder = jtt.JpegEncoder()
    encoder.sample_precision = 12
    encoder.set_quantization_table(scale_by_quality(standard_luminance_table(0), 90))
    encoder.set_huffman_table(True, 0)
    encoder.set_huffman_table(False, 0)
    encoder.add_component(1, 0, 0, 0, 1, 1)
    encoder.set_input([plane])
    return jtt.encode(encoder, device=dev)


def phase_golden(sl, dev):
    """The bit-exact decode on the card: ``jtt.decode(data, xp=dev).planes``
    (K4 once per component) and ``jtt.decode_region(..., xp=dev)`` against
    the host numpy path, 0 values differing, on the slice's 8 streams, a
    12-bit grayscale stream, a progressive one and an arithmetic one; K4
    against its plain version on the Y plane of a slice image, random
    int16 and int32 planes and 12-bit planes; K4 timed against its plain
    version, one ``torch.matmul`` of the folded IDCT matrix and its bound;
    the planes' host-clock time beside the host numpy planes'. Returns
    K4's record."""
    import jpeglibrary_tpu_torch as jtt
    from jpeglibrary_tpu_torch.host.models.progressive_encoder import encode_progressive_rgb
    from jpeglibrary_tpu_torch.models.decoder import quant_tables
    from jpeglibrary_tpu_torch.ops import decode_stage, kernels

    start = time.perf_counter()
    src = sl["sources"][0]
    gray12 = src[..., 1].astype(np.int32) * 16 + np.random.default_rng(12).integers(
        0, 16, src.shape[:2]).astype(np.int32)
    extra = {"12-bit gray": (gray12_stream(gray12, dev), 1),
             "progressive": (encode_progressive_rgb(src, 75), 3),
             "arithmetic": (jtt.encode_rgb(src, 75, arithmetic=True, device=dev), 3),
             "restart 16": (jtt.encode_rgb(src, 75, restart_interval=16, device=dev), 3)}
    log(f"golden: streams written in {time.perf_counter() - start:.3f} s: "
        + ", ".join(f"{k} {len(d)} bytes" for k, (d, _) in extra.items()))
    jobs = [(f"slice image {i}", d, 3) for i, d in enumerate(sl["datas"])]
    jobs += [(k, d, n) for k, (d, n) in extra.items()]

    host_s, card_s, n_values, launches = [], [], 0, 0
    for label, data, n_comps in jobs:
        t0 = time.perf_counter()
        want = jtt.decode(data).planes
        t1 = time.perf_counter()
        reset_counts()
        res = jtt.decode(data, xp=dev)
        got = res.planes
        t2 = time.perf_counter()
        k4 = kernels.butterfly_idct_shift.launches
        check(k4 == n_comps and kernels.dequantize_idct_shift.launches == 0,
              (label, "K4 launches", k4, "K1 launches", kernels.dequantize_idct_shift.launches))
        check(sorted(got) == sorted(want), (label, sorted(got), sorted(want)))
        n_diff = 0
        for k in want:
            check(got[k].dtype == want[k].dtype == np.int32 and got[k].shape == want[k].shape,
                  (label, k, got[k].dtype, got[k].shape))
            n_diff += int((got[k] != want[k]).sum())
            n_values += got[k].size
        log(f"golden: decode(xp={dev}).planes of {label} ({res.width}x{res.height}, "
            f"{res.precision}-bit): {n_diff} values differ from the host numpy planes; K4 "
            f"launches {k4}; host clock {(t2 - t1) * 1e3:.6f} ms vs numpy {(t1 - t0) * 1e3:.6f} ms "
            "(each with its scan)")
        check(n_diff == 0, (label, n_diff))
        if label.startswith("slice"):
            launches += k4
            host_s.append(t1 - t0)
            card_s.append(t2 - t1)
    log(f"golden: {len(jobs)} streams, {n_values} plane values, all equal to the host numpy "
        f"path; K4 launches on the 8 slice images {launches} (3 per 4:2:0 image); decode + "
        f"planes median {statistics.median(card_s) * 1e3:.6f} ms on the card, "
        f"{statistics.median(host_s) * 1e3:.6f} ms on numpy (host clock, first call each)")

    res = jtt.decode(sl["datas"][0])
    t_scan = warm_median_s(lambda: jtt.decode(sl["datas"][0]))
    t_card = warm_median_s(lambda: jtt.decode(sl["datas"][0], xp=dev).planes)
    t_host = warm_median_s(lambda: jtt.decode(sl["datas"][0]).planes)
    log(f"golden: slice image 0, median of {STREAM_RUNS} warm runs (host clock): scan "
        f"{t_scan * 1e3:.6f} ms; scan + planes on the card {t_card * 1e3:.6f} ms, on numpy "
        f"{t_host * 1e3:.6f} ms; planes alone {(t_card - t_scan) * 1e3:.6f} ms vs "
        f"{(t_host - t_scan) * 1e3:.6f} ms")

    for x, y, w, h in GOLDEN_RECTS:
        for label, data in (("slice image 0", sl["datas"][0]),
                            *((k, d) for k, (d, _) in extra.items())):
            got = jtt.decode_region(data, x, y, w, h, xp=dev)
            want = jtt.decode_region(data, x, y, w, h)
            check(got.shape == want.shape == (h, w, 3), (label, got.shape, want.shape))
            n_diff = int((got != want).sum())
            log(f"golden: decode_region({x}, {y}, {w}, {h}, xp={dev}) of {label}: {n_diff} "
                "values differ from the host numpy region")
            check(n_diff == 0, (label, (x, y, w, h), n_diff))

    # K4 alone: the Y plane of slice image 0 (real coefficients), random
    # planes at 8-bit magnitudes (int16 and int32) and at 12-bit ones
    # (quant entries up to 65,535), and the 12-bit stream's plane.
    rng = np.random.default_rng(4444)
    y_idx = res.geometry.components[0].component_index
    y_plane = torch.from_numpy(res.coefficients[y_idx]).to(dev)
    q_y = torch.from_numpy(quant_tables(res)[0]).to(dev)
    n_blocks = y_plane.shape[0] * y_plane.shape[1]
    k4_check("Y of slice image 0", y_plane, q_y, 128)
    rand = rng.integers(-1024, 1024, size=tuple(y_plane.shape)).astype(np.int16)
    rand = torch.from_numpy(rand).to(dev)
    q_rand = torch.from_numpy(rng.integers(1, 256, size=64).astype(np.int32)).to(dev)
    k4_check("random int16", rand, q_rand, 128)
    k4_check("random int32", rand.to(torch.int32), q_rand, 128)
    rand12 = torch.from_numpy(rng.integers(-256, 256, size=tuple(y_plane.shape)).astype(np.int16))
    q12 = torch.from_numpy(rng.integers(1, 65536, size=64).astype(np.int32)).to(dev)
    k4_check("random 12-bit, quant up to 65535", rand12.to(dev), q12, 2048)
    res12 = jtt.decode(extra["12-bit gray"][0])
    c12 = res12.coefficients[res12.geometry.components[0].component_index]
    k4_check("12-bit gray stream", torch.from_numpy(c12).to(dev),
             torch.from_numpy(quant_tables(res12)[0]).to(dev), 2048)

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    matrix = kernels.transform_matrix(dev)
    deq = (y_plane.reshape(-1, 64).to(torch.int32) * q_y).to(torch.float32)
    fns = (
        lambda: decode_stage.blocks_to_plane(
            decode_stage.dequantize_idct_shift_exact(y_plane, q_y, 128)),
        lambda: kernels.butterfly_idct_shift(y_plane, q_y, 128),
        lambda: torch.matmul(deq, matrix),
    )
    p_ev, k_ev, lib_ev = device_ms(*fns)
    warm = kernel_ms(*fns)
    cold = kernel_ms(*fns, flush=flush)
    del flush
    b_ms, b_by = k4_bound(n_blocks, 2)
    log(f"golden: K4 Y of slice image 0 ({n_blocks} blocks int16), CUDA events around each "
        f"call (launch gaps included): K4 {k_ev:.6f} ms, plain {p_ev:.6f} ms, torch.matmul "
        f"{lib_ev:.6f} ms (median of {TIMED_RUNS} in turns)")
    for what, (p_ms, k_ms, lib_ms) in (("warm", warm), ("L2 flushed", cold)):
        log(f"golden: K4 Y of slice image 0, {what}: K4 {k_ms:.6f} ms ({b_ms / k_ms:.1%} of its "
            f"{b_by} bound {b_ms:.6f} ms), plain (dct.idct8x8 in torch ops) {p_ms:.6f} ms, "
            f"torch.matmul of the dequantized fp32 blocks by the folded IDCT matrix {lib_ms:.6f} "
            "ms (the same transform, not bit-exact) (kernel time, mean of "
            f"{TIMED_RUNS} in turns)")
    p_ms, k_ms, lib_ms = cold
    log(f"golden: phase {time.perf_counter() - start:.3f} s")
    return {"name": "butterfly_idct_shift", "route": "cuda", "source": K4_SOURCE,
            "replaces": K4_REPLACES, "launches": launches, "max_abs_err": 0, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def step_inputs(datas):
    """``full_step``'s inputs from the host scans of ``datas`` (same
    geometry and tables): (Y, Cb, Cr) int16 coefficient planes stacked
    over the images, and the luma and chroma zig-zag quant tables."""
    from jpeglibrary_tpu_torch.models.decoder import quant_tables
    from jpeglibrary_tpu_torch.parallel.batch import scan

    results = [scan(d) for d in datas]
    comps = results[0].geometry.components
    planes = tuple(np.stack([r.coefficients[c.component_index] for r in results]).astype(np.int16)
                   for c in comps)
    q = quant_tables(results[0]).astype(np.int32)
    return planes, (q[0], q[1])


def scan_phase_only(dev):
    """``--phase device_scan``: the device scan phase alone, on sources
    made here (the slice's images, image 0 also by ``encode_420``), for
    development on the card; returns its records."""
    t0 = time.perf_counter()
    sources = [synth_image(seed, SIZE) for seed in range(N_IMAGES)]
    datas = [encode_420(sources[0], 75)]
    log(f"device scan only: {N_IMAGES} sources {SIZE}x{SIZE}, one encode_420 stream, "
        f"{time.perf_counter() - t0:.3f} s")
    return list(phase_device_scan(sources, datas, dev).values())


def step_phase_only(dev):
    """``--phase full_step``: the full-step phase alone (K5's checks, times
    and parts among it), on the slice's 8 images made and encoded here."""
    t0 = time.perf_counter()
    datas = [encode_420(synth_image(seed, SIZE), 75) for seed in range(N_IMAGES)]
    log(f"full step only: {N_IMAGES} sources {SIZE}x{SIZE} encoded, "
        f"{time.perf_counter() - t0:.3f} s")
    inputs = step_inputs(datas)
    records = list(phase_full_step(inputs, dev)[0].values())
    phase_full_step_422(inputs, dev)
    return records


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one GPU.")
    parser.add_argument("--phase", choices=("all", "device_scan", "full_step",
                                            "color_round_trip", "gray_step", "progressive_step"),
                        default="all",
                        help="run every phase (the default), or the device scan, the full-step, "
                             "the colour round trip, the gray step or the progressive step "
                             "phase alone")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        sys.exit(2)
    phase_environment()
    phase_build()
    dev = torch.device("cuda")
    if args.phase == "device_scan":
        kernel_records = scan_phase_only(dev)
    elif args.phase == "full_step":
        kernel_records = step_phase_only(dev)
    elif args.phase == "color_round_trip":
        kernel_records = phase_color_round_trip(dev)
    elif args.phase == "gray_step":
        kernel_records = phase_gray_step(dev)
    elif args.phase == "progressive_step":
        kernel_records = [phase_progressive_step(dev)]
    else:
        kernel_records = run_all(dev)
    print(json.dumps({"kernels": kernel_records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def run_all(dev):
    """Every phase after the build, in order; returns the kernels' records."""
    records = phase_kernel(dev)
    record_k2 = phase_kernel_fdct(dev)
    sl = phase_slice(records["k1"], dev)
    phase_batch(records, sl, dev)
    overlap_rates = phase_overlap(sl, dev)
    phase_wires(records, sl, dev)
    phase_thumbnails(records, sl, dev)
    phase_encode(record_k2, sl["sources"], dev)
    box_records = phase_k2_boxes(dev)
    phase_encode_boxes(box_records, sl["sources"], dev)
    cmyk_launches = phase_cmyk(sl["sources"], dev)
    phase_fancy_u16(sl, dev)
    stripe_launches = phase_stripes(sl, dev)
    scan_records = phase_device_scan(sl["sources"], sl["datas"], dev)
    inputs = step_inputs(sl["datas"])
    step_records, k6_launches = phase_full_step(inputs, dev)
    k6_launches_422 = phase_full_step_422(inputs, dev)
    records_k6 = phase_color_round_trip(dev, (k6_launches, k6_launches_422))
    gray_records = phase_gray_step(dev)
    record_k7 = phase_progressive_step(dev)
    phase_mesh(sl)
    record_k4 = phase_golden(sl, dev)
    log("stream MP/s by (group, device_workers): "
        + ", ".join(f"{k}: {r:.3f}" for k, r in overlap_rates.items()))
    log(f"K1 launches on the later paths: fancy {3 * N_IMAGES}, u16 {3 * N_IMAGES}, "
        f"stripes {stripe_launches}, full_step {step_records['k1']['launches']}; K2 on the "
        f"CMYK path {cmyk_launches}, full_step {step_records['k2']['launches']}; K5 on "
        f"full_step {step_records['k5']['launches']}")
    return [*records.values(), record_k2, *box_records.values(), *scan_records.values(),
            *step_records.values(), *records_k6, *gray_records, record_k7, record_k4]


if __name__ == "__main__":
    main()

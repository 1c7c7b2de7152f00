"""The port's six kernels and their wrappers.

K1, the decode transform: dequantize + un-zigzag + 2-D IDCT + round +
level shift over a batch of 8x8 blocks. Port of the decode half of
``jpeglibrary_tpu/ops/pallas_kernels.py``. The whole transform is linear
up to the rounding, so it is one product with a folded [64, 64] matrix
per block:

    samples[t, :] = rint( fl(coeff[t, :] * quant[:]) @ K ) + level_shift
    K[zz, 8*i+j]  = 0.125 * M[i, r(zz)] * M[j, c(zz)]

where M is the 1-D AAN IDCT butterfly written as a matrix and (r, c) the
natural position of zig-zag index zz. The scaled decode (1/2, 1/4, 1/8)
is the same product with the [64, n*n] reduced-IDCT matrix, which the
JAX package ran as n*n XLA matvecs; and a batch of images runs as one
launch with one quant table per image, where the JAX package vmapped K1.

:func:`dequantize_idct_shift` launches the hand-written CUDA kernel
(``csrc/dequant_idct.cu``) for a CUDA tensor, and takes the plain
PyTorch version (``decode_stage.dequantize_idct_shift``) only for a CPU
tensor. The Pallas wrapper padded to a 1024-block tile; the CUDA kernel,
a persistent grid that stages 128-block tiles asynchronously, masks its
ragged edge and nothing is padded.

:func:`dequantize_idct_plane` is K1 with another store: a batch of
one-component frames' blocks to their uint16 raster planes, each sample
clamped to the frame's precision (``csrc/dequant_idct.cu``
``dequant_idct_plane_kernel``; plain version
``decode_stage.dequantize_idct_shift`` -> ``decode_stage.clamp_plane_u16``).

K2, the encode transform: zero pad + box subsample + level shift + 2-D
FDCT + zig-zag + quantize, ``rint(((s - level_shift) @ F) / q)`` with F
the folded matrix of ``host.ops.encode_stage.fdct_zigzag_matrix``. Port
of the encode half of ``pallas_kernels.py``, with the pad and subsample
that the JAX package ran ahead of it fused in. :func:`fdct_quantize`
launches ``csrc/fdct_quant.cu`` on a CUDA plane, which reads the
unpadded [H, W] component plane itself and runs the product on the
tensor cores with an exact bf16 split of F (:func:`fdct_split`), and
takes the plain version (``encode_stage`` pad, subsample, fdct_quantize)
only for a CPU tensor.

K3, the entropy decode: the baseline Huffman decode of restart segments
into dense zig-zag coefficients. Port of
``jpeglibrary_tpu/ops/device_scan.py:121-245`` ``_compiled_decoder``, an
XLA ``while_loop`` (not Pallas) whose lanes were the segments.
:func:`huffman_scan` runs ``csrc/huffman_scan.cu`` on CUDA tensors, a
self-synchronising subsequence decoder (one thread per subsequence of
``HUFFMAN_SUB_BITS`` bits: sync rounds until every subsequence starts
where the one before it ends, then a write pass), and takes the plain
version (``device_scan.decode_segments_plain``) only for CPU tensors.
Its bound on the card is not bytes: each symbol is a chain of dependent
steps (a table lookup, the value bits, the next bit position), so a pass
costs the symbols of the longest subsequence, and the subsequences spread
even a stream without restart markers over thousands of threads.

K4, the bit-exact decode transform of one component plane: dequantize +
un-zigzag + the float32 AAN butterfly IDCT + rint + level shift, with
``blocks_to_plane`` fused into the store. Counterpart of the XLA
butterfly that ``JpegDecoder.decode(xp=jnp)`` runs
(``jpeglibrary_tpu/ops/decode_stage.py:32`` ``dequantize_idct_shift``
through ``ops/dct.py:167`` ``idct8x8``), not of a Pallas kernel: where K1
folds the IDCT into one product and is within 1 LSB, K4 repeats the
butterfly's operations in their order and equals the host numpy planes
(and the reference's golden fixtures) bit for bit.
:func:`butterfly_idct_shift` launches ``csrc/butterfly_idct.cu`` for a
CUDA tensor and takes the plain version
(``decode_stage.dequantize_idct_shift_exact`` -> ``blocks_to_plane``)
only for a CPU tensor.

K5, the symbol statistics: the DC and AC Huffman symbol histograms of
zig-zag blocks walked in MCU order, one DC predictor chain per row.
Counterpart of the XLA program of ``jpeglibrary_tpu/parallel/sharding.py:60``
``_mcu_order_batch`` + ``jpeglibrary_tpu/ops/encode_stage.py:330``
``symbol_histograms_device`` (not Pallas), which ``full_step``, the
sharded step and ``mesh_symbol_frequencies`` run.
:func:`symbol_histograms` launches ``csrc/symbol_hist.cu`` for a CUDA
tensor (component planes read where they lie: tiles of whole MCUs staged
through shared memory by bulk copies, a thread per block walking the set
bits of its non-zero mask, bins per warp in shared memory) and takes the
plain version (``encode_stage.symbol_histograms_plain``) only for a CPU
tensor; the results are integer sums and equal bit for bit.

K6, ``full_step``'s colour round trip: K1's int32 4:2:0 samples to the
step's RGB output and K2's three uint8 planes in one pass (layout, 2x2
chroma duplication, clamp, YCbCr -> RGB, RGB -> YCbCr). It replaces no
TPU kernel: the JAX step leaves these ops to XLA, which fuses them
(``jpeglibrary_tpu/parallel/sharding.py:70-117``).
:func:`color_round_trip` launches ``csrc/color_round_trip.cu`` for CUDA
tensors and takes the plain version (``color.round_trip_420_plain``, the
same chain in plain ops) only for CPU tensors; the two equal byte for
byte.

Every wrapper checks its inputs, picks its route with :func:`_on_cuda`
and launches through :func:`_launch`, the one place that loads the
library, passes the device's current stream, checks the C entry's return
code and counts the launch (K3's sync call reads its own).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..host.ops.decode_stage import fused_transform_matrix, scaled_folded_matrix
from ..host.ops.encode_stage import fdct_zigzag_matrix
from . import _build, color, decode_stage, device_scan, encode_stage


@functools.lru_cache(maxsize=16)
def transform_matrix(device: torch.device, n: int = 8) -> torch.Tensor:
    """K1's folded [64, n*n] matrix as a tensor on ``device`` (one copy per
    device and n): the full IDCT at n = 8, the scaled decode's reduced
    IDCT at n = 4, 2, 1."""
    if n == 8:
        return torch.from_numpy(fused_transform_matrix()).to(device)
    return torch.from_numpy(scaled_folded_matrix(n)).to(device)


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper, box=None, walk=None, **last) -> None:
    """One launch on ``wrapper.launches`` and, with ``box``, on
    ``wrapper.launches_by_box[box]``, with ``walk`` on
    ``wrapper.launches_by_walk[walk]``; ``last`` sets attributes that
    describe the launch (K3's ``rounds``). Under one lock: the stream's
    device workers launch from several threads, and ``+=`` on an
    attribute can lose a count between them."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        if box is not None:
            wrapper.launches_by_box[box] = wrapper.launches_by_box.get(box, 0) + 1
        if walk is not None:
            wrapper.launches_by_walk[walk] = wrapper.launches_by_walk.get(walk, 0) + 1
        for name, value in last.items():
            setattr(wrapper, name, value)


def _on_cuda(device: torch.device, label: str) -> bool:
    """Where a wrapper runs: False on the CPU (its plain version), True on
    a CUDA device (its kernel, ``label``); raises on any other device."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"no {label} kernel for device {device}")
    return True


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or where it starts off a 16-byte boundary (a view into a
    larger tensor) a copy in a fresh, aligned allocation: the kernels copy
    and load 16 bytes at a time."""
    return t.clone() if t.data_ptr() % 16 else t


def _launch(label: str, wrapper, entry: str, device: torch.device, *args, box=None,
            walk=None, **last) -> None:
    """One call of the library's C entry ``entry`` with ``args`` and the
    current stream of ``device``, under that device's guard. Raises
    RuntimeError on a non-zero return code, else counts the launch on
    ``wrapper`` (``box``, ``walk`` and ``last`` as :func:`count_launch`
    takes them)."""
    fn = getattr(_build.load_library(), entry)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{label} launch failed: CUDA error {err}")
    count_launch(wrapper, box=box, walk=walk, **last)


def dequantize_idct_shift(coeffs_zz: torch.Tensor, quants_zz: torch.Tensor,
                          level_shift: int, *, blocks_per_table: Optional[int] = None,
                          scale_n: int = 8) -> torch.Tensor:
    """[..., 64] zig-zag int32 (or int16) coefficients + int32 zig-zag
    quant tables -> int32 samples [..., n, n], n = ``scale_n``.

    ``quants_zz`` is one [64] table, or [G, 64] tables of which block t
    (in the flattened order of the leading dimensions) takes row
    ``t // blocks_per_table``: a batch of G images that each carry their
    own tables runs as one launch. ``scale_n`` 4, 2 or 1 gives the
    scaled decode's reduced blocks.

    ``dequantize_idct_shift.launches`` counts the CUDA kernel's launches."""
    if coeffs_zz.dtype not in (torch.int32, torch.int16):
        raise TypeError(f"coefficients must be int32 or int16, got {coeffs_zz.dtype}")
    if coeffs_zz.dim() < 1 or coeffs_zz.shape[-1] != 64:
        raise ValueError(f"coefficients must be [..., 64], got {tuple(coeffs_zz.shape)}")
    if (quants_zz.dtype != torch.int32 or quants_zz.dim() not in (1, 2)
            or quants_zz.shape[-1] != 64):
        raise ValueError(
            f"quant must be int32 [64] or [G, 64], got {quants_zz.dtype} "
            f"{tuple(quants_zz.shape)}"
        )
    if quants_zz.device != coeffs_zz.device:
        raise ValueError(
            f"quant on {quants_zz.device}, coefficients on {coeffs_zz.device}"
        )
    if scale_n not in (8, 4, 2, 1):
        raise ValueError(f"scale_n must be 8, 4, 2 or 1, got {scale_n}")
    n_blocks = coeffs_zz.numel() // 64
    n_tables = quants_zz.numel() // 64
    if blocks_per_table is None:
        if n_tables != 1:
            raise ValueError(f"{n_tables} quant tables need blocks_per_table")
        blocks_per_table = max(n_blocks, 1)
    if blocks_per_table < 1 or n_tables * blocks_per_table < n_blocks:
        raise ValueError(
            f"{n_tables} tables of {blocks_per_table} blocks do not cover {n_blocks} blocks"
        )
    device = coeffs_zz.device
    matrix = transform_matrix(device, scale_n)
    shape = coeffs_zz.shape[:-1] + (scale_n, scale_n)
    if not _on_cuda(device, "K1"):
        return decode_stage.dequantize_idct_shift(
            coeffs_zz, quants_zz, blocks_per_table, level_shift, matrix).reshape(shape)
    if not (coeffs_zz.is_contiguous() and quants_zz.is_contiguous()):
        raise ValueError("coefficients and quant must be contiguous")

    out = torch.empty(shape, dtype=torch.int32, device=device)
    if n_blocks == 0:
        return out
    coeffs_zz, quants_zz = _aligned(coeffs_zz), _aligned(quants_zz)
    entry = "jpx_dequant_idct_i32" if coeffs_zz.dtype == torch.int32 else "jpx_dequant_idct_i16"
    _launch("K1", dequantize_idct_shift, entry, device,
            coeffs_zz.data_ptr(), quants_zz.data_ptr(), matrix.data_ptr(), out.data_ptr(),
            n_blocks, blocks_per_table, scale_n * scale_n, int(level_shift))
    return out


dequantize_idct_shift.launches = 0

PRECISIONS = (8, 12)  # the sample precisions of T.81's DCT processes


def dequantize_idct_plane(coeffs_zz: torch.Tensor, quant_zz: torch.Tensor,
                          precision: int) -> torch.Tensor:
    """int16 zig-zag coefficients [B, Hb, Wb, 64] of a batch of one-component
    frames + their int32 zig-zag quant table [64] -> the decoded planes,
    uint16 [B, 8 Hb, 8 Wb]: K1's transform, the level shift 2^(P - 1) and
    the clamp to [0, 2^P - 1] of the frames' sample precision P
    (``precision``, 8 or 12), in raster order.

    On a CPU tensor it runs the plain version
    (``decode_stage.dequantize_idct_shift`` -> ``clamp_plane_u16``); on a
    CUDA tensor it launches ``csrc/dequant_idct.cu``'s plane store, or
    raises: on any dtype or shape but those above, and on coefficients or a
    table that are not contiguous or do not start on a 16-byte boundary.
    ``dequantize_idct_plane.launches`` counts the kernel's launches."""
    if coeffs_zz.dtype != torch.int16:
        raise TypeError(f"coefficients must be int16, got {coeffs_zz.dtype}")
    if coeffs_zz.dim() != 4 or coeffs_zz.shape[-1] != 64:
        raise ValueError(f"coefficients must be [B, Hb, Wb, 64], got {tuple(coeffs_zz.shape)}")
    if quant_zz.dtype != torch.int32 or tuple(quant_zz.shape) != (64,):
        raise ValueError(f"quant must be int32 [64], got {quant_zz.dtype} "
                         f"{tuple(quant_zz.shape)}")
    if quant_zz.device != coeffs_zz.device:
        raise ValueError(f"quant on {quant_zz.device}, coefficients on {coeffs_zz.device}")
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision}")
    b, hb, wb = coeffs_zz.shape[:3]
    level_shift, max_sample = 1 << (precision - 1), (1 << precision) - 1
    n_blocks = b * hb * wb
    device = coeffs_zz.device
    matrix = transform_matrix(device)
    if not _on_cuda(device, "K1"):
        samples = decode_stage.dequantize_idct_shift(coeffs_zz, quant_zz, max(n_blocks, 1),
                                                     level_shift, matrix)
        return decode_stage.clamp_plane_u16(samples.reshape(b, hb, wb, 8, 8), precision)
    for name, t in (("coefficients", coeffs_zz), ("quant", quant_zz)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:  # the kernel copies and loads 16 bytes at a time
            raise ValueError(f"{name} must start on a 16-byte boundary")

    out = torch.empty((b, hb * 8, wb * 8), dtype=torch.uint16, device=device)
    if n_blocks == 0:
        return out
    _launch("K1 plane", dequantize_idct_plane, "jpx_dequant_idct_plane_u16", device,
            coeffs_zz.data_ptr(), quant_zz.data_ptr(), matrix.data_ptr(), out.data_ptr(),
            n_blocks, n_blocks, wb, level_shift, max_sample)
    return out


dequantize_idct_plane.launches = 0


@functools.lru_cache(maxsize=16)
def fdct_matrix(device: torch.device) -> torch.Tensor:
    """K2's folded FDCT + zig-zag matrix on ``device`` (one copy per device)."""
    return torch.from_numpy(fdct_zigzag_matrix()).to(device)


def fdct_split() -> torch.Tensor:
    """The exact three-way bf16 split of K2's fp32 matrix F, [3, 64, 64]
    (part, position, zig-zag): F1 = bf16(F), F2 = bf16(F - F1),
    F3 = F - F1 - F2. F has 24 significant bits and bf16 8 with fp32's
    exponent range, so F3 is exact in bf16 and F1 + F2 + F3 == F; both
    are asserted in float64."""
    f = torch.from_numpy(fdct_zigzag_matrix().astype(np.float64))
    f1 = f.to(torch.bfloat16)
    f2 = (f - f1.double()).to(torch.bfloat16)
    f3 = (f - f1.double() - f2.double()).to(torch.bfloat16)
    parts = torch.stack([f1, f2, f3])
    if not torch.equal(parts.double().sum(0), f) or not torch.equal(
            parts.double()[2], f - f1.double() - f2.double()):
        raise AssertionError("the bf16 split of the FDCT matrix is not exact")
    return parts


@functools.lru_cache(maxsize=16)
def fdct_split_operand(device: torch.device) -> torch.Tensor:
    """:func:`fdct_split` as the kernel reads it: bf16 [3, 64, 64]
    (part, zig-zag, position), each zig-zag column's 64 positions
    contiguous (the B operand's column-major layout), on ``device``."""
    return fdct_split().transpose(1, 2).contiguous().to(device)


BOX_FACTORS = ((1, 2, 3, 4), (1, 2, 3, 4))  # the hs and vs K2 takes, as T.81 allows


def fdct_quantize(plane: torch.Tensor, quant_zz: torch.Tensor, level_shift: int, *,
                  hs: int = 1, vs: int = 1,
                  blocks: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """[H, W] uint8 (or uint16, or int32) component plane + [64] int32 zig-zag quant
    -> int16 zig-zag coefficients [hb, wb, 64]: the plane zero-padded to
    ``hb * 8 * vs`` rows and ``wb * 8 * hs`` columns, box-subsampled by
    (hs, vs) with ``(sum + n // 2) // n``, n = hs * vs, then level
    shift, FDCT, zig-zag and quantize.

    ``blocks`` is (hb, wb), the component's block grid (by default the
    least that covers the plane). hs and vs are each 1 to 4, the box
    factors ``max_h // h`` and ``max_v // v`` that T.81's sampling factors
    give; ``//`` floors, as the JAX package's int32 division does, for a
    negative box sum too. int32 samples must lie within 2^16 of
    ``level_shift`` (the 8- and 12-bit precisions do), where the kernel's
    bf16 split is exact. uint16 samples (K1's planes of one-component
    frames, ``dequantize_idct_plane``) take the 1x1 box only.

    On a CPU plane it runs the plain version, ``encode_stage.pad_to_grid``
    -> ``subsample_box`` -> ``fdct_quantize``; on a CUDA plane it launches
    ``csrc/fdct_quant.cu``, which fuses the pad and the box into its load,
    or raises. ``fdct_quantize.launches`` counts the kernel's launches,
    ``fdct_quantize.launches_by_box`` the same launches by (sample dtype,
    hs, vs), one instantiation of the kernel each, and
    ``fdct_quantize.launches_by_walk`` by the walk the launch took
    (:func:`fdct_walk`)."""
    if plane.dtype not in (torch.int32, torch.uint16, torch.uint8):
        raise TypeError(f"samples must be int32, uint16 or uint8, got {plane.dtype}")
    if plane.dim() != 2:
        raise ValueError(f"samples must be one [H, W] plane, got {tuple(plane.shape)}")
    if not plane.is_contiguous():
        raise ValueError("the sample plane must be contiguous")
    if hs not in BOX_FACTORS[0] or vs not in BOX_FACTORS[1]:
        raise ValueError(f"(hs, vs) must be in {BOX_FACTORS[0]} x {BOX_FACTORS[1]}, "
                         f"got ({hs}, {vs})")
    if plane.dtype == torch.uint16 and (hs, vs) != (1, 1):
        raise ValueError(f"uint16 samples take the 1x1 box only, got ({hs}, {vs})")
    if not 0 <= level_shift <= 1 << 15:
        raise ValueError(f"level_shift must be in [0, 32768], got {level_shift}")
    h, w = plane.shape
    if blocks is None:
        blocks = (-(-h // (8 * vs)), -(-w // (8 * hs)))
    hb, wb = (int(b) for b in blocks)
    if hb < 0 or wb < 0 or hb * 8 * vs < h or wb * 8 * hs < w:
        raise ValueError(f"{hb} x {wb} blocks at ({hs}, {vs}) do not cover a {h} x {w} plane")
    if quant_zz.dtype != torch.int32 or tuple(quant_zz.shape) != (64,):
        raise ValueError(
            f"quant must be int32 [64], got {quant_zz.dtype} {tuple(quant_zz.shape)}"
        )
    if quant_zz.device != plane.device:
        raise ValueError(f"quant on {quant_zz.device}, samples on {plane.device}")
    device = plane.device
    if not _on_cuda(device, "K2"):
        padded = encode_stage.pad_to_grid(plane, hb * 8 * vs, wb * 8 * hs)
        return encode_stage.fdct_quantize(encode_stage.subsample_box(padded, hs, vs),
                                          quant_zz, level_shift, fdct_matrix(device))
    if not quant_zz.is_contiguous():
        raise ValueError("quant must be contiguous")

    out = torch.empty((hb, wb, 64), dtype=torch.int16, device=device)
    if out.numel() == 0:
        return out
    split = fdct_split_operand(device)
    entry = {torch.int32: "jpx_fdct_quant_i32", torch.uint16: "jpx_fdct_quant_u16",
             torch.uint8: "jpx_fdct_quant_u8"}[plane.dtype]
    _launch("K2", fdct_quantize, entry, device,
            plane.data_ptr(), quant_zz.data_ptr(), split.data_ptr(), out.data_ptr(),
            h, w, hb, wb, hs, vs, int(level_shift), box=(plane.dtype, hs, vs),
            walk=fdct_walk(plane.element_size(), hs, vs, int(level_shift)))
    return out


fdct_quantize.launches = 0
fdct_quantize.launches_by_box = {}
fdct_quantize.launches_by_walk = {}


@functools.lru_cache(maxsize=64)
def fdct_walk(sample_bytes: int, hs: int, vs: int, level_shift: int) -> str:
    """The walk K2's kernel takes for samples of ``sample_bytes`` bytes at
    the (hs, vs) box and ``level_shift``, as the library decides it at
    compile time from the strip's size: ``"warpgroups"``, where each
    warpgroup walks its own strips and multiplies them with wgmma, or
    ``"rounds"``, the CTA walk of lock-step rounds that keeps the strips too
    large for the warpgroups' rings (and 8-bit samples at a level shift past
    256, which need a second A pass)."""
    code = _build.load_library().jpx_fdct_quant_walk(sample_bytes, hs, vs, level_shift)
    if code not in (0, 1):
        raise ValueError(f"K2 takes no {sample_bytes}-byte samples at ({hs}, {vs})")
    return "warpgroups" if code == 1 else "rounds"


SCAN_MAX_COMPS = 4  # components in one scan (T.81 B.2.3)
SCAN_MAX_BPM = 10  # blocks in one MCU (T.81 B.2.3)


#: K3's subsequence length in bits: the fastest of 512, 1,024 and 2,048 on
#: an H100 (PERF.md).
HUFFMAN_SUB_BITS = 2048


def huffman_scan(buf: torch.Tensor, comp_of: torch.Tensor, mcu_counts: torch.Tensor,
                 lookahead: torch.Tensor, maxcode: torch.Tensor, valoffset: torch.Tensor,
                 values: torch.Tensor, *, max_blocks: int,
                 sub_bits: int = HUFFMAN_SUB_BITS) -> torch.Tensor:
    """uint8 [S, W] unstuffed, 0xFF-padded restart segments -> int32
    [S, max_blocks * 64] zig-zag coefficients, each segment's blocks in
    MCU order from its row's start and zeros after them.

    ``comp_of`` int32 [bpm] is the component of each block of an MCU,
    ``mcu_counts`` int32 [S] each segment's MCUs, and the int32 tables
    lookahead [T, 256], maxcode [T, 18], valoffset [T, 19] and values
    [T, 256] are ``device_scan.prepare_scan``'s, T = 2 * components (DC
    table at 2i, AC at 2i + 1). Every predictor starts at 0 in every
    segment.

    On CPU tensors it runs the plain version
    (``device_scan.decode_segments_plain``). On CUDA tensors it runs
    ``csrc/huffman_scan.cu``, the subsequence decoder, or raises: each row
    cut into subsequences of ``sub_bits`` bits, the sync rounds
    (``jpx_huffman_sync``, which reads a 4-byte flag after each round and
    so synchronises the stream), the offsets (``device_scan.
    subsequence_offsets``) and the write pass into a zeroed output
    (``jpx_huffman_write``); ``device_scan.decode_segments_split_plain`` is
    its CPU model. ``huffman_scan.launches`` counts the calls that ran the
    kernels, ``huffman_scan.rounds`` holds the last such call's sync
    rounds."""
    tables = (lookahead, maxcode, valoffset, values)
    if buf.dtype != torch.uint8 or buf.dim() != 2 or buf.shape[1] < 1:
        raise ValueError(f"segments must be uint8 [S, W], got {buf.dtype} {tuple(buf.shape)}")
    n_segs = buf.shape[0]
    n_tables = lookahead.shape[0] if lookahead.dim() == 2 else 0
    for name, t, width in zip(("lookahead", "maxcode", "valoffset", "values"), tables,
                              (256, 18, 19, 256)):
        if t.dtype != torch.int32 or tuple(t.shape) != (n_tables, width):
            raise ValueError(f"{name} must be int32 [{n_tables}, {width}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if n_tables % 2 or not 1 <= n_tables // 2 <= SCAN_MAX_COMPS:
        raise ValueError(f"{n_tables} tables are not one DC and one AC table for 1 to "
                         f"{SCAN_MAX_COMPS} components")
    if comp_of.dtype != torch.int32 or comp_of.dim() != 1 or not 1 <= comp_of.shape[0] <= SCAN_MAX_BPM:
        raise ValueError(f"comp_of must be int32 [1..{SCAN_MAX_BPM}], got {comp_of.dtype} "
                         f"{tuple(comp_of.shape)}")
    if mcu_counts.dtype != torch.int32 or tuple(mcu_counts.shape) != (n_segs,):
        raise ValueError(f"mcu_counts must be int32 [{n_segs}], got {mcu_counts.dtype} "
                         f"{tuple(mcu_counts.shape)}")
    if max_blocks < 1:
        raise ValueError(f"max_blocks must be at least 1, got {max_blocks}")
    if sub_bits < 8:
        raise ValueError(f"sub_bits must be at least 8, got {sub_bits}")
    device = buf.device
    for t in (comp_of, mcu_counts, *tables):
        if t.device != device:
            raise ValueError(f"a table on {t.device}, the segments on {device}")
    if not _on_cuda(device, "K3"):
        return device_scan.decode_segments_plain(buf, comp_of, mcu_counts, *tables, max_blocks)
    if not all(t.is_contiguous() for t in (buf, comp_of, mcu_counts, *tables)):
        raise ValueError("the segments and tables must be contiguous")

    out = torch.zeros((n_segs, max_blocks * 64), dtype=torch.int32, device=device)
    if n_segs == 0:
        return out
    n_comps = n_tables // 2
    n_sub = device_scan.subsequence_count(buf.shape[1], sub_bits)
    total = n_segs * n_sub

    def scratch(dtype, n):
        return torch.zeros(n, dtype=dtype, device=device)

    starts, exits = scratch(torch.int64, total), scratch(torch.int64, 2 * total)
    n_blk, dsum = scratch(torch.int64, total), scratch(torch.int32, total * n_comps)
    flag = scratch(torch.int32, 1)
    rounds = ctypes.c_int(0)
    shape = (buf.data_ptr(), buf.shape[1], n_segs, n_sub, sub_bits, comp_of.data_ptr(),
             comp_of.shape[0], n_comps)
    with torch.cuda.device(device):
        # The one call that reads its return code itself, and not through
        # _launch: besides a CUDA error it returns -1 when the rounds do not
        # settle.
        err = _build.load_library().jpx_huffman_sync(
            *shape, *(t.data_ptr() for t in tables), starts.data_ptr(), exits.data_ptr(),
            n_blk.data_ptr(), dsum.data_ptr(), flag.data_ptr(), ctypes.byref(rounds),
            torch.cuda.current_stream(device).cuda_stream)
        if err == -1:
            raise RuntimeError(f"K3's sync rounds did not settle in {n_sub} rounds")
        if err != 0:
            raise RuntimeError(f"K3 sync launch failed: CUDA error {err}")
        block0, pred0 = device_scan.subsequence_offsets(n_blk.view(n_segs, n_sub),
                                                        dsum.view(n_segs, n_sub, n_comps))
        block0, pred0 = block0.contiguous(), pred0.contiguous()
    _launch("K3 write", huffman_scan, "jpx_huffman_write", device,
            *shape, mcu_counts.data_ptr(), *(t.data_ptr() for t in tables), starts.data_ptr(),
            block0.data_ptr(), pred0.data_ptr(), out.data_ptr(), max_blocks,
            rounds=rounds.value)
    return out


huffman_scan.launches = 0
huffman_scan.rounds = 0


def butterfly_idct_shift(coeffs_zz: torch.Tensor, quant_zz: torch.Tensor,
                         level_shift: int) -> torch.Tensor:
    """[Hb, Wb, 64] zig-zag int16 (or int32) coefficients + [64] int32
    zig-zag quant table -> the int32 sample plane [Hb*8, Wb*8]: the int32
    product, its float32 conversion, the butterfly IDCT of ``ops/dct.py``,
    rint (half to even) and the level shift, bit for bit the JAX package's
    ``dequantize_idct_shift`` + ``blocks_to_plane`` (quant entries up to
    65,535 and coefficients of int16 keep the product within int32).

    On a CPU tensor it runs the plain version
    (``decode_stage.dequantize_idct_shift_exact`` -> ``blocks_to_plane``);
    on a CUDA tensor it launches ``csrc/butterfly_idct.cu``, or raises.
    ``butterfly_idct_shift.launches`` counts the kernel's launches."""
    if coeffs_zz.dtype not in (torch.int32, torch.int16):
        raise TypeError(f"coefficients must be int32 or int16, got {coeffs_zz.dtype}")
    if coeffs_zz.dim() != 3 or coeffs_zz.shape[-1] != 64:
        raise ValueError(f"coefficients must be [Hb, Wb, 64], got {tuple(coeffs_zz.shape)}")
    if quant_zz.dtype != torch.int32 or tuple(quant_zz.shape) != (64,):
        raise ValueError(
            f"quant must be int32 [64], got {quant_zz.dtype} {tuple(quant_zz.shape)}"
        )
    if quant_zz.device != coeffs_zz.device:
        raise ValueError(f"quant on {quant_zz.device}, coefficients on {coeffs_zz.device}")
    device = coeffs_zz.device
    hb, wb = coeffs_zz.shape[0], coeffs_zz.shape[1]
    if not _on_cuda(device, "K4"):
        return decode_stage.blocks_to_plane(
            decode_stage.dequantize_idct_shift_exact(coeffs_zz, quant_zz, level_shift))
    if not (coeffs_zz.is_contiguous() and quant_zz.is_contiguous()):
        raise ValueError("coefficients and quant must be contiguous")

    out = torch.empty((hb * 8, wb * 8), dtype=torch.int32, device=device)
    if out.numel() == 0:
        return out
    coeffs_zz = _aligned(coeffs_zz)
    entry = ("jpx_butterfly_idct_i32" if coeffs_zz.dtype == torch.int32
             else "jpx_butterfly_idct_i16")
    _launch("K4", butterfly_idct_shift, entry, device,
            coeffs_zz.data_ptr(), quant_zz.data_ptr(), out.data_ptr(), hb * wb, wb,
            int(level_shift))
    return out


butterfly_idct_shift.launches = 0


def symbol_histograms(blocks, n_valid: Optional[torch.Tensor] = None,
                      prev_dc: Optional[torch.Tensor] = None, *,
                      mcu=(1, 1)) -> Tuple[torch.Tensor, torch.Tensor]:
    """int16 (or int32) zig-zag blocks -> (dc_freq [256], ac_freq [256])
    int32 Huffman symbol histograms summed over their R chains:
    ``encode_stage.symbol_histograms_plain``'s result. ``blocks`` is any
    form of ``encode_stage.k5_planes``: [B, N, 64] blocks in walk order,
    a [B, Hb, Wb, 64] component plane walked in the interleaved order of
    an ``mcu`` = (h, v) MCU where it lies (``full_step``'s luma at (2,
    2)), or a tuple of up to 4 planes of one shape whose chains stack
    (its Cb and Cr). ``n_valid`` [R] counts the real blocks of each chain
    (the rest count nothing); ``prev_dc`` [R] is the DC before each
    chain's first block (0 without it). Both, where given, lie on the
    blocks' device.

    On a CPU tensor it runs the plain version; on a CUDA tensor it
    launches ``csrc/symbol_hist.cu``, or raises.
    ``symbol_histograms.launches`` counts the kernel's launches."""
    planes, h, v = encode_stage.k5_planes(blocks, mcu)
    device = planes[0].device
    b, hb, wb = planes[0].shape[:3]
    rows = len(planes) * b
    for name, t in (("n_valid", n_valid), ("prev_dc", prev_dc)):
        if t is None:
            continue
        if not torch.is_tensor(t):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, blocks on {device}")
        if tuple(t.shape) != (rows,) or t.is_floating_point() or t.is_complex():
            raise ValueError(f"{name} must be an integer [{rows}], got {t.dtype} {tuple(t.shape)}")
    if not _on_cuda(device, "K5"):
        return encode_stage.symbol_histograms_plain(blocks, n_valid, prev_dc, mcu=mcu)
    if not all(x.is_contiguous() for x in planes):
        raise ValueError("blocks must be contiguous")

    out = torch.zeros((2, 256), dtype=torch.int32, device=device)
    if rows * hb * wb == 0:
        return out[0], out[1]
    planes = [_aligned(x) for x in planes]
    if n_valid is not None:
        n_valid = n_valid.clamp(0, hb * wb).to(torch.int32).contiguous()
    if prev_dc is not None:
        prev_dc = prev_dc.to(torch.int32).contiguous()
    ptrs = [x.data_ptr() for x in planes] + [None] * (encode_stage.MAX_PLANES - len(planes))
    entry = ("jpx_symbol_histograms_i32" if planes[0].dtype == torch.int32
             else "jpx_symbol_histograms_i16")
    _launch("K5", symbol_histograms, entry, device,
            *ptrs, len(planes), b, hb, wb, h, v,
            None if n_valid is None else n_valid.data_ptr(),
            None if prev_dc is None else prev_dc.data_ptr(), out.data_ptr())
    return out[0], out[1]


symbol_histograms.launches = 0


@functools.lru_cache(maxsize=1)
def _round_trip_constants():
    """``color.ROUND_TRIP_CONSTANTS`` as the int32 array K6's C entry copies
    into its launch."""
    return (ctypes.c_int32 * len(color.ROUND_TRIP_CONSTANTS))(*color.ROUND_TRIP_CONSTANTS)


def color_round_trip(y_samples: torch.Tensor, cb_samples: torch.Tensor,
                     cr_samples: torch.Tensor):
    """K1's int32 samples of a batch of 4:2:0 images, luma [B, Hb, Wb, 8,
    8] and each chroma [B, Hb/2, Wb/2, 8, 8] (Hb and Wb even) -> (rgb
    uint8 [B, H, W, 3], y, cb, cr uint8 [B, H, W]), H = 8 Hb, W = 8 Wb:
    the chroma duplicated 2x2, every sample clamped to [0, 255], the
    fixed-point YCbCr -> RGB and RGB -> YCbCr of ``ops/color.py``. The
    RGB is ``full_step``'s output, the three planes what K2 takes.

    On CPU tensors it runs the plain version,
    ``color.round_trip_420_plain``; on CUDA tensors it launches
    ``csrc/color_round_trip.cu``, or raises. Raises on any dtype but
    int32, on a shape that is not 4:2:0 blocks (chroma not [B, Hb/2,
    Wb/2, 8, 8], Hb or Wb odd) and on non-contiguous samples or samples
    that do not start on a 16-byte boundary.
    ``color_round_trip.launches`` counts the kernel's launches."""
    samples = (y_samples, cb_samples, cr_samples)
    for name, s in zip(("y", "cb", "cr"), samples):
        if s.dtype != torch.int32:
            raise TypeError(f"{name} samples must be int32, got {s.dtype}")
        if s.dim() != 5 or tuple(s.shape[-2:]) != (8, 8):
            raise ValueError(f"{name} samples must be [B, Hb, Wb, 8, 8] blocks, got "
                             f"{tuple(s.shape)}")
        if not s.is_contiguous():
            raise ValueError(f"{name} samples must be contiguous")
        if s.data_ptr() % 16:  # the kernel loads 16 bytes at a time
            raise ValueError(f"{name} samples must start on a 16-byte boundary")
        if s.device != y_samples.device:
            raise ValueError(f"{name} samples on {s.device}, luma on {y_samples.device}")
    b, hb, wb = y_samples.shape[:3]
    if hb % 2 or wb % 2:
        raise ValueError(f"{hb} x {wb} luma blocks are no whole 4:2:0 MCUs")
    for name, s in (("cb", cb_samples), ("cr", cr_samples)):
        if tuple(s.shape[:3]) != (b, hb // 2, wb // 2):
            raise ValueError(f"{name} samples must be [{b}, {hb // 2}, {wb // 2}, 8, 8] "
                             f"(4:2:0), got {tuple(s.shape)}")
    device = y_samples.device
    if not _on_cuda(device, "K6"):
        return color.round_trip_420_plain(*samples)

    h, w = hb * 8, wb * 8
    rgb = torch.empty((b, h, w, 3), dtype=torch.uint8, device=device)
    planes = [torch.empty((b, h, w), dtype=torch.uint8, device=device) for _ in range(3)]
    if rgb.numel() == 0:
        return (rgb, *planes)
    _launch("K6", color_round_trip, "jpx_color_round_trip", device,
            *(s.data_ptr() for s in samples), rgb.data_ptr(), *(p.data_ptr() for p in planes),
            b * hb // 2, wb // 2, ctypes.addressof(_round_trip_constants()))
    return (rgb, *planes)


color_round_trip.launches = 0

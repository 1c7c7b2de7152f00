"""Baseline (SOF0/SOF1) Huffman entropy decode: ECS bitstream ->
dense zig-zag coefficient planes.

Behavioral parity with the reference hot path
(yigolden/JpegLibrary/src/JpegLibrary/ScanDecoder/JpegHuffmanBaselineScanDecoder.cs:51-225
 and JpegHuffmanScanDecoder.cs:81-117), restructured for the TPU
pipeline: entropy decode is a *separate stage* producing coefficient
tensors; dequantization/IDCT/level-shift run as batched device kernels
afterwards (see jpeglibrary_tpu_torch.host.ops.decode_stage).

This module is the pure-Python reference scanner. The production path
uses the native C++ scanner (jpeglibrary_tpu_torch.host.native) with identical
semantics; tests assert they agree bit-for-bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..io.bitreader import BitReader, EndOfStream, MarkerEncountered
from ..io.reader import EntropySpan, unstuff_entropy_bytes
from ..syntax.frame import FrameHeader, ScanHeader, resolve_scan_components
from ..syntax.huffman import HuffmanDecodingTable
from ..syntax.markers import Marker, is_restart_marker
from .geometry import FrameGeometry, frame_geometry


class JpegDecodeError(ValueError):
    pass


def extend(v: int, nbits: int) -> int:
    """ITU-T T.81 EXTEND, branchless form (JpegHuffmanScanDecoder.cs:114)."""
    return v - ((((v + v) >> nbits) - 1) & ((1 << nbits) - 1))


def decode_huffman_code(reader: BitReader, table: HuffmanDecodingTable) -> int:
    """Decode one Huffman symbol (JpegHuffmanScanDecoder.cs:81-88)."""
    bits, available = reader.peek_bits(16)
    size, value = table.lookup(bits)
    reader.advance(min(size, available))
    return value


def receive_and_extend(reader: BitReader, length: int) -> int:
    """Read `length` magnitude bits and sign-extend (JpegHuffmanScanDecoder.cs:100)."""
    try:
        value = reader.read_bits(length)
    except MarkerEncountered:
        raise JpegDecodeError(
            "Expect raw data from bit stream. Yet a marker is encountered."
        )
    except EndOfStream:
        raise JpegDecodeError("The bit stream ended prematurely.")
    return extend(value, length)


def read_block_baseline(
    reader: BitReader,
    dc_table: HuffmanDecodingTable,
    ac_table: HuffmanDecodingTable,
    dc_predictor: int,
) -> tuple[np.ndarray, int]:
    """Decode one 8x8 block's coefficients (zig-zag order).

    Returns (int16[64] block, new_dc_predictor). Mirrors
    ReadBlockBaseline (JpegHuffmanBaselineScanDecoder.cs:179-223)
    including the Min(i, 63) index clamp for corrupt streams.
    """
    block = np.zeros(64, dtype=np.int16)

    # DC
    t = decode_huffman_code(reader, dc_table)
    if t != 0:
        t = receive_and_extend(reader, t)
    t += dc_predictor
    # The block stores (short)t — wrap to int16 — while the predictor
    # itself accumulates unwrapped (DcPredictor is a C# int).
    block[0] = ((t & 0xFFFF) ^ 0x8000) - 0x8000

    # AC
    i = 1
    while i < 64:
        s = decode_huffman_code(reader, ac_table)
        r = s >> 4
        s &= 15
        if s != 0:
            i += r
            s = receive_and_extend(reader, s)
            block[min(i, 63)] = s
            i += 1
        else:
            if r == 0:
                break
            i += 16
    return block, t


def decode_baseline_scan(
    data: bytes,
    spans: Sequence[EntropySpan],
    frame: FrameHeader,
    scan: ScanHeader,
    dc_tables: Dict[int, HuffmanDecodingTable],
    ac_tables: Dict[int, HuffmanDecodingTable],
    restart_interval: int,
    coefficient_planes: Dict[int, np.ndarray],
    geometry: Optional[FrameGeometry] = None,
) -> None:
    """Decode one baseline scan into the coefficient planes (in place).

    The MCU walk is the interleaved loop of the reference
    (JpegHuffmanBaselineScanDecoder.cs:99-165): every scan is treated as
    interleaved over the scan's components on the *frame's* MCU grid,
    with RSTn boundaries resetting DC predictors and (here) switching to
    the next pre-split entropy span.
    """
    geo = geometry or frame_geometry(frame)
    resolved = resolve_scan_components(frame, scan)

    comps = []
    for comp_index, fc, sc in resolved:
        dc = dc_tables.get(sc.dc_table_selector)
        ac = ac_tables.get(sc.ac_table_selector)
        if dc is None or ac is None:
            raise JpegDecodeError(
                f"Huffman table of component {comp_index} is not defined."
            )
        cg = geo.components[comp_index]
        comps.append(
            {
                "index": comp_index,
                "h": cg.h,
                "v": cg.v,
                "dc": dc,
                "ac": ac,
                "predictor": 0,
                "plane": coefficient_planes[comp_index],
            }
        )

    span_idx = 0
    reader = BitReader(unstuff_entropy_bytes(data[spans[0].start : spans[0].end]))
    mcus_before_restart = restart_interval

    for row_mcu in range(geo.mcus_per_column):
        for col_mcu in range(geo.mcus_per_line):
            for comp in comps:
                h, v = comp["h"], comp["v"]
                plane = comp["plane"]
                for y in range(v):
                    by = row_mcu * v + y
                    for x in range(h):
                        bx = col_mcu * h + x
                        block, comp["predictor"] = read_block_baseline(
                            reader, comp["dc"], comp["ac"], comp["predictor"]
                        )
                        plane[by, bx, :] = block

            # Restart handling (JpegHuffmanBaselineScanDecoder.cs:140-163).
            if restart_interval > 0:
                mcus_before_restart -= 1
                if mcus_before_restart == 0:
                    terminator = spans[span_idx].terminator
                    if terminator == Marker.EOI or terminator is None:
                        return  # tolerated truncation
                    if not is_restart_marker(terminator):
                        # Tolerate a non-restart terminator ONLY when the
                        # boundary coincides with the scan end (libjpeg
                        # tolerance; see huffman_progressive). Mid-scan it
                        # is a corrupt stream — raise like the reference.
                        if (
                            row_mcu == geo.mcus_per_column - 1
                            and col_mcu == geo.mcus_per_line - 1
                        ):
                            return
                        raise JpegDecodeError("Expect restart marker.")
                    span_idx += 1
                    if span_idx >= len(spans):
                        return
                    nxt = spans[span_idx]
                    reader = BitReader(unstuff_entropy_bytes(data[nxt.start : nxt.end]))
                    mcus_before_restart = restart_interval
                    for comp in comps:
                        comp["predictor"] = 0

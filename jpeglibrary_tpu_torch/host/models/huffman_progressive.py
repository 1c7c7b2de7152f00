"""Progressive (SOF2) Huffman entropy decode: multi-scan accumulation
into dense zig-zag coefficient planes.

Behavioral parity with the reference
(yigolden/JpegLibrary/src/JpegLibrary/ScanDecoder/JpegHuffmanProgressiveScanDecoder.cs:57-419):
DC first/refinement scans (interleaved or single-component), AC
first scans with EOB-run tracking, AC refinement with correction bits.
The reference performs IDCT at Dispose() (:421-470); here every scan
just updates the persistent coefficient planes and the shared batched
transform stage runs once at the end of decode — the same contract made
explicit.

This is the pure-Python reference scanner; the native C++ scanner
(jpeglibrary_tpu_torch/host/native/scanner.cpp) implements identical semantics for
the production path.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..io.bitreader import BitReader, EndOfStream, MarkerEncountered
from ..io.reader import EntropySpan, unstuff_entropy_bytes
from ..syntax.frame import FrameHeader, ScanHeader, resolve_scan_components
from ..syntax.huffman import HuffmanDecodingTable
from ..syntax.markers import Marker, is_restart_marker
from .geometry import FrameGeometry, ceil_div, frame_geometry
from .huffman_baseline import (
    JpegDecodeError,
    decode_huffman_code,
    receive_and_extend,
)


def _wrap_int16(v: int) -> int:
    return ((v & 0xFFFF) ^ 0x8000) - 0x8000


def _read_bits_strict(reader: BitReader, n: int) -> int:
    """TryReadBits with the progressive decoder's error message."""
    try:
        return reader.read_bits(n)
    except (MarkerEncountered, EndOfStream):
        raise JpegDecodeError("Unexpected end of JPEG data stream.")


def read_block_progressive_dc(
    reader: BitReader,
    dc_table: Optional[HuffmanDecodingTable],
    scan: ScanHeader,
    block: np.ndarray,
    predictor: int,
) -> int:
    """DC first/refinement for one block (reference :227-253).

    Returns the updated DC predictor.
    """
    al = scan.successive_approximation_bit_position_low
    if scan.successive_approximation_bit_position_high == 0:
        s = decode_huffman_code(reader, dc_table)
        if s != 0:
            s = receive_and_extend(reader, s)
        s += predictor
        predictor = s
        block[0] = _wrap_int16(s << al)
    else:
        bits = _read_bits_strict(reader, 1)
        block[0] = _wrap_int16(int(block[0]) | (bits << al))
    return predictor


def read_block_progressive_ac(
    reader: BitReader,
    ac_table: HuffmanDecodingTable,
    scan: ScanHeader,
    eobrun: int,
    block: np.ndarray,
) -> int:
    """AC first scan for one block (reference :255-304).

    Returns the updated EOB run.
    """
    if scan.successive_approximation_bit_position_high != 0:
        return read_block_progressive_ac_refined(reader, ac_table, scan, eobrun, block)

    if eobrun != 0:
        return eobrun - 1

    start = scan.start_of_spectral_selection
    end = scan.end_of_spectral_selection
    low = scan.successive_approximation_bit_position_low

    i = start
    while i <= end:
        s = decode_huffman_code(reader, ac_table)
        r = s >> 4
        s &= 15
        i += r
        if s != 0:
            s = receive_and_extend(reader, s)
            block[min(i, 63)] = _wrap_int16(s << low)
        else:
            if r != 15:
                eobrun = 1 << r
                if r != 0:
                    eobrun += _read_bits_strict(reader, r)
                eobrun -= 1
                break
        i += 1
    return eobrun


def read_block_progressive_ac_refined(
    reader: BitReader,
    ac_table: HuffmanDecodingTable,
    scan: ScanHeader,
    eobrun: int,
    block: np.ndarray,
) -> int:
    """AC refinement for one block (reference :313-419).

    Mind the asymmetry preserved from the reference: the in-band loop
    uses ``coef >= 0`` (:372) while the EOB-run tail uses ``coef > 0``
    (:410).
    """
    start = scan.start_of_spectral_selection
    end = scan.end_of_spectral_selection
    al = scan.successive_approximation_bit_position_low
    p1 = 1 << al
    m1 = -1 << al

    k = start
    if eobrun == 0:
        while k <= end:
            s = decode_huffman_code(reader, ac_table)
            r = s >> 4
            s &= 15
            if s != 0:
                bits = _read_bits_strict(reader, 1)
                s = p1 if bits != 0 else m1
            else:
                if r != 15:
                    eobrun = 1 << r
                    if r != 0:
                        eobrun += _read_bits_strict(reader, r)
                    break

            while k <= end:
                coef = int(block[k])
                if coef != 0:
                    bits = _read_bits_strict(reader, 1)
                    if bits != 0 and (coef & p1) == 0:
                        block[k] = _wrap_int16(coef + (p1 if coef >= 0 else m1))
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1

            if s != 0 and k < 64:
                block[k] = _wrap_int16(s)
            k += 1

    if eobrun > 0:
        while k <= end:
            coef = int(block[k])
            if coef != 0:
                bits = _read_bits_strict(reader, 1)
                if bits != 0 and (coef & p1) == 0:
                    block[k] = _wrap_int16(coef + (p1 if coef > 0 else m1))
            k += 1
        eobrun -= 1
    return eobrun


class _SpanCursor:
    """Walks the pre-split entropy spans, mirroring the restart logic of
    HandleRestart (reference :196-224): on each restart boundary, verify
    the terminator and move the bit cursor to the next span."""

    def __init__(self, data: bytes, spans: Sequence[EntropySpan]):
        self.data = data
        self.spans = spans
        self.index = 0
        self.reader = BitReader(
            unstuff_entropy_bytes(data[spans[0].start : spans[0].end])
        )

    def advance_restart(self, scan_complete: bool = False) -> bool:
        """Move to the next span. Returns False when the scan should end
        (EOI/stream end — tolerated truncation)."""
        terminator = self.spans[self.index].terminator
        if terminator == Marker.EOI or terminator is None:
            return False
        if not is_restart_marker(terminator):
            # A restart boundary that coincides with the end of the
            # scan (next marker is SOS/DNL/...): the scan is complete.
            # The reference throws here (HandleRestart,
            # JpegHuffmanProgressiveScanDecoder.cs:209-212) but libjpeg
            # checks intervals at their start and accepts such streams,
            # which our own restart-emitting progressive encoder
            # produces when the unit count divides the interval. The
            # tolerance applies ONLY at the true scan end: mid-scan the
            # stream is corrupt and we raise like the reference.
            if scan_complete:
                return False
            raise JpegDecodeError("Expect restart marker.")
        self.index += 1
        if self.index >= len(self.spans):
            return False
        nxt = self.spans[self.index]
        self.reader = BitReader(
            unstuff_entropy_bytes(self.data[nxt.start : nxt.end])
        )
        return True


def decode_progressive_scan(
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
    """Decode one progressive scan into the coefficient planes in place."""
    geo = geometry or frame_geometry(frame)
    resolved = resolve_scan_components(frame, scan)
    is_dc_scan = scan.start_of_spectral_selection == 0

    comps = []
    for comp_index, fc, sc in resolved:
        dc = dc_tables.get(sc.dc_table_selector)
        ac = ac_tables.get(sc.ac_table_selector)
        if is_dc_scan and dc is None:
            raise JpegDecodeError(
                f"Huffman table of component {comp_index} is not defined."
            )
        if not is_dc_scan and ac is None:
            raise JpegDecodeError(
                f"Huffman table of component {comp_index} is not defined."
            )
        cg = geo.components[comp_index]
        comps.append(
            {
                "index": comp_index,
                "h": cg.h,
                "v": cg.v,
                "hs": cg.hs,
                "vs": cg.vs,
                "dc": dc,
                "ac": ac,
                "predictor": 0,
                "plane": coefficient_planes[comp_index],
            }
        )

    cursor = _SpanCursor(data, spans)
    mcus_before_restart = restart_interval
    eobrun = 0

    def handle_restart(scan_complete: bool = False) -> bool:
        nonlocal mcus_before_restart, eobrun
        if restart_interval > 0:
            mcus_before_restart -= 1
            if mcus_before_restart == 0:
                if not cursor.advance_restart(scan_complete):
                    return False
                mcus_before_restart = restart_interval
                eobrun = 0
                for c in comps:
                    c["predictor"] = 0
        return True

    if len(comps) == 1:
        # Non-interleaved: the component's own block grid
        # (reference :140-193), one restart unit per block.
        comp = comps[0]
        plane = comp["plane"]
        hbc = ceil_div(geo.width, 8 * comp["hs"])
        vbc = ceil_div(geo.height, 8 * comp["vs"])
        if is_dc_scan:
            for by in range(vbc):
                for bx in range(hbc):
                    comp["predictor"] = read_block_progressive_dc(
                        cursor.reader, comp["dc"], scan, plane[by, bx], comp["predictor"]
                    )
                    if not handle_restart(by == vbc - 1 and bx == hbc - 1):
                        return
        else:
            for by in range(vbc):
                for bx in range(hbc):
                    eobrun = read_block_progressive_ac(
                        cursor.reader, comp["ac"], scan, eobrun, plane[by, bx]
                    )
                    if not handle_restart(by == vbc - 1 and bx == hbc - 1):
                        return
    else:
        # Interleaved (DC scans only per T.81): frame MCU walk
        # (reference :92-137), one restart unit per MCU.
        if not is_dc_scan:
            raise JpegDecodeError("Progressive AC scans must be non-interleaved.")
        for row_mcu in range(geo.mcus_per_column):
            for col_mcu in range(geo.mcus_per_line):
                for comp in comps:
                    plane = comp["plane"]
                    for y in range(comp["v"]):
                        by = row_mcu * comp["v"] + y
                        for x in range(comp["h"]):
                            bx = col_mcu * comp["h"] + x
                            comp["predictor"] = read_block_progressive_dc(
                                cursor.reader, comp["dc"], scan, plane[by, bx], comp["predictor"]
                            )
                if not handle_restart(
                    row_mcu == geo.mcus_per_column - 1
                    and col_mcu == geo.mcus_per_line - 1
                ):
                    return

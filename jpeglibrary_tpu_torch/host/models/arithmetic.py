"""Arithmetic-coded (SOF9/SOF10) entropy decode: ITU-T T.81 Annex D/F
MQ-style binary arithmetic decoder with adaptive statistics bins.

Behavioral parity, state-machine-exact, with the reference
(yigolden/JpegLibrary/src/JpegLibrary/ScanDecoder/JpegArithmeticScanDecoder.cs:117-324,
 JpegArithmeticSequentialScanDecoder.cs:50-308,
 JpegArithmeticProgressiveScanDecoder.cs:56-470):

- the 113-entry Qe probability-estimation table plus the fixed-0.5 bin
  (T.851 §10.3) packed exactly like the reference (:202-324)
- DC difference decode with DcL/DcU context conditioning (Figure F.19-24)
- AC decode with per-index bin triplets and Kx conditioning
- progressive DC/AC first+refinement scans incl. the EOBx backscan
- restart handling resets statistics, contexts and the register state

The arithmetic stream is inherently serial within a restart segment
(SURVEY.md §5); segments decode independently after a register reset,
which is the parallel seam the native scanner exploits.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..io.bitreader import BitReader
from ..io.reader import EntropySpan
from ..syntax.frame import FrameHeader, ScanHeader, resolve_scan_components
from .geometry import FrameGeometry, ceil_div, frame_geometry
from .huffman_baseline import JpegDecodeError
from .huffman_progressive import _SpanCursor, _wrap_int16


def _pack(a: int, b: int, c: int, d: int) -> int:
    """The compact Qe-table packing (reference :202-203)."""
    return a << 16 | c << 8 | d << 7 | b

# Table D.3 Qe values + next-state machine; entry 113 is the fixed 0.5
# estimate (reference s_arithmeticTable, :205-324).
_RAW = [
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0),
    (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1), (0x3F25, 36, 16, 0),
    (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0), (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
    (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0),
    (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0),
    (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0),
    (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0),
    (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0), (0x119C, 74, 76, 0),
    (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0), (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
    (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415E, 103, 99, 0), (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0),
]

QE_TABLE = tuple(_pack(a, b, c, d) for (a, b, c, d) in _RAW)
assert len(QE_TABLE) == 114


class ConditioningTable:
    """DAC conditioning values (JpegArithmeticDecodingTable.Configure,
    JpegArithmeticDecodingTable.cs:20-35)."""

    __slots__ = ("table_class", "identifier", "dc_l", "dc_u", "ac_kx")

    def __init__(self, table_class: int, identifier: int, value: int):
        self.table_class = table_class
        self.identifier = identifier
        if table_class == 0:
            self.dc_l = value & 0x0F
            self.dc_u = value >> 4
            self.ac_kx = 0
        else:
            self.dc_l = 0
            self.dc_u = 0
            self.ac_kx = value


def parse_dac_segment(payload: bytes):
    """Parse all conditioning tables in one DAC segment (T.81 B.2.4.3)."""
    tables = []
    off = 0
    while off + 2 <= len(payload):
        tc_tb = payload[off]
        value = payload[off + 1]
        table_class = tc_tb >> 4
        if table_class == 1 and not (1 <= value <= 63):
            raise JpegDecodeError("Invalid arithmetic conditioning value.")
        tables.append(ConditioningTable(table_class, tc_tb & 0x0F, value))
        off += 2
    return tables


class ArithmeticDecoder:
    """Register state + adaptive statistics, persistent per frame."""

    def __init__(self):
        self._c = 0
        self._a = 0
        self._ct = -16
        self.fixed_bin = np.array([113, 0, 0, 0], dtype=np.uint8)
        self._stats: Dict[tuple, np.ndarray] = {}

    def reset_registers(self) -> None:
        """(reference Reset, :188-193)"""
        self._c = 0
        self._a = 0
        self._ct = -16  # force reading 2 initial bytes to fill C

    def get_stats(self, is_dc: bool, identifier: int) -> np.ndarray:
        """Statistics bin per (class, table id): 64 B for DC, 256 B for
        AC (JpegArithmeticStatistics.cs:17)."""
        key = (is_dc, identifier)
        bin_ = self._stats.get(key)
        if bin_ is None:
            bin_ = np.zeros(64 if is_dc else 256, dtype=np.uint8)
            self._stats[key] = bin_
        return bin_

    def decode(self, reader: BitReader, st: np.ndarray, idx: int) -> int:
        """DecodeBinaryDecision (reference :117-186), bit-exact."""
        a = self._a
        c = self._c
        ct = self._ct

        # Renormalization & data input per D.2.6
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                data = reader.try_read_bits(8)
                c = ((c << 8) | data) & 0xFFFFFFFF
                if c & 0x80000000:
                    c -= 0x100000000
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1

        sv = int(st[idx])
        qe = QE_TABLE[sv & 0x7F]
        nl = qe & 0xFF
        qe >>= 8
        nm = qe & 0xFF
        qe >>= 8

        # Decode & estimation per D.2.4 / D.2.5
        temp = a - qe
        a = temp
        temp <<= ct
        if c >= temp:
            c -= temp
            if a < qe:
                a = qe
                st[idx] = (sv & 0x80) ^ nm  # Estimate_after_MPS
            else:
                a = qe
                st[idx] = (sv & 0x80) ^ nl  # Estimate_after_LPS
                sv ^= 0x80  # Exchange LPS/MPS
        elif a < 0x8000:
            if a < qe:
                st[idx] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[idx] = (sv & 0x80) ^ nm

        self._a = a
        self._c = c
        self._ct = ct
        return sv >> 7


class _Comp:
    __slots__ = (
        "index", "h", "v", "dc_table", "ac_table", "dc_stats", "ac_stats",
        "predictor", "dc_context", "plane",
    )


def _resolve_components(
    frame: FrameHeader,
    scan: ScanHeader,
    dac_dc: Dict[int, ConditioningTable],
    dac_ac: Dict[int, ConditioningTable],
    state: ArithmeticDecoder,
    coefficient_planes: Dict[int, np.ndarray],
):
    """InitDecodeComponents for arithmetic scans
    (JpegArithmeticScanDecoder.cs:48-108): resolve tables and the shared
    statistics bins; predictor/context start at 0 each scan."""
    comps = []
    for comp_index, fc, sc in resolve_scan_components(frame, scan):
        c = _Comp()
        c.index = comp_index
        c.h = fc.horizontal_sampling_factor
        c.v = fc.vertical_sampling_factor
        c.dc_table = dac_dc.get(sc.dc_table_selector)
        c.ac_table = dac_ac.get(sc.ac_table_selector)
        c.dc_stats = (
            state.get_stats(True, c.dc_table.identifier) if c.dc_table else None
        )
        c.ac_stats = (
            state.get_stats(False, c.ac_table.identifier) if c.ac_table else None
        )
        c.predictor = 0
        c.dc_context = 0
        c.plane = coefficient_planes[comp_index]
        comps.append(c)
    return comps


def _decode_dc(state: ArithmeticDecoder, reader: BitReader, comp: _Comp) -> None:
    """DC difference decode, Figures F.19-F.24
    (JpegArithmeticSequentialScanDecoder.ReadBlock :185-246)."""
    st = comp.dc_stats
    if st is None or comp.dc_table is None:
        raise JpegDecodeError("DC table is missing.")
    base = comp.dc_context
    if state.decode(reader, st, base) == 0:
        comp.dc_context = 0
        return
    sign = state.decode(reader, st, base + 1)
    pos = base + 2 + sign
    m = state.decode(reader, st, pos)
    if m != 0:
        pos = 20
        while state.decode(reader, st, pos) != 0:
            m <<= 1
            if m == 0x8000:
                raise JpegDecodeError("Invalid arithmetic code.")
            pos += 1
    # F.1.4.4.1.2: establish dc_context conditioning category
    if m < ((1 << comp.dc_table.dc_l) >> 1):
        comp.dc_context = 0
    elif m > ((1 << comp.dc_table.dc_u) >> 1):
        comp.dc_context = 12 + sign * 4
    else:
        comp.dc_context = 4 + sign * 4
    v = m
    pos += 14
    m >>= 1
    while m != 0:
        if state.decode(reader, st, pos) != 0:
            v |= m
        m >>= 1
    v += 1
    if sign != 0:
        v = -v
    comp.predictor = _wrap_int16(comp.predictor + v)


def _decode_ac_value(state: ArithmeticDecoder, reader: BitReader, comp: _Comp,
                     st: np.ndarray, pos: int, k: int) -> int:
    """Shared AC magnitude decode (after the nonzero decision), Figures
    F.21-F.24 (reference sequential :269-305)."""
    sign = state.decode(reader, state.fixed_bin, 0)
    pos += 2
    m = state.decode(reader, st, pos)
    if m != 0:
        if state.decode(reader, st, pos) != 0:
            m <<= 1
            pos = 189 if k <= comp.ac_table.ac_kx else 217
            while state.decode(reader, st, pos) != 0:
                m <<= 1
                if m == 0x8000:
                    raise JpegDecodeError("Invalid arithmetic code.")
                pos += 1
    v = m
    pos += 14
    m >>= 1
    while m != 0:
        if state.decode(reader, st, pos) != 0:
            v |= m
        m >>= 1
    v += 1
    if sign != 0:
        v = -v
    return v


def _read_block_sequential(state: ArithmeticDecoder, reader: BitReader, comp: _Comp,
                           block: np.ndarray) -> None:
    """(JpegArithmeticSequentialScanDecoder.ReadBlock :181-307)"""
    _decode_dc(state, reader, comp)
    block[0] = comp.predictor

    st = comp.ac_stats
    if st is None or comp.ac_table is None:
        raise JpegDecodeError("AC table is missing.")
    k = 1
    while k <= 63:
        pos = 3 * (k - 1)
        if state.decode(reader, st, pos) != 0:
            break  # EOB
        while state.decode(reader, st, pos + 1) == 0:
            pos += 3
            k += 1
            if k > 63:
                raise JpegDecodeError("Invalid arithmetic code.")
        v = _decode_ac_value(state, reader, comp, st, pos, k)
        block[k] = _wrap_int16(v)
        k += 1


def decode_sequential_scan(
    data: bytes,
    spans: Sequence[EntropySpan],
    frame: FrameHeader,
    scan: ScanHeader,
    dac_dc: Dict[int, ConditioningTable],
    dac_ac: Dict[int, ConditioningTable],
    state: ArithmeticDecoder,
    restart_interval: int,
    coefficient_planes: Dict[int, np.ndarray],
    geometry: Optional[FrameGeometry] = None,
) -> None:
    """SOF9 scan decode (JpegArithmeticSequentialScanDecoder.ProcessScan
    :50-179): interleaved MCU walk, statistics+register reset at scan
    start and on every restart."""
    geo = geometry or frame_geometry(frame)
    comps = _resolve_components(frame, scan, dac_dc, dac_ac, state, coefficient_planes)

    for c in comps:
        if c.dc_stats is not None:
            c.dc_stats[:] = 0
        if c.ac_stats is not None:
            c.ac_stats[:] = 0
    state.reset_registers()

    cursor = _SpanCursor(data, spans)
    mcus_before_restart = restart_interval

    for row_mcu in range(geo.mcus_per_column):
        for col_mcu in range(geo.mcus_per_line):
            for comp in comps:
                plane = comp.plane
                for y in range(comp.v):
                    by = row_mcu * comp.v + y
                    for x in range(comp.h):
                        bx = col_mcu * comp.h + x
                        block = np.zeros(64, dtype=np.int16)
                        _read_block_sequential(state, cursor.reader, comp, block)
                        plane[by, bx, :] = block

            if restart_interval > 0:
                mcus_before_restart -= 1
                if mcus_before_restart == 0:
                    if not cursor.advance_restart(
                        row_mcu == geo.mcus_per_column - 1
                        and col_mcu == geo.mcus_per_line - 1
                    ):
                        return
                    mcus_before_restart = restart_interval
                    for comp in comps:
                        comp.predictor = 0
                        comp.dc_context = 0
                        if comp.dc_stats is not None:
                            comp.dc_stats[:] = 0
                        if comp.ac_stats is not None:
                            comp.ac_stats[:] = 0
                    state.reset_registers()


def _read_block_progressive_dc(state: ArithmeticDecoder, reader: BitReader,
                               comp: _Comp, scan: ScanHeader, block: np.ndarray) -> None:
    """(JpegArithmeticProgressiveScanDecoder.ReadBlockProgressiveDC :243-321)"""
    al = scan.successive_approximation_bit_position_low
    if scan.successive_approximation_bit_position_high == 0:
        _decode_dc(state, reader, comp)
        block[0] = _wrap_int16(comp.predictor << al)
    else:
        bit = state.decode(reader, state.fixed_bin, 0)
        block[0] = _wrap_int16(int(block[0]) | (bit << al))


def _read_block_progressive_ac(state: ArithmeticDecoder, reader: BitReader,
                               comp: _Comp, scan: ScanHeader, block: np.ndarray) -> None:
    """(JpegArithmeticProgressiveScanDecoder.ReadBlockProgressiveAC :323-400)"""
    st_arr = comp.ac_stats
    if st_arr is None or comp.ac_table is None:
        raise JpegDecodeError("AC table is missing")

    if scan.successive_approximation_bit_position_high == 0:
        start = scan.start_of_spectral_selection
        end = scan.end_of_spectral_selection
        low = scan.successive_approximation_bit_position_low
        k = start
        while k <= end:
            pos = 3 * (k - 1)
            if state.decode(reader, st_arr, pos) != 0:
                break
            while state.decode(reader, st_arr, pos + 1) == 0:
                pos += 3
                k += 1
                if k > 63:
                    raise JpegDecodeError("Invalid arithmetic code.")
            v = _decode_ac_value(state, reader, comp, st_arr, pos, k)
            block[k] = _wrap_int16(v << low)
            k += 1
    else:
        _read_block_progressive_ac_refined(state, reader, st_arr, scan, block)


def _read_block_progressive_ac_refined(state: ArithmeticDecoder, reader: BitReader,
                                       st_arr: np.ndarray, scan: ScanHeader,
                                       block: np.ndarray) -> None:
    """(JpegArithmeticProgressiveScanDecoder.ReadBlockProgressiveACRefined :402-470)"""
    start = scan.start_of_spectral_selection
    end = scan.end_of_spectral_selection
    p1 = 1 << scan.successive_approximation_bit_position_low
    m1 = -1 << scan.successive_approximation_bit_position_low

    # Establish EOBx (previous stage end-of-block) index (:411-418)
    kex = end
    while kex > 0:
        if block[kex] != 0:
            break
        kex -= 1

    k = start
    while k <= end:
        pos = 3 * (k - 1)
        if k > kex:
            if state.decode(reader, st_arr, pos) != 0:
                break
        while True:
            coef = int(block[k])
            if coef != 0:  # previously nonzero coef
                if state.decode(reader, st_arr, pos + 2) != 0:
                    block[k] = _wrap_int16(coef + (m1 if coef < 0 else p1))
                break
            if state.decode(reader, st_arr, pos + 1) != 0:  # newly nonzero
                if state.decode(reader, state.fixed_bin, 0) != 0:
                    block[k] = _wrap_int16(coef + m1)
                else:
                    block[k] = _wrap_int16(coef + p1)
                break
            pos += 3
            k += 1
            if k > end:
                raise JpegDecodeError("Invalid arithmetic code.")
        k += 1


def decode_progressive_scan(
    data: bytes,
    spans: Sequence[EntropySpan],
    frame: FrameHeader,
    scan: ScanHeader,
    dac_dc: Dict[int, ConditioningTable],
    dac_ac: Dict[int, ConditioningTable],
    state: ArithmeticDecoder,
    restart_interval: int,
    coefficient_planes: Dict[int, np.ndarray],
    geometry: Optional[FrameGeometry] = None,
) -> None:
    """SOF10 scan decode (JpegArithmeticProgressiveScanDecoder.ProcessScan
    :56-243)."""
    geo = geometry or frame_geometry(frame)
    comps = _resolve_components(frame, scan, dac_dc, dac_ac, state, coefficient_planes)

    is_dc_first = (
        scan.start_of_spectral_selection == 0
        and scan.successive_approximation_bit_position_high == 0
    )
    is_ac = scan.start_of_spectral_selection != 0
    for c in comps:
        if is_dc_first and c.dc_stats is not None:
            c.dc_stats[:] = 0
        if is_ac and c.ac_stats is not None:
            c.ac_stats[:] = 0
    state.reset_registers()

    cursor = _SpanCursor(data, spans)
    mcus_before_restart = restart_interval

    def handle_restart(scan_complete: bool = False) -> bool:
        nonlocal mcus_before_restart
        if restart_interval > 0:
            mcus_before_restart -= 1
            if mcus_before_restart == 0:
                if not cursor.advance_restart(scan_complete):
                    return False
                mcus_before_restart = restart_interval
                for c in comps:
                    if is_dc_first:
                        c.predictor = 0
                        c.dc_context = 0
                        if c.dc_stats is not None:
                            c.dc_stats[:] = 0
                    if is_ac and c.ac_stats is not None:
                        c.ac_stats[:] = 0
                state.reset_registers()
        return True

    if len(comps) == 1:
        comp = comps[0]
        plane = comp.plane
        cg = geo.components[comp.index]
        hbc = ceil_div(geo.width, 8 * cg.hs)
        vbc = ceil_div(geo.height, 8 * cg.vs)
        if scan.start_of_spectral_selection == 0:
            if comp.dc_table is None or comp.dc_stats is None:
                raise JpegDecodeError("DC table is missing.")
            for by in range(vbc):
                for bx in range(hbc):
                    _read_block_progressive_dc(state, cursor.reader, comp, scan, plane[by, bx])
                    if not handle_restart(by == vbc - 1 and bx == hbc - 1):
                        return
        else:
            for by in range(vbc):
                for bx in range(hbc):
                    _read_block_progressive_ac(state, cursor.reader, comp, scan, plane[by, bx])
                    if not handle_restart(by == vbc - 1 and bx == hbc - 1):
                        return
    else:
        for comp in comps:
            if comp.dc_table is None or comp.dc_stats is None:
                raise JpegDecodeError("DC table is missing.")
        for row_mcu in range(geo.mcus_per_column):
            for col_mcu in range(geo.mcus_per_line):
                for comp in comps:
                    plane = comp.plane
                    for y in range(comp.v):
                        by = row_mcu * comp.v + y
                        for x in range(comp.h):
                            bx = col_mcu * comp.h + x
                            _read_block_progressive_dc(
                                state, cursor.reader, comp, scan, plane[by, bx]
                            )
                if not handle_restart(
                    row_mcu == geo.mcus_per_column - 1
                    and col_mcu == geo.mcus_per_line - 1
                ):
                    return

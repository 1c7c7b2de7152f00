"""Arithmetic lossless coding (SOF11 / differential SOF15), T.81 H.2.

Completes the framework's T.81 SOF matrix — with this module every
coding process in Table B.1 is implemented in BOTH directions
(SOF0/1/2/3 + hierarchical 5/6/7 Huffman, SOF9/10/11 + hierarchical
13/14/15 arithmetic). The reference supports none of the arithmetic or
hierarchical processes (JpegDecoder.cs ThrowUnsupported), and no
mainstream codec implements SOF11/SOF15, so conformance here is
self-validated: encoder and decoder are exact inverses (round-trip
property tests over every predictor/precision/point-transform/restart
configuration) built on the same QM coder validated bit-exactly against
real SOF9/SOF10 fixtures.

Coding model (T.81 H.2.1, mirroring the sequential DC model F.1.4.1
with a two-dimensional conditioning state):

- Per sample, the prediction difference Dx (same Annex-H predictors
  and int16 wraparound as the Huffman lossless path, models/lossless.py)
  is coded with the DC decision tree: S0 zero/nonzero, SS sign, SP/SN
  first magnitude decision, then a magnitude-category ladder and
  mantissa bits.
- The conditioning state is the 5x5 classification of the differences
  already coded at the sample to the left (Da) and the sample above
  (Db): {zero, small+, small-, large+, large-} per F.1.4.4.1.1's
  thresholds from the DAC conditioning (L, U). 25 contexts x 4 bins,
  plus TWO magnitude-ladder bin sets (X1..X15 + M2..M15) selected by
  whether Db classifies as large = 100 + 2*29 = 158 statistics bins.
- Restart: registers, statistics, predictors and the conditioning
  history all reset — segments are fully independent (the property the
  framework's restart-parallel decoders rely on in every other mode).

Conformance caveat (carried since round 3): T.81 spells out the 5x5
(Qa, Qb) conditioning STATE for H.2 but not a normative flat index
order for the statistics area, and no public codec or conformance
stream implements SOF11 to cross-validate against. The layout here —
``base = 4 * (Qb * 5 + Qa)`` with bins (S0, SS, SP, SN), one X/M
magnitude ladder per Db-size class selected by ``Qb >= 3`` (large) —
is therefore self-chosen (any consistent enumeration yields a valid
QM-coded stream; encoder and decoder just have to agree). If a T.81
H.2 conformance stream ever surfaces, re-check the (Qa, Qb) -> base
mapping and the magnitude bin-set selection rule first.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..io.reader import EntropySpan
from ..syntax.frame import (
    FrameComponent,
    FrameHeader,
    ScanComponent,
    ScanHeader,
    resolve_scan_components,
)
from ..syntax.markers import Marker
from .arithmetic import QE_TABLE, ArithmeticDecoder, ConditioningTable
from .geometry import ceil_div
from .huffman_baseline import JpegDecodeError
from .huffman_progressive import _SpanCursor, _wrap_int16
from .lossless import _predict

#: Statistics layout: 25 contexts x 4 bins (S0, SS, SP, SN), then the
#: small-Db magnitude set (X ladder at 100, mantissa at pos+14) and the
#: large-Db set at 129.
N_STATS = 158
_X_SMALL = 100
_X_LARGE = 129


def _classify(v: int, lo: int, hi: int) -> int:
    """F.1.4.4.1.1 five-way classification of a coded difference:
    0 zero, 1 small+, 2 small-, 3 large+, 4 large-. ``lo``/``hi`` are
    the precomputed (1 << L) >> 1 and (1 << U) >> 1 thresholds; the
    compared quantity is the magnitude-category value MSB(|v| - 1),
    exactly the ``m`` the DC coder conditions on (models/arithmetic.py
    _decode_dc)."""
    if v == 0:
        return 0
    sign = 1 if v < 0 else 0
    # MSB mask of (|v| - 1); 0 when |v| == 1.
    mval = (-v if v < 0 else v) - 1
    mcat = 0
    if mval:
        mcat = 1
        while mval > 1:
            mval >>= 1
            mcat <<= 1
    if mcat < lo:
        return 0
    if mcat > hi:
        return 3 + sign
    return 1 + sign


class ArithmeticEncoder:
    """Pure-Python QM encoder — the exact inverse of
    ArithmeticDecoder's register machine (and a mirror of the native
    ArithEncoder, native/scanner.cpp:4146): carry propagation through
    stacked 0xFF bytes, JPEG byte stuffing, D.1.8 flush."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self) -> None:
        self._a = 0x10000
        self._c = 0
        self._ct = 11
        self._pending = -1
        self._sc = 0

    def _emit(self, b: int) -> None:
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0x00)

    def _byte_out(self) -> None:
        temp = self._c >> 19
        if temp > 0xFF:
            if self._pending >= 0:
                self._emit((self._pending + 1) & 0xFF)
            while self._sc > 0:
                self._emit(0x00)
                self._sc -= 1
            self._pending = temp & 0xFF
        elif temp == 0xFF:
            self._sc += 1
        else:
            if self._pending >= 0:
                self._emit(self._pending)
            while self._sc > 0:
                self._emit(0xFF)
                self._sc -= 1
            self._pending = temp
        self._c &= 0x7FFFF

    def encode(self, bit: int, st: np.ndarray, idx: int) -> None:
        sv = int(st[idx])
        # _pack(qe, next_lps, next_mps, switch) = qe<<16 | nm<<8 |
        # switch<<7 | nlps — the low byte is next-LPS with the MPS
        # switch folded into bit 7, exactly what XOR-ing the sense bit
        # applies (models/arithmetic.py:35-40).
        packed = QE_TABLE[sv & 0x7F]
        qe = packed >> 16
        nm = (packed >> 8) & 0xFF
        nl = packed & 0xFF
        an = self._a - qe
        if bit == (sv >> 7):
            if an & 0x8000:
                self._a = an
                return
            if an < qe:
                self._c += an
                self._a = qe
            else:
                self._a = an
            st[idx] = (sv & 0x80) ^ nm
        else:
            if an < qe:
                self._a = an
            else:
                self._c += an
                self._a = qe
            st[idx] = (sv & 0x80) ^ nl
        while True:
            self._a = (self._a << 1) & 0xFFFFFFFF
            self._c = (self._c << 1) & 0xFFFFFFFF
            self._ct -= 1
            if self._ct == 0:
                self._byte_out()
                self._ct = 8
            if self._a & 0x8000:
                break

    def flush(self) -> bytes:
        temp = (self._c + self._a - 1) & ~0xFFFF
        if temp < self._c:
            temp += 0x8000
        self._c = temp << self._ct
        self._byte_out()
        self._c = (self._c << 8) & 0xFFFFFFFF
        self._byte_out()
        if self._pending > 0:
            self._emit(self._pending)
        elif self._pending == 0:
            self._emit(0x00)
        while self._sc > 0:
            self._emit(0xFF)
            self._sc -= 1
        data = bytes(self.out)
        self.out = bytearray()
        return data


def _encode_diff(enc: ArithmeticEncoder, st: np.ndarray, base: int,
                 db_large: bool, v: int) -> None:
    """Encode one difference with the DC decision tree at conditioning
    ``base`` (inverse of _decode_diff)."""
    if v == 0:
        enc.encode(0, st, base)
        return
    enc.encode(1, st, base)
    sign = 1 if v < 0 else 0
    enc.encode(sign, st, base + 1)
    mval = (-v if v < 0 else v) - 1
    pos = base + 2 + sign
    if mval == 0:
        enc.encode(0, st, pos)
        mcat = 0
    else:
        enc.encode(1, st, pos)
        k = 0
        while (mval >> (k + 1)) != 0:
            k += 1
        pos = _X_LARGE if db_large else _X_SMALL
        for i in range(k):
            enc.encode(1, st, pos + i)
        enc.encode(0, st, pos + k)
        pos += k
        mcat = 1 << k
    pos += 14
    m = mcat >> 1
    while m:
        enc.encode(1 if (mval & m) else 0, st, pos)
        m >>= 1


def _decode_diff(state: ArithmeticDecoder, reader, st: np.ndarray,
                 base: int, db_large: bool) -> int:
    """Decode one difference (T.81 H.2.1, Figure F.19 decision tree
    with the lossless conditioning)."""
    if state.decode(reader, st, base) == 0:
        return 0
    sign = state.decode(reader, st, base + 1)
    pos = base + 2 + sign
    m = state.decode(reader, st, pos)
    if m != 0:
        pos = _X_LARGE if db_large else _X_SMALL
        while state.decode(reader, st, pos) != 0:
            m <<= 1
            if m == 0x8000:
                raise JpegDecodeError("Invalid arithmetic code.")
            pos += 1
    v = m
    pos += 14
    m >>= 1
    while m:
        if state.decode(reader, st, pos) != 0:
            v |= m
        m >>= 1
    v += 1
    return -v if sign else v


class _LosslessComp:
    __slots__ = ("index", "h", "v", "plane", "diffs", "stats", "lo", "hi")

    def __init__(self, index, h, v, plane, stats: np.ndarray,
                 cond: Optional[ConditioningTable]):
        self.index = index
        self.h = h
        self.v = v
        self.plane = plane
        self.diffs = np.zeros(plane.shape, dtype=np.int32)
        # Statistics are a property of the TABLE selector, shared by
        # every component referencing it (T.81 statistical areas, same
        # keying as ArithmeticDecoder.get_stats).
        self.stats = stats
        dc_l = cond.dc_l if cond is not None else 0
        dc_u = cond.dc_u if cond is not None else 1
        self.lo = (1 << dc_l) >> 1
        self.hi = (1 << dc_u) >> 1


def decode_scan(
    data: bytes,
    spans: Sequence[EntropySpan],
    frame: FrameHeader,
    scan: ScanHeader,
    dac_dc: Dict[int, ConditioningTable],
    state: ArithmeticDecoder,
    restart_interval: int,
    sample_planes: Dict[int, np.ndarray],
    *,
    use_native: bool = True,
) -> None:
    """Decode one SOF11/SOF15 scan: native C++ scanner when available,
    pure-Python twin otherwise (bit-identical either way — fuzzed
    against each other in tests/test_arithmetic_lossless.py)."""
    if use_native:
        try:
            from ..native import scanner as native_scanner

            native_scanner.decode_lossless_arith_scan(
                data, spans, frame, scan, dac_dc, restart_interval,
                sample_planes,
            )
            return
        except ImportError:
            pass
    decode_lossless_scan_arithmetic(
        data, spans, frame, scan, dac_dc, state, restart_interval,
        sample_planes,
    )


def decode_lossless_scan_arithmetic(
    data: bytes,
    spans: Sequence[EntropySpan],
    frame: FrameHeader,
    scan: ScanHeader,
    dac_dc: Dict[int, ConditioningTable],
    state: ArithmeticDecoder,
    restart_interval: int,
    sample_planes: Dict[int, np.ndarray],
) -> None:
    """Decode one SOF11/SOF15 scan into the sample planes in place.
    Traversal, predictors, initial predictions and restart re-seeding
    mirror the Huffman lossless scanner (models/lossless.py:66-157);
    only the entropy layer differs."""
    resolved = resolve_scan_components(frame, scan)
    comps = []
    stats_by_id: Dict[int, np.ndarray] = {}
    for comp_index, fc, sc in resolved:
        stats = stats_by_id.setdefault(
            sc.dc_table_selector, np.zeros(N_STATS, dtype=np.uint8)
        )
        comps.append(
            _LosslessComp(
                comp_index,
                fc.horizontal_sampling_factor,
                fc.vertical_sampling_factor,
                sample_planes[comp_index],
                stats,
                dac_dc.get(sc.dc_table_selector),
            )
        )

    max_h = frame.max_horizontal_sampling
    max_v = frame.max_vertical_sampling
    mcus_per_line = ceil_div(frame.samples_per_line, max_h)
    mcus_per_column = ceil_div(frame.number_of_lines, max_v)

    predictor_sel = scan.start_of_spectral_selection
    pt = scan.successive_approximation_bit_position_low
    initial_prediction = (
        (1 << (frame.sample_precision - pt - 1)) if predictor_sel else 0
    )

    state.reset_registers()
    cursor = _SpanCursor(data, spans)
    mcus_before_restart = restart_interval

    for row_mcu in range(mcus_per_column):
        for col_mcu in range(mcus_per_line):
            at_restart_start = (
                restart_interval > 0 and mcus_before_restart == restart_interval
            )
            for comp in comps:
                h, v = comp.h, comp.v
                plane = comp.plane
                dplane = comp.diffs
                st = comp.stats
                offset_x = col_mcu * h
                offset_y = row_mcu * v
                for y in range(v):
                    row = offset_y + y
                    scanline = plane[row]
                    drow = dplane[row]
                    lastline = None if (y == 0 and row_mcu == 0) else plane[row - 1]
                    dlast = None if row == 0 else dplane[row - 1]
                    for x in range(h):
                        cx = offset_x + x
                        da = int(drow[cx - 1]) if cx > 0 else 0
                        db = int(dlast[cx]) if dlast is not None else 0
                        qa = _classify(da, comp.lo, comp.hi)
                        qb = _classify(db, comp.lo, comp.hi)
                        diff = _decode_diff(
                            state, cursor.reader, st,
                            4 * (qb * 5 + qa), qb >= 3,
                        )
                        drow[cx] = diff
                        if row_mcu == 0 or at_restart_start:
                            if col_mcu == 0 and x == 0:
                                pred = initial_prediction
                            else:
                                ra = int(scanline[cx - 1])
                                rb = initial_prediction if y == 0 else int(lastline[cx])
                                rc = initial_prediction if y == 0 else int(lastline[cx - 1])
                                pred = _predict(predictor_sel, ra, rb, rc)
                        elif col_mcu == 0:
                            pred = int(lastline[cx]) if predictor_sel else 0
                        else:
                            ra = int(scanline[cx - 1])
                            rb = int(lastline[cx])
                            rc = int(lastline[cx - 1])
                            pred = _predict(predictor_sel, ra, rb, rc)
                        scanline[cx] = _wrap_int16(pred + diff)

            if restart_interval > 0:
                mcus_before_restart -= 1
                if mcus_before_restart == 0:
                    if not cursor.advance_restart(
                        row_mcu == mcus_per_column - 1
                        and col_mcu == mcus_per_line - 1
                    ):
                        return
                    mcus_before_restart = restart_interval
                    state.reset_registers()
                    for comp in comps:
                        comp.stats[:] = 0
                        comp.diffs[:] = 0


def encode_lossless_arithmetic(
    planes,
    *,
    precision: int = 8,
    predictor: int = 1,
    point_transform: int = 0,
    restart_interval: int = 0,
    differential: bool = False,
    sampling: Optional[Sequence] = None,
    size: Optional[tuple] = None,
    dc_conditioning=(0, 1),
    use_native: bool = True,
) -> bytes:
    """Encode sample planes as an arithmetic lossless JPEG (SOF11; with
    ``differential`` a hierarchical SOF15 frame coding raw diffs with
    predictor selection 0 — models/hierarchical.py embeds those).

    ``planes``: [H, W], [H, W, C], or list of [H, W] planes (int,
    up to ``precision`` bits; int16-wrapped diffs for differential).
    ``restart_interval`` is in MCUs and fully re-seeds the coder, so
    segments decode independently. Output round-trips bit-exactly
    through decode_lossless_scan_arithmetic.
    """
    from ..io.writer import JpegWriter

    if isinstance(planes, np.ndarray) and planes.ndim == 3:
        planes = [planes[..., i] for i in range(planes.shape[-1])]
    elif isinstance(planes, np.ndarray):
        planes = [planes]
    planes = [np.asarray(p, dtype=np.int32) for p in planes]
    n_comps = len(planes)
    if not 1 <= n_comps <= 4:
        raise ValueError("1..4 components supported")
    if differential:
        predictor = 0  # differential frames code raw diffs (T.81 J)
    elif not 1 <= predictor <= 7:
        raise ValueError("predictor selection must be 1..7")
    if sampling is None:
        sampling = [(1, 1)] * n_comps
    elif size is None and any(s != (1, 1) for s in sampling):
        # Same contract as encode_lossless: sub-sampled layouts need
        # the full-frame size — silently cropping equal-shape planes to
        # their component grids would discard data.
        raise ValueError("size=(H, W) is required with sampling")
    if size is not None:
        # Interleaved sub-sampled layout: ``size`` = full-frame (H, W);
        # each plane is its component's own (possibly padded)
        # resolution, like encode_lossless(sampling=..., size=...).
        h, w = size
    else:
        h, w = planes[0].shape
        if any(p.shape != (h, w) for p in planes):
            raise ValueError(
                "planes of differing shapes need size=(H, W) and sampling"
            )
    max_h = max(s[0] for s in sampling)
    max_v = max(s[1] for s in sampling)
    mcus_per_line = ceil_div(w, max_h)
    mcus_per_column = ceil_div(h, max_v)

    dc_l, dc_u = dc_conditioning
    lo = (1 << dc_l) >> 1
    hi = (1 << dc_u) >> 1
    initial_prediction = (
        (1 << (precision - point_transform - 1)) if predictor else 0
    )

    # Padded per-component sample planes on the MCU grid (edge
    # replicated), matching the decoder's allocation.
    comp_planes = []
    for p, (ch, cv) in zip(planes, sampling):
        # Interleaved sub-sampled encode takes the component plane at
        # its own resolution, like encode_lossless.
        ph = mcus_per_column * cv
        pw = mcus_per_line * ch
        src = p
        padded = np.zeros((ph, pw), dtype=np.int32)
        sh = min(src.shape[0], ph)
        sw = min(src.shape[1], pw)
        padded[:sh, :sw] = src[:sh, :sw]
        if sw < pw:
            padded[:sh, sw:] = padded[:sh, sw - 1 : sw]
        if sh < ph:
            padded[sh:, :] = padded[sh - 1 : sh, :]
        comp_planes.append(padded)

    entropy_blob = None
    if use_native:
        try:
            from ..native import scanner as native_scanner

            entropy_blob = native_scanner.encode_lossless_arith(
                comp_planes,
                list(sampling),
                [min(i, 1) for i in range(n_comps)],
                (lo, hi),
                predictor,
                initial_prediction,
                point_transform,
                restart_interval,
            )
        except ImportError:
            entropy_blob = None
    if entropy_blob is None:
        entropy_blob = _encode_scan_python(
            comp_planes, sampling, n_comps, mcus_per_line, mcus_per_column,
            predictor, initial_prediction, point_transform,
            restart_interval, lo, hi,
        )

    # --- container (SOI/EOI always present; hierarchical embedding
    # strips them, same contract as encode_lossless) ---
    writer = JpegWriter()
    writer.write_marker(Marker.SOI)
    sof_marker = Marker.SOF15 if differential else Marker.SOF11
    frame = FrameHeader(
        marker=sof_marker,
        sample_precision=precision,
        number_of_lines=h,
        samples_per_line=w,
        components=tuple(
            FrameComponent(i + 1, sampling[i][0], sampling[i][1], 0)
            for i in range(n_comps)
        ),
    )
    writer.write_segment(sof_marker, frame.serialize())
    dac = bytearray()
    for tid in range(min(n_comps, 2)):
        dac += bytes([tid, (dc_u << 4) | dc_l])
    writer.write_segment(Marker.DAC, bytes(dac))
    if restart_interval > 0:
        writer.write_segment(
            Marker.DRI,
            bytes([(restart_interval >> 8) & 0xFF, restart_interval & 0xFF]),
        )
    scan = ScanHeader(
        components=tuple(
            ScanComponent(i + 1, min(i, 1), 0) for i in range(n_comps)
        ),
        start_of_spectral_selection=predictor,
        end_of_spectral_selection=0,
        successive_approximation_bit_position_high=0,
        successive_approximation_bit_position_low=point_transform,
    )
    writer.write_segment(Marker.SOS, scan.serialize())
    writer.write_bytes(entropy_blob)
    writer.write_marker(Marker.EOI)
    return writer.to_bytes()


def _encode_scan_python(
    comp_planes, sampling, n_comps, mcus_per_line, mcus_per_column,
    predictor, initial_prediction, point_transform, restart_interval,
    lo, hi,
) -> bytes:
    """Pure-Python entropy encode (native twin:
    jpx_encode_lossless_arith) — one blob with inline RSTn markers."""
    enc = ArithmeticEncoder()
    # Statistics shared per table selector (component i uses selector
    # min(i, 1)), mirroring the decoder and T.81 statistical areas.
    stats_by_id = [
        np.zeros(N_STATS, dtype=np.uint8) for _ in range(min(n_comps, 2))
    ]
    stats = [stats_by_id[min(i, 1)] for i in range(n_comps)]
    diffs = [np.zeros(p.shape, dtype=np.int32) for p in comp_planes]
    segments = []  # encoded entropy segments split at restart marks

    mcus_before_restart = restart_interval
    recon = [np.zeros(p.shape, dtype=np.int16) for p in comp_planes]

    for row_mcu in range(mcus_per_column):
        for col_mcu in range(mcus_per_line):
            at_restart_start = (
                restart_interval > 0 and mcus_before_restart == restart_interval
            )
            for ci in range(n_comps):
                ch, cv = sampling[ci]
                plane = comp_planes[ci]
                rplane = recon[ci]
                dplane = diffs[ci]
                st = stats[ci]
                offset_x = col_mcu * ch
                offset_y = row_mcu * cv
                for y in range(cv):
                    row = offset_y + y
                    scanline = rplane[row]
                    drow = dplane[row]
                    lastline = None if (y == 0 and row_mcu == 0) else rplane[row - 1]
                    dlast = None if row == 0 else dplane[row - 1]
                    for x in range(ch):
                        cx = offset_x + x
                        if row_mcu == 0 or at_restart_start:
                            if col_mcu == 0 and x == 0:
                                pred = initial_prediction
                            else:
                                ra = int(scanline[cx - 1])
                                rb = initial_prediction if y == 0 else int(lastline[cx])
                                rc = initial_prediction if y == 0 else int(lastline[cx - 1])
                                pred = _predict(predictor, ra, rb, rc)
                        elif col_mcu == 0:
                            pred = int(lastline[cx]) if predictor else 0
                        else:
                            ra = int(scanline[cx - 1])
                            rb = int(lastline[cx])
                            rc = int(lastline[cx - 1])
                            pred = _predict(predictor, ra, rb, rc)
                        sample = int(plane[row, cx]) >> point_transform
                        diff = _wrap_int16(sample - pred)
                        da = int(drow[cx - 1]) if cx > 0 else 0
                        db = int(dlast[cx]) if dlast is not None else 0
                        qa = _classify(da, lo, hi)
                        qb = _classify(db, lo, hi)
                        _encode_diff(enc, st, 4 * (qb * 5 + qa), qb >= 3, diff)
                        drow[cx] = diff
                        scanline[cx] = _wrap_int16(pred + diff)

            if restart_interval > 0:
                mcus_before_restart -= 1
                if mcus_before_restart == 0 and not (
                    row_mcu == mcus_per_column - 1
                    and col_mcu == mcus_per_line - 1
                ):
                    segments.append(enc.flush())
                    enc.reset()
                    mcus_before_restart = restart_interval
                    for st in stats:
                        st[:] = 0
                    for d in diffs:
                        d[:] = 0
    segments.append(enc.flush())
    blob = bytearray()
    for k, seg in enumerate(segments):
        if k > 0:
            blob += bytes([0xFF, 0xD0 + ((k - 1) & 7)])
        blob += seg
    return bytes(blob)

"""Region-of-interest decode: pixels for a rectangle without paying for
the whole image.

The reference (yigolden/JpegLibrary) has no partial decode — its
decoder always walks every MCU (JpegHuffmanBaselineScanDecoder.cs:99).
This module adds the tile-serving capability on top of this
framework's restart-span machinery: RSTn seams reset the DC predictors
(JpegHuffmanBaselineScanDecoder.cs:140-163), so any contiguous subset
of an image's restart spans decodes independently and bit-identically
to the same spans inside a full decode. For a baseline image with a
restart interval, decoding a tile therefore costs entropy work
proportional to the covered MCU rows — not the image — plus a
band-sized transform.

Fast paths (native, span-skipping), all requiring a restart interval:

- single-scan SOF0/SOF1, 8-bit: band decode with a native unit offset;
- SOF2 progressive, 8-bit: every scan resets DC predictors AND the EOB
  run at RSTn (JpegHuffmanProgressiveScanDecoder.cs:196-224), so each
  scan's covering spans decode as a standalone band — the span subset
  is snapped down to a unit-ROW-aligned boundary (lcm(DRI, units/row))
  and all scans accumulate into shared band planes;
- SOF3 lossless, predictor 1, 1x1 sampling, DRI a multiple of the
  samples-per-line: predictor 1 references only Ra (left) plus the
  line above WITHIN a span (start-of-line Rb), so row-aligned spans
  reconstruct independently (JpegHuffmanLosslessScanDecoder.cs:109);
  the covered spans decode as a standalone sub-image. Other predictors
  reference the row above across span boundaries, so they cannot skip
  vertically and fall back.

Everything else falls back to a full decode and an exact crop, so
``decode_region`` is correct for every mode the framework decodes.

Output matches ``full_decode.to_rgb8(upsample=...)[y:y+h, x:x+w]``
EXACTLY (tested property). For ``upsample="fancy"`` the band is
expanded by one iMCU of margin on each side before the transform: the
triangular filter (jdsample.c semantics) reads neighbor chroma samples
across block boundaries, and the margin reproduces them; at real image
edges the filter's replication is already identical.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..io import reader as io_reader
from ..syntax.frame import FrameHeader, ScanHeader, resolve_scan_components
from ..syntax.markers import Marker
from ..syntax.markers import ALL_SOF_MARKERS
from .decoder import DecodeResult, JpegDecoder
from .geometry import frame_geometry


def _exact_crop(img: np.ndarray, x: int, y: int, w: int, h: int) -> np.ndarray:
    return np.ascontiguousarray(img[y : y + h, x : x + w])


def decode_region(
    data: bytes,
    x: int,
    y: int,
    w: int,
    h: int,
    *,
    upsample: str = "duplicate",
    use_native: bool = True,
    xp=np,
) -> np.ndarray:
    """Decode the ``(x, y, w, h)`` pixel rectangle of a JPEG stream.

    Returns uint8 ``(h, w, 3)`` RGB (grayscale replicated), or
    ``(h, w, 4)`` ink for Adobe CMYK/YCCK streams — exactly the crop of
    the corresponding full-image ``to_rgb8``/``to_cmyk8``.

    Partial-decode semantics: the fast path only reads the restart
    spans covering the region, so corruption or truncation elsewhere in
    the stream goes unnoticed — a tile over intact spans decodes where
    a full decode would raise. Corruption inside the covered spans
    raises the same errors as a full decode.
    """
    if w <= 0 or h <= 0 or x < 0 or y < 0:
        raise ValueError("Region must have positive size and non-negative origin.")

    if use_native:
        out = _decode_region_fast(data, x, y, w, h, upsample, xp)
        if out is not None:
            return out

    dec = JpegDecoder()
    dec.set_input(data)
    res = dec.decode(use_native=use_native, xp=xp)
    if x + w > res.width or y + h > res.height:
        raise ValueError("Region exceeds image bounds.")
    if res.frame.number_of_components == 4:
        img = res.to_cmyk8(upsample=upsample)
    else:
        img = res.to_rgb8(upsample=upsample)
    return _exact_crop(img, x, y, w, h)


def _decode_region_fast(
    data: bytes, x: int, y: int, w: int, h: int, upsample: str, xp
) -> Optional[np.ndarray]:
    """Span-skipping band decode; None when the stream is ineligible
    (the caller falls back to full decode + crop)."""
    try:
        from ..native import scanner as native_scanner
        from ..native import build as native_build

        native_build.load_library()
    except ImportError:
        return None

    dec = JpegDecoder()
    dec.set_input(data)
    try:
        stream = dec._parsed()
    except Exception:
        return None  # let the full decode raise the canonical error
    if not stream.scans:
        return None

    frame: Optional[FrameHeader] = None
    sof_marker = None
    adobe = None
    # Pass 1: frame header + the restart interval in force at each SOS
    # (DRI may change between scans).
    scan_ris = []
    ri_cur = 0
    for seg in stream.segments:
        if seg.marker == Marker.DRI:
            payload = seg.payload(data)
            if len(payload) != 2:
                return None
            ri_cur = int.from_bytes(payload, "big")
        elif seg.marker == Marker.APP14:
            payload = seg.payload(data)
            if len(payload) >= 12 and payload[:5] == b"Adobe":
                adobe = payload[11]
        elif seg.marker == Marker.DHP:
            return None  # hierarchical pyramid
        elif seg.marker in ALL_SOF_MARKERS:
            if frame is not None:
                return None  # multi-frame
            sof_marker = seg.marker
            frame = io_reader.resolve_dnl(
                stream, data, FrameHeader.parse(seg.payload(data), seg.marker)
            )
        elif seg.marker == Marker.SOS:
            if frame is None:
                return None
            scan_ris.append(ri_cur)

    if frame is None or len(scan_ris) != len(stream.scans):
        return None
    if sof_marker == Marker.SOF2 and frame.sample_precision == 8:
        return _region_banded(
            dec, stream, data, frame, scan_ris, x, y, w, h, upsample, adobe,
            xp, arithmetic=False, progressive=True,
        )
    if sof_marker == Marker.SOF9 and frame.sample_precision == 8:
        return _region_banded(
            dec, stream, data, frame, scan_ris, x, y, w, h, upsample, adobe,
            xp, arithmetic=True, progressive=False,
        )
    if sof_marker == Marker.SOF10 and frame.sample_precision == 8:
        return _region_banded(
            dec, stream, data, frame, scan_ris, x, y, w, h, upsample, adobe,
            xp, arithmetic=True, progressive=True,
        )
    if sof_marker == Marker.SOF3:
        return _region_lossless(
            dec, stream, data, frame, scan_ris, x, y, w, h, xp
        )
    if sof_marker not in (Marker.SOF0, Marker.SOF1) or frame.sample_precision != 8:
        return None
    if len(stream.scans) != 1:
        return None

    scan_header: Optional[ScanHeader] = None
    for seg in stream.segments:
        if seg.marker in (Marker.DQT, Marker.DHT, Marker.DAC, Marker.DRI):
            dec._process_table_segment(seg, data)
        elif seg.marker == Marker.SOS:
            scan_header = ScanHeader.parse(seg.payload(data))
            break
    if scan_header is None:
        return None
    if x + w > frame.samples_per_line or y + h > frame.number_of_lines:
        raise ValueError("Region exceeds image bounds.")
    ri = dec._restart_interval
    if ri <= 0:
        return None  # no restart seams to skip by

    geo = frame_geometry(frame)
    scan = stream.scans[0]
    mh, mv = geo.max_h, geo.max_v
    mpl = geo.mcus_per_line
    total_mcus = mpl * geo.mcus_per_column

    # iMCU-aligned band/columns covering the rect; fancy upsampling
    # reads one chroma neighbor across block edges -> 1 iMCU margin.
    margin = 1 if upsample == "fancy" else 0
    row0 = max(0, y // (8 * mv) - margin)
    row1 = min(geo.mcus_per_column, -(-(y + h) // (8 * mv)) + margin)
    cx0 = max(0, x // (8 * mh) - margin)
    cx1 = min(mpl, -(-(x + w) // (8 * mh)) + margin)

    # Full-list validation first (exactly what a full decode enforces);
    # then the contiguous span subset covering the band's MCU range.
    native_scanner.validate_restart_spans(scan.spans, ri, total_mcus)
    s0 = (row0 * mpl) // ri
    s1 = min(len(scan.spans), -(-(row1 * mpl) // ri))

    # MCU rows the selected spans actually touch (spans need not align
    # with row boundaries): the band planes must cover all of them.
    first_mcu = s0 * ri
    cover_lo = first_mcu // mpl
    cover_hi = (
        -(-min(s1 * ri, total_mcus) // mpl) if s1 > s0 else row1
    )
    cover_hi = max(cover_hi, row1)

    band_planes = {}
    for cg in geo.components:
        band_planes[cg.component_index] = np.zeros(
            ((cover_hi - cover_lo) * cg.v, cg.blocks_per_line, 64), dtype=np.int16
        )
    if s1 > s0:
        native_scanner.decode_baseline_scan(
            data,
            list(scan.spans[s0:s1]),
            frame,
            scan_header,
            dec._dc_tables,
            dec._ac_tables,
            ri,
            band_planes,
            geo,
            first_mcu=first_mcu,
            mcu_row_offset=cover_lo,
            validate=False,
        )
    # else: region lies beyond a truncated stream's spans — stays zero
    # coefficients (mid-gray), matching the tolerated-truncation full
    # decode.

    quant = {}
    for comp_index, fc, _sc in resolve_scan_components(frame, scan_header):
        qt = dec._quant_tables.get(fc.quantization_table_selector)
        if qt is None or qt.is_empty:
            raise ValueError(
                f"Quantization table of component {comp_index} is not defined."
            )
        quant[comp_index] = qt.elements.astype(np.int32)

    # Synthesize the sub-image: same components, iMCU-snapped rect. The
    # block grid of the sliced planes matches frame_geometry of the
    # snapped dimensions exactly (both are whole-MCU grids).
    px_x0 = cx0 * 8 * mh
    px_y0 = row0 * 8 * mv
    sub_w = min(frame.samples_per_line, cx1 * 8 * mh) - px_x0
    sub_h = min(frame.number_of_lines, row1 * 8 * mv) - px_y0
    sub_frame = dataclasses.replace(
        frame, samples_per_line=sub_w, number_of_lines=sub_h
    )
    sub_geo = frame_geometry(sub_frame)

    coeffs = {}
    for cg in geo.components:
        p = band_planes[cg.component_index]
        r0 = (row0 - cover_lo) * cg.v
        r1 = (row1 - cover_lo) * cg.v
        coeffs[cg.component_index] = np.ascontiguousarray(
            p[r0:r1, cx0 * cg.h : cx1 * cg.h]
        )

    res = DecodeResult(
        frame=sub_frame,
        geometry=sub_geo,
        coefficients=coeffs,
        quant=quant,
        xp=xp,
        adobe_transform=adobe,
    )
    if frame.number_of_components == 4:
        img = res.to_cmyk8(upsample=upsample)
    else:
        img = res.to_rgb8(upsample=upsample)
    return _exact_crop(img, x - px_x0, y - px_y0, w, h)


def _region_banded(
    dec, stream, data, frame, scan_ris, x, y, w, h, upsample, adobe, xp,
    *, arithmetic: bool, progressive: bool
) -> Optional[np.ndarray]:
    """SOF2 / SOF9 / SOF10 band decode: each scan's covering restart
    spans decode as a standalone band (RSTn resets DC predictors + the
    EOB run in Huffman progressive scans,
    JpegHuffmanProgressiveScanDecoder.cs:196-224, and the whole
    register + statistics-bin state in arithmetic scans,
    JpegArithmeticSequentialScanDecoder.cs:138-165). Span subsets are
    snapped down to a unit-ROW boundary (first unit multiple of
    lcm(DRI, units-per-row)) so the native walkers' coordinates map
    onto band plane views directly."""
    from math import gcd

    from ..native import scanner as native_scanner

    if any(ri <= 0 for ri in scan_ris):
        return None
    if x + w > frame.samples_per_line or y + h > frame.number_of_lines:
        raise ValueError("Region exceeds image bounds.")

    geo = frame_geometry(frame)
    mh, mv = geo.max_h, geo.max_v
    mpl, mpc = geo.mcus_per_line, geo.mcus_per_column
    margin = 1 if upsample == "fancy" else 0
    row0 = max(0, y // (8 * mv) - margin)
    row1 = min(mpc, -(-(y + h) // (8 * mv)) + margin)
    cx0 = max(0, x // (8 * mh) - margin)
    cx1 = min(mpl, -(-(x + w) // (8 * mh)) + margin)

    sos_headers = [
        ScanHeader.parse(seg.payload(data))
        for seg in stream.segments
        if seg.marker == Marker.SOS
    ]
    if len(sos_headers) != len(stream.scans):
        return None

    # Resolve each scan's unit grid up front. Successive-approximation
    # refinement scans (Ah > 0) decode against the coefficient history
    # the earlier scans of the same band left behind — correction-bit /
    # arithmetic-context decoding desyncs when a unit's history is
    # missing — so when ANY scan refines, every scan must cover exactly
    # the SAME MCU rows: the snapped subsets are aligned to one shared
    # MCU-row multiple (lcm over all scans' restart/row alignments)
    # instead of each scan's own lcm(DRI, units/row). First-pass-only
    # scripts (all Ah == 0) have no cross-scan history, so per-scan
    # snapping stays (it covers fewer spans). T.81 B.2.4.4 allows DRI
    # to change between scans, which is what makes the per-scan snaps
    # diverge (advisor round-4 finding).
    grids = []
    for sh, ri_s, scan in zip(sos_headers, scan_ris, stream.scans):
        try:
            resolved = resolve_scan_components(frame, sh)
        except Exception:
            return None
        if len(resolved) > 1 or not progressive:
            # Frame-MCU-grid walk. Sequential scans ALWAYS walk the
            # frame grid — including non-interleaved (Ns=1) scans of a
            # multi-component frame, which the reference decodes with
            # the same interleaved walk restricted to the scan's
            # component (JpegArithmeticSequentialScanDecoder.cs:85-140
            # uses the frame's _mcusPerLine with the component's full
            # h x v blocks per MCU; the native walker mirrors it).
            if progressive and sh.start_of_spectral_selection != 0:
                return None  # invalid stream; full decode raises
            grids.append((sh, ri_s, scan, mpl, mpl * mpc, None, mpc))
        else:
            ci = resolved[0][0]
            cg = geo.components[ci]
            hbc = -(-geo.width // (8 * cg.hs))
            vbc = -(-geo.height // (8 * cg.vs))
            grids.append((sh, ri_s, scan, hbc, hbc * vbc, cg.v, vbc))

    shared = None
    if any(
        sh.successive_approximation_bit_position_high > 0
        for sh in sos_headers
    ):
        # Shared MCU-row alignment: the smallest row multiple at which
        # EVERY scan's span subset starts on a restart boundary.
        L = 1
        for _sh, ri_s, _scan, upr, _total, v_comp, _vbc in grids:
            align_ur = ri_s // gcd(ri_s, upr) * upr // upr
            if v_comp is not None:
                align_ur = align_ur // gcd(align_ur, v_comp)
            L = L // gcd(L, align_ur) * align_ur
        # A large L degrades gracefully: m0 floors to 0 and m1 rounds
        # up to the whole image — the band grows, exactness holds.
        m0 = (row0 // L) * L
        m1 = -(-row1 // L) * L
        if m1 >= mpc:
            m1 = mpc  # full tail: every scan runs to its last unit
        shared = (m0, m1)

    # Plan each scan's aligned covering span subset; the band planes
    # cover the union of the scans' snapped MCU-row ranges.
    plans = []
    u_lo, u_hi = row0, row1
    for sh, ri_s, scan, upr, total_units, v_comp, vbc in grids:
        native_scanner.validate_restart_spans(scan.spans, ri_s, total_units)
        if shared is not None:
            m0, m1 = shared
            if v_comp is None:
                first_unit = m0 * upr
                hi_u = total_units if m1 >= mpc else m1 * upr
            else:
                first_unit = m0 * v_comp * upr
                hi_u = min(m1 * v_comp, vbc) * upr
            if hi_u <= first_unit:
                plans.append(None)
                continue
            s0 = first_unit // ri_s
            s1 = -(-hi_u // ri_s)
            if s1 > len(scan.spans):
                # Truncated stream: this scan cannot reach the shared
                # end row, so the coverage sets would diverge — the
                # full decode owns truncation semantics.
                return None
        else:
            if v_comp is None:
                ur0, ur1 = row0, row1
            else:
                ur0 = min(row0 * v_comp, vbc)
                ur1 = min(row1 * v_comp, vbc)
            lo_u = ur0 * upr
            hi_u = min(ur1 * upr, total_units)
            if hi_u <= lo_u:
                plans.append(None)
                continue
            align = ri_s // gcd(ri_s, upr) * upr  # lcm(ri, units per row)
            first_unit = (lo_u // align) * align
            s0 = first_unit // ri_s
            s1 = min(len(scan.spans), -(-hi_u // ri_s))
            if s1 <= s0:
                plans.append(None)  # truncated stream: covered spans absent
                continue
        end_unit = min(s1 * ri_s, total_units)
        start_ur = first_unit // upr
        end_ur = -(-end_unit // upr)
        if v_comp is None:
            mlo, mhi = start_ur, end_ur
        else:
            mlo, mhi = start_ur // v_comp, -(-end_ur // v_comp)
        u_lo = min(u_lo, mlo)
        u_hi = max(u_hi, mhi)
        plans.append((sh, ri_s, scan, s0, s1, first_unit, end_unit, v_comp, start_ur))

    band_planes = {
        cg.component_index: np.zeros(
            ((u_hi - u_lo) * cg.v, cg.blocks_per_line, 64), dtype=np.int16
        )
        for cg in geo.components
    }

    # Decode each SOS with the table state in force at that point (DHT
    # and DRI may change between scans).
    scan_idx = 0
    for seg in stream.segments:
        if seg.marker in (Marker.DQT, Marker.DHT, Marker.DAC, Marker.DRI):
            dec._process_table_segment(seg, data)
        elif seg.marker == Marker.SOS:
            plan = plans[scan_idx]
            scan_idx += 1
            if plan is None:
                continue
            sh, ri_s, scan, s0, s1, first_unit, end_unit, v_comp, start_ur = plan
            views = {}
            for ci, _fc, _sc in resolve_scan_components(frame, sh):
                cg = geo.components[ci]
                off = (
                    (start_ur - u_lo) * cg.v
                    if v_comp is None
                    else start_ur - u_lo * cg.v
                )
                views[ci] = band_planes[ci][off:]
            if arithmetic:
                native_scanner.decode_arithmetic_scan(
                    data,
                    list(scan.spans[s0:s1]),
                    frame,
                    sh,
                    dec._dac_dc,
                    dec._dac_ac,
                    ri_s,
                    views,
                    geo,
                    progressive=progressive,
                    units_override=end_unit - first_unit,
                    validate=False,
                )
            else:
                native_scanner.decode_progressive_scan(
                    data,
                    list(scan.spans[s0:s1]),
                    frame,
                    sh,
                    dec._dc_tables,
                    dec._ac_tables,
                    ri_s,
                    views,
                    geo,
                    units_override=end_unit - first_unit,
                    validate=False,
                )

    quant = {}
    for idx, fc in enumerate(frame.components):
        qt = dec._quant_tables.get(fc.quantization_table_selector)
        if qt is None or qt.is_empty:
            raise ValueError(
                f"Quantization table of component {idx} is not defined."
            )
        quant[idx] = qt.elements.astype(np.int32)

    px_x0 = cx0 * 8 * mh
    px_y0 = row0 * 8 * mv
    sub_w = min(frame.samples_per_line, cx1 * 8 * mh) - px_x0
    sub_h = min(frame.number_of_lines, row1 * 8 * mv) - px_y0
    sub_frame = dataclasses.replace(
        frame, samples_per_line=sub_w, number_of_lines=sub_h
    )
    sub_geo = frame_geometry(sub_frame)
    coeffs = {}
    for cg in geo.components:
        p = band_planes[cg.component_index]
        r0 = (row0 - u_lo) * cg.v
        r1 = (row1 - u_lo) * cg.v
        coeffs[cg.component_index] = np.ascontiguousarray(
            p[r0:r1, cx0 * cg.h : cx1 * cg.h]
        )
    res = DecodeResult(
        frame=sub_frame,
        geometry=sub_geo,
        coefficients=coeffs,
        quant=quant,
        xp=xp,
        adobe_transform=adobe,
    )
    if frame.number_of_components == 4:
        img = res.to_cmyk8(upsample=upsample)
    else:
        img = res.to_rgb8(upsample=upsample)
    return _exact_crop(img, x - px_x0, y - px_y0, w, h)


def _region_lossless(
    dec, stream, data, frame, scan_ris, x, y, w, h, xp
) -> Optional[np.ndarray]:
    """SOF3 band decode, predictor 1 only: Ra-chains never reference
    the row above except at start-of-line (Rb), which stays inside a
    row-aligned restart span — so the covering spans decode as a
    standalone sub-image, bit-identical (predictors 2-7 reference the
    previous span's last row and must fall back)."""
    from ..native import scanner as native_scanner
    from .lossless import allocate_sample_planes

    if len(stream.scans) != 1 or len(scan_ris) != 1:
        return None
    ri = scan_ris[0]
    if ri <= 0:
        return None
    if any(
        fc.horizontal_sampling_factor != 1 or fc.vertical_sampling_factor != 1
        for fc in frame.components
    ):
        return None
    if x + w > frame.samples_per_line or y + h > frame.number_of_lines:
        raise ValueError("Region exceeds image bounds.")
    width = frame.samples_per_line
    height = frame.number_of_lines
    if ri % width != 0:
        return None

    scan_header: Optional[ScanHeader] = None
    for seg in stream.segments:
        if seg.marker in (Marker.DQT, Marker.DHT, Marker.DAC, Marker.DRI):
            dec._process_table_segment(seg, data)
        elif seg.marker == Marker.SOS:
            scan_header = ScanHeader.parse(seg.payload(data))
            break
    if scan_header is None or scan_header.start_of_spectral_selection != 1:
        return None

    scan = stream.scans[0]
    rows_per_span = ri // width
    native_scanner.validate_restart_spans(scan.spans, ri, width * height)
    s0 = y // rows_per_span
    s1 = min(len(scan.spans), -(-(y + h) // rows_per_span))
    cover_r0 = s0 * rows_per_span
    cover_r1 = max(y + h, min(height, s1 * rows_per_span))
    sub_frame = dataclasses.replace(frame, number_of_lines=cover_r1 - cover_r0)
    planes = allocate_sample_planes(sub_frame)
    if s1 > s0:
        native_scanner.decode_lossless_scan(
            data,
            list(scan.spans[s0:s1]),
            sub_frame,
            scan_header,
            dec._dc_tables,
            ri,
            planes,
        )
    # else: region beyond a truncated stream's spans stays zero samples,
    # matching the tolerated-truncation full decode.
    res = DecodeResult(
        frame=sub_frame,
        geometry=frame_geometry(sub_frame),
        samples=planes,
        xp=xp,
    )
    img = res.to_rgb8()
    return _exact_crop(img, x, y - cover_r0, w, h)

"""Lossless (SOF3) Huffman predictive decode.

Behavioral parity with the reference
(yigolden/JpegLibrary/src/JpegLibrary/ScanDecoder/JpegHuffmanLosslessScanDecoder.cs:52-223):
per-sample Huffman-coded differences (incl. the t==16 -> 32768 special
case), the 7 Annex-H predictors selected by StartOfSpectralSelection,
the 2^(P-Pt-1) initial prediction at scan/restart starts, and int16
wraparound sample storage. Output is one sub-resolution sample plane
per component (ceil(W/hs) x ceil(H/vs)); duplication upsampling to full
resolution happens in the shared output stage, matching
JpegPartialScanlineAllocator.WriteBlock (JpegPartialScanlineAllocator.cs:185-222).

Bit-exactness vs the reference is the gate for this mode (BASELINE.md).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ..io.bitreader import BitReader
from ..io.reader import EntropySpan
from ..syntax.frame import FrameHeader, ScanHeader, resolve_scan_components
from ..syntax.huffman import HuffmanDecodingTable
from .geometry import ceil_div
from .huffman_baseline import (
    JpegDecodeError,
    decode_huffman_code,
    receive_and_extend,
)
from .huffman_progressive import _SpanCursor, _wrap_int16


def allocate_sample_planes(frame: FrameHeader) -> Dict[int, np.ndarray]:
    """Per-component int16 sample planes on the padded MCU grid.

    Padded to mcusPerLine*h x mcusPerColumn*v so the interleaved decode
    loop never writes out of range; the output stage crops to the true
    component size ceil(W/hs) x ceil(H/vs).
    """
    max_h = frame.max_horizontal_sampling
    max_v = frame.max_vertical_sampling
    mcus_per_line = ceil_div(frame.samples_per_line, max_h)
    mcus_per_column = ceil_div(frame.number_of_lines, max_v)
    out = {}
    for idx, fc in enumerate(frame.components):
        h, v = fc.horizontal_sampling_factor, fc.vertical_sampling_factor
        out[idx] = np.zeros((mcus_per_column * v, mcus_per_line * h), dtype=np.int16)
    return out


def read_sample_lossless(reader: BitReader, table: HuffmanDecodingTable) -> int:
    """ReadSampleLossless (reference :210-223): t==16 means +32768."""
    t = decode_huffman_code(reader, table)
    if t == 16:
        return 32768
    if t != 0:
        t = receive_and_extend(reader, t)
    return t


def decode_lossless_scan(
    data: bytes,
    spans: Sequence[EntropySpan],
    frame: FrameHeader,
    scan: ScanHeader,
    dc_tables: Dict[int, HuffmanDecodingTable],
    restart_interval: int,
    sample_planes: Dict[int, np.ndarray],
) -> None:
    """Decode one lossless scan into the sample planes in place."""
    resolved = resolve_scan_components(frame, scan)
    comps = []
    for comp_index, fc, sc in resolved:
        table = dc_tables.get(sc.dc_table_selector)
        if table is None:
            raise JpegDecodeError(
                f"Huffman table of component {comp_index} is not defined."
            )
        comps.append(
            {
                "index": comp_index,
                "h": fc.horizontal_sampling_factor,
                "v": fc.vertical_sampling_factor,
                "table": table,
                "plane": sample_planes[comp_index],
            }
        )

    max_h = frame.max_horizontal_sampling
    max_v = frame.max_vertical_sampling
    mcus_per_line = ceil_div(frame.samples_per_line, max_h)
    mcus_per_column = ceil_div(frame.number_of_lines, max_v)

    predictor_sel = scan.start_of_spectral_selection
    pt = scan.successive_approximation_bit_position_low
    # Differential frames (T.81 J, predictor selection 0) code raw
    # diffs: prediction is 0 everywhere, including scan/restart starts
    # and line starts.
    initial_prediction = (
        (1 << (frame.sample_precision - pt - 1)) if predictor_sel else 0
    )

    cursor = _SpanCursor(data, spans)
    mcus_before_restart = restart_interval

    for row_mcu in range(mcus_per_column):
        for col_mcu in range(mcus_per_line):
            at_restart_start = restart_interval > 0 and mcus_before_restart == restart_interval
            for comp in comps:
                table = comp["table"]
                h, v = comp["h"], comp["v"]
                plane = comp["plane"]
                offset_x = col_mcu * h
                offset_y = row_mcu * v
                for y in range(v):
                    row = offset_y + y
                    scanline = plane[row]
                    lastline = None if (y == 0 and row_mcu == 0) else plane[row - 1]
                    for x in range(h):
                        diff = read_sample_lossless(cursor.reader, table)
                        cx = offset_x + x
                        if row_mcu == 0 or at_restart_start:
                            # First-line / restart-start prediction
                            # (reference :109-134).
                            if col_mcu == 0 and x == 0:
                                diff += initial_prediction
                            else:
                                ra = int(scanline[cx - 1])
                                rb = initial_prediction if y == 0 else int(lastline[cx])
                                rc = initial_prediction if y == 0 else int(lastline[cx - 1])
                                diff += _predict(predictor_sel, ra, rb, rc)
                        elif col_mcu == 0:
                            # Start of line: Rb (reference :136-139);
                            # sel 0 (differential): raw diff, no Rb.
                            if predictor_sel:
                                diff += int(lastline[cx])
                        else:
                            ra = int(scanline[cx - 1])
                            rb = int(lastline[cx])
                            rc = int(lastline[cx - 1])
                            diff += _predict(predictor_sel, ra, rb, rc)
                        scanline[cx] = _wrap_int16(diff)

            # Restart handling (reference :160-177): no predictor state
            # to reset — the restart-start condition above re-seeds it.
            if restart_interval > 0:
                mcus_before_restart -= 1
                if mcus_before_restart == 0:
                    if not cursor.advance_restart(
                        row_mcu == mcus_per_column - 1
                        and col_mcu == mcus_per_line - 1
                    ):
                        return
                    mcus_before_restart = restart_interval


# ---------------------------------------------------------------------------
# Lossless (SOF3) ENCODER — a capability beyond the reference (whose
# encoder is baseline-only, JpegEncoder.cs): produces streams our own
# bit-exact SOF3 decoder reads back losslessly. Interop caveat: the
# first sample row predicts with the SELECTED predictor using
# Rb = Rc = 2^(P-Pt-1), mirroring the reference decoder's behavior
# (JpegHuffmanLosslessScanDecoder.cs:109-134); T.81 H.1.2.2 instead
# mandates the Ra predictor for the rest of the first line, so for
# selectors 2, 3, 6 and 7 a strictly-conforming third-party decoder
# reconstructs the first row differently. Round trips through this
# repo's decoders (and the reference's) are exact for all selectors.
# Diff computation is fully vectorized (predictions depend only on the
# original samples — the codec is lossless, so reconstructed == source);
# bit packing runs in the native category packer.
# ---------------------------------------------------------------------------


def _lossless_diffs(s16: np.ndarray, sel: int, init: int, v: int = 1,
                    h: int = 1) -> np.ndarray:
    """Per-sample prediction differences for one component plane
    (int16-wrapped), mirroring the decoder's neighbor selection
    (JpegHuffmanLosslessScanDecoder.cs:122-152) including its
    interleaved-sampling quirks: plane row 0 uses Rb = Rc = the
    2^(P-Pt-1) initial prediction; in MCU row 0 the column-0 sample of
    EVERY row predicts from the initial prediction (`col_mcu == 0 &&
    x == 0` holds for all v rows); and from MCU row 1 on, ALL h columns
    of MCU column 0 predict from Rb (`col_mcu == 0` regardless of x)."""
    s = s16.astype(np.int32)
    ra = np.empty_like(s)
    ra[:, 1:] = s[:, :-1]
    ra[:, 0] = 0
    rb = np.empty_like(s)
    rb[1:, :] = s[:-1, :]
    rb[0, :] = init
    rc = np.empty_like(s)
    rc[1:, 1:] = s[:-1, :-1]
    rc[0, :] = init
    rc[1:, 0] = 0

    if sel == 1:
        pred = ra
    elif sel == 2:
        pred = rb
    elif sel == 3:
        pred = rc
    elif sel == 4:
        pred = ra + rb - rc
    elif sel == 5:
        pred = ra + ((rb - rc) >> 1)
    elif sel == 6:
        pred = rb + ((ra - rc) >> 1)
    elif sel == 7:
        pred = (ra + rb) >> 1
    else:
        raise ValueError(f"predictor {sel} not in 1..7")
    # MCU column 0, MCU rows >= 1: Rb regardless of selector (all h cols)
    pred[v:, :h] = s[v - 1 : -1, :h]  # planes always have >= v rows
    # MCU row 0: column 0 uses the initial prediction on every row
    pred[: min(v, s.shape[0]), 0] = init
    return (s - pred).astype(np.int16)  # mod-2^16 wrap


def encode_lossless(
    planes,
    *,
    precision: int = 8,
    predictor: int = 1,
    point_transform: int = 0,
    restart_interval: int = 0,
    sampling=None,
    size=None,
    differential: bool = False,
) -> bytes:
    """Encode sample planes as a lossless (SOF3) JPEG.

    ``planes``: [H, W] array, [H, W, C] array, or list of same-shape
    [H, W] planes (1x1 sampling, single interleaved scan). Values must
    fit ``precision`` bits. Optimal per-component Huffman tables are
    built from the category histogram (2-pass).

    ``restart_interval`` (MCUs, i.e. pixels at 1x1 sampling) emits DRI
    + RSTn markers: each restart segment's diff stream is
    bitstream-independent, the parallel seam the framework's
    restart-parallel lossless decoder exploits (the first sample of
    each segment re-predicts from the 2^(P-Pt-1) initial prediction,
    JpegHuffmanLosslessScanDecoder.cs:109-115).

    ``sampling``: per-component (h, v) factors for interleaved
    subsampled lossless (the committed _s22 fixtures' structure). Each
    plane must then be the PADDED component grid
    [mcus_per_column*v, mcus_per_line*h] and ``size`` = (H, W) supplies
    the true frame dimensions; restart intervals are not combined with
    sampling.

    ``differential``: encode a hierarchical differential-lossless frame
    (T.81 Annex J, SOF7): ``planes`` then hold raw signed sample
    DIFFERENCES (int, mod-2^16 wrapped) that are entropy-coded directly
    with predictor selection 0 — no prediction, no initial-prediction
    seed, no point-transform shift. The emitted frame is SOF7 with
    Ss = 0; the caller (models.hierarchical) embeds it after a DHP
    segment. ``predictor``/``point_transform`` are ignored.
    """
    from ..io.writer import JpegWriter
    from ..syntax.frame import (
        FrameComponent,
        FrameHeader,
        ScanComponent,
        ScanHeader,
    )
    from ..syntax.markers import Marker
    from .huffman_builder import HuffmanTableBuilder

    if isinstance(planes, np.ndarray) and planes.ndim == 3:
        planes = [planes[..., i] for i in range(planes.shape[-1])]
    elif isinstance(planes, np.ndarray):
        planes = [planes]
    planes = [np.asarray(p) for p in planes]
    n_comps = len(planes)
    if not 1 <= n_comps <= 4:
        raise ValueError("1..4 components supported")
    if sampling is None:
        sampling = [(1, 1)] * n_comps
        h, w = planes[0].shape
        if any(p.shape != (h, w) for p in planes):
            raise ValueError("all planes must share one shape (1x1 sampling)")
    else:
        if size is None:
            raise ValueError("size=(H, W) is required with sampling")
        if restart_interval:
            raise ValueError("restart intervals not supported with sampling")
        h, w = size
        max_h = max(s[0] for s in sampling)
        max_v = max(s[1] for s in sampling)
        mpl, mpc = ceil_div(w, max_h), ceil_div(h, max_v)
        for p, (ch, cv) in zip(planes, sampling):
            if p.shape != (mpc * cv, mpl * ch):
                raise ValueError(
                    f"plane shape {p.shape} != padded grid {(mpc * cv, mpl * ch)}"
                )

    if differential:
        predictor = 0
        point_transform = 0
    pt = point_transform
    init = 1 << (precision - pt - 1)

    # Fast path: 1x1 sampling, non-differential — the whole encode
    # stage (prediction diffs + category histograms + interleaved
    # restart-segmented pack) runs as two threaded native calls,
    # byte-identical to the staged numpy pipeline below.
    ri = restart_interval
    if not differential and all(s == (1, 1) for s in sampling):
        try:
            from ..native import scanner as native_scanner

            diffs_c = []
            tables = []
            for p in planes:
                d, hist = native_scanner.lossless_diffs_hist(
                    p, pt, predictor, init, ri
                )
                diffs_c.append(d)
                builder = HuffmanTableBuilder()
                builder.add_frequencies(hist)
                tables.append(builder.build(optimal=True))
            payload = native_scanner.pack_lossless_diffs(diffs_c, tables, ri)
            return _lossless_container(
                tables, payload, h, w, n_comps, sampling, precision,
                ri, differential, predictor=predictor, pt=pt
            )
        except ImportError:
            pass

    # Vectorized diffs -> categories + EXTEND bits per component.
    cats_c = []
    raws_c = []
    for p, (ch, cv) in zip(planes, sampling):
        s16 = (p.astype(np.int32) >> pt).astype(np.int16)
        if differential:
            # Values ARE the diffs (mod-2^16); no prediction pass.
            diff = s16.astype(np.int32)
        else:
            diff = _lossless_diffs(s16, predictor, init, v=cv, h=ch).astype(
                np.int32
            )
        if ri > 0 and not differential:
            # Restart-start pixels re-predict row-0 style.
            s = s16.astype(np.int32)
            pos = np.arange(ri, h * w, ri, dtype=np.int64)
            rows, cols = pos // w, pos % w
            ra = s[rows, np.maximum(cols - 1, 0)]
            if predictor == 1:
                pr = ra
            elif predictor in (2, 3):
                pr = np.full_like(ra, init)
            elif predictor == 4:
                pr = ra + init - init
            elif predictor == 5:
                pr = ra + ((init - init) >> 1)
            elif predictor == 6:
                pr = init + ((ra - init) >> 1)
            else:  # 7
                pr = (ra + init) >> 1
            pr = np.where(cols == 0, init, pr)
            diff[rows, cols] = (
                (s[rows, cols] - pr).astype(np.int16).astype(np.int32)
            )
        is_32768 = diff == -32768  # t == 16: no appended bits
        mag = np.abs(np.where(is_32768, 0, diff))
        cats = np.zeros(diff.shape, dtype=np.uint8)
        nz = mag > 0
        cats[nz] = (np.floor(np.log2(mag[nz])) + 1).astype(np.uint8)
        cats[is_32768] = 16
        raw = np.where(diff < 0, diff - 1, diff).astype(np.int64) & 0xFFFF
        cats_c.append(cats)
        raws_c.append(raw.astype(np.uint16))

    # 2-pass optimal tables from the category histograms.
    tables = []
    for cats in cats_c:
        builder = HuffmanTableBuilder()
        freq = np.bincount(cats.reshape(-1), minlength=256).astype(np.int64)
        builder.add_frequencies(freq)
        tables.append(builder.build(optimal=True))

    # Interleave in MCU walk order: per MCU, component c contributes
    # its v*h samples (y-major). At 1x1 sampling this is plain
    # sample-by-sample interleave.
    def mcu_order(arr, ch, cv):
        gh, gw = arr.shape
        mr, mc = gh // cv, gw // ch
        return (
            arr.reshape(mr, cv, mc, ch)
            .transpose(0, 2, 1, 3)
            .reshape(mr * mc, cv * ch)
        )

    cats_all = np.concatenate(
        [mcu_order(c, s[0], s[1]) for c, s in zip(cats_c, sampling)], axis=1
    ).reshape(-1)
    raws_all = np.concatenate(
        [mcu_order(r, s[0], s[1]) for r, s in zip(raws_c, sampling)], axis=1
    ).reshape(-1)
    # table index per position within one MCU
    pattern = np.concatenate(
        [np.full(s[0] * s[1], i, dtype=np.uint8) for i, s in enumerate(sampling)]
    )

    def pack(cats, raws):
        try:
            from ..native import scanner as native_scanner

            return native_scanner.pack_lossless(cats, raws, tables, pattern=pattern)
        except ImportError:
            return _pack_lossless_py(cats, raws, tables, pattern)

    if ri > 0:
        step = ri * n_comps
        try:
            from ..native import scanner as native_scanner

            # Whole restart-segmented scan in one threaded native call
            # (byte-identical to per-segment packing + RSTn joins; the
            # per-segment Python loop paid ~0.13 ms of call overhead
            # per segment — 4.2 MP at interval 2048 has 2048 of them).
            payload = native_scanner.pack_lossless_restart(
                cats_all, raws_all, tables, step, pattern=pattern
            )
        except ImportError:
            from ..syntax.markers import Marker as _M

            pieces = []
            total = cats_all.shape[0]
            for i, off in enumerate(range(0, total, step)):
                if off > 0:
                    pieces.append(bytes([0xFF, _M.RST0 + ((i - 1) & 7)]))
                pieces.append(
                    pack(cats_all[off:off + step], raws_all[off:off + step])
                )
            payload = b"".join(pieces)
    else:
        payload = pack(cats_all, raws_all)

    return _lossless_container(
        tables, payload, h, w, n_comps, sampling, precision, ri,
        differential, predictor=predictor, pt=pt
    )


def _lossless_container(tables, payload, h, w, n_comps, sampling, precision,
                        ri, differential, *, predictor=0, pt=0) -> bytes:
    """Shared SOF3/SOF7 container emission around a packed scan."""
    from ..io.writer import JpegWriter
    from ..syntax.frame import (
        FrameComponent,
        FrameHeader,
        ScanComponent,
        ScanHeader,
    )
    from ..syntax.markers import Marker

    writer = JpegWriter()
    writer.write_marker(Marker.SOI)
    dht_payload = b"".join(t.serialize(0, i) for i, t in enumerate(tables))
    writer.write_segment(Marker.DHT, dht_payload)
    sof = Marker.SOF7 if differential else Marker.SOF3
    frame = FrameHeader(
        marker=sof,
        sample_precision=precision,
        number_of_lines=h,
        samples_per_line=w,
        components=tuple(
            FrameComponent(i + 1, sampling[i][0], sampling[i][1], 0)
            for i in range(n_comps)
        ),
    )
    writer.write_segment(sof, frame.serialize())
    if ri > 0:
        writer.write_segment(Marker.DRI, bytes([(ri >> 8) & 0xFF, ri & 0xFF]))
    scan = ScanHeader(
        components=tuple(ScanComponent(i + 1, i, 0) for i in range(n_comps)),
        start_of_spectral_selection=predictor,
        end_of_spectral_selection=0,
        successive_approximation_bit_position_high=0,
        successive_approximation_bit_position_low=pt,
    )
    writer.write_segment(Marker.SOS, scan.serialize())
    writer.write_bytes(payload)
    writer.write_marker(Marker.EOI)
    return writer.to_bytes()  # single copy: the payload rides a chunk


def _pack_lossless_py(cats, raws, tables, pattern) -> bytes:
    """Pure-Python packer fallback (semantic reference for the native
    jpx_pack_lossless): entry i uses table pattern[i % len(pattern)]."""
    from ..io.writer import JpegWriter

    w = JpegWriter()
    w.enter_bit_mode()
    codes = [t.codes for t in tables]
    sizes = [t.sizes for t in tables]
    plen = len(pattern)
    for i in range(len(cats)):
        t = int(cats[i])
        ci = int(pattern[i % plen])
        w.write_bits(int(codes[ci][t]), int(sizes[ci][t]))
        if 0 < t < 16:
            w.write_bits(int(raws[i]) & ((1 << t) - 1), t)
    w.exit_bit_mode()
    return w.to_bytes()


def _predict(sel: int, ra: int, rb: int, rc: int) -> int:
    """The 7 Annex-H predictors (reference :122-132); 0/unknown -> 0."""
    if sel == 1:
        return ra
    if sel == 2:
        return rb
    if sel == 3:
        return rc
    if sel == 4:
        return ra + rb - rc
    if sel == 5:
        return ra + ((rb - rc) >> 1)
    if sel == 6:
        return rb + ((ra - rc) >> 1)
    if sel == 7:
        return (ra + rb) >> 1
    return 0


def component_sizes(frame: FrameHeader) -> Dict[int, tuple]:
    """True (height, width) of each component's sample plane:
    ceil over the *subsampling* factor (JpegPartialScanlineAllocator.cs:40-46)."""
    max_h = frame.max_horizontal_sampling
    max_v = frame.max_vertical_sampling
    out = {}
    for idx, fc in enumerate(frame.components):
        hs = max_h // fc.horizontal_sampling_factor
        vs = max_v // fc.vertical_sampling_factor
        out[idx] = (
            ceil_div(frame.number_of_lines, vs),
            ceil_div(frame.samples_per_line, hs),
        )
    return out

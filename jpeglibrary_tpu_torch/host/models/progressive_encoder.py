"""Progressive (SOF2) Huffman encoder — a capability beyond the
reference (its encoder is baseline-only, JpegEncoder.cs): full
spectral-selection + successive-approximation scan scripts with EOB-run
coding and refinement correction bits, emitted by the native inverses
of the progressive scan decoders (native/scanner.cpp
jpx_encode_prog_dc / _ac_first / _ac_refine). Optimal per-class Huffman
tables come from a count pass over the whole script (2-pass).

Validation gate: decode(encode_progressive(...)) is coefficient-exact
against the baseline encode of the same samples, through both the
native and pure-Python reference-parity decoders.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..io.writer import JpegWriter
from ..ops import encode_stage
from ..syntax.frame import FrameComponent, FrameHeader, ScanComponent, ScanHeader
from ..syntax.markers import Marker
from ..syntax.quantization import (
    scale_by_quality,
    standard_chrominance_table,
    standard_luminance_table,
)
from .geometry import ceil_div
from .huffman_builder import HuffmanTableBuilder

# (component_indices, Ss, Se, Ah, Al) — the classic libjpeg-style
# script: DC first at Al=1, AC bands coarse-to-fine, then refinements.
SCRIPT_3 = [
    ((0, 1, 2), 0, 0, 0, 1),
    ((0,), 1, 5, 0, 2),
    ((1,), 1, 63, 0, 1),
    ((2,), 1, 63, 0, 1),
    ((0,), 6, 63, 0, 2),
    ((0,), 1, 63, 2, 1),
    ((0, 1, 2), 0, 0, 1, 0),
    ((1,), 1, 63, 1, 0),
    ((2,), 1, 63, 1, 0),
    ((0,), 1, 63, 1, 0),
]

SCRIPT_1 = [
    ((0,), 0, 0, 0, 1),
    ((0,), 1, 5, 0, 2),
    ((0,), 6, 63, 0, 2),
    ((0,), 1, 63, 2, 1),
    ((0,), 0, 0, 1, 0),
    ((0,), 1, 63, 1, 0),
]


def encode_progressive_rgb(
    rgb: np.ndarray,
    quality: int = 75,
    *,
    subsampling: str = "420",
    script: Optional[List[Tuple]] = None,
    arithmetic: bool = False,
    restart_interval: int = 0,
) -> bytes:
    """RGB [H, W, 3] uint8 -> progressive JPEG bytes (SOF2 Huffman, or
    SOF10 when ``arithmetic``)."""
    from ..ops import color as color_ops

    if subsampling == "420":
        sampling = [(2, 2), (1, 1), (1, 1)]
    elif subsampling == "444":
        sampling = [(1, 1), (1, 1), (1, 1)]
    else:
        raise ValueError(f"unsupported subsampling {subsampling!r}")
    quants = [
        scale_by_quality(standard_luminance_table(0), quality),
        scale_by_quality(standard_chrominance_table(1), quality),
        scale_by_quality(standard_chrominance_table(1), quality),
    ]

    rgb = np.asarray(rgb, dtype=np.uint8)
    try:
        from ..native import scanner as native_scanner

        # Fused transform (one native stripe pass: convert + pad +
        # subsample + FDCT + quantize), then invert the MCU walk back
        # to the per-component block grid the progressive scan splitter
        # consumes — bit-identical to the staged path, one image read.
        max_h, max_v = sampling[0]
        h, w = rgb.shape[:2]
        mcl = ceil_div(w, 8 * max_h)
        mcc = ceil_div(h, 8 * max_v)
        mcu = native_scanner.encode_transform_rgb(
            rgb, max_h, max_v, [q.elements for q in quants]
        )
        coeffs = []
        for b, (ch, cv) in zip(mcu, sampling):
            coeffs.append(
                np.ascontiguousarray(
                    b.reshape(mcc, mcl, cv, ch, 64)
                    .transpose(0, 2, 1, 3, 4)
                    .reshape(mcc * cv, mcl * ch, 64)
                )
            )
        return encode_progressive(
            None, quants, sampling,
            quant_ids=[0, 1, 1], table_ids=[0, 1, 1],
            script=script or SCRIPT_3,
            arithmetic=arithmetic,
            restart_interval=restart_interval,
            coefficients=coeffs,
            size=(h, w),
        )
    except ImportError:
        y, cb, cr = color_ops.rgb_to_ycbcr(rgb[..., 0], rgb[..., 1], rgb[..., 2])

    return encode_progressive(
        [y, cb, cr], quants, sampling,
        quant_ids=[0, 1, 1], table_ids=[0, 1, 1],
        script=script or SCRIPT_3,
        arithmetic=arithmetic,
        restart_interval=restart_interval,
    )


def encode_progressive_gray(plane: np.ndarray, quality: int = 75,
                            *, script: Optional[List[Tuple]] = None,
                            arithmetic: bool = False,
                            restart_interval: int = 0) -> bytes:
    return encode_progressive(
        [np.asarray(plane)],
        [scale_by_quality(standard_luminance_table(0), quality)],
        [(1, 1)], quant_ids=[0], table_ids=[0],
        script=script or SCRIPT_1,
        arithmetic=arithmetic,
        restart_interval=restart_interval,
    )


def encode_progressive(
    planes: Sequence[np.ndarray],
    quant_tables,
    sampling: Sequence[Tuple[int, int]],
    *,
    quant_ids: Sequence[int],
    table_ids: Sequence[int],
    script: List[Tuple],
    arithmetic: bool = False,
    dc_conditioning: Tuple[int, int] = (0, 1),
    ac_conditioning: int = 5,
    coefficients: Optional[Sequence[np.ndarray]] = None,
    size: Optional[Tuple[int, int]] = None,
    precision: int = 8,
    restart_interval: int = 0,
    differential: bool = False,
) -> bytes:
    """Core progressive encode: sample planes -> SOF2 (Huffman) or
    SOF10 (arithmetic QM coder) stream.

    ``differential`` emits the hierarchical differential markers
    instead (SOF6 Huffman / SOF14 arithmetic, T.81 Table B.1) — the
    scan coding is IDENTICAL (progressive coefficient coding is
    lossless), only the frame type and the decoder's finalize (no
    level shift, add to the reference) differ. Callers pass
    ``coefficients`` holding quantized FDCTs of residuals computed
    with no level shift (models/hierarchical.py).

    ``coefficients`` (with ``size`` = (H, W)): pre-quantized zig-zag
    planes, skipping the sample transform — the lossless-transcode
    entry (models/transcode.py); ``planes`` is ignored then.

    ``restart_interval`` (in each scan's own units: MCUs for DC scans,
    blocks for AC scans) emits DRI + RSTn: every emitter state —
    predictors, EOB runs, refinement correction bits, QM registers and
    statistics — resets per segment, so segments are independent and
    the framework's progressive scanners decode them in parallel.
    """
    from ..native import scanner as native_scanner

    max_h = max(s[0] for s in sampling)
    max_v = max(s[1] for s in sampling)
    if coefficients is not None:
        n_comps = len(coefficients)
        h, w = size
        coeffs = [np.asarray(c, dtype=np.int16) for c in coefficients]
        mcus_per_line = ceil_div(w, 8 * max_h)
        mcus_per_column = ceil_div(h, 8 * max_v)
    else:
        n_comps = len(planes)
        h, w = planes[0].shape
        mcus_per_line = ceil_div(w, 8 * max_h)
        mcus_per_column = ceil_div(h, 8 * max_v)

        # Transform (same stage as the baseline encoder).
        coeffs = []
        for plane, (ch, cv), qid in zip(planes, sampling, quant_ids):
            q = quant_tables[qid].elements if hasattr(quant_tables[qid], "elements") else quant_tables[qid]
            coeffs.append(
                encode_stage.forward_component(
                    np.asarray(plane), q, ch, cv,
                    max_h // ch, max_v // cv,
                    mcus_per_line, mcus_per_column,
                )
            )

    # Per-scan block arrays: interleaved MCU order for DC scans, the
    # component's own (unpadded) block grid for AC scans
    # (JpegHuffmanProgressiveScanDecoder.cs:146-147).
    mcu_blocks = [
        encode_stage.mcu_order_blocks(c, s[0], s[1])
        for c, s in zip(coeffs, sampling)
    ]
    comp_blocks = []
    for c, (ch, cv) in zip(coeffs, sampling):
        hbc = ceil_div(w, 8 * (max_h // ch))
        vbc = ceil_div(h, 8 * (max_v // cv))
        comp_blocks.append(np.ascontiguousarray(c[:vbc, :hbc]).reshape(-1, 64))

    def scan_units(entry) -> int:
        comp_idx, ss, se, ah, al = entry
        if ss == 0:
            per0 = sampling[comp_idx[0]][0] * sampling[comp_idx[0]][1]
            return mcu_blocks[comp_idx[0]].shape[0] // per0
        return comp_blocks[comp_idx[0]].shape[0]

    def run_scan(entry, tables=None, dc_freqs=None, ac_freqs=None):
        """Emit (or count) one WHOLE scan in one native call. With
        restart_interval > 0 the emitter segments the scan internally
        (byte-aligned RSTn between segments, fresh coder state per
        segment — byte-identical to per-segment calls joined with
        RSTn, pinned by tests)."""
        comp_idx, ss, se, ah, al = entry
        ri = restart_interval
        if ss == 0:  # DC scan (interleaved over MCUs)
            per_mcu = [sampling[i][0] * sampling[i][1] for i in comp_idx]
            blocks = [mcu_blocks[i] for i in comp_idx]
            n_mcus = scan_units(entry)
            if arithmetic:
                return native_scanner.encode_arith_prog_dc(
                    blocks, per_mcu, n_mcus, ah, al,
                    [table_ids[i] for i in comp_idx],
                    dc_conditioning[0], dc_conditioning[1],
                    restart_interval=ri,
                )
            if ah != 0 and dc_freqs is not None:
                return None  # refinement: raw bits, no symbols to count
            if dc_freqs is not None:
                native_scanner.encode_prog_dc(
                    blocks, per_mcu, n_mcus, ah, al,
                    freqs=[dc_freqs[table_ids[i]] for i in comp_idx],
                    restart_interval=ri,
                )
                return None
            return native_scanner.encode_prog_dc(
                blocks, per_mcu, n_mcus, ah, al,
                tables=[tables[(True, table_ids[i])] for i in comp_idx],
                restart_interval=ri,
            )
        (ci,) = comp_idx  # AC scans are single-component; units = blocks
        blocks = comp_blocks[ci]
        if arithmetic:
            return native_scanner.encode_arith_prog_ac(
                blocks, table_ids[ci], ac_conditioning, ss, se, ah, al,
                restart_interval=ri,
            )
        fn = (
            native_scanner.encode_prog_ac_first
            if ah == 0
            else native_scanner.encode_prog_ac_refine
        )
        if ac_freqs is not None:
            fn(blocks, ss, se, al, freq=ac_freqs[table_ids[ci]],
               restart_interval=ri)
            return None
        return fn(blocks, ss, se, al, table=tables[(False, table_ids[ci])],
                  restart_interval=ri)

    # Pass 1 (Huffman only): symbol statistics over the whole script,
    # chunked identically to the emission pass (restart resets change
    # the EOB-run/DC-diff symbol mix). Scans (and restart chunks) are
    # statistically independent — every counter starts fresh — so the
    # count jobs fan out on the shared pool with job-local histograms
    # summed afterwards (the native counters increment their arrays in
    # place, so sharing them across jobs would race).
    tables = {}
    if not arithmetic:
        from ..utils.pool import shared_pool

        dc_freqs = {tid: np.zeros(256, dtype=np.int64) for tid in set(table_ids)}
        ac_freqs = {tid: np.zeros(256, dtype=np.int64) for tid in set(table_ids)}
        count_jobs = list(script)

        def count_one(entry):
            local_dc = {tid: np.zeros(256, dtype=np.int64) for tid in dc_freqs}
            local_ac = {tid: np.zeros(256, dtype=np.int64) for tid in ac_freqs}
            run_scan(entry, dc_freqs=local_dc, ac_freqs=local_ac)
            return local_dc, local_ac

        if len(count_jobs) > 1:
            results = list(shared_pool().map(count_one, count_jobs))
        else:
            results = [count_one(count_jobs[0])] if count_jobs else []
        for local_dc, local_ac in results:
            for tid in dc_freqs:
                dc_freqs[tid] += local_dc[tid]
                ac_freqs[tid] += local_ac[tid]

        for tid, freq in dc_freqs.items():
            if freq.sum() > 0:
                b = HuffmanTableBuilder()
                b.add_frequencies(freq)
                tables[(True, tid)] = b.build(optimal=True)
        for tid, freq in ac_freqs.items():
            if freq.sum() > 0:
                b = HuffmanTableBuilder()
                b.add_frequencies(freq)
                tables[(False, tid)] = b.build(optimal=True)

    # Pass 2: container + scans.
    writer = JpegWriter()
    writer.write_marker(Marker.SOI)
    seen = set()
    dqt = b""
    for qid in quant_ids:
        if qid in seen:
            continue
        seen.add(qid)
        qt = quant_tables[qid]
        dqt += qt.serialize()
    writer.write_segment(Marker.DQT, dqt)
    if differential:
        sof = Marker.SOF14 if arithmetic else Marker.SOF6
    else:
        sof = Marker.SOF10 if arithmetic else Marker.SOF2
    frame = FrameHeader(
        marker=sof,
        sample_precision=precision,
        number_of_lines=h,
        samples_per_line=w,
        components=tuple(
            FrameComponent(i + 1, sampling[i][0], sampling[i][1], quant_ids[i])
            for i in range(n_comps)
        ),
    )
    writer.write_segment(sof, frame.serialize())
    if arithmetic:
        dc_l, dc_u = dc_conditioning
        dac = bytearray()
        for tid in sorted(set(table_ids)):
            dac += bytes([tid, (dc_u << 4) | dc_l])
        for tid in sorted(set(table_ids)):
            dac += bytes([0x10 | tid, ac_conditioning])
        writer.write_segment(Marker.DAC, bytes(dac))
    else:
        dht = b"".join(
            tables[key].serialize(0 if key[0] else 1, key[1])
            for key in sorted(tables, key=lambda k: (not k[0], k[1]))
        )
        writer.write_segment(Marker.DHT, dht)

    if restart_interval > 0:
        ri = restart_interval
        writer.write_segment(Marker.DRI, bytes([(ri >> 8) & 0xFF, ri & 0xFF]))

    # Every scan (and restart chunk) emits from fresh coder state, so
    # the payloads are independent byte strings — fan the emission out
    # on the shared pool and write them in script order.
    from ..utils.pool import shared_pool

    if len(script) > 1:
        payloads = iter(
            shared_pool().map(lambda e: run_scan(e, tables=tables), script)
        )
    else:
        payloads = iter([run_scan(e, tables=tables) for e in script])

    for entry in script:
        comp_idx, ss, se, ah, al = entry
        scan = ScanHeader(
            components=tuple(
                ScanComponent(i + 1, table_ids[i], table_ids[i]) for i in comp_idx
            ),
            start_of_spectral_selection=ss,
            end_of_spectral_selection=se,
            successive_approximation_bit_position_high=ah,
            successive_approximation_bit_position_low=al,
        )
        writer.write_segment(Marker.SOS, scan.serialize())
        # one whole-scan payload (RSTn separators already embedded)
        writer.write_bytes(next(payloads))

    writer.write_marker(Marker.EOI)
    return writer.to_bytes()

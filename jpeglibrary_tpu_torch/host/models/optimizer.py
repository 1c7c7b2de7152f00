"""Lossless Huffman re-optimization of baseline JPEG files.

Capability parity with the reference JpegOptimizer
(yigolden/JpegLibrary/src/JpegLibrary/JpegOptimizer.cs:16-893):

- ``scan()`` (pass 1, :72-150): decode the entropy stream and count
  code frequencies per Huffman table, then build replacement tables
  (Annex-K or package-merge per ``most_optimal_coding``).
- ``optimize(strip)`` (pass 2, :546-650): re-emit the file, copying
  markers in order, replacing the first DHT with the new tables,
  re-serializing DQT, optionally stripping APPn/COM metadata, and
  re-encoding every scan's entropy data (with RSTn markers re-emitted
  between restart segments, :794-815).

Architecture differences (TPU pipeline, same observable capability):
- pass 1 uses the native restart-parallel scanner to produce
  coefficient planes, then counts symbols via vectorized histograms —
  the frequencies of the *canonical* symbol stream, which pass 2 also
  emits, so the two passes agree by construction;
- DRI segments are preserved (the reference's Optimize drops them into
  the default strip path);
- progressive input raises, like the reference (:580-582).

Gate (OptimizerTests.cs:28-58): output strictly smaller AND decoding
pixel-identical to the input.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io import reader as io_reader
from ..io.writer import JpegWriter
from ..ops import encode_stage
from ..syntax.frame import FrameHeader, ScanHeader, resolve_scan_components
from ..syntax.huffman import HuffmanEncodingTable, parse_dht_segment
from ..syntax.markers import ALL_SOF_MARKERS, Marker, is_restart_marker
from ..syntax.quantization import QuantizationTable, parse_dqt_segment
from . import huffman_baseline
from .geometry import FrameGeometry, allocate_coefficient_planes, frame_geometry
from .huffman_builder import HuffmanTableBuilder


class JpegOptimizeError(ValueError):
    pass


@dataclasses.dataclass
class _ScanRecord:
    header: ScanHeader
    restart_interval: int
    terminators: Tuple[Optional[int], ...]


class JpegOptimizer:
    def __init__(self):
        self.most_optimal_coding = False
        self._data: Optional[bytes] = None
        self._tables: Dict[Tuple[bool, int], HuffmanEncodingTable] = {}
        self._frame: Optional[FrameHeader] = None
        self._geometry: Optional[FrameGeometry] = None
        self._planes: Optional[Dict[int, np.ndarray]] = None
        self._scan_records: List[_ScanRecord] = []

    def set_input(self, data: bytes) -> None:
        self._data = bytes(data)
        # Per-image state resets with the input (the decoder's
        # set_input does the same): stale scan records from a previous
        # image would pair with the new image's scans in optimize().
        self._scan_records = []
        self._frame = None
        self._geometry = None
        self._planes = None
        self._tables = {}

    def scan(self) -> None:
        """Pass 1: decode + frequency statistics + table build."""
        data = self._data
        if data is None:
            raise JpegOptimizeError("Input is not specified.")
        stream = io_reader.parse_stream(data)

        dc_tables: Dict[int, object] = {}
        ac_tables: Dict[int, object] = {}
        frame: Optional[FrameHeader] = None
        geometry: Optional[FrameGeometry] = None
        planes: Optional[Dict[int, np.ndarray]] = None
        restart_interval = 0
        builders: Dict[Tuple[bool, int], HuffmanTableBuilder] = {}
        scan_iter = iter(stream.scans)

        for seg in stream.segments:
            if seg.marker == Marker.DHT:
                for t in parse_dht_segment(seg.payload(data)):
                    registry = dc_tables if t.table_class == 0 else ac_tables
                    registry[t.identifier] = t
            elif seg.marker == Marker.DRI:
                payload = seg.payload(data)
                if len(payload) < 2:
                    raise JpegOptimizeError("Truncated DRI segment.")
                restart_interval = (payload[0] << 8) | payload[1]
            elif seg.marker in ALL_SOF_MARKERS:
                if seg.marker == Marker.SOF2:
                    raise JpegOptimizeError("Progressive JPEG is not supported currently.")
                if seg.marker not in (Marker.SOF0, Marker.SOF1):
                    raise JpegOptimizeError(
                        f"This type of JPEG stream is not supported ({Marker(seg.marker).name})."
                    )
                if frame is not None:
                    raise JpegOptimizeError("Multiple frame is not supported.")
                frame = io_reader.resolve_dnl(
                    stream, data, FrameHeader.parse(seg.payload(data), seg.marker)
                )
                geometry = frame_geometry(frame)
                planes = allocate_coefficient_planes(geometry)
            elif seg.marker == Marker.SOS:
                if frame is None:
                    raise JpegOptimizeError("Frame header is missing.")
                scan = next(scan_iter)
                scan_header = ScanHeader.parse(seg.payload(data))
                decoded = False
                try:
                    from ..native import scanner as native_scanner

                    decoded = native_scanner.decode_baseline_scan(
                        data, scan.spans, frame, scan_header,
                        dc_tables, ac_tables, restart_interval, planes, geometry,
                    )
                except ImportError:
                    decoded = False
                if not decoded:
                    huffman_baseline.decode_baseline_scan(
                        data, scan.spans, frame, scan_header,
                        dc_tables, ac_tables, restart_interval, planes, geometry,
                    )
                self._scan_records.append(
                    _ScanRecord(
                        header=scan_header,
                        restart_interval=restart_interval,
                        terminators=tuple(s.terminator for s in scan.spans),
                    )
                )
                # Frequency statistics per referenced table.
                for comp_index, fc, sc in resolve_scan_components(frame, scan_header):
                    cg = geometry.components[comp_index]
                    blocks = encode_stage.mcu_order_blocks(
                        planes[comp_index], cg.h, cg.v
                    )
                    dc_freq, ac_freq = encode_stage.dc_ac_symbol_frequencies(blocks)
                    if restart_interval > 0:
                        # Pass 2 resets DC predictors at every restart
                        # boundary; correct the one-chain histogram so
                        # segment-start categories are present in the
                        # built table (same fixup the encoder applies).
                        encode_stage.apply_restart_dc_fixup(
                            dc_freq, blocks, cg.h * cg.v, restart_interval
                        )
                    builders.setdefault(
                        (True, sc.dc_table_selector), HuffmanTableBuilder()
                    ).add_frequencies(dc_freq)
                    builders.setdefault(
                        (False, sc.ac_table_selector), HuffmanTableBuilder()
                    ).add_frequencies(ac_freq)
            elif seg.marker == Marker.EOI:
                break

        if frame is None or not self._scan_records:
            raise JpegOptimizeError("No image data is read.")

        self._frame = frame
        self._geometry = geometry
        self._planes = planes
        self._tables = {
            key: b.build(optimal=self.most_optimal_coding) for key, b in builders.items()
        }

    def optimize(self, strip: bool = True, keep=None) -> bytes:
        """Pass 2: re-emit the file with the optimized tables.

        ``strip`` drops APPn/COM metadata like the reference
        (JpegOptimizer.Optimize(strip), JpegOptimizer.cs:546,:632-643).
        ``keep`` refines it: a predicate ``keep(marker, payload) ->
        bool`` consulted for each metadata segment — segments it
        accepts are preserved even when stripping (e.g. keep EXIF but
        drop comments), and rejected ones are dropped even when not
        stripping.
        """
        data = self._data
        if not self._tables:
            raise JpegOptimizeError("scan() must run before optimize().")
        stream = io_reader.parse_stream(data)

        writer = JpegWriter()
        dht_written = False
        dqt_written = False
        scan_index = 0

        for seg in stream.segments:
            m = seg.marker
            if m == Marker.SOI:
                writer.write_marker(m)
            elif m in (Marker.APP0,) or m in ALL_SOF_MARKERS:
                writer.write_segment(m, seg.payload(data))
            elif m == Marker.DHT:
                if not dht_written:
                    payload = b"".join(
                        self._tables[key].serialize(0 if key[0] else 1, key[1])
                        for key in sorted(self._tables, key=lambda k: (not k[0], k[1]))
                    )
                    writer.write_segment(Marker.DHT, payload)
                    dht_written = True
            elif m == Marker.DQT:
                if not dqt_written:
                    payload = b"".join(
                        t.serialize() for t in parse_all_quant_tables(stream, data)
                    )
                    writer.write_segment(Marker.DQT, payload)
                    dqt_written = True
            elif m in (Marker.DRI, Marker.DNL):
                # DNL is structural, not metadata: a zero-lines SOF is
                # invalid without it, so it survives stripping.
                writer.write_segment(m, seg.payload(data))
            elif m == Marker.SOS:
                writer.write_segment(m, seg.payload(data))
                record = self._scan_records[scan_index]
                scan_index += 1
                self._emit_scan(writer, record)
            elif m == Marker.EOI:
                writer.write_marker(m)
                break
            elif is_restart_marker(m):
                pass  # re-emitted by _emit_scan
            else:
                if keep is not None:
                    payload = seg.payload(data)
                    if keep(m, payload):
                        writer.write_segment(m, payload)
                elif not strip:
                    writer.write_segment(m, seg.payload(data))

        return writer.to_bytes()

    def _emit_scan(self, writer: JpegWriter, record: _ScanRecord) -> None:
        """Re-encode one scan's entropy data with the new tables,
        re-emitting the original restart markers between segments
        (CopyScanBaseline, JpegOptimizer.cs:716-834)."""
        from .encoder import _encode_block

        frame, geo = self._frame, self._geometry
        comps = []
        for comp_index, fc, sc in resolve_scan_components(frame, record.header):
            cg = geo.components[comp_index]
            blocks = encode_stage.mcu_order_blocks(
                self._planes[comp_index], cg.h, cg.v
            )
            dc = self._tables[(True, sc.dc_table_selector)]
            ac = self._tables[(False, sc.ac_table_selector)]
            comps.append(
                {
                    "blocks": blocks,
                    "per_mcu": cg.h * cg.v,
                    "dc_codes": dc.codes, "dc_sizes": dc.sizes,
                    "ac_codes": ac.codes, "ac_sizes": ac.sizes,
                    "predictor": 0,
                    "cursor": 0,
                }
            )

        total_mcus = geo.mcus_per_line * geo.mcus_per_column
        restart_interval = record.restart_interval

        native_emit = None
        try:
            from ..native import scanner as native_scanner

            native_emit = native_scanner.encode_segment
        except ImportError:
            pass

        def emit_segment(first_mcu: int, n_mcus: int) -> None:
            """One byte-aligned entropy segment (fresh DC predictors)."""
            if native_emit is not None:
                seg_comps = [
                    {
                        **c,
                        "blocks": c["blocks"][first_mcu * c["per_mcu"]:],
                    }
                    for c in comps
                ]
                writer.write_bytes(native_emit(seg_comps, n_mcus))
                return
            writer.enter_bit_mode()
            write_bits = writer.write_bits
            for c in comps:
                c["predictor"] = 0
                c["cursor"] = first_mcu * c["per_mcu"]
            for _ in range(n_mcus):
                for c in comps:
                    blocks = c["blocks"]
                    for _ in range(c["per_mcu"]):
                        _encode_block(write_bits, c, blocks[c["cursor"]])
                        c["cursor"] += 1
            writer.exit_bit_mode()

        if restart_interval <= 0:
            if native_emit is not None:
                # chunk-parallel shift-merge emission (bit-identical)
                writer.write_bytes(native_emit(comps, total_mcus, parallel=True))
            else:
                emit_segment(0, total_mcus)
            return

        # Restart segments are independent byte-aligned streams. The
        # normal case (terminators are the canonical cycling RSTn
        # sequence) emits the whole scan in ONE native call (fresh
        # predictors per segment, RSTn embedded, threaded over segment
        # ranges — per-segment wrapper calls cost ~100 us each).
        n_seg = -(-total_mcus // restart_interval)
        if (
            native_emit is not None
            and total_mcus > restart_interval
            and len(record.terminators) >= n_seg - 1
            and all(
                record.terminators[i] == Marker.RST0 + (i & 7)
                for i in range(n_seg - 1)
            )
        ):
            writer.write_bytes(
                native_emit(comps, total_mcus, restart_interval=restart_interval)
            )
            return

        # Irregular terminators (truncated/corrupt input scan): emit
        # segments concurrently and write the ORIGINAL terminator
        # sequence between them (parallel twin of the serial loop).
        if native_emit is not None and total_mcus > restart_interval:
            from ..utils.pool import shared_pool

            spans = []
            mcu = 0
            while mcu < total_mcus:
                spans.append((mcu, min(restart_interval, total_mcus - mcu)))
                mcu += restart_interval

            def one(span):
                first, count = span
                seg_comps = [
                    {**c, "blocks": c["blocks"][first * c["per_mcu"]:]}
                    for c in comps
                ]
                return native_emit(seg_comps, count)

            payloads = list(shared_pool().map(one, spans))
            for segment_index, payload in enumerate(payloads):
                writer.write_bytes(payload)
                if segment_index + 1 >= len(payloads):
                    break
                terminator = (
                    record.terminators[segment_index]
                    if segment_index < len(record.terminators)
                    else None
                )
                if terminator is None or not is_restart_marker(terminator):
                    break  # truncated input scan: stop like the decoder did
                writer.write_marker(terminator)
            return

        mcu = 0
        segment_index = 0
        while mcu < total_mcus:
            n = min(restart_interval, total_mcus - mcu)
            emit_segment(mcu, n)
            mcu += n
            if mcu >= total_mcus:
                break
            terminator = (
                record.terminators[segment_index]
                if segment_index < len(record.terminators)
                else None
            )
            segment_index += 1
            if terminator is None or not is_restart_marker(terminator):
                break  # truncated input scan: stop like the decoder did
            writer.write_marker(terminator)


def parse_all_quant_tables(stream: io_reader.JpegStream, data: bytes) -> List[QuantizationTable]:
    """All DQT definitions, collapsed to one up-front segment. A table
    id REDEFINED with different values mid-stream (legal per T.81 —
    later scans dequantize with the later table) cannot be collapsed
    without changing decoded pixels, so it is refused."""
    import numpy as np

    tables: Dict[int, QuantizationTable] = {}
    for seg in stream.segments:
        if seg.marker == Marker.DQT:
            for t in parse_dqt_segment(seg.payload(data)):
                prev = tables.get(t.identifier)
                if prev is not None and not np.array_equal(
                    prev.elements, t.elements
                ):
                    raise JpegOptimizeError(
                        f"Quantization table {t.identifier} is redefined "
                        "mid-stream; collapsing the definitions would "
                        "change decoded pixels."
                    )
                tables[t.identifier] = t
    return list(tables.values())


def optimize(data: bytes, *, strip: bool = True, most_optimal_coding: bool = True) -> bytes:
    """One-shot convenience: scan + optimize (OptimizeAction.cs:20-27)."""
    opt = JpegOptimizer()
    opt.most_optimal_coding = most_optimal_coding
    opt.set_input(data)
    opt.scan()
    return opt.optimize(strip=strip)

"""Bounded-memory streaming decode, host half: the stripe split of the
compact payloads and the lossless row stream.

The port's copy of the host half of ``jpeglibrary_tpu/models/streaming.py``
(``_stripe_geometry``, ``split_payload_stripes``, ``split_payload2_stripes``
and ``decode_lossless_rows``); its device half (``decode_rgb_stripes``,
``_stripes_from_payload2``, ``decode_rgb_streaming``) is
``jpeglibrary_tpu_torch.models.streaming``.

Bounded-memory streaming decode: MCU-row stripes pushed to a
consumer.

The reference's pivot abstraction is a user-pluggable
``JpegBlockOutputWriter`` receiving 8x8 blocks as they decode
(yigolden/JpegLibrary/src/JpegLibrary/JpegBlockOutputWriter.cs:8-18), which
gives O(1)-memory push-based baseline decode for gigapixel inputs. The
TPU-native equivalent trades per-block callbacks (hopeless for a
batched device) for per-STRIPE delivery: the merged entropy scan
produces the compact sparse payload (v2 split-stream wire, ~2 bytes
per nonzero AC coefficient — far below one RGB plane), whose blocks
are ordered by MCU row, so any row range is a contiguous slice; each
stripe then runs the fused device transform at stripe shape and is
handed to the consumer before the next one materializes. Peak memory
= sparse payload + one stripe.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

from .decoder import JpegDecoder
from .geometry import FrameGeometry


def _stripe_geometry(base: FrameGeometry, mcu_rows: int, height: int) -> FrameGeometry:
    """FrameGeometry restricted to a stripe of MCU rows (same component
    set, reduced row count) — the jitted transforms compile at stripe
    shape and are shared by every full stripe."""
    comps = tuple(
        dataclasses.replace(c, blocks_per_column=mcu_rows * c.v)
        for c in base.components
    )
    return dataclasses.replace(
        base, height=height, mcus_per_column=mcu_rows, components=comps
    )


def split_payload_stripes(res, stripe_mcu_rows: int):
    """Slice a merged-scan sparse payload into per-MCU-row-stripe
    payloads (entries are MCU-row ordered, so stripes are contiguous
    slices with a rebased first delta). Returns
    (stripe_payloads [S, 2n] int16 bucket-padded uniformly, geometry,
    quants [C, 64] int32, stripe_heights list) — shared by the
    bounded-memory streaming decode and the stripe-sharded mesh decode.
    """
    geo = res.geometry
    packed = res.packed_mcu.reshape(-1, 2)
    deltas = packed[:, 0].astype(np.int64) & 0xFFFF
    pad = np.flatnonzero((deltas == 0) & (packed[:, 1] == 0))
    n_entries = int(pad[0]) if len(pad) else len(packed)
    pos = np.cumsum(deltas[:n_entries]) - 1

    cpm = 64 * sum(c.h * c.v for c in geo.components)
    cpr = geo.mcus_per_line * cpm
    quants = np.stack(
        [res.quant[c.component_index] for c in geo.components]
    ).astype(np.int32)

    chunks = []
    heights = []
    px_per_row = 8 * geo.max_v
    for r0 in range(0, geo.mcus_per_column, stripe_mcu_rows):
        r1 = min(r0 + stripe_mcu_rows, geo.mcus_per_column)
        lo = int(np.searchsorted(pos, r0 * cpr, side="left"))
        hi = int(np.searchsorted(pos, r1 * cpr, side="left"))
        first = lo
        while first < hi and packed[first, 1] == 0 and deltas[first] == 0xFFFF:
            first += 1
        body = packed[first:hi]
        if len(body):
            lead = int(pos[first]) - r0 * cpr + 1
            n_esc = lead // 0xFFFF
            rem = lead - n_esc * 0xFFFF
        else:
            n_esc = rem = 0
        chunks.append((n_esc, rem, body))
        heights.append(min((r1 - r0) * px_per_row, geo.height - r0 * px_per_row))

    n_out = max(n_esc + len(b) for n_esc, _, b in chunks)
    bucket = 1024
    while bucket < n_out:
        bucket = (int(bucket * 1.5) + 1023) & ~1023
    out = np.zeros((len(chunks), bucket, 2), dtype=np.int16)
    for i, (n_esc, rem, body) in enumerate(chunks):
        if n_esc:
            out[i, :n_esc, 0] = np.int16(-1)
        if len(body):
            out[i, n_esc : n_esc + len(body)] = body
            out[i, n_esc, 0] = np.int16(rem)
    return out.reshape(len(chunks), -1), geo, quants, heights


def split_payload2_stripes(res, stripe_mcu_rows: int):
    """v2-wire twin of :func:`split_payload_stripes`: slice a v2
    split-stream payload into per-stripe v2 payloads. Blocks are
    MCU-major, so a stripe is a contiguous block range — dc/counts
    slice directly, the AC streams slice at cumsum(counts) boundaries,
    and exceptions filter + rebase by the stripe's first coefficient.
    Stripes share one uniform block count (trailing zero blocks pad
    the short last stripe — zero DC + zero counts decode to zero
    blocks) and one AC bucket, so a single compiled stripe transform
    serves all of them. Returns (stripe_payloads [S, K] uint8,
    geometry, quants, stripe_heights)."""
    from ..native.scanner import exception_capacity, v2_payload_bn

    geo = res.geometry
    payload = res.packed_mcu2
    bpm = sum(c.h * c.v for c in geo.components)
    nb = geo.mcus_per_line * geo.mcus_per_column * bpm
    bn = v2_payload_bn(payload, nb)
    dc = payload[: 2 * nb].view(np.int16)
    counts = payload[2 * nb : 3 * nb]
    acpos = payload[3 * nb : 3 * nb + bn]
    acval = payload[3 * nb + bn : 3 * nb + 2 * bn]
    be = bn // 64
    exc = payload[3 * nb + 2 * bn :].view(np.int32).reshape(be, 2)
    exc_live = exc[exc[:, 1] != 0]
    ends = np.cumsum(counts.astype(np.int64))

    quants = np.stack(
        [res.quant[c.component_index] for c in geo.components]
    ).astype(np.int32)

    bpr = geo.mcus_per_line * bpm  # blocks per MCU row
    nb_stripe = stripe_mcu_rows * bpr  # uniform (last stripe zero-padded)
    chunks = []
    heights = []
    px_per_row = 8 * geo.max_v
    for r0 in range(0, geo.mcus_per_column, stripe_mcu_rows):
        r1 = min(r0 + stripe_mcu_rows, geo.mcus_per_column)
        b_lo, b_hi = r0 * bpr, r1 * bpr
        e_lo = int(ends[b_lo - 1]) if b_lo else 0
        e_hi = int(ends[b_hi - 1]) if b_hi else 0
        sel = exc_live[
            (exc_live[:, 0] >= b_lo * 64) & (exc_live[:, 0] < b_hi * 64)
        ].copy()
        sel[:, 0] -= b_lo * 64
        chunks.append((b_lo, b_hi, e_lo, e_hi, sel))
        heights.append(
            min((r1 - r0) * px_per_row, geo.height - r0 * px_per_row)
        )

    need = max(
        [e_hi - e_lo for (_b0, _b1, e_lo, e_hi, _x) in chunks] + [1]
    )
    need_exc = max(len(x) for (_b0, _b1, _e0, _e1, x) in chunks)
    sbn = 1024
    while sbn < need or exception_capacity(sbn) < need_exc:
        sbn = (int(sbn * 1.5) + 1023) & ~1023
    sbe = exception_capacity(sbn)
    sk = 3 * nb_stripe + 2 * sbn + 8 * sbe
    out = np.zeros((len(chunks), sk), dtype=np.uint8)
    for i, (b_lo, b_hi, e_lo, e_hi, sel) in enumerate(chunks):
        nblk = b_hi - b_lo
        row = out[i]
        row[: 2 * nblk] = dc[b_lo:b_hi].view(np.uint8)
        row[2 * nb_stripe : 2 * nb_stripe + nblk] = counts[b_lo:b_hi]
        n_ac = e_hi - e_lo
        row[3 * nb_stripe : 3 * nb_stripe + n_ac] = acpos[e_lo:e_hi]
        row[3 * nb_stripe + sbn : 3 * nb_stripe + sbn + n_ac] = acval[
            e_lo:e_hi
        ]
        if len(sel):
            ev = row[3 * nb_stripe + 2 * sbn :].view(np.int32).reshape(sbe, 2)
            ev[: len(sel)] = sel
    return out, geo, quants, heights


def decode_lossless_rows(
    data: bytes, *, mcu_rows: int = 16
) -> Iterator[Tuple[int, dict]]:
    """Bounded-memory lossless (SOF3) decode: yields
    ``(y0, {component_index: int16 sample rows})`` panels top to
    bottom, each covering ``mcu_rows`` MCU rows (``mcu_rows * v_i``
    sample rows per component; the final panel is cropped to the image
    height for 1x1 sampling). Peak memory is O(width) — the native
    cursor carries only the bit position, restart-span state, and one
    previous row per component, the TPU-native form of the reference's
    16-row scanline ring (JpegPartialScanlineAllocator.cs:11,60).

    Sample values are bit-identical to ``jt.decode(data).planes``
    (predictor-domain samples, same truncation tolerance)."""
    from ..io import reader as io_reader
    from ..native import scanner as native_scanner
    from ..syntax.frame import FrameHeader, ScanHeader
    from ..syntax.markers import ALL_SOF_MARKERS, Marker

    dec = JpegDecoder()
    dec.set_input(data)
    stream = io_reader.parse_stream(data)
    scan_iter = iter(stream.scans)
    frame = None
    for seg in stream.segments:
        if seg.marker in (Marker.DQT, Marker.DHT, Marker.DAC, Marker.DRI):
            dec._process_table_segment(seg, data)
        elif seg.marker == Marker.SOF3:
            frame = io_reader.resolve_dnl(
                stream, data, FrameHeader.parse(seg.payload(data), seg.marker)
            )
        elif seg.marker in ALL_SOF_MARKERS and seg.marker != Marker.SOF3:
            raise ValueError(
                "decode_lossless_rows requires a lossless (SOF3) stream"
            )
        elif seg.marker == Marker.SOS:
            if frame is None:
                raise ValueError("Frame header was not found before SOS.")
            if len(stream.scans) > 1:
                # Multi-scan (non-interleaved per-component) lossless
                # streams would need one row cursor per scan stitched
                # row-wise; refuse rather than silently yield only the
                # first scan's component(s).
                raise ValueError(
                    "decode_lossless_rows supports single-scan "
                    "(interleaved) lossless streams; this stream has "
                    f"{len(stream.scans)} scans — use jt.decode()."
                )
            scan = next(scan_iter)
            scan_header = ScanHeader.parse(seg.payload(data))
            rows = native_scanner.LosslessRowStream(
                data, scan.spans, frame, scan_header,
                dec._dc_tables, dec._restart_interval,
            )
            rows_per_panel = mcu_rows * rows.rows_per_mcu
            with rows:
                y0 = 0
                while True:
                    panels = rows.next_rows(mcu_rows)
                    if panels is None:
                        return
                    if rows.rows_per_mcu == 1:
                        # 1x1 sampling: crop the final panel to height
                        panels = {
                            ci: p[: min(len(p), frame.number_of_lines - y0)]
                            for ci, p in panels.items()
                        }
                    yield y0, panels
                    y0 += rows_per_panel
            return
    raise ValueError("No SOS marker found in stream.")

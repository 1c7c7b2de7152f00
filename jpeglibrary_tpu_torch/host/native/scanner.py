"""ctypes front-end for the native entropy scanner.

Presents the same call signature as the pure-Python reference scanners
(jpeglibrary_tpu_torch.host.models.huffman_baseline) so the decoder can swap them
freely; tests assert bit-identical coefficient output between the two.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Sequence

import numpy as np

from ..io.reader import EntropySpan
from ..syntax.frame import FrameHeader, ScanHeader, resolve_scan_components
from ..syntax.huffman import HuffmanDecodingTable
from ..models.geometry import FrameGeometry, frame_geometry
from . import build

_TABLE_BYTES = 824


import functools


@functools.lru_cache(maxsize=256)
def pack_huffman_table(t: HuffmanDecodingTable) -> bytes:
    """Serialize to the fixed HuffTable layout in scanner.cpp.

    Cached by table identity: the decoder's DHT parse cache returns the
    same immutable table objects for identical payloads, so repeated
    images from one encoder configuration skip the re-serialization."""
    out = bytearray()
    look = (t.lookahead_size.astype(np.uint16) << 8) | t.lookahead_value.astype(
        np.uint16
    )
    out += look.astype("<u2").tobytes()
    out += t.maxcode.astype("<u2").tobytes()
    out += t.valoffset.astype(np.uint8).tobytes()
    out += t.values.astype(np.uint8).tobytes()
    out += b"\x00"
    assert len(out) == _TABLE_BYTES
    return bytes(out)


def validate_restart_spans(
    spans: Sequence[EntropySpan], restart_interval: int, total_units: int
) -> None:
    """A scan ending at a non-restart, non-EOI marker before covering all
    restart intervals is corrupt — raise like the reference (HandleRestart
    throws "Expect restart marker."). EOI/stream-end truncation stays
    tolerated (JpegHuffmanBaselineScanDecoder.cs:145-149), as does a
    restart boundary that coincides with the true scan end (libjpeg
    convention; the pure-Python scanners apply the same rule)."""
    if restart_interval <= 0:
        return
    from ..models.huffman_baseline import JpegDecodeError
    from ..syntax.markers import Marker, is_restart_marker

    required = -(-total_units // restart_interval)
    if len(spans) < required:
        term = spans[-1].terminator if spans else None
        if term is not None and term != Marker.EOI:
            raise JpegDecodeError("Expect restart marker.")
        return
    # Enough spans — but a corrupt byte can fabricate a marker that
    # SPLITS a span, so every mid-scan boundary must still terminate
    # with an actual RSTn. EOI/stream-end truncation stays tolerated
    # (later boundaries are then unreachable), and the final boundary
    # (scan complete) accepts any terminator, exactly like the Python
    # scanners' advance_restart.
    from ..io.reader import SpanTable

    if isinstance(spans, SpanTable):
        terms = spans.terminators[: required - 1]
        rst = (terms >= int(Marker.RST0)) & (terms <= int(Marker.RST7))
        if not rst.all():
            # All boundaries before the first non-RSTn are fine; the
            # offender itself is either tolerated truncation (EOI /
            # stream end) or a corrupt marker.
            t = int(terms[int(np.argmax(~rst))])
            if t >= 0 and t != int(Marker.EOI):
                raise JpegDecodeError("Expect restart marker.")
        return
    for k in range(required - 1):
        term = spans[k].terminator
        if term is None or term == Marker.EOI:
            return
        if not is_restart_marker(term):
            raise JpegDecodeError("Expect restart marker.")


_PI64 = ctypes.POINTER(ctypes.c_int64)


def _span_ptrs(spans: Sequence[EntropySpan]):
    """(starts_ptr, ends_ptr, keepalive) for a span sequence.

    Array-backed SpanTables pass their int64 arrays straight through —
    zero per-span Python work for restart-heavy streams. The returned
    keepalive tuple must stay referenced for the duration of the
    native call."""
    from ..io.reader import SpanTable

    if isinstance(spans, SpanTable):
        sa, ea = spans.starts, spans.ends
    else:
        n = len(spans)
        sa = np.fromiter((s.start for s in spans), np.int64, n)
        ea = np.fromiter((s.end for s in spans), np.int64, n)
    return sa.ctypes.data_as(_PI64), ea.ctypes.data_as(_PI64), (sa, ea)


def default_threads() -> int:
    env = os.environ.get("JPX_SCAN_THREADS")
    if env:
        return int(env)
    # Leave headroom for the JAX runtime/transfer threads.
    return max(1, (os.cpu_count() or 2) - 2)


def decode_baseline_scan(
    data: bytes,
    spans: Sequence[EntropySpan],
    frame: FrameHeader,
    scan: ScanHeader,
    dc_tables: Dict[int, HuffmanDecodingTable],
    ac_tables: Dict[int, HuffmanDecodingTable],
    restart_interval: int,
    coefficient_planes: Dict[int, np.ndarray],
    geometry: FrameGeometry = None,
    *,
    first_mcu: int = 0,
    mcu_row_offset: int = 0,
    validate: bool = True,
) -> bool:
    """Native baseline scan decode; returns True when handled.

    Raises the same error types as the Python scanner on corrupt input.

    Region decode (``first_mcu``/``mcu_row_offset`` nonzero): ``spans``
    is a contiguous SUBSET of the image's restart spans starting at
    global MCU index ``first_mcu`` (span-aligned), and the coefficient
    planes cover only the MCU rows the subset touches, shifted up by
    ``mcu_row_offset`` rows. The caller is responsible for validating
    the FULL span list first (``validate=False`` skips the subset
    re-validation, whose MCU count would not match).
    """
    lib = build.load_library()  # may raise ImportError -> caller falls back
    from ..models.huffman_baseline import JpegDecodeError

    geo = geometry or frame_geometry(frame)
    resolved = resolve_scan_components(frame, scan)

    n = len(resolved)
    comp_h = (ctypes.c_int32 * n)()
    comp_v = (ctypes.c_int32 * n)()
    plane_ptrs = (ctypes.c_void_p * n)()
    plane_wb = (ctypes.c_int64 * n)()
    dc_blob = bytearray()
    ac_blob = bytearray()
    keepalive = []
    for i, (comp_index, fc, sc) in enumerate(resolved):
        dc = dc_tables.get(sc.dc_table_selector)
        ac = ac_tables.get(sc.ac_table_selector)
        if dc is None or ac is None:
            raise JpegDecodeError(
                f"Huffman table of component {comp_index} is not defined."
            )
        cg = geo.components[comp_index]
        comp_h[i] = cg.h
        comp_v[i] = cg.v
        plane = coefficient_planes[comp_index]
        assert plane.dtype == np.int16 and plane.flags.c_contiguous
        keepalive.append(plane)
        plane_ptrs[i] = plane.ctypes.data_as(ctypes.c_void_p)
        plane_wb[i] = plane.shape[1]
        dc_blob += pack_huffman_table(dc)
        ac_blob += pack_huffman_table(ac)

    if validate:
        validate_restart_spans(
            spans, restart_interval, geo.mcus_per_line * geo.mcus_per_column
        )
    n_spans = len(spans)
    starts, ends, _span_keep = _span_ptrs(spans)

    buf = np.frombuffer(data, dtype=np.uint8)
    dc_arr = bytes(dc_blob)
    ac_arr = bytes(ac_blob)

    # Host-consumer dense decode: unless the caller pinned
    # JPX_SCAN_THREADS (serving pipelines set 1 and parallelize across
    # images), this call IS the decode — give it every core. The
    # device pipeline rides the sparse wrappers, not this one.
    threads = default_threads()
    if not os.environ.get("JPX_SCAN_THREADS"):
        threads = max(threads, os.cpu_count() or 2)

    if first_mcu or mcu_row_offset:
        rc = lib.jpx_decode_baseline_scan_region(
            buf.ctypes.data_as(ctypes.c_void_p),
            starts, ends, n_spans,
            restart_interval,
            geo.mcus_per_line, geo.mcus_per_column,
            n,
            comp_h, comp_v,
            dc_arr, ac_arr,
            plane_ptrs, plane_wb,
            threads,
            first_mcu, mcu_row_offset,
        )
    else:
        rc = lib.jpx_decode_baseline_scan(
            buf.ctypes.data_as(ctypes.c_void_p),
            starts, ends, n_spans,
            restart_interval,
            geo.mcus_per_line, geo.mcus_per_column,
            n,
            comp_h, comp_v,
            dc_arr, ac_arr,
            plane_ptrs, plane_wb,
            threads,
        )
    if rc == 2:
        from ..syntax.huffman import JpegHuffmanError

        raise JpegHuffmanError("Invalid Huffman code encountered.")
    if rc == 1:
        raise JpegDecodeError("The bit stream ended prematurely.")
    if rc != 0:
        raise JpegDecodeError(f"native scanner error {rc}")
    return True


def decode_image_sparse(data: bytes, *, bucket_factor: float = 1.5):
    """Fused whole-image baseline decode: ONE native call does the
    container walk, table build, ECS split and the merged sparse scan —
    no per-image Python marker/table work (GIL-held time drops to the
    ctypes call itself). Returns ``(payload, frame, geometry, quant)``
    or ``None`` when the stream is not a single-scan interleaved
    baseline image (the caller takes the general path). The returned
    tuple's last element is the Adobe APP14 color transform (or None),
    needed for RGB/CMYK/YCCK output decisions."""
    lib = build.load_library()
    buf = np.frombuffer(data, dtype=np.uint8)
    info = np.zeros(22, dtype=np.int32)
    info[21] = -1
    quants = np.zeros((4, 64), dtype=np.uint16)
    out = _pack_scratch(1 << 21)
    written = lib.jpx_decode_image_baseline_sparse(
        buf.ctypes.data_as(ctypes.c_void_p), buf.shape[0],
        out.ctypes.data_as(ctypes.c_void_p), out.shape[0],
        info.ctypes.data_as(ctypes.c_void_p),
        quants.ctypes.data_as(ctypes.c_void_p),
        default_threads(),
    )
    if written == -1:
        # capacity: size exactly from the parsed dimensions and retry
        out = _pack_scratch(_exact_sparse_capacity(info))
        written = lib.jpx_decode_image_baseline_sparse(
            buf.ctypes.data_as(ctypes.c_void_p), buf.shape[0],
            out.ctypes.data_as(ctypes.c_void_p), out.shape[0],
            info.ctypes.data_as(ctypes.c_void_p),
            quants.ctypes.data_as(ctypes.c_void_p),
            default_threads(),
        )
    if written == -10:
        return None
    if written < 0:
        _raise_sparse_error(written)
        return None
    return _package_sparse(info, quants, out, int(written), bucket_factor)


def exception_capacity(bn: int) -> int:
    """v2-wire exception bucket size as a fixed fraction of the AC
    bucket (Bn is a multiple of 1024, so Be = Bn/64 is exact and the
    flat payload length K = 3*NB + 2*Bn + 8*Be = 3*NB + 17*Bn/8 is
    invertible on the device side: Bn = (K - 3*NB) * 8 / 17). ~1.6% of
    AC slots covers the |AC| > 127 density of natural images with wide
    margin (measured 0.4-0.6% on q~90 assets); denser streams grow the
    bucket."""
    return bn // 64


def _total_blocks(info: np.ndarray) -> int:
    n_comps = int(info[3])
    max_h = max(int(info[4 + i]) for i in range(n_comps))
    max_v = max(int(info[8 + i]) for i in range(n_comps))
    mpl = -(-int(info[0]) // (8 * max_h))
    mpc = -(-int(info[1]) // (8 * max_v))
    bpm = sum(int(info[4 + i]) * int(info[8 + i]) for i in range(n_comps))
    return mpl * mpc * bpm


def decode_image_sparse2(data: bytes, *, bucket_factor: float = 1.5):
    """v2-wire twin of decode_image_sparse: ONE native call does the
    container walk, table build, ECS split and the merged split-stream
    scan. The payload is a flat uint8 buffer —
    ``[dc int16*NB][counts u8*NB][acpos u8*Bn][acval i8*Bn][exc i32*2*Be]``
    with NB/Be functions of the geometry and Bn bucket-padded — at
    ~0.54x the v1 wire bytes (the pipeline's dominant transfer-cost
    term on remote-attached chips). Returns
    ``(payload, frame, geometry, quant, adobe)`` or ``None`` when the
    stream is ineligible or overflows the exception bucket (the caller
    falls back to the v1 wire / general path)."""
    lib = build.load_library()
    buf = np.frombuffer(data, dtype=np.uint8)
    info = np.zeros(22, dtype=np.int32)
    info[21] = -1
    quants = np.zeros((4, 64), dtype=np.uint16)

    # First call with guessed capacities (images rarely exceed one AC
    # entry per compressed byte); -1 retries with the exact worst case
    # from the walk-filled dimensions.
    ac_cap = max(1 << 20, len(data) + 4096)
    nb_cap = 1 << 20
    # Exception scratch scales with the input: a decline on overflow
    # would silently RERUN the whole entropy decode on the v1 wire —
    # a 2x latency cliff on exactly the most expensive images. One
    # pair per 8 compressed bytes is ~10x the worst |AC|>127 density
    # measured on natural images at q95+.
    exc_cap = max(65536, len(data) // 8)
    for _ in range(2):
        dc_sc, cnt_sc, pos_sc, val_sc, exc_sc = _v2_scratch(
            nb_cap, ac_cap, exc_cap
        )
        n_exc = ctypes.c_int64(0)
        written = lib.jpx_decode_image_baseline_sparse2(
            buf.ctypes.data_as(ctypes.c_void_p), buf.shape[0],
            dc_sc.ctypes.data_as(ctypes.c_void_p),
            cnt_sc.ctypes.data_as(ctypes.c_void_p), nb_cap,
            pos_sc.ctypes.data_as(ctypes.c_void_p),
            val_sc.ctypes.data_as(ctypes.c_void_p), ac_cap,
            exc_sc.ctypes.data_as(ctypes.c_void_p),
            exc_sc.shape[0] // 2, ctypes.byref(n_exc),
            info.ctypes.data_as(ctypes.c_void_p),
            quants.ctypes.data_as(ctypes.c_void_p),
            default_threads(),
        )
        if written != -1:
            break
        nb_cap = _total_blocks(info) + 64
        ac_cap = _total_blocks(info) * 63 + 4096
    if written == -10:
        return None
    if written < 0:
        _raise_sparse_error(written)
        return None

    nb = _total_blocks(info)
    if int(n_exc.value) > exc_sc.shape[0] // 2:
        return None  # beyond even the scratch: v1 wire
    payload = _assemble_v2_payload(
        dc_sc, cnt_sc, pos_sc, val_sc, exc_sc, nb, int(written),
        int(n_exc.value), bucket_factor,
    )
    frame, geometry, quant, adobe = _frame_from_info(info, quants)
    return payload, frame, geometry, quant, adobe


_V2_SCRATCH = threading.local()


def _v2_scratch(nb_cap: int, ac_cap: int, exc_cap: int = 65536):
    """Per-thread persistent scratch for the v2 native call (the
    pattern _pack_scratch uses: gigantic buffers are not re-faulted
    per image; oversized ones are released)."""
    cur = getattr(_V2_SCRATCH, "bufs", None)
    if (
        cur is not None
        and cur[0].shape[0] >= nb_cap
        and cur[2].shape[0] >= ac_cap
        and cur[4].shape[0] >= 2 * exc_cap
    ):
        return cur
    dc = np.empty(nb_cap, dtype=np.int16)
    cnt = np.empty(nb_cap, dtype=np.uint8)
    pos = np.empty(ac_cap, dtype=np.uint8)
    val = np.empty(ac_cap, dtype=np.int8)
    exc = np.empty(2 * exc_cap, dtype=np.int64)
    bufs = (dc, cnt, pos, val, exc)
    if ac_cap <= (64 << 20):  # retention cap, like _pack_scratch
        _V2_SCRATCH.bufs = bufs
    return bufs


def _assemble_v2_payload(dc, cnt, pos, val, exc, nb, n_ac, n_exc,
                         bucket_factor):
    """Flatten the split streams into the bucket-padded device wire."""
    bn = 1024
    while bn < n_ac or exception_capacity(bn) < n_exc:
        bn = (int(bn * bucket_factor) + 1023) & ~1023
    be = exception_capacity(bn)
    k = 3 * nb + 2 * bn + 8 * be
    payload = np.zeros(k, dtype=np.uint8)
    payload[: 2 * nb] = dc[:nb].view(np.uint8)
    payload[2 * nb : 3 * nb] = cnt[:nb]
    payload[3 * nb : 3 * nb + n_ac] = pos[:n_ac]
    # acpos padding stays 0 -> repeat() pads block ids with the last
    # block and these entries scatter-add 0 into its DC slot: no-ops.
    av = payload[3 * nb + bn : 3 * nb + 2 * bn].view(np.int8)
    av[:n_ac] = val[:n_ac]
    if n_exc:
        ev = payload[3 * nb + 2 * bn :].view(np.int32).reshape(be, 2)
        pairs = exc[: 2 * n_exc].reshape(n_exc, 2)
        ev[:n_exc] = pairs  # positions < 2**31 for any real geometry
    return payload


def v2_payload_bn(payload: np.ndarray, nb: int) -> int:
    """AC bucket size of an assembled v2 payload (K = 3*NB + 17*Bn/8)."""
    return (payload.shape[0] - 3 * nb) * 8 // 17


def rebucket_v2_payload(payload: np.ndarray, nb: int, bn_new: int) -> np.ndarray:
    """Re-assemble a v2 payload at a LARGER AC bucket (multi-image
    batching pads every image to one shared width; unlike naive
    zero-padding, the stream offsets must move with Bn). Zero padding
    in every stream is a no-op on device (counts 0 / scatter-add 0)."""
    bn = v2_payload_bn(payload, nb)
    if bn_new == bn:
        return payload
    assert bn_new > bn and bn_new % 1024 == 0
    be, be_new = bn // 64, bn_new // 64
    out = np.zeros(3 * nb + 2 * bn_new + 8 * be_new, dtype=np.uint8)
    out[: 3 * nb] = payload[: 3 * nb]
    out[3 * nb : 3 * nb + bn] = payload[3 * nb : 3 * nb + bn]
    out[3 * nb + bn_new : 3 * nb + bn_new + bn] = payload[
        3 * nb + bn : 3 * nb + 2 * bn
    ]
    out[3 * nb + 2 * bn_new : 3 * nb + 2 * bn_new + 8 * be] = payload[
        3 * nb + 2 * bn :
    ]
    return out


def _frame_from_info(info, quants):
    """Frame/geometry/quant/adobe from the walk-filled info/quants
    (shared by the v1 and v2 fused wrappers)."""
    from ..syntax.frame import FrameComponent, FrameHeader
    from ..syntax.markers import Marker
    from ..models.geometry import frame_geometry

    n_comps = int(info[3])
    frame = FrameHeader(
        marker=Marker(int(info[16]) or int(Marker.SOF0)),
        sample_precision=int(info[2]),
        number_of_lines=int(info[1]),
        samples_per_line=int(info[0]),
        components=tuple(
            FrameComponent(
                int(info[17 + i]),
                int(info[4 + i]), int(info[8 + i]), int(info[12 + i]),
            )
            for i in range(n_comps)
        ),
    )
    geometry = frame_geometry(frame)
    quant = {
        i: quants[int(info[12 + i])].astype(np.int32) for i in range(n_comps)
    }
    adobe = int(info[21])
    return frame, geometry, quant, (adobe if adobe >= 0 else None)


def _raise_sparse_error(written: int) -> None:
    """Map the fused-walk decode error codes to the exceptions the
    general path raises (capacity -1 is handled by the caller)."""
    if written == -2:
        from ..syntax.huffman import JpegHuffmanError

        raise JpegHuffmanError("Invalid Huffman code encountered.")
    if written == -3:
        from ..models.huffman_baseline import JpegDecodeError

        raise JpegDecodeError("The bit stream ended prematurely.")


def _exact_sparse_capacity(info: np.ndarray) -> int:
    """Worst-case entry capacity from the walk-filled info fields."""
    n_comps = int(info[3])
    max_h = max(int(info[4 + i]) for i in range(n_comps))
    max_v = max(int(info[8 + i]) for i in range(n_comps))
    mpl = -(-int(info[0]) // (8 * max_h))
    mpc = -(-int(info[1]) // (8 * max_v))
    total = sum(
        mpl * int(info[4 + i]) * mpc * int(info[8 + i]) * 64
        for i in range(n_comps)
    )
    return total + total // 0xFFFF + 4096


def _package_sparse(info, quants, out, n_entries: int, bucket_factor: float):
    """Bucket-pad the payload and build (frame, geometry, quant, adobe)
    from the walk-filled info/quants arrays."""
    from ..syntax.frame import FrameComponent, FrameHeader
    from ..syntax.markers import Marker
    from ..models.geometry import frame_geometry

    bucket = 1024
    while bucket < n_entries:
        bucket = (int(bucket * bucket_factor) + 1023) & ~1023
    packed = np.empty((bucket, 2), dtype=np.int16)
    packed[:n_entries] = out[:n_entries]
    packed[n_entries:] = 0

    n_comps = int(info[3])
    frame = FrameHeader(
        # The fused walk accepts SOF0 and SOF1 (scanner.cpp); report the
        # actual marker so the fast path matches the dense path.
        marker=Marker(int(info[16]) or int(Marker.SOF0)),
        sample_precision=int(info[2]),
        number_of_lines=int(info[1]),
        samples_per_line=int(info[0]),
        components=tuple(
            # info[17+i] is always filled by the walk (component id 0
            # is legal — no or-fallback, it would alias ids).
            FrameComponent(
                int(info[17 + i]),
                int(info[4 + i]), int(info[8 + i]), int(info[12 + i]),
            )
            for i in range(n_comps)
        ),
    )
    geometry = frame_geometry(frame)
    quant = {
        i: quants[int(info[12 + i])].astype(np.int32) for i in range(n_comps)
    }
    adobe = int(info[21])
    return packed.reshape(-1), frame, geometry, quant, (
        adobe if adobe >= 0 else None
    )


def decode_baseline_scan_sparse(
    data: bytes,
    spans: Sequence[EntropySpan],
    frame: FrameHeader,
    scan: ScanHeader,
    dc_tables: Dict[int, HuffmanDecodingTable],
    ac_tables: Dict[int, HuffmanDecodingTable],
    restart_interval: int,
    geometry: FrameGeometry = None,
    *,
    bucket_factor: float = 1.5,
):
    """Merged baseline decode + sparse pack: entropy-decode the scan and
    emit the 4-byte (delta uint16, value int16) wire entries directly —
    no dense coefficient planes, no separate packing pass. Entries are
    in MCU-interleaved decode order (ops.pipeline.jitted_transform_mcu
    is the matching device unpack).

    Returns the bucket-padded flat int16 payload, or ``None`` when the
    scan is not eligible (the caller falls back to the dense path):
    eligibility is a scan covering all frame components in frame order,
    or a 1x1-sampled single-component frame.
    """
    lib = build.load_library()
    from ..models.huffman_baseline import JpegDecodeError

    geo = geometry or frame_geometry(frame)
    resolved = resolve_scan_components(frame, scan)
    if [ci for ci, _, _ in resolved] != list(range(len(frame.components))):
        return None
    if len(resolved) == 1:
        cg = geo.components[0]
        if cg.h != 1 or cg.v != 1:
            # Single-component scans walk the component's own block
            # grid; it only matches the MCU grid at 1x1 sampling.
            return None

    n = len(resolved)
    comp_h = (ctypes.c_int32 * n)()
    comp_v = (ctypes.c_int32 * n)()
    dc_blob = bytearray()
    ac_blob = bytearray()
    total = 0
    for i, (comp_index, fc, sc) in enumerate(resolved):
        dc = dc_tables.get(sc.dc_table_selector)
        ac = ac_tables.get(sc.ac_table_selector)
        if dc is None or ac is None:
            raise JpegDecodeError(
                f"Huffman table of component {comp_index} is not defined."
            )
        cg = geo.components[comp_index]
        comp_h[i] = cg.h
        comp_v[i] = cg.v
        dc_blob += pack_huffman_table(dc)
        ac_blob += pack_huffman_table(ac)
        total += cg.blocks_per_column * cg.blocks_per_line * 64

    validate_restart_spans(
        spans, restart_interval, geo.mcus_per_line * geo.mcus_per_column
    )
    n_spans = len(spans)
    starts, ends, _span_keep = _span_ptrs(spans)
    buf = np.frombuffer(data, dtype=np.uint8)

    cap = total + total // 0xFFFF + 16 * (n_spans + 1) + 1024
    out = _pack_scratch(cap)
    written = lib.jpx_decode_baseline_scan_sparse(
        buf.ctypes.data_as(ctypes.c_void_p),
        starts, ends, n_spans,
        restart_interval,
        geo.mcus_per_line, geo.mcus_per_column,
        n,
        comp_h, comp_v,
        bytes(dc_blob), bytes(ac_blob),
        out.ctypes.data_as(ctypes.c_void_p), cap,
        default_threads(),
    )
    if written == -2:
        from ..syntax.huffman import JpegHuffmanError

        raise JpegHuffmanError("Invalid Huffman code encountered.")
    if written == -3:
        raise JpegDecodeError("The bit stream ended prematurely.")
    if written < 0:
        return None  # capacity/arg problem: dense fallback
    n_entries = int(written)
    bucket = 1024
    while bucket < n_entries:
        bucket = (int(bucket * bucket_factor) + 1023) & ~1023
    packed = np.empty((bucket, 2), dtype=np.int16)
    packed[:n_entries] = out[:n_entries]
    packed[n_entries:] = 0  # (0, 0) no-op padding entries
    return packed.reshape(-1)


def decode_baseline_scan_sparse2(
    data: bytes,
    spans: Sequence[EntropySpan],
    frame: FrameHeader,
    scan: ScanHeader,
    dc_tables: Dict[int, HuffmanDecodingTable],
    ac_tables: Dict[int, HuffmanDecodingTable],
    restart_interval: int,
    geometry: FrameGeometry = None,
    *,
    bucket_factor: float = 1.5,
):
    """v2-wire twin of :func:`decode_baseline_scan_sparse` for the
    staged container path (streams the fused whole-image walk
    declines): same eligibility, split-stream payload out. Returns the
    flat uint8 payload or ``None`` (caller falls back to the v1 wire /
    dense path)."""
    lib = build.load_library()
    from ..models.huffman_baseline import JpegDecodeError

    geo = geometry or frame_geometry(frame)
    resolved = resolve_scan_components(frame, scan)
    if [ci for ci, _, _ in resolved] != list(range(len(frame.components))):
        return None
    if len(resolved) == 1:
        cg = geo.components[0]
        if cg.h != 1 or cg.v != 1:
            return None

    n = len(resolved)
    comp_h = (ctypes.c_int32 * n)()
    comp_v = (ctypes.c_int32 * n)()
    dc_blob = bytearray()
    ac_blob = bytearray()
    bpm = 0
    for i, (comp_index, fc, sc) in enumerate(resolved):
        dc = dc_tables.get(sc.dc_table_selector)
        ac = ac_tables.get(sc.ac_table_selector)
        if dc is None or ac is None:
            raise JpegDecodeError(
                f"Huffman table of component {comp_index} is not defined."
            )
        cg = geo.components[comp_index]
        comp_h[i] = cg.h
        comp_v[i] = cg.v
        dc_blob += pack_huffman_table(dc)
        ac_blob += pack_huffman_table(ac)
        bpm += cg.h * cg.v

    total_mcus = geo.mcus_per_line * geo.mcus_per_column
    validate_restart_spans(spans, restart_interval, total_mcus)
    nb = total_mcus * bpm
    n_spans = len(spans)
    starts, ends, _span_keep = _span_ptrs(spans)
    buf = np.frombuffer(data, dtype=np.uint8)

    ac_cap = max(1 << 20, len(data) + 4096)
    exc_cap = max(65536, len(data) // 8)
    for attempt in range(2):
        dc_sc, cnt_sc, pos_sc, val_sc, exc_sc = _v2_scratch(
            max(nb + 64, 1 << 20), ac_cap, exc_cap
        )
        n_exc = ctypes.c_int64(0)
        written = lib.jpx_decode_baseline_scan_sparse2(
            buf.ctypes.data_as(ctypes.c_void_p),
            starts, ends, n_spans,
            restart_interval,
            geo.mcus_per_line, geo.mcus_per_column,
            n,
            comp_h, comp_v,
            bytes(dc_blob), bytes(ac_blob),
            dc_sc.ctypes.data_as(ctypes.c_void_p),
            cnt_sc.ctypes.data_as(ctypes.c_void_p),
            pos_sc.ctypes.data_as(ctypes.c_void_p),
            val_sc.ctypes.data_as(ctypes.c_void_p), ac_cap,
            exc_sc.ctypes.data_as(ctypes.c_void_p),
            exc_sc.shape[0] // 2, ctypes.byref(n_exc),
            default_threads(),
        )
        if written != -1:
            break
        ac_cap = nb * 63 + 4096
    if written == -2:
        from ..syntax.huffman import JpegHuffmanError

        raise JpegHuffmanError("Invalid Huffman code encountered.")
    if written == -3:
        raise JpegDecodeError("The bit stream ended prematurely.")
    if written < 0:
        return None
    if int(n_exc.value) > exc_sc.shape[0] // 2:
        return None  # beyond even the scratch: v1 wire
    return _assemble_v2_payload(
        dc_sc, cnt_sc, pos_sc, val_sc, exc_sc, nb, int(written),
        int(n_exc.value), bucket_factor,
    )


def decode_progressive_chains(
    data: bytes,
    chain_jobs,
    frame: FrameHeader,
    geometry: FrameGeometry,
    coefficient_planes: Dict[int, np.ndarray],
) -> bool:
    """Watermark-pipelined decode of NON-INTERLEAVED progressive Huffman
    scans (jpx_decode_progressive_chains): each scan runs in its own
    thread gated per-unit on the previous same-component scan, so a
    component's first->refine->refine chain overlaps instead of
    serializing. ``chain_jobs`` are the scan jobs in stream order; each
    must resolve to exactly one component."""
    lib = build.load_library()
    from ..models.geometry import ceil_div
    from ..models.huffman_baseline import JpegDecodeError

    n = len(chain_jobs)
    starts_l, ends_l, offsets, counts = [], [], [], []
    ss = (ctypes.c_int32 * n)()
    se = (ctypes.c_int32 * n)()
    ah = (ctypes.c_int32 * n)()
    al = (ctypes.c_int32 * n)()
    gates = (ctypes.c_int32 * n)()
    ris = (ctypes.c_int64 * n)()
    plane_ptrs = (ctypes.c_void_p * n)()
    wbs = (ctypes.c_int64 * n)()
    hbcs = (ctypes.c_int64 * n)()
    totals = (ctypes.c_int64 * n)()
    blobs = bytearray()
    last_for_comp: Dict[int, int] = {}
    keepalive = []

    for s, job in enumerate(chain_jobs):
        hdr = job["scan_header"]
        resolved = resolve_scan_components(frame, hdr)
        assert len(resolved) == 1, "chain jobs must be single-component"
        comp_index, fc, sc = resolved[0]
        is_dc = hdr.start_of_spectral_selection == 0
        table = (
            job["dc_tables"].get(sc.dc_table_selector)
            if is_dc
            else job["ac_tables"].get(sc.ac_table_selector)
        )
        if table is None:
            raise JpegDecodeError(
                f"Huffman table of component {comp_index} is not defined."
            )
        cg = geometry.components[comp_index]
        hbc = ceil_div(geometry.width, 8 * cg.hs)
        vbc = ceil_div(geometry.height, 8 * cg.vs)
        spans = job["scan"].spans
        validate_restart_spans(spans, job["restart_interval"], hbc * vbc)
        offsets.append(sum(len(a) for a in starts_l))
        counts.append(len(spans))
        _, _, (sa, ea) = _span_ptrs(spans)
        starts_l.append(sa)
        ends_l.append(ea)
        ris[s] = job["restart_interval"]
        ss[s] = hdr.start_of_spectral_selection
        se[s] = hdr.end_of_spectral_selection
        ah[s] = hdr.successive_approximation_bit_position_high
        al[s] = hdr.successive_approximation_bit_position_low
        gates[s] = last_for_comp.get(comp_index, -1)
        last_for_comp[comp_index] = s
        blobs += pack_huffman_table(table)
        plane = coefficient_planes[comp_index]
        assert plane.dtype == np.int16 and plane.flags.c_contiguous
        keepalive.append(plane)
        plane_ptrs[s] = plane.ctypes.data_as(ctypes.c_void_p)
        wbs[s] = plane.shape[1]
        hbcs[s] = hbc
        totals[s] = hbc * vbc

    starts_cat = (
        np.concatenate(starts_l) if starts_l else np.empty(0, np.int64)
    )
    ends_cat = np.concatenate(ends_l) if ends_l else np.empty(0, np.int64)
    starts = starts_cat.ctypes.data_as(_PI64)
    ends = ends_cat.ctypes.data_as(_PI64)
    keepalive.append((starts_cat, ends_cat))
    offs = (ctypes.c_int32 * n)(*offsets)
    cnts = (ctypes.c_int32 * n)(*counts)
    buf = np.frombuffer(data, dtype=np.uint8)

    # The chain call is the whole decode at this point: unless the user
    # pinned JPX_SCAN_THREADS (serving pipelines set 1 and parallelize
    # across images), give the pipeline every core so the chained scans
    # actually overlap.
    threads = default_threads()
    if not os.environ.get("JPX_SCAN_THREADS"):
        threads = max(threads, min(n, os.cpu_count() or 2))

    rc = lib.jpx_decode_progressive_chains(
        buf.ctypes.data_as(ctypes.c_void_p),
        n,
        starts, ends, offs, cnts,
        ris, ss, se, ah, al, gates,
        bytes(blobs),
        plane_ptrs, wbs, hbcs, totals,
        threads,
    )
    if rc == 2:
        from ..syntax.huffman import JpegHuffmanError

        raise JpegHuffmanError("Invalid Huffman code encountered.")
    if rc == 1:
        raise JpegDecodeError("Unexpected end of JPEG data stream.")
    if rc != 0:
        raise JpegDecodeError(f"native scanner error {rc}")
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
    geometry: FrameGeometry = None,
    *,
    units_override: int = None,
    validate: bool = True,
) -> bool:
    """Native progressive scan decode; returns True when handled.

    Same semantics as models.huffman_progressive.decode_progressive_scan
    (bit-identical coefficient updates); restart segments decode in
    parallel across threads.

    Region decode (models/region.py): ``spans`` may be a contiguous
    SUBSET of the scan's restart spans whose first unit falls on a unit
    ROW boundary; ``units_override`` is then the number of units the
    subset covers, the passed planes are band views whose row 0 is that
    boundary, and ``validate=False`` skips the whole-scan span
    validation (the caller validated the full list)."""
    lib = build.load_library()
    from ..models.geometry import ceil_div
    from ..models.huffman_baseline import JpegDecodeError

    geo = geometry or frame_geometry(frame)
    resolved = resolve_scan_components(frame, scan)
    is_dc_scan = scan.start_of_spectral_selection == 0
    if len(resolved) > 1 and not is_dc_scan:
        raise JpegDecodeError("Progressive AC scans must be non-interleaved.")

    n = len(resolved)
    comp_h = (ctypes.c_int32 * n)()
    comp_v = (ctypes.c_int32 * n)()
    plane_ptrs = (ctypes.c_void_p * n)()
    plane_wb = (ctypes.c_int64 * n)()
    dc_blob = bytearray()
    ac_blob = bytearray()
    empty = pack_huffman_table(
        HuffmanDecodingTable.build(0, 0, np.zeros(16, np.uint8), np.zeros(0, np.uint8))
    )
    keepalive = []
    hbc = 1
    total_units = geo.mcus_per_line * geo.mcus_per_column
    for i, (comp_index, fc, sc) in enumerate(resolved):
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
        comp_h[i] = cg.h
        comp_v[i] = cg.v
        plane = coefficient_planes[comp_index]
        assert plane.dtype == np.int16 and plane.flags.c_contiguous
        keepalive.append(plane)
        plane_ptrs[i] = plane.ctypes.data_as(ctypes.c_void_p)
        plane_wb[i] = plane.shape[1]
        dc_blob += pack_huffman_table(dc) if dc is not None else empty
        ac_blob += pack_huffman_table(ac) if ac is not None else empty
        if n == 1:
            # Non-interleaved: the component's own block grid
            # (JpegHuffmanProgressiveScanDecoder.cs:146-147).
            hbc = ceil_div(geo.width, 8 * cg.hs)
            vbc = ceil_div(geo.height, 8 * cg.vs)
            total_units = hbc * vbc

    if validate:
        validate_restart_spans(spans, restart_interval, total_units)
    if units_override is not None:
        total_units = units_override
    n_spans = len(spans)
    starts, ends, _span_keep = _span_ptrs(spans)
    buf = np.frombuffer(data, dtype=np.uint8)

    # Like the chain wrapper: unless the caller pinned JPX_SCAN_THREADS
    # (serving pipelines set 1 and parallelize across images), give a
    # restart-span scan every core. The scan dependency graph narrows
    # to a single heavy refinement scan at its tail, and 2-of-4 threads
    # there leaves half the host idle exactly when nothing else runs.
    threads = default_threads()
    if n_spans > 1 and not os.environ.get("JPX_SCAN_THREADS"):
        threads = max(threads, min(n_spans, os.cpu_count() or 2))

    rc = lib.jpx_decode_progressive_scan(
        buf.ctypes.data_as(ctypes.c_void_p),
        starts, ends, n_spans,
        restart_interval,
        total_units, geo.mcus_per_line, hbc,
        n,
        comp_h, comp_v,
        bytes(dc_blob), bytes(ac_blob),
        plane_ptrs, plane_wb,
        scan.start_of_spectral_selection,
        scan.end_of_spectral_selection,
        scan.successive_approximation_bit_position_high,
        scan.successive_approximation_bit_position_low,
        threads,
    )
    if rc == 2:
        from ..syntax.huffman import JpegHuffmanError

        raise JpegHuffmanError("Invalid Huffman code encountered.")
    if rc == 1:
        raise JpegDecodeError("Unexpected end of JPEG data stream.")
    if rc != 0:
        raise JpegDecodeError(f"native scanner error {rc}")
    return True


def decode_lossless_scan(
    data: bytes,
    spans: Sequence[EntropySpan],
    frame: FrameHeader,
    scan: ScanHeader,
    dc_tables: Dict[int, HuffmanDecodingTable],
    restart_interval: int,
    sample_planes: Dict[int, np.ndarray],
) -> bool:
    """Native lossless scan decode; returns True when handled. Same
    bit-exact semantics as models.lossless.decode_lossless_scan."""
    lib = build.load_library()
    from ..models.geometry import ceil_div
    from ..models.huffman_baseline import JpegDecodeError

    resolved = resolve_scan_components(frame, scan)
    n = len(resolved)
    comp_h = (ctypes.c_int32 * n)()
    comp_v = (ctypes.c_int32 * n)()
    plane_ptrs = (ctypes.c_void_p * n)()
    widths = (ctypes.c_int64 * n)()
    blob = bytearray()
    keepalive = []
    for i, (comp_index, fc, sc) in enumerate(resolved):
        table = dc_tables.get(sc.dc_table_selector)
        if table is None:
            raise JpegDecodeError(
                f"Huffman table of component {comp_index} is not defined."
            )
        comp_h[i] = fc.horizontal_sampling_factor
        comp_v[i] = fc.vertical_sampling_factor
        plane = sample_planes[comp_index]
        assert plane.dtype == np.int16 and plane.flags.c_contiguous
        keepalive.append(plane)
        plane_ptrs[i] = plane.ctypes.data_as(ctypes.c_void_p)
        widths[i] = plane.shape[1]
        blob += pack_huffman_table(table)

    max_h = frame.max_horizontal_sampling
    max_v = frame.max_vertical_sampling
    pt = scan.successive_approximation_bit_position_low
    # Differential frames (T.81 J, predictor selection 0) code raw
    # diffs: no initial prediction seed.
    init_pred = (
        (1 << (frame.sample_precision - pt - 1))
        if scan.start_of_spectral_selection
        else 0
    )
    # Lossless MCU = one sample per component (T.81 H.2).
    validate_restart_spans(
        spans,
        restart_interval,
        ceil_div(frame.samples_per_line, max_h)
        * ceil_div(frame.number_of_lines, max_v),
    )
    n_spans = len(spans)
    starts, ends, _span_keep = _span_ptrs(spans)
    buf = np.frombuffer(data, dtype=np.uint8)

    # Speculative parallel path: single span, 1x1 sampling, enough
    # threads and data. Diff symbols are context-free, so chunks decode
    # concurrently and a cheap prediction pass reconstructs; stitch
    # failure (rc -1) falls back to the sequential decode below.
    # A lone lossless decode is host-entropy-bound, so unless the
    # caller pinned JPX_SCAN_THREADS (serving pipelines parallelize
    # across images), the scan gets every core.
    threads = default_threads()
    if not os.environ.get("JPX_SCAN_THREADS"):
        threads = max(threads, os.cpu_count() or 2)
    if (
        n_spans == 1
        and restart_interval == 0
        and max_h == 1
        and max_v == 1
        and all(comp_h[i] == 1 and comp_v[i] == 1 for i in range(n))
        and threads > 2
    ):
        rc = lib.jpx_decode_lossless_scan_parallel(
            buf.ctypes.data_as(ctypes.c_void_p),
            spans[0].start, spans[0].end,
            ceil_div(frame.samples_per_line, max_h),
            ceil_div(frame.number_of_lines, max_v),
            n,
            bytes(blob),
            plane_ptrs, widths,
            scan.start_of_spectral_selection,
            init_pred,
            threads,
        )
        if rc == 0:
            return True
        if rc == 2:
            from ..syntax.huffman import JpegHuffmanError

            raise JpegHuffmanError("Invalid Huffman code encountered.")
        if rc == 1:
            raise JpegDecodeError("The bit stream ended prematurely.")
        # rc == -1: could not synchronize; sequential fallback

    # Restart-interval parallel path: spans' diff streams are
    # bitstream-independent, so they decode concurrently (no
    # speculation needed) with a shared reconstruction pass. Requires a
    # COMPLETE span table: on a truncated stream the parallel pass would
    # zero-fill missing diffs and still predict samples for them,
    # whereas the sequential decoders stop and leave raw zeros — route
    # truncated inputs to the sequential path for identical semantics.
    mcus_total = ceil_div(frame.samples_per_line, max_h) * ceil_div(
        frame.number_of_lines, max_v
    )
    if (
        restart_interval > 0
        and n_spans > 1
        and n_spans >= ceil_div(mcus_total, restart_interval)
        and max_h == 1
        and max_v == 1
        and all(comp_h[i] == 1 and comp_v[i] == 1 for i in range(n))
        and threads > 1
    ):
        rc = lib.jpx_decode_lossless_restart_parallel(
            buf.ctypes.data_as(ctypes.c_void_p),
            starts, ends, n_spans,
            restart_interval,
            ceil_div(frame.samples_per_line, max_h),
            ceil_div(frame.number_of_lines, max_v),
            n,
            bytes(blob),
            plane_ptrs, widths,
            scan.start_of_spectral_selection,
            init_pred,
            threads,
        )
        if rc == 0:
            return True
        if rc == 2:
            from ..syntax.huffman import JpegHuffmanError

            raise JpegHuffmanError("Invalid Huffman code encountered.")
        if rc == 1:
            raise JpegDecodeError("The bit stream ended prematurely.")
        # other rc: sequential fallback

    rc = lib.jpx_decode_lossless_scan(
        buf.ctypes.data_as(ctypes.c_void_p),
        starts, ends, n_spans,
        restart_interval,
        ceil_div(frame.samples_per_line, max_h),
        ceil_div(frame.number_of_lines, max_v),
        n,
        comp_h, comp_v,
        bytes(blob),
        plane_ptrs, widths,
        scan.start_of_spectral_selection,
        init_pred,
    )
    if rc == 2:
        from ..syntax.huffman import JpegHuffmanError

        raise JpegHuffmanError("Invalid Huffman code encountered.")
    if rc == 1:
        raise JpegDecodeError("The bit stream ended prematurely.")
    if rc != 0:
        raise JpegDecodeError(f"native scanner error {rc}")
    return True


class LosslessRowStream:
    """Bounded-memory lossless row-panel cursor — the TPU-native
    analogue of the reference's 16-row scanline ring
    (yigolden/JpegLibrary/src/JpegLibrary/JpegPartialScanlineAllocator.cs:11,60):
    each ``next_rows`` call decodes the next MCU rows into fresh
    panels; the native state carries only the bit-reader position,
    restart-span cursor, and ONE previous sample row per component, so
    peak memory is O(width), never O(image). Sample values are
    bit-identical to the batch decoder (models.lossless /
    jpx_decode_lossless_scan)."""

    def __init__(
        self,
        data: bytes,
        spans: Sequence[EntropySpan],
        frame: FrameHeader,
        scan: ScanHeader,
        dc_tables: Dict[int, HuffmanDecodingTable],
        restart_interval: int,
    ):
        lib = build.load_library()
        from ..models.geometry import ceil_div
        from ..models.huffman_baseline import JpegDecodeError

        resolved = resolve_scan_components(frame, scan)
        n = len(resolved)
        comp_h = (ctypes.c_int32 * n)()
        comp_v = (ctypes.c_int32 * n)()
        widths = (ctypes.c_int64 * n)()
        blob = bytearray()
        self.component_indices = []
        max_h = frame.max_horizontal_sampling
        max_v = frame.max_vertical_sampling
        mpl = ceil_div(frame.samples_per_line, max_h)
        mpc = ceil_div(frame.number_of_lines, max_v)
        for i, (comp_index, fc, sc) in enumerate(resolved):
            table = dc_tables.get(sc.dc_table_selector)
            if table is None:
                raise JpegDecodeError(
                    f"Huffman table of component {comp_index} is not defined."
                )
            comp_h[i] = fc.horizontal_sampling_factor
            comp_v[i] = fc.vertical_sampling_factor
            widths[i] = mpl * fc.horizontal_sampling_factor
            blob += pack_huffman_table(table)
            self.component_indices.append(comp_index)

        pt = scan.successive_approximation_bit_position_low
        validate_restart_spans(spans, restart_interval, mpl * mpc)
        n_spans = len(spans)
        starts, ends, self._span_keep = _span_ptrs(spans)
        # keepalives: the native state holds pointers into the input
        self._buf = np.frombuffer(data, dtype=np.uint8)
        self._lib = lib
        self._vs = [int(comp_v[i]) for i in range(n)]
        self._widths = [int(widths[i]) for i in range(n)]
        self.mcus_per_column = mpc
        self.rows_per_mcu = max_v
        self._handle = lib.jpx_lossless_stream_open(
            self._buf.ctypes.data_as(ctypes.c_void_p),
            starts, ends, n_spans,
            restart_interval, mpl, mpc, n,
            comp_h, comp_v,
            bytes(blob), widths,
            scan.start_of_spectral_selection,
            (1 << (frame.sample_precision - pt - 1))
            if scan.start_of_spectral_selection
            else 0,
        )
        if not self._handle:
            raise JpegDecodeError("failed to open lossless row stream")

    def next_rows(self, mcu_rows: int):
        """Decode the next ``mcu_rows`` MCU rows. Returns
        {component_index: int16 [rows*v_i, width_i]} (cropped at the
        image end), or None when the image is complete."""
        from ..models.huffman_baseline import JpegDecodeError

        if self._handle is None:
            return None
        n = len(self.component_indices)
        panels = [
            np.zeros((mcu_rows * self._vs[i], self._widths[i]), dtype=np.int16)
            for i in range(n)
        ]
        ptrs = (ctypes.c_void_p * n)(
            *[p.ctypes.data_as(ctypes.c_void_p) for p in panels]
        )
        got = self._lib.jpx_lossless_stream_next(self._handle, mcu_rows, ptrs)
        if got == 0:
            return None
        if got == -2:
            from ..syntax.huffman import JpegHuffmanError

            raise JpegHuffmanError("Invalid Huffman code encountered.")
        if got < 0:
            raise JpegDecodeError("The bit stream ended prematurely.")
        return {
            ci: panels[i][: int(got) * self._vs[i]]
            for i, ci in enumerate(self.component_indices)
        }

    def close(self) -> None:
        if self._handle is not None:
            self._lib.jpx_lossless_stream_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def decode_arithmetic_scan(
    data: bytes,
    spans: Sequence[EntropySpan],
    frame: FrameHeader,
    scan: ScanHeader,
    dac_dc: Dict[int, object],
    dac_ac: Dict[int, object],
    restart_interval: int,
    coefficient_planes: Dict[int, np.ndarray],
    geometry: FrameGeometry = None,
    *,
    progressive: bool,
    units_override: int = None,
    validate: bool = True,
) -> bool:
    """Native arithmetic scan decode (SOF9 sequential / SOF10
    progressive); returns True when handled. Same bit-exact semantics as
    models.arithmetic; restart segments decode in parallel.

    Adaptive statistics never carry across scans in the reference
    contract (DC-first scans reset DC bins, AC scans reset AC bins, DC
    refinement uses only the fixed bin), so per-scan/per-segment fresh
    bins are equivalent — which is what makes this scan-at-a-time
    native call valid.
    """
    lib = build.load_library()
    from ..models.geometry import ceil_div
    from ..models.huffman_baseline import JpegDecodeError

    geo = geometry or frame_geometry(frame)
    resolved = resolve_scan_components(frame, scan)
    is_dc_scan = scan.start_of_spectral_selection == 0
    if progressive and len(resolved) > 1 and not is_dc_scan:
        # Same T.81 G.1.1.1 validation as the Huffman progressive
        # wrapper: interleaved AC scans are malformed and would make
        # the native unit walk write garbage silently.
        raise JpegDecodeError("Progressive AC scans must be non-interleaved.")
    needs_dc = (not progressive) or is_dc_scan
    needs_ac = (not progressive) or not is_dc_scan

    n = len(resolved)
    comp_h = (ctypes.c_int32 * n)()
    comp_v = (ctypes.c_int32 * n)()
    dc_ids = (ctypes.c_int32 * n)()
    ac_ids = (ctypes.c_int32 * n)()
    dc_l = (ctypes.c_int32 * n)()
    dc_u = (ctypes.c_int32 * n)()
    ac_kx = (ctypes.c_int32 * n)()
    plane_ptrs = (ctypes.c_void_p * n)()
    plane_wb = (ctypes.c_int64 * n)()
    keepalive = []
    hbc = 1
    total_units = geo.mcus_per_line * geo.mcus_per_column
    for i, (comp_index, fc, sc) in enumerate(resolved):
        dc = dac_dc.get(sc.dc_table_selector)
        ac = dac_ac.get(sc.ac_table_selector)
        if needs_dc and dc is None:
            raise JpegDecodeError("DC table is missing.")
        if needs_ac and ac is None:
            raise JpegDecodeError("AC table is missing")
        cg = geo.components[comp_index]
        comp_h[i] = cg.h
        comp_v[i] = cg.v
        dc_ids[i] = dc.identifier if dc is not None else 0
        ac_ids[i] = ac.identifier if ac is not None else 0
        dc_l[i] = dc.dc_l if dc is not None else 0
        dc_u[i] = dc.dc_u if dc is not None else 0
        ac_kx[i] = ac.ac_kx if ac is not None else 0
        plane = coefficient_planes[comp_index]
        assert plane.dtype == np.int16 and plane.flags.c_contiguous
        keepalive.append(plane)
        plane_ptrs[i] = plane.ctypes.data_as(ctypes.c_void_p)
        plane_wb[i] = plane.shape[1]
        if progressive and n == 1:
            hbc = ceil_div(geo.width, 8 * cg.hs)
            vbc = ceil_div(geo.height, 8 * cg.vs)
            total_units = hbc * vbc

    if validate:
        validate_restart_spans(spans, restart_interval, total_units)
    if units_override is not None:
        total_units = units_override
    n_spans = len(spans)
    starts, ends, _span_keep = _span_ptrs(spans)
    buf = np.frombuffer(data, dtype=np.uint8)

    # Same policy as the progressive scan wrapper: a restart-span scan
    # gets every core unless the caller pinned JPX_SCAN_THREADS
    # (serving pipelines parallelize across images instead).
    threads = default_threads()
    if n_spans > 1 and not os.environ.get("JPX_SCAN_THREADS"):
        threads = max(threads, min(n_spans, os.cpu_count() or 2))

    rc = lib.jpx_decode_arithmetic_scan(
        buf.ctypes.data_as(ctypes.c_void_p),
        starts, ends, n_spans,
        restart_interval,
        total_units, geo.mcus_per_line, hbc,
        n,
        comp_h, comp_v,
        dc_ids, ac_ids,
        dc_l, dc_u, ac_kx,
        plane_ptrs, plane_wb,
        1 if progressive else 0,
        scan.start_of_spectral_selection,
        scan.end_of_spectral_selection,
        scan.successive_approximation_bit_position_high,
        scan.successive_approximation_bit_position_low,
        threads,
    )
    if rc == 2:
        raise JpegDecodeError("Invalid arithmetic code.")
    if rc == 1:
        raise JpegDecodeError("The bit stream ended prematurely.")
    if rc != 0:
        raise JpegDecodeError(f"native scanner error {rc}")
    return True


def decode_transform_rgb(coefficients, quant, geometry, *, mode: str) -> np.ndarray:
    """Fused host decode transform: zig-zag coefficient planes ->
    interleaved uint8 RGB in one threaded native pass (dequant + AAN
    IDCT + level shift + duplication upsample + fixed-point
    YCbCr->RGB). Bit-exact to the numpy path in DecodeResult.to_rgb8
    (same float op order, rint, color constants); 8-bit precision only.

    ``mode``: "gray" (1 component), "ycbcr", or "rgb" (RGB-coded
    3-component stream — channels pass through).
    """
    lib = build.load_library()
    from ..ops.zigzag import ZIGZAG_TO_BLOCK

    comps = geometry.components
    n = len(comps)
    plane_ptrs = (ctypes.c_void_p * n)()
    plane_wb = (ctypes.c_int64 * n)()
    comp_h = (ctypes.c_int32 * n)()
    comp_v = (ctypes.c_int32 * n)()
    qarr = np.zeros((n, 64), dtype=np.int32)
    keepalive = []
    for i, cg in enumerate(comps):
        p = coefficients[cg.component_index]
        assert p.dtype == np.int16 and p.flags.c_contiguous
        keepalive.append(p)
        plane_ptrs[i] = p.ctypes.data_as(ctypes.c_void_p)
        plane_wb[i] = p.shape[1]
        comp_h[i] = cg.h
        comp_v[i] = cg.v
        qarr[i] = quant[cg.component_index]
    out = np.empty((geometry.height, geometry.width, 3), dtype=np.uint8)
    zz = np.ascontiguousarray(ZIGZAG_TO_BLOCK, dtype=np.uint8)
    # Host-consumer transform: all cores unless pinned (see
    # decode_baseline_scan) — the n-2 default left the 4-core host's
    # RGB path at ~2/3 of single-thread libjpeg-turbo.
    threads = default_threads()
    if not os.environ.get("JPX_SCAN_THREADS"):
        threads = max(threads, os.cpu_count() or 2)
    rc = lib.jpx_decode_transform_rgb(
        plane_ptrs, plane_wb,
        qarr.ctypes.data_as(ctypes.c_void_p),
        n, comp_h, comp_v,
        geometry.max_h, geometry.max_v,
        geometry.width, geometry.height,
        geometry.mcus_per_line, geometry.mcus_per_column,
        zz.ctypes.data_as(ctypes.c_void_p),
        {"gray": 0, "ycbcr": 1, "rgb": 2}[mode],
        out.ctypes.data_as(ctypes.c_void_p),
        threads,
    )
    if rc != 0:
        raise RuntimeError(f"jpx_decode_transform_rgb error {rc}")
    return out


def decode_rgb_fused(
    data: bytes,
    spans: Sequence[EntropySpan],
    frame: FrameHeader,
    scan: ScanHeader,
    dc_tables: Dict[int, HuffmanDecodingTable],
    ac_tables: Dict[int, HuffmanDecodingTable],
    restart_interval: int,
    quant: Dict[int, np.ndarray],
    geometry: FrameGeometry = None,
    *,
    mode: str,
) -> np.ndarray:
    """Fully fused single-call host decode: restart-span entropy decode
    and the per-MCU-row RGB transform share one native thread pool (a
    row transforms as soon as its covering spans finish, coefficients
    still cache-warm). Byte-identical to decode_baseline_scan +
    decode_transform_rgb — the native entry reuses their bodies.
    Returns interleaved uint8 [H, W, 3]."""
    lib = build.load_library()
    from ..models.huffman_baseline import JpegDecodeError
    from ..ops.zigzag import ZIGZAG_TO_BLOCK

    geo = geometry or frame_geometry(frame)
    resolved = resolve_scan_components(frame, scan)
    n = len(resolved)
    comp_h = (ctypes.c_int32 * n)()
    comp_v = (ctypes.c_int32 * n)()
    plane_ptrs = (ctypes.c_void_p * n)()
    plane_wb = (ctypes.c_int64 * n)()
    qarr = np.zeros((n, 64), dtype=np.int32)
    dc_blob = bytearray()
    ac_blob = bytearray()
    keepalive = []
    for i, (comp_index, fc, sc) in enumerate(resolved):
        dc = dc_tables.get(sc.dc_table_selector)
        ac = ac_tables.get(sc.ac_table_selector)
        if dc is None or ac is None:
            raise JpegDecodeError(
                f"Huffman table of component {comp_index} is not defined."
            )
        cg = geo.components[comp_index]
        comp_h[i] = cg.h
        comp_v[i] = cg.v
        plane = np.zeros(
            (cg.blocks_per_column, cg.blocks_per_line, 64), dtype=np.int16
        )
        keepalive.append(plane)
        plane_ptrs[i] = plane.ctypes.data_as(ctypes.c_void_p)
        plane_wb[i] = plane.shape[1]
        qarr[i] = quant[comp_index]
        dc_blob += pack_huffman_table(dc)
        ac_blob += pack_huffman_table(ac)

    validate_restart_spans(
        spans, restart_interval, geo.mcus_per_line * geo.mcus_per_column
    )
    starts, ends, _keep = _span_ptrs(spans)
    buf = np.frombuffer(data, dtype=np.uint8)
    zz = np.ascontiguousarray(ZIGZAG_TO_BLOCK, dtype=np.uint8)
    out = np.empty((geo.height, geo.width, 3), dtype=np.uint8)
    threads = default_threads()
    if not os.environ.get("JPX_SCAN_THREADS"):
        threads = max(threads, os.cpu_count() or 2)
    rc = lib.jpx_decode_rgb_fused(
        buf.ctypes.data_as(ctypes.c_void_p),
        starts, ends, len(spans),
        restart_interval,
        geo.mcus_per_line, geo.mcus_per_column,
        n,
        comp_h, comp_v,
        bytes(dc_blob), bytes(ac_blob),
        plane_ptrs, plane_wb,
        qarr.ctypes.data_as(ctypes.c_void_p),
        geo.max_h, geo.max_v,
        geo.width, geo.height,
        zz.ctypes.data_as(ctypes.c_void_p),
        {"gray": 0, "ycbcr": 1, "rgb": 2}[mode],
        out.ctypes.data_as(ctypes.c_void_p),
        threads,
    )
    if rc == 2:
        from ..syntax.huffman import JpegHuffmanError

        raise JpegHuffmanError("Invalid Huffman code encountered.")
    if rc == 1:
        raise JpegDecodeError("Unexpected end of JPEG data stream.")
    if rc != 0:
        raise JpegDecodeError(f"native scanner error {rc}")
    return out


def box_subsample(plane: np.ndarray, hs: int, vs: int) -> np.ndarray:
    """Native box-filter subsample; bit-identical to
    ops.encode_stage.subsample_box (same (sum + 2^(s-1)) >> s rounding)."""
    lib = build.load_library()
    plane = np.ascontiguousarray(plane, dtype=np.uint8)
    h, w = plane.shape
    out = np.empty((h // vs, w // hs), dtype=np.int32)
    lib.jpx_box_subsample(
        plane.ctypes.data_as(ctypes.c_void_p), h, w, hs, vs,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def zz_block_permute(view: np.ndarray, perm: np.ndarray,
                     sign: np.ndarray) -> np.ndarray:
    """Materialize a composed coefficient-domain geometric transform in
    one threaded pass: ``out[i, j, z] = view[i, j, perm[z]] * sign[z]``
    with ``view`` an arbitrary-stride int16 [hb, wb, 64] view (grid
    transposes/mirrors expressed as its strides). Replaces the eager
    numpy gather chain in models/transcode.py, which cost ~90 ms on a
    4.2 MP plane set (the measured jt.transform bottleneck)."""
    lib = build.load_library()
    assert view.dtype == np.int16 and view.ndim == 3 and view.shape[2] == 64
    hb, wb, _ = view.shape
    s0, s1, s2 = (s // 2 for s in view.strides)  # bytes -> elements
    perm32 = np.ascontiguousarray(perm, dtype=np.int32)
    sign32 = np.ascontiguousarray(sign, dtype=np.int32)
    out = np.empty((hb, wb, 64), dtype=np.int16)
    lib.jpx_zz_block_permute(
        view.ctypes.data_as(ctypes.c_void_p),
        s0, s1, s2, hb, wb,
        perm32.ctypes.data_as(ctypes.c_void_p),
        sign32.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        default_threads(),
    )
    return out


def rgb_to_ycbcr(rgb: np.ndarray):
    """Native fixed-point RGB->YCbCr, bit-identical to
    ops.color.rgb_to_ycbcr (JpegRgbToYCbCrConverter parity),
    multithreaded. rgb: uint8 [..., 3]; returns (y, cb, cr) uint8."""
    lib = build.load_library()
    from ..ops import color as color_ops

    flat = np.ascontiguousarray(rgb.reshape(-1, 3), dtype=np.uint8)
    n = flat.shape[0]
    y = np.empty(n, dtype=np.uint8)
    cb = np.empty(n, dtype=np.uint8)
    cr = np.empty(n, dtype=np.uint8)
    consts = (ctypes.c_int32 * 8)(
        color_ops._Y_R, color_ops._Y_G, color_ops._Y_B,
        color_ops._CB_R, color_ops._CB_G, color_ops._CB_B,
        color_ops._CR_G, color_ops._CR_B,
    )
    lib.jpx_rgb_to_ycbcr(
        flat.ctypes.data_as(ctypes.c_void_p), n,
        y.ctypes.data_as(ctypes.c_void_p),
        cb.ctypes.data_as(ctypes.c_void_p),
        cr.ctypes.data_as(ctypes.c_void_p),
        consts,
    )
    shape = rgb.shape[:-1]
    return y.reshape(shape), cb.reshape(shape), cr.reshape(shape)


def fdct_quantize(
    plane: np.ndarray, quant_zz: np.ndarray, level_shift: float = 128.0
) -> np.ndarray:
    """Native threaded FDCT + zig-zag + quantize: [H, W] uint8/int32
    samples (8-aligned dims) -> [Hb, Wb, 64] int16 zig-zag coefficients.
    Same AAN float32 butterfly dataflow as ops.dct.fdct8x8 (compiled
    with fp-contract off), rint quantization. ``level_shift`` is
    1 << (P - 1) — 2048 for the direct 12-bit sample encode path."""
    lib = build.load_library()
    from ..ops.zigzag import ZIGZAG_TO_BLOCK

    h, w = plane.shape
    assert h % 8 == 0 and w % 8 == 0
    plane = np.ascontiguousarray(plane)
    out = np.empty((h // 8, w // 8, 64), dtype=np.int16)
    q = np.ascontiguousarray(quant_zz, dtype=np.float32)
    zz = np.ascontiguousarray(ZIGZAG_TO_BLOCK, dtype=np.uint8)
    if plane.dtype == np.uint8:
        u8, i32 = plane.ctypes.data_as(ctypes.c_void_p), None
    elif plane.dtype == np.int32:
        u8, i32 = None, plane.ctypes.data_as(ctypes.c_void_p)
    else:
        raise TypeError(f"unsupported plane dtype {plane.dtype}")
    lib.jpx_fdct_quantize(
        u8, i32, h, w,
        q.ctypes.data_as(ctypes.c_void_p),
        zz.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        0,
        ctypes.c_float(level_shift),
    )
    return out


_TRANSFORM_SCRATCH = __import__("threading").local()


def encode_transform_rgb(rgb: np.ndarray, max_h: int, max_v: int, quants,
                         with_histograms: bool = False):
    """Fused baseline RGB encode transform: one threaded native stripe
    pass doing RGB->YCbCr + zero-pad + chroma box subsample + AAN FDCT
    + quantize, emitting MCU-walk-ordered block arrays directly — the
    whole transform stage of ``encode_rgb`` in a single image read.
    Byte-identical to the staged rgb_to_ycbcr/forward_component/
    mcu_order_blocks pipeline.

    ``rgb``: uint8 [H, W, 3]; ``max_h``/``max_v``: luma sampling
    factors (chroma 1x1); ``quants``: three [64] zig-zag divisor
    tables in frame order (Y, Cb, Cr). Returns three int16 [N, 64]
    MCU-ordered block arrays."""
    lib = build.load_library()
    from ..ops import color as color_ops
    from ..ops.zigzag import ZIGZAG_TO_BLOCK

    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]
    mcl = -(-w // (8 * max_h))
    mcc = -(-h // (8 * max_v))
    n_mcus = mcl * mcc
    # Reuse output buffers across calls (thread-local): fresh 10+ MB
    # allocations page-fault on every touch, which costs more than the
    # FDCT itself on repeat encodes. Buffers are handed to the caller,
    # so keep a generation pair and only reuse once the previous
    # call's arrays could still be alive — encode() consumes them
    # within the call, and per-thread reuse means no cross-thread
    # aliasing; a caller holding blocks across two encodes on the same
    # thread must copy (encode() never does).
    ny = n_mcus * max_h * max_v
    if (ny + 2 * n_mcus) * 128 > (64 << 20):
        # Very large image (> 64 MB of coefficients): one-shot buffers.
        # Caching would pin that much memory PER POOL THREAD when
        # encode_batch_rgb fans large images across the shared pool.
        out_y = np.empty((ny, 64), dtype=np.int16)
        out_cb = np.empty((n_mcus, 64), dtype=np.int16)
        out_cr = np.empty((n_mcus, 64), dtype=np.int16)
    else:
        cache = getattr(_TRANSFORM_SCRATCH, "bufs", None)
        if cache is None or cache[0].shape[0] < ny or cache[1].shape[0] < n_mcus:
            cache = (
                np.empty((ny, 64), dtype=np.int16),
                np.empty((n_mcus, 64), dtype=np.int16),
                np.empty((n_mcus, 64), dtype=np.int16),
            )
            _TRANSFORM_SCRATCH.bufs = cache
        out_y = cache[0][:ny]
        out_cb = cache[1][:n_mcus]
        out_cr = cache[2][:n_mcus]
    qs = [np.ascontiguousarray(q, dtype=np.float32) for q in quants]
    zz = np.ascontiguousarray(ZIGZAG_TO_BLOCK, dtype=np.uint8)
    consts = (ctypes.c_int32 * 8)(
        color_ops._Y_R, color_ops._Y_G, color_ops._Y_B,
        color_ops._CB_R, color_ops._CB_G, color_ops._CB_B,
        color_ops._CR_G, color_ops._CR_B,
    )
    hists = np.zeros(3 * 512, dtype=np.int64) if with_histograms else None
    lib.jpx_encode_transform_rgb(
        rgb.ctypes.data_as(ctypes.c_void_p), h, w,
        max_h, max_v,
        qs[0].ctypes.data_as(ctypes.c_void_p),
        qs[1].ctypes.data_as(ctypes.c_void_p),
        qs[2].ctypes.data_as(ctypes.c_void_p),
        zz.ctypes.data_as(ctypes.c_void_p), consts,
        out_y.ctypes.data_as(ctypes.c_void_p),
        out_cb.ctypes.data_as(ctypes.c_void_p),
        out_cr.ctypes.data_as(ctypes.c_void_p),
        hists.ctypes.data_as(ctypes.c_void_p) if hists is not None else None,
        0,
    )
    if with_histograms:
        # per component: (dc[256], ac[256]) — jpx_symbol_histograms
        # statistics produced inside the transform pass
        split = [
            (hists[i * 512 : i * 512 + 256].copy(),
             hists[i * 512 + 256 : (i + 1) * 512].copy())
            for i in range(3)
        ]
        return (out_y, out_cb, out_cr), split
    return out_y, out_cb, out_cr


def encode_transform_cmyk(ink: np.ndarray, max_h: int, max_v: int,
                          ycck: bool, quants):
    """Fused 4-component ink (CMYK/YCCK) encode transform: one
    threaded native stripe pass (invert / fixed-point YCCK convert +
    pad + chroma subsample + FDCT + quantize + MCU ordering).
    ``quants``: four [64] zig-zag divisor tables in frame order.
    Returns four int16 [N, 64] MCU-ordered block arrays."""
    lib = build.load_library()
    from ..ops import color as color_ops
    from ..ops.zigzag import ZIGZAG_TO_BLOCK

    ink = np.ascontiguousarray(ink, dtype=np.uint8)
    h, w = ink.shape[:2]
    mcl = -(-w // (8 * max_h))
    mcc = -(-h // (8 * max_v))
    n_mcus = mcl * mcc
    per = max_h * max_v
    outs = [
        np.empty((n_mcus * per, 64), dtype=np.int16),
        np.empty((n_mcus, 64), dtype=np.int16),
        np.empty((n_mcus, 64), dtype=np.int16),
        np.empty((n_mcus * per, 64), dtype=np.int16),
    ]
    qs = [np.ascontiguousarray(q, dtype=np.float32) for q in quants]
    zz = np.ascontiguousarray(ZIGZAG_TO_BLOCK, dtype=np.uint8)
    consts = (ctypes.c_int32 * 8)(
        color_ops._Y_R, color_ops._Y_G, color_ops._Y_B,
        color_ops._CB_R, color_ops._CB_G, color_ops._CB_B,
        color_ops._CR_G, color_ops._CR_B,
    )
    lib.jpx_encode_transform_cmyk(
        ink.ctypes.data_as(ctypes.c_void_p), h, w,
        max_h, max_v, 1 if ycck else 0,
        qs[0].ctypes.data_as(ctypes.c_void_p),
        qs[1].ctypes.data_as(ctypes.c_void_p),
        qs[2].ctypes.data_as(ctypes.c_void_p),
        qs[3].ctypes.data_as(ctypes.c_void_p),
        zz.ctypes.data_as(ctypes.c_void_p), consts,
        outs[0].ctypes.data_as(ctypes.c_void_p),
        outs[1].ctypes.data_as(ctypes.c_void_p),
        outs[2].ctypes.data_as(ctypes.c_void_p),
        outs[3].ctypes.data_as(ctypes.c_void_p),
        0,
    )
    return outs


def encode_rgb_scan(
    rgb: np.ndarray,
    max_h: int,
    max_v: int,
    quants,
    tables,
    restart_interval: int = 0,
):
    """Fully fused fixed-table baseline encode: transform + Huffman
    scan emission in ONE threaded native pass (jpx_encode_rgb_baseline)
    — the image bytes are read exactly once and coefficients never
    leave the per-stripe cache. Returns the scan's entropy bytes
    (including RSTn separators), byte-identical to
    ``encode_transform_rgb`` + the segment emitter.

    ``tables``: three (dc_table, ac_table) HuffmanEncodingTable pairs
    in component order (Y, Cb, Cr)."""
    lib = build.load_library()
    from ..ops import color as color_ops
    from ..ops.zigzag import ZIGZAG_TO_BLOCK

    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]
    mcl = -(-w // (8 * max_h))
    mcc = -(-h // (8 * max_v))
    n_mcus = mcl * mcc
    bpm = max_h * max_v + 2
    qs = [np.ascontiguousarray(q, dtype=np.float32) for q in quants]
    zz = np.ascontiguousarray(ZIGZAG_TO_BLOCK, dtype=np.uint8)
    consts = (ctypes.c_int32 * 8)(
        color_ops._Y_R, color_ops._Y_G, color_ops._Y_B,
        color_ops._CB_R, color_ops._CB_G, color_ops._CB_B,
        color_ops._CR_G, color_ops._CR_B,
    )
    dc_codes = (ctypes.c_void_p * 3)()
    dc_sizes = (ctypes.c_void_p * 3)()
    ac_codes = (ctypes.c_void_p * 3)()
    ac_sizes = (ctypes.c_void_p * 3)()
    keepalive = []
    for i, (dc, ac) in enumerate(tables):
        dcc = np.ascontiguousarray(dc.codes, dtype=np.uint16)
        dcs = np.ascontiguousarray(dc.sizes, dtype=np.uint8)
        acc = np.ascontiguousarray(ac.codes, dtype=np.uint16)
        acs = np.ascontiguousarray(ac.sizes, dtype=np.uint8)
        keepalive += [dcc, dcs, acc, acs]
        dc_codes[i] = dcc.ctypes.data_as(ctypes.c_void_p).value
        dc_sizes[i] = dcs.ctypes.data_as(ctypes.c_void_p).value
        ac_codes[i] = acc.ctypes.data_as(ctypes.c_void_p).value
        ac_sizes[i] = acs.ctypes.data_as(ctypes.c_void_p).value
    n_seg = -(-n_mcus // restart_interval) if restart_interval > 0 else 1
    cap = n_mcus * bpm * 512 + n_seg * 2 + 1024
    out = np.empty(cap, dtype=np.uint8)
    written = lib.jpx_encode_rgb_baseline(
        rgb.ctypes.data_as(ctypes.c_void_p), h, w,
        max_h, max_v,
        qs[0].ctypes.data_as(ctypes.c_void_p),
        qs[1].ctypes.data_as(ctypes.c_void_p),
        qs[2].ctypes.data_as(ctypes.c_void_p),
        zz.ctypes.data_as(ctypes.c_void_p), consts,
        dc_codes, dc_sizes, ac_codes, ac_sizes,
        restart_interval,
        out.ctypes.data_as(ctypes.c_void_p), cap,
        0,
    )
    if written == -2:
        from ..models.encoder import JpegEncodeError

        raise JpegEncodeError("Huffman table has no code for an emitted symbol.")
    if written < 0:
        raise RuntimeError("native encode capacity exceeded")
    # Read-only memoryview: spares a full copy of the scan bytes on the
    # encode hot path (joins/compares like bytes).
    return memoryview(out)[: int(written)].toreadonly()


class RgbBandEncoder:
    """Streaming twin of :func:`encode_rgb_scan`: encode an RGB image
    band-at-a-time (jpx_encode_rgb_band) with the DC predictors and the
    partial-byte bit remainder carried across bands, producing scan
    bytes byte-identical to the whole-image fused encode. Bands must be
    multiples of 8*max_v rows except the last; no restart intervals
    (the staged streaming path keeps those — segments are byte-aligned
    and need no carry)."""

    def __init__(self, max_h: int, max_v: int, quants, tables):
        from ..ops import color as color_ops
        from ..ops.zigzag import ZIGZAG_TO_BLOCK

        self._lib = build.load_library()
        self.max_h = max_h
        self.max_v = max_v
        self._qs = [np.ascontiguousarray(q, dtype=np.float32) for q in quants]
        self._zz = np.ascontiguousarray(ZIGZAG_TO_BLOCK, dtype=np.uint8)
        self._consts = (ctypes.c_int32 * 8)(
            color_ops._Y_R, color_ops._Y_G, color_ops._Y_B,
            color_ops._CB_R, color_ops._CB_G, color_ops._CB_B,
            color_ops._CR_G, color_ops._CR_B,
        )
        self._dc_codes = (ctypes.c_void_p * 3)()
        self._dc_sizes = (ctypes.c_void_p * 3)()
        self._ac_codes = (ctypes.c_void_p * 3)()
        self._ac_sizes = (ctypes.c_void_p * 3)()
        self._keepalive = []
        for i, (dc, ac) in enumerate(tables):
            dcc = np.ascontiguousarray(dc.codes, dtype=np.uint16)
            dcs = np.ascontiguousarray(dc.sizes, dtype=np.uint8)
            acc = np.ascontiguousarray(ac.codes, dtype=np.uint16)
            acs = np.ascontiguousarray(ac.sizes, dtype=np.uint8)
            self._keepalive += [dcc, dcs, acc, acs]
            self._dc_codes[i] = dcc.ctypes.data_as(ctypes.c_void_p).value
            self._dc_sizes[i] = dcs.ctypes.data_as(ctypes.c_void_p).value
            self._ac_codes[i] = acc.ctypes.data_as(ctypes.c_void_p).value
            self._ac_sizes[i] = acs.ctypes.data_as(ctypes.c_void_p).value
        self._state = np.zeros(6, dtype=np.int64)

    def encode_band(self, rgb_band: np.ndarray, *, is_last: bool,
                    n_threads: int = 0):
        """Encode one band of whole MCU rows (the last band may be
        partial); returns the band's stuffed scan bytes. ``n_threads``
        0 = all hardware threads (tests force specific counts to
        exercise the empty-trailing-chunk chunking shapes)."""
        rgb_band = np.ascontiguousarray(rgb_band, dtype=np.uint8)
        h, w = rgb_band.shape[:2]
        mcl = -(-w // (8 * self.max_h))
        mcc = -(-h // (8 * self.max_v))
        bpm = self.max_h * self.max_v + 2
        # Optimistic output capacity (raw band bytes; compressed bands
        # are far smaller for natural content): on -1 retry at the
        # worst case with the carried state restored, so the steady
        # working set stays O(band).
        caps = (h * w * 3 + 65536, mcl * mcc * bpm * 512 + 1024)
        for attempt, cap in enumerate(caps):
            saved = self._state.copy()
            out = np.empty(cap, dtype=np.uint8)
            written = self._lib.jpx_encode_rgb_band(
                rgb_band.ctypes.data_as(ctypes.c_void_p), h, w,
                self.max_h, self.max_v,
                self._qs[0].ctypes.data_as(ctypes.c_void_p),
                self._qs[1].ctypes.data_as(ctypes.c_void_p),
                self._qs[2].ctypes.data_as(ctypes.c_void_p),
                self._zz.ctypes.data_as(ctypes.c_void_p), self._consts,
                self._dc_codes, self._dc_sizes,
                self._ac_codes, self._ac_sizes,
                self._state.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                1 if is_last else 0,
                out.ctypes.data_as(ctypes.c_void_p), cap,
                n_threads,
            )
            if written != -1:
                break
            self._state[:] = saved
        if written == -2:
            from ..models.encoder import JpegEncodeError

            raise JpegEncodeError(
                "Huffman table has no code for an emitted symbol."
            )
        if written < 0:
            raise RuntimeError("native band encode capacity exceeded")
        return memoryview(out)[: int(written)].toreadonly()


def encode_cmyk_scan(
    ink: np.ndarray,
    max_h: int,
    max_v: int,
    ycck: bool,
    quants,
    tables,
    restart_interval: int = 0,
):
    """Fully fused fixed-table 4-component (CMYK / YCCK) baseline
    encode — the ink twin of :func:`encode_rgb_scan`
    (jpx_encode_cmyk_baseline). ``tables``: FOUR (dc, ac)
    HuffmanEncodingTable pairs in component order."""
    lib = build.load_library()
    from ..ops import color as color_ops
    from ..ops.zigzag import ZIGZAG_TO_BLOCK

    ink = np.ascontiguousarray(ink, dtype=np.uint8)
    h, w = ink.shape[:2]
    mcl = -(-w // (8 * max_h))
    mcc = -(-h // (8 * max_v))
    n_mcus = mcl * mcc
    bpm = 2 * max_h * max_v + 2
    qs = [np.ascontiguousarray(q, dtype=np.float32) for q in quants]
    zz = np.ascontiguousarray(ZIGZAG_TO_BLOCK, dtype=np.uint8)
    consts = (ctypes.c_int32 * 8)(
        color_ops._Y_R, color_ops._Y_G, color_ops._Y_B,
        color_ops._CB_R, color_ops._CB_G, color_ops._CB_B,
        color_ops._CR_G, color_ops._CR_B,
    )
    dc_codes = (ctypes.c_void_p * 4)()
    dc_sizes = (ctypes.c_void_p * 4)()
    ac_codes = (ctypes.c_void_p * 4)()
    ac_sizes = (ctypes.c_void_p * 4)()
    keepalive = []
    for i, (dc, ac) in enumerate(tables):
        dcc = np.ascontiguousarray(dc.codes, dtype=np.uint16)
        dcs = np.ascontiguousarray(dc.sizes, dtype=np.uint8)
        acc = np.ascontiguousarray(ac.codes, dtype=np.uint16)
        acs = np.ascontiguousarray(ac.sizes, dtype=np.uint8)
        keepalive += [dcc, dcs, acc, acs]
        dc_codes[i] = dcc.ctypes.data_as(ctypes.c_void_p).value
        dc_sizes[i] = dcs.ctypes.data_as(ctypes.c_void_p).value
        ac_codes[i] = acc.ctypes.data_as(ctypes.c_void_p).value
        ac_sizes[i] = acs.ctypes.data_as(ctypes.c_void_p).value
    n_seg = -(-n_mcus // restart_interval) if restart_interval > 0 else 1
    cap = n_mcus * bpm * 512 + n_seg * 2 + 1024
    out = np.empty(cap, dtype=np.uint8)
    written = lib.jpx_encode_cmyk_baseline(
        ink.ctypes.data_as(ctypes.c_void_p), h, w,
        max_h, max_v, 1 if ycck else 0,
        qs[0].ctypes.data_as(ctypes.c_void_p),
        qs[1].ctypes.data_as(ctypes.c_void_p),
        qs[2].ctypes.data_as(ctypes.c_void_p),
        qs[3].ctypes.data_as(ctypes.c_void_p),
        zz.ctypes.data_as(ctypes.c_void_p), consts,
        dc_codes, dc_sizes, ac_codes, ac_sizes,
        restart_interval,
        out.ctypes.data_as(ctypes.c_void_p), cap,
        0,
    )
    if written == -2:
        from ..models.encoder import JpegEncodeError

        raise JpegEncodeError("Huffman table has no code for an emitted symbol.")
    if written < 0:
        raise RuntimeError("native encode capacity exceeded")
    return memoryview(out)[: int(written)].toreadonly()


def encode_prog_dc(blocks_list, per_mcu, n_mcus: int, ah: int, al: int,
                   tables=None, freqs=None, restart_interval: int = 0):
    """Progressive DC scan emission (count mode when ``freqs`` given).
    ``blocks_list``: per-component int16 [n, 64] MCU-ordered arrays.
    ``restart_interval`` > 0 emits the whole scan's RSTn-separated
    segments (fresh predictors each) in this one call."""
    lib = build.load_library()
    n = len(blocks_list)
    block_ptrs = (ctypes.c_void_p * n)()
    pm = (ctypes.c_int32 * n)()
    keepalive = []
    for i, b in enumerate(blocks_list):
        b = np.ascontiguousarray(b, dtype=np.int16)
        keepalive.append(b)
        block_ptrs[i] = b.ctypes.data_as(ctypes.c_void_p)
        pm[i] = int(per_mcu[i])
    if freqs is not None:
        fr = (ctypes.c_void_p * n)(
            *[f.ctypes.data_as(ctypes.c_void_p).value for f in freqs]
        )
        rc = lib.jpx_encode_prog_dc(
            n, block_ptrs, pm, n_mcus, ah, al, None, None,
            ctypes.cast(fr, ctypes.POINTER(ctypes.c_void_p)), None, 0,
            restart_interval,
        )
        if rc < 0:
            raise RuntimeError(f"prog DC count failed ({rc})")
        return None
    codes = (ctypes.c_void_p * n)()
    sizes = (ctypes.c_void_p * n)()
    for i, t in enumerate(tables):
        ca = np.ascontiguousarray(t.codes, dtype=np.uint16)
        sa = np.ascontiguousarray(t.sizes, dtype=np.uint8)
        keepalive += [ca, sa]
        codes[i] = ca.ctypes.data_as(ctypes.c_void_p)
        sizes[i] = sa.ctypes.data_as(ctypes.c_void_p)
    total = sum(int(n_mcus) * int(per_mcu[i]) for i in range(n))
    # DC worst case: 16-bit code + 15 diff bits ~ 4 B/block, doubled by
    # 0xFF stuffing -> 8 covers any valid stream.
    n_seg = -(-int(n_mcus) // restart_interval) if restart_interval > 0 else 1
    cap = total * 8 + n_seg * 2 + 4096
    out = np.empty(cap, dtype=np.uint8)
    written = lib.jpx_encode_prog_dc(
        n, block_ptrs, pm, n_mcus, ah, al, codes, sizes, None,
        out.ctypes.data_as(ctypes.c_void_p), cap, restart_interval,
    )
    if written == -2:
        from ..models.encoder import JpegEncodeError

        raise JpegEncodeError("Huffman table has no code for a DC symbol.")
    if written < 0:
        raise RuntimeError("prog DC emission capacity exceeded")
    return memoryview(out)[: int(written)].toreadonly()


def _encode_prog_ac(fn_name, blocks, ss, se, al, table=None, freq=None,
                    restart_interval: int = 0):
    lib = build.load_library()
    blocks = np.ascontiguousarray(blocks, dtype=np.int16)
    fn = getattr(lib, fn_name)
    if freq is not None:
        rc = fn(
            blocks.ctypes.data_as(ctypes.c_void_p), blocks.shape[0],
            ss, se, al, None, None,
            freq.ctypes.data_as(ctypes.c_void_p), None, 0,
            restart_interval,
        )
        if rc < 0:
            raise RuntimeError(f"{fn_name} count failed ({rc})")
        return None
    ca = np.ascontiguousarray(table.codes, dtype=np.uint16)
    sa = np.ascontiguousarray(table.sizes, dtype=np.uint8)
    # True worst case: 63 coefficients x (16-bit code + 15 value bits)
    # ~ 244 B/block, doubled by 0xFF stuffing -> 512 covers any valid
    # stream (np.empty is lazy-committed, so the slack is virtual).
    cap = blocks.shape[0] * 512 + 4096
    out = np.empty(cap, dtype=np.uint8)
    written = fn(
        blocks.ctypes.data_as(ctypes.c_void_p), blocks.shape[0],
        ss, se, al,
        ca.ctypes.data_as(ctypes.c_void_p), sa.ctypes.data_as(ctypes.c_void_p),
        None,
        out.ctypes.data_as(ctypes.c_void_p), cap, restart_interval,
    )
    if written == -2:
        from ..models.encoder import JpegEncodeError

        raise JpegEncodeError("Huffman table has no code for an AC symbol.")
    if written < 0:
        raise RuntimeError(f"{fn_name} emission capacity exceeded")
    return memoryview(out)[: int(written)].toreadonly()


def encode_prog_ac_first(blocks, ss, se, al, table=None, freq=None,
                         restart_interval: int = 0):
    return _encode_prog_ac("jpx_encode_prog_ac_first", blocks, ss, se, al,
                           table, freq, restart_interval)


def encode_prog_ac_refine(blocks, ss, se, al, table=None, freq=None,
                          restart_interval: int = 0):
    return _encode_prog_ac("jpx_encode_prog_ac_refine", blocks, ss, se, al,
                           table, freq, restart_interval)


def encode_arith_prog_dc(blocks_list, per_mcu, n_mcus: int, ah: int, al: int,
                         dc_ids, dc_l: int, dc_u: int,
                         restart_interval: int = 0):
    """Progressive arithmetic DC scan emission (SOF10)."""
    lib = build.load_library()
    n = len(blocks_list)
    block_ptrs = (ctypes.c_void_p * n)()
    pm = (ctypes.c_int32 * n)()
    ids = (ctypes.c_int32 * n)(*[int(i) for i in dc_ids])
    ls = (ctypes.c_int32 * n)(*([dc_l] * n))
    us = (ctypes.c_int32 * n)(*([dc_u] * n))
    keepalive = []
    total = 0
    for i, b in enumerate(blocks_list):
        b = np.ascontiguousarray(b, dtype=np.int16)
        keepalive.append(b)
        block_ptrs[i] = b.ctypes.data_as(ctypes.c_void_p)
        pm[i] = int(per_mcu[i])
        total += n_mcus * int(per_mcu[i])
    n_seg = -(-int(n_mcus) // restart_interval) if restart_interval > 0 else 1
    cap = total * 8 + n_seg * 2 + 4096
    out = np.empty(cap, dtype=np.uint8)
    written = lib.jpx_encode_arith_prog_dc(
        n, block_ptrs, pm, ids, ls, us, n_mcus, ah, al,
        out.ctypes.data_as(ctypes.c_void_p), cap, restart_interval,
    )
    if written < 0:
        raise RuntimeError("arith prog DC capacity exceeded")
    return memoryview(out)[: int(written)].toreadonly()


def encode_arith_prog_ac(blocks, ac_id: int, ac_kx: int,
                         ss: int, se: int, ah: int, al: int,
                         restart_interval: int = 0):
    """Progressive arithmetic AC scan emission (SOF10, one component)."""
    lib = build.load_library()
    blocks = np.ascontiguousarray(blocks, dtype=np.int16)
    n_seg = (
        -(-int(blocks.shape[0]) // restart_interval)
        if restart_interval > 0 else 1
    )
    cap = blocks.shape[0] * 320 + n_seg * 2 + 4096
    out = np.empty(cap, dtype=np.uint8)
    written = lib.jpx_encode_arith_prog_ac(
        blocks.ctypes.data_as(ctypes.c_void_p), blocks.shape[0],
        ac_id, ac_kx, ss, se, ah, al,
        out.ctypes.data_as(ctypes.c_void_p), cap, restart_interval,
    )
    if written < 0:
        raise RuntimeError("arith prog AC capacity exceeded")
    return memoryview(out)[: int(written)].toreadonly()


def encode_arith_segment(comps: Sequence[dict], n_mcus: int):
    """Emit one arithmetic-coded (SOF9) entropy segment natively.

    ``comps``: per-component dicts with ``blocks`` (int16 [n, 64]
    zig-zag, MCU order, positioned at this segment's first block),
    ``per_mcu``, ``dc_id``/``ac_id`` (statistics bin ids) and
    ``dc_l``/``dc_u``/``ac_kx`` conditioning. Statistics and registers
    start fresh — the per-scan / per-restart-segment contract.
    """
    lib = build.load_library()
    n = len(comps)
    block_ptrs = (ctypes.c_void_p * n)()
    per_mcu = (ctypes.c_int32 * n)()
    dc_ids = (ctypes.c_int32 * n)()
    ac_ids = (ctypes.c_int32 * n)()
    dc_l = (ctypes.c_int32 * n)()
    dc_u = (ctypes.c_int32 * n)()
    ac_kx = (ctypes.c_int32 * n)()
    keepalive = []
    total_blocks = 0
    for i, c in enumerate(comps):
        blocks = np.ascontiguousarray(c["blocks"], dtype=np.int16)
        keepalive.append(blocks)
        block_ptrs[i] = blocks.ctypes.data_as(ctypes.c_void_p)
        per_mcu[i] = int(c["per_mcu"])
        dc_ids[i] = int(c["dc_id"])
        ac_ids[i] = int(c["ac_id"])
        dc_l[i] = int(c["dc_l"])
        dc_u[i] = int(c["dc_u"])
        ac_kx[i] = int(c["ac_kx"])
        total_blocks += n_mcus * int(c["per_mcu"])

    cap = total_blocks * 320 + 4096  # worst case with stuffing
    out = np.empty(cap, dtype=np.uint8)
    written = lib.jpx_encode_arith_sequential(
        n,
        block_ptrs, per_mcu,
        dc_ids, ac_ids,
        dc_l, dc_u, ac_kx,
        n_mcus,
        out.ctypes.data_as(ctypes.c_void_p), cap,
    )
    if written < 0:
        raise RuntimeError("native arithmetic encode capacity exceeded")
    return memoryview(out)[: int(written)].toreadonly()


def encode_arith_scan(comps: Sequence[dict], n_mcus: int,
                      restart_interval: int = 0):
    """Whole SOF9 scan in one native call: restart segments (fresh QM
    state each, the restart contract) encode on separate threads and
    concatenate with RSTn separators — byte-identical to per-segment
    ``encode_arith_segment`` calls joined with RSTn. ``comps`` as in
    ``encode_arith_segment`` but positioned at the SCAN start."""
    lib = build.load_library()
    n = len(comps)
    block_ptrs = (ctypes.c_void_p * n)()
    per_mcu = (ctypes.c_int32 * n)()
    dc_ids = (ctypes.c_int32 * n)()
    ac_ids = (ctypes.c_int32 * n)()
    dc_l = (ctypes.c_int32 * n)()
    dc_u = (ctypes.c_int32 * n)()
    ac_kx = (ctypes.c_int32 * n)()
    keepalive = []
    total_blocks = 0
    for i, c in enumerate(comps):
        blocks = np.ascontiguousarray(c["blocks"], dtype=np.int16)
        keepalive.append(blocks)
        block_ptrs[i] = blocks.ctypes.data_as(ctypes.c_void_p)
        per_mcu[i] = int(c["per_mcu"])
        dc_ids[i] = int(c["dc_id"])
        ac_ids[i] = int(c["ac_id"])
        dc_l[i] = int(c["dc_l"])
        dc_u[i] = int(c["dc_u"])
        ac_kx[i] = int(c["ac_kx"])
        total_blocks += n_mcus * int(c["per_mcu"])

    n_seg = -(-n_mcus // restart_interval) if restart_interval > 0 else 1
    cap = total_blocks * 320 + n_seg * 2 + 4096
    out = np.empty(cap, dtype=np.uint8)
    written = lib.jpx_encode_arith_restart_parallel(
        n,
        block_ptrs, per_mcu,
        dc_ids, ac_ids,
        dc_l, dc_u, ac_kx,
        n_mcus, restart_interval,
        out.ctypes.data_as(ctypes.c_void_p), cap,
        0,
    )
    if written < 0:
        raise RuntimeError("native arithmetic encode capacity exceeded")
    return memoryview(out)[: int(written)].toreadonly()


def pack_lossless(cats: np.ndarray, raws: np.ndarray, tables, *,
                  pattern=None):
    """Native lossless (SOF3) category-stream packer; entry i uses
    table pattern[i % len(pattern)] (default: plain component cycle).
    Bit-identical to models.lossless._pack_lossless_py."""
    lib = build.load_library()
    cats = np.ascontiguousarray(cats, dtype=np.uint8)
    raws = np.ascontiguousarray(raws, dtype=np.uint16)
    if pattern is None:
        pattern = np.arange(len(tables), dtype=np.uint8)
    pattern = np.ascontiguousarray(pattern, dtype=np.uint8)
    n = len(tables)
    code_ptrs = (ctypes.c_void_p * n)()
    size_ptrs = (ctypes.c_void_p * n)()
    keepalive = []
    for i, t in enumerate(tables):
        codes = np.ascontiguousarray(t.codes, dtype=np.uint16)
        sizes = np.ascontiguousarray(t.sizes, dtype=np.uint8)
        keepalive += [codes, sizes]
        code_ptrs[i] = codes.ctypes.data_as(ctypes.c_void_p)
        size_ptrs[i] = sizes.ctypes.data_as(ctypes.c_void_p)
    cap = int(cats.shape[0]) * 8 + 1024  # <= 31-bit entries, 2x stuffing
    out = np.empty(cap, dtype=np.uint8)
    written = lib.jpx_pack_lossless(
        cats.ctypes.data_as(ctypes.c_void_p),
        raws.ctypes.data_as(ctypes.c_void_p),
        cats.shape[0],
        pattern.ctypes.data_as(ctypes.c_void_p), pattern.shape[0],
        code_ptrs, size_ptrs,
        out.ctypes.data_as(ctypes.c_void_p), cap,
    )
    if written == -2:
        raise RuntimeError("lossless table missing a category code")
    if written < 0:
        raise RuntimeError("lossless pack capacity exceeded")
    return memoryview(out)[: int(written)].toreadonly()


def lossless_diffs_hist(plane: np.ndarray, pt: int, sel: int, init: int,
                        restart_interval: int = 0):
    """Threaded native prediction-difference + category-histogram pass
    for one 1x1-sampled lossless component plane (the encode twin of
    models/lossless._lossless_diffs at v=h=1, including the restart
    re-prediction fix-up). Returns (diffs int16 [H, W], hist int64
    [256])."""
    lib = build.load_library()
    plane = np.ascontiguousarray(plane)
    if plane.dtype == np.uint8:
        p8 = plane.ctypes.data_as(ctypes.c_void_p)
        p16 = None
    else:
        if plane.dtype != np.uint16:
            plane = np.ascontiguousarray(plane.astype(np.uint16))
        p8 = None
        p16 = plane.ctypes.data_as(ctypes.c_void_p)
    h, w = plane.shape
    diffs = np.empty((h, w), dtype=np.int16)
    hist = np.zeros(256, dtype=np.int64)
    rc = lib.jpx_lossless_diffs_hist(
        p8, p16, h, w, pt, sel, init, restart_interval,
        diffs.ctypes.data_as(ctypes.c_void_p),
        hist.ctypes.data_as(ctypes.c_void_p),
        0,
    )
    if rc < 0:
        raise RuntimeError(f"lossless diff pass failed ({rc})")
    return diffs, hist


def pack_lossless_diffs(diff_planes, tables, restart_interval: int = 0):
    """Pack interleaved 1x1 lossless diff planes into the scan entropy
    bytes in one threaded native call (RSTn segments when
    ``restart_interval`` > 0, shift-merged concurrent chunks
    otherwise). Byte-identical to the cats/raws staged pack. Returns a
    read-only memoryview over a freshly allocated buffer (compares and
    joins like bytes; avoids an extra multi-MB copy on the encode hot
    path)."""
    lib = build.load_library()
    n = len(diff_planes)
    diffs = [np.ascontiguousarray(d, dtype=np.int16) for d in diff_planes]
    n_px = int(diffs[0].size)
    diff_ptrs = (ctypes.c_void_p * n)(
        *[d.ctypes.data_as(ctypes.c_void_p).value for d in diffs]
    )
    code_ptrs = (ctypes.c_void_p * n)()
    size_ptrs = (ctypes.c_void_p * n)()
    keepalive = []
    for i, t in enumerate(tables):
        codes = np.ascontiguousarray(t.codes, dtype=np.uint16)
        sizes = np.ascontiguousarray(t.sizes, dtype=np.uint8)
        keepalive += [codes, sizes]
        code_ptrs[i] = codes.ctypes.data_as(ctypes.c_void_p)
        size_ptrs[i] = sizes.ctypes.data_as(ctypes.c_void_p)
    n_seg = -(-n_px // restart_interval) if restart_interval > 0 else 1
    cap = n_px * n * 8 + n_seg * 2 + 1024
    out = np.empty(cap, dtype=np.uint8)
    written = lib.jpx_pack_lossless_diffs(
        diff_ptrs, n, n_px, restart_interval,
        code_ptrs, size_ptrs,
        out.ctypes.data_as(ctypes.c_void_p), cap,
        0,
    )
    if written == -2:
        raise RuntimeError("lossless table missing a category code")
    if written < 0:
        raise RuntimeError("lossless pack capacity exceeded")
    view = memoryview(out)[: int(written)]
    return view.toreadonly()


def pack_lossless_restart(cats: np.ndarray, raws: np.ndarray, tables,
                          step: int, *, pattern=None):
    """Whole restart-segmented lossless scan in one native call:
    ``step`` entries per segment, fresh bit state + RSTn separators,
    threaded over segment ranges. Byte-identical to per-segment
    ``pack_lossless`` calls joined with RSTn."""
    lib = build.load_library()
    cats = np.ascontiguousarray(cats, dtype=np.uint8)
    raws = np.ascontiguousarray(raws, dtype=np.uint16)
    if pattern is None:
        pattern = np.arange(len(tables), dtype=np.uint8)
    pattern = np.ascontiguousarray(pattern, dtype=np.uint8)
    n = len(tables)
    code_ptrs = (ctypes.c_void_p * n)()
    size_ptrs = (ctypes.c_void_p * n)()
    keepalive = []
    for i, t in enumerate(tables):
        codes = np.ascontiguousarray(t.codes, dtype=np.uint16)
        sizes = np.ascontiguousarray(t.sizes, dtype=np.uint8)
        keepalive += [codes, sizes]
        code_ptrs[i] = codes.ctypes.data_as(ctypes.c_void_p)
        size_ptrs[i] = sizes.ctypes.data_as(ctypes.c_void_p)
    n_seg = -(-int(cats.shape[0]) // step) if step > 0 else 1
    cap = int(cats.shape[0]) * 8 + n_seg * 2 + 1024
    out = np.empty(cap, dtype=np.uint8)
    written = lib.jpx_pack_lossless_restart(
        cats.ctypes.data_as(ctypes.c_void_p),
        raws.ctypes.data_as(ctypes.c_void_p),
        cats.shape[0], step,
        pattern.ctypes.data_as(ctypes.c_void_p), pattern.shape[0],
        code_ptrs, size_ptrs,
        out.ctypes.data_as(ctypes.c_void_p), cap,
        0,
    )
    if written == -2:
        raise RuntimeError("lossless table missing a category code")
    if written < 0:
        raise RuntimeError("lossless pack capacity exceeded")
    return memoryview(out)[: int(written)].toreadonly()


def symbol_histograms(blocks: np.ndarray):
    """Native threaded DC/AC symbol histograms for MCU-ordered int16
    [N, 64] blocks; bit-identical to
    ops.encode_stage.dc_ac_symbol_frequencies."""
    lib = build.load_library()
    blocks = np.ascontiguousarray(blocks, dtype=np.int16)
    dc = np.zeros(256, dtype=np.int64)
    ac = np.zeros(256, dtype=np.int64)
    lib.jpx_symbol_histograms(
        blocks.ctypes.data_as(ctypes.c_void_p), blocks.shape[0],
        dc.ctypes.data_as(ctypes.c_void_p), ac.ctypes.data_as(ctypes.c_void_p),
        0,
    )
    return dc, ac


def encode_segment(comps: Sequence[dict], n_mcus: int, *, parallel: bool = False,
                   restart_interval: int = 0):
    """Emit one byte-aligned entropy segment natively.

    ``comps``: per-component dicts with keys ``blocks`` (int16 [n, 64]
    MCU-ordered, positioned at this segment's first block), ``per_mcu``,
    ``dc_codes``/``dc_sizes``/``ac_codes``/``ac_sizes`` (the
    HuffmanEncodingTable arrays). DC predictors start at zero — the
    per-scan / per-restart-segment contract.

    ``parallel`` packs MCU chunks concurrently (unstuffed) and
    shift-merges them — bit-identical output, used for the big single
    segment the reference-parity encoder emits (no restart markers).

    ``restart_interval`` > 0 emits the WHOLE restart-segmented scan in
    this one call (jpx_encode_segments_rst: fresh predictors per
    segment, byte-aligned RSTn between, threaded over segment ranges) —
    byte-identical to per-segment calls joined with RSTn.
    """
    lib = build.load_library()
    n = len(comps)
    block_ptrs = (ctypes.c_void_p * n)()
    per_mcu = (ctypes.c_int32 * n)()
    dc_code_ptrs = (ctypes.c_void_p * n)()
    dc_size_ptrs = (ctypes.c_void_p * n)()
    ac_code_ptrs = (ctypes.c_void_p * n)()
    ac_size_ptrs = (ctypes.c_void_p * n)()
    keepalive = []
    total_blocks = 0
    for i, c in enumerate(comps):
        blocks = np.ascontiguousarray(c["blocks"], dtype=np.int16)
        dc_codes = np.ascontiguousarray(c["dc_codes"], dtype=np.uint16)
        dc_sizes = np.ascontiguousarray(c["dc_sizes"], dtype=np.uint8)
        ac_codes = np.ascontiguousarray(c["ac_codes"], dtype=np.uint16)
        ac_sizes = np.ascontiguousarray(c["ac_sizes"], dtype=np.uint8)
        keepalive += [blocks, dc_codes, dc_sizes, ac_codes, ac_sizes]
        block_ptrs[i] = blocks.ctypes.data_as(ctypes.c_void_p)
        per_mcu[i] = int(c["per_mcu"])
        dc_code_ptrs[i] = dc_codes.ctypes.data_as(ctypes.c_void_p)
        dc_size_ptrs[i] = dc_sizes.ctypes.data_as(ctypes.c_void_p)
        ac_code_ptrs[i] = ac_codes.ctypes.data_as(ctypes.c_void_p)
        ac_size_ptrs[i] = ac_sizes.ctypes.data_as(ctypes.c_void_p)
        total_blocks += n_mcus * int(c["per_mcu"])

    # 64 x (16-bit code + 15 value bits) ~ 248 B/block, doubled by
    # 0xFF stuffing -> 512 covers any valid stream.
    n_seg = -(-int(n_mcus) // restart_interval) if restart_interval > 0 else 1
    cap = total_blocks * 512 + n_seg * 2 + 1024
    out = np.empty(cap, dtype=np.uint8)
    if restart_interval > 0:
        written = lib.jpx_encode_segments_rst(
            n,
            block_ptrs, per_mcu,
            dc_code_ptrs, dc_size_ptrs,
            ac_code_ptrs, ac_size_ptrs,
            n_mcus, restart_interval,
            out.ctypes.data_as(ctypes.c_void_p), cap,
            0,
        )
    elif parallel:
        written = lib.jpx_encode_segment_parallel(
            n,
            block_ptrs, per_mcu,
            dc_code_ptrs, dc_size_ptrs,
            ac_code_ptrs, ac_size_ptrs,
            n_mcus,
            out.ctypes.data_as(ctypes.c_void_p), cap,
            0,
        )
    else:
        written = lib.jpx_encode_segment(
            n,
            block_ptrs, per_mcu,
            dc_code_ptrs, dc_size_ptrs,
            ac_code_ptrs, ac_size_ptrs,
            n_mcus,
            out.ctypes.data_as(ctypes.c_void_p), cap,
        )
    if written == -2:
        from ..models.encoder import JpegEncodeError

        raise JpegEncodeError("Huffman table has no code for an emitted symbol.")
    if written < 0:
        raise RuntimeError("native encode capacity exceeded")
    return memoryview(out)[: int(written)].toreadonly()


class EncodeCarry:
    """Cross-call entropy-emission state for streaming encode: per-
    component DC predictors plus the partial-byte bit register. One
    instance spans a single entropy segment; ``finalize`` (1-pad +
    flush) ends it, and restart boundaries start a fresh instance."""

    def __init__(self, n_comps: int):
        self.predictors = (ctypes.c_int32 * n_comps)()
        self.reg = ctypes.c_uint64(0)
        self.bits = ctypes.c_int32(0)

    def reset(self) -> None:
        for i in range(len(self.predictors)):
            self.predictors[i] = 0
        self.reg.value = 0
        self.bits.value = 0


def encode_segment_carry(
    comps: Sequence[dict], n_mcus: int, carry: EncodeCarry, *, finalize: bool
):
    """Streaming (stripe-at-a-time) entropy emission: like
    ``encode_segment`` but DC predictors and the partial-byte bit
    register persist in ``carry`` across calls, so a scan can be
    emitted without ever holding all of its blocks (the reference's
    bufferless WriteScanData contract, JpegEncoder.cs:662-741).
    Chained calls are bit-identical to one ``encode_segment`` over the
    concatenated blocks."""
    lib = build.load_library()
    n = len(comps)
    block_ptrs = (ctypes.c_void_p * n)()
    per_mcu = (ctypes.c_int32 * n)()
    dc_code_ptrs = (ctypes.c_void_p * n)()
    dc_size_ptrs = (ctypes.c_void_p * n)()
    ac_code_ptrs = (ctypes.c_void_p * n)()
    ac_size_ptrs = (ctypes.c_void_p * n)()
    keepalive = []
    total_blocks = 0
    for i, c in enumerate(comps):
        blocks = np.ascontiguousarray(c["blocks"], dtype=np.int16)
        dc_codes = np.ascontiguousarray(c["dc_codes"], dtype=np.uint16)
        dc_sizes = np.ascontiguousarray(c["dc_sizes"], dtype=np.uint8)
        ac_codes = np.ascontiguousarray(c["ac_codes"], dtype=np.uint16)
        ac_sizes = np.ascontiguousarray(c["ac_sizes"], dtype=np.uint8)
        keepalive += [blocks, dc_codes, dc_sizes, ac_codes, ac_sizes]
        block_ptrs[i] = blocks.ctypes.data_as(ctypes.c_void_p)
        per_mcu[i] = int(c["per_mcu"])
        dc_code_ptrs[i] = dc_codes.ctypes.data_as(ctypes.c_void_p)
        dc_size_ptrs[i] = dc_sizes.ctypes.data_as(ctypes.c_void_p)
        ac_code_ptrs[i] = ac_codes.ctypes.data_as(ctypes.c_void_p)
        ac_size_ptrs[i] = ac_sizes.ctypes.data_as(ctypes.c_void_p)
        total_blocks += n_mcus * int(c["per_mcu"])

    cap = total_blocks * 512 + 1024  # worst case incl. stuffing
    out = np.empty(cap, dtype=np.uint8)
    written = lib.jpx_encode_segment_carry(
        n,
        block_ptrs, per_mcu,
        dc_code_ptrs, dc_size_ptrs,
        ac_code_ptrs, ac_size_ptrs,
        n_mcus,
        out.ctypes.data_as(ctypes.c_void_p), cap,
        carry.predictors,
        ctypes.byref(carry.reg),
        ctypes.byref(carry.bits),
        1 if finalize else 0,
    )
    if written == -2:
        from ..models.encoder import JpegEncodeError

        raise JpegEncodeError("Huffman table has no code for an emitted symbol.")
    if written < 0:
        raise RuntimeError("native encode capacity exceeded")
    return memoryview(out)[: int(written)].toreadonly()


_PACK_SCRATCH = __import__("threading").local()


def _pack_scratch(cap: int) -> np.ndarray:
    """Reusable per-thread scratch for the worst-case pack output —
    fresh 25 MB allocations per image cost ~10 ms in page faults (the
    MemoryPool discipline of the reference, JpegDecoder.cs:38)."""
    buf = getattr(_PACK_SCRATCH, "buf", None)
    if buf is None or buf.shape[0] < cap:
        buf = np.empty((cap, 2), dtype=np.int16)
        _PACK_SCRATCH.buf = buf
    return buf


def pack_sparse(planes: Sequence[np.ndarray], *, bucket_factor: float = 1.5) -> np.ndarray:
    """Pack dense int16 coefficient planes into interleaved
    (delta uint16, value int16) entries — the 4-byte sparse wire format
    the device unpacks with cumsum + scatter-add. Returns int16 [n, 2]
    (bucket-padded with (0, 0) no-op entries)."""
    lib = build.load_library()
    n = len(planes)
    ptrs = (ctypes.c_void_p * n)()
    sizes = (ctypes.c_int64 * n)()
    keepalive = []
    total = 0
    for i, p in enumerate(planes):
        flat = np.ascontiguousarray(p).reshape(-1)
        keepalive.append(flat)
        ptrs[i] = flat.ctypes.data_as(ctypes.c_void_p)
        sizes[i] = flat.shape[0]
        total += flat.shape[0]
    cap = total + 1024  # worst case: every coefficient nonzero
    out = _pack_scratch(cap)
    written = lib.jpx_pack_sparse(ptrs, sizes, n, out.ctypes.data_as(ctypes.c_void_p), cap)
    if written < 0:
        raise RuntimeError("sparse pack capacity exceeded")
    n_entries = int(written)
    bucket = 1024
    while bucket < n_entries:
        bucket = (int(bucket * bucket_factor) + 1023) & ~1023
    packed = np.zeros((bucket, 2), dtype=np.int16)
    packed[:n_entries] = out[:n_entries]
    return packed


def decode_lossless_arith_scan(
    data: bytes,
    spans: Sequence[EntropySpan],
    frame: FrameHeader,
    scan: ScanHeader,
    dac_dc,
    restart_interval: int,
    sample_planes: Dict[int, np.ndarray],
) -> bool:
    """Native SOF11/SOF15 scan decode (T.81 H.2); returns True when
    handled. Bit-identical to
    models.arithmetic_lossless.decode_lossless_scan_arithmetic."""
    lib = build.load_library()
    from ..models.geometry import ceil_div
    from ..models.huffman_baseline import JpegDecodeError

    resolved = resolve_scan_components(frame, scan)
    n = len(resolved)
    comp_h = (ctypes.c_int32 * n)()
    comp_v = (ctypes.c_int32 * n)()
    table_ids = (ctypes.c_int32 * n)()
    cond_lo = (ctypes.c_int32 * n)()
    cond_hi = (ctypes.c_int32 * n)()
    plane_ptrs = (ctypes.c_void_p * n)()
    widths = (ctypes.c_int64 * n)()
    keepalive = []
    for i, (comp_index, fc, sc) in enumerate(resolved):
        comp_h[i] = fc.horizontal_sampling_factor
        comp_v[i] = fc.vertical_sampling_factor
        table_ids[i] = sc.dc_table_selector
        cond = dac_dc.get(sc.dc_table_selector)
        dc_l = cond.dc_l if cond is not None else 0
        dc_u = cond.dc_u if cond is not None else 1
        cond_lo[i] = (1 << dc_l) >> 1
        cond_hi[i] = (1 << dc_u) >> 1
        plane = sample_planes[comp_index]
        assert plane.dtype == np.int16 and plane.flags.c_contiguous
        keepalive.append(plane)
        plane_ptrs[i] = plane.ctypes.data_as(ctypes.c_void_p)
        widths[i] = plane.shape[1]

    max_h = frame.max_horizontal_sampling
    max_v = frame.max_vertical_sampling
    pt = scan.successive_approximation_bit_position_low
    init_pred = (
        (1 << (frame.sample_precision - pt - 1))
        if scan.start_of_spectral_selection
        else 0
    )
    n_spans = len(spans)
    starts, ends, _span_keep = _span_ptrs(spans)
    buf = np.frombuffer(data, dtype=np.uint8)

    # Mirror the Python cursor's restart-boundary discipline before any
    # native path runs: a fabricated marker splitting a span must raise
    # ("Expect restart marker."), not decode the fragments as segments.
    validate_restart_spans(
        spans,
        restart_interval,
        ceil_div(frame.samples_per_line, max_h)
        * ceil_div(frame.number_of_lines, max_v),
    )

    # Restart-parallel path: spans are QM-self-contained (registers +
    # statistics + conditioning history reset), so they decode diffs
    # concurrently with a bit-free prediction pass after — the same
    # two-phase structure as the Huffman lossless parallel decode.
    # Requires a complete span table (truncation -> sequential for
    # identical error semantics) and 1x1 sampling.
    mcus_total = ceil_div(frame.samples_per_line, max_h) * ceil_div(
        frame.number_of_lines, max_v
    )
    threads = default_threads()
    if not os.environ.get("JPX_SCAN_THREADS"):
        threads = max(threads, os.cpu_count() or 2)
    if (
        restart_interval > 0
        and n_spans > 1
        and n_spans >= ceil_div(mcus_total, restart_interval)
        and max_h == 1
        and max_v == 1
        and all(comp_h[i] == 1 and comp_v[i] == 1 for i in range(n))
        and threads > 1
    ):
        rc = lib.jpx_decode_lossless_arith_restart_parallel(
            buf.ctypes.data_as(ctypes.c_void_p),
            starts, ends, n_spans,
            restart_interval,
            ceil_div(frame.samples_per_line, max_h),
            ceil_div(frame.number_of_lines, max_v),
            n,
            table_ids, cond_lo, cond_hi,
            plane_ptrs, widths,
            scan.start_of_spectral_selection,
            init_pred,
            threads,
        )
        if rc == 0:
            return True
        if rc == 2:
            from ..models.huffman_baseline import JpegDecodeError as _E

            raise _E("Invalid arithmetic code.")
        # other rc: sequential fallback

    rc = lib.jpx_decode_lossless_arith(
        buf.ctypes.data_as(ctypes.c_void_p),
        starts, ends, n_spans,
        restart_interval,
        ceil_div(frame.samples_per_line, max_h),
        ceil_div(frame.number_of_lines, max_v),
        n,
        comp_h, comp_v, table_ids, cond_lo, cond_hi,
        plane_ptrs, widths,
        scan.start_of_spectral_selection,
        init_pred,
    )
    if rc == 2:
        from ..models.huffman_baseline import JpegDecodeError as _E

        raise _E("Invalid arithmetic code.")
    if rc != 0:
        raise JpegDecodeError(f"native scanner error {rc}")
    return True


def encode_lossless_arith(
    comp_planes: Sequence[np.ndarray],
    sampling,
    table_ids,
    cond_lo_hi,
    predictor: int,
    initial_prediction: int,
    point_transform: int,
    restart_interval: int,
):
    """Native SOF11/SOF15 entropy encode: padded int32 component
    planes -> one entropy blob with inline RSTn markers. Bit-identical
    to the pure-Python encoder loop."""
    lib = build.load_library()
    n = len(comp_planes)
    comp_h = (ctypes.c_int32 * n)()
    comp_v = (ctypes.c_int32 * n)()
    tids = (ctypes.c_int32 * n)()
    cond_lo = (ctypes.c_int32 * n)()
    cond_hi = (ctypes.c_int32 * n)()
    plane_ptrs = (ctypes.c_void_p * n)()
    widths = (ctypes.c_int64 * n)()
    keepalive = []
    total = 0
    lo, hi = cond_lo_hi
    for i, p in enumerate(comp_planes):
        comp_h[i], comp_v[i] = sampling[i]
        tids[i] = table_ids[i]
        cond_lo[i] = lo
        cond_hi[i] = hi
        p = np.ascontiguousarray(p, dtype=np.int32)
        keepalive.append(p)
        plane_ptrs[i] = p.ctypes.data_as(ctypes.c_void_p)
        widths[i] = p.shape[1]
        total += p.size
    max_v = max(s[1] for s in sampling)
    max_h = max(s[0] for s in sampling)
    mcus_per_column = comp_planes[0].shape[0] // sampling[0][1]
    mcus_per_line = comp_planes[0].shape[1] // sampling[0][0]

    cap = total * 6 + 4096
    while True:
        out = np.empty(cap, dtype=np.uint8)
        written = lib.jpx_encode_lossless_arith_restart_parallel(
            plane_ptrs, widths,
            mcus_per_line, mcus_per_column,
            n,
            comp_h, comp_v, tids, cond_lo, cond_hi,
            predictor, initial_prediction, point_transform,
            restart_interval,
            out.ctypes.data_as(ctypes.c_void_p), cap, 0,
        )
        if written >= 0:
            return memoryview(out)[:written].toreadonly()
        if written == -1:
            cap *= 2
            continue
        raise RuntimeError(f"native arithmetic lossless encode error {written}")

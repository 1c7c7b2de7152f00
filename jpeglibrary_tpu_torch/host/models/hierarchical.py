"""Hierarchical JPEG (T.81 Annex J): DHP / EXP, differential frames.

The port's copy of the decode half of ``jpeglibrary_tpu/models/hierarchical.py``
(its ``encode_hierarchical`` is not copied).

A capability BEYOND the reference: yigolden/JpegLibrary rejects every
hierarchical SOF (JpegDecoder.cs ThrowUnsupported for SOF5-7/13-15) and
has no DHP/EXP handling. This module implements the full Annex-J
progression for the Huffman lossless differential mode:

- ``decode_hierarchical``: the multi-frame decode loop
  ``JpegDecoder.decode`` delegates to when the stream carries a DHP
  segment. Reference planes accumulate per component; EXP doubles them
  with the J.1.1.2 bilinear filter; differential frames add their
  decoded diffs mod 2^16 (J.1.5).

Frame structure (T.81 B.2.1, B.3):
    SOI [tables] DHP frame0 (EXP frame_i)* EOI
where frame_i = [tables] SOFn SOS ECS.

The entropy layer reuses the existing lossless machinery: predictor
selection 0 ("no prediction", T.81 Table H.1) with a zero initial
prediction IS differential coding, so the native restart-parallel and
speculative-parallel lossless scanners accelerate SOF7 scans unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..io import reader as io_reader
from ..ops import decode_stage
from ..syntax.frame import (
    FrameHeader,
    ScanHeader,
    resolve_scan_components,
)
from ..syntax.markers import (
    ALL_SOF_MARKERS,
    Marker,
)
from .geometry import allocate_coefficient_planes, frame_geometry

#: Differential SOF markers (T.81 Table B.1) — ALL implemented:
#: lossless SOF7/SOF15 (Huffman/arithmetic), sequential DCT
#: SOF5/SOF13, progressive DCT SOF6/SOF14.
DIFFERENTIAL_SOF_MARKERS = frozenset(
    {Marker.SOF5, Marker.SOF6, Marker.SOF7, Marker.SOF13, Marker.SOF14, Marker.SOF15}
)


# ---------------------------------------------------------------------------
# J.1.1.2 reference expansion
# ---------------------------------------------------------------------------


def expand_reference(plane: np.ndarray, eh: int, ev: int) -> np.ndarray:
    """Expand a reference component by 2 horizontally and/or vertically
    with the T.81 J.1.1.2 interpolation filter:

        P(2x)   = R(x)
        P(2x+1) = (R(x) + R(x+1) + 1) >> 1,  with R(W) = R(W-1)

    (then the same vertically). Input/output int32.
    """
    p = np.asarray(plane, dtype=np.int32)
    if eh:
        right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
        odd = (p + right + 1) >> 1
        out = np.empty((p.shape[0], 2 * p.shape[1]), dtype=np.int32)
        out[:, 0::2] = p
        out[:, 1::2] = odd
        p = out
    if ev:
        below = np.concatenate([p[1:, :], p[-1:, :]], axis=0)
        odd = (p + below + 1) >> 1
        out = np.empty((2 * p.shape[0], p.shape[1]), dtype=np.int32)
        out[0::2, :] = p
        out[1::2, :] = odd
        p = out
    return p


# ---------------------------------------------------------------------------
# Decoder: the multi-frame loop
# ---------------------------------------------------------------------------


def decode_hierarchical(decoder, stream: io_reader.JpegStream, data: bytes, *,
                        use_native: bool = True, xp=np):
    """Decode a hierarchical stream (called by JpegDecoder.decode when a
    DHP segment is present). Returns a DecodeResult whose sample planes
    are the fully refined reference components at DHP resolution."""
    from .decoder import DecodeResult
    from .huffman_baseline import JpegDecodeError
    from ..utils import metrics

    dhp: Optional[FrameHeader] = None
    #: component identifier -> int32 reference plane (current pyramid level)
    refs: Dict[int, np.ndarray] = {}
    pending_exp = None  # (Eh, Ev) from an EXP segment, for the next frame

    # Current-frame decode context
    frame: Optional[FrameHeader] = None
    sof_marker: Optional[int] = None
    geometry = None
    coefficient_planes = None
    sample_planes = None
    component_quant: Dict[int, np.ndarray] = {}
    progressive_jobs = []

    scan_iter = iter(stream.scans)

    def finalize_frame():
        """Fold the just-decoded frame into the reference planes."""
        nonlocal frame, sof_marker, geometry, coefficient_planes
        nonlocal sample_planes, progressive_jobs
        if frame is None:
            return
        differential = sof_marker in DIFFERENTIAL_SOF_MARKERS
        if progressive_jobs:
            from .decoder import _run_progressive_jobs

            _run_progressive_jobs(
                data, frame, geometry, coefficient_planes, progressive_jobs,
                arithmetic_state_factory=lambda: decoder._make_arithmetic_state(),
                use_native=use_native,
            )
            progressive_jobs = []
        mask = (1 << frame.sample_precision) - 1
        if sample_planes is not None:
            # Lossless frame (SOF3 non-diff / SOF7 diff): planes hold
            # samples (or raw diffs) on the padded MCU grid.
            from .lossless import component_sizes

            sizes = component_sizes(frame)
            for idx, fc in enumerate(frame.components):
                hc, wc = sizes[idx]
                vals = sample_planes[idx][:hc, :wc].astype(np.int32)
                if differential:
                    ref = refs.get(fc.identifier)
                    if ref is None:
                        raise JpegDecodeError(
                            f"Differential frame component {fc.identifier} "
                            "has no reference (no prior frame coded it)."
                        )
                    if ref.shape != (hc, wc):
                        raise JpegDecodeError(
                            f"Reference for component {fc.identifier} is "
                            f"{ref.shape}, differential frame needs {(hc, wc)} "
                            "(missing or wrong EXP segment?)."
                        )
                    # J.1.5: differential addition is modulo 2^16.
                    refs[fc.identifier] = (ref + vals) & 0xFFFF
                else:
                    refs[fc.identifier] = vals & 0xFFFF
        elif coefficient_planes is not None:
            # DCT frame. Non-differential: dequantize + IDCT + level
            # shift, clamped to the sample range (the writer clamp,
            # J.1.1.3) — the clamped values are the reference.
            # Differential (SOF5/SOF13): IDCT with NO level shift gives
            # the spatial differences; add to the reference and clamp.
            # Component sizes use the SAME integer-ratio convention as
            # the lossless frames and the final DHP check
            # (lossless.component_sizes) so pyramid stages agree for
            # every sampling layout.
            from .lossless import component_sizes

            dct_sizes = component_sizes(frame)
            for cg in geometry.components:
                fc = frame.components[cg.component_index]
                hc, wc = dct_sizes[cg.component_index]
                plane = decode_stage.component_plane(
                    coefficient_planes[cg.component_index],
                    component_quant[cg.component_index].astype(np.int32),
                    0 if differential else geometry.level_shift,
                    1, 1, hc, wc,
                )
                if differential:
                    ref = refs.get(fc.identifier)
                    if ref is None:
                        raise JpegDecodeError(
                            f"Differential frame component {fc.identifier} "
                            "has no reference (no prior frame coded it)."
                        )
                    if ref.shape != (hc, wc):
                        raise JpegDecodeError(
                            f"Reference for component {fc.identifier} is "
                            f"{ref.shape}, differential frame needs "
                            f"{(hc, wc)} (missing or wrong EXP segment?)."
                        )
                    refs[fc.identifier] = np.clip(ref + plane, 0, mask)
                else:
                    refs[fc.identifier] = np.clip(plane, 0, mask)
        frame = None
        sof_marker = None
        geometry = None
        coefficient_planes = None
        sample_planes = None

    for seg in stream.segments:
        if decoder._marker_handlers:
            decoder._dispatch_marker(seg, data)
        if seg.marker in (Marker.DQT, Marker.DHT, Marker.DAC, Marker.DRI):
            decoder._process_table_segment(seg, data)
        elif seg.marker == Marker.DHP:
            dhp = FrameHeader.parse(seg.payload(data), Marker.DHP)
        elif seg.marker == Marker.EXP:
            payload = seg.payload(data)
            if len(payload) < 1:
                raise JpegDecodeError("EXP segment too short.")
            pending_exp = (payload[0] >> 4, payload[0] & 0xF)
        elif seg.marker in ALL_SOF_MARKERS:
            finalize_frame()
            frame = io_reader.resolve_dnl(
                stream, data, FrameHeader.parse(seg.payload(data), seg.marker)
            )
            sof_marker = seg.marker
            geometry = frame_geometry(frame)
            decoder._arithmetic_state = None
            differential = sof_marker in DIFFERENTIAL_SOF_MARKERS
            if differential and pending_exp is not None:
                eh, ev = pending_exp
                from .lossless import component_sizes

                sizes = component_sizes(frame)
                for idx, fc in enumerate(frame.components):
                    ref = refs.get(fc.identifier)
                    if ref is None:
                        continue  # caught at finalize with a clear error
                    expanded = expand_reference(ref, eh, ev)
                    hc, wc = sizes[idx]
                    if expanded.shape[0] < hc or expanded.shape[1] < wc:
                        raise JpegDecodeError(
                            f"EXP-expanded reference {expanded.shape} smaller "
                            f"than frame component {(hc, wc)}."
                        )
                    refs[fc.identifier] = expanded[:hc, :wc]
            pending_exp = None
            if sof_marker in (Marker.SOF3, Marker.SOF7, Marker.SOF11,
                              Marker.SOF15):
                from .lossless import allocate_sample_planes

                sample_planes = allocate_sample_planes(frame)
            else:
                coefficient_planes = None
        elif seg.marker == Marker.SOS:
            if frame is None:
                raise ValueError("Frame header was not found before SOS.")
            scan = next(scan_iter)
            scan_header = ScanHeader.parse(seg.payload(data))
            with metrics.stage("decode.entropy_scan"):
                if sof_marker in (Marker.SOF11, Marker.SOF15):
                    from .arithmetic import ArithmeticDecoder
                    from .arithmetic_lossless import decode_scan

                    decode_scan(
                        data, scan.spans, frame, scan_header,
                        decoder._dac_dc, ArithmeticDecoder(),
                        decoder._restart_interval, sample_planes,
                        use_native=use_native,
                    )
                elif sample_planes is not None:
                    decoded_native = False
                    if use_native:
                        try:
                            from ..native import scanner as native_scanner

                            decoded_native = native_scanner.decode_lossless_scan(
                                data, scan.spans, frame, scan_header,
                                decoder._dc_tables, decoder._restart_interval,
                                sample_planes,
                            )
                        except ImportError:
                            decoded_native = False
                    if not decoded_native:
                        from .lossless import decode_lossless_scan

                        decode_lossless_scan(
                            data, scan.spans, frame, scan_header,
                            decoder._dc_tables, decoder._restart_interval,
                            sample_planes,
                        )
                elif sof_marker in (Marker.SOF2, Marker.SOF6, Marker.SOF10,
                                    Marker.SOF14):
                    for comp_index, fc, _sc in resolve_scan_components(
                        frame, scan_header
                    ):
                        qt = decoder._quant_tables.get(
                            fc.quantization_table_selector
                        )
                        if qt is None or qt.is_empty:
                            raise ValueError(
                                f"Quantization table of component "
                                f"{comp_index} is not defined."
                            )
                        component_quant[comp_index] = qt.elements.copy()
                    if coefficient_planes is None:
                        coefficient_planes = allocate_coefficient_planes(geometry)
                    progressive_jobs.append(
                        {
                            "scan": scan,
                            "scan_header": scan_header,
                            "dc_tables": dict(decoder._dc_tables),
                            "ac_tables": dict(decoder._ac_tables),
                            "dac_dc": dict(decoder._dac_dc),
                            "dac_ac": dict(decoder._dac_ac),
                            "restart_interval": decoder._restart_interval,
                            "arithmetic": sof_marker in (Marker.SOF10,
                                                         Marker.SOF14),
                        }
                    )
                else:
                    if coefficient_planes is None:
                        coefficient_planes = allocate_coefficient_planes(geometry)
                    decoder._decode_scan(
                        data, scan, scan_header, frame, sof_marker, geometry,
                        coefficient_planes, component_quant,
                        use_native=use_native,
                    )
        elif seg.marker == Marker.EOI:
            break

    finalize_frame()
    if dhp is None:
        raise ValueError("Hierarchical stream has no DHP segment.")
    if not refs:
        raise ValueError("No image data decoded.")

    # Assemble the final result at DHP resolution. The synthetic frame
    # keeps the DHP marker so callers can tell the mode apart; the
    # sample-plane output stage (duplication upsample + crop + writers)
    # is shared with lossless.
    from .lossless import component_sizes

    final_sizes = component_sizes(dhp)
    out_planes: Dict[int, np.ndarray] = {}
    for idx, fc in enumerate(dhp.components):
        ref = refs.get(fc.identifier)
        if ref is None:
            raise JpegDecodeError(
                f"Hierarchical stream never coded component {fc.identifier}."
            )
        hc, wc = final_sizes[idx]
        if ref.shape != (hc, wc):
            raise JpegDecodeError(
                f"Component {fc.identifier} ended at {ref.shape}, DHP "
                f"declares {(hc, wc)} (incomplete pyramid?)."
            )
        # Padded-grid plane for the shared output stage (which crops).
        out_planes[idx] = ref.astype(np.int16)

    metrics.count("decode.images")
    metrics.count(
        "decode.megapixels", dhp.samples_per_line * dhp.number_of_lines / 1e6
    )
    return DecodeResult(
        frame=dhp, geometry=frame_geometry(dhp), samples=out_planes, xp=xp
    )

"""Hierarchical JPEG (T.81 Annex J): DHP / EXP, differential frames.

A capability BEYOND the reference: yigolden/JpegLibrary rejects every
hierarchical SOF (JpegDecoder.cs ThrowUnsupported for SOF5-7/13-15) and
has no DHP/EXP handling. This module implements the full Annex-J
progression for the Huffman lossless differential mode:

- ``encode_hierarchical``: encodes a resolution pyramid — one
  non-differential base frame (lossless SOF3 or baseline SOF0) followed
  by EXP-expanded differential-lossless (SOF7) refinement frames. The
  final stage is lossless, so the decoded full-resolution image is
  bit-exact (with a lossless base) or an exact refinement of the lossy
  base (with a DCT base).
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
    FrameComponent,
    FrameHeader,
    ScanHeader,
    resolve_scan_components,
)
from ..syntax.markers import (
    ALL_SOF_MARKERS,
    Marker,
)
from .geometry import allocate_coefficient_planes, ceil_div, frame_geometry

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


def downsample2(plane: np.ndarray) -> np.ndarray:
    """Pyramid downsample by 2 in both axes: 2x2 mean with rounding,
    edge-replicated for odd dimensions. T.81 J.1.1.1 leaves the
    downsampling filter to the encoder; this one approximately inverts
    ``expand_reference`` so the differential frames stay small."""
    p = np.asarray(plane, dtype=np.int32)
    h, w = p.shape
    if h % 2:
        p = np.concatenate([p, p[-1:, :]], axis=0)
    if w % 2:
        p = np.concatenate([p, p[:, -1:]], axis=1)
    return (
        p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2] + 2
    ) >> 2


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


# ---------------------------------------------------------------------------
# Encoder: pyramid -> DHP + base frame + differential refinements
# ---------------------------------------------------------------------------


def encode_hierarchical(
    planes,
    *,
    precision: int = 8,
    levels: int = 3,
    base: str = "lossless",
    refinement: str = "lossless",
    final_lossless: bool = True,
    arithmetic: bool = False,
    quality: int = 75,
    restart_interval: int = 0,
) -> bytes:
    """Encode sample planes as a hierarchical (Annex J) JPEG pyramid.

    ``planes``: [H, W] array, [H, W, C] array, or list of same-shape
    [H, W] planes (1x1 sampling in every frame — resolution scaling is
    carried by the pyramid itself). Components are coded as-is (no
    color transform), matching ``encode_lossless`` semantics.

    ``levels``: number of frames. Level 0 is the base at
    ceil(dim / 2^(levels-1)); each refinement doubles resolution via an
    EXP segment and codes the residual as a differential frame.

    ``base``: ``"lossless"`` (SOF3, or SOF11 with ``arithmetic``) or
    ``"dct"`` (sequential DCT at ``quality``; SOF9 with
    ``arithmetic``).

    ``arithmetic`` switches EVERY frame to the QM-coded process:
    SOF3->SOF11, SOF0->SOF9, SOF5->SOF13, SOF6->SOF14, SOF7->SOF15 —
    an all-arithmetic Annex-J pyramid.

    ``refinement``: ``"lossless"`` codes residuals as
    differential-lossless SOF7 frames (final output decodes BIT-EXACTLY
    regardless of base). ``"dct"`` codes them as differential
    sequential DCT frames (SOF5, or SOF13 with ``arithmetic``) at
    ``quality`` — the classic lossy Annex-J pyramid; ``"progressive"``
    codes the same quantized residuals with progressive scan scripts
    (SOF6, or SOF14 with ``arithmetic``). With ``final_lossless``
    (default) the LAST refinement stays SOF7 so the full-resolution
    output is still exact.

    ``restart_interval`` applies to the differential frames (samples
    per restart segment for SOF7, MCUs for SOF5/SOF13) — their streams
    restart-partition, giving the decoder its parallel seam.
    """
    from ..io.writer import JpegWriter
    from .lossless import encode_lossless

    if isinstance(planes, np.ndarray) and planes.ndim == 3:
        planes = [planes[..., i] for i in range(planes.shape[-1])]
    elif isinstance(planes, np.ndarray):
        planes = [planes]
    planes = [np.asarray(p, dtype=np.int32) for p in planes]
    n_comps = len(planes)
    if not 1 <= n_comps <= 4:
        raise ValueError("1..4 components supported")
    h, w = planes[0].shape
    if any(p.shape != (h, w) for p in planes):
        raise ValueError("all planes must share one shape")
    if levels < 1:
        raise ValueError("levels must be >= 1")
    if base not in ("lossless", "dct"):
        raise ValueError(f"base mode {base!r} not in ('lossless', 'dct')")
    if refinement not in ("lossless", "dct", "progressive"):
        raise ValueError(
            f"refinement mode {refinement!r} not in "
            "('lossless', 'dct', 'progressive')"
        )
    if (base == "dct" or refinement != "lossless") and precision != 8:
        raise ValueError("DCT frames require precision=8")
    mask = (1 << precision) - 1

    # Pyramid: level levels-1 is the input; each lower level halves.
    pyramid = [planes]
    for _ in range(levels - 1):
        pyramid.append([downsample2(p) for p in pyramid[-1]])
    pyramid.reverse()  # pyramid[0] = smallest (base)

    def strip(jpeg_bytes: bytes) -> bytes:
        """Drop the SOI/EOI wrapper of a single-frame encode."""
        assert jpeg_bytes[:2] == b"\xff\xd8" and jpeg_bytes[-2:] == b"\xff\xd9"
        return jpeg_bytes[2:-2]

    def quality_tables():
        """Quality-scaled Annex-K quant tables: luminance for component
        0, chrominance shared by the rest — the ONE source of truth for
        every DCT frame in the pyramid."""
        from ..syntax.quantization import (
            scale_by_quality,
            standard_chrominance_table,
            standard_luminance_table,
        )

        qtabs = [scale_by_quality(standard_luminance_table(0), quality)]
        if n_comps > 1:
            qtabs.append(scale_by_quality(standard_chrominance_table(1), quality))
        return qtabs

    def make_dct_encoder(differential: bool):
        """A 1x1-sampled JpegEncoder over quality_tables() — the DCT
        base frame and the SOF5/SOF13 sequential refinements."""
        from . import encoder as encoder_mod
        from ..syntax import huffman_standard

        enc = encoder_mod.JpegEncoder()
        enc.arithmetic = arithmetic
        enc.differential = differential
        enc.restart_interval = restart_interval if differential else 0
        quants = quality_tables()
        for qt in quants:
            enc.set_quantization_table(qt)
        if not arithmetic:
            for tid in range(len(quants)):
                if differential:
                    # Residual statistics are nothing like Annex K's —
                    # registering builders switches on 2-pass optimize.
                    enc.set_huffman_table(True, tid, None)
                    enc.set_huffman_table(False, tid, None)
                elif tid == 0:
                    enc.set_huffman_table(True, 0, huffman_standard.dc_luminance())
                    enc.set_huffman_table(False, 0, huffman_standard.ac_luminance())
                else:
                    enc.set_huffman_table(True, 1, huffman_standard.dc_chrominance())
                    enc.set_huffman_table(False, 1, huffman_standard.ac_chrominance())
        for i in range(n_comps):
            q = 0 if i == 0 else 1
            enc.add_component(i + 1, q, q, q, 1, 1)
        return enc, [np.asarray(q.elements, dtype=np.int32) for q in quants]

    # Base frame + its reconstruction (the decoder's reference).
    base_planes = pyramid[0]
    if base == "lossless":
        if arithmetic:
            from .arithmetic_lossless import encode_lossless_arithmetic

            base_bytes = strip(
                encode_lossless_arithmetic(
                    [p.astype(np.int32) for p in base_planes],
                    precision=precision,
                    predictor=1,
                )
            )
        else:
            base_bytes = strip(
                encode_lossless(
                    [p.astype(np.int32) for p in base_planes],
                    precision=precision,
                    predictor=1,
                )
            )
        recon = [p & mask for p in base_planes]
    else:
        enc, _quants = make_dct_encoder(differential=False)
        enc.set_input([np.clip(p, 0, 255).astype(np.uint8) for p in base_planes])
        full = enc.encode()
        base_bytes = strip(full)
        # The decoder-side reference is OUR decode of the base frame
        # (clamped IDCT output) — reproduce it exactly.
        from .decoder import JpegDecoder

        dec = JpegDecoder()
        dec.set_input(full)
        result = dec.decode(use_native=True)
        recon = [
            np.clip(result.planes[i], 0, mask).astype(np.int32)
            for i in range(n_comps)
        ]

    writer = JpegWriter()
    writer.write_marker(Marker.SOI)
    dhp = FrameHeader(
        marker=Marker.DHP,
        sample_precision=precision,
        number_of_lines=h,
        samples_per_line=w,
        components=tuple(
            FrameComponent(i + 1, 1, 1, 0) for i in range(n_comps)
        ),
    )
    writer.write_segment(Marker.DHP, dhp.serialize())
    writer.write_bytes(base_bytes)

    for level in range(1, levels):
        target = pyramid[level]
        th, tw = target[0].shape
        # EXP: expand the reference by 2 in both axes (J.1.1.2), crop.
        writer.write_segment(Marker.EXP, bytes([0x11]))
        expanded = [expand_reference(r, 1, 1)[:th, :tw] for r in recon]
        diffs = [
            ((p & mask) - ref).astype(np.int32)
            for p, ref in zip(target, expanded)
        ]
        use_dct = refinement != "lossless" and not (
            final_lossless and level == levels - 1
        )
        if use_dct:
            # Differential DCT frame (SOF5/SOF13 sequential, SOF6/SOF14
            # progressive): FDCT of the spatial residuals with NO level
            # shift (J.1.1.3), quantized; the decoder adds the clamped
            # IDCT back onto the expanded reference, so the next level
            # diffs against the DECODER-side reconstruction (computed
            # here with the same component_plane the decoder uses —
            # exact parity). Progressive coefficient coding is lossless,
            # so the reconstruction is entropy-coder-independent.
            from ..ops import encode_stage

            qtabs = quality_tables()
            quants = [np.asarray(q.elements, dtype=np.int32) for q in qtabs]
            coeff_planes = []
            new_recon = []
            hb, wb = ceil_div(th, 8), ceil_div(tw, 8)
            comp_quants = [quants[0]] + [quants[-1]] * (n_comps - 1)
            for d, ref, qz in zip(diffs, expanded, comp_quants):
                coeffs = encode_stage.forward_component(
                    d, qz, 1, 1, 1, 1, wb, hb, xp=np, level_shift=0.0
                )
                coeff_planes.append(coeffs)
                plane = decode_stage.component_plane(
                    coeffs.astype(np.int32), qz, 0, 1, 1, th, tw
                )
                new_recon.append(np.clip(ref + plane, 0, mask))
            recon = new_recon
            if refinement == "progressive":
                from .progressive_encoder import (
                    SCRIPT_1,
                    SCRIPT_3,
                    encode_progressive,
                )

                qids = [0] + [len(qtabs) - 1] * (n_comps - 1)
                if n_comps == 3:
                    script = SCRIPT_3
                elif n_comps == 1:
                    script = SCRIPT_1
                else:
                    # Spectral-selection-only script for 2/4 components.
                    script = [(tuple(range(n_comps)), 0, 0, 0, 0)] + [
                        ((i,), 1, 63, 0, 0) for i in range(n_comps)
                    ]
                frame_bytes = encode_progressive(
                    [],
                    qtabs,
                    [(1, 1)] * n_comps,
                    quant_ids=qids,
                    table_ids=[min(i, 1) for i in range(n_comps)],
                    script=script,
                    arithmetic=arithmetic,
                    coefficients=coeff_planes,
                    size=(th, tw),
                    restart_interval=restart_interval,
                    differential=True,
                )
                writer.write_bytes(strip(frame_bytes))
            else:
                enc, _ = make_dct_encoder(differential=True)
                enc.set_coefficient_planes(coeff_planes, tw, th)
                writer.write_bytes(strip(enc.encode()))
        else:
            recon = [p & mask for p in target]
            if arithmetic:
                from .arithmetic_lossless import encode_lossless_arithmetic

                frame_bytes = encode_lossless_arithmetic(
                    [d.astype(np.int16) for d in diffs],
                    precision=precision,
                    differential=True,
                    restart_interval=restart_interval,
                )
            else:
                frame_bytes = encode_lossless(
                    [d.astype(np.int16) for d in diffs],
                    precision=precision,
                    differential=True,
                    restart_interval=restart_interval,
                )
            writer.write_bytes(strip(frame_bytes))

    writer.write_marker(Marker.EOI)
    return writer.to_bytes()

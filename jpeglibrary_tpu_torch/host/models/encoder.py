"""Baseline (SOF0) JPEG encoder.

The port's copy of ``jpeglibrary_tpu/models/encoder.py``, without the
JAX device branch of ``encode`` (``xp=jnp``): here ``encode`` runs on
numpy and raises for it. The port's device encode is
``jpeglibrary_tpu_torch.models.encoder.encode``. The mesh statistics run
over the port's mesh (``parallel.sharding.mesh_symbol_frequencies``).

API parity with the reference JpegEncoder
(yigolden/JpegLibrary/src/JpegLibrary/JpegEncoder.cs:15-997:
 SetQuantizationTable / SetHuffmanTable / AddComponent / SetInputReader /
 SetOutput / Encode / MostOptimalCoding), re-architected for the TPU
pipeline:

- The sample->coefficient transform (zero-pad, box subsample, level
  shift, AAN FDCT, zig-zag quantize) runs as one batched device stage
  (ops.encode_stage), replacing the per-block loop of
  TransformBlocks/WriteScanData (JpegEncoder.cs:414-489,:662-741).
- Symbol statistics for optimize-coding are vectorized histograms
  (mesh-reducible via psum) instead of the serial
  GatherBlockStatistics walk (:551-601).
- Table construction (Annex K standard or package-merge when
  MostOptimalCoding) happens on host (models.huffman_builder).
- Bit emission packs the entropy stream on host (io.writer), in the
  same interleaved MCU order with identical DC-diff/run-length symbols
  (EncodeBlock/EncodeRunLength, :828-936).

Like the reference, no restart markers are emitted by default;
setting ``restart_interval`` (an extension) adds DRI + RSTn seams so
downstream decodes parallelize. Further extensions beyond the
reference: ``arithmetic`` (SOF9 via the native QM coder),
``set_coefficient_planes`` (lossless transcode input), ``mesh``
(device-reduced 2-pass statistics).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..io.writer import JpegWriter
from ..ops import encode_stage
from ..syntax import huffman_standard
from ..syntax.frame import FrameComponent, FrameHeader, ScanComponent, ScanHeader
from ..syntax.huffman import HuffmanEncodingTable
from ..syntax.markers import Marker
from ..syntax.quantization import (
    QuantizationTable,
    scale_by_quality,
    standard_chrominance_table,
    standard_luminance_table,
)
from .geometry import ceil_div
from .huffman_builder import HuffmanTableBuilder


@dataclasses.dataclass
class _EncodeComponent:
    """AddComponent record (JpegEncoder.AddComponent, JpegEncoder.cs:175-253)."""

    identifier: int
    quantization_table_id: int
    dc_table_id: int
    ac_table_id: int
    h: int
    v: int


class JpegEncodeError(ValueError):
    pass


class JpegEncoder:
    def __init__(self):
        self.most_optimal_coding = False
        #: MCUs per restart interval; 0 emits no DRI/RSTn like the
        #: reference encoder (JpegEncoder.cs never writes DRI). Setting
        #: it makes the output restart-segment-parallel decodable — the
        #: parallel seam this framework's scanners exploit.
        self.restart_interval = 0
        #: optional mesh (jpeglibrary_tpu_torch.parallel.sharding.make_mesh):
        #: 2-pass symbol statistics then run on the mesh's devices, the
        #: blocks split over its ``data`` axis and the histograms
        #: all-reduced (parallel.sharding.mesh_symbol_frequencies).
        self.mesh = None
        #: arithmetic entropy coding (SOF9) instead of Huffman — a
        #: capability beyond the reference encoder (JpegEncoder.cs is
        #: Huffman-only). The adaptive QM coder needs no table pass;
        #: Huffman table registrations are ignored and the dc/ac table
        #: ids select statistics bins + DAC conditioning.
        self.arithmetic = False
        #: DAC conditioning when arithmetic: (dc_l, dc_u) and ac_kx
        self.dc_conditioning = (0, 1)
        self.ac_conditioning = 5
        #: hierarchical differential DCT frame (T.81 Annex J): the SOF
        #: marker becomes SOF5 (Huffman) / SOF13 (arithmetic) and the
        #: input MUST be pre-quantized coefficient planes of the
        #: DIFFERENTIAL samples (FDCT with no level shift) — set by
        #: models.hierarchical when emitting DCT refinement frames.
        self.differential = False
        self._quant_tables: List[QuantizationTable] = []
        #: (is_dc, identifier) -> HuffmanEncodingTable or None (None = build)
        self._huffman_tables: Dict[tuple, Optional[HuffmanEncodingTable]] = {}
        self._components: List[_EncodeComponent] = []
        self._input_planes: Optional[List[np.ndarray]] = None
        #: pull-based stripe reader (set_input_reader) — streaming encode
        self._input_reader = None
        #: pull-based RGB reader (set_input_rgb_reader) — fused streaming
        self._input_rgb_reader = None
        #: push-based stripe iterator (set_input_stream) — unknown-height
        #: streaming encode with a trailing DNL segment
        self._input_stream = None
        #: pre-quantized zig-zag coefficient planes (one [Hb, Wb, 64]
        #: int16 per component) — the lossless-transcode entry: encode()
        #: skips the sample transform entirely (models/transcode.py)
        self._coefficient_planes: Optional[List[np.ndarray]] = None
        #: SOF sample precision; >8 selects SOF1 (extended sequential)
        self.sample_precision = 8
        #: (marker, payload) APPn/COM segments emitted right after SOI
        #: (add_marker_segment) — metadata carry and the Adobe APP14
        #: transform tag for CMYK/YCCK output, which the reference
        #: encoder cannot write
        self._marker_segments: List[tuple] = []
        #: RGB [H, W, 3] input for the fused native transform
        #: (set_input_rgb) — converted lazily if the fused path
        #: cannot apply
        self._input_rgb: Optional[np.ndarray] = None
        #: (ink [H, W, 4] uint8, ycck) for the fused 4-component
        #: CMYK/YCCK transform (set_input_ink)
        self._input_ink = None
        self._width = 0
        self._height = 0

    # -- configuration --

    def set_quantization_table(self, table: QuantizationTable) -> None:
        self._quant_tables = [
            t for t in self._quant_tables if t.identifier != table.identifier
        ]
        self._quant_tables.append(table)

    def set_huffman_table(
        self, is_dc: bool, identifier: int, table: Optional[HuffmanEncodingTable] = None
    ) -> None:
        """With table=None, registers a table *builder* — any builder
        present switches Encode() into 2-pass optimize-coding mode
        (JpegEncoder.cs:137-173,:257)."""
        self._huffman_tables[(is_dc, identifier)] = table

    def add_marker_segment(self, marker: int, payload: bytes) -> None:
        """Queue an APPn/COM segment for emission right after SOI, in
        call order. Use for JFIF/EXIF/ICC metadata or the Adobe APP14
        color-transform tag (``b"Adobe" + bytes([0,100,0,0,0,0,t])``)
        that tells decoders a 4-component stream is CMYK (t=0) or YCCK
        (t=2). Note the Adobe convention: CMYK samples are stored
        INVERTED (255 - ink); feed inverted planes so PIL/libjpeg and
        ``DecodeResult.to_cmyk8`` (which un-inverts) read them back."""
        m = int(marker)
        if not (0xE0 <= m <= 0xEF or m == 0xFE):  # APPn / COM only
            raise JpegEncodeError(
                f"add_marker_segment accepts APPn/COM markers, got {m:#x}."
            )
        if len(payload) > 0xFFFD:
            raise JpegEncodeError("Marker segment payload exceeds 65533 bytes.")
        self._marker_segments.append((m, bytes(payload)))

    def add_component(
        self, identifier: int, quantization_table_id: int,
        dc_table_id: int, ac_table_id: int, h: int, v: int,
    ) -> None:
        self._components.append(
            _EncodeComponent(identifier, quantization_table_id, dc_table_id, ac_table_id, h, v)
        )

    def set_coefficient_planes(self, planes, width: int, height: int) -> None:
        """Provide pre-quantized zig-zag coefficient planes (int16
        [Hb, Wb, 64] per component in frame order) — encode() re-emits
        them losslessly with the configured entropy coding."""
        self._coefficient_planes = [np.asarray(p, dtype=np.int16) for p in planes]
        self._input_rgb = None
        self._input_ink = None
        self._width = width
        self._height = height

    def set_input_reader(self, reader, width: int, height: int) -> None:
        """Pull-based input — the TPU-native analogue of the
        reference's JpegBlockInputReader
        (yigolden/JpegLibrary/src/JpegLibrary/JpegBlockInputReader.cs:27):
        ``reader(y0, y1)`` returns the sample rows [y0, y1) as a
        [y1-y0, W, C] uint8 array or a list of [y1-y0, W] planes.

        encode() then streams: it pulls MCU-row-aligned stripes,
        transforms and entropy-emits each with carried DC-predictor and
        bit-register state, and discards it — never materializing the
        full image (the reference's bufferless WriteScanData,
        JpegEncoder.cs:662-741). Output is bit-identical to the
        buffered ``set_input`` path. With optimize-coding the stripes
        are pulled twice (statistics pass, then emission) — still O(
        stripe) memory, unlike the reference, whose optimize path
        buffers the whole coefficient image (JpegEncoder.cs:414)."""
        self._input_reader = reader
        self._input_rgb_reader = None
        self._input_rgb = None
        self._input_ink = None
        self._input_stream = None
        self._width = width
        self._height = height

    def set_input_rgb_reader(self, reader, width: int, height: int) -> None:
        """Pull-based RGB input: ``reader(y0, y1)`` returns RGB rows
        [y0, y1) as [y1-y0, W, 3] uint8. When the fused-RGB conditions
        hold (standard 3-component layout, 8-bit, fixed tables, no
        restart interval, native available), encode() pulls
        MCU-row-aligned bands and runs convert + subsample + FDCT +
        quantize + Huffman emission as ONE native call per band with
        the DC predictors and the bit-register remainder carried
        across bands (jpx_encode_rgb_band) — O(band) host memory,
        byte-identical to the buffered fused encode. Anything else
        falls back to the staged streaming pipeline automatically
        (same bytes, slower)."""
        self._input_rgb_reader = reader
        self._input_reader = None
        self._input_rgb = None
        self._input_ink = None
        self._input_stream = None
        self._input_planes = None
        self._width = width
        self._height = height

    def set_input_stream(self, stripes, width: int) -> None:
        """Push-based input for UNKNOWN-height streaming encode:
        ``stripes`` is an iterable yielding row stripes top to bottom
        (each a [rows, W, C] array or a list of [rows, W] planes).
        Every stripe except the last must cover whole MCU rows
        (a multiple of 8*max_v sample rows).

        encode() emits the SOF with a zero line count and appends the
        true count after the scan in a DNL segment (T.81 B.2.5), so the
        producer never needs to know the height up front — live capture
        / scanline sources encode as the rows arrive. Beyond the
        reference (its encoder requires height at AddComponent time and
        never writes DNL). Requires fixed Huffman tables: two-pass
        table optimization needs the whole image."""
        self._input_stream = iter(stripes)
        self._input_rgb_reader = None
        self._input_rgb = None
        self._input_ink = None
        self._input_reader = None
        self._input_planes = None
        self._width = width
        self._height = 0

    def set_input_rgb(self, rgb: np.ndarray) -> None:
        """Input RGB [H, W, 3] uint8 — encode() runs the whole
        transform stage (fixed-point RGB->YCbCr, pad, chroma box
        subsample, FDCT, quantize, MCU ordering) as ONE fused threaded
        native stripe pass that reads the image exactly once
        (jpx_encode_transform_rgb), instead of staging full Y/Cb/Cr
        planes through memory. Byte-identical to converting with
        ops.color.rgb_to_ycbcr and calling set_input. Requires the
        standard 3-component layout (luma h,v = max; chroma 1x1) and
        8-bit precision; anything else falls back to the staged path
        automatically."""
        rgb = np.asarray(rgb, dtype=np.uint8)
        if rgb.ndim != 3 or rgb.shape[-1] != 3:
            raise JpegEncodeError("set_input_rgb expects [H, W, 3] uint8.")
        self._input_rgb = rgb
        self._input_rgb_reader = None
        self._input_ink = None
        self._input_planes = None
        self._input_reader = None
        self._input_stream = None
        self._height, self._width = rgb.shape[:2]

    def set_input_ink(self, ink: np.ndarray, ycck: bool = False) -> None:
        """Input CMYK ink [H, W, 4] uint8 — encode() runs the whole
        4-component transform (invert, or the YCCK fixed-point convert,
        plus pad/subsample/FDCT/quantize/MCU ordering) as one fused
        threaded native stripe pass (jpx_encode_transform_cmyk).
        Byte-identical to the staged conversion + set_input path; falls
        back automatically when the component layout does not match
        encode_cmyk's (comp 0/3 at max sampling, 1/2 chroma 1x1)."""
        ink = np.asarray(ink, dtype=np.uint8)
        if ink.ndim != 3 or ink.shape[-1] != 4:
            raise JpegEncodeError("set_input_ink expects [H, W, 4] uint8.")
        self._input_ink = (ink, bool(ycck))
        self._input_rgb_reader = None
        self._input_rgb = None
        self._input_planes = None
        self._input_reader = None
        self._input_stream = None
        self._height, self._width = ink.shape[:2]

    def set_input(self, planes, width: Optional[int] = None, height: Optional[int] = None) -> None:
        """Input samples: [H, W, C] uint8 array or a list of [H, W] planes."""
        self._input_reader = None
        self._input_rgb_reader = None
        self._input_stream = None
        self._input_rgb = None
        self._input_ink = None
        if isinstance(planes, np.ndarray) and planes.ndim == 3:
            self._input_planes = [planes[..., i] for i in range(planes.shape[-1])]
            self._height, self._width = planes.shape[:2]
        else:
            self._input_planes = list(planes)
            self._height, self._width = self._input_planes[0].shape
        if width is not None:
            self._width = width
        if height is not None:
            self._height = height

    def _fused_rgb_applies(self, xp) -> bool:
        """True when the set_input_rgb fast path can run: host numpy,
        8-bit, non-differential, the standard 3-component layout
        (luma carries the max sampling factors, chroma 1x1 — the
        encode_rgb/_configure_rgb_encoder shape), native available."""
        if xp is not np or self.sample_precision != 8 or self.differential:
            return False
        if len(self._components) != 3:
            return False
        c0, c1, c2 = self._components
        max_h = max(c.h for c in self._components)
        max_v = max(c.v for c in self._components)
        if (c0.h, c0.v) != (max_h, max_v):
            return False
        if (c1.h, c1.v) != (1, 1) or (c2.h, c2.v) != (1, 1):
            return False
        try:
            from ..native import build

            build.load_library()
        except Exception:
            return False
        return True

    def _fused_ink_applies(self, xp) -> bool:
        """True when the set_input_ink fast path can run: host numpy,
        8-bit, non-differential, the encode_cmyk 4-component layout
        (components 0 and 3 at the max sampling factors, 1 and 2 at
        1x1), native available."""
        if xp is not np or self.sample_precision != 8 or self.differential:
            return False
        if len(self._components) != 4:
            return False
        c0, c1, c2, c3 = self._components
        max_h = max(c.h for c in self._components)
        max_v = max(c.v for c in self._components)
        if (c0.h, c0.v) != (max_h, max_v) or (c3.h, c3.v) != (max_h, max_v):
            return False
        if (c1.h, c1.v) != (1, 1) or (c2.h, c2.v) != (1, 1):
            return False
        try:
            from ..native import build

            build.load_library()
        except Exception:
            return False
        return True

    # -- encode --

    def encode(self, xp=np) -> bytes:
        # The JAX device branch (xp=jnp) is the port's device encode:
        # xp=torch (the card) or a torch.device runs
        # jpeglibrary_tpu_torch.models.encoder.encode on a copy of this
        # encoder; anything but numpy or those raises TypeError.
        if xp is not np:
            from ...models.encoder import encode as device_encode

            return device_encode(self, xp=xp)
        if self.mesh is not None:
            from ...parallel.sharding import check_mesh

            try:
                check_mesh(self.mesh)
            except ValueError as exc:
                raise JpegEncodeError(str(exc)) from None
        if self._input_stream is not None:
            return self._encode_streaming_dnl()
        if self._input_rgb_reader is not None:
            fixed_tables = not any(
                t is None for t in self._huffman_tables.values()
            )
            if (
                fixed_tables
                and self.restart_interval == 0
                and not self.arithmetic
                and self._fused_rgb_applies(xp)
            ):
                return self._encode_streaming_rgb_fused()
            # Staged fallback: wrap into a YCbCr plane reader — the
            # exact pipeline set_input_reader always ran (same bytes).
            rgb_reader = self._input_rgb_reader

            def ycbcr_reader(y0, y1):
                from ..ops import color as color_ops

                rgb = np.ascontiguousarray(rgb_reader(y0, y1), dtype=np.uint8)
                try:
                    from ..native import scanner as native_scanner

                    return list(native_scanner.rgb_to_ycbcr(rgb))
                except ImportError:
                    return list(
                        color_ops.rgb_to_ycbcr(
                            rgb[..., 0], rgb[..., 1], rgb[..., 2], xp=np
                        )
                    )

            self._input_reader = ycbcr_reader
            self._input_rgb_reader = None
            return self._encode_streaming()
        if self._input_reader is not None:
            return self._encode_streaming()
        if (
            self._input_planes is None
            and self._coefficient_planes is None
            and self._input_rgb is None
            and self._input_ink is None
        ):
            raise JpegEncodeError("Input is not specified.")
        if not self._components:
            raise JpegEncodeError("No component is specified.")
        use_fused_ink = False
        if self._input_ink is not None and self._input_planes is None:
            use_fused_ink = self._fused_ink_applies(xp)
            if not use_fused_ink:
                # Staged fallback: convert exactly like encode_cmyk's
                # plane path and continue below.
                ink, ycck = self._input_ink
                if ycck:
                    from ..ops import color as color_ops

                    y, cb, cr = color_ops.rgb_to_ycbcr(
                        ink[..., 0].astype(np.int32),
                        ink[..., 1].astype(np.int32),
                        ink[..., 2].astype(np.int32),
                    )
                    self._input_planes = [
                        y.astype(np.uint8), cb.astype(np.uint8),
                        cr.astype(np.uint8), 255 - ink[..., 3],
                    ]
                else:
                    self._input_planes = [255 - ink[..., i] for i in range(4)]
        use_fused_rgb = False
        if self._input_rgb is not None and self._input_planes is None:
            use_fused_rgb = self._fused_rgb_applies(xp)
            if not use_fused_rgb:
                # Staged fallback: convert once and ride the plane path.
                from ..ops import color as color_ops

                rgb = self._input_rgb
                try:
                    from ..native import scanner as native_scanner

                    planes = native_scanner.rgb_to_ycbcr(rgb)
                except ImportError:
                    planes = color_ops.rgb_to_ycbcr(
                        rgb[..., 0], rgb[..., 1], rgb[..., 2], xp=np
                    )
                self._input_planes = list(planes)
        n_inputs = (
            len(self._components)
            if (use_fused_rgb or use_fused_ink)
            else len(
                self._input_planes
                if self._input_planes is not None
                else self._coefficient_planes
            )
        )
        if n_inputs != len(self._components):
            raise JpegEncodeError("Component count does not match input planes.")

        if self.sample_precision not in (8, 12) and self._coefficient_planes is None:
            raise JpegEncodeError(
                "Direct sample encode supports 8- and 12-bit precision "
                "(T.81 extended sequential); other precisions ride the "
                "coefficient (transcode) input path."
            )
        if self.differential and self._coefficient_planes is None:
            raise JpegEncodeError(
                "Differential frames take pre-quantized coefficient planes "
                "of the sample differences (set_coefficient_planes) — the "
                "sample path would apply a level shift differential frames "
                "must not have."
            )

        optimize = (not self.arithmetic) and any(
            t is None for t in self._huffman_tables.values()
        )

        quant_by_id = {t.identifier: t for t in self._quant_tables}
        max_h = max(c.h for c in self._components)
        max_v = max(c.v for c in self._components)
        mcus_per_line = ceil_div(self._width, 8 * max_h)
        mcus_per_column = ceil_div(self._height, 8 * max_v)

        # --- transform stage: all components -> MCU-ordered blocks
        quants = []
        for comp in self._components:
            qt = quant_by_id.get(comp.quantization_table_id)
            if qt is None or qt.is_empty:
                raise JpegEncodeError(
                    f"Quantization table {comp.quantization_table_id} is not defined."
                )
            quants.append(qt.elements)

        if (
            (use_fused_rgb or use_fused_ink)
            and not self.arithmetic
            and not optimize
            and self.mesh is None
        ):
            # Fully fused fixed-table path: transform + scan emission in
            # one native pass; the image bytes are read exactly once.
            fixed = {
                k: t for k, t in self._huffman_tables.items() if t is not None
            }
            comp_tables = []
            for comp in self._components:
                dc = fixed.get((True, comp.dc_table_id))
                ac = fixed.get((False, comp.ac_table_id))
                if dc is None or ac is None:
                    raise JpegEncodeError("Huffman table is not defined.")
                comp_tables.append((dc, ac))
            from ..native import scanner as native_scanner

            writer = JpegWriter()
            self._write_headers(writer, fixed)
            if use_fused_ink:
                ink, ycck = self._input_ink
                scan = native_scanner.encode_cmyk_scan(
                    ink, max_h, max_v, ycck, quants, comp_tables,
                    self.restart_interval,
                )
            else:
                scan = native_scanner.encode_rgb_scan(
                    self._input_rgb, max_h, max_v, quants, comp_tables,
                    self.restart_interval,
                )
            writer.write_bytes(scan)
            writer.write_marker(Marker.EOI)
            return writer.to_bytes()  # single copy: the scan rides a chunk

        comp_blocks: List[np.ndarray] = []
        fused_hists = None
        if use_fused_ink:
            from ..native import scanner as native_scanner

            ink, ycck = self._input_ink
            comp_blocks = list(
                native_scanner.encode_transform_cmyk(
                    ink, max_h, max_v, ycck, quants
                )
            )
        elif use_fused_rgb:
            from ..native import scanner as native_scanner

            if optimize and self.mesh is None:
                # Optimize-coding: the transform pass also accumulates
                # the per-component DC/AC symbol histograms, so the
                # statistics gather below needs no second pass over
                # the coefficient arrays.
                blocks, fused_hists = native_scanner.encode_transform_rgb(
                    self._input_rgb, max_h, max_v, quants,
                    with_histograms=True,
                )
                comp_blocks = list(blocks)
            else:
                comp_blocks = list(
                    native_scanner.encode_transform_rgb(
                        self._input_rgb, max_h, max_v, quants
                    )
                )
        elif self._coefficient_planes is not None:
            # Transcode path: coefficients are already quantized.
            for comp, coeffs in zip(self._components, self._coefficient_planes):
                comp_blocks.append(
                    encode_stage.mcu_order_blocks(np.asarray(coeffs), comp.h, comp.v)
                )
        else:
            # Components are independent; the native transform releases
            # the GIL, so they run concurrently on the shared pool.
            from ..utils.pool import shared_pool

            level_shift = float(1 << (self.sample_precision - 1))

            def one(args):
                comp, plane, q = args
                plane = np.asarray(plane)
                if self.sample_precision != 8 and plane.dtype == np.uint8:
                    raise JpegEncodeError(
                        "12-bit encode requires >8-bit sample planes "
                        "(uint16/int32)."
                    )
                coeffs = encode_stage.forward_component(
                    plane,
                    q,
                    comp.h, comp.v,
                    max_h // comp.h, max_v // comp.v,
                    mcus_per_line, mcus_per_column,
                    xp=np,
                    level_shift=level_shift,
                )
                return encode_stage.mcu_order_blocks(
                    np.asarray(coeffs), comp.h, comp.v
                )

            jobs = list(zip(self._components, self._input_planes, quants))
            if len(jobs) > 1:
                comp_blocks = list(shared_pool().map(one, jobs))
            else:
                comp_blocks = [one(jobs[0])]

        # --- table build (2-pass optimize-coding) or fixed tables
        tables: Dict[tuple, HuffmanEncodingTable] = {}
        if self.arithmetic:
            pass  # adaptive QM coder: no tables
        elif optimize:
            if self.mesh is not None:
                from ...parallel.sharding import mesh_symbol_frequencies

                gather = lambda blocks: mesh_symbol_frequencies(blocks, self.mesh)
            else:
                gather = encode_stage.dc_ac_symbol_frequencies
            builders: Dict[tuple, HuffmanTableBuilder] = {}
            for ci, (comp, blocks) in enumerate(
                zip(self._components, comp_blocks)
            ):
                if fused_hists is not None:
                    dc_freq, ac_freq = fused_hists[ci]
                else:
                    dc_freq, ac_freq = gather(blocks)
                if self.restart_interval > 0:
                    dc_freq = np.array(dc_freq, dtype=np.int64)
                    encode_stage.apply_restart_dc_fixup(
                        dc_freq, blocks, comp.h * comp.v, self.restart_interval
                    )
                dkey, akey = (True, comp.dc_table_id), (False, comp.ac_table_id)
                if self._huffman_tables.get(dkey, "absent") is None:
                    builders.setdefault(dkey, HuffmanTableBuilder()).add_frequencies(dc_freq)
                if self._huffman_tables.get(akey, "absent") is None:
                    builders.setdefault(akey, HuffmanTableBuilder()).add_frequencies(ac_freq)
            for key, builder in builders.items():
                tables[key] = builder.build(optimal=self.most_optimal_coding)
        for key, table in self._huffman_tables.items():
            if table is not None:
                tables[key] = table

        # --- container emission
        writer = JpegWriter()
        self._write_headers(writer, tables)

        if self.arithmetic:
            self._emit_scan_arith(writer, comp_blocks)
        else:
            self._emit_scan(writer, comp_blocks, tables)

        writer.write_marker(Marker.EOI)
        return writer.to_bytes()

    def _encode_streaming_rgb_fused(self) -> bytes:
        """Bufferless fused encode over the RGB pull reader: each
        MCU-row-aligned band runs convert + pad + subsample + FDCT +
        quantize + Huffman emission in ONE threaded native call
        (jpx_encode_rgb_band) with the DC predictors and the
        bit-register remainder carried across bands. O(band) host
        memory, byte-identical to the whole-image fused encode — the
        reference benchmarks bufferless as a first-class peer
        (tests/JpegLibrary.Benchmarks/EncoderBenchmark.cs:60-180)."""
        import os

        from ..native import scanner as native_scanner

        quant_by_id = {t.identifier: t for t in self._quant_tables}
        max_h = max(c.h for c in self._components)
        max_v = max(c.v for c in self._components)
        quants = []
        tables = []
        for comp in self._components:
            qt = quant_by_id.get(comp.quantization_table_id)
            if qt is None or qt.is_empty:
                raise JpegEncodeError(
                    f"Quantization table {comp.quantization_table_id} is not defined."
                )
            quants.append(qt.elements)
            dc = self._huffman_tables.get((True, comp.dc_table_id))
            ac = self._huffman_tables.get((False, comp.ac_table_id))
            if dc is None or ac is None:
                raise JpegEncodeError("Huffman table is not defined.")
            tables.append((dc, ac))

        writer = JpegWriter()
        self._write_headers(
            writer, {k: t for k, t in self._huffman_tables.items() if t}
        )

        band_enc = native_scanner.RgbBandEncoder(max_h, max_v, quants, tables)
        rows_per_mcu = 8 * max_v
        # 16 MCU rows (256 samples at 4:2:0) measures at 0.89x the
        # buffered fused encode on the 16.8 MP reference workload
        # (173.8 vs 195.7 MP/s; 32 rows reaches 0.985x) while keeping
        # the working set a few MB: smaller bands pay thread
        # fan-in/join per band, larger ones trade memory.
        band_mcu_rows = max(
            1, int(os.environ.get("JPX_ENCODE_STRIPE_MCU_ROWS", "16"))
        )
        band_rows = band_mcu_rows * rows_per_mcu
        for y0 in range(0, self._height, band_rows):
            y1 = min(self._height, y0 + band_rows)
            band = np.ascontiguousarray(
                self._input_rgb_reader(y0, y1), dtype=np.uint8
            )
            if band.ndim != 3 or band.shape != (y1 - y0, self._width, 3):
                raise JpegEncodeError("RGB reader returned a wrong-shape band.")
            writer.write_bytes(
                band_enc.encode_band(band, is_last=y1 == self._height)
            )
        writer.write_marker(Marker.EOI)
        return writer.to_bytes()

    def _encode_streaming(self) -> bytes:
        """Bufferless encode over the pull reader: stripe-at-a-time
        transform + carry-state entropy emission. Peak memory is
        O(stripe), not O(image); output is bit-identical to the
        buffered path (the transform is per-block and stripes align to
        MCU rows; Huffman emission is deterministic per (block,
        predictor) and the carry emitter chains exactly)."""
        import os

        if self.arithmetic:
            raise JpegEncodeError(
                "Streaming encode supports Huffman entropy coding only."
            )
        if not self._components:
            raise JpegEncodeError("No component is specified.")
        try:
            from ..native import scanner as native_scanner
        except ImportError:
            # Correctness fallback: pull everything and run buffered.
            planes = self._input_reader(0, self._height)
            self._input_reader = None
            try:
                self.set_input(planes, self._width, self._height)
                return self.encode()
            finally:
                self._input_planes = None

        optimize = any(t is None for t in self._huffman_tables.values())
        quant_by_id = {t.identifier: t for t in self._quant_tables}
        max_h = max(c.h for c in self._components)
        max_v = max(c.v for c in self._components)
        mcus_per_line = ceil_div(self._width, 8 * max_h)
        mcus_per_column = ceil_div(self._height, 8 * max_v)
        quants = []
        for comp in self._components:
            qt = quant_by_id.get(comp.quantization_table_id)
            if qt is None or qt.is_empty:
                raise JpegEncodeError(
                    f"Quantization table {comp.quantization_table_id} is not defined."
                )
            quants.append(qt.elements)

        rows_per_mcu = 8 * max_v
        stripe_mcu_rows = max(
            1, int(os.environ.get("JPX_ENCODE_STRIPE_MCU_ROWS", "8"))
        )

        def stripes():
            for m0 in range(0, mcus_per_column, stripe_mcu_rows):
                m1 = min(mcus_per_column, m0 + stripe_mcu_rows)
                y1 = min(self._height, m1 * rows_per_mcu)
                planes = self._input_reader(m0 * rows_per_mcu, y1)
                if isinstance(planes, np.ndarray) and planes.ndim == 3:
                    planes = [planes[..., i] for i in range(planes.shape[-1])]
                if len(planes) != len(self._components):
                    raise JpegEncodeError(
                        "Component count does not match reader planes."
                    )
                blocks = []
                for comp, plane, q in zip(self._components, planes, quants):
                    coeffs = encode_stage.forward_component(
                        np.asarray(plane), q,
                        comp.h, comp.v, max_h // comp.h, max_v // comp.v,
                        mcus_per_line, m1 - m0, xp=np,
                        level_shift=float(1 << (self.sample_precision - 1)),
                    )
                    blocks.append(
                        encode_stage.mcu_order_blocks(coeffs, comp.h, comp.v)
                    )
                yield m0 * mcus_per_line, blocks

        # --- pass 1 (optimize-coding only): stripe-wise histograms.
        # DC carry fixup: dc_ac_symbol_frequencies counts the stripe's
        # first diff against predictor 0; the whole-scan semantics
        # (GatherBlockStatistics, JpegEncoder.cs:551-601) diff against
        # the previous stripe's last DC.
        tables: Dict[tuple, HuffmanEncodingTable] = {}
        if optimize:
            builders: Dict[tuple, HuffmanTableBuilder] = {}
            sums = [
                (np.zeros(256, np.int64), np.zeros(256, np.int64))
                for _ in self._components
            ]
            last_dc = [None] * len(self._components)
            for first_mcu, blocks in stripes():
                for i, b in enumerate(blocks):
                    dc_freq, ac_freq = encode_stage.dc_ac_symbol_frequencies(b)
                    dc_freq = np.array(dc_freq, dtype=np.int64)
                    if self.restart_interval > 0:
                        encode_stage.apply_restart_dc_fixup(
                            dc_freq, b, self._components[i].h * self._components[i].v,
                            self.restart_interval,
                            first_mcu=first_mcu, prev_dc=last_dc[i],
                        )
                    elif last_dc[i] is not None:
                        first = int(b[0, 0])
                        dc_freq[abs(first).bit_length()] -= 1
                        dc_freq[abs(first - last_dc[i]).bit_length()] += 1
                    last_dc[i] = int(b[-1, 0])
                    sums[i][0][:] += dc_freq
                    sums[i][1][:] += ac_freq
            for comp, (dc_freq, ac_freq) in zip(self._components, sums):
                dkey, akey = (True, comp.dc_table_id), (False, comp.ac_table_id)
                if self._huffman_tables.get(dkey, "absent") is None:
                    builders.setdefault(dkey, HuffmanTableBuilder()).add_frequencies(dc_freq)
                if self._huffman_tables.get(akey, "absent") is None:
                    builders.setdefault(akey, HuffmanTableBuilder()).add_frequencies(ac_freq)
            for key, builder in builders.items():
                tables[key] = builder.build(optimal=self.most_optimal_coding)
        for key, table in self._huffman_tables.items():
            if table is not None:
                tables[key] = table

        writer = JpegWriter()
        self._write_headers(writer, tables)

        # --- pass 2: stripe-wise emission with carried state.
        comp_meta = []
        for comp in self._components:
            dc = tables.get((True, comp.dc_table_id))
            ac = tables.get((False, comp.ac_table_id))
            if dc is None or ac is None:
                raise JpegEncodeError("Huffman table is not defined.")
            comp_meta.append(
                {
                    "per_mcu": comp.h * comp.v,
                    "dc_codes": dc.codes, "dc_sizes": dc.sizes,
                    "ac_codes": ac.codes, "ac_sizes": ac.sizes,
                }
            )

        carry = native_scanner.EncodeCarry(len(self._components))
        ri = self.restart_interval
        total_mcus = mcus_per_line * mcus_per_column
        emitted = 0
        seg_fill = 0
        rst = 0
        for _, blocks in stripes():
            stripe_mcus = blocks[0].shape[0] // comp_meta[0]["per_mcu"]
            emitted += stripe_mcus
            seg_fill, rst = self._emit_stream_stripe(
                writer, native_scanner, carry, comp_meta, blocks,
                ri, seg_fill, rst, last=emitted == total_mcus,
            )

        writer.write_marker(Marker.EOI)
        return writer.to_bytes()

    def _encode_streaming_dnl(self) -> bytes:
        """Unknown-height streaming encode (set_input_stream): consume
        row stripes as they arrive, emit the SOF with zero lines, and
        define the true line count in a trailing DNL segment
        (T.81 B.2.5). Entropy emission carries DC-predictor and
        bit-register state across stripes exactly like the known-height
        streaming path, so the scan bytes are bit-identical to a
        buffered encode of the same pixels."""
        if self.arithmetic:
            raise JpegEncodeError(
                "Streaming encode supports Huffman entropy coding only."
            )
        if not self._components:
            raise JpegEncodeError("No component is specified.")
        if any(t is None for t in self._huffman_tables.values()):
            raise JpegEncodeError(
                "Unknown-height streaming encode requires fixed Huffman "
                "tables (two-pass table optimization needs the whole image)."
            )
        try:
            from ..native import scanner as native_scanner
        except ImportError as e:
            raise JpegEncodeError(
                "Unknown-height streaming encode requires the native "
                "emission kernel."
            ) from e

        tables = {k: t for k, t in self._huffman_tables.items() if t is not None}
        quant_by_id = {t.identifier: t for t in self._quant_tables}
        max_h = max(c.h for c in self._components)
        max_v = max(c.v for c in self._components)
        mcus_per_line = ceil_div(self._width, 8 * max_h)
        rows_per_mcu = 8 * max_v
        quants = []
        for comp in self._components:
            qt = quant_by_id.get(comp.quantization_table_id)
            if qt is None or qt.is_empty:
                raise JpegEncodeError(
                    f"Quantization table {comp.quantization_table_id} is not defined."
                )
            quants.append(qt.elements)

        comp_meta = []
        for comp in self._components:
            dc = tables.get((True, comp.dc_table_id))
            ac = tables.get((False, comp.ac_table_id))
            if dc is None or ac is None:
                raise JpegEncodeError("Huffman table is not defined.")
            comp_meta.append(
                {
                    "per_mcu": comp.h * comp.v,
                    "dc_codes": dc.codes, "dc_sizes": dc.sizes,
                    "ac_codes": ac.codes, "ac_sizes": ac.sizes,
                }
            )

        writer = JpegWriter()
        self._height = 0  # SOF number-of-lines: deferred to DNL
        self._write_headers(writer, tables)

        def transform(planes):
            if isinstance(planes, np.ndarray) and planes.ndim == 3:
                planes = [planes[..., i] for i in range(planes.shape[-1])]
            if len(planes) != len(self._components):
                raise JpegEncodeError(
                    "Component count does not match stream planes."
                )
            rows = int(np.asarray(planes[0]).shape[0])
            m_rows = ceil_div(rows, rows_per_mcu)
            blocks = []
            for comp, plane, q in zip(self._components, planes, quants):
                coeffs = encode_stage.forward_component(
                    np.asarray(plane), q,
                    comp.h, comp.v, max_h // comp.h, max_v // comp.v,
                    mcus_per_line, m_rows, xp=np,
                    level_shift=float(1 << (self.sample_precision - 1)),
                )
                blocks.append(encode_stage.mcu_order_blocks(coeffs, comp.h, comp.v))
            return rows, m_rows, blocks

        carry = native_scanner.EncodeCarry(len(self._components))
        ri = self.restart_interval
        lines = 0
        seg_fill = 0
        rst = 0
        pending = None  # one-stripe lookahead: the last stripe finalizes
        stream = self._input_stream
        self._input_stream = None
        for planes in stream:
            nxt = transform(planes)
            if pending is not None:
                rows, m_rows, _ = pending
                if rows != m_rows * rows_per_mcu:
                    raise JpegEncodeError(
                        "Only the final stripe may cover partial MCU rows."
                    )
                seg_fill, rst = self._emit_stream_stripe(
                    writer, native_scanner, carry, comp_meta, pending[2],
                    ri, seg_fill, rst, last=False,
                )
                lines += rows
            pending = nxt
        if pending is None:
            raise JpegEncodeError("Input stream yielded no stripes.")
        self._emit_stream_stripe(
            writer, native_scanner, carry, comp_meta, pending[2],
            ri, seg_fill, rst, last=True,
        )
        lines += pending[0]
        if lines > 0xFFFF:
            raise JpegEncodeError("Accumulated line count exceeds 65535.")

        # DNL directly after the scan's entropy data (T.81 B.2.5: end
        # of the first scan), then EOI.
        writer.write_segment(Marker.DNL, bytes([(lines >> 8) & 0xFF, lines & 0xFF]))
        writer.write_marker(Marker.EOI)
        self._height = lines
        return writer.to_bytes()

    def _emit_stream_stripe(
        self, writer, native_scanner, carry, comp_meta, blocks,
        ri, seg_fill, rst, *, last,
    ):
        """Emit one transformed stripe through the carry emitter,
        splitting at restart-interval boundaries. Returns the updated
        (seg_fill, rst) cycle state."""
        stripe_mcus = blocks[0].shape[0] // comp_meta[0]["per_mcu"]
        pos = 0
        while pos < stripe_mcus:
            n = stripe_mcus - pos
            if ri > 0:
                n = min(n, ri - seg_fill)
            seg_comps = [
                {**m, "blocks": b[pos * m["per_mcu"]:(pos + n) * m["per_mcu"]]}
                for m, b in zip(comp_meta, blocks)
            ]
            seg_end = ri > 0 and seg_fill + n == ri
            is_last = last and pos + n == stripe_mcus
            writer.write_bytes(
                native_scanner.encode_segment_carry(
                    seg_comps, n, carry, finalize=seg_end or is_last
                )
            )
            pos += n
            seg_fill += n
            if seg_end:
                if not is_last:
                    writer.write_marker(Marker.RST0 + rst)
                    rst = (rst + 1) & 7
                carry.reset()
                seg_fill = 0
        return seg_fill, rst

    def _write_headers(self, writer: JpegWriter, tables) -> None:
        """SOI through SOS — shared by the buffered and streaming
        encode paths (WriteStartOfImage..WriteStartOfScan,
        JpegEncoder.cs:296-412)."""
        writer.write_marker(Marker.SOI)

        for marker, payload in self._marker_segments:
            writer.write_segment(Marker(marker), payload)

        dqt_payload = b"".join(t.serialize() for t in self._quant_tables)
        writer.write_segment(Marker.DQT, dqt_payload)

        if self.differential:
            # Differential frames keep one marker per entropy coder
            # regardless of precision (T.81 Table B.1).
            sof_marker = Marker.SOF13 if self.arithmetic else Marker.SOF5
        elif self.arithmetic:
            sof_marker = Marker.SOF9
        else:
            sof_marker = Marker.SOF1 if self.sample_precision > 8 else Marker.SOF0
        frame = FrameHeader(
            marker=sof_marker,
            sample_precision=self.sample_precision,
            number_of_lines=self._height,
            samples_per_line=self._width,
            components=tuple(
                FrameComponent(c.identifier, c.h, c.v, c.quantization_table_id)
                for c in self._components
            ),
        )
        writer.write_segment(sof_marker, frame.serialize())

        if self.arithmetic:
            # DAC conditioning for every statistics bin id in use
            # (T.81 B.2.4.3).
            dc_l, dc_u = self.dc_conditioning
            dac = bytearray()
            for tid in sorted({c.dc_table_id for c in self._components}):
                dac += bytes([tid, (dc_u << 4) | dc_l])
            for tid in sorted({c.ac_table_id for c in self._components}):
                dac += bytes([0x10 | tid, self.ac_conditioning])
            writer.write_segment(Marker.DAC, bytes(dac))
        else:
            dht_payload = b"".join(
                tables[key].serialize(0 if key[0] else 1, key[1])
                for key in sorted(tables, key=lambda k: (not k[0], k[1]))
            )
            writer.write_segment(Marker.DHT, dht_payload)

        if self.restart_interval > 0:
            ri = self.restart_interval
            writer.write_segment(Marker.DRI, bytes([(ri >> 8) & 0xFF, ri & 0xFF]))

        scan = ScanHeader(
            components=tuple(
                ScanComponent(c.identifier, c.dc_table_id, c.ac_table_id)
                for c in self._components
            ),
            start_of_spectral_selection=0,
            end_of_spectral_selection=63,
            successive_approximation_bit_position_high=0,
            successive_approximation_bit_position_low=0,
        )
        writer.write_segment(Marker.SOS, scan.serialize())

    def _emit_scan_arith(self, writer: JpegWriter, comp_blocks) -> None:
        """Arithmetic (SOF9) scan emission via the native QM coder;
        restart segments restart statistics + registers, so they emit
        independently (and could in parallel)."""
        from ..native import scanner as native_scanner

        dc_l, dc_u = self.dc_conditioning
        comps = [
            {
                "blocks": blocks,
                "per_mcu": comp.h * comp.v,
                "dc_id": comp.dc_table_id,
                "ac_id": comp.ac_table_id,
                "dc_l": dc_l,
                "dc_u": dc_u,
                "ac_kx": self.ac_conditioning,
            }
            for comp, blocks in zip(self._components, comp_blocks)
        ]
        n_mcus = comp_blocks[0].shape[0] // comps[0]["per_mcu"]
        # One native call for the whole scan: restart segments encode
        # on separate threads (fresh QM state each — the restart
        # contract) with inline RSTn separators.
        writer.write_bytes(
            native_scanner.encode_arith_scan(comps, n_mcus, self.restart_interval)
        )

    def _emit_scan(self, writer: JpegWriter, comp_blocks, tables) -> None:
        """Interleaved MCU emission (WritePreparedScanData,
        JpegEncoder.cs:605-660). comp_blocks are per-component [N, 64]
        arrays already in MCU walk order. Uses the native segment
        emitter when available; the Python path is the semantic
        reference."""
        comps = []
        for comp, blocks in zip(self._components, comp_blocks):
            dc = tables.get((True, comp.dc_table_id))
            ac = tables.get((False, comp.ac_table_id))
            if dc is None or ac is None:
                raise JpegEncodeError("Huffman table is not defined.")
            comps.append(
                {
                    "blocks": blocks,
                    "per_mcu": comp.h * comp.v,
                    "dc_codes": dc.codes, "dc_sizes": dc.sizes,
                    "ac_codes": ac.codes, "ac_sizes": ac.sizes,
                    "predictor": 0,
                    "cursor": 0,
                }
            )

        n_mcus = comp_blocks[0].shape[0] // comps[0]["per_mcu"]
        native_emit = None
        try:
            from ..native import scanner as native_scanner

            native_emit = native_scanner.encode_segment
        except ImportError:
            pass

        def emit_segment(first_mcu: int, count: int, *, parallel: bool = False) -> None:
            if native_emit is not None:
                seg_comps = [
                    {**c, "blocks": c["blocks"][first_mcu * c["per_mcu"]:]}
                    for c in comps
                ]
                writer.write_bytes(native_emit(seg_comps, count, parallel=parallel))
                return
            writer.enter_bit_mode()
            write_bits = writer.write_bits
            for c in comps:
                c["predictor"] = 0
                c["cursor"] = first_mcu * c["per_mcu"]
            for _ in range(count):
                for c in comps:
                    blocks = c["blocks"]
                    for _ in range(c["per_mcu"]):
                        block = blocks[c["cursor"]]
                        c["cursor"] += 1
                        _encode_block(write_bits, c, block)
            writer.exit_bit_mode()

        ri = self.restart_interval
        if ri <= 0:
            # Single segment (reference parity): chunk-parallel native
            # emission (bit-identical shift-merge).
            emit_segment(0, n_mcus, parallel=True)
            return
        if native_emit is not None and n_mcus > ri:
            # Restart segments are independent byte-aligned streams —
            # ONE native call emits them all (fresh predictors per
            # segment, RSTn embedded, threaded over segment ranges).
            writer.write_bytes(
                native_emit(comps, n_mcus, restart_interval=ri)
            )
            return
        mcu = 0
        rst = 0
        while mcu < n_mcus:
            n = min(ri, n_mcus - mcu)
            emit_segment(mcu, n)
            mcu += n
            if mcu < n_mcus:
                writer.write_marker(Marker.RST0 + rst)
                rst = (rst + 1) & 7


def _encode_block(write_bits, c, block) -> None:
    """EncodeBlock (JpegEncoder.cs:828-890): DC diff + AC run-length."""
    dc_codes, dc_sizes = c["dc_codes"], c["dc_sizes"]
    ac_codes, ac_sizes = c["ac_codes"], c["ac_sizes"]

    value = int(block[0])
    t = value - c["predictor"]
    c["predictor"] = value
    _encode_run_length(write_bits, dc_codes, dc_sizes, 0, t)

    run = 0
    for i in range(1, 64):
        t = int(block[i])
        if t == 0:
            run += 1
        else:
            while run > 15:
                if int(ac_sizes[0xF0]) == 0:
                    raise JpegEncodeError(
                        "Huffman table has no code for symbol 0xf0."
                    )
                write_bits(int(ac_codes[0xF0]), int(ac_sizes[0xF0]))
                run -= 16
            _encode_run_length(write_bits, ac_codes, ac_sizes, run, t)
            run = 0
    if run > 0:
        if int(ac_sizes[0]) == 0:
            raise JpegEncodeError("Huffman table has no code for symbol 0x0.")
        write_bits(int(ac_codes[0]), int(ac_sizes[0]))


def _encode_run_length(write_bits, codes, sizes, run: int, value: int) -> None:
    """EncodeRunLength (JpegEncoder.cs:893-936)."""
    a = value
    b = value
    if a < 0:
        a = -value
        b = value - 1
    bit_count = a.bit_length()
    symbol = (run << 4) | bit_count
    size = int(sizes[symbol])
    if size == 0:
        raise JpegEncodeError(f"Huffman table has no code for symbol {symbol:#x}.")
    write_bits(int(codes[symbol]), size)
    if bit_count > 0:
        write_bits(b & ((1 << bit_count) - 1), bit_count)


# ---------------------------------------------------------------------------
# High-level convenience mirroring the JpegEncode app
# (apps/JpegEncode/EncodeAction.cs:17-72)
# ---------------------------------------------------------------------------

def _configure_rgb_encoder(
    quality: int,
    subsampling: str,
    *,
    optimize_coding: bool = False,
    most_optimal_coding: bool = False,
    restart_interval: int = 0,
    arithmetic: bool = False,
) -> "JpegEncoder":
    """Shared setup for the encode_rgb* family: quality-scaled Annex-K
    quant tables, standard-or-built Huffman tables, 4:2:0/4:4:4
    component wiring (one source of truth — the three entry points
    previously drifted)."""
    encoder = JpegEncoder()
    encoder.most_optimal_coding = most_optimal_coding
    encoder.restart_interval = restart_interval
    encoder.arithmetic = arithmetic
    encoder.set_quantization_table(scale_by_quality(standard_luminance_table(0), quality))
    encoder.set_quantization_table(scale_by_quality(standard_chrominance_table(1), quality))
    if optimize_coding or most_optimal_coding:
        for is_dc in (True, False):
            encoder.set_huffman_table(is_dc, 0)
            encoder.set_huffman_table(is_dc, 1)
    else:
        encoder.set_huffman_table(True, 0, huffman_standard.dc_luminance())
        encoder.set_huffman_table(False, 0, huffman_standard.ac_luminance())
        encoder.set_huffman_table(True, 1, huffman_standard.dc_chrominance())
        encoder.set_huffman_table(False, 1, huffman_standard.ac_chrominance())
    # Luma sampling factors per JFIF convention; chroma is always 1x1.
    # The reference app exposes only 4:2:0 (EncodeAction.cs:54-56); the
    # extra ratios are the standard libjpeg set and ride the same
    # arbitrary-(h,v) component machinery.
    luma_hv = {
        "420": (2, 2),
        "444": (1, 1),
        "422": (2, 1),
        "440": (1, 2),
        "411": (4, 1),
    }.get(subsampling)
    if luma_hv is None:
        raise ValueError(f"unsupported subsampling {subsampling!r}")
    encoder.add_component(1, 0, 0, 0, *luma_hv)
    encoder.add_component(2, 1, 1, 1, 1, 1)
    encoder.add_component(3, 1, 1, 1, 1, 1)
    return encoder


def encode_rgb(
    rgb: np.ndarray,
    quality: int = 75,
    *,
    subsampling: str = "420",
    optimize_coding: bool = False,
    most_optimal_coding: bool = False,
    restart_interval: int = 0,
    arithmetic: bool = False,
    xp=np,
) -> bytes:
    """RGB [H, W, 3] uint8 -> baseline JPEG bytes.

    Fixed-point RGB->YCbCr (ops.color, bit-exact vs the reference app
    converter), quality-scaled Annex-K quantization tables, 4:2:0 or
    4:4:4 subsampling.
    """
    encoder = _configure_rgb_encoder(
        quality, subsampling,
        optimize_coding=optimize_coding,
        most_optimal_coding=most_optimal_coding,
        restart_interval=restart_interval,
        arithmetic=arithmetic,
    )
    # set_input_rgb runs convert+pad+subsample+FDCT+quantize+MCU-order
    # as one fused native stripe pass (encode() falls back to the
    # staged rgb_to_ycbcr + set_input pipeline when it cannot apply).
    encoder.set_input_rgb(np.asarray(rgb, dtype=np.uint8))
    return encoder.encode(xp=xp)


def encode_cmyk(
    ink: np.ndarray,
    quality: int = 75,
    *,
    ycck: bool = False,
    subsampling: str = "420",
    optimize_coding: bool = False,
    restart_interval: int = 0,
    xp=np,
) -> bytes:
    """CMYK ink [H, W, 4] uint8 -> Adobe-tagged 4-component JPEG.

    ``ycck=False``: plain CMYK — channels stored inverted per the Adobe
    convention (APP14 transform 0), all 1x1 (ink channels do not
    decorrelate, so chroma-style subsampling does not apply).
    ``ycck=True``: YCCK (APP14 transform 2) — the CMY triple runs
    through the fixed-point RGB->YCbCr transform so Cb/Cr can be
    subsampled (``subsampling``: 420/444/422/440/411 as in encode_rgb);
    K rides at full (luma) resolution. Component/table layout follows
    libjpeg jcparam.c: quant+Huffman 0 for Y and K, 1 for Cb/Cr.
    Inverse of ``DecodeResult.to_cmyk8`` (decoder.py:382), which PIL
    matches channel-for-channel."""
    ink = np.asarray(ink, dtype=np.uint8)
    if ink.ndim != 3 or ink.shape[-1] != 4:
        raise JpegEncodeError("encode_cmyk expects [H, W, 4] ink values.")
    encoder = JpegEncoder()
    encoder.most_optimal_coding = False
    encoder.restart_interval = restart_interval
    transform = 2 if ycck else 0
    encoder.add_marker_segment(
        0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, transform])
    )
    encoder.set_quantization_table(
        scale_by_quality(standard_luminance_table(0), quality)
    )
    if optimize_coding:
        encoder.set_huffman_table(True, 0)
        encoder.set_huffman_table(False, 0)
    else:
        encoder.set_huffman_table(True, 0, huffman_standard.dc_luminance())
        encoder.set_huffman_table(False, 0, huffman_standard.ac_luminance())
    if not ycck:
        for i in range(4):
            encoder.add_component(i + 1, 0, 0, 0, 1, 1)
        encoder.set_input_ink(ink, ycck=False)
        return encoder.encode(xp=xp)

    from ..ops import color as color_ops  # noqa: F401 (fallback path)

    encoder.set_quantization_table(
        scale_by_quality(standard_chrominance_table(1), quality)
    )
    if optimize_coding:
        encoder.set_huffman_table(True, 1)
        encoder.set_huffman_table(False, 1)
    else:
        encoder.set_huffman_table(True, 1, huffman_standard.dc_chrominance())
        encoder.set_huffman_table(False, 1, huffman_standard.ac_chrominance())
    luma_hv = {
        "420": (2, 2), "444": (1, 1), "422": (2, 1),
        "440": (1, 2), "411": (4, 1),
    }.get(subsampling)
    if luma_hv is None:
        raise ValueError(f"unsupported subsampling {subsampling!r}")
    encoder.add_component(1, 0, 0, 0, *luma_hv)
    encoder.add_component(2, 1, 1, 1, 1, 1)
    encoder.add_component(3, 1, 1, 1, 1, 1)
    encoder.add_component(4, 0, 0, 0, *luma_hv)  # K at luma resolution
    # to_cmyk8 decodes YCCK as ink = ycbcr_to_rgb(stored Y/Cb/Cr) for
    # CMY and 255 - stored for K — so encode stores YCbCr(C, M, Y)
    # directly and K inverted. The fused native transform does the
    # whole stage in one stripe pass; encode() converts on fallback.
    encoder.set_input_ink(ink, ycck=True)
    return encoder.encode(xp=xp)


def encode_rgb_stream(
    reader,
    width: int,
    height: int,
    quality: int = 75,
    *,
    subsampling: str = "420",
    optimize_coding: bool = False,
    most_optimal_coding: bool = False,
    restart_interval: int = 0,
) -> bytes:
    """Bufferless RGB encode: ``reader(y0, y1)`` returns rows [y0, y1)
    as [y1-y0, W, 3] uint8. Color conversion, transform, and entropy
    emission all run stripe-at-a-time (set_input_reader), so peak host
    memory is O(stripe) — the reference's bufferless encode benchmark
    contract (tests/JpegLibrary.Benchmarks/EncoderBenchmark.cs).
    Bit-identical to ``encode_rgb`` on the same pixels."""
    encoder = _configure_rgb_encoder(
        quality, subsampling,
        optimize_coding=optimize_coding,
        most_optimal_coding=most_optimal_coding,
        restart_interval=restart_interval,
    )
    # encode() routes to the fused band path (one native call per
    # MCU-row band, carry-threaded) when eligible, and otherwise wraps
    # this into the staged YCbCr stripe pipeline itself.
    encoder.set_input_rgb_reader(reader, width, height)
    return encoder.encode()


def encode_rgb_stripes(
    stripes,
    width: int,
    quality: int = 75,
    *,
    subsampling: str = "420",
    restart_interval: int = 0,
) -> bytes:
    """Unknown-height RGB streaming encode: ``stripes`` yields
    [rows, W, 3] uint8 row bands top to bottom (whole MCU rows except
    the last). The height is defined after the scan by a DNL segment
    (T.81 B.2.5), so live row sources encode without knowing their
    length. Fixed Annex-K tables (single pass). Beyond the reference:
    its encoder requires the height up front and never writes DNL."""
    from ..ops import color as color_ops

    def ycbcr_stripes():
        for rgb in stripes:
            rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
            try:
                from ..native import scanner as native_scanner

                yield list(native_scanner.rgb_to_ycbcr(rgb))
            except ImportError:
                yield list(
                    color_ops.rgb_to_ycbcr(
                        rgb[..., 0], rgb[..., 1], rgb[..., 2], xp=np
                    )
                )

    encoder = _configure_rgb_encoder(
        quality, subsampling, restart_interval=restart_interval
    )
    encoder.set_input_stream(ycbcr_stripes(), width)
    return encoder.encode()


def encode_gray(plane: np.ndarray, quality: int = 75, *, optimize_coding: bool = False,
                most_optimal_coding: bool = False, precision: int = 8,
                restart_interval: int = 0, arithmetic: bool = False,
                xp=np) -> bytes:
    """Grayscale [H, W] -> JPEG bytes. ``precision=8`` (uint8, SOF0) or
    ``precision=12`` (uint16/int32 samples in [0, 4095], SOF1 extended
    sequential with optimal tables — beyond the 8-bit-only reference
    encoder, JpegEncoder.cs:108). ``arithmetic`` switches the entropy
    coder to adaptive QM (SOF9), same as encode_rgb."""
    encoder = JpegEncoder()
    encoder.most_optimal_coding = most_optimal_coding
    encoder.restart_interval = restart_interval
    encoder.arithmetic = arithmetic
    encoder.set_quantization_table(scale_by_quality(standard_luminance_table(0), quality))
    if precision != 8:
        encoder.sample_precision = precision
        # Annex-K standard tables cover 8-bit symbol ranges only; the
        # 12-bit symbol alphabet (DC category <= 15) needs built tables.
        optimize_coding = True
    if arithmetic:
        pass  # adaptive QM coder: no Huffman tables
    elif optimize_coding or most_optimal_coding:
        encoder.set_huffman_table(True, 0)
        encoder.set_huffman_table(False, 0)
    else:
        encoder.set_huffman_table(True, 0, huffman_standard.dc_luminance())
        encoder.set_huffman_table(False, 0, huffman_standard.ac_luminance())
    encoder.add_component(1, 0, 0, 0, 1, 1)
    encoder.set_input([plane])
    return encoder.encode(xp=xp)

"""Top-level JPEG decoder.

The port's copy of ``jpeglibrary_tpu/models/decoder.py``, with its JAX
device branches moved to the port's device modules:
``DecodeResult.to_rgb8_device`` calls
``jpeglibrary_tpu_torch.models.decoder.to_rgb8_device`` (on the card unless
given a ``device``), and the ``xp`` of the decode takes ``torch`` or a
``torch.device`` where the JAX package takes ``jnp``.

API parity with the reference JpegDecoder
(yigolden/JpegLibrary/src/JpegLibrary/JpegDecoder.cs:19-978:
 SetInput/Identify/Decode/LoadTables/TryEstimateQuanlity/Reset*),
re-architected for the TPU pipeline:

- The host walks the container once (io.reader), maintaining the table
  registries in stream order and snapshotting per-scan state into a
  plan.
- Entropy decode runs per scan into dense coefficient planes (native
  C++ scanner when available, Python reference scanner otherwise).
- The transform stage (dequant + IDCT + level shift + upsample) runs
  once at the end as batched device ops — for *every* mode, which
  generalizes the reference's progressive IDCT-on-Dispose contract
  (JpegHuffmanProgressiveScanDecoder.cs:421-470) into an explicit
  finalize step.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, Optional

import numpy as np

from ..io import reader as io_reader
from ..ops import decode_stage
from ..syntax import quantization as quant_mod
from ..syntax.frame import FrameHeader, ScanHeader
from ..syntax.huffman import HuffmanDecodingTable, parse_dht_segment
from ..syntax.markers import Marker, SUPPORTED_SOF_MARKERS, ALL_SOF_MARKERS
from ..syntax.quantization import QuantizationTable, parse_dqt_segment
from . import huffman_baseline
from .geometry import FrameGeometry, allocate_coefficient_planes, frame_geometry


class JpegUnsupportedError(ValueError):
    pass


# Serving workloads repeat identical DHT/DQT payloads (one encoder
# configuration across a stream of images); cache the parsed —
# immutable — table objects by payload bytes. This also stabilizes
# object identity so the native wrapper's packed-blob cache hits
# (native/scanner.pack_huffman_table).
@functools.lru_cache(maxsize=256)
def _parse_dht_cached(payload: bytes):
    return tuple(parse_dht_segment(payload))


@functools.lru_cache(maxsize=256)
def _parse_dqt_cached(payload: bytes):
    return tuple(parse_dqt_segment(payload))


class DecodeResult:
    """Decoded output: coefficient planes plus lazily computed sample
    planes.

    ``planes`` are int32 [H, W], *unclamped* level-shifted samples, i.e.
    exactly what the reference pushes into a JpegBlockOutputWriter.
    Output formatting (8-bit clamp, 16-bit extension, RGB) happens on
    top — either via the host xp backend (golden-parity path) or the
    jitted fused device pipeline (throughput path).

    ``xp`` (the decode's) says where ``planes`` are computed: numpy on
    the host, or a torch device (``torch`` for the card,
    ``torch.device(...)`` for any) through the port's K4, bit-equal to
    numpy and downloaded once. Lossless results never read it.
    """

    def __init__(
        self,
        frame: FrameHeader,
        geometry: FrameGeometry,
        coefficients: Optional[Dict[int, np.ndarray]] = None,
        quant: Optional[Dict[int, np.ndarray]] = None,
        samples: Optional[Dict[int, np.ndarray]] = None,
        packed_mcu: Optional[np.ndarray] = None,
        packed_mcu2: Optional[np.ndarray] = None,
        xp=np,
        adobe_transform: Optional[int] = None,
        errors=(),
    ):
        self.frame = frame
        self.geometry = geometry
        self._coefficients = coefficients
        self.quant = quant
        #: lossless mode: sub-resolution raw sample planes (no IDCT)
        self.samples = samples
        #: merged-scan sparse payload (MCU decode order, flat int16) —
        #: the zero-copy serving path; dense planes materialize lazily
        #: on first host access via the ``coefficients`` property.
        self.packed_mcu = packed_mcu
        #: v2 split-stream payload (flat uint8, ~0.4-0.6x the v1
        #: bytes — native.scanner.decode_image_sparse2 layout); when
        #: set it is the preferred device wire.
        self.packed_mcu2 = packed_mcu2
        #: APP14 "Adobe" transform byte (0 none, 1 YCbCr, 2 YCCK), or
        #: None when the stream carries no Adobe tag.
        self.adobe_transform = adobe_transform
        #: tolerant-decode recovery notes (empty on clean decodes; the
        #: default strict mode raises instead of recording)
        self.errors = list(errors)
        self._xp = xp
        self._planes: Optional[Dict[int, np.ndarray]] = None

    @property
    def color_transform(self) -> str:
        """The stream's component color interpretation, by the libjpeg
        heuristics (jdapimin.c default_decompress_parms): 3 components
        are YCbCr unless an Adobe tag says transform 0 or the component
        IDs literally spell 'R','G','B'; 4 components are CMYK, or YCCK
        when the Adobe tag says transform 2. 1/2 components pass
        through ("gray" / "unknown")."""
        n = len(self.frame.components)
        ids = tuple(fc.identifier for fc in self.frame.components)
        if n == 3:
            if self.adobe_transform is not None:
                return "ycbcr" if self.adobe_transform != 0 else "rgb"
            if ids == (0x52, 0x47, 0x42):  # 'R','G','B'
                return "rgb"
            return "ycbcr"
        if n == 4:
            return "ycck" if self.adobe_transform == 2 else "cmyk"
        if n == 1:
            return "gray"
        return "unknown"

    @property
    def coefficients(self) -> Optional[Dict[int, np.ndarray]]:
        """Dense zig-zag coefficient planes (lazily reconstructed from
        the sparse payload when the merged scan path produced one)."""
        if self._coefficients is None and self.packed_mcu is not None:
            self._coefficients = self._densify_packed()
        if self._coefficients is None and self.packed_mcu2 is not None:
            self._coefficients = self._densify_packed2()
        return self._coefficients

    def _densify_packed2(self) -> Dict[int, np.ndarray]:
        """Host reconstruction from the v2 split-stream payload (see
        native.scanner.decode_image_sparse2 for the layout)."""
        geo = self.geometry
        bpm = sum(c.h * c.v for c in geo.components)
        nb = geo.mcus_per_line * geo.mcus_per_column * bpm
        payload = self.packed_mcu2
        k = payload.shape[0]
        bn = (k - 3 * nb) * 8 // 17
        dc = payload[: 2 * nb].view(np.int16)
        cnt = payload[2 * nb : 3 * nb].astype(np.int64)
        acpos = payload[3 * nb : 3 * nb + bn].astype(np.int64)
        acval = payload[3 * nb + bn : 3 * nb + 2 * bn].view(np.int8)
        be = bn // 64
        exc = payload[3 * nb + 2 * bn :].view(np.int32).reshape(be, 2)
        block_id = np.repeat(np.arange(nb, dtype=np.int64), cnt)
        n_ac = block_id.shape[0]
        dense = np.zeros(nb * 64, dtype=np.int32)
        np.add.at(dense, block_id * 64 + acpos[:n_ac], acval[:n_ac])
        np.add.at(dense, exc[:, 0].astype(np.int64), exc[:, 1])
        dense[::64] += dc
        dense = dense.astype(np.int16)
        cpm = 64 * bpm
        per_mcu = dense.reshape(geo.mcus_per_column * geo.mcus_per_line, cpm)
        out: Dict[int, np.ndarray] = {}
        off = 0
        for c in geo.components:
            size = c.h * c.v * 64
            blk = (
                per_mcu[:, off : off + size]
                .reshape(geo.mcus_per_column, geo.mcus_per_line, c.v, c.h, 64)
                .transpose(0, 2, 1, 3, 4)
                .reshape(c.blocks_per_column, c.blocks_per_line, 64)
            )
            out[c.component_index] = np.ascontiguousarray(blk)
            off += size
        return out

    def _densify_packed(self) -> Dict[int, np.ndarray]:
        """Reconstruct dense coefficient planes from the MCU-order
        sparse payload on host (only non-serving paths need this; the
        device transform consumes the payload directly)."""
        geo = self.geometry
        packed = self.packed_mcu.reshape(-1, 2)
        deltas = packed[:, 0].astype(np.int64) & 0xFFFF
        vals = packed[:, 1]
        # (0, 0) entries are bucket padding: real entries always carry a
        # nonzero value (only nonzero coefficients are emitted) or are
        # escapes with delta 0xFFFF.
        keep = vals != 0
        pos = np.cumsum(deltas) - 1
        cpm = 64 * sum(c.h * c.v for c in geo.components)
        total = geo.mcus_per_line * geo.mcus_per_column * cpm
        dense = np.zeros(total, dtype=np.int16)
        dense[pos[keep]] = vals[keep]
        per_mcu = dense.reshape(geo.mcus_per_column * geo.mcus_per_line, cpm)
        out: Dict[int, np.ndarray] = {}
        off = 0
        for c in geo.components:
            size = c.h * c.v * 64
            blk = (
                per_mcu[:, off : off + size]
                .reshape(geo.mcus_per_column, geo.mcus_per_line, c.v, c.h, 64)
                .transpose(0, 2, 1, 3, 4)
                .reshape(c.blocks_per_column, c.blocks_per_line, 64)
            )
            out[c.component_index] = np.ascontiguousarray(blk)
            off += size
        return out

    @property
    def width(self) -> int:
        return self.geometry.width

    @property
    def height(self) -> int:
        return self.geometry.height

    @property
    def precision(self) -> int:
        return self.geometry.precision

    @property
    def planes(self) -> Dict[int, np.ndarray]:
        if self._planes is None:
            if self.samples is not None:
                # Lossless: duplication-upsample the raw sample planes
                # (JpegPartialScanlineAllocator.WriteBlock semantics,
                # JpegPartialScanlineAllocator.cs:185-222) and crop.
                from .lossless import component_sizes

                sizes = component_sizes(self.frame)
                out = {}
                for cg in self.geometry.components:
                    hc, wc = sizes[cg.component_index]
                    plane = self.samples[cg.component_index][:hc, :wc].astype(np.int32)
                    plane = decode_stage.upsample_duplicate(plane, cg.hs, cg.vs)
                    out[cg.component_index] = plane[: self.height, : self.width]
                self._planes = out
            else:
                planes = decode_stage.decode_components_to_planes(
                    self.coefficients, self.quant, self.geometry, xp=self._xp
                )
                self._planes = decode_stage.planes_to_host(planes)
        return self._planes

    def prepack(self) -> None:
        """Precompute the sparse device payload on the calling thread.

        Lets a pipeline run the pack stage inside its scan workers (it
        parallelizes across images) so the single device thread only
        dispatches; the port's ``to_rgb8_device`` reuses the cached payload. A no-op
        when the merged scan path already produced the payload."""
        if (
            self.samples is not None
            or self.packed_mcu is not None
            or self.packed_mcu2 is not None
            or getattr(self, "_packed", None) is not None
        ):
            return
        try:
            from ..native import scanner as native_scanner
        except ImportError:
            return
        from ..utils import metrics

        planes = [
            self.coefficients[c.component_index] for c in self.geometry.components
        ]
        with metrics.stage("transform.pack_sparse"):
            self._packed = native_scanner.pack_sparse(planes).reshape(-1)

    def _subres_u8(self) -> Dict[int, np.ndarray]:
        """Writer-normalized uint8 planes at COMPONENT resolution
        (pre-upsample) — what filters that must see clamped sample
        values (fancy upsampling) operate on, exactly as libjpeg
        upsamples range-limited JSAMPLEs."""
        from .geometry import ceil_div

        out: Dict[int, np.ndarray] = {}
        if self.samples is not None:
            from .lossless import component_sizes

            sizes = component_sizes(self.frame)
            for cg in self.geometry.components:
                hc, wc = sizes[cg.component_index]
                p = self.samples[cg.component_index][:hc, :wc].astype(np.int32)
                out[cg.component_index] = decode_stage.normalize_to_uint8(
                    p, self.precision
                )
        else:
            for cg in self.geometry.components:
                idx = cg.component_index
                hc = ceil_div(self.height, cg.vs)
                wc = ceil_div(self.width, cg.hs)
                plane = decode_stage.component_plane(
                    self.coefficients[idx],
                    self.quant[idx].astype(np.int32),
                    self.geometry.level_shift,
                    1, 1, hc, wc,
                )
                out[idx] = decode_stage.normalize_to_uint8(plane, self.precision)
        return out

    def to_rgb8_device(self, *, device=None, sparse: bool = True,
                       upsample: str = "duplicate", scale: float = 1.0):
        """Planar ``[3, H', W']`` uint8 RGB tensor on ``device`` (the card
        when None): ``jpeglibrary_tpu_torch.models.decoder.to_rgb8_device``
        of this result, the port of the JAX method of the same name."""
        from ...models.decoder import to_rgb8_device
        from ...ops import _device

        return to_rgb8_device(self, device=_device.resolve(device), sparse=sparse,
                              upsample=upsample, scale=scale)

    def to_rgb8_scaled(self, scale, *, upsample: str = "duplicate") -> np.ndarray:
        """Scaled decode to [ceil(H*s), ceil(W*s), 3] uint8 RGB for
        ``scale`` s in {1/2, 1/4, 1/8} (libjpeg-class DCT scaling).

        The n = 8*s lowest frequencies per axis inverse-transform
        straight to an n x n block (ops/decode_stage.scaled_idct_matrix
        — spectral truncation, block means exact), skipping 8x8 IDCT
        and full-resolution plane materialization entirely; at 1/8 the
        transform is just the DC plane. DCT modes only (lossless has no
        frequency domain — slice its sample planes instead).
        """
        n = int(round(8 * scale))
        if n not in (1, 2, 4) or abs(8 * scale - n) > 1e-9:
            raise ValueError("scale must be 1/2, 1/4 or 1/8 (use to_rgb8() for full)")
        if self.coefficients is None:
            raise ValueError("scaled decode needs DCT coefficients (not a lossless stream)")
        transform = self.color_transform
        if transform not in ("ycbcr", "gray", "rgb"):
            raise ValueError(f"scaled decode supports YCbCr/gray/RGB streams, not {transform}")
        out_h = -(-self.height * n // 8)
        out_w = -(-self.width * n // 8)
        u8 = []
        for cg in self.geometry.components:
            idx = cg.component_index
            plane = decode_stage.component_plane_scaled(
                self.coefficients[idx],
                self.quant[idx].astype(np.int32),
                self.geometry.level_shift,
                cg.hs, cg.vs, out_h, out_w, n,
            )
            u8.append(decode_stage.normalize_to_uint8(plane, self.precision))
        from ..ops import color as color_ops

        if len(u8) == 1:
            half = np.full_like(u8[0], 128)
            r, g, b = color_ops.ycbcr_to_rgb(u8[0], half, half)
        elif len(u8) == 3 and transform == "rgb":
            r, g, b = u8
        elif len(u8) == 3:
            r, g, b = color_ops.ycbcr_to_rgb(u8[0], u8[1], u8[2])
        else:
            raise ValueError("scaled decode needs 1 or 3 components")
        return np.stack([r, g, b], axis=-1)

    def to_rgb8(self, *, upsample: str = "duplicate") -> np.ndarray:
        """[H, W, 3] uint8 RGB on host: clamp writer + fixed-point
        YCbCr->RGB (grayscale fills Cb=Cr=128, DecodeAction.cs:58-66).

        ``upsample``: ``"duplicate"`` (default) keeps the reference's
        nearest-neighbor chroma semantics; ``"fancy"`` applies
        libjpeg's default triangular filter
        (ops/decode_stage.upsample_fancy, bit-exact to jdsample.c) for
        smoother 4:2:0/4:2:2 output that matches libjpeg viewers.

        Pure host computation with the bit-exact reference semantics —
        the device-resident serving output is
        ``jpeglibrary_tpu_torch.to_rgb8_device(result, device=...)``
        (planar, stays in device memory)."""
        from ..ops import color as color_ops

        if upsample not in ("duplicate", "fancy"):
            raise ValueError(f"unknown upsample mode {upsample!r}")
        transform_ = self.color_transform
        if (
            upsample == "duplicate"
            and self.precision == 8
            and self.samples is None
            and transform_ in ("gray", "ycbcr", "rgb")
        ):
            # Fused native host transform (the decode twin of the fused
            # encode): dequant + IDCT + upsample + color in one threaded
            # pass, bit-exact to the numpy path below (parity-tested,
            # tests/test_native_rgb_transform.py).
            try:
                from ..native import scanner as native_scanner

                coeffs = self.coefficients
                if coeffs is not None and self.quant is not None and all(
                    cg.component_index in self.quant
                    for cg in self.geometry.components
                ):
                    return native_scanner.decode_transform_rgb(
                        coeffs, self.quant, self.geometry, mode=transform_
                    )
            except ImportError:
                pass
        if upsample == "fancy":
            sub = self._subres_u8()
            u8 = []
            for cg in self.geometry.components:
                p = decode_stage.upsample_fancy(
                    sub[cg.component_index], cg.hs, cg.vs
                )
                u8.append(
                    p[: self.height, : self.width].astype(np.uint8)
                )
        else:
            u8 = [
                decode_stage.normalize_to_uint8(self.planes[i], self.precision)
                for i in sorted(self.planes)
            ]
        transform = self.color_transform
        if len(u8) == 1:
            half = np.full_like(u8[0], 128)
            r, g, b = color_ops.ycbcr_to_rgb(u8[0], half, half)
        elif len(u8) == 3 and transform == "rgb":
            # RGB-coded stream (Adobe transform 0 or 'R','G','B' ids):
            # components ARE the channels.
            r, g, b = u8
        elif len(u8) == 3:
            r, g, b = color_ops.ycbcr_to_rgb(u8[0], u8[1], u8[2])
        elif len(u8) == 4:
            # CMYK / YCCK via to_cmyk8 (which honors the upsample
            # mode), then naive CMYK -> RGB (x * (255 - k) / 255), the
            # conversion PIL and most viewers apply to ink values.
            c, m, y, k = np.moveaxis(
                self.to_cmyk8(upsample=upsample).astype(np.uint32), -1, 0
            )
            s = 255 - k
            r = ((255 - c) * s + 127) // 255
            g = ((255 - m) * s + 127) // 255
            b = ((255 - y) * s + 127) // 255
            return np.stack([r, g, b], axis=-1).astype(np.uint8)
        else:
            raise ValueError(
                f"RGB output needs 1, 3 or 4 components, got {len(u8)}."
            )
        return np.stack([r, g, b], axis=-1)

    def to_cmyk8(self, *, upsample: str = "duplicate") -> np.ndarray:
        """[H, W, 4] uint8 ink values for a 4-component stream.

        YCCK (Adobe transform 2) converts the YCbCr triple back to
        'RGB' and complements it (libjpeg ycck_cmyk_convert,
        jdcolor.c); Adobe-tagged files additionally store every channel
        inverted (255 - ink), so the tag flips all four at the end —
        the same two-step rule libjpeg + PIL apply, verified against
        PIL channel-for-channel (tests/test_color_transforms.py).
        ``upsample`` selects the chroma filter like ``to_rgb8``."""
        if upsample not in ("duplicate", "fancy"):
            raise ValueError(f"unknown upsample mode {upsample!r}")
        if upsample == "fancy":
            sub = self._subres_u8()
            u8 = [
                decode_stage.upsample_fancy(
                    sub[cg.component_index], cg.hs, cg.vs
                )[: self.height, : self.width].astype(np.uint8)
                for cg in self.geometry.components
            ]
        else:
            u8 = [
                decode_stage.normalize_to_uint8(self.planes[i], self.precision)
                for i in sorted(self.planes)
            ]
        if len(u8) != 4:
            raise ValueError(f"CMYK output needs 4 components, got {len(u8)}.")
        from ..ops import color as color_ops

        if self.color_transform == "ycck":
            r_, g_, b_ = color_ops.ycbcr_to_rgb(u8[0], u8[1], u8[2])
            c, m, y = 255 - r_, 255 - g_, 255 - b_
        else:
            c, m, y = u8[0], u8[1], u8[2]
        k = u8[3]
        out = np.stack([c, m, y, k], axis=-1).astype(np.int32)
        if self.adobe_transform is not None:
            out = 255 - out
        return out.astype(np.uint8)

    def to_uint8(self) -> np.ndarray:
        """[H, W, C] uint8, precision-aware writer semantics (8-bit
        clamp; >8-bit shift; <8-bit bit-expand — DecodeAction.cs:41-54)."""
        planes = [
            decode_stage.normalize_to_uint8(self.planes[i], self.precision)
            for i in sorted(self.planes)
        ]
        return np.stack(planes, axis=-1)

    def to_uint16_extended(self) -> np.ndarray:
        """[H, W, C] uint16, JpegExtendingOutputWriter semantics — the
        format of the committed golden fixtures."""
        planes = [
            decode_stage.extend_to_uint16(self.planes[i], self.precision)
            for i in sorted(self.planes)
        ]
        return np.stack(planes, axis=-1)


@dataclasses.dataclass(frozen=True)
class ImageInfo:
    """Identify() output (JpegDecoder.cs:75-167)."""

    width: int
    height: int
    precision: int
    number_of_components: int
    marker: int
    consumed_bytes: int


class JpegDecoder:
    """Host orchestrator for JPEG decoding."""

    def __init__(self):
        self._data: Optional[bytes] = None
        self._stream: Optional[io_reader.JpegStream] = None
        #: marker byte -> [handler]; decoder configuration (survives
        #: reset(), like the reference's subclass hook overrides)
        self._marker_handlers: Dict[int, list] = {}
        self.reset()

    # -- marker extension hooks (ProcessMarkerForDecode /
    #    ProcessMarkerForIdentification parity, JpegDecoder.cs:114,:558) --

    def register_marker_handler(self, marker: int, handler) -> None:
        """Register ``handler(marker, payload: bytes, offset: int)`` to
        be called whenever decode() or identify() walks past a matching
        segment — the extension point the reference exposes as the
        protected virtual ProcessMarkerForDecode/ForIdentification
        (JpegDecoder.cs:114, :558), used to consume APPn/COM metadata
        (EXIF, ICC, comments) without subclassing the walk."""
        self._marker_handlers.setdefault(int(marker), []).append(handler)

    def _dispatch_marker(self, seg: io_reader.Segment, data: bytes) -> None:
        handlers = self._marker_handlers.get(seg.marker)
        if handlers:
            payload = seg.payload(data)
            for handler in handlers:
                handler(seg.marker, payload, seg.offset)

    # -- input management (SetInput / Reset* parity) --

    def reset(self) -> None:
        self.reset_frame_header()
        self.reset_tables()
        self._restart_interval = 0
        self._arithmetic_state = None

    def reset_frame_header(self) -> None:
        self._frame: Optional[FrameHeader] = None

    def reset_tables(self) -> None:
        self.reset_huffman_tables()
        self.reset_quantization_tables()
        self.reset_arithmetic_tables()

    def reset_huffman_tables(self) -> None:
        self._dc_tables: Dict[int, HuffmanDecodingTable] = {}
        self._ac_tables: Dict[int, HuffmanDecodingTable] = {}

    def reset_quantization_tables(self) -> None:
        self._quant_tables: Dict[int, QuantizationTable] = {}

    def reset_arithmetic_tables(self) -> None:
        self._dac_dc = {}
        self._dac_ac = {}

    def set_input(self, data: bytes) -> None:
        self._data = bytes(data)
        self._stream = None
        # Per-image stream state resets with the input (the reference
        # SetInput zeroes _restartInterval, JpegDecoder.cs:61) — a
        # stale DRI from a previous image would otherwise truncate the
        # next image's single-span scan to one restart interval.
        self._restart_interval = 0
        self._adobe_transform = None
        self._arithmetic_state = None

    def _parsed(self) -> io_reader.JpegStream:
        if self._data is None:
            raise ValueError("Input data is not specified.")
        if self._stream is None:
            from ..utils import metrics

            with metrics.stage("decode.parse_container"):
                self._stream = io_reader.parse_stream(self._data)
        return self._stream

    # -- table registries --

    def set_quantization_table(self, table: QuantizationTable) -> None:
        self._quant_tables[table.identifier] = table

    def get_quantization_table(self, identifier: int) -> Optional[QuantizationTable]:
        return self._quant_tables.get(identifier)

    def set_huffman_table(self, table: HuffmanDecodingTable) -> None:
        registry = self._dc_tables if table.table_class == 0 else self._ac_tables
        registry[table.identifier] = table

    def get_huffman_table(self, is_dc: bool, identifier: int) -> Optional[HuffmanDecodingTable]:
        return (self._dc_tables if is_dc else self._ac_tables).get(identifier)

    def get_restart_interval(self) -> int:
        return self._restart_interval

    def load_tables(self, data: bytes) -> None:
        """Load tables from an abbreviated (tables-only) stream
        (JpegDecoder.LoadTables, JpegDecoder.cs:313-405)."""
        stream = io_reader.parse_stream(data, require_soi=False)
        for seg in stream.segments:
            self._process_table_segment(seg, data)

    def _process_table_segment(self, seg: io_reader.Segment, data: bytes) -> None:
        if seg.marker == Marker.DQT:
            for table in _parse_dqt_cached(seg.payload(data)):
                self.set_quantization_table(table)
        elif seg.marker == Marker.DHT:
            for htable in _parse_dht_cached(seg.payload(data)):
                self.set_huffman_table(htable)
        elif seg.marker == Marker.DAC:
            from .arithmetic import parse_dac_segment

            for table in parse_dac_segment(seg.payload(data)):
                registry = self._dac_dc if table.table_class == 0 else self._dac_ac
                registry[table.identifier] = table
        elif seg.marker == Marker.DRI:
            payload = seg.payload(data)
            if len(payload) >= 2:
                self._restart_interval = (payload[0] << 8) | payload[1]

    # -- identify --

    def identify(self, *, load_quantization_tables: bool = False) -> ImageInfo:
        """Metadata-only scan (JpegDecoder.Identify, JpegDecoder.cs:75-114)."""
        data = self._data
        stream = self._parsed()
        frame = None
        marker = 0
        for seg in stream.segments:
            self._dispatch_marker(seg, data)
            if seg.marker == Marker.DHP:
                # Hierarchical (Annex J): DHP carries the authoritative
                # full-resolution dimensions; report it as the marker
                # (later per-frame SOFs are pyramid levels, not the image).
                frame = FrameHeader.parse(seg.payload(data), seg.marker)
                marker = seg.marker
            elif seg.marker in ALL_SOF_MARKERS and marker != Marker.DHP:
                frame = io_reader.resolve_dnl(
                    stream, data, FrameHeader.parse(seg.payload(data), seg.marker)
                )
                marker = seg.marker
            elif load_quantization_tables and seg.marker == Marker.DQT:
                for table in parse_dqt_segment(seg.payload(data)):
                    self.set_quantization_table(table)
        if frame is None:
            raise ValueError("Failed to parse JPEG data: no frame header found.")
        self._frame = frame
        return ImageInfo(
            width=frame.samples_per_line,
            height=frame.number_of_lines,
            precision=frame.sample_precision,
            number_of_components=frame.number_of_components,
            marker=marker,
            consumed_bytes=stream.consumed,
        )

    def estimate_quality(self) -> Optional[float]:
        """IJG-style quality estimate (JpegDecoder.TryEstimateQuanlity,
        JpegDecoder.cs:169-195). Requires quantization tables loaded
        (identify(load_quantization_tables=True) or load_tables)."""
        return quant_mod.estimate_quality(self._quant_tables)

    # -- decode --

    def _make_arithmetic_state(self):
        from . import arithmetic

        if self._arithmetic_state is None:
            self._arithmetic_state = arithmetic.ArithmeticDecoder()
        return self._arithmetic_state

    def decode(
        self, *, use_native: bool = True, sparse_direct: bool = False,
        tolerant: bool = False, wire: str = "v2", xp=np
    ) -> DecodeResult:
        """Full decode: walk segments in order, decode every scan, then
        run the batched transform stage.

        ``sparse_direct`` (serving fast path): for single-scan baseline
        images, run the merged native decode+sparse-pack and return a
        result carrying the device wire payload instead of dense
        coefficient planes (which then materialize lazily if a host
        path asks for them). Ineligible streams fall back to the dense
        path transparently.

        ``tolerant`` (error recovery, BEYOND the reference, which
        throws like our default): scan-level decode errors are
        collected into ``DecodeResult.errors`` instead of raised — a
        truncated or corrupt stream yields the decodable prefix
        (undeedcoded blocks stay zero coefficients = mid-gray after the
        level shift), and independent progressive scans still apply.
        Raises only when NOTHING decodes.
        """
        from ..utils import metrics

        import contextlib

        errors: list = []

        @contextlib.contextmanager
        def scan_guard(what: str):
            try:
                yield
            except ValueError as exc:
                if not tolerant:
                    raise
                errors.append(f"{what}: {type(exc).__name__}: {exc}")

        data = self._data
        if (
            sparse_direct
            and use_native
            and not tolerant
            and data is not None
            and not self._marker_handlers
            and self._restart_interval == 0
        ):
            # Fused whole-image native fast path: container walk +
            # tables + merged sparse scan in one call. Ineligible
            # streams return None and take the general path below.
            try:
                from ..native import scanner as native_scanner

                # v2 split-stream wire by default (~0.4-0.6x transfer
                # bytes); JPX_WIRE=1 pins the v1 wire, and streams the
                # v2 packer declines (exception-bucket overflow) fall
                # back to v1 transparently.
                # ``wire="v1"`` (and JPX_WIRE=1) pin the v1 payload for
                # consumers built on its MCU-entry layout (stripe
                # sharding); the serving default is the v2 wire.
                fused2 = None
                if wire != "v1" and os.environ.get("JPX_WIRE") != "1":
                    fused2 = native_scanner.decode_image_sparse2(data)
                fused = (
                    None
                    if fused2 is not None
                    else native_scanner.decode_image_sparse(data)
                )
            except ImportError:
                fused = fused2 = None
            if fused is not None or fused2 is not None:
                payload, frame, geometry, quant, adobe = fused or fused2
                metrics.count("decode.images")
                metrics.count(
                    "decode.megapixels",
                    frame.samples_per_line * frame.number_of_lines / 1e6,
                )
                return DecodeResult(
                    frame=frame,
                    geometry=geometry,
                    quant=quant,
                    packed_mcu=payload if fused is not None else None,
                    packed_mcu2=payload if fused2 is not None else None,
                    xp=xp,
                    adobe_transform=adobe,
                )

        stream = self._parsed()

        if any(seg.marker == Marker.DHP for seg in stream.segments):
            # Hierarchical stream (T.81 Annex J): multi-frame pyramid
            # with EXP-expanded differential refinements. (The fused
            # native walk above rejects DHP/EXP streams, so this check
            # sees every hierarchical input.)
            from .hierarchical import decode_hierarchical

            return decode_hierarchical(
                self, stream, data, use_native=use_native, xp=xp
            )

        frame: Optional[FrameHeader] = None
        sof_marker: Optional[int] = None
        geometry: Optional[FrameGeometry] = None
        coefficient_planes: Optional[Dict[int, np.ndarray]] = None
        sample_planes: Optional[Dict[int, np.ndarray]] = None
        sparse_payload: Optional[np.ndarray] = None
        sparse_payload2: Optional[np.ndarray] = None
        # Quant table snapshot per component, captured at scan time the
        # way the reference dequantizes mid-scan.
        component_quant: Dict[int, np.ndarray] = {}
        progressive_jobs = []
        scan_iter = iter(stream.scans)

        self._adobe_transform = None
        for seg in stream.segments:
            if self._marker_handlers:
                self._dispatch_marker(seg, data)
            if seg.marker in (Marker.DQT, Marker.DHT, Marker.DAC, Marker.DRI):
                self._process_table_segment(seg, data)
            elif seg.marker == Marker.APP14:
                # Adobe color-transform tag (libjpeg semantics): drives
                # RGB / CMYK / YCCK output interpretation.
                payload = seg.payload(data)
                if len(payload) >= 12 and payload[:5] == b"Adobe":
                    self._adobe_transform = payload[11]
            elif seg.marker in ALL_SOF_MARKERS:
                if seg.marker not in SUPPORTED_SOF_MARKERS:
                    raise JpegUnsupportedError(
                        f"This type of JPEG stream is not supported ({Marker(seg.marker).name})."
                    )
                frame = io_reader.resolve_dnl(
                    stream, data, FrameHeader.parse(seg.payload(data), seg.marker)
                )
                sof_marker = seg.marker
                geometry = frame_geometry(frame)
                # Fresh per-frame entropy state (the reference creates a
                # new scan decoder per SOF, JpegDecoder.cs:558-590).
                self._arithmetic_state = None
                if sof_marker in (Marker.SOF3, Marker.SOF11):
                    from .lossless import allocate_sample_planes

                    sample_planes = allocate_sample_planes(frame)
                else:
                    # Allocated lazily at the first dense scan — the
                    # sparse_direct fast path never touches them.
                    coefficient_planes = None
            elif seg.marker == Marker.SOS:
                if frame is None:
                    raise ValueError("Frame header was not found before SOS.")
                scan = next(scan_iter)
                scan_header = ScanHeader.parse(seg.payload(data))
                if (
                    use_native
                    and sof_marker in (Marker.SOF2, Marker.SOF10)
                ):
                    # Progressive scans: collect jobs and run them after
                    # the walk — independent (component, band) scans
                    # decode in parallel threads. The whole collection
                    # runs under scan_guard so a tolerant decode skips
                    # (and records) a scan whose tables are broken
                    # instead of aborting the walk.
                    from ..syntax.frame import resolve_scan_components

                    with scan_guard(
                        f"scan at offset {scan.header_segment.offset}"
                    ):
                        for comp_index, fc, _sc in resolve_scan_components(
                            frame, scan_header
                        ):
                            qt = self._quant_tables.get(fc.quantization_table_selector)
                            if qt is None or qt.is_empty:
                                raise ValueError(
                                    f"Quantization table of component {comp_index} is not defined."
                                )
                            component_quant[comp_index] = qt.elements.copy()
                        if coefficient_planes is None:
                            coefficient_planes = allocate_coefficient_planes(geometry)
                        progressive_jobs.append(
                            {
                                "scan": scan,
                                "scan_header": scan_header,
                                "dc_tables": dict(self._dc_tables),
                                "ac_tables": dict(self._ac_tables),
                                "dac_dc": dict(self._dac_dc),
                                "dac_ac": dict(self._dac_ac),
                                "restart_interval": self._restart_interval,
                                "arithmetic": sof_marker == Marker.SOF10,
                            }
                        )
                    continue
                with scan_guard(
                    f"scan at offset {scan.header_segment.offset}"
                ), metrics.stage("decode.entropy_scan"):
                    if sof_marker == Marker.SOF11:
                        from . import arithmetic
                        from .arithmetic_lossless import decode_scan

                        if self._arithmetic_state is None:
                            self._arithmetic_state = arithmetic.ArithmeticDecoder()
                        decode_scan(
                            data,
                            scan.spans,
                            frame,
                            scan_header,
                            self._dac_dc,
                            self._arithmetic_state,
                            self._restart_interval,
                            sample_planes,
                            use_native=use_native,
                        )
                    elif sof_marker == Marker.SOF3:
                        decoded_native = False
                        if use_native:
                            try:
                                from ..native import scanner as native_scanner

                                decoded_native = native_scanner.decode_lossless_scan(
                                    data,
                                    scan.spans,
                                    frame,
                                    scan_header,
                                    self._dc_tables,
                                    self._restart_interval,
                                    sample_planes,
                                )
                            except ImportError:
                                decoded_native = False
                        if not decoded_native:
                            from .lossless import decode_lossless_scan

                            decode_lossless_scan(
                                data,
                                scan.spans,
                                frame,
                                scan_header,
                                self._dc_tables,
                                self._restart_interval,
                                sample_planes,
                            )
                    else:
                        if (
                            sparse_direct
                            and use_native
                            and sof_marker in (Marker.SOF0, Marker.SOF1)
                            and len(stream.scans) == 1
                        ):
                            sparse_payload2 = None
                            try:
                                from ..native import scanner as native_scanner

                                if (
                                    wire != "v1"
                                    and os.environ.get("JPX_WIRE") != "1"
                                ):
                                    sparse_payload2 = (
                                        native_scanner.decode_baseline_scan_sparse2(
                                            data,
                                            scan.spans,
                                            frame,
                                            scan_header,
                                            self._dc_tables,
                                            self._ac_tables,
                                            self._restart_interval,
                                            geometry,
                                        )
                                    )
                                sparse_payload = (
                                    None
                                    if sparse_payload2 is not None
                                    else native_scanner.decode_baseline_scan_sparse(
                                        data,
                                        scan.spans,
                                        frame,
                                        scan_header,
                                        self._dc_tables,
                                        self._ac_tables,
                                        self._restart_interval,
                                        geometry,
                                    )
                                )
                            except ImportError:
                                sparse_payload = sparse_payload2 = None
                            if (
                                sparse_payload is not None
                                or sparse_payload2 is not None
                            ):
                                # Snapshot quantization tables the way
                                # _decode_scan does, then skip the dense
                                # scan entirely.
                                from ..syntax.frame import resolve_scan_components

                                for comp_index, fc, _sc in resolve_scan_components(
                                    frame, scan_header
                                ):
                                    qt = self._quant_tables.get(
                                        fc.quantization_table_selector
                                    )
                                    if qt is None or qt.is_empty:
                                        raise ValueError(
                                            f"Quantization table of component {comp_index} is not defined."
                                        )
                                    component_quant[comp_index] = qt.elements.copy()
                                continue
                        if coefficient_planes is None:
                            coefficient_planes = allocate_coefficient_planes(geometry)
                        self._decode_scan(
                            data,
                            scan,
                            scan_header,
                            frame,
                            sof_marker,
                            geometry,
                            coefficient_planes,
                            component_quant,
                            use_native=use_native,
                        )
            elif seg.marker == Marker.EOI:
                break

        if progressive_jobs:
            with metrics.stage("decode.entropy_scan"):
                try:
                    _run_progressive_jobs(
                        data, frame, geometry, coefficient_planes, progressive_jobs,
                        arithmetic_state_factory=lambda: self._make_arithmetic_state(),
                    )
                except ValueError as exc:
                    if not tolerant:
                        raise
                    # The parallel run may have partially applied
                    # refinement scans (non-idempotent): reset and
                    # re-run per scan, skipping the broken ones.
                    errors.append(
                        f"progressive scans: {type(exc).__name__}: {exc}"
                    )
                    for p in coefficient_planes.values():
                        p[:] = 0
                    _run_progressive_jobs_tolerant(
                        data, frame, geometry, coefficient_planes,
                        progressive_jobs, errors,
                        arithmetic_state_factory=lambda: self._make_arithmetic_state(),
                    )

        if frame is None or (
            coefficient_planes is None
            and sample_planes is None
            and sparse_payload is None
            and sparse_payload2 is None
        ):
            raise ValueError("No image data decoded.")

        if tolerant and coefficient_planes is not None:
            # Components whose every scan failed never registered a
            # quant table; identity-fill so the transform stage renders
            # their (all-zero) planes as mid-gray instead of raising.
            for cg in geometry.components:
                component_quant.setdefault(
                    cg.component_index, np.ones(64, dtype=np.uint16)
                )

        metrics.count("decode.images")
        metrics.count(
            "decode.megapixels", frame.samples_per_line * frame.number_of_lines / 1e6
        )

        if sample_planes is not None:
            return DecodeResult(
                frame=frame, geometry=geometry, samples=sample_planes, xp=xp,
                adobe_transform=self._adobe_transform, errors=errors,
            )
        quant_by_comp = {
            idx: component_quant[idx].astype(np.int32) for idx in component_quant
        }
        have_sparse = sparse_payload is not None or sparse_payload2 is not None
        return DecodeResult(
            frame=frame,
            geometry=geometry,
            coefficients=None if have_sparse else coefficient_planes,
            quant=quant_by_comp,
            packed_mcu=sparse_payload,
            packed_mcu2=sparse_payload2,
            xp=xp,
            adobe_transform=self._adobe_transform,
            errors=errors,
        )

    def _decode_scan(
        self,
        data: bytes,
        scan: io_reader.Scan,
        scan_header: ScanHeader,
        frame: FrameHeader,
        sof_marker: int,
        geometry: FrameGeometry,
        coefficient_planes: Dict[int, np.ndarray],
        component_quant: Dict[int, np.ndarray],
        *,
        use_native: bool,
    ) -> None:
        # Snapshot quantization tables for the scan's components.
        from ..syntax.frame import resolve_scan_components

        for comp_index, fc, _sc in resolve_scan_components(frame, scan_header):
            qt = self._quant_tables.get(fc.quantization_table_selector)
            if qt is None or qt.is_empty:
                raise ValueError(
                    f"Quantization table of component {comp_index} is not defined."
                )
            component_quant[comp_index] = qt.elements.copy()

        # Differential frames (SOF5/SOF13, hierarchical mode) use the
        # SAME scan coding as their sequential counterparts — the DC
        # predictor starts at 0 either way and the level shift lives in
        # the transform stage, so the scan decoders are shared verbatim
        # (only the hierarchical finalize differs: no level shift, add
        # to the reference).
        if sof_marker in (Marker.SOF9, Marker.SOF10, Marker.SOF13):
            from . import arithmetic

            decoded_native = False
            if use_native:
                try:
                    from ..native import scanner as native_scanner

                    decoded_native = native_scanner.decode_arithmetic_scan(
                        data,
                        scan.spans,
                        frame,
                        scan_header,
                        self._dac_dc,
                        self._dac_ac,
                        self._restart_interval,
                        coefficient_planes,
                        geometry,
                        progressive=sof_marker == Marker.SOF10,
                    )
                except ImportError:
                    decoded_native = False
            if not decoded_native:
                if self._arithmetic_state is None:
                    self._arithmetic_state = arithmetic.ArithmeticDecoder()
                fn = (
                    arithmetic.decode_progressive_scan
                    if sof_marker == Marker.SOF10
                    else arithmetic.decode_sequential_scan
                )
                fn(
                    data,
                    scan.spans,
                    frame,
                    scan_header,
                    self._dac_dc,
                    self._dac_ac,
                    self._arithmetic_state,
                    self._restart_interval,
                    coefficient_planes,
                    geometry,
                )
        elif sof_marker == Marker.SOF2:
            decoded_native = False
            if use_native:
                try:
                    from ..native import scanner as native_scanner

                    decoded_native = native_scanner.decode_progressive_scan(
                        data,
                        scan.spans,
                        frame,
                        scan_header,
                        self._dc_tables,
                        self._ac_tables,
                        self._restart_interval,
                        coefficient_planes,
                        geometry,
                    )
                except ImportError:
                    decoded_native = False
            if not decoded_native:
                from . import huffman_progressive

                huffman_progressive.decode_progressive_scan(
                    data,
                    scan.spans,
                    frame,
                    scan_header,
                    self._dc_tables,
                    self._ac_tables,
                    self._restart_interval,
                    coefficient_planes,
                    geometry,
                )
        elif sof_marker in (Marker.SOF0, Marker.SOF1, Marker.SOF5):
            decoded_native = False
            if use_native:
                try:
                    from ..native import scanner as native_scanner

                    decoded_native = native_scanner.decode_baseline_scan(
                        data,
                        scan.spans,
                        frame,
                        scan_header,
                        self._dc_tables,
                        self._ac_tables,
                        self._restart_interval,
                        coefficient_planes,
                        geometry,
                    )
                except ImportError:
                    decoded_native = False
            if not decoded_native:
                huffman_baseline.decode_baseline_scan(
                    data,
                    scan.spans,
                    frame,
                    scan_header,
                    self._dc_tables,
                    self._ac_tables,
                    self._restart_interval,
                    coefficient_planes,
                    geometry,
                )
        else:
            raise JpegUnsupportedError(
                f"Scan decoding for {Marker(sof_marker).name} is not implemented yet."
            )



def _scan_bands_overlap(a, b) -> bool:
    return max(a[0], b[0]) <= min(a[1], b[1])


def _run_progressive_jobs_tolerant(data, frame, geometry, coefficient_planes,
                                   jobs, errors, *, arithmetic_state_factory):
    """Sequential per-scan recovery pass (tolerant decode): each scan
    runs independently in stream order; a scan that errors is recorded
    and skipped — later scans still apply (refinements of a skipped
    band refine zeros, which is the standard progressive-truncation
    behavior)."""
    from . import arithmetic as arith_mod
    from . import huffman_progressive

    try:
        from ..native import scanner as native_scanner

        native_scanner.build.load_library()
        native = native_scanner
    except ImportError:
        native = None

    for k, job in enumerate(jobs):
        try:
            if native is not None:
                if job["arithmetic"]:
                    native.decode_arithmetic_scan(
                        data, job["scan"].spans, frame, job["scan_header"],
                        job["dac_dc"], job["dac_ac"], job["restart_interval"],
                        coefficient_planes, geometry, progressive=True,
                    )
                else:
                    native.decode_progressive_scan(
                        data, job["scan"].spans, frame, job["scan_header"],
                        job["dc_tables"], job["ac_tables"],
                        job["restart_interval"], coefficient_planes, geometry,
                    )
            elif job["arithmetic"]:
                arith_mod.decode_progressive_scan(
                    data, job["scan"].spans, frame, job["scan_header"],
                    job["dac_dc"], job["dac_ac"], arithmetic_state_factory(),
                    job["restart_interval"], coefficient_planes, geometry,
                )
            else:
                huffman_progressive.decode_progressive_scan(
                    data, job["scan"].spans, frame, job["scan_header"],
                    job["dc_tables"], job["ac_tables"],
                    job["restart_interval"], coefficient_planes, geometry,
                )
        except ValueError as exc:
            errors.append(
                f"progressive scan {k}: {type(exc).__name__}: {exc}"
            )


def _run_progressive_jobs(data, frame, geometry, coefficient_planes, jobs,
                          *, arithmetic_state_factory, use_native=True):
    """Run progressive scan jobs, in parallel where the data allows.

    Scans touching disjoint (component, spectral band) pairs are
    independent (DC first/refine chains and AC band refinements overlap
    and stay ordered); the native scanners release the GIL, so
    independent scans decode concurrently. Falls back to the sequential
    Python scanners when the native library is unavailable.
    """
    from concurrent.futures import ThreadPoolExecutor

    from ..syntax.frame import resolve_scan_components

    native = None
    if use_native:
        try:
            from ..native import scanner as native_scanner

            native_scanner.build.load_library()
            native = native_scanner
        except ImportError:
            native = None

    if native is None:
        # Sequential Python fallback in stream order.
        from . import arithmetic as arith_mod
        from . import huffman_progressive

        arith_state = arithmetic_state_factory()
        for job in jobs:
            if job["arithmetic"]:
                arith_mod.decode_progressive_scan(
                    data, job["scan"].spans, frame, job["scan_header"],
                    job["dac_dc"], job["dac_ac"], arith_state,
                    job["restart_interval"], coefficient_planes, geometry,
                )
            else:
                huffman_progressive.decode_progressive_scan(
                    data, job["scan"].spans, frame, job["scan_header"],
                    job["dc_tables"], job["ac_tables"],
                    job["restart_interval"], coefficient_planes, geometry,
                )
        return

    # Dependency edges: earlier job i -> job j when they share a
    # component and their spectral bands overlap.
    touches = []
    for job in jobs:
        hdr = job["scan_header"]
        comps = frozenset(
            ci for ci, _fc, _sc in resolve_scan_components(frame, hdr)
        )
        band = (hdr.start_of_spectral_selection, hdr.end_of_spectral_selection)
        touches.append((comps, band))

    deps = [
        [
            i
            for i in range(j)
            if (touches[i][0] & touches[j][0])
            and _scan_bands_overlap(touches[i][1], touches[j][1])
        ]
        for j in range(len(jobs))
    ]

    # Single-component Huffman scans go to the watermark-pipelined chain
    # decoder (jpx_decode_progressive_chains): a component's
    # first->refine->refine chain overlaps per-unit instead of
    # serializing scan by scan. Remaining jobs (interleaved DC,
    # arithmetic) keep the future-based schedule. If a rest job depends
    # on a chain job (unusual scan scripts), fall back to futures-only.
    # Restart-span scans route through chains too: measured on a 4.2 MP
    # ri=64 stream, the futures graph's scan-level barriers (a refine
    # scan can't START until its producer FINISHES) cap it at ~150 MP/s
    # while the per-unit pipeline reaches ~210 — the barrier costs more
    # than intra-scan restart threading recovers on a 4-core host.
    chain_idx = [
        j
        for j in range(len(jobs))
        if not jobs[j]["arithmetic"]
        and len(touches[j][0]) == 1
    ]
    chain_set = set(chain_idx)
    if chain_set and any(
        i in chain_set for j in range(len(jobs)) if j not in chain_set
        for i in deps[j]
    ):
        chain_idx = []
        chain_set = set()

    rest_idx = [j for j in range(len(jobs)) if j not in chain_set]

    def run_rest(j, futures):
        if futures is not None:
            for i in deps[j]:
                futures[i].result()
        job = jobs[j]
        if job["arithmetic"]:
            native.decode_arithmetic_scan(
                data, job["scan"].spans, frame, job["scan_header"],
                job["dac_dc"], job["dac_ac"], job["restart_interval"],
                coefficient_planes, geometry, progressive=True,
            )
        else:
            native.decode_progressive_scan(
                data, job["scan"].spans, frame, job["scan_header"],
                job["dc_tables"], job["ac_tables"], job["restart_interval"],
                coefficient_planes, geometry,
            )

    if chain_idx and not rest_idx:
        native.decode_progressive_chains(
            data, [jobs[j] for j in chain_idx], frame, geometry,
            coefficient_planes,
        )
        return

    # Per-decode executors cost ~5-7 ms in thread spawn alone — the
    # shared persistent pool removes that fixed overhead entirely.
    from ..utils.pool import shared_pool

    pool = shared_pool()
    futures = {}
    for j in rest_idx:
        futures[j] = pool.submit(run_rest, j, futures)
    chain_future = None
    if chain_idx:
        chain_deps = sorted(
            {i for j in chain_idx for i in deps[j] if i not in chain_set}
        )

        def run_chains():
            for i in chain_deps:
                futures[i].result()
            native.decode_progressive_chains(
                data, [jobs[j] for j in chain_idx], frame, geometry,
                coefficient_planes,
            )

        chain_future = pool.submit(run_chains)
    for j in rest_idx:
        futures[j].result()
    if chain_future is not None:
        chain_future.result()


def decode(data: bytes, **kwargs) -> DecodeResult:
    """One-shot decode convenience function."""
    decoder = JpegDecoder()
    decoder.set_input(data)
    return decoder.decode(**kwargs)


def decode_rgb8(data: bytes, *, upsample: str = "duplicate") -> np.ndarray:
    """One-shot host decode straight to interleaved uint8 [H, W, 3] RGB.

    Semantically identical to ``decode(data).to_rgb8(upsample=...)``
    (bit-exact), but eligible streams — single-scan SOF0/SOF1, 8-bit,
    gray/YCbCr/RGB, duplication upsampling — run entropy decode and
    the RGB transform in ONE fused native call sharing a thread pool:
    an MCU row transforms as soon as its covering restart spans have
    decoded, while its coefficients are still cache-warm, instead of
    the transform waiting behind the whole scan. This is the host
    consumer's fastest full-image path (the device serving path is
    ``jpeglibrary_tpu_torch.to_rgb8_device``)."""
    out = _decode_rgb8_fused(data, upsample)
    if out is not None:
        return out
    return decode(data).to_rgb8(upsample=upsample)


def _decode_rgb8_fused(data: bytes, upsample: str) -> Optional[np.ndarray]:
    if upsample != "duplicate":
        return None
    try:
        from ..native import build as native_build
        from ..native import scanner as native_scanner

        native_build.load_library()
    except ImportError:
        return None

    dec = JpegDecoder()
    dec.set_input(data)
    try:
        stream = dec._parsed()
    except Exception:
        return None  # full decode raises the canonical error
    if len(stream.scans) != 1:
        return None

    frame = None
    adobe = None
    scan_header = None
    for seg in stream.segments:
        if seg.marker in (Marker.DQT, Marker.DHT, Marker.DAC, Marker.DRI):
            dec._process_table_segment(seg, data)
        elif seg.marker == Marker.APP14:
            payload = seg.payload(data)
            if len(payload) >= 12 and payload[:5] == b"Adobe":
                adobe = payload[11]
        elif seg.marker == Marker.DHP:
            return None
        elif seg.marker in ALL_SOF_MARKERS:
            if seg.marker not in (Marker.SOF0, Marker.SOF1):
                return None
            frame = io_reader.resolve_dnl(
                stream, data, FrameHeader.parse(seg.payload(data), seg.marker)
            )
        elif seg.marker == Marker.SOS:
            if frame is None:
                return None
            scan_header = ScanHeader.parse(seg.payload(data))
            break
    if frame is None or scan_header is None or frame.sample_precision != 8:
        return None
    n = frame.number_of_components
    if len(scan_header.components) != n:
        return None  # non-interleaved single-component scans: staged path

    # Color interpretation (DecodeResult.color_transform rules).
    ids = tuple(fc.identifier for fc in frame.components)
    if n == 1:
        mode = "gray"
    elif n == 3:
        if adobe is not None:
            mode = "ycbcr" if adobe != 0 else "rgb"
        elif ids == (0x52, 0x47, 0x42):
            mode = "rgb"
        else:
            mode = "ycbcr"
    else:
        return None  # CMYK/YCCK ride to_cmyk8

    from ..syntax.frame import resolve_scan_components

    geo = frame_geometry(frame)
    quant = {}
    for comp_index, fc, _sc in resolve_scan_components(frame, scan_header):
        qt = dec._quant_tables.get(fc.quantization_table_selector)
        if qt is None or qt.is_empty:
            return None  # full decode raises the canonical error
        quant[comp_index] = qt.elements.astype(np.int32)

    return native_scanner.decode_rgb_fused(
        data,
        stream.scans[0].spans,
        frame,
        scan_header,
        dec._dc_tables,
        dec._ac_tables,
        dec._restart_interval,
        quant,
        geo,
        mode=mode,
    )

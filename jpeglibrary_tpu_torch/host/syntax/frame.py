"""Frame (SOF) and scan (SOS) header models.

Capability parity with the reference syntax structs
(yigolden/JpegLibrary/src/JpegLibrary/JpegFrameHeader.cs:70,190 and
 JpegScanHeader.cs:23-66) — parse/serialize of ITU-T T.81 B.2.2/B.2.3
segments, re-expressed as frozen dataclasses for use in host-side
scan planning.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional, Tuple


class JpegParseError(ValueError):
    """Raised when a JPEG segment cannot be parsed."""


@dataclasses.dataclass(frozen=True)
class FrameComponent:
    """One component spec in a SOF segment (T.81 B.2.2)."""

    identifier: int
    horizontal_sampling_factor: int
    vertical_sampling_factor: int
    quantization_table_selector: int


@dataclasses.dataclass(frozen=True)
class FrameHeader:
    """A parsed SOF segment (reference: JpegFrameHeader.cs:70)."""

    marker: int  # which SOFn introduced this frame
    sample_precision: int
    number_of_lines: int
    samples_per_line: int
    components: Tuple[FrameComponent, ...]

    @property
    def number_of_components(self) -> int:
        return len(self.components)

    @property
    def max_horizontal_sampling(self) -> int:
        return max((c.horizontal_sampling_factor for c in self.components), default=1)

    @property
    def max_vertical_sampling(self) -> int:
        return max((c.vertical_sampling_factor for c in self.components), default=1)

    @staticmethod
    def parse(payload: bytes, marker: int) -> "FrameHeader":
        if len(payload) < 6:
            raise JpegParseError("SOF segment too short.")
        precision, lines, samples_per_line, ncomp = struct.unpack_from(">BHHB", payload, 0)
        if len(payload) < 6 + 3 * ncomp:
            raise JpegParseError("SOF segment too short for component list.")
        # T.81 B.2.2: X (samples per line) is 1..65535 — only Y may be
        # 0 (deferred to a DNL segment). Fuzz-found: a zero width
        # previously surfaced as a RuntimeError deep in the transform
        # stage (libjpeg raises JERR_EMPTY_IMAGE here too).
        if samples_per_line == 0:
            raise JpegParseError("Frame header defines zero samples per line.")
        # T.81 Table B.2: sample precision per process — baseline 8,
        # extended/progressive 8 or 12, lossless 2..16 (differential
        # frames follow their base family, B.3.2; DHP accepts the
        # union). Fuzz-found: a corrupt precision byte (e.g. 40) blew
        # up 1 << (P-1) downstream (libjpeg raises JERR_BAD_PRECISION).
        if marker == 0xC0:  # SOF0 baseline
            valid_p = precision == 8
        elif marker in (0xC3, 0xC7, 0xCB, 0xCF):  # lossless families
            valid_p = 2 <= precision <= 16
        else:  # extended sequential / progressive (+ differential, DHP)
            valid_p = precision in (8, 12) or (
                marker == 0xDE and 2 <= precision <= 16
            )
        if not valid_p:
            raise JpegParseError(
                f"Bogus sample precision {precision} for marker 0x{marker:02X}."
            )
        comps = []
        off = 6
        for _ in range(ncomp):
            ident = payload[off]
            sampling = payload[off + 1]
            tq = payload[off + 2]
            h, v = sampling >> 4, sampling & 0xF
            # T.81 B.2.2: Hi/Vi are 1..4. Out-of-range factors made the
            # staged and fused pipelines disagree on garbage output
            # (fuzz-found; libjpeg raises JERR_BAD_SAMPLING).
            if not (1 <= h <= 4 and 1 <= v <= 4):
                raise JpegParseError(
                    f"Bogus sampling factor {h}x{v} for component {ident}."
                )
            comps.append(
                FrameComponent(
                    identifier=ident,
                    horizontal_sampling_factor=h,
                    vertical_sampling_factor=v,
                    quantization_table_selector=tq,
                )
            )
            off += 3
        return FrameHeader(
            marker=marker,
            sample_precision=precision,
            number_of_lines=lines,
            samples_per_line=samples_per_line,
            components=tuple(comps),
        )

    def serialize(self) -> bytes:
        """Emit the SOF payload (without marker/length), cf. JpegFrameHeader.TryWrite."""
        out = bytearray(
            struct.pack(
                ">BHHB",
                self.sample_precision,
                self.number_of_lines,
                self.samples_per_line,
                self.number_of_components,
            )
        )
        for c in self.components:
            out.append(c.identifier)
            out.append(
                ((c.horizontal_sampling_factor & 0xF) << 4)
                | (c.vertical_sampling_factor & 0xF)
            )
            out.append(c.quantization_table_selector)
        return bytes(out)


@dataclasses.dataclass(frozen=True)
class ScanComponent:
    """One component spec in a SOS segment (T.81 B.2.3)."""

    scan_component_selector: int
    dc_table_selector: int
    ac_table_selector: int


@dataclasses.dataclass(frozen=True)
class ScanHeader:
    """A parsed SOS segment (reference: JpegScanHeader.cs:23-66).

    ``start_of_spectral_selection``/``end_of_spectral_selection`` double
    as the predictor selector / point transform context for lossless
    frames, exactly as in T.81.
    """

    components: Tuple[ScanComponent, ...]
    start_of_spectral_selection: int
    end_of_spectral_selection: int
    successive_approximation_bit_position_high: int
    successive_approximation_bit_position_low: int

    @property
    def number_of_components(self) -> int:
        return len(self.components)

    @staticmethod
    def parse(payload: bytes) -> "ScanHeader":
        if len(payload) < 1:
            raise JpegParseError("SOS segment too short.")
        ncomp = payload[0]
        if len(payload) < 1 + 2 * ncomp + 3:
            raise JpegParseError("SOS segment too short for component list.")
        comps = []
        off = 1
        for _ in range(ncomp):
            selector = payload[off]
            tables = payload[off + 1]
            comps.append(
                ScanComponent(
                    scan_component_selector=selector,
                    dc_table_selector=tables >> 4,
                    ac_table_selector=tables & 0xF,
                )
            )
            off += 2
        ss = payload[off]
        se = payload[off + 1]
        a = payload[off + 2]
        return ScanHeader(
            components=tuple(comps),
            start_of_spectral_selection=ss,
            end_of_spectral_selection=se,
            successive_approximation_bit_position_high=a >> 4,
            successive_approximation_bit_position_low=a & 0xF,
        )

    def serialize(self) -> bytes:
        out = bytearray([self.number_of_components])
        for c in self.components:
            out.append(c.scan_component_selector)
            out.append(((c.dc_table_selector & 0xF) << 4) | (c.ac_table_selector & 0xF))
        out.append(self.start_of_spectral_selection)
        out.append(self.end_of_spectral_selection)
        out.append(
            ((self.successive_approximation_bit_position_high & 0xF) << 4)
            | (self.successive_approximation_bit_position_low & 0xF)
        )
        return bytes(out)


def resolve_scan_components(
    frame: FrameHeader, scan: ScanHeader
) -> Tuple[Tuple[int, FrameComponent, ScanComponent], ...]:
    """Match scan components to frame components by identifier.

    Returns (component_index_in_frame, frame_component, scan_component)
    triples in scan order (reference: JpegHuffmanScanDecoder.cs:17-75).
    """
    resolved = []
    seen = set()
    for sc in scan.components:
        # T.81 B.2.3: the scan component selectors shall all be
        # different — a duplicate maps two scan slots onto one frame
        # component and leaves another without tables (fuzz-found: the
        # dangling component surfaced later as a bare KeyError).
        if sc.scan_component_selector in seen:
            raise JpegParseError(
                f"Duplicate scan component selector {sc.scan_component_selector}."
            )
        seen.add(sc.scan_component_selector)
        found: Optional[Tuple[int, FrameComponent]] = None
        for j, fc in enumerate(frame.components):
            if sc.scan_component_selector == fc.identifier:
                found = (j, fc)
        if found is None:
            raise JpegParseError(
                f"Scan component {sc.scan_component_selector} missing from frame header."
            )
        resolved.append((found[0], found[1], sc))
    return tuple(resolved)

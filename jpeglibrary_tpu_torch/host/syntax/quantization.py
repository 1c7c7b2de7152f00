"""Quantization tables: DQT parse/serialize, Annex-K standard tables,
IJG quality scaling, and IJG-style quality estimation.

Capability parity with the reference
(yigolden/JpegLibrary/src/JpegLibrary/JpegQuantizationTable.cs:22-57,
 JpegStandardQuantizationTable.cs:12-87, JpegDecoder.cs:169-248).

Tables are stored in **zig-zag order**, exactly like the reference and
the DQT wire format. Kernels bake the un-zigzag permutation in.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class QuantizationTable:
    """A quantization table (elements in zig-zag order)."""

    element_precision: int  # 0: 8-bit elements; 1: 16-bit elements
    identifier: int
    elements: np.ndarray  # uint16[64], zig-zag order

    def __post_init__(self):
        assert self.elements.shape == (64,)

    @property
    def is_empty(self) -> bool:
        return bool(np.all(self.elements == 0))

    def serialize(self) -> bytes:
        """Emit Pq/Tq byte + elements (T.81 B.2.4.1)."""
        head = bytes([((self.element_precision & 0xF) << 4) | (self.identifier & 0xF)])
        if self.element_precision == 0:
            return head + self.elements.astype(np.uint8).tobytes()
        return head + self.elements.astype(">u2").tobytes()


def parse_dqt_segment(payload: bytes) -> List[QuantizationTable]:
    """Parse all tables in one DQT segment (may contain several)."""
    tables = []
    off = 0
    n = len(payload)
    while off < n:
        pq_tq = payload[off]
        precision = pq_tq >> 4
        identifier = pq_tq & 0xF
        off += 1
        if precision == 0:
            if off + 64 > n:
                raise ValueError("DQT segment truncated (8-bit elements).")
            elements = np.frombuffer(payload, dtype=np.uint8, count=64, offset=off)
            elements = elements.astype(np.uint16)
            off += 64
        elif precision == 1:
            if off + 128 > n:
                raise ValueError("DQT segment truncated (16-bit elements).")
            elements = np.frombuffer(payload, dtype=">u2", count=64, offset=off)
            elements = elements.astype(np.uint16)
            off += 128
        else:
            raise ValueError(f"Invalid DQT element precision {precision}.")
        tables.append(
            QuantizationTable(element_precision=precision, identifier=identifier, elements=elements)
        )
    return tables


# ---------------------------------------------------------------------------
# Annex K standard tables (ITU-T T.81 Tables K.1/K.2), in zig-zag order —
# the same constants the reference exposes
# (JpegStandardQuantizationTable.cs:12-34).
# ---------------------------------------------------------------------------

STANDARD_LUMINANCE_ZIGZAG = np.array(
    [
        16, 11, 12, 14, 12, 10, 16, 14,
        13, 14, 18, 17, 16, 19, 24, 40,
        26, 24, 22, 22, 24, 49, 35, 37,
        29, 40, 58, 51, 61, 60, 57, 51,
        56, 55, 64, 72, 92, 78, 64, 68,
        87, 69, 55, 56, 80, 109, 81, 87,
        95, 98, 103, 104, 103, 62, 77, 113,
        121, 112, 100, 120, 92, 101, 103, 99,
    ],
    dtype=np.uint16,
)

STANDARD_CHROMINANCE_ZIGZAG = np.array(
    [
        17, 18, 18, 24, 21, 24, 47, 26,
        26, 47, 99, 66, 56, 66, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
    ],
    dtype=np.uint16,
)


def standard_luminance_table(identifier: int = 0) -> QuantizationTable:
    return QuantizationTable(0, identifier, STANDARD_LUMINANCE_ZIGZAG.copy())


def standard_chrominance_table(identifier: int = 1) -> QuantizationTable:
    return QuantizationTable(0, identifier, STANDARD_CHROMINANCE_ZIGZAG.copy())


def scale_by_quality(table: QuantizationTable, quality: int) -> QuantizationTable:
    """IJG quality scaling (reference: JpegStandardQuantizationTable.cs:64-87)."""
    if table.is_empty:
        raise ValueError("Quantization table is not initialized.")
    if not (0 < quality <= 100):
        raise ValueError("quality must be in (0, 100].")
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    x = table.elements.astype(np.int64)
    x = (x * scale + 50) // 100
    x = np.clip(x, 1, 255).astype(np.uint16)
    return QuantizationTable(table.element_precision, table.identifier, x)


def estimate_quality_single(
    table: QuantizationTable, standard: QuantizationTable
) -> Tuple[float, float]:
    """IJG-style quality estimate from one table vs its standard table.

    Returns (quality, variance). Mirrors the statistics in
    JpegDecoder.EstimateQuality (JpegDecoder.cs:198-248).
    """
    elements = table.elements.astype(np.float64)
    std = standard.elements.astype(np.float64)
    compare = np.where(elements == 0, 999.99, 100.0 * elements / np.where(std == 0, 1, std))
    sum_percent = float(np.sum(compare)) / 64.0
    sum_percent_sqr = float(np.sum(compare * compare)) / 64.0
    variance = sum_percent_sqr - sum_percent * sum_percent
    if bool(np.all(elements == 1)):
        return 100.0, variance
    if sum_percent <= 100.0:
        return (200.0 - sum_percent) / 2.0, variance
    return 5000.0 / sum_percent, variance


def estimate_quality(tables: dict) -> float | None:
    """Estimate quality from a {identifier: QuantizationTable} registry.

    Mirrors JpegDecoder.TryEstimateQuanlity (JpegDecoder.cs:169-195):
    luminance table 0 required, chrominance table 1 optional, result is
    min of the two, clamped to [0, 100].
    """
    lum = tables.get(0)
    if lum is None or lum.is_empty:
        return None
    quality, _ = estimate_quality_single(lum, standard_luminance_table())
    chrom = tables.get(1)
    if chrom is not None and not chrom.is_empty:
        quality2, _ = estimate_quality_single(chrom, standard_chrominance_table())
        quality = min(quality, quality2)
    return float(np.clip(quality, 0.0, 100.0))

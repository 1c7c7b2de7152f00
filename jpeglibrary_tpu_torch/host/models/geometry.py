"""Frame/scan geometry: MCU grids and per-component block planes.

This is the TPU-native replacement for the reference's per-block
callback pivot (JpegBlockOutputWriter / JpegBlockAllocator,
yigolden/JpegLibrary/src/JpegLibrary/JpegBlockAllocator.cs:35-84): instead of
pushing 8x8 blocks through a callback, every scan materializes dense
per-component coefficient planes ``int16[Hb, Wb, 64]`` (zig-zag order)
sized to the full MCU grid, which then feed the batched device kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from ..syntax.frame import FrameHeader


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class ComponentGeometry:
    """Block-plane geometry for one frame component."""

    component_index: int
    identifier: int
    h: int  # horizontal sampling factor
    v: int  # vertical sampling factor
    hs: int  # horizontal subsampling (max_h / h) — duplication factor on output
    vs: int  # vertical subsampling (max_v / v)
    blocks_per_line: int  # width of the coefficient plane in blocks (full MCU grid)
    blocks_per_column: int  # height of the coefficient plane in blocks


@dataclasses.dataclass(frozen=True)
class FrameGeometry:
    """MCU grid + per-component planes for a frame.

    Mirrors the values computed in
    JpegHuffmanBaselineScanDecoder's constructor
    (JpegHuffmanBaselineScanDecoder.cs:28-42).
    """

    width: int
    height: int
    precision: int
    max_h: int
    max_v: int
    mcus_per_line: int
    mcus_per_column: int
    components: Tuple[ComponentGeometry, ...]

    @property
    def level_shift(self) -> int:
        return 1 << (self.precision - 1)


def frame_geometry(frame: FrameHeader) -> FrameGeometry:
    max_h = frame.max_horizontal_sampling
    max_v = frame.max_vertical_sampling
    mcus_per_line = ceil_div(frame.samples_per_line, 8 * max_h)
    mcus_per_column = ceil_div(frame.number_of_lines, 8 * max_v)
    comps = []
    for idx, fc in enumerate(frame.components):
        h = fc.horizontal_sampling_factor
        v = fc.vertical_sampling_factor
        comps.append(
            ComponentGeometry(
                component_index=idx,
                identifier=fc.identifier,
                h=h,
                v=v,
                hs=max_h // h,
                vs=max_v // v,
                blocks_per_line=mcus_per_line * h,
                blocks_per_column=mcus_per_column * v,
            )
        )
    return FrameGeometry(
        width=frame.samples_per_line,
        height=frame.number_of_lines,
        precision=frame.sample_precision,
        max_h=max_h,
        max_v=max_v,
        mcus_per_line=mcus_per_line,
        mcus_per_column=mcus_per_column,
        components=tuple(comps),
    )


def allocate_coefficient_planes(geometry: FrameGeometry) -> Dict[int, np.ndarray]:
    """Dense zig-zag coefficient planes, one per component.

    The TPU-native analogue of JpegBlockAllocator.Allocate
    (JpegBlockAllocator.cs:35-84).
    """
    return {
        c.component_index: np.zeros(
            (c.blocks_per_column, c.blocks_per_line, 64), dtype=np.int16
        )
        for c in geometry.components
    }

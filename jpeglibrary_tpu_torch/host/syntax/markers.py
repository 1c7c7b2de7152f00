"""JPEG marker constants (ITU-T T.81 Table B.1).

Capability parity with the reference marker model
(yigolden/JpegLibrary/src/JpegLibrary/JpegMarker.cs:8-245,
 JpegMarkerHelper.cs:7), re-expressed as a Python IntEnum.
"""

from __future__ import annotations

import enum


class Marker(enum.IntEnum):
    """Second byte of a JPEG marker (the byte following 0xFF)."""

    # Padding (not a real marker; 0xFF fill bytes precede markers)
    PADDING = 0xFF

    # Start-of-frame markers, non-differential Huffman coding
    SOF0 = 0xC0  # Baseline DCT
    SOF1 = 0xC1  # Extended sequential DCT
    SOF2 = 0xC2  # Progressive DCT
    SOF3 = 0xC3  # Lossless (sequential)

    # Start-of-frame markers, differential Huffman coding
    SOF5 = 0xC5
    SOF6 = 0xC6
    SOF7 = 0xC7

    # Start-of-frame markers, arithmetic coding
    JPG = 0xC8
    SOF9 = 0xC9  # Extended sequential DCT, arithmetic
    SOF10 = 0xCA  # Progressive DCT, arithmetic
    SOF11 = 0xCB  # Lossless (sequential), arithmetic
    SOF13 = 0xCD
    SOF14 = 0xCE
    SOF15 = 0xCF

    # Huffman / arithmetic tables
    DHT = 0xC4  # Define Huffman table(s)
    DAC = 0xCC  # Define arithmetic coding conditioning(s)

    # Restart interval markers
    RST0 = 0xD0
    RST1 = 0xD1
    RST2 = 0xD2
    RST3 = 0xD3
    RST4 = 0xD4
    RST5 = 0xD5
    RST6 = 0xD6
    RST7 = 0xD7

    # Other markers
    SOI = 0xD8  # Start of image
    EOI = 0xD9  # End of image
    SOS = 0xDA  # Start of scan
    DQT = 0xDB  # Define quantization table(s)
    DNL = 0xDC  # Define number of lines
    DRI = 0xDD  # Define restart interval
    DHP = 0xDE  # Define hierarchical progression
    EXP = 0xDF  # Expand reference component(s)

    APP0 = 0xE0
    APP1 = 0xE1
    APP2 = 0xE2
    APP3 = 0xE3
    APP4 = 0xE4
    APP5 = 0xE5
    APP6 = 0xE6
    APP7 = 0xE7
    APP8 = 0xE8
    APP9 = 0xE9
    APP10 = 0xEA
    APP11 = 0xEB
    APP12 = 0xEC
    APP13 = 0xED
    APP14 = 0xEE
    APP15 = 0xEF

    COM = 0xFE  # Comment

    # JPEG extensions / reserved
    TEM = 0x01


#: SOF markers understood by the decoder dispatch
#: (reference: ScanDecoder/JpegScanDecoder.cs:18-36).
SUPPORTED_SOF_MARKERS = frozenset(
    {
        Marker.SOF0, Marker.SOF1, Marker.SOF2, Marker.SOF3,
        Marker.SOF9, Marker.SOF10, Marker.SOF11,
    }
)

ALL_SOF_MARKERS = frozenset(
    {
        Marker.SOF0, Marker.SOF1, Marker.SOF2, Marker.SOF3,
        Marker.SOF5, Marker.SOF6, Marker.SOF7,
        Marker.SOF9, Marker.SOF10, Marker.SOF11,
        Marker.SOF13, Marker.SOF14, Marker.SOF15,
    }
)


def is_restart_marker(marker: int) -> bool:
    """True for RST0-RST7 (reference: JpegMarkerHelper.cs:7)."""
    return Marker.RST0 <= marker <= Marker.RST7


#: Markers that carry no length-prefixed payload.
STANDALONE_MARKERS = frozenset(
    {
        Marker.SOI, Marker.EOI, Marker.TEM,
        Marker.RST0, Marker.RST1, Marker.RST2, Marker.RST3,
        Marker.RST4, Marker.RST5, Marker.RST6, Marker.RST7,
    }
)

"""Golden-fixture I/O: the reference's two-PNG 16-bit fixture format.

Format parity with the reference test helper
(yigolden/JpegLibrary/tests/JpegLibrary.Tests/Utils/ImageHelper.cs:12-91) and
the fixture generator (apps/JpegDebugDump/DebugDumpAction.cs:44-104):

- ``<asset>.high.png``: high byte of each 16-bit sample per channel.
- ``<asset>.low-diff.png``: low byte XOR-predicted by the high byte.
- reassembly: value = (high << 8) | (high ^ low_diff).

Both PNGs are RGBA; only the first ``num_components`` channels carry
data. The reassembled buffer is [H, W, 4] uint16 with unused channels
zero.
"""

from __future__ import annotations

import numpy as np


def _load_png_rgba(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"), dtype=np.uint8)


def load_expected_buffer(asset_path: str, num_components: int) -> np.ndarray:
    """Load a golden fixture pair next to ``asset_path``.

    Returns uint16 [H, W, 4] (channels beyond num_components are 0),
    matching ImageHelper.LoadBuffer's flat ushort[w*h*4] layout.
    """
    high = _load_png_rgba(asset_path + ".high.png")
    low_diff = _load_png_rgba(asset_path + ".low-diff.png")
    if high.shape != low_diff.shape:
        raise ValueError("Fixture PNG dimensions differ.")
    h, w, _ = high.shape
    buffer = np.zeros((h, w, 4), dtype=np.uint16)
    for n in range(num_components):
        hi = high[..., n].astype(np.uint16)
        lo = low_diff[..., n].astype(np.uint16)
        buffer[..., n] = (hi << 8) | (hi ^ lo)
    return buffer


def split_to_fixture(buffer16: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of load_expected_buffer: produce (high, low_diff) RGBA
    uint8 planes from a [H, W, C<=4] uint16 buffer — the JpegDebugDump
    generator (DebugDumpAction.cs:64-104), for writing our own goldens."""
    h, w, c = buffer16.shape
    high = np.zeros((h, w, 4), dtype=np.uint8)
    low_diff = np.zeros((h, w, 4), dtype=np.uint8)
    hi = (buffer16 >> 8).astype(np.uint8)
    lo = (buffer16 & 0xFF).astype(np.uint8)
    high[..., :c] = hi
    low_diff[..., :c] = hi ^ lo
    # alpha channels opaque for viewability, like the dump app
    high[..., 3] = 255 if c < 4 else high[..., 3]
    low_diff[..., 3] = 255 if c < 4 else low_diff[..., 3]
    return high, low_diff

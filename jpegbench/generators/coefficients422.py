"""What a baseline 4:2:2 JPEG encoder stores (a camera original, EXIF
``YCbCrSubSampling`` [2, 1]), made on the device: the quantised zig-zag
coefficient planes of RGB images, as a decoder's entropy scan hands them to
the transform. JFIF YCbCr in float, the image padded to whole 16 x 8 MCUs
by repeating its last row and column (as libjpeg pads), the chroma averaged
over each horizontal pair (2 x 1), the orthonormal FDCT and rounding to the
quantisation tables. The benchmark's own plain code."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .coefficients import _blocks

MCU = (16, 8)  # luma samples of an MCU across and down


def padded(width: int, height: int):
    """(width, height) rounded up to whole 16 x 8 MCUs."""
    return -(-width // MCU[0]) * MCU[0], -(-height // MCU[1]) * MCU[1]


def quantised_planes(rgb: torch.Tensor, qy: torch.Tensor, qc: torch.Tensor):
    """uint8 [n, h, w, 3] -> (y [n, Hb, Wb, 64], cb, cr [n, Hb, Wb/2, 64])
    int16 zig-zag, with (8 Wb, 8 Hb) = padded(w, h)."""
    n, h, w, _ = rgb.shape
    pw, ph = padded(w, h)
    x = rgb.permute(0, 3, 1, 2).to(torch.float32)
    x = F.pad(x, (0, pw - w, 0, ph - h), mode="replicate")
    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
    cb, cr = (c.reshape(n, ph, pw // 2, 2).mean(dim=-1) for c in (cb, cr))
    return _blocks(y, qy), _blocks(cb, qc), _blocks(cr, qc)

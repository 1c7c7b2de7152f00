"""What a baseline 4:2:0 JPEG encoder stores, made on the device: the
quantised zig-zag coefficient planes of RGB images, as a decoder's
entropy scan hands them to the transform. JFIF YCbCr in float, the image
padded to whole 16x16 MCUs by repeating its last row and column (as
libjpeg pads), the chroma averaged over 2x2, the orthonormal FDCT and
rounding to the quantisation tables. The benchmark's own plain code."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..reference import tables


def padded(size: int) -> int:
    """``size`` samples rounded up to whole 16-sample MCUs."""
    return -(-size // 16) * 16


def _blocks(plane: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
    """float32 [n, H, W] samples -> int16 [n, H/8, W/8, 64] zig-zag."""
    n, h, w = plane.shape
    rows = (plane - 128).reshape(n, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)
    basis = torch.from_numpy(tables.BASIS_ZZ.T.astype("float32")).to(plane.device)
    coef = rows.reshape(n, h // 8, w // 8, 64) @ basis
    return torch.round(coef / quant.to(torch.float32)).to(torch.int16)


def quantised_planes(rgb: torch.Tensor, qy: torch.Tensor, qc: torch.Tensor):
    """uint8 [n, h, w, 3] -> (y [n, Hb, Wb, 64], cb, cr [n, Hb/2, Wb/2, 64])
    int16 zig-zag, with Hb = padded(h) / 8, Wb = padded(w) / 8."""
    n, h, w, _ = rgb.shape
    x = rgb.permute(0, 3, 1, 2).to(torch.float32)
    x = F.pad(x, (0, padded(w) - w, 0, padded(h) - h), mode="replicate")
    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
    cb, cr = (F.avg_pool2d(c[:, None], 2)[:, 0] for c in (cb, cr))
    return _blocks(y, qy), _blocks(cb, qc), _blocks(cr, qc)

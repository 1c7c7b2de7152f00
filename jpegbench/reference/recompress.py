"""The plain reference of the re-encoding step, and the comparison that
decides ``correct`` for its cells.

The step takes a batch of 4:2:0 baseline JPEG coefficient planes (int16
zig-zag ``[B, Hb, Wb, 64]`` luma, ``[B, Hb/2, Wb/2, 64]`` Cb and Cr) and
their two zig-zag quantisation tables, and returns what the program's
``full_step`` returns:

- ``rgb`` uint8 ``[B, H, W, 3]``: dequantise, 2-D IDCT, round half to
  even, level shift +128, chroma upsampled by duplication, clamp to
  [0, 255], YCbCr -> RGB in 16-bit fixed point;
- ``requant_y`` int16 ``[B, Hb, Wb, 64]``: RGB -> YCbCr in 16-bit fixed
  point, level shift -128, 2-D FDCT, divide by the table, round half to
  even;
- ``hists`` ``[4, 256]``: the DC and AC Huffman symbol histograms of the
  luma (walked in 2x2 MCU order, one DC chain an image), then of the
  chroma (each component its own chain an image, raster order), after the
  chroma's 2x2 box ``(sum + 2) // 4``, FDCT and quantisation.

The transforms run in float64 (``precision="float64"``), or with their
products in TF32 (``"tf32"``: both operands rounded to TF32's 10-bit
mantissa, products summed in float32, as the tensor cores do), the
control one step below the float32 that the configurations state. This
module imports nothing of the program: it reads the program's outputs
only to judge them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from . import tables

PRECISIONS = ("float64", "tf32")
CHUNK_PIXELS = 1 << 24  # luma pixels per chunk of images the reference holds at once


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits), to nearest even."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & -0x2000
    return bits.view(torch.float32)


def _product(rows: torch.Tensor, matrix: np.ndarray, precision: str) -> torch.Tensor:
    """rows [..., 64] times a [64, 64] float64 matrix, at ``precision``."""
    if precision == "float64":
        return rows.to(torch.float64) @ torch.from_numpy(matrix).to(rows.device)
    if precision != "tf32":
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    m = to_tf32(torch.from_numpy(matrix.astype(np.float32)).to(rows.device))
    allowed = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the rounding above is the TF32 step
    try:
        return to_tf32(rows.to(torch.float32)) @ m
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed


def decode_plane(coeffs: torch.Tensor, quant: torch.Tensor, up: int, precision: str):
    """[B, Hb, Wb, 64] zig-zag coefficients -> uint8 [B, Hb*8*up, Wb*8*up]."""
    b, hb, wb, _ = coeffs.shape
    deq = coeffs.to(torch.int32) * quant.to(torch.int32)
    samples = torch.round(_product(deq, tables.BASIS_ZZ, precision)).to(torch.int32) + 128
    plane = samples.reshape(b, hb, wb, 8, 8).permute(0, 1, 3, 2, 4).reshape(b, hb * 8, wb * 8)
    if up > 1:
        h, w = plane.shape[1:]
        plane = plane[:, :, None, :, None].expand(b, h, up, w, up).reshape(b, h * up, w * up)
    return plane.clamp(0, 255).to(torch.uint8)


def ycbcr_to_rgb(y, cb, cr) -> torch.Tensor:
    """uint8 planes -> uint8 [..., 3] RGB, JFIF in 16-bit fixed point."""
    y = y.to(torch.int32)
    cb = cb.to(torch.int32) - 128
    cr = cr.to(torch.int32) - 128
    r = y + ((tables.CR_R * cr + tables.HALF) >> tables.SHIFT)
    g = y + ((tables.CB_G * cb + tables.HALF + tables.CR_G * cr) >> tables.SHIFT)
    b = y + ((tables.CB_B * cb + tables.HALF) >> tables.SHIFT)
    return torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)


def rgb_to_ycbcr(rgb: torch.Tensor):
    """uint8 [..., 3] RGB -> int32 Y, Cb, Cr planes in [0, 255]: round half
    up for Y; for the chroma the offset 128 and a half less one, which keeps
    them in range without a clamp."""
    r, g, b = (rgb[..., i].to(torch.int32) for i in range(3))
    bias = (128 << tables.SHIFT) + tables.HALF - 1
    y = (tables.Y_R * r + tables.Y_G * g + tables.Y_B * b + tables.HALF) >> tables.SHIFT
    cb = (tables.CB_R_ * r + tables.CB_G_ * g + tables.CB_B_ * b + bias) >> tables.SHIFT
    cr = (tables.CR_R_ * r + tables.CR_G_ * g + tables.CR_B_ * b + bias) >> tables.SHIFT
    return y, cb, cr


def box2x2(plane: torch.Tensor) -> torch.Tensor:
    """int32 [B, H, W] -> [B, H/2, W/2], the mean of each 2x2 box rounded
    half up."""
    b, h, w = plane.shape
    return (plane.reshape(b, h // 2, 2, w // 2, 2).sum(dim=(2, 4)) + 2) // 4


def encode_plane(plane: torch.Tensor, quant: torch.Tensor, precision: str) -> torch.Tensor:
    """int32 samples [B, H, W] -> int16 zig-zag coefficients [B, H/8, W/8, 64]."""
    b, h, w = plane.shape
    blocks = (plane - 128).reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)
    coef = _product(blocks.reshape(b, h // 8, w // 8, 64), tables.BASIS_ZZ.T, precision)
    return torch.round(coef / quant.to(coef.dtype)).to(torch.int16)


def mcu_order(plane: torch.Tensor, h: int, v: int) -> torch.Tensor:
    """[B, Hb, Wb, 64] -> [B, Hb*Wb, 64] in the order of an interleaved scan
    whose MCU holds v rows of h blocks of this component."""
    b, hb, wb, _ = plane.shape
    walk = plane.reshape(b, hb // v, v, wb // h, h, 64).permute(0, 1, 3, 2, 4, 5)
    return walk.reshape(b, hb * wb, 64)


def _size(values: torch.Tensor) -> torch.Tensor:
    """T.81's magnitude category of each integer: its bit length, 0 for 0."""
    return torch.frexp(values.to(torch.float64).abs()).exponent.to(torch.int64)


def histograms(chains: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[R, N, 64] zig-zag blocks, each row one DC chain starting from 0 ->
    (dc [256], ac [256]) int64 symbol counts of a baseline Huffman encode."""
    chains = chains.to(torch.int64)
    dc = chains[:, :, 0]
    diff = dc - torch.cat([torch.zeros_like(dc[:, :1]), dc[:, :-1]], dim=1)
    dc_hist = torch.bincount(_size(diff).reshape(-1), minlength=256)

    ac = chains[:, :, 1:].reshape(-1, 63)
    block, k = torch.nonzero(ac, as_tuple=True)  # row-major: blocks, then positions
    first = torch.ones_like(block, dtype=torch.bool)
    first[1:] = block[1:] != block[:-1]
    previous = torch.where(first, torch.full_like(k, -1), torch.roll(k, 1))
    run = k - previous - 1
    symbols = (run % 16) << 4 | _size(ac[block, k])
    ac_hist = torch.bincount(symbols, minlength=256)
    ac_hist[0xF0] += (run // 16).sum()
    ac_hist[0x00] += (ac[:, 62] == 0).sum()  # EOB: the block ends in zeros
    return dc_hist[:256], ac_hist[:256]


def _chunks(batch: int, pixels: int):
    per = max(1, CHUNK_PIXELS // pixels)
    return [slice(i, min(i + per, batch)) for i in range(0, batch, per)]


def _chunk(y, cb, cr, qy, qc, precision):
    """One chunk of images: (rgb, (requant_y, requant_cb, requant_cr))."""
    ys, cbs, crs = (decode_plane(c, q, up, precision)
                    for c, q, up in ((y, qy, 1), (cb, qc, 2), (cr, qc, 2)))
    rgb = ycbcr_to_rgb(ys, cbs, crs)
    y2, cb2, cr2 = rgb_to_ycbcr(rgb)
    return rgb, (encode_plane(y2, qy, precision), encode_plane(box2x2(cb2), qc, precision),
                 encode_plane(box2x2(cr2), qc, precision))


def step(y, cb, cr, qy, qc, precision: str = "float64"):
    """The whole step on the inputs' device: (rgb, requant_y, hists
    [4, 256] int64), as ``full_step`` returns them."""
    b, hb, wb, _ = y.shape
    rgbs, requants, hists = [], [], torch.zeros((4, 256), dtype=torch.int64, device=y.device)
    for part in _chunks(b, hb * wb * 64):
        rgb, (ry, rcb, rcr) = _chunk(y[part], cb[part], cr[part], qy, qc, precision)
        rgbs.append(rgb)
        requants.append(ry)
        hists += torch.stack([*histograms(mcu_order(ry, 2, 2)),
                              *histograms(torch.cat([mcu_order(rcb, 1, 1),
                                                     mcu_order(rcr, 1, 1)]))])
    return torch.cat(rgbs), torch.cat(requants), hists


def judge(inputs, outputs) -> Dict[str, float]:
    """The numbers compared for one step: ``inputs`` (y, cb, cr, qy, qc) as
    handed to the program, ``outputs`` (rgb, requant_y, hists) as it
    returned them, against the float64 reference:

    - ``rgb_diff_share``: the share of RGB values that differ;
    - ``requant_diff_share``: the share of requantised luma coefficients
      that differ;
    - ``luma_hist_bins_off``: the luma histogram bins that differ from the
      reference's count of the program's own ``requant_y`` (exact);
    - ``hist_l1_share``: the four histograms' L1 distance from the
      reference's counts of its own requantised planes, over the
      reference's count of symbols;
    - ``chroma_hist_l1_share``: the same of the chroma's two histograms
      alone. The chroma's requantised planes are no output of the step, so
      the chroma box, K2 on the chroma and K5's chroma walk are judged by
      these two numbers only.
    """
    y, cb, cr, qy, qc = inputs
    rgb, requant_y, hists = outputs
    b, hb, wb, _ = y.shape
    if tuple(rgb.shape) != (b, hb * 8, wb * 8, 3) or tuple(requant_y.shape) != tuple(y.shape):
        raise ValueError(f"outputs of shapes {tuple(rgb.shape)}, {tuple(requant_y.shape)} "
                         f"for inputs {tuple(y.shape)}")
    rgb_off = req_off = 0
    own = torch.zeros((2, 256), dtype=torch.int64, device=y.device)
    want = torch.zeros((4, 256), dtype=torch.int64, device=y.device)
    for part in _chunks(b, hb * wb * 64):
        want_rgb, (want_y, want_cb, want_cr) = _chunk(y[part], cb[part], cr[part], qy, qc,
                                                      "float64")
        d = rgb[part].to(want_rgb.device) != want_rgb
        rgb_off += int(d.sum())
        got_y = requant_y[part].to(want_y.device)
        d = got_y != want_y
        req_off += int(d.sum())
        own += torch.stack(histograms(mcu_order(got_y, 2, 2)))
        want += torch.stack([*histograms(mcu_order(want_y, 2, 2)),
                             *histograms(torch.cat([mcu_order(want_cb, 1, 1),
                                                    mcu_order(want_cr, 1, 1)]))])
    got = hists.to(y.device).to(torch.int64)
    return {
        "rgb_diff_share": rgb_off / rgb.numel(),
        "requant_diff_share": req_off / requant_y.numel(),
        "luma_hist_bins_off": float((got[:2] != own).sum()),
        "hist_l1_share": float((got - want).abs().sum()) / max(1, int(want.sum())),
        "chroma_hist_l1_share": (float((got[2:] - want[2:]).abs().sum())
                                 / max(1, int(want[2:].sum()))),
    }

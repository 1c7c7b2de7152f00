"""The plain reference of the re-encoding step at 4:2:2 (the chroma halved
across only, as camera originals mark it: EXIF ``YCbCrSubSampling`` [2, 1]),
and the comparison that decides ``correct`` for its cells.

The step takes a batch of 4:2:2 baseline JPEG coefficient planes (int16
zig-zag ``[B, Hb, Wb, 64]`` luma, ``[B, Hb, Wb/2, 64]`` Cb and Cr) and
their two zig-zag quantisation tables, and returns what the program's
``full_step`` returns:

- ``rgb`` uint8 ``[B, H, W, 3]``: dequantise, 2-D IDCT (the orthonormal
  basis worked out in extended precision), round half to even, level
  shift +128, the chroma duplicated 2 x 1 (across, not down), clamp to
  [0, 255], YCbCr -> RGB in 16-bit fixed point;
- ``requant_y`` int16 ``[B, Hb, Wb, 64]``: RGB -> YCbCr in 16-bit fixed
  point, level shift -128, 2-D FDCT, divide by the table, round half to
  even;
- ``hists`` ``[4, 256]``: the DC and AC Huffman symbol histograms of T.81's
  symbols, the luma walked in the interleaved scan's order of a (2, 1) MCU
  (two blocks across, one DC chain an image), then the chroma (each
  component its own chain an image, raster order), after the chroma's 2 x 1
  box ``(a + b + 1) // 2``, FDCT and quantisation.

The transforms run in float64 (``precision="float64"``), or with their
products in TF32 (``"tf32"``), the control one step below the float32 that
the configuration states. Plain PyTorch: it imports neither JAX nor
anything of the program, takes its transforms, colour conversions and
symbol counts from ``reference/recompress.py``, and reads the program's
outputs only to judge them. Importing it turns TF32 off for float32 matrix
products and convolutions (the control rounds to TF32 itself).
"""

from __future__ import annotations

from typing import Dict

import torch

from .recompress import (_chunks, decode_plane, encode_plane, histograms, mcu_order,
                         rgb_to_ycbcr, ycbcr_to_rgb)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PRECISIONS = ("float64", "tf32")
LUMA_MCU = (2, 1)  # (h, v): the luma blocks of a 4:2:2 MCU, two across


def upsample(plane: torch.Tensor) -> torch.Tensor:
    """uint8 chroma [B, H, W/2] -> [B, H, W]: each sample duplicated across."""
    return plane.repeat_interleave(2, dim=-1)


def box(plane: torch.Tensor) -> torch.Tensor:
    """int32 [B, H, W] -> [B, H, W/2], the mean of each horizontal pair
    rounded half up: ``(a + b + 1) // 2``."""
    b, h, w = plane.shape
    return (plane.reshape(b, h, w // 2, 2).sum(dim=-1) + 1) // 2


def _chunk(y, cb, cr, qy, qc, precision):
    """One chunk of images: (rgb, (requant_y, requant_cb, requant_cr))."""
    ys = decode_plane(y, qy, 1, precision)
    cbs, crs = (upsample(decode_plane(c, qc, 1, precision)) for c in (cb, cr))
    rgb = ycbcr_to_rgb(ys, cbs, crs)
    y2, cb2, cr2 = rgb_to_ycbcr(rgb)
    return rgb, (encode_plane(y2, qy, precision), encode_plane(box(cb2), qc, precision),
                 encode_plane(box(cr2), qc, precision))


def _hists(ry, rcb, rcr) -> torch.Tensor:
    """[4, 256]: the luma's DC and AC counts in its MCU walk, the chroma's."""
    return torch.stack([*histograms(mcu_order(ry, *LUMA_MCU)),
                        *histograms(torch.cat([mcu_order(rcb, 1, 1), mcu_order(rcr, 1, 1)]))])


def _check_shapes(y, cb, cr) -> None:
    b, hb, wb, _ = y.shape
    if wb % 2 or tuple(cb.shape[:3]) != (b, hb, wb // 2) or cr.shape != cb.shape:
        raise ValueError(f"4:2:2 needs chroma [B, Hb, Wb/2, 64] with Wb even, got luma "
                         f"{tuple(y.shape)}, chroma {tuple(cb.shape)} and {tuple(cr.shape)}")


def step(y, cb, cr, qy, qc, precision: str = "float64"):
    """The whole step on the inputs' device: (rgb, requant_y, hists
    [4, 256] int64), as ``full_step`` returns them."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    _check_shapes(y, cb, cr)
    b, hb, wb, _ = y.shape
    rgbs, requants, hists = [], [], torch.zeros((4, 256), dtype=torch.int64, device=y.device)
    for part in _chunks(b, hb * wb * 64):
        rgb, requant = _chunk(y[part], cb[part], cr[part], qy, qc, precision)
        rgbs.append(rgb)
        requants.append(requant[0])
        hists += _hists(*requant)
    return torch.cat(rgbs), torch.cat(requants), hists


def judge(inputs, outputs) -> Dict[str, float]:
    """The numbers compared for one step: ``inputs`` (y, cb, cr, qy, qc) as
    handed to the program, ``outputs`` (rgb, requant_y, hists) as it
    returned them, against the float64 reference:

    - ``rgb_diff_share``: the share of RGB values that differ;
    - ``requant_diff_share``: the share of requantised luma coefficients
      that differ;
    - ``luma_hist_bins_off``: the luma histogram bins that differ from the
      reference's count of the program's own ``requant_y`` in the (2, 1)
      walk (exact);
    - ``hist_l1_share``: the four histograms' L1 distance from the
      reference's counts of its own requantised planes, over the
      reference's count of symbols;
    - ``chroma_hist_l1_share``: the same of the chroma's two histograms
      alone. The chroma's requantised planes are no output of the step, so
      the 2 x 1 box, K2 on the chroma and K5's chroma walk are judged by
      these two numbers only.
    """
    y, cb, cr, qy, qc = inputs
    rgb, requant_y, hists = outputs
    _check_shapes(y, cb, cr)
    b, hb, wb, _ = y.shape
    if tuple(rgb.shape) != (b, hb * 8, wb * 8, 3) or tuple(requant_y.shape) != tuple(y.shape):
        raise ValueError(f"outputs of shapes {tuple(rgb.shape)}, {tuple(requant_y.shape)} "
                         f"for inputs {tuple(y.shape)}")
    rgb_off = req_off = 0
    own = torch.zeros((2, 256), dtype=torch.int64, device=y.device)
    want = torch.zeros((4, 256), dtype=torch.int64, device=y.device)
    for part in _chunks(b, hb * wb * 64):
        want_rgb, want_requant = _chunk(y[part], cb[part], cr[part], qy, qc, "float64")
        rgb_off += int((rgb[part].to(want_rgb.device) != want_rgb).sum())
        got_y = requant_y[part].to(y.device)
        req_off += int((got_y != want_requant[0]).sum())
        own += torch.stack(histograms(mcu_order(got_y, *LUMA_MCU)))
        want += _hists(*want_requant)
    got = hists.to(y.device).to(torch.int64)
    return {
        "rgb_diff_share": rgb_off / rgb.numel(),
        "requant_diff_share": req_off / requant_y.numel(),
        "luma_hist_bins_off": float((got[:2] != own).sum()),
        "hist_l1_share": float((got - want).abs().sum()) / max(1, int(want.sum())),
        "chroma_hist_l1_share": (float((got[2:] - want[2:]).abs().sum())
                                 / max(1, int(want[2:].sum()))),
    }

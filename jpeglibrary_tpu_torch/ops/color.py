"""YCbCr <-> RGB with the reference's 16-bit fixed-point arithmetic.

Port of ``jpeglibrary_tpu/ops/color.py``, both directions, bit-exact: the
same constants, int32 products, arithmetic ``>>`` and clamps.
"""

from __future__ import annotations

import numpy as np
import torch

_SHIFT = 16
_ONE_HALF = 1 << (_SHIFT - 1)


def _fix(x) -> int:
    """Fixed-point constant: float32 times 2^16 in float32, plus 0.5 in
    double, truncated toward zero."""
    return int(float(np.float32(x) * np.float32(1 << _SHIFT)) + 0.5)


_LR, _LG, _LB = np.float32(0.299), np.float32(0.587), np.float32(0.114)
_F1 = np.float32(2) - np.float32(2) * _LR
_F3 = np.float32(2) - np.float32(2) * _LB
_D1 = _fix(_F1)  # Cr -> R
_D2 = -_fix(_LR * _F1 / _LG)  # Cr -> G
_D3 = _fix(_F3)  # Cb -> B
_D4 = -_fix(_LB * _F3 / _LG)  # Cb -> G


def ycbcr_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor):
    """uint8 Y/Cb/Cr planes -> (r, g, b) uint8 planes."""
    y = y.to(torch.int32)
    x_cb = cb.to(torch.int32) - 128
    x_cr = cr.to(torch.int32) - 128
    cr_r = (_D1 * x_cr + _ONE_HALF) >> _SHIFT
    cb_b = (_D3 * x_cb + _ONE_HALF) >> _SHIFT
    g_off = ((_D4 * x_cb + _ONE_HALF) + _D2 * x_cr) >> _SHIFT
    r = (y + cr_r).clamp(0, 255).to(torch.uint8)
    g = (y + g_off).clamp(0, 255).to(torch.uint8)
    b = (y + cb_b).clamp(0, 255).to(torch.uint8)
    return r, g, b


# Encode side: the RGB -> YCbCr converter's constants.
_Y_R = _fix(float(np.float32(0.299)))
_Y_G = _fix(float(np.float32(0.587)))
_Y_B = _fix(float(np.float32(0.114)))
_CB_R = -_fix(float(np.float32(0.168735892)))
_CB_G = -_fix(float(np.float32(0.331264108)))
_CB_B = _fix(float(np.float32(0.5)))  # also Cr <- R
_CR_G = -_fix(float(np.float32(0.418687589)))
_CR_B = -_fix(float(np.float32(0.081312411)))
_CBCR_OFFSET = 128 << _SHIFT


def rgb_to_ycbcr(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """uint8 R/G/B planes -> (y, cb, cr) uint8 planes, with the
    reference's 0.5-epsilon rounding fudge that makes a clamp
    unnecessary; the int32 results are cast as the JAX version casts
    them."""
    r = r.to(torch.int32)
    g = g.to(torch.int32)
    b = b.to(torch.int32)
    fudge = _CBCR_OFFSET + _ONE_HALF - 1
    y = (_Y_R * r + _Y_G * g + (_Y_B * b + _ONE_HALF)) >> _SHIFT
    cb = (_CB_R * r + _CB_G * g + (_CB_B * b + fudge)) >> _SHIFT
    cr = ((_CB_B * r + fudge) + _CR_G * g + _CR_B * b) >> _SHIFT
    return y.to(torch.uint8), cb.to(torch.uint8), cr.to(torch.uint8)

"""YCbCr -> RGB with the reference's 16-bit fixed-point arithmetic.

Port of ``jpeglibrary_tpu/ops/color.py`` (decode side), bit-exact: the
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

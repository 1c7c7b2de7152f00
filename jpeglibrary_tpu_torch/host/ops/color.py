"""Color conversion: YCbCr <-> RGB with exact fixed-point parity.

The reference keeps color conversion in the apps, not the core library
(yigolden/JpegLibrary/apps/JpegDecode/JpegYCbCrToRgbConverter.cs:25-205 and
 yigolden/JpegLibrary/apps/JpegEncode/JpegRgbToYCbCrConverter.cs:26-95).
Both use 16-bit fixed-point LUTs; the LUT contents are affine functions
of the input byte, so on TPU we evaluate the same arithmetic directly as
vector ops (the VPU has no gather advantage for a 256-entry LUT) —
results are bit-identical to the reference tables.

All functions accept ``xp`` (numpy or jax.numpy) and operate on integer
arrays of any shape (broadcast over pixels).
"""

from __future__ import annotations

import numpy as np

_SHIFT = 16
_ONE_HALF = 1 << (_SHIFT - 1)


def _fix(x) -> int:
    """Fixed-point constant, Fix() in both reference converters: the
    float32 value is multiplied by 2^16 in float32 (C# float * long),
    then + 0.5 in double, truncated toward zero."""
    return int(float(np.float32(x) * np.float32(1 << _SHIFT)) + 0.5)


# Decode side (JpegYCbCrToRgbConverter.Init, JpegYCbCrToRgbConverter.cs:67-122):
# luma = (0.299, 0.587, 0.114); with the default ReferenceBlackWhite the
# Code2V maps are identity, so the tables reduce to these constants.
_LR, _LG, _LB = np.float32(0.299), np.float32(0.587), np.float32(0.114)
_F1 = np.float32(2) - np.float32(2) * _LR
_F3 = np.float32(2) - np.float32(2) * _LB
_D1 = _fix(_F1)  # Cr -> R
_D2 = -_fix(_LR * _F1 / _LG)  # Cr -> G
_D3 = _fix(_F3)  # Cb -> B
_D4 = -_fix(_LB * _F3 / _LG)  # Cb -> G


def ycbcr_to_rgb(y, cb, cr, xp=np):
    """uint8 Y/Cb/Cr planes -> (r, g, b) uint8, bit-exact vs the
    reference converter (ConvertYCbCr8ToRgb24,
    JpegYCbCrToRgbConverter.cs:174-205)."""
    y = y.astype(xp.int32)
    x_cb = cb.astype(xp.int32) - 128
    x_cr = cr.astype(xp.int32) - 128
    cr_r = (_D1 * x_cr + _ONE_HALF) >> _SHIFT
    cb_b = (_D3 * x_cb + _ONE_HALF) >> _SHIFT
    g_off = ((_D4 * x_cb + _ONE_HALF) + _D2 * x_cr) >> _SHIFT
    r = xp.clip(y + cr_r, 0, 255).astype(xp.uint8)
    g = xp.clip(y + g_off, 0, 255).astype(xp.uint8)
    b = xp.clip(y + cb_b, 0, 255).astype(xp.uint8)
    return r, g, b


# Encode side (JpegRgbToYCbCrConverter ctor, JpegRgbToYCbCrConverter.cs:37-57).
_Y_R = _fix(float(np.float32(0.299)))
_Y_G = _fix(float(np.float32(0.587)))
_Y_B = _fix(float(np.float32(0.114)))
_CB_R = -_fix(float(np.float32(0.168735892)))
_CB_G = -_fix(float(np.float32(0.331264108)))
_CB_B = _fix(float(np.float32(0.5)))  # also Cr<-R ("B=>Cb and R=>Cr tables are the same")
_CR_G = -_fix(float(np.float32(0.418687589)))
_CR_B = -_fix(float(np.float32(0.081312411)))
_CBCR_OFFSET = 128 << _SHIFT


def rgb_to_ycbcr(r, g, b, xp=np):
    """uint8 R/G/B -> (y, cb, cr) uint8, bit-exact vs the reference
    converter (ConvertRgb24ToYCbCr8, JpegRgbToYCbCrConverter.cs:66-95),
    including the 0.5-epsilon rounding fudge that makes range limiting
    unnecessary."""
    r = r.astype(xp.int32)
    g = g.astype(xp.int32)
    b = b.astype(xp.int32)
    fudge = _CBCR_OFFSET + _ONE_HALF - 1
    y = (_Y_R * r + _Y_G * g + (_Y_B * b + _ONE_HALF)) >> _SHIFT
    cb = (_CB_R * r + _CB_G * g + (_CB_B * b + fudge)) >> _SHIFT
    cr = ((_CB_B * r + fudge) + _CR_G * g + _CR_B * b) >> _SHIFT
    return y.astype(xp.uint8), cb.astype(xp.uint8), cr.astype(xp.uint8)

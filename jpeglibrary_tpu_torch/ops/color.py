"""YCbCr <-> RGB with the reference's 16-bit fixed-point arithmetic.

Port of ``jpeglibrary_tpu/ops/color.py``, both directions, bit-exact: the
same constants, int32 products, arithmetic ``>>`` and clamps.

:func:`round_trip_420_plain` is the plain version of K6
(``kernels.color_round_trip``): ``full_step``'s chain from K1's 4:2:0
samples to the RGB output and K2's planes, composed of the functions here
and in ``decode_stage``. :data:`ROUND_TRIP_CONSTANTS` are the constants the
kernel is handed.
"""

from __future__ import annotations

import numpy as np
import torch

from . import decode_stage

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


def round_trip_420_plain(y_samples: torch.Tensor, cb_samples: torch.Tensor,
                         cr_samples: torch.Tensor):
    """K1's int32 4:2:0 samples, luma [B, Hb, Wb, 8, 8] and each chroma
    [B, Hb/2, Wb/2, 8, 8], -> (rgb uint8 [B, H, W, 3], y, cb, cr uint8
    [B, H, W]): each component laid out as a plane, the chroma duplicated
    2x2, clamped to [0, 255], converted to RGB and back to YCbCr, in the
    order of the JAX step (``jpeglibrary_tpu/parallel/sharding.py:70-117``)."""
    y8, cb8, cr8 = (
        decode_stage.clamp_to_uint8(
            decode_stage.upsample_duplicate(decode_stage.blocks_to_plane(s), up, up))
        for s, up in ((y_samples, 1), (cb_samples, 2), (cr_samples, 2))
    )
    r, g, b = ycbcr_to_rgb(y8, cb8, cr8)
    return (torch.stack([r, g, b], dim=-1), *rgb_to_ycbcr(r, g, b))


# K6's constants, in the order of ``csrc/color_round_trip.cu``'s
# ``RoundTripConstants``: the decode's three chroma terms with the -128 of
# each chroma sample folded into their offsets, then the encode's
# products and offsets.
ROUND_TRIP_CONSTANTS = (
    _D1, _ONE_HALF - 128 * _D1,                         # cr_r
    _D3, _ONE_HALF - 128 * _D3,                         # cb_b
    _D4, _D2, _ONE_HALF - 128 * (_D4 + _D2),            # g_off
    _Y_R, _Y_G, _Y_B, _ONE_HALF,                        # y
    _CB_R, _CB_G, _CB_B, _CBCR_OFFSET + _ONE_HALF - 1,  # cb
    _CR_G, _CR_B,                                       # cr (its R product is _CB_B)
)

"""The constants of baseline JPEG that the reference and the input
generators share: the zig-zag order, the orthonormal 8x8 DCT, the
quantisation tables of ITU-T T.81 Annex K with IJG quality scaling, and
the 16-bit fixed-point colour constants of the upstream JpegLibrary's
converters. Plain numpy; nothing here comes from the program."""

from __future__ import annotations

import numpy as np

# ZIGZAG[k] is the natural (row * 8 + column) index of zig-zag position k.
ZIGZAG = np.array(sorted(range(64), key=lambda p: (
    p // 8 + p % 8, p // 8 if (p // 8 + p % 8) % 2 else p % 8)))

_u = np.arange(8)[:, None]
# DCT[u, x]: the orthonormal DCT-II, T.81's A.3.3 with its 1/4 C(u) C(v).
DCT = np.sqrt(np.where(_u == 0, 1 / 8, 2 / 8)) * np.cos(
    (2 * np.arange(8)[None, :] + 1) * _u * np.pi / 16)


def _basis_zz() -> np.ndarray:
    """The 2-D basis, [64 zig-zag, 64 natural], each entry the float64
    nearest its true value: worked out in extended precision, so that the
    entries that are exact in binary (the DC's 1/8 among them) are exact,
    and a sum that is exactly a half in true arithmetic stays a half."""
    u = np.arange(8, dtype=np.longdouble)[:, None]
    x = np.arange(8, dtype=np.longdouble)[None, :]
    pi = np.arctan(np.longdouble(1)) * 4
    d = np.sqrt(np.where(u == 0, np.longdouble(1) / 8, np.longdouble(2) / 8)) * np.cos(
        (2 * x + 1) * u * pi / 16)
    return np.kron(d, d)[ZIGZAG].astype(np.float64)


# Row vectors of 64 samples (natural order) times BASIS_ZZ.T give the
# zig-zag coefficients; zig-zag coefficients times BASIS_ZZ give samples.
BASIS_ZZ = _basis_zz()

# T.81 Annex K, tables K.1 and K.2, natural order.
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.full(64, 99)
CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]


def quant_tables_zz(quality: int):
    """(luma, chroma) int32 [64] zig-zag tables at IJG ``quality``."""
    if not 1 <= quality <= 100:
        raise ValueError(f"quality must be 1..100, got {quality}")
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((q * scale + 50) // 100, 1, 255)[ZIGZAG].astype(np.int32)
                 for q in (LUMA_Q, CHROMA_Q))


# YCbCr -> RGB (JFIF): round(2^16 x) of Cr->R 1.402, Cr->G -0.714136,
# Cb->B 1.772 and Cb->G -0.344136, each as the upstream library forms it
# in float32 arithmetic.
CR_R, CR_G, CB_B, CB_G = 91881, -46802, 116130, -22553
# RGB -> YCbCr: round(2^16 x) of 0.299, 0.587, 0.114; -0.168735892,
# -0.331264108, 0.5; 0.5, -0.418687589, -0.081312411.
Y_R, Y_G, Y_B = 19595, 38470, 7471
CB_R_, CB_G_, CB_B_ = -11058, -21710, 32768
CR_R_, CR_G_, CR_B_ = 32768, -27439, -5329
SHIFT = 16
HALF = 1 << (SHIFT - 1)

"""Batched 8x8 forward/inverse DCT with the exact float32 AAN-style
butterfly dataflow of the reference
(yigolden/JpegLibrary/src/JpegLibrary/FastFloatingPointDCT.cs:54-364).

Design notes (TPU-first):

- The butterfly is pure elementwise float32 adds/muls over the batch:
  each stage combines whole rows ``x[..., k, :]``. On TPU this runs on
  the VPU; with blocks laid out ``[N, 8, 8]`` XLA tiles N*8 across
  sublanes and keeps every op an 8-lane-friendly vector op. We keep the
  *identical operation order* as the reference so that float32 results
  are bit-identical (IEEE-754 add/mul, no FMA contraction, no
  reassociation) — this is what makes whole-pipeline decode output
  exactly equal to the reference's committed golden fixtures.

- The same function body serves NumPy (host golden path) and
  jax.numpy (device path): only +, -, * and stacking are used.

The transform works on the *row index* axis (a 1-D transform of each
column); the 2-D transform is transpose -> 1-D -> transpose -> 1-D ->
scale by 1/8, exactly like TransformIDCT/TransformFDCT.
"""

from __future__ import annotations

import numpy as np

# Constants from FastFloatingPointDCT.cs:19-45 (float32 literals).
_C_1_175876 = np.float32(1.175875602)
_C_1_961571 = np.float32(-1.961570560)
_C_0_390181 = np.float32(-0.390180644)
_C_0_899976 = np.float32(-0.899976223)
_C_2_562915 = np.float32(-2.562915447)
_C_0_298631 = np.float32(0.298631336)
_C_2_053120 = np.float32(2.053119869)
_C_3_072711 = np.float32(3.072711026)
_C_1_501321 = np.float32(1.501321110)
_C_0_541196 = np.float32(0.541196100)
_C_1_847759 = np.float32(-1.847759065)
_C_0_765367 = np.float32(0.765366865)
_C_0_125 = np.float32(0.125)

# FDCT constants (FastFloatingPointDCT.cs:198-232).
_F_0_541196 = np.float32(0.541196)
_F_1_306563 = np.float32(1.306563)
_F_1_175876 = np.float32(1.175876)
_F_0_785695 = np.float32(0.785695)
_F_1_387040 = np.float32(1.387040)
_F_0_275899 = np.float32(0.275899)
_F_0_707107 = np.float32(0.707107)


def _idct_1d(x, xp):
    """One 1-D IDCT pass along axis -2 (row index), batched.

    Mirrors IDCT8x4_LeftPart/RightPart (which differ only in which lane
    half they touch; vectorized over all lanes here).
    """
    my1 = x[..., 1, :]
    my7 = x[..., 7, :]
    mz0 = my1 + my7

    my3 = x[..., 3, :]
    mz2 = my3 + my7
    my5 = x[..., 5, :]
    mz1 = my3 + my5
    mz3 = my1 + my5

    mz4 = (mz0 + mz1) * _C_1_175876

    mz2 = (mz2 * _C_1_961571) + mz4
    mz3 = (mz3 * _C_0_390181) + mz4
    mz0 = mz0 * _C_0_899976
    mz1 = mz1 * _C_2_562915

    mb3 = (my7 * _C_0_298631) + mz0 + mz2
    mb2 = (my5 * _C_2_053120) + mz1 + mz3
    mb1 = (my3 * _C_3_072711) + mz1 + mz2
    mb0 = (my1 * _C_1_501321) + mz0 + mz3

    my2 = x[..., 2, :]
    my6 = x[..., 6, :]
    mz4 = (my2 + my6) * _C_0_541196
    my0 = x[..., 0, :]
    my4 = x[..., 4, :]
    mz0 = my0 + my4
    mz1 = my0 - my4

    mz2 = mz4 + (my6 * _C_1_847759)
    mz3 = mz4 + (my2 * _C_0_765367)

    my0 = mz0 + mz3
    my3 = mz0 - mz3
    my1 = mz1 + mz2
    my2 = mz1 - mz2

    return xp.stack(
        [
            my0 + mb0,
            my1 + mb1,
            my2 + mb2,
            my3 + mb3,
            my3 - mb3,
            my2 - mb2,
            my1 - mb1,
            my0 - mb0,
        ],
        axis=-2,
    )


def _fdct_1d(x, xp):
    """One 1-D FDCT pass along axis -2, mirroring FDCT8x4_LeftPart/RightPart."""
    c0 = x[..., 0, :]
    c1 = x[..., 7, :]
    t0 = c0 + c1
    t7 = c0 - c1

    c1 = x[..., 6, :]
    c0 = x[..., 1, :]
    t1 = c0 + c1
    t6 = c0 - c1

    c1 = x[..., 5, :]
    c0 = x[..., 2, :]
    t2 = c0 + c1
    t5 = c0 - c1

    c0 = x[..., 3, :]
    c1 = x[..., 4, :]
    t3 = c0 + c1
    t4 = c0 - c1

    c0 = t0 + t3
    c3 = t0 - t3
    c1 = t1 + t2
    c2 = t1 - t2

    d0 = c0 + c1
    d4 = c0 - c1

    d2 = (_F_0_541196 * c2) + (_F_1_306563 * c3)
    d6 = (_F_0_541196 * c3) - (_F_1_306563 * c2)

    c3 = (_F_1_175876 * t4) + (_F_0_785695 * t7)
    c0 = (_F_1_175876 * t7) - (_F_0_785695 * t4)

    c2 = (_F_1_387040 * t5) + (_F_0_275899 * t6)
    c1 = (_F_1_387040 * t6) - (_F_0_275899 * t5)

    d3 = c0 - c2
    d5 = c3 - c1

    c0 = (c0 + c2) * _F_0_707107
    c3 = (c3 + c1) * _F_0_707107

    d1 = c0 + c3
    d7 = c0 - c3

    return xp.stack([d0, d1, d2, d3, d4, d5, d6, d7], axis=-2)


def _transpose(x, xp):
    return xp.swapaxes(x, -1, -2)


def idct8x8(blocks, xp=np):
    """2-D IDCT of float32 blocks [..., 8, 8] (natural order).

    Matches FastFloatingPointDCT.TransformIDCT exactly:
    transpose -> 1-D -> transpose -> 1-D -> * 0.125.
    """
    x = _transpose(blocks, xp)
    x = _idct_1d(x, xp)
    x = _transpose(x, xp)
    x = _idct_1d(x, xp)
    return x * _C_0_125


def fdct8x8(blocks, xp=np):
    """2-D FDCT of float32 blocks [..., 8, 8] (natural order).

    Matches FastFloatingPointDCT.TransformFDCT(src, dest, temp):
    transpose -> 1-D -> transpose -> 1-D -> * 0.125.
    """
    x = _transpose(blocks, xp)
    x = _fdct_1d(x, xp)
    x = _transpose(x, xp)
    x = _fdct_1d(x, xp)
    return x * _C_0_125

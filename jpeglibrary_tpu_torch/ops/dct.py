"""The float32 AAN butterfly 8x8 IDCT and FDCT in PyTorch.

Port of ``jpeglibrary_tpu/ops/dct.py`` (``idct8x8``, ``fdct8x8``), the
reference's FastFloatingPointDCT in its exact operation order. Every
product, sum and difference is one PyTorch op on float32 tensors, so each
rounds once, as IEEE add and multiply do, and nothing is reassociated or
fused: on any device the results equal the numpy and XLA versions bit for
bit. The constants are the host copy's float32 values.

:func:`idct8x8` is the plain version of K4 (``kernels.butterfly_idct_shift``,
``csrc/butterfly_idct.cu``), which computes the same operations in the
same order with ``__fmul_rn`` / ``__fadd_rn`` / ``__fsub_rn``.
:func:`fdct8x8` serves the butterfly route of the device FDCT
(``encode_stage.fdct_quantize_butterfly``).

Each 1-D pass transforms along axis -2 (the row index); the 2-D transform
is transpose -> 1-D -> transpose -> 1-D -> * 0.125.
"""

from __future__ import annotations

import torch

from ..host.ops import dct as _host

_C_1_175876 = float(_host._C_1_175876)
_C_1_961571 = float(_host._C_1_961571)
_C_0_390181 = float(_host._C_0_390181)
_C_0_899976 = float(_host._C_0_899976)
_C_2_562915 = float(_host._C_2_562915)
_C_0_298631 = float(_host._C_0_298631)
_C_2_053120 = float(_host._C_2_053120)
_C_3_072711 = float(_host._C_3_072711)
_C_1_501321 = float(_host._C_1_501321)
_C_0_541196 = float(_host._C_0_541196)
_C_1_847759 = float(_host._C_1_847759)
_C_0_765367 = float(_host._C_0_765367)
_C_0_125 = float(_host._C_0_125)

_F_0_541196 = float(_host._F_0_541196)
_F_1_306563 = float(_host._F_1_306563)
_F_1_175876 = float(_host._F_1_175876)
_F_0_785695 = float(_host._F_0_785695)
_F_1_387040 = float(_host._F_1_387040)
_F_0_275899 = float(_host._F_0_275899)
_F_0_707107 = float(_host._F_0_707107)


def _idct_1d(x: torch.Tensor) -> torch.Tensor:
    """One 1-D IDCT pass along axis -2: IDCT8x4_LeftPart/RightPart."""
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

    return torch.stack(
        [my0 + mb0, my1 + mb1, my2 + mb2, my3 + mb3,
         my3 - mb3, my2 - mb2, my1 - mb1, my0 - mb0],
        dim=-2,
    )


def _fdct_1d(x: torch.Tensor) -> torch.Tensor:
    """One 1-D FDCT pass along axis -2: FDCT8x4_LeftPart/RightPart."""
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

    return torch.stack([d0, d1, d2, d3, d4, d5, d6, d7], dim=-2)


def idct8x8(blocks: torch.Tensor) -> torch.Tensor:
    """2-D IDCT of float32 blocks ``[..., 8, 8]`` (natural order):
    transpose -> 1-D -> transpose -> 1-D -> * 0.125, as
    FastFloatingPointDCT.TransformIDCT."""
    x = _idct_1d(blocks.transpose(-1, -2))
    x = _idct_1d(x.transpose(-1, -2))
    return x * _C_0_125


def fdct8x8(blocks: torch.Tensor) -> torch.Tensor:
    """2-D FDCT of float32 blocks ``[..., 8, 8]`` (natural order):
    transpose -> 1-D -> transpose -> 1-D -> * 0.125, as
    FastFloatingPointDCT.TransformFDCT."""
    x = _fdct_1d(blocks.transpose(-1, -2))
    x = _fdct_1d(x.transpose(-1, -2))
    return x * _C_0_125

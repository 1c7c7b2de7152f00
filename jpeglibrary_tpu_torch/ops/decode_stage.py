"""Decode transform stage in PyTorch: zig-zag coefficient blocks ->
sample planes -> 8-bit output.

Port of ``jpeglibrary_tpu/ops/decode_stage.py`` (the parts the device
transform runs: the scaled decode's reduced IDCT, libjpeg's fancy
upsampling and the 16-bit extending writer included). The integer ops
are bit-exact against the numpy originals, computed in int32 whatever
the output type; :func:`dequantize_idct_shift`
is the plain PyTorch version of the K1 kernel (``ops/kernels.py``) and,
like the Pallas kernel and the XLA matvecs it mirrors, is within 1
sample LSB of the butterfly IDCT and of the JAX scaled transform.

The bit-exact decode (``JpegDecoder.decode(xp=...)`` with a torch device,
the JAX package's ``xp=jnp``) runs :func:`decode_components_to_planes`:
per component one upload, K4 (``kernels.butterfly_idct_shift``: the
butterfly IDCT of ``ops/dct.py`` in the reference's operation order),
duplicate upsampling and the crop. :func:`dequantize_idct_shift_exact`
is K4's plain version; its planes equal the host numpy planes bit for bit.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..host.models.geometry import FrameGeometry
from ..host.ops.zigzag import BLOCK_TO_ZIGZAG
from . import dct, kernels


def dequantize_idct_shift(coeffs_zz: torch.Tensor, quants_zz: torch.Tensor,
                          blocks_per_table: int, level_shift: int,
                          matrix: torch.Tensor) -> torch.Tensor:
    """[N, 64] zig-zag coefficients + [G, 64] zig-zag quant tables ->
    int32 samples [N, n, n]; block t dequantizes with table
    ``t // blocks_per_table``.

    ``matrix`` is the [64, n*n] fp32 folded map: at n = 8 un-zigzag +
    IDCT (``kernels.fused_transform_matrix``), at n = 4, 2, 1 the reduced
    IDCT of the scaled decode (``scaled_folded_matrix``). The int32
    product converts to fp32 with one rounding, as ``fl(c) * fl(q)`` does
    in the kernels; rounding is half to even (``torch.round``). On a CUDA
    tensor it raises while TF32 matmuls are allowed: TF32 keeps a 10-bit
    mantissa and breaks the 1-LSB contract, and the process-wide setting
    is the caller's to change. This is the port of the JAX
    ``dequantize_idct_shift_scaled`` and, over a batch of images, of the
    vmapped K1."""
    if coeffs_zz.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the plain K1 version needs full fp32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )
    coeffs = coeffs_zz.reshape(-1, 64).to(torch.int32)
    quants = quants_zz.reshape(-1, 64).to(torch.int32)
    if coeffs.shape[0] > blocks_per_table:
        table = torch.arange(coeffs.shape[0], device=coeffs.device) // blocks_per_table
        quants = quants[table]
    deq = (coeffs * quants).to(torch.float32)
    pixels = deq @ matrix
    samples = torch.round(pixels).to(torch.int32) + level_shift
    n = int(round(matrix.shape[1] ** 0.5))
    return samples.reshape(-1, n, n)


def dequantize_idct_shift_exact(coeffs_zz: torch.Tensor, quant_zz: torch.Tensor,
                                level_shift: int) -> torch.Tensor:
    """[..., 64] zig-zag coefficients + [64] zig-zag quant table -> int32
    samples [..., 8, 8], bit for bit the JAX package's
    ``dequantize_idct_shift``: the int32 product, the un-zigzag gather, one
    rounding to float32, the butterfly ``dct.idct8x8``, rint (half to
    even, ``torch.round``) and the level shift. K4's plain version."""
    deq = coeffs_zz.to(torch.int32) * quant_zz.to(torch.int32)  # exact int32
    gather = torch.as_tensor(BLOCK_TO_ZIGZAG, dtype=torch.int64, device=deq.device)
    natural = deq.index_select(-1, gather)  # natural[j] = zigzag[BLOCK_TO_ZIGZAG[j]]
    blocks = natural.reshape(natural.shape[:-1] + (8, 8)).to(torch.float32)
    return torch.round(dct.idct8x8(blocks)).to(torch.int32) + level_shift


def component_plane(coeffs_zz: torch.Tensor, quant_zz: torch.Tensor, level_shift: int,
                    hs: int, vs: int, height: int, width: int) -> torch.Tensor:
    """One component's bit-exact decode transform: [Hb, Wb, 64] zig-zag
    coefficients -> the cropped int32 plane [height, width], through K4
    (``kernels.butterfly_idct_shift``; its plain version on the CPU), then
    duplicate upsampling by (hs, vs) and the crop. The port of the JAX
    ``component_plane``."""
    plane = kernels.butterfly_idct_shift(coeffs_zz, quant_zz, level_shift)
    return upsample_duplicate(plane, hs, vs)[:height, :width]


def decode_components_to_planes(coefficient_planes, quant_tables_zz,
                                geometry: FrameGeometry, device) -> Dict[int, torch.Tensor]:
    """Every component's coefficient plane (numpy ``[Hb, Wb, 64]``, int16
    as the host decoder writes them) and zig-zag quant table -> cropped
    int32 sample planes [H, W] on ``device``, by component index: the JAX
    ``decode_components_to_planes`` on a torch device. One upload per
    component plane (the quant tables go up together), one K4 launch per
    component on the card."""
    device = torch.device(device)
    comps = geometry.components
    quants = np.stack([np.asarray(quant_tables_zz[c.component_index]) for c in comps])
    quants = torch.from_numpy(quants.astype(np.int32)).to(device)
    out = {}
    for cg, quant in zip(comps, quants):
        coeffs = torch.as_tensor(np.ascontiguousarray(coefficient_planes[cg.component_index]))
        out[cg.component_index] = component_plane(
            coeffs.to(device), quant, geometry.level_shift, cg.hs, cg.vs,
            geometry.height, geometry.width)
    return out


def blocks_to_plane(samples: torch.Tensor) -> torch.Tensor:
    """[..., Hb, Wb, n, n] -> [..., Hb*n, Wb*n]."""
    *lead, hb, wb, n, _ = samples.shape
    return samples.transpose(-3, -2).reshape(*lead, hb * n, wb * n)


def upsample_duplicate(plane: torch.Tensor, hs: int, vs: int) -> torch.Tensor:
    """Nearest-neighbour duplication upsample of ``[..., H, W]`` planes
    (each sample repeated ``vs`` times down and ``hs`` times across)."""
    if vs != 1:
        plane = plane.repeat_interleave(vs, dim=-2)
    if hs != 1:
        plane = plane.repeat_interleave(hs, dim=-1)
    return plane


def _fancy_double_w(p: torch.Tensor) -> torch.Tensor:
    """Double the last axis with libjpeg's h2v1 triangular weights; the
    replicated edges give jdsample.c's first and last columns."""
    left = torch.cat([p[..., :1], p[..., :-1]], dim=-1)
    right = torch.cat([p[..., 1:], p[..., -1:]], dim=-1)
    even = (3 * p + left + 1) >> 2
    odd = (3 * p + right + 2) >> 2
    return torch.stack([even, odd], dim=-1).reshape(*p.shape[:-1], -1)


def upsample_fancy(plane: torch.Tensor, hs: int, vs: int) -> torch.Tensor:
    """libjpeg's triangular ("fancy") upsampling of ``[..., h, w]`` planes
    of clamped samples, in int32: jdsample.c's h2v1_fancy_upsample at
    (2, 1) and h2v2_fancy_upsample at (2, 2), with replicated edges and
    the +1/+2 and +8/+7 biases; every other factor duplicates, as libjpeg
    selects. Bit-exact against ``decode_stage.upsample_fancy``."""
    p = plane.to(torch.int32)
    if hs == 2 and vs == 1:
        return _fancy_double_w(p)
    if hs == 2 and vs == 2:
        up = torch.cat([p[..., :1, :], p[..., :-1, :]], dim=-2)
        down = torch.cat([p[..., 1:, :], p[..., -1:, :]], dim=-2)
        # Output row 2v blends input rows (v, v-1) 3:1 and row 2v+1 rows
        # (v, v+1): jdsample.c's thiscolsum chain.
        t = torch.stack([3 * p + up, 3 * p + down], dim=-2)
        t = t.reshape(*p.shape[:-2], 2 * p.shape[-2], p.shape[-1])
        left = torch.cat([t[..., :1], t[..., :-1]], dim=-1)
        right = torch.cat([t[..., 1:], t[..., -1:]], dim=-1)
        even = (3 * t + left + 8) >> 4
        odd = (3 * t + right + 7) >> 4
        return torch.stack([even, odd], dim=-1).reshape(*t.shape[:-1], -1)
    return upsample_duplicate(p, hs, vs)


def extend_to_uint16(plane: torch.Tensor, precision: int) -> torch.Tensor:
    """The 16-bit extending writer: each int32 sample taken as a ushort
    (``& 0xFFFF``, so a negative one wraps high and clamps to the top),
    clamped to ``2^precision - 1``, bit-expanded to 16 bits, and cast
    once to ``torch.uint16``. Bit-exact against
    ``decode_stage.extend_to_uint16``."""
    max_value = (1 << precision) - 1
    bits = (plane.to(torch.int32) & 0xFFFF).clamp(max=max_value)
    if precision >= 8:
        r = 16 - precision
        bits = (bits << r) | (bits & ((1 << r) - 1))
    else:
        current = precision
        while current < 16:
            bits = (bits << precision) | bits
            current += precision
        if current > 16:
            bits = bits >> precision
            current -= precision
            bits = (bits << (16 - current)) | (bits & ((1 << (16 - current)) - 1))
    return bits.to(torch.uint16)


def clamp_to_uint8(plane: torch.Tensor) -> torch.Tensor:
    """8-bit writer: clamp to [0, 255]."""
    return plane.clamp(0, 255).to(torch.uint8)


def normalize_to_uint8(plane: torch.Tensor, precision: int) -> torch.Tensor:
    """Precision-aware 8-bit output: 8-bit clamps; >8-bit shifts right by
    p-8, then clamps; <8-bit clamps to [0, 2^p - 1], then bit-expands to
    8 bits. ``plane`` is int32."""
    if precision == 8:
        return clamp_to_uint8(plane)
    if precision > 8:
        return (plane >> (precision - 8)).clamp(0, 255).to(torch.uint8)
    bits = plane.clamp(0, (1 << precision) - 1)
    current = precision
    while current < 8:
        bits = (bits << precision) | bits
        current += precision
    if current > 8:
        bits = bits >> precision
        current -= precision
        remaining = 8 - current
        bits = (bits << remaining) | (bits & ((1 << remaining) - 1))
    return bits.to(torch.uint8)

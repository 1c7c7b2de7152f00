"""Device transform of the v2 split-stream wire: payload -> planar RGB.

Port of ``jpeglibrary_tpu/ops/pipeline.py`` ``jitted_transform_mcu2_inner``
with the ``transform_to_rgb8`` duplicate-upsample, full-scale branch and
``_transform_planes``. PyTorch runs it eagerly, one op after another, on
the payload's device; K1 (``kernels.dequantize_idct_shift``) does the
per-component dequantize + IDCT.
"""

from __future__ import annotations

from typing import List

import torch

from jpeglibrary_tpu.models.geometry import FrameGeometry

from . import color, decode_stage, kernels


def densify_mcu2(payload_u8: torch.Tensor, geometry: FrameGeometry) -> List[torch.Tensor]:
    """v2 payload -> per-component zig-zag coefficient planes
    ``[Hb, Wb, 64]`` int32, on the payload's device.

    The payload is one flat uint8 buffer
    ``[dc i16*NB][counts u8*NB][acpos u8*Bn][acval i8*Bn][exc i32*2*Be]``
    (``native.scanner.decode_image_sparse2``); NB follows from the
    geometry and Bn from the length, K = 3*NB + 17*Bn/8."""
    comps = geometry.components
    mr, mc = geometry.mcus_per_column, geometry.mcus_per_line
    bpm = sum(c.h * c.v for c in comps)
    nb = mr * mc * bpm
    k = payload_u8.shape[0]
    bn = (k - 3 * nb) * 8 // 17
    be = bn // 64
    if k != 3 * nb + 2 * bn + 8 * be:
        raise ValueError(f"payload of {k} bytes is no v2 wire for {nb} blocks")
    dev = payload_u8.device
    # A dtype view needs a storage offset divisible by the item size; the
    # exception block starts at 3*NB + 2*Bn, so it is copied out first.
    dc = payload_u8[: 2 * nb].clone().view(torch.int16).to(torch.int32)
    counts = payload_u8[2 * nb : 3 * nb].to(torch.int64)
    acpos = payload_u8[3 * nb : 3 * nb + bn].to(torch.int64)
    acval = payload_u8[3 * nb + bn : 3 * nb + 2 * bn].view(torch.int8).to(torch.int32)
    exc = payload_u8[3 * nb + 2 * bn :].clone().view(torch.int32).reshape(be, 2)

    # Segment expansion: a marker at each block's first entry slot, then
    # a prefix sum gives every entry its block id. Blocks that start at or
    # after the end of the AC bucket have no entries; their markers land
    # in one spare slot past the end, which is cut off (JAX drops the
    # out-of-bounds scatter; index_add_ would raise).
    starts = (torch.cumsum(counts, 0) - counts).clamp_(max=bn)
    seg = torch.zeros(bn + 1, dtype=torch.int64, device=dev)
    seg.index_add_(0, starts, torch.ones_like(starts))
    block_id = (torch.cumsum(seg[:bn], 0) - 1).clamp_(0, nb - 1)
    dense = torch.zeros(nb * 64, dtype=torch.int32, device=dev)
    dense.index_add_(0, block_id * 64 + acpos, acval)
    dense.index_add_(0, exc[:, 0].to(torch.int64), exc[:, 1])
    dense = dense.view(nb, 64)
    dense[:, 0] += dc

    # MCU un-interleave: MCU m holds each component's h*v blocks in turn.
    per_mcu = dense.view(mr * mc, 64 * bpm)
    planes = []
    off = 0
    for c in comps:
        size = c.h * c.v * 64
        blk = (
            per_mcu[:, off : off + size]
            .reshape(mr, mc, c.v, c.h, 64)
            .permute(0, 2, 1, 3, 4)
            .reshape(mr * c.v, mc * c.h, 64)
            .contiguous()
        )
        planes.append(blk)
        off += size
    return planes


def transform_mcu2(payload_u8, quants, geometry: FrameGeometry,
                   device) -> torch.Tensor:
    """v2 payload + stacked ``[C, 64]`` int32 zig-zag quant tables ->
    planar uint8 RGB ``[3, H, W]`` on ``device`` (inputs that are not
    there yet are copied there). Gray images replicate Y with
    Cb = Cr = 128."""
    payload_u8 = torch.as_tensor(payload_u8, device=device)
    quants = torch.as_tensor(quants, dtype=torch.int32, device=device)
    coeffs = densify_mcu2(payload_u8, geometry)
    u8 = []
    for cg, cz, qz in zip(geometry.components, coeffs, quants):
        samples = kernels.dequantize_idct_shift(cz, qz.contiguous(), geometry.level_shift)
        plane = decode_stage.blocks_to_plane(samples)
        plane = decode_stage.upsample_duplicate(plane, cg.hs, cg.vs)
        plane = plane[: geometry.height, : geometry.width]
        u8.append(decode_stage.normalize_to_uint8(plane, geometry.precision))
    if len(u8) == 1:
        half = torch.full_like(u8[0], 128)
        r, g, b = color.ycbcr_to_rgb(u8[0], half, half)
    elif len(u8) == 3:
        r, g, b = color.ycbcr_to_rgb(*u8)
    else:
        raise ValueError(f"RGB output needs 1 or 3 components, got {len(u8)}.")
    return torch.stack([r, g, b], dim=0)

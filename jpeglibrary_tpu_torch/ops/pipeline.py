"""Device transform of the decode: coefficient payloads -> planar RGB.

Port of ``jpeglibrary_tpu/ops/pipeline.py``: the densify of each wire
(``jitted_transform_mcu2_inner`` for the v2 split-stream wire,
``jitted_transform_mcu_inner`` for the v1 MCU wire,
``jitted_transform_delta`` for the v1 plane-order wire,
``jitted_transform_packed`` for the numpy (flat index, value) wire of
``host/ops/pipeline.pack_sparse``, and the dense
``jitted_transform``), and the shared tails ``transform_to_rgb8`` (with
duplicate or libjpeg's fancy upsampling) and ``transform_to_u16`` (the
16-bit extending writer, ``output="u16"``), at full size and, for RGB
with duplicate upsampling, at the scaled decode's 1/2, 1/4 and 1/8. PyTorch runs it eagerly, one op after another, on the inputs'
device; K1 (``kernels.dequantize_idct_shift``) does each component's
dequantize + IDCT.

Every step takes a batch of same-geometry images stacked on a leading
axis and runs each op once for the whole batch (one K1 launch per
component, each image with its own quant tables). The stacked form of
the ``transform_*`` entry points is the port of the vmapped programs of
``jpeglibrary_tpu.parallel.batch`` (``_batched_mcu_transform2``,
``_batched_mcu_transform``, ``_batched_transform_delta`` and
``_batched_transform``); given one image's inputs without the batch axis
they return one image.

JAX wraps a negative scatter index and drops one out of bounds, where
``index_add_`` raises: every index that may fall outside goes to a spare
slot past the end, which is cut off.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..host.models.geometry import FrameGeometry
from . import color, decode_stage, kernels


def _mcu_planes(dense: torch.Tensor, geometry: FrameGeometry) -> List[torch.Tensor]:
    """MCU un-interleave: ``[B, NB*64]`` coefficients in MCU order (MCU m
    holds each component's h*v blocks in turn) -> per-component
    ``[B, Hb, Wb, 64]`` planes."""
    comps = geometry.components
    mr, mc = geometry.mcus_per_column, geometry.mcus_per_line
    b = dense.shape[0]
    per_mcu = dense.reshape(b, mr * mc, 64 * sum(c.h * c.v for c in comps))
    planes = []
    off = 0
    for c in comps:
        size = c.h * c.v * 64
        planes.append(
            per_mcu[:, :, off : off + size]
            .reshape(b, mr, mc, c.v, c.h, 64)
            .permute(0, 1, 3, 2, 4, 5)
            .reshape(b, mr * c.v, mc * c.h, 64)
            .contiguous()
        )
        off += size
    return planes


def densify_mcu2(payload_u8: torch.Tensor, geometry: FrameGeometry) -> List[torch.Tensor]:
    """Stacked v2 payloads ``[B, K]`` uint8 -> per-component zig-zag
    coefficient planes ``[B, Hb, Wb, 64]`` int32, on the payload's device.

    Each payload is ``[dc i16*NB][counts u8*NB][acpos u8*Bn][acval i8*Bn]
    [exc i32*2*Be]`` (``native.scanner.decode_image_sparse2``, stacked at
    one AC bucket by ``rebucket_v2_payload``); NB follows from the
    geometry and Bn from the length, K = 3*NB + 17*Bn/8. One segment
    expansion covers the whole batch, block ids offset by b*NB."""
    comps = geometry.components
    nb = geometry.mcus_per_column * geometry.mcus_per_line * sum(c.h * c.v for c in comps)
    b, k = payload_u8.shape
    bn = (k - 3 * nb) * 8 // 17
    be = bn // 64
    if k != 3 * nb + 2 * bn + 8 * be:
        raise ValueError(f"payload of {k} bytes is no v2 wire for {nb} blocks")
    dev = payload_u8.device
    # A dtype view needs contiguous rows at an aligned storage offset; the
    # DC and exception blocks are copied out first.
    dc = payload_u8[:, : 2 * nb].clone(memory_format=torch.contiguous_format)
    dc = dc.view(torch.int16).to(torch.int32)
    counts = payload_u8[:, 2 * nb : 3 * nb].to(torch.int64)
    acpos = payload_u8[:, 3 * nb : 3 * nb + bn].to(torch.int64)
    acval = payload_u8[:, 3 * nb + bn : 3 * nb + 2 * bn].view(torch.int8).to(torch.int32)
    exc = payload_u8[:, 3 * nb + 2 * bn :].clone(memory_format=torch.contiguous_format)
    exc = exc.view(torch.int32).reshape(b, be, 2)
    row = torch.arange(b, device=dev)[:, None]

    # Segment expansion: a marker at each block's first entry slot, then a
    # prefix sum gives every entry its block id. Blocks that start at or
    # after the end of an image's AC bucket have no entries; their markers
    # land in that image's spare slot, past its bucket, which no entry
    # reads (JAX drops the out-of-bounds scatter). Bucket padding entries
    # (pos 0, val 0) add zero to some block. Both prefix sums run over the
    # flattened batch (a scan along a row of a [B, n] tensor is many times
    # slower on the card than one over a flat one): each image holds
    # exactly NB markers, block 0's at its slot 0, so the running count
    # at an entry of image b is b*NB plus its block's index in the image,
    # which is the global block id JAX clips to [0, NB).
    ends = torch.cumsum(counts.reshape(-1), 0).view(b, nb)
    before = ends[:, -1:] - counts.sum(1, keepdim=True)  # AC entries of the images before
    starts = (ends - counts - before).clamp_(max=bn) + row * (bn + 1)
    seg = torch.zeros(b * (bn + 1), dtype=torch.int64, device=dev)
    seg.index_add_(0, starts.reshape(-1), torch.ones_like(starts).reshape(-1))
    block_id = (torch.cumsum(seg, 0) - 1).view(b, bn + 1)[:, :bn]
    dense = torch.zeros(b * nb * 64, dtype=torch.int32, device=dev)
    dense.index_add_(0, (block_id * 64 + acpos).reshape(-1), acval.reshape(-1))
    dense.index_add_(0, (exc[..., 0].to(torch.int64) + row * (nb * 64)).reshape(-1),
                     exc[..., 1].reshape(-1))
    dense = dense.view(b * nb, 64)
    dense[:, 0] += dc.reshape(-1)
    return _mcu_planes(dense.view(b, nb * 64), geometry)


def _scatter_deltas(packed_i16: torch.Tensor, total: int) -> torch.Tensor:
    """Stacked v1 entries ``[B, 2n]`` int16, interleaved (delta uint16,
    value int16) -> ``[B, total]`` int32 coefficients.

    Positions are ``cumsum(delta) - 1`` along each image: the packer starts
    from -1. Bucket padding (0, 0) and escapes (0xFFFF, 0) add zero. A
    position outside ``[0, total)`` (the padding of an image with no
    coefficient sits at -1) goes to one spare slot past the batch."""
    b = packed_i16.shape[0]
    if packed_i16.shape[1] % 2:
        raise ValueError(f"v1 entries come in pairs, got {packed_i16.shape[1]} values")
    pairs = packed_i16.reshape(b, -1, 2)
    deltas = pairs[..., 0].to(torch.int32) & 0xFFFF  # uint16 bits in int16 storage
    vals = pairs[..., 1].to(torch.int32)
    # One prefix sum over the flattened batch (see densify_mcu2), less the
    # deltas of the images before.
    ends = torch.cumsum(deltas.reshape(-1), 0, dtype=torch.int64).view(b, -1)
    pos = ends - (ends[:, -1:] - deltas.sum(1, keepdim=True, dtype=torch.int64)) - 1
    row = torch.arange(b, device=pos.device)[:, None]
    spare = b * total
    idx = torch.where((pos >= 0) & (pos < total), pos + row * total, spare)
    dense = torch.zeros(spare + 1, dtype=torch.int32, device=pos.device)
    dense.index_add_(0, idx.reshape(-1), vals.reshape(-1))
    return dense[:spare].view(b, total)


def densify_mcu(packed_i16: torch.Tensor, geometry: FrameGeometry) -> List[torch.Tensor]:
    """Stacked v1 MCU-wire payloads ``[B, 2n]`` int16
    (``native.scanner.decode_image_sparse``: positions run in entropy-decode
    order, MCU by MCU) -> per-component ``[B, Hb, Wb, 64]`` int32 planes."""
    cpm = 64 * sum(c.h * c.v for c in geometry.components)
    total = geometry.mcus_per_column * geometry.mcus_per_line * cpm
    return _mcu_planes(_scatter_deltas(packed_i16, total), geometry)


def densify_delta(packed_i16: torch.Tensor, geometry: FrameGeometry) -> List[torch.Tensor]:
    """Stacked v1 plane-order payloads ``[B, 2n]`` int16
    (``native.scanner.pack_sparse`` of the component planes, concatenated
    in component order; what ``DecodeResult.prepack`` gives progressive,
    arithmetic, restart and multi-scan streams) -> per-component
    ``[B, Hb, Wb, 64]`` int32 planes."""
    shapes = [(c.blocks_per_column, c.blocks_per_line) for c in geometry.components]
    total = sum(64 * hb * wb for hb, wb in shapes)
    dense = _scatter_deltas(packed_i16, total)
    planes = []
    off = 0
    for hb, wb in shapes:
        planes.append(dense[:, off : off + 64 * hb * wb].reshape(-1, hb, wb, 64).contiguous())
        off += 64 * hb * wb
    return planes


UPSAMPLES = ("duplicate", "fancy")
OUTPUTS = ("rgb8", "u16")  # of the wire transforms; transform_dense adds "rgb8p"


def _component_samples(cz: torch.Tensor, quants: torch.Tensor, i: int,
                       geometry: FrameGeometry, scale_n: int = 8) -> torch.Tensor:
    """Component i's K1 launch for the whole batch -> its int32 sample
    plane ``[B, Hb*n, Wb*n]`` at its own resolution."""
    samples = kernels.dequantize_idct_shift(
        cz, quants[:, i].contiguous(), geometry.level_shift,
        blocks_per_table=cz.shape[1] * cz.shape[2], scale_n=scale_n,
    )
    return decode_stage.blocks_to_plane(samples)


def transform_to_rgb8(coeffs: Sequence[torch.Tensor], quants: torch.Tensor,
                      geometry: FrameGeometry, *, scale_n: int = 8,
                      upsample: str = "duplicate") -> torch.Tensor:
    """Per-component zig-zag coefficient planes ``[B, Hb, Wb, 64]`` (int32
    or int16) + ``[B, C, 64]`` int32 zig-zag quant tables -> planar uint8
    RGB ``[B, 3, H', W']`` with ``H' = ceil(H * n / 8)``, n = ``scale_n``.

    One K1 launch per component for the whole batch, at n = 8 the full
    IDCT and at n = 4, 2, 1 the reduced one (the scaled decode); then
    duplicate upsampling, which at n < 8 comes after the reduced IDCT as
    in the JAX ``component_plane_scaled``, crop, the precision-aware 8-bit
    writer and fixed-point YCbCr -> RGB. Gray images replicate Y with
    Cb = Cr = 128.

    ``upsample="fancy"`` (full size only, as in JAX) crops each
    component to its own ``ceil(H/vs) x ceil(W/hs)`` grid, normalises it
    to 8 bits and upsamples it with libjpeg's triangular filter
    (``decode_stage.upsample_fancy``) before the crop to H x W."""
    if upsample not in UPSAMPLES:
        raise ValueError(f"upsample must be one of {UPSAMPLES}, got {upsample!r}")
    if upsample == "fancy" and scale_n != 8:
        raise ValueError("fancy upsampling is full-resolution only")
    out_h = -(-geometry.height * scale_n // 8)
    out_w = -(-geometry.width * scale_n // 8)
    u8 = []
    for i, (cg, cz) in enumerate(zip(geometry.components, coeffs)):
        plane = _component_samples(cz, quants, i, geometry, scale_n)
        if upsample == "fancy":
            hc, wc = -(-geometry.height // cg.vs), -(-geometry.width // cg.hs)
            p8 = decode_stage.normalize_to_uint8(plane[:, :hc, :wc], geometry.precision)
            plane = decode_stage.upsample_fancy(p8, cg.hs, cg.vs)[:, :out_h, :out_w]
            u8.append(plane.to(torch.uint8))
            continue
        plane = decode_stage.upsample_duplicate(plane, cg.hs, cg.vs)
        plane = plane[:, :out_h, :out_w]
        u8.append(decode_stage.normalize_to_uint8(plane, geometry.precision))
    if len(u8) == 1:
        half = torch.full_like(u8[0], 128)
        r, g, b = color.ycbcr_to_rgb(u8[0], half, half)
    elif len(u8) == 3:
        r, g, b = color.ycbcr_to_rgb(*u8)
    else:
        raise ValueError(f"RGB output needs 1 or 3 components, got {len(u8)}.")
    return torch.stack([r, g, b], dim=1)


def transform_to_u16(coeffs: Sequence[torch.Tensor], quants: torch.Tensor,
                     geometry: FrameGeometry) -> torch.Tensor:
    """As :func:`transform_to_rgb8`, to the 16-bit extending writer's
    output (the golden-fixture format): for each component one K1 launch,
    duplicate upsampling, the crop to H x W and ``extend_to_uint16``;
    ``[B, H, W, C]`` uint16 for any C (CMYK too), no colour conversion."""
    ext = []
    for i, (cg, cz) in enumerate(zip(geometry.components, coeffs)):
        plane = _component_samples(cz, quants, i, geometry)
        plane = decode_stage.upsample_duplicate(plane, cg.hs, cg.vs)
        plane = plane[:, :geometry.height, :geometry.width]
        ext.append(decode_stage.extend_to_uint16(plane, geometry.precision))
    return torch.stack(ext, dim=-1)


def _tail(coeffs, quants, geometry: FrameGeometry, scale_n: int, upsample: str,
          output: str) -> torch.Tensor:
    """The shared tail for ``output`` "rgb8" (planar RGB) or "u16"
    (``[B, H, W, C]``, full size; the JAX package's u16 output has
    duplicate upsampling whatever ``upsample`` says, and so has this)."""
    if output == "rgb8":
        return transform_to_rgb8(coeffs, quants, geometry, scale_n=scale_n, upsample=upsample)
    if output != "u16":
        raise ValueError(f"output must be one of {OUTPUTS}, got {output!r}")
    if scale_n != 8:
        raise ValueError("the u16 output is full-resolution only")
    return transform_to_u16(coeffs, quants, geometry)


def _wire_transform(densify, wire, quants, geometry: FrameGeometry, device,
                    scale_n: int, upsample: str, output: str) -> torch.Tensor:
    """Copy a wire and its quant tables to ``device``, densify, and run
    the shared tail. Without a batch axis on ``quants`` ([C, 64]) the wire
    is one image's, and so is the result."""
    quants = torch.as_tensor(quants, dtype=torch.int32, device=device)
    wire = torch.as_tensor(wire, device=device)
    single = quants.dim() == 2
    if single:
        wire, quants = wire[None], quants[None]
    out = _tail(densify(wire, geometry), quants, geometry, scale_n, upsample, output)
    return out[0] if single else out


def transform_mcu2(payload_u8, quants, geometry: FrameGeometry, device, *,
                   scale_n: int = 8, upsample: str = "duplicate",
                   output: str = "rgb8") -> torch.Tensor:
    """v2 payload ``[K]`` uint8 + ``[C, 64]`` int32 zig-zag quant tables ->
    planar uint8 RGB ``[3, H', W']`` on ``device`` (inputs that are not
    there yet are copied there); stacked ``[B, K]`` + ``[B, C, 64]`` ->
    ``[B, 3, H', W']``. ``output="u16"`` gives ``[H, W, C]`` uint16
    instead (:func:`transform_to_u16`), the JAX ``output="u16"``."""
    return _wire_transform(densify_mcu2, payload_u8, quants, geometry, device, scale_n,
                           upsample, output)


def transform_mcu(packed_i16, quants, geometry: FrameGeometry, device, *,
                  scale_n: int = 8, upsample: str = "duplicate",
                  output: str = "rgb8") -> torch.Tensor:
    """As :func:`transform_mcu2` for the v1 MCU wire, ``[2n]`` or
    ``[B, 2n]`` int16."""
    return _wire_transform(densify_mcu, packed_i16, quants, geometry, device, scale_n,
                           upsample, output)


def transform_delta(packed_i16, quants, geometry: FrameGeometry, device, *,
                    scale_n: int = 8, upsample: str = "duplicate",
                    output: str = "rgb8") -> torch.Tensor:
    """As :func:`transform_mcu2` for the v1 plane-order wire, ``[2n]`` or
    ``[B, 2n]`` int16."""
    return _wire_transform(densify_delta, packed_i16, quants, geometry, device, scale_n,
                           upsample, output)


def transform_packed(packed_i32, quants, geometry: FrameGeometry, device, *,
                     output: str = "rgb8", upsample: str = "duplicate") -> torch.Tensor:
    """One image's numpy packer wire, ``[2n]`` int32 interleaved (flat
    index, value) pairs over the concatenated component planes
    (``host/ops/pipeline.pack_sparse``), + ``[C, 64]`` int32 zig-zag quant
    tables -> planar uint8 RGB ``[3, H, W]`` on ``device``, or ``[H, W,
    C]`` uint16 with ``output="u16"``: the port of
    ``jitted_transform_packed``. The pairs are scatter-added into zeroed
    planes (the bucket padding adds 0 at index 0), then the shared tail
    runs (K1 per component)."""
    shapes = [(c.blocks_per_column, c.blocks_per_line) for c in geometry.components]
    total = sum(64 * hb * wb for hb, wb in shapes)
    pairs = torch.as_tensor(packed_i32, dtype=torch.int32, device=device).reshape(-1, 2)
    quants = torch.as_tensor(quants, dtype=torch.int32, device=device)
    dense = torch.zeros(total, dtype=torch.int32, device=pairs.device)
    dense.index_add_(0, pairs[:, 0].to(torch.int64), pairs[:, 1])
    planes = []
    off = 0
    for hb, wb in shapes:
        planes.append(dense[off : off + 64 * hb * wb].view(1, hb, wb, 64))
        off += 64 * hb * wb
    return _tail(planes, quants[None], geometry, 8, upsample, output)[0]


def transform_dense(coeffs: Sequence, quants, geometry: FrameGeometry, device, *,
                    scale_n: int = 8, upsample: str = "duplicate",
                    output: str = "rgb8p") -> torch.Tensor:
    """As :func:`transform_mcu2` for dense coefficient planes, one per
    component, ``[Hb, Wb, 64]`` or stacked ``[B, Hb, Wb, 64]`` (int16 or
    int32): the port of ``jitted_transform(geometry, output, upsample)``,
    whose ``output`` is "rgb8p" (planar), "rgb8" (``[H, W, 3]``) or
    "u16" (``[H, W, C]``)."""
    if output not in ("rgb8p", *OUTPUTS):
        raise ValueError(f"output must be one of {('rgb8p', *OUTPUTS)}, got {output!r}")
    quants = torch.as_tensor(quants, dtype=torch.int32, device=device)
    planes = [torch.as_tensor(p, device=device) for p in coeffs]
    single = quants.dim() == 2
    if single:
        planes, quants = [p[None] for p in planes], quants[None]
    out = _tail(planes, quants, geometry, scale_n, upsample, "u16" if output == "u16" else "rgb8")
    if output == "rgb8":
        out = out.permute(0, 2, 3, 1).contiguous()
    return out[0] if single else out

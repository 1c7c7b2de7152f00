"""Encode transform stage in PyTorch: sample planes -> quantized zig-zag
coefficient planes.

Port of ``jpeglibrary_tpu/ops/encode_stage.py`` (the parts the device
encode runs, ``jitted_forward``): zero-pad to the MCU grid, box-filter
subsample, then level shift + folded FDCT + zig-zag + quantize. On the
card all of it is K2 (``kernels.fdct_quantize``), one launch per
component. The integer ops are bit-exact against the numpy originals;
:func:`pad_to_grid` -> :func:`subsample_box` -> :func:`fdct_quantize` is
the plain PyTorch version of K2 and, like the Pallas kernel it mirrors,
is within 1 LSB of the butterfly FDCT.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from . import kernels


def pad_to_grid(plane: torch.Tensor, height_padded: int, width_padded: int) -> torch.Tensor:
    """Zero-pad a [H, W] plane to the MCU-aligned size (zeros, not the
    edge samples, as the JAX package pads)."""
    h, w = plane.shape
    if h == height_padded and w == width_padded:
        return plane
    out = plane.new_zeros((height_padded, width_padded))
    out[:h, :w] = plane
    return out


def subsample_box(plane: torch.Tensor, hs: int, vs: int) -> torch.Tensor:
    """Box-filter downsample by (hs, vs) with round-half-up,
    ``(sum + n//2) // n`` for n = hs*vs, in int32. Input dims must
    divide evenly. A 1x1 box returns the plane as it is: K2 takes uint8
    samples too, so a full-resolution 8-bit component skips the int32
    widening the JAX version makes."""
    if hs == 1 and vs == 1:
        return plane
    h, w = plane.shape
    total = plane.to(torch.int32).reshape(h // vs, vs, w // hs, hs).sum(
        dim=(1, 3), dtype=torch.int32
    )
    n = hs * vs
    return (total + n // 2) // n


def fdct_quantize(plane: torch.Tensor, quant_zz: torch.Tensor, level_shift: int,
                  matrix: torch.Tensor) -> torch.Tensor:
    """[Hb*8, Wb*8] integer samples + [64] zig-zag quant -> int16
    [Hb, Wb, 64] zig-zag coefficients: ``rint(((s - ls) @ F) / q)``.

    ``matrix`` is the [64, 64] fp32 folded FDCT + zig-zag map
    (``kernels.fdct_matrix``). Division is fp32 and rounding half to even
    (``torch.round``), as ``jnp.rint``. On a CUDA tensor it raises while
    TF32 matmuls are allowed: TF32 keeps a 10-bit mantissa and breaks the
    1-LSB contract, and the process-wide setting is the caller's to
    change."""
    if plane.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the plain K2 version needs full fp32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )
    h, w = plane.shape
    hb, wb = h // 8, w // 8
    blocks = plane.reshape(hb, 8, wb, 8).permute(0, 2, 1, 3).reshape(hb * wb, 64)
    shifted = blocks.to(torch.float32) - float(level_shift)
    zz = (shifted @ matrix) / quant_zz.to(torch.float32)
    return torch.round(zz).to(torch.int32).to(torch.int16).reshape(hb, wb, 64)


def forward_component(plane: torch.Tensor, quant_zz: torch.Tensor, h: int, v: int,
                      hs: int, vs: int, mcus_per_line: int, mcus_per_column: int,
                      level_shift: int) -> torch.Tensor:
    """One component: [H, W] samples -> [mcus_per_column*v,
    mcus_per_line*h, 64] int16 zig-zag coefficients, on the plane's
    device. On a CUDA plane the zero pad to the MCU grid and the box
    subsample run inside K2's load: one launch, no other kernel."""
    return kernels.fdct_quantize(plane, quant_zz, level_shift, hs=hs, vs=vs,
                                 blocks=(mcus_per_column * v, mcus_per_line * h))


def forward(planes: Sequence, quants, comp_params: Sequence[Tuple[int, int, int, int]],
            mcus_per_line: int, mcus_per_column: int, level_shift: int,
            device) -> List[torch.Tensor]:
    """Every component's encode transform on ``device``: the counterpart
    of ``jitted_forward``. PyTorch runs it eagerly.

    ``planes`` are [H, W] sample arrays or tensors, all of one dtype
    (uint8 at 8 bits, int32 at 12), ``quants`` the stacked [C, 64] int32
    zig-zag tables, ``comp_params`` one ``(h, v, hs, vs)`` per
    component. The planes go up in one copy and the coefficients come
    back in one: returns int16 [Hb, Wb, 64] CPU tensors."""
    device = torch.device(device)
    shapes = [tuple(p.shape) for p in planes]
    flat = torch.cat([torch.as_tensor(p).reshape(-1) for p in planes]).to(device)
    quants = torch.as_tensor(quants, dtype=torch.int32).to(device)
    outs = []
    off = 0
    for (h, v, hs, vs), shape, q in zip(comp_params, shapes, quants):
        n = shape[0] * shape[1]
        plane = flat[off : off + n].view(shape)
        off += n
        outs.append(forward_component(plane, q, h, v, hs, vs, mcus_per_line,
                                      mcus_per_column, level_shift))
    host = torch.cat([o.reshape(-1) for o in outs]).cpu()
    return [part.view(o.shape) for part, o in zip(host.split([o.numel() for o in outs]), outs)]

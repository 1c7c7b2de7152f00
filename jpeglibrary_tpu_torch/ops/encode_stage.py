"""Encode transform stage in PyTorch: sample planes -> quantized zig-zag
coefficient planes.

Port of ``jpeglibrary_tpu/ops/encode_stage.py`` (the parts the device
encode runs, ``jitted_forward``): zero-pad to the MCU grid, box-filter
subsample, then level shift + folded FDCT + zig-zag + quantize. On the
card all of it is K2 (``kernels.fdct_quantize``), one launch per
component. The integer ops are bit-exact against the numpy originals;
:func:`pad_to_grid` -> :func:`subsample_box` -> :func:`fdct_quantize` is
the plain PyTorch version of K2 and, like the Pallas kernel it mirrors,
is within 1 LSB of the butterfly FDCT. :func:`fdct_quantize_butterfly` is
the other route of the JAX ``fdct_quantize`` (``use_matmul=False``): the
reference's butterfly FDCT (``ops/dct.py``), bit for bit the JAX route on
any device, in plain PyTorch ops as it is XLA ops there.

:func:`symbol_histograms_device` is the port of the JAX package's device
symbol statistics (``encode_stage.py:320-390``): the DC and AC Huffman
symbol histograms of MCU-ordered blocks, bit-identical to the host
gather ``dc_ac_symbol_frequencies``, in plain PyTorch ops (XLA in the JAX
package, not a Pallas kernel).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..host.ops.zigzag import ZIGZAG_TO_BLOCK
from . import dct, kernels


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


def fdct_quantize_butterfly(plane: torch.Tensor, quant_zz: torch.Tensor,
                            level_shift: float = 128.0) -> torch.Tensor:
    """[Hb*8, Wb*8] integer samples + [64] zig-zag quant -> int16 [Hb, Wb,
    64] zig-zag coefficients through the butterfly: level shift in float32,
    ``dct.fdct8x8``, zig-zag, ``rint(zz / q)`` in float32 (half to even).
    The counterpart of the JAX ``fdct_quantize(use_matmul=False)``, equal
    to it bit for bit, on the plane's device."""
    h, w = plane.shape
    hb, wb = h // 8, w // 8
    blocks = plane.reshape(hb, 8, wb, 8).permute(0, 2, 1, 3).to(torch.float32)
    coef = dct.fdct8x8(blocks - float(level_shift)).reshape(hb, wb, 64)
    zz = coef.index_select(-1, torch.as_tensor(ZIGZAG_TO_BLOCK, dtype=torch.int64,
                                               device=coef.device))
    return torch.round(zz / quant_zz.to(torch.float32)).to(torch.int32).to(torch.int16)


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


def _bit_count_device(a: torch.Tensor) -> torch.Tensor:
    """The bits of each value, exactly, in int32: 16 threshold compares
    (a float log2 can be off by one at powers of two); 0 gives 0."""
    a = a.to(torch.int32)
    out = torch.zeros(a.shape, dtype=torch.int32, device=a.device)
    for k in range(16):
        out += (a >= (1 << k)).to(torch.int32)
    return out


def symbol_histograms_device(blocks: torch.Tensor, n_valid: Optional[torch.Tensor] = None,
                             prev_dc: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """DC and AC Huffman symbol histograms of int [B, N, 64] zig-zag
    blocks in MCU walk order, each batch row one component instance with
    its own DC predictor chain; ``n_valid`` [B] counts the real blocks of
    each row (the rest are padding and count nothing). Returns
    (dc_freq [256], ac_freq [256]) int32, summed over the batch, on the
    blocks' device: the DC categories of successive differences, the AC
    (run, size) symbols, a ZRL per 16 zeros of a run and an EOB per block
    whose last coefficient is zero.

    A row's first DC differs from 0, or from ``prev_dc`` [B] where given:
    the DC before the row in its chain, when the row is a shard of a
    longer chain (the mesh's boundary exchange)."""
    b, n, _ = blocks.shape
    dev = blocks.device
    i32 = torch.int32
    blocks = blocks.to(i32)
    if n_valid is None:
        valid = torch.ones((b, n), dtype=i32, device=dev)
    else:
        n_valid = torch.as_tensor(n_valid, device=dev)
        valid = (torch.arange(n, device=dev)[None, :] < n_valid[:, None]).to(i32)

    dc = blocks[:, :, 0]
    first = (torch.zeros((b, 1), dtype=i32, device=dev) if prev_dc is None
             else torch.as_tensor(prev_dc, device=dev).to(i32).reshape(b, 1))
    prev = torch.cat([first, dc[:, :-1]], dim=1)
    dc_syms = _bit_count_device((dc - prev).abs())
    dc_freq = torch.zeros(256, dtype=i32, device=dev)
    dc_freq.index_add_(0, dc_syms.reshape(-1), valid.reshape(-1))

    ac = blocks[:, :, 1:]  # [B, N, 63]
    nz = ac != 0
    col = torch.arange(63, dtype=i32, device=dev)
    marked = torch.where(nz, col, -1)
    cmax = torch.cummax(marked, dim=-1).values
    prev_nz = torch.cat([torch.full((b, n, 1), -1, dtype=i32, device=dev), cmax[:, :, :-1]],
                        dim=2)
    runs = col - prev_nz - 1
    sizes = _bit_count_device(ac.abs())
    syms = ((runs % 16) << 4) | sizes
    w = nz.to(i32) * valid[:, :, None]
    ac_freq = torch.zeros(256, dtype=i32, device=dev)
    ac_freq.index_add_(0, torch.where(nz, syms, 0).reshape(-1), w.reshape(-1))
    eob = ((cmax[:, :, -1] < 62).to(i32) * valid).sum(dtype=i32)
    ac_freq[0xF0] += ((runs // 16) * w).sum(dtype=i32)
    ac_freq[0] += eob
    return dc_freq, ac_freq

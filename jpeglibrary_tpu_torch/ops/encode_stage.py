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
symbol statistics (``encode_stage.py:330``, XLA there, not a Pallas
kernel): the DC and AC Huffman symbol histograms of MCU-ordered blocks,
bit-identical to the host gather ``dc_ac_symbol_frequencies``. It runs
K5 (``kernels.symbol_histograms``, ``csrc/symbol_hist.cu``) on the card;
:func:`symbol_histograms_plain` is K5's plain version, the JAX program in
plain PyTorch ops, and :func:`symbol_histograms_model` a CPU model of the
kernel's per-block arithmetic.
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
    """DC and AC Huffman symbol histograms of int16 or int32 [B, N, 64]
    zig-zag blocks in MCU walk order: :func:`symbol_histograms_plain`'s
    result, through K5's wrapper ``kernels.symbol_histograms`` (the plain
    version on a CPU tensor, ``csrc/symbol_hist.cu`` on a CUDA tensor).
    ``n_valid`` and ``prev_dc`` [B] lie on the blocks' device."""
    return kernels.symbol_histograms(blocks, n_valid, prev_dc)


def symbol_histograms_plain(blocks: torch.Tensor, n_valid: Optional[torch.Tensor] = None,
                            prev_dc: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's plain version: the DC and AC Huffman symbol histograms of int
    [B, N, 64] zig-zag blocks in MCU walk order, each batch row one
    component instance with its own DC predictor chain; ``n_valid`` [B]
    counts the real blocks of each row (the rest are padding and count
    nothing). Returns
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


def _top_bit(x: torch.Tensor) -> torch.Tensor:
    """The index of the highest set bit of each int64 value in [1, 2^63),
    by six halving steps (the kernel's ``__clz`` / ``__clzll``)."""
    out = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    for k in (32, 16, 8, 4, 2, 1):
        high = (x >> k) != 0
        out += high.to(torch.int64) * k
        x = torch.where(high, x >> k, x)
    return out


def _bit_count_model(v: torch.Tensor) -> torch.Tensor:
    """K5's bit count of int32 values: |v| in 32-bit two's complement, 0
    for 0 and for the negative |INT_MIN|, else ``min(32 - clz(|v|), 16)``."""
    a = v.to(torch.int64).abs()
    a = torch.where(a > 0x7FFFFFFF, 0, a)  # only INT_MIN: its int32 abs is negative
    return torch.where(a > 0, torch.clamp(_top_bit(a.clamp(min=1)) + 1, max=16), 0)


def symbol_histograms_model(blocks: torch.Tensor, n_valid: Optional[torch.Tensor] = None,
                            prev_dc: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A CPU model of K5's per-block arithmetic (``csrc/symbol_hist.cu``),
    in torch ops, with :func:`symbol_histograms_plain`'s arguments and
    result: each block's 64-bit non-zero mask; for each non-zero AC
    coefficient at zig-zag position p, its run from the previous set bit
    (the highest bit of the mask below p with the DC bit cleared, or 0;
    the kernel finds it once per 8 positions and carries it along them),
    its symbol ``((run & 15) << 4) | bits`` and ``run >> 4`` ZRLs; an EOB
    where coefficient 63 is zero; the DC against the block before it in
    its row, or ``prev_dc`` (0 without it) at n = 0; nothing from the
    blocks at n >= ``n_valid``. It exercises the kernel's algorithm where
    no kernel runs."""
    b, n, _ = blocks.shape
    dev = blocks.device
    i64 = torch.int64
    v = blocks.to(torch.int32).reshape(b * n, 64)
    nz = v != 0
    pos = torch.arange(64, dtype=i64, device=dev)
    mask = (nz.to(i64) << pos).sum(dim=1)  # wraps into bit 63 as the uint64 does
    cols = torch.arange(n, device=dev).repeat(b)
    if n_valid is None:
        valid = torch.ones(b * n, dtype=torch.bool, device=dev)
    else:
        limit = torch.as_tensor(n_valid, device=dev).to(i64).clamp(0, n)
        valid = cols < limit.repeat_interleave(n)

    dc = v[:, 0]
    first = (torch.zeros(b, dtype=torch.int32, device=dev) if prev_dc is None
             else torch.as_tensor(prev_dc, device=dev).to(torch.int32).reshape(b))
    prev = torch.where(cols == 0, first.repeat_interleave(n), torch.roll(dc, 1))
    diff = (dc.to(i64) - prev.to(i64) + (1 << 31)) % (1 << 32) - (1 << 31)  # int32 wrap
    dc_sym = _bit_count_model(diff)

    lows = torch.tensor([(1 << p) - 1 for p in range(64)], dtype=i64, device=dev)
    below = mask[:, None] & lows & ~1  # the AC bits under each position
    prev_p = torch.where(below != 0, _top_bit(below.clamp(min=1)), 0)
    runs = pos - prev_p - 1
    ac_sym = ((runs & 15) << 4) | _bit_count_model(v)
    take = nz & valid[:, None]
    take[:, 0] = False
    eob = valid & (v[:, 63] == 0)

    dc_freq = torch.bincount(dc_sym[valid], minlength=256)
    ac_freq = torch.bincount(ac_sym[take], minlength=256)
    ac_freq[0xF0] += (runs[take] >> 4).sum()
    ac_freq[0] += eob.sum()
    return dc_freq.to(torch.int32), ac_freq.to(torch.int32)

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

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

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


MCU_SHAPES = range(1, 5)  # h and v of an MCU, as JPEG allows
MAX_PLANES = 4  # K5's planes in one call


def k5_planes(blocks, mcu=(1, 1)) -> Tuple[Tuple[torch.Tensor, ...], int, int]:
    """K5's block forms as (planes, h, v), each plane [B, Hb, Wb, 64]:

    - [B, N, 64] int16 or int32 blocks already in walk order, one chain a
      row: one plane [B, 1, N, 64] (a view), ``mcu`` (1, 1);
    - a [B, Hb, Wb, 64] component plane in its natural layout, walked in
      the interleaved order of an ``mcu`` = (h, v) MCU (v rows of h
      blocks each), h dividing Wb and v dividing Hb;
    - a tuple or list of 1 to 4 such planes of one shape, dtype and device,
      whose chains stack plane after plane (B chains of the first, then B
      of the next).

    Raises TypeError or ValueError for anything else."""
    many = isinstance(blocks, (tuple, list))
    planes = tuple(blocks) if many else (blocks,)
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"K5 takes 1 to {MAX_PLANES} planes, got {len(planes)}")
    for x in planes:
        if not torch.is_tensor(x):
            raise TypeError(f"blocks must be tensors, got {type(x).__name__}")
        if x.dtype not in (torch.int16, torch.int32):
            raise TypeError(f"blocks must be int16 or int32, got {x.dtype}")
    first = planes[0]
    if any(x.shape != first.shape or x.dtype != first.dtype or x.device != first.device
           for x in planes):
        raise ValueError("K5's planes must share one shape, dtype and device")
    h, v = (int(n) for n in mcu)
    if h not in MCU_SHAPES or v not in MCU_SHAPES:
        raise ValueError(f"an MCU is 1 to 4 blocks each way, got {tuple(mcu)}")
    if first.dim() == 3 and first.shape[-1] == 64 and not many:
        if (h, v) != (1, 1):
            raise ValueError(f"[B, N, 64] blocks are in walk order already; got mcu {(h, v)}")
        return (first.unsqueeze(1),), 1, 1
    if first.dim() != 4 or first.shape[-1] != 64:
        raise ValueError("blocks must be [B, N, 64] or [B, Hb, Wb, 64] planes, got "
                         f"{tuple(first.shape)}")
    if first.shape[1] % v or first.shape[2] % h:
        raise ValueError(f"{tuple(first.shape[1:3])} blocks are no whole ({h}, {v}) MCUs")
    return planes, h, v


def mcu_walk(blocks, mcu=(1, 1)) -> torch.Tensor:
    """K5's blocks (any form of :func:`k5_planes`) as [R, N, 64] in MCU
    walk order, R = planes x B chains: the JAX package's
    ``_mcu_order_batch`` of each plane (a permute copy), the planes' chains
    stacked. The plain version's way in; the kernel reads the planes where
    they lie."""
    planes, h, v = k5_planes(blocks, mcu)
    out = []
    for x in planes:
        b, hb, wb, _ = x.shape
        x = x.reshape(b, hb // v, v, wb // h, h, 64).permute(0, 1, 3, 2, 4, 5)
        out.append(x.reshape(b, hb * wb, 64))
    return out[0] if len(out) == 1 else torch.cat(out)


def symbol_histograms_device(blocks, n_valid: Optional[torch.Tensor] = None,
                             prev_dc: Optional[torch.Tensor] = None, *,
                             mcu=(1, 1)) -> Tuple[torch.Tensor, torch.Tensor]:
    """DC and AC Huffman symbol histograms of int16 or int32 zig-zag
    blocks, in any form of :func:`k5_planes` (component planes walked in
    the order of an ``mcu`` = (h, v) MCU where they lie):
    :func:`symbol_histograms_plain`'s result, through K5's wrapper
    ``kernels.symbol_histograms`` (the plain version on a CPU tensor,
    ``csrc/symbol_hist.cu`` on a CUDA tensor). ``n_valid`` and ``prev_dc``
    [R] lie on the blocks' device."""
    return kernels.symbol_histograms(blocks, n_valid, prev_dc, mcu=mcu)


def symbol_histograms_plain(blocks, n_valid: Optional[torch.Tensor] = None,
                            prev_dc: Optional[torch.Tensor] = None, *, mcu=(1, 1)
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's plain version: the DC and AC Huffman symbol histograms of int
    zig-zag blocks in any form of :func:`k5_planes`, first put into MCU
    walk order by :func:`mcu_walk` ([B, N, 64] blocks as they are), each
    row one component instance with its own DC predictor chain;
    ``n_valid`` [R] counts the real blocks of each row (the rest are
    padding and count nothing). Returns
    (dc_freq [256], ac_freq [256]) int32, summed over the batch, on the
    blocks' device: the DC categories of successive differences, the AC
    (run, size) symbols, a ZRL per 16 zeros of a run and an EOB per block
    whose last coefficient is zero.

    A row's first DC differs from 0, or from ``prev_dc`` [R] where given:
    the DC before the row in its chain, when the row is a shard of a
    longer chain (the mesh's boundary exchange)."""
    blocks = mcu_walk(blocks, mcu)
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


K5_TILE_BLOCKS = 128  # the blocks of one of K5's tiles, one a consumer thread


def k5_walk(hb: int, wb: int, h: int, v: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's walk of one [Hb, Wb] plane of an (h, v) MCU, by the kernel's
    own index arithmetic: (pos, pred) int64 [Hb Wb], walk index t -> the
    block's flat position ``row * Wb + col`` in the plane, and the
    position of the block whose DC comes before it (-1 at t = 0).

    A tile is C = 128 // (h v) MCUs of one MCU row; its v block rows land
    in shared memory one after another, C h blocks apart; consumer thread
    k counts walk block k of the tile at the stage offset ((k % hv) // h
    * C + k // hv) * h + k % h, and its DC comes from thread k - 1's
    offset, or for k = 0 from the last block of the MCU before the tile
    (in the MCU row above at the row's start)."""
    hv = h * v
    c = K5_TILE_BLOCKS // hv
    mcu_cols = wb // h
    t = torch.arange(hb * wb, dtype=torch.int64, device=device)
    mcu = t // hv
    mr, mc = mcu // mcu_cols, mcu % mcu_cols
    mc0 = mc // c * c  # the tile's first MCU
    k = t - (mr * mcu_cols + mc0) * hv

    def stage_to_plane(kk):
        at = ((kk % hv) // h * c + kk // hv) * h + kk % h
        return (mr * v + at // (c * h)) * wb + mc0 * h + at % (c * h)

    pos = stage_to_plane(k)
    before = torch.where(mc0 > 0, (mr * v + v - 1) * wb + mc0 * h - 1, (mr * v - 1) * wb + wb - 1)
    pred = torch.where(k > 0, stage_to_plane(k - 1), torch.where(t > 0, before, -1))
    return pos, pred


def symbol_histograms_model(blocks, n_valid: Optional[torch.Tensor] = None,
                            prev_dc: Optional[torch.Tensor] = None, *, mcu=(1, 1)
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A CPU model of K5 (``csrc/symbol_hist.cu``), in torch ops, with
    :func:`symbol_histograms_plain`'s arguments and result: the walk of
    each plane by the kernel's tile and stage arithmetic (:func:`k5_walk`,
    in place, without the plain version's permute copy); per block its
    64-bit non-zero mask, and for each non-zero AC coefficient at zig-zag
    position p, taken from the top, its run to the next lower set bit q
    (the highest bit of the mask below p with the DC bit cleared, or 0)
    p - q - 1, its symbol ``((run & 15) << 4) | bits`` and ``run >> 4``
    ZRLs; an EOB where coefficient 63 is zero; the DC against the block
    :func:`k5_walk` names, or ``prev_dc`` (0 without it) at t = 0; nothing
    from the blocks at t >= ``n_valid``. It exercises the kernel's
    algorithm where no kernel runs."""
    planes, mcu_h, mcu_v = k5_planes(blocks, mcu)
    _, hb, wb, _ = planes[0].shape
    dev = planes[0].device
    i64 = torch.int64
    pos, pred = k5_walk(hb, wb, mcu_h, mcu_v, dev)
    n = hb * wb
    flat = torch.cat([x.reshape(x.shape[0], n, 64) for x in planes]).to(torch.int32)
    b = flat.shape[0]
    v = flat[:, pos].reshape(b * n, 64)
    nz = v != 0
    at = torch.arange(64, dtype=i64, device=dev)
    mask = (nz.to(i64) << at).sum(dim=1)  # wraps into bit 63 as the uint64 does
    cols = torch.arange(n, device=dev).repeat(b)
    if n_valid is None:
        valid = torch.ones(b * n, dtype=torch.bool, device=dev)
    else:
        limit = torch.as_tensor(n_valid, device=dev).to(i64).clamp(0, n)
        valid = cols < limit.repeat_interleave(n)

    dc = v[:, 0]
    first = (torch.zeros(b, dtype=torch.int32, device=dev) if prev_dc is None
             else torch.as_tensor(prev_dc, device=dev).to(torch.int32).reshape(b))
    before = flat[:, pred.clamp(min=0), 0].reshape(b * n)
    prev = torch.where(pred.repeat(b) < 0, first.repeat_interleave(n), before)
    diff = (dc.to(i64) - prev.to(i64) + (1 << 31)) % (1 << 32) - (1 << 31)  # int32 wrap
    dc_sym = _bit_count_model(diff)

    lows = torch.tensor([(1 << p) - 1 for p in range(64)], dtype=i64, device=dev)
    below = mask[:, None] & lows & ~1  # the AC bits under each position
    prev_p = torch.where(below != 0, _top_bit(below.clamp(min=1)), 0)
    runs = at - prev_p - 1
    ac_sym = ((runs & 15) << 4) | _bit_count_model(v)
    take = nz & valid[:, None]
    take[:, 0] = False
    eob = valid & (v[:, 63] == 0)

    dc_freq = torch.bincount(dc_sym[valid], minlength=256)
    ac_freq = torch.bincount(ac_sym[take], minlength=256)
    ac_freq[0xF0] += (runs[take] >> 4).sum()
    ac_freq[0] += eob.sum()
    return dc_freq.to(torch.int32), ac_freq.to(torch.int32)


# K7: the symbol statistics of a progressive scan script, per image.

MAX_AC_SCANS = 8  # AC scans of one component that K7 counts in one pass
MAX_EOB_RUN = 0x7FFF  # an EOB run codes at most this many blocks (T.81 G.1.2.2)


class ComponentPlan(NamedTuple):
    """What K7 counts for one component: its DC first scan as (Al, row),
    or None, and its AC scans as (Ss, Se, Ah, Al, row), in script order;
    ``row`` is the scan's row in the output."""

    dc: Optional[Tuple[int, int]]
    ac: Tuple[Tuple[int, int, int, int, int], ...]


def progressive_plan(script, n_comps: int) -> Tuple[int, Tuple[ComponentPlan, ...]]:
    """:func:`_progressive_plan` of ``script`` as tuples, worked out once
    a script (a step calls it every time)."""
    return _progressive_plan(tuple((tuple(comps), *rest) for comps, *rest in script), n_comps)


@functools.lru_cache(maxsize=64)
def _progressive_plan(script, n_comps: int) -> Tuple[int, Tuple[ComponentPlan, ...]]:
    """(R, one :class:`ComponentPlan` a component) for a scan script of
    ``(components, Ss, Se, Ah, Al)`` entries. The rows are the (scan,
    component) pairs that code Huffman symbols, in script order: a DC
    first scan gives one row a component, an AC scan one row, a DC
    refinement (raw bits) none.

    Raises ValueError for a script K7 does not count: an AC scan of more
    than one component or outside [1, 63]; a refinement whose Ah is not
    Al + 1; a component with two DC first scans or more than
    :data:`MAX_AC_SCANS` AC scans; or a coefficient that could code two
    symbols (two first scans over one position, two refinements of one
    bit, or a refinement of a bit at or above its first scan's Al), as no
    successive-approximation script does."""
    dc: List[Optional[Tuple[int, int]]] = [None] * n_comps
    ac: List[list] = [[] for _ in range(n_comps)]
    r = 0
    for comps, ss, se, ah, al in script:
        comps = tuple(int(c) for c in comps)
        if not comps or any(not 0 <= c < n_comps for c in comps):
            raise ValueError(f"scan components {comps} outside the frame's {n_comps}")
        if not 0 <= al <= 13 or ah not in (0, al + 1):
            raise ValueError(f"Ah {ah}, Al {al}: K7 takes Ah = 0 or Al + 1, Al <= 13")
        if ss == 0:
            if se != 0:
                raise ValueError(f"a scan of band [0, {se}] mixes DC and AC")
            if ah == 0:
                for c in comps:
                    if dc[c] is not None:
                        raise ValueError(f"component {c} has two DC first scans")
                    dc[c] = (al, r)
                    r += 1
            continue
        if len(comps) != 1 or not 1 <= ss <= se <= 63:
            raise ValueError(f"an AC scan is one component over [1, 63]: {comps}, [{ss}, {se}]")
        (c,) = comps
        if len(ac[c]) == MAX_AC_SCANS:
            raise ValueError(f"component {c} has more than {MAX_AC_SCANS} AC scans")
        ac[c].append((ss, se, ah, al, r))
        r += 1
    for c in range(n_comps):
        for p in range(1, 64):
            here = [s for s in ac[c] if s[0] <= p <= s[1]]
            first = [s[3] for s in here if s[2] == 0]
            refined = [s[3] for s in here if s[2] != 0]
            if (len(first) > 1 or len(set(refined)) != len(refined)
                    or any(first and al + 1 > first[0] for al in refined)):
                raise ValueError(f"coefficient {p} of component {c} could code two symbols")
    return r, tuple(ComponentPlan(d, tuple(a)) for d, a in zip(dc, ac))


def progressive_sampling(y: torch.Tensor, cb: Optional[torch.Tensor],
                         cr: Optional[torch.Tensor]) -> Tuple[Tuple[int, int], ...]:
    """The components' (h, v) read from the planes' shapes: the luma alone
    (1, 1); or the luma (hs, vs) and each chroma (1, 1), with the chroma
    planes [B, Hb / vs, Wb / hs, 64], hs and vs 1 or 2 (4:4:4, 4:2:2,
    4:4:0, 4:2:0). Raises ValueError for anything else."""
    for name, x in (("y", y), ("cb", cb), ("cr", cr)):
        if x is not None and (x.dim() != 4 or x.shape[-1] != 64):
            raise ValueError(f"{name} must be a [B, Hb, Wb, 64] plane, got {tuple(x.shape)}")
    if cb is None and cr is None:
        return ((1, 1),)
    if cb is None or cr is None or cb.shape != cr.shape:
        raise ValueError("cb and cr must both be given, of one shape")
    b, hb, wb = y.shape[:3]
    for hs in (1, 2):
        for vs in (1, 2):
            if tuple(cb.shape[:3]) == (b, hb // vs, wb // hs) and hb % vs == 0 and wb % hs == 0:
                return ((hs, vs), (1, 1), (1, 1))
    raise ValueError(f"chroma {tuple(cb.shape)} is no 1x1 or 2x box of luma {tuple(y.shape)}")


def progressive_grid(size: Tuple[int, int], sampling, c: int) -> Tuple[int, int]:
    """(rows, columns) of component ``c``'s own block grid, the blocks its
    AC scans walk in raster order: ``ceil(Yi / 8) x ceil(Xi / 8)`` for an
    image of ``size`` = (height, width), as the host encoder forms it."""
    height, width = size
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    h, v = sampling[c]
    return -(-height // (8 * (vmax // v))), -(-width // (8 * (hmax // h)))


def _bit_length(a: torch.Tensor) -> torch.Tensor:
    """The bit length of each non-negative int64 (at most 2^31)."""
    return torch.frexp(a.to(torch.float64))[1].to(torch.int64)


def _add_eob_runs(hist: torch.Tensor, row: torch.Tensor, lengths: torch.Tensor) -> None:
    """Count runs of ``lengths`` blocks into ``hist[row]``: ``L // 0x7FFF``
    symbols 0xE0, then ``floor(log2(L % 0x7FFF)) << 4``."""
    keep = lengths > 0
    row, lengths = row[keep], lengths[keep]
    hist[:, 0xE0].index_add_(0, row, lengths // MAX_EOB_RUN)
    rest = lengths % MAX_EOB_RUN
    keep = rest > 0
    hist.index_put_((row[keep], (_bit_length(rest[keep]) - 1) << 4),
                    torch.ones_like(rest[keep]), accumulate=True)


def _plain_ac_scan(blocks: torch.Tensor, ss: int, se: int, ah: int, al: int,
                   hist: torch.Tensor) -> None:
    """One AC scan of a batch's component: ``blocks`` [B, N, 64] int64, each
    image's blocks of the scan's grid in raster order; adds each image's
    symbols into ``hist`` [B, 256]. The EOB runs are counted along each
    image's whole chain: a coding block flushes the blocks that joined the
    run since the coding block before it, and the image's end the rest."""
    b = blocks.shape[0]
    band = blocks[..., ss:se + 1]
    width = band.shape[-1]
    t = band.abs() >> al
    coded = t != 0 if ah == 0 else t == 1
    zero = t == 0
    pos = torch.arange(width, device=blocks.device)
    last = torch.cummax(torch.where(coded, pos, -1), dim=-1).values
    prev = torch.cat([torch.full_like(last[..., :1], -1), last[..., :-1]], dim=-1)
    zeros = torch.cumsum(zero.to(torch.int64), dim=-1)
    zeros_at_prev = torch.where(prev >= 0, zeros.gather(-1, prev.clamp(min=0)), 0)
    z = zeros - zero.to(torch.int64) - zeros_at_prev
    size = _bit_length(t) if ah == 0 else torch.ones_like(t)
    image = torch.arange(b, device=blocks.device).view(b, 1, 1).expand_as(coded)
    hist.index_put_((image[coded], (z[coded] % 16) << 4 | size[coded]),
                    torch.ones_like(z[coded]), accumulate=True)
    hist[:, 0xF0] += torch.where(coded, z // 16, 0).flatten(1).sum(1)

    joins = (last[..., -1] < width - 1).to(torch.int64)
    # The joining blocks before each block, and in the whole chain as a last column.
    before = torch.nn.functional.pad(torch.cumsum(joins, 1), (1, 0))
    flush = torch.nn.functional.pad(coded.any(-1), (0, 1), value=True)
    at_last_flush = torch.cummax(torch.where(flush, before, 0), 1).values
    lengths = before - torch.nn.functional.pad(at_last_flush[:, :-1], (1, 0))
    images = torch.arange(b, device=blocks.device).view(b, 1).expand_as(flush)
    _add_eob_runs(hist, images[flush], lengths[flush])


def progressive_histograms_plain(y: torch.Tensor, cb: Optional[torch.Tensor],
                                 cr: Optional[torch.Tensor], script, *,
                                 size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """K7's plain version: [B, R, 256] int32 symbol histograms of each image
    of a batch under a progressive scan ``script``, in torch ops. Each DC
    first scan walks its components' interleaved MCU chains over the
    padded planes; each AC scan walks its component's own grid
    (:func:`progressive_grid`) in raster order, its EOB runs counted along
    the image's whole chain. Arguments as ``kernels.progressive_histograms``."""
    planes = [p for p in (y, cb, cr) if p is not None]
    sampling = progressive_sampling(y, cb, cr)
    n_rows, plans = progressive_plan(script, len(planes))
    b, hb, wb = y.shape[:3]
    size = size or (8 * hb, 8 * wb)
    out = torch.zeros((b, n_rows, 256), dtype=torch.int64, device=y.device)
    for c, (plane, (h, v), plan) in enumerate(zip(planes, sampling, plans)):
        if plan.dc is not None:
            al, row = plan.dc
            chain = mcu_walk(plane, (h, v))[..., 0].to(torch.int64) >> al
            diff = chain - torch.nn.functional.pad(chain[:, :-1], (1, 0))
            out[:, row].scatter_add_(1, _bit_length(diff.abs()), torch.ones_like(diff))
        rows, cols = progressive_grid(size, sampling, c)
        grid = plane[:, :rows, :cols].to(torch.int64).reshape(b, rows * cols, 64)
        for ss, se, ah, al, row in plan.ac:
            _plain_ac_scan(grid, ss, se, ah, al, out[:, row])
    return out.to(torch.int32)

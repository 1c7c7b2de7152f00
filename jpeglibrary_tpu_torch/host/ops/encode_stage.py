"""Device-side encode transform stage: sample planes -> quantized
zig-zag coefficient planes.

The batched-tensor replacement for the reference per-block encode
pipeline (JpegEncoder.cs:414-489 TransformBlocks and :756-810
ReadBlockWithSubsample / ShiftDataLevel / ZigZagAndQuantizeBlock):

  [H, W] uint8 sample plane
    -> zero-pad to the MCU grid (edge zero-fill semantics of
       JpegBufferInputReader.ReadBlock, JpegBufferInputReader.cs:27-51)
    -> box-filter subsample with round-half-up: (sum + 2^(s-1)) >> s
    -> level shift to float32 (sample - 128)
    -> batched float32 AAN FDCT (ops.dct, the reference butterfly)
    -> zig-zag + quantize: rint(coef / q) per element, float32 division
  -> int16 [Hb, Wb, 64] zig-zag coefficient planes

The port's copy of ``jpeglibrary_tpu/ops/encode_stage.py``, the numpy
half the host encoder runs (and K2's folded matrix); the JAX programs
(``jitted_forward``, the device symbol histograms) and the Pallas branch
are not copied.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from . import dct
from .zigzag import ZIGZAG_TO_BLOCK


def pad_to_grid(plane, height_padded: int, width_padded: int, xp=np):
    """Zero-pad a [H, W] plane to the MCU-aligned size."""
    h, w = plane.shape
    if h == height_padded and w == width_padded:
        return plane
    if xp is np:
        out = np.zeros((height_padded, width_padded), dtype=plane.dtype)
        out[:h, :w] = plane
        return out
    return xp.pad(plane, ((0, height_padded - h), (0, width_padded - w)))


def subsample_box(plane, hs: int, vs: int, xp=np):
    """Box-filter downsample by (hs, vs), round-half-up: (sum + n//2)//n
    with n = hs*vs — identical to the reference's (sum + 2^(s-1)) >> s
    (ReadBlockWithSubsample, JpegEncoder.cs:756-787) for the power-of-two
    boxes the reference supports, and correct for non-power-of-two
    factors (e.g. 3) it does not. Input dims must divide evenly."""
    if hs == 1 and vs == 1:
        return plane.astype(xp.int32) if plane.dtype != xp.int32 else plane
    if xp is np and plane.dtype == np.uint8:
        try:
            from ..native import scanner as native_scanner

            return native_scanner.box_subsample(plane, hs, vs)
        except ImportError:
            pass
    h, w = plane.shape
    x = plane.astype(xp.int32).reshape(h // vs, vs, w // hs, hs)
    total = xp.sum(x, axis=(1, 3))
    # Round-half-up divide by the box size. For power-of-two boxes this
    # equals the reference's (sum + 2^(s-1)) >> s exactly; for the
    # non-power-of-two factors T.81 also allows (e.g. 3), the shift
    # form would scale samples by n/2^s — a real divide is required.
    n = hs * vs
    return (total + n // 2) // n


import functools


@functools.lru_cache(maxsize=1)
def fdct_zigzag_matrix() -> np.ndarray:
    """[64, 64] f32: the 2-D AAN FDCT + 0.125 scale + zig-zag output
    permutation folded into one matrix — the forward twin of the decode
    Pallas kernel's formulation: one GEMM per block tile instead of the
    30-step butterfly chain (same transform, f32 summation order
    differs, so a quantized coefficient can shift by 1 LSB vs the
    butterfly; the encoder has no bit-exact gate)."""
    f = dct._fdct_1d(np.eye(8, dtype=np.float64), np)  # 1-D pass matrix
    k = np.zeros((64, 64), dtype=np.float64)
    for zz in range(64):
        nat = int(ZIGZAG_TO_BLOCK[zz])
        r, c = nat // 8, nat % 8
        for a in range(8):
            for b in range(8):
                k[8 * a + b, zz] = 0.125 * f[r, a] * f[c, b]
    return k.astype(np.float32)


def fdct_quantize(plane, quant_zz, xp=np, *, use_matmul: bool = True,
                  level_shift: float = 128.0):
    """[Hb*8, Wb*8] int samples -> [Hb, Wb, 64] int16 zig-zag coeffs.

    Level shift, AAN FDCT, zig-zag, rint(c / q) — float32 division then
    round-half-even, matching ZigZagAndQuantizeBlock
    (JpegEncoder.cs:812-827 with JpegMathHelper.RoundToInt16).
    ``use_matmul`` selects the folded-GEMM formulation (default, ~15x
    faster on host BLAS and MXU-shaped on device); False runs the
    reference butterfly dataflow. ``level_shift`` = 1 << (P - 1)
    (2048 for direct 12-bit sample encode — beyond the reference's
    8-bit-only encoder, JpegEncoder.cs:108)."""
    h, w = plane.shape
    hb, wb = h // 8, w // 8
    blocks = plane.reshape(hb, 8, wb, 8)
    blocks = xp.transpose(blocks, (0, 2, 1, 3)).astype(xp.float32) - xp.float32(
        level_shift
    )
    q = quant_zz.astype(xp.float32)
    if use_matmul:
        flat = blocks.reshape(hb * wb, 64)
        k = fdct_zigzag_matrix() if xp is np else xp.asarray(fdct_zigzag_matrix())
        zz = (flat @ k).reshape(hb, wb, 64)
        return xp.rint(zz / q).astype(xp.int16)
    coef = dct.fdct8x8(blocks, xp=xp)  # [hb, wb, 8, 8] natural order
    flat = coef.reshape(hb, wb, 64)
    if xp is np:
        zz = flat[..., ZIGZAG_TO_BLOCK]
    else:
        zz = xp.take(flat, xp.asarray(ZIGZAG_TO_BLOCK), axis=-1)
    return xp.rint(zz / q).astype(xp.int16)


def forward_component(
    plane, quant_zz, h: int, v: int, hs: int, vs: int,
    mcus_per_line: int, mcus_per_column: int, xp=np,
    level_shift: float = 128.0,
):
    """Full encode transform for one component: [H, W] samples ->
    [mcus_per_column*v, mcus_per_line*h, 64] int16 zig-zag coeffs.

    Host (numpy) path uses the native threaded butterfly FDCT when
    available — the folded-GEMM BLAS call is memory-bound at this K=64
    shape; the native AAN butterfly with fp-contract off is both faster
    and closer to the reference dataflow."""
    full_h = mcus_per_column * v * 8 * vs
    full_w = mcus_per_line * h * 8 * hs
    padded = pad_to_grid(plane, full_h, full_w, xp=xp)
    if xp is np:
        try:
            from ..native import scanner as native_scanner

            if hs == 1 and vs == 1 and padded.dtype == np.uint8:
                return native_scanner.fdct_quantize(padded, quant_zz, level_shift)
            sub = subsample_box(padded, hs, vs, xp=np)
            if sub.dtype not in (np.dtype(np.uint8), np.dtype(np.int32)):
                # >8-bit sample planes (uint16/int16): widen for the
                # native int32 input path.
                sub = sub.astype(np.int32)
            return native_scanner.fdct_quantize(sub, quant_zz, level_shift)
        except ImportError:
            pass
    sub = subsample_box(padded, hs, vs, xp=xp)
    return fdct_quantize(sub, quant_zz, xp=xp, level_shift=level_shift)


def mcu_order_blocks(coeffs_zz: np.ndarray, h: int, v: int) -> np.ndarray:
    """[Hb, Wb, 64] -> [N, 64] in the interleaved MCU walk order the
    scan uses (per MCU: v rows x h cols of blocks,
    JpegEncoder.cs:512-536)."""
    hb, wb, _ = coeffs_zz.shape
    mc, ml = hb // v, wb // h
    x = coeffs_zz.reshape(mc, v, ml, h, 64)
    return np.transpose(x, (0, 2, 1, 3, 4)).reshape(-1, 64)


def dc_ac_symbol_frequencies(blocks_mcu_order: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized symbol statistics for one component's blocks (already
    in MCU walk order — DC differences depend on it) — the
    device/psum-able analogue of GatherBlockStatistics
    (JpegEncoder.cs:551-601).

    Returns (dc_freq[256], ac_freq[256]) int64 symbol histograms.
    """
    if blocks_mcu_order.dtype == np.int16:
        try:
            from ..native import scanner as native_scanner

            return native_scanner.symbol_histograms(
                blocks_mcu_order.reshape(-1, 64)
            )
        except ImportError:
            pass
    blocks = blocks_mcu_order.reshape(-1, 64).astype(np.int32)

    # DC: category of successive differences
    dc = blocks[:, 0]
    diffs = np.empty_like(dc)
    diffs[0] = dc[0]
    diffs[1:] = dc[1:] - dc[:-1]
    dc_syms = bit_count(np.abs(diffs))
    dc_freq = np.bincount(dc_syms, minlength=256).astype(np.int64)

    # AC: run-length symbols. Vectorized per block via nonzero scan.
    ac_freq = np.zeros(256, dtype=np.int64)
    ac = blocks[:, 1:]
    nz_rows, nz_cols = np.nonzero(ac)
    sizes = bit_count(np.abs(ac[nz_rows, nz_cols]))
    # run length before each nonzero: distance to previous nonzero in
    # the same row (or to position 0).
    prev_col = np.full(len(nz_cols), -1, dtype=np.int64)
    if len(nz_cols) > 0:
        same_row = np.zeros(len(nz_cols), dtype=bool)
        same_row[1:] = nz_rows[1:] == nz_rows[:-1]
        prev_col[same_row] = nz_cols[np.flatnonzero(same_row) - 1]
    runs = nz_cols - prev_col - 1
    # ZRL symbols for runs > 15
    zrl_count = int(np.sum(runs // 16))
    ac_freq[0xF0] += zrl_count
    symbols = ((runs % 16) << 4) | sizes
    ac_freq += np.bincount(symbols, minlength=256).astype(np.int64)
    # EOB per block whose trailing coefficients are zero
    has_nz = np.zeros(len(blocks), dtype=bool)
    last_nz = np.full(len(blocks), -1, dtype=np.int64)
    if len(nz_rows) > 0:
        np.maximum.at(last_nz, nz_rows, nz_cols)
        has_nz[nz_rows] = True
    eob_count = int(np.sum(last_nz < 62))  # 62 == index 63 in full block
    ac_freq[0] += eob_count
    return dc_freq, ac_freq


def apply_restart_dc_fixup(
    dc_freq: np.ndarray,
    blocks_mcu_order: np.ndarray,
    per_mcu: int,
    restart_interval: int,
    *,
    first_mcu: int = 0,
    prev_dc=None,
) -> None:
    """Correct a dc_ac_symbol_frequencies histogram for restart-interval
    DC-predictor resets: the gather counts DC diffs as one unbroken
    chain with initial predictor 0, but emission resets the predictor
    at every restart boundary, so the segment-start categories differ —
    and a category emitted only there would be missing from the built
    table. (The reference cannot hit this: its encoder never emits
    restart markers, JpegEncoder.cs:605-660.)

    ``first_mcu``/``prev_dc`` support stripe-wise (streaming) gathering:
    the stripe starts at global MCU ``first_mcu`` and ``prev_dc`` is the
    previous stripe's last DC value (None for the first stripe).
    """
    dc = np.asarray(blocks_mcu_order[:, 0], dtype=np.int64)
    ri = restart_interval
    # Global segment starts strictly after the stripe's first block.
    first_seg = ((first_mcu + ri - 1) // ri) * ri
    if first_seg == first_mcu:
        first_seg += ri
    starts = np.arange((first_seg - first_mcu) * per_mcu, len(dc), ri * per_mcu)
    if len(starts):
        old = bit_count(np.abs(dc[starts] - dc[starts - 1]))
        new = bit_count(np.abs(dc[starts]))
        np.subtract.at(dc_freq, old, 1)
        np.add.at(dc_freq, new, 1)
    # The stripe's first block: the gather counted cat(dc[0] - 0), which
    # is correct when the stripe begins a segment; otherwise the true
    # predecessor is the previous stripe's last DC.
    if prev_dc is not None and first_mcu % ri != 0:
        dc_freq[abs(int(dc[0])).bit_length()] -= 1
        dc_freq[abs(int(dc[0]) - prev_dc).bit_length()] += 1


def bit_count(a):
    """Number of bits to represent |value| (BitCountTable semantics,
    JpegEncoder.cs:938-996); 0 -> 0."""
    a = np.asarray(a)
    out = np.zeros(a.shape, dtype=np.int64)
    nz = a > 0
    out[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return out

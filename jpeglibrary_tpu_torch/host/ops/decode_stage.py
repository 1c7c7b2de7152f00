"""Device-side decode transform stage: zig-zag coefficient planes ->
full-resolution sample planes / interleaved output.

This replaces the per-block pipeline of the reference hot loop
(JpegHuffmanBaselineScanDecoder.cs:99-137: dequantize -> IDCT ->
level-shift -> WriteBlock with duplication upsampling,
JpegHuffmanBaselineScanDecoder.cs:238-271) with batched tensor ops:

  coeffs int16 [Hb, Wb, 64] (zig-zag)
    -> dequantize (int32 product, exact) + un-zigzag gather
    -> float32 AAN IDCT (ops.dct, bit-matching the reference)
    -> round-half-even + level shift (int32)
    -> reshape to plane [Hb*8, Wb*8]
    -> nearest (duplication) chroma upsample
    -> crop to [H, W]

The port's copy of ``jpeglibrary_tpu/ops/decode_stage.py``: the numpy
writers of the host ``to_rgb8`` and the folded matrices of K1, the
full one (``fused_transform_matrix``, from the numpy half of
``jpeglibrary_tpu/ops/pallas_kernels.py``) and the reduced ones of the
scaled decode (``scaled_folded_matrix``).

Its ``xp`` takes numpy, the host golden path, or a torch device in the
place of the JAX package's ``jnp``: ``torch`` (the module) means the
card, ``torch.device(...)`` names a device. There
:func:`decode_components_to_planes` runs the port's device decode
(``jpeglibrary_tpu_torch.ops.decode_stage``, K4 on the card), whose
planes equal the numpy planes bit for bit, and :func:`planes_to_host`
brings them back in one download.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence

import numpy as np

from ..models.geometry import FrameGeometry
from . import dct
from .zigzag import BLOCK_TO_ZIGZAG, ZIGZAG_TO_BLOCK


def dequantize_idct_shift(coeffs_zz, quant_zz, level_shift: int, xp=np):
    """[..., 64] zig-zag int16 coeffs + zig-zag quant -> int32 samples [..., 8, 8].

    Matches DequantizeBlockAndUnZigZag (JpegScanDecoder.cs:50-62: the
    int product converted to float32) followed by TransformIDCT and
    ShiftDataLevel (JpegScanDecoder.cs:64-73: MathF.Round — round half
    to even — plus the level shift).
    """
    deq = coeffs_zz.astype(xp.int32) * quant_zz.astype(xp.int32)  # exact int32
    # natural[j] = zigzag[BLOCK_TO_ZIGZAG[j]]
    if xp is np:
        natural = deq[..., BLOCK_TO_ZIGZAG]
    else:
        natural = xp.take(deq, xp.asarray(BLOCK_TO_ZIGZAG), axis=-1)
    blocks = natural.reshape(natural.shape[:-1] + (8, 8)).astype(xp.float32)
    pixels = dct.idct8x8(blocks, xp=xp)
    return xp.rint(pixels).astype(xp.int32) + level_shift


def blocks_to_plane(samples, xp=np):
    """[Hb, Wb, 8, 8] -> [Hb*8, Wb*8]."""
    hb, wb = samples.shape[0], samples.shape[1]
    return xp.transpose(samples, (0, 2, 1, 3)).reshape(hb * 8, wb * 8)


def upsample_duplicate(plane, hs: int, vs: int, xp=np):
    """Nearest-neighbor duplication upsample, the exact semantics of
    WriteBlockSlow (JpegHuffmanBaselineScanDecoder.cs:238-271)."""
    if vs != 1:
        plane = xp.repeat(plane, vs, axis=0)
    if hs != 1:
        plane = xp.repeat(plane, hs, axis=1)
    return plane


def _fancy_double_h(p, xp):
    """Double the column count with libjpeg's h2v1 triangular weights.
    Edge replication reproduces jdsample.c's first/last-column special
    cases exactly: (4s+1)>>2 == s and (4s+2)>>2 == s."""
    left = xp.concatenate([p[:, :1], p[:, :-1]], axis=1)
    right = xp.concatenate([p[:, 1:], p[:, -1:]], axis=1)
    even = (3 * p + left + 1) >> 2
    odd = (3 * p + right + 2) >> 2
    return xp.stack([even, odd], axis=2).reshape(p.shape[0], -1)


def upsample_fancy(plane, hs: int, vs: int, xp=np):
    """Triangular ("fancy") chroma upsampling, bit-exact to libjpeg's
    jdsample.c h2v1_fancy_upsample / h2v2_fancy_upsample — the libjpeg
    DEFAULT filter, offered beyond the reference's duplication
    semantics. Inputs must already be clamped to sample range (the
    filter is applied to writer-normalized values, as libjpeg applies
    it to range-limited JSAMPLEs). libjpeg has fancy kernels only for
    the h2v1/h2v2 factors; every other factor falls back to
    duplication, the same selection rule jdsample.c uses."""
    p = xp.asarray(plane).astype(xp.int32)
    if hs == 2 and vs == 1:
        return _fancy_double_h(p, xp)
    if hs == 2 and vs == 2:
        up = xp.concatenate([p[:1], p[:-1]], axis=0)
        down = xp.concatenate([p[1:], p[-1:]], axis=0)
        # Output row 2v blends input rows (v, v-1) 3:1; row 2v+1 blends
        # (v, v+1) 3:1 — jdsample.c's thiscolsum chain.
        t = xp.stack([3 * p + up, 3 * p + down], axis=1).reshape(-1, p.shape[1])
        left = xp.concatenate([t[:, :1], t[:, :-1]], axis=1)
        right = xp.concatenate([t[:, 1:], t[:, -1:]], axis=1)
        even = (3 * t + left + 8) >> 4
        odd = (3 * t + right + 7) >> 4
        return xp.stack([even, odd], axis=2).reshape(t.shape[0], -1)
    return upsample_duplicate(p, hs, vs, xp=xp)


def component_plane(coeffs_zz, quant_zz, level_shift: int, hs: int, vs: int,
                    height: int, width: int, xp=np):
    """Full decode transform for one component: coeffs -> cropped int32 plane."""
    samples = dequantize_idct_shift(coeffs_zz, quant_zz, level_shift, xp=xp)
    plane = blocks_to_plane(samples, xp=xp)
    plane = upsample_duplicate(plane, hs, vs, xp=xp)
    return plane[:height, :width]


def decode_components_to_planes(
    coefficient_planes: Dict[int, "np.ndarray"],
    quant_tables_zz: Dict[int, "np.ndarray"],
    geometry: FrameGeometry,
    xp=np,
) -> Dict[int, "np.ndarray"]:
    """All components -> cropped int32 sample planes [H, W]: numpy arrays
    for ``xp=np``, tensors on the device that ``xp`` names otherwise
    (:func:`device_of`)."""
    device = device_of(xp)
    if device is not None:
        from ...ops import decode_stage as device_stage

        return device_stage.decode_components_to_planes(
            coefficient_planes, quant_tables_zz, geometry, device)
    out = {}
    for cg in geometry.components:
        out[cg.component_index] = component_plane(
            coefficient_planes[cg.component_index],
            quant_tables_zz[cg.component_index],
            geometry.level_shift,
            cg.hs,
            cg.vs,
            geometry.height,
            geometry.width,
            xp=xp,
        )
    return out


def device_of(xp):
    """None for ``xp=np`` (the host path); for ``torch`` the card
    (``cuda``), as ``jnp`` means the JAX default device; for a
    ``torch.device`` that device. Raises ``TypeError`` for any other value."""
    if xp is np:
        return None
    import torch

    if xp is torch:
        return torch.device("cuda")
    if isinstance(xp, torch.device):
        return xp
    raise TypeError(
        f"xp must be numpy (the host), torch (the card) or a torch.device, got {xp!r}"
    )


def planes_to_host(planes) -> Dict[int, "np.ndarray"]:
    """Sample planes by component index as numpy arrays: numpy planes as
    they are, device planes (all [H, W] int32) in one download."""
    if all(isinstance(v, np.ndarray) for v in planes.values()):
        return dict(planes)
    import torch

    host = torch.stack(list(planes.values())).cpu().numpy()
    return dict(zip(planes, host))


# ---------------------------------------------------------------------------
# Output formats (the reference keeps these in pluggable writers; we
# provide them as pure functions over the assembled planes)
# ---------------------------------------------------------------------------

def clamp_to_uint8(plane, xp=np):
    """8-bit output writer semantics (apps/JpegDecode/JpegBufferOutputWriter8Bit.cs:28-60):
    clamp int sample to [0, 255]."""
    return xp.clip(plane, 0, 255).astype(xp.uint8)


def normalize_to_uint8(plane, precision: int, xp=np):
    """Precision-aware 8-bit output, matching the app's writer choice
    (DecodeAction.cs:41-54): 8-bit clamps; >8-bit shifts right by p-8
    then clamps (JpegBufferOutputWriterGreaterThan8Bit.cs:34-61); <8-bit
    clamps to [0, 2^p - 1] then bit-expands to 8 bits
    (JpegBufferOutputWriterLessThan8Bit.cs:35-94)."""
    if precision == 8:
        return clamp_to_uint8(plane, xp=xp)
    if precision > 8:
        return xp.clip(plane >> (precision - 8), 0, 255).astype(xp.uint8)
    bits = xp.clip(plane, 0, (1 << precision) - 1)
    current = precision
    while current < 8:
        bits = (bits << precision) | bits
        current += precision
    if current > 8:
        bits = bits >> precision
        current -= precision
        remaining = 8 - current
        bits = (bits << remaining) | (bits & ((1 << remaining) - 1))
    return bits.astype(xp.uint8)


def expand_bits_fast(bits, precision: int, xp=np):
    """FastExpandBits (apps/JpegDebugDump/JpegExtendingOutputWriter.cs:92-99):
    for precision >= 8: (bits << r) | (bits & ((1 << r) - 1)), r = 16 - p."""
    r = 16 - precision
    return (bits << r) | (bits & ((1 << r) - 1))


def expand_bits_slow(bits, precision: int, xp=np):
    """ExpandBits for precision < 8 (JpegExtendingOutputWriter.cs:101-118)."""
    current = precision
    while current < 16:
        bits = (bits << precision) | bits
        current += precision
    if current > 16:
        bits = bits >> precision
        current -= precision
        bits = (bits << (16 - current)) | (bits & ((1 << (16 - current)) - 1))
    return bits


def extend_to_uint16(plane, precision: int, xp=np):
    """JpegExtendingOutputWriter.WriteBlock semantics
    (JpegExtendingOutputWriter.cs:40-118): the int16 sample is cast to
    ushort (so negatives wrap high and clamp to max), clamped to
    [0, 2^p - 1], then bit-expanded to 16 bits."""
    max_value = (1 << precision) - 1
    as_ushort = plane.astype(xp.int32) & 0xFFFF
    clamped = xp.minimum(as_ushort, max_value)
    if precision >= 8:
        expanded = expand_bits_fast(clamped, precision, xp=xp)
    else:
        expanded = expand_bits_slow(clamped, precision, xp=xp)
    return expanded.astype(xp.uint16)


def interleave_planes(planes: Sequence, xp=np):
    """[H, W] planes -> [H, W, C]."""
    return xp.stack(list(planes), axis=-1)


def _idct_matrix_f64() -> np.ndarray:
    """Extract the 1-D IDCT pass as a matrix (the butterfly is linear):
    _idct_1d maps along axis -2, so applying it to I8 yields M itself
    (column k = response to e_k)."""
    return dct._idct_1d(np.eye(8, dtype=np.float64), np)


@functools.lru_cache(maxsize=1)
def fused_transform_matrix() -> np.ndarray:
    """[64, 64] f32: un-zigzag + 2-D IDCT + 0.125 scale folded."""
    m = _idct_matrix_f64()  # out = 0.125 * M @ X @ M.T
    k = np.zeros((64, 64), dtype=np.float64)
    for zz in range(64):
        nat = int(ZIGZAG_TO_BLOCK[zz])
        r, c = nat // 8, nat % 8
        for i in range(8):
            for j in range(8):
                k[zz, 8 * i + j] = 0.125 * m[i, r] * m[j, c]
    return k.astype(np.float32)


# ---------------------------------------------------------------------------
# Scaled decode (libjpeg-class DCT-domain downscaling: 1/2, 1/4, 1/8)
# ---------------------------------------------------------------------------

_SCALED_IDCT_CACHE: Dict[int, "np.ndarray"] = {}


def scaled_idct_matrix(n: int) -> "np.ndarray":
    """[n, 8] reduced-IDCT matrix R: an 8x8 coefficient block maps to
    an n x n spatial block as R @ F_natural @ R.T.

    Classic DCT-domain downsampling (spectral truncation): keep the
    lowest n frequencies per axis, rescale to the orthonormal n-point
    basis (sqrt(n/8)) and inverse-transform. Preserves the block mean
    exactly (n=1 output IS the DC mean). Derived numerically from the
    production idct8x8 so the frequency scaling convention always
    matches.
    """
    if n in _SCALED_IDCT_CACHE:
        return _SCALED_IDCT_CACHE[n]
    if n == 8:
        raise ValueError("use the full IDCT path for scale 1")
    # Recover the per-axis 8-point IDCT matrix A (f = A @ F @ A.T)
    # from the 2-D production kernel.
    probe = np.zeros((8, 8, 8), dtype=np.float32)
    for u in range(8):
        probe[u, u, 0] = 1.0
    out = dct.idct8x8(probe, xp=np)  # [8 probes, 8, 8]
    c0 = float(np.sqrt(max(out[0][0, 0], 1e-12)))
    A = np.stack([out[u][:, 0] / c0 for u in range(8)], axis=1)  # [x, u]
    # Orthonormal DCT-II bases.
    def orth(m):
        B = np.zeros((m, m))
        for u in range(m):
            g = np.sqrt(0.5) if u == 0 else 1.0
            for x in range(m):
                B[u, x] = np.sqrt(2.0 / m) * g * np.cos(
                    (2 * x + 1) * u * np.pi / (2 * m)
                )
        return B

    B8, Bn = orth(8), orth(n)
    # B8 @ A is diagonal (both diagonalize the same transform); its
    # diagonal carries the production kernel's frequency scaling.
    s = np.diag(B8 @ A)
    R = (Bn.T * (np.sqrt(n / 8.0) * s[:n])).astype(np.float32)  # [x, u<n]
    R = np.concatenate([R, np.zeros((n, 8 - n), np.float32)], axis=1)
    _SCALED_IDCT_CACHE[n] = R
    return R


_SCALED_FOLDED_CACHE: Dict[int, "np.ndarray"] = {}


def scaled_folded_matrix(n: int) -> "np.ndarray":
    """[64, n*n] folded reduced-IDCT: un-zigzag + R (x) R in ONE matmul
    over the zig-zag coefficient vector — the same single-matmul shape
    the full-resolution Pallas path uses, which is what the MXU wants
    (the tiny [n, 8] einsum form lowers poorly on TPU)."""
    if n in _SCALED_FOLDED_CACHE:
        return _SCALED_FOLDED_CACHE[n]
    R = scaled_idct_matrix(n).astype(np.float64)  # [x, u]
    M = np.zeros((64, n * n), dtype=np.float64)
    for z in range(64):
        nat = ZIGZAG_TO_BLOCK[z]
        u, v = nat // 8, nat % 8
        for x in range(n):
            for y in range(n):
                M[z, x * n + y] = R[x, u] * R[y, v]
    M = M.astype(np.float32)
    _SCALED_FOLDED_CACHE[n] = M
    return M


def dequantize_idct_shift_scaled(coeffs_zz, quant_zz, level_shift: int,
                                 n: int, xp=np):
    """[..., 64] zig-zag coeffs -> [..., n, n] int32 samples at scale n/8."""
    deq = (coeffs_zz.astype(xp.int32) * quant_zz.astype(xp.int32)).astype(
        xp.float32
    )
    M = xp.asarray(scaled_folded_matrix(n))
    pixels = deq @ M  # [..., 64] @ [64, n*n]
    pixels = pixels.reshape(pixels.shape[:-1] + (n, n))
    return xp.rint(pixels).astype(xp.int32) + level_shift


def component_plane_scaled(coeffs_zz, quant_zz, level_shift: int,
                           hs: int, vs: int, out_h: int, out_w: int,
                           n: int, xp=np):
    """Scaled decode transform for one component -> cropped int32 plane
    of the n/8-scaled image.

    Computed as n*n per-output-position matvecs producing full [Hb, Wb]
    planes, then one interleaving transpose — on TPU the minor (lane)
    dimension pads to 128, so the direct [..., n, n] form (minor n <= 4)
    wastes ~all of every vector op; the per-position planes keep Wb on
    the lanes throughout.
    """
    hb, wb = coeffs_zz.shape[0], coeffs_zz.shape[1]
    deq = (coeffs_zz.astype(xp.int32) * quant_zz.astype(xp.int32)).astype(
        xp.float32
    )
    M = xp.asarray(scaled_folded_matrix(n))
    grid = xp.stack(
        [deq @ M[:, k] for k in range(n * n)]
    )  # [n*n, Hb, Wb], position k = x*n + y inside the scaled block
    grid = xp.rint(grid).astype(xp.int32) + level_shift
    plane = (
        grid.reshape(n, n, hb, wb)
        .transpose(2, 0, 3, 1)
        .reshape(hb * n, wb * n)
    )
    plane = upsample_duplicate(plane, hs, vs, xp=xp)
    return plane[:out_h, :out_w]

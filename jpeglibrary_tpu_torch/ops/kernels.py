"""The port's two kernels and their wrappers.

K1, the decode transform: dequantize + un-zigzag + 2-D IDCT + round +
level shift over a batch of 8x8 blocks. Port of the decode half of
``jpeglibrary_tpu/ops/pallas_kernels.py``. The whole transform is linear
up to the rounding, so it is one product with a folded [64, 64] matrix
per block:

    samples[t, :] = rint( fl(coeff[t, :] * quant[:]) @ K ) + level_shift
    K[zz, 8*i+j]  = 0.125 * M[i, r(zz)] * M[j, c(zz)]

where M is the 1-D AAN IDCT butterfly written as a matrix and (r, c) the
natural position of zig-zag index zz. The scaled decode (1/2, 1/4, 1/8)
is the same product with the [64, n*n] reduced-IDCT matrix, which the
JAX package ran as n*n XLA matvecs; and a batch of images runs as one
launch with one quant table per image, where the JAX package vmapped K1.

:func:`dequantize_idct_shift` launches the hand-written CUDA kernel
(``csrc/dequant_idct.cu``) for a CUDA tensor, and takes the plain
PyTorch version (``decode_stage.dequantize_idct_shift``) only for a CPU
tensor. The Pallas wrapper padded to a 1024-block tile; the CUDA kernel,
a persistent grid that stages 128-block tiles asynchronously, masks its
ragged edge and nothing is padded.

K2, the encode transform: level shift + 2-D FDCT + zig-zag + quantize,
``rint(((s - level_shift) @ F) / q)`` with F the folded matrix of
``host.ops.encode_stage.fdct_zigzag_matrix``. Port of the
encode half of ``pallas_kernels.py``. :func:`fdct_quantize` launches
``csrc/fdct_quant.cu`` on a CUDA plane, which reads the [Hp, Wp] sample
plane itself instead of pre-cut blocks, and takes the plain version
(``encode_stage.fdct_quantize``) only for a CPU tensor.
"""

from __future__ import annotations

import functools
import threading
from typing import Optional

import torch

from ..host.ops.decode_stage import fused_transform_matrix, scaled_folded_matrix
from ..host.ops.encode_stage import fdct_zigzag_matrix
from . import _build, decode_stage, encode_stage


@functools.lru_cache(maxsize=16)
def transform_matrix(device: torch.device, n: int = 8) -> torch.Tensor:
    """K1's folded [64, n*n] matrix as a tensor on ``device`` (one copy per
    device and n): the full IDCT at n = 8, the scaled decode's reduced
    IDCT at n = 4, 2, 1."""
    if n == 8:
        return torch.from_numpy(fused_transform_matrix()).to(device)
    return torch.from_numpy(scaled_folded_matrix(n)).to(device)


_COUNT_LOCK = threading.Lock()


def dequantize_idct_shift(coeffs_zz: torch.Tensor, quants_zz: torch.Tensor,
                          level_shift: int, *, blocks_per_table: Optional[int] = None,
                          scale_n: int = 8) -> torch.Tensor:
    """[..., 64] zig-zag int32 (or int16) coefficients + int32 zig-zag
    quant tables -> int32 samples [..., n, n], n = ``scale_n``.

    ``quants_zz`` is one [64] table, or [G, 64] tables of which block t
    (in the flattened order of the leading dimensions) takes row
    ``t // blocks_per_table``: a batch of G images that each carry their
    own tables runs as one launch. ``scale_n`` 4, 2 or 1 gives the
    scaled decode's reduced blocks.

    ``dequantize_idct_shift.launches`` counts the CUDA kernel's launches."""
    if coeffs_zz.dtype not in (torch.int32, torch.int16):
        raise TypeError(f"coefficients must be int32 or int16, got {coeffs_zz.dtype}")
    if coeffs_zz.dim() < 1 or coeffs_zz.shape[-1] != 64:
        raise ValueError(f"coefficients must be [..., 64], got {tuple(coeffs_zz.shape)}")
    if (quants_zz.dtype != torch.int32 or quants_zz.dim() not in (1, 2)
            or quants_zz.shape[-1] != 64):
        raise ValueError(
            f"quant must be int32 [64] or [G, 64], got {quants_zz.dtype} "
            f"{tuple(quants_zz.shape)}"
        )
    if quants_zz.device != coeffs_zz.device:
        raise ValueError(
            f"quant on {quants_zz.device}, coefficients on {coeffs_zz.device}"
        )
    if scale_n not in (8, 4, 2, 1):
        raise ValueError(f"scale_n must be 8, 4, 2 or 1, got {scale_n}")
    n_blocks = coeffs_zz.numel() // 64
    n_tables = quants_zz.numel() // 64
    if blocks_per_table is None:
        if n_tables != 1:
            raise ValueError(f"{n_tables} quant tables need blocks_per_table")
        blocks_per_table = max(n_blocks, 1)
    if blocks_per_table < 1 or n_tables * blocks_per_table < n_blocks:
        raise ValueError(
            f"{n_tables} tables of {blocks_per_table} blocks do not cover {n_blocks} blocks"
        )
    device = coeffs_zz.device
    matrix = transform_matrix(device, scale_n)
    shape = coeffs_zz.shape[:-1] + (scale_n, scale_n)
    if device.type == "cpu":
        return decode_stage.dequantize_idct_shift(
            coeffs_zz, quants_zz, blocks_per_table, level_shift, matrix).reshape(shape)
    if device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {device}")
    if not (coeffs_zz.is_contiguous() and quants_zz.is_contiguous()):
        raise ValueError("coefficients and quant must be contiguous")

    out = torch.empty(shape, dtype=torch.int32, device=device)
    if n_blocks == 0:
        return out
    # The kernel copies and loads 16 bytes at a time; a view that starts
    # off that alignment is copied to a fresh (aligned) allocation.
    if coeffs_zz.data_ptr() % 16:
        coeffs_zz = coeffs_zz.clone()
    if quants_zz.data_ptr() % 16:
        quants_zz = quants_zz.clone()
    lib = _build.load_library()
    fn = lib.jpx_dequant_idct_i32 if coeffs_zz.dtype == torch.int32 else lib.jpx_dequant_idct_i16
    with torch.cuda.device(device):
        err = fn(
            coeffs_zz.data_ptr(), quants_zz.data_ptr(), matrix.data_ptr(), out.data_ptr(),
            n_blocks, blocks_per_table, scale_n * scale_n, int(level_shift),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        dequantize_idct_shift.launches += 1
    return out


dequantize_idct_shift.launches = 0


@functools.lru_cache(maxsize=16)
def fdct_matrix(device: torch.device) -> torch.Tensor:
    """K2's folded FDCT + zig-zag matrix on ``device`` (one copy per device)."""
    return torch.from_numpy(fdct_zigzag_matrix()).to(device)


def fdct_quantize(plane: torch.Tensor, quant_zz: torch.Tensor,
                  level_shift: int) -> torch.Tensor:
    """[Hb*8, Wb*8] int32 (or uint8) sample plane + [64] int32 zig-zag
    quant -> int16 zig-zag coefficients [Hb, Wb, 64].

    ``fdct_quantize.launches`` counts the CUDA kernel's launches."""
    if plane.dtype not in (torch.int32, torch.uint8):
        raise TypeError(f"samples must be int32 or uint8, got {plane.dtype}")
    if plane.dim() != 2 or plane.shape[0] % 8 or plane.shape[1] % 8:
        raise ValueError(
            f"samples must be one [H, W] plane with H and W multiples of 8, "
            f"got {tuple(plane.shape)}"
        )
    if quant_zz.dtype != torch.int32 or tuple(quant_zz.shape) != (64,):
        raise ValueError(
            f"quant must be int32 [64], got {quant_zz.dtype} {tuple(quant_zz.shape)}"
        )
    if quant_zz.device != plane.device:
        raise ValueError(f"quant on {quant_zz.device}, samples on {plane.device}")
    device = plane.device
    matrix = fdct_matrix(device)
    if device.type == "cpu":
        return encode_stage.fdct_quantize(plane, quant_zz, level_shift, matrix)
    if device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {device}")
    if not (plane.is_contiguous() and quant_zz.is_contiguous()):
        raise ValueError("samples and quant must be contiguous")

    hb, wb = plane.shape[0] // 8, plane.shape[1] // 8
    out = torch.empty((hb, wb, 64), dtype=torch.int16, device=device)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    fn = lib.jpx_fdct_quant_i32 if plane.dtype == torch.int32 else lib.jpx_fdct_quant_u8
    with torch.cuda.device(device):
        err = fn(
            plane.data_ptr(), quant_zz.data_ptr(), matrix.data_ptr(), out.data_ptr(),
            hb, wb, int(level_shift), torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"K2 launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        fdct_quantize.launches += 1
    return out


fdct_quantize.launches = 0

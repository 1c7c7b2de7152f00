"""The batch step of the JAX package's ``parallel/sharding.py``, on one
device.

Port of the single-device part of ``jpeglibrary_tpu/parallel/sharding.py``
(``:39-137`` and ``:409-440``): ``full_step``, the package's flagship
device step (the decode transform of a batch of 4:2:0 images, the full
re-encode transform and the true Huffman symbol statistics), its helpers,
``assemble_stripes`` and ``batched_transform_rgb``. The decode half runs
K1 (``kernels.dequantize_idct_shift``), the re-encode K2
(``kernels.fdct_quantize``, which fuses the chroma's 2x2 box), the
statistics ``encode_stage.symbol_histograms_device``.

The mesh (``make_mesh``, the sharded step, ``mesh_symbol_frequencies``,
``decode_rgb_sharded``) is not ported yet: a ``mesh`` argument raises.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..host.models.geometry import FrameGeometry
from ..ops import color, decode_stage, encode_stage, kernels
from ..ops.pipeline import transform_dense


def _fdct_quantize_batch(planes: torch.Tensor, qt_zz: torch.Tensor, *, hs: int = 1,
                         vs: int = 1, k2=kernels.fdct_quantize) -> torch.Tensor:
    """[B, H, W] uint8 or int32 samples -> int16 [B, H/(8 vs), W/(8 hs), 64]
    zig-zag coefficients: the (hs, vs) box ``(sum + n/2) // n``, level
    shift 128, FDCT and quantize; JAX's ``_fdct_quantize_batch`` (after
    ``box2x2`` at hs = vs = 2). One K2 launch for the batch: the images
    stack as one [B*H, W] plane, and since H is a multiple of 8 vs no
    block row crosses from one image into the next (one launch per image
    would pay a launch and a ragged last wave per image). ``k2`` is K2's
    wrapper, or a function of the same signature (its plain version)."""
    b, h, w = planes.shape
    if h % (8 * vs) or w % (8 * hs):
        raise ValueError(f"{h} x {w} planes are not whole blocks at ({hs}, {vs})")
    hb, wb = h // (8 * vs), w // (8 * hs)
    out = k2(planes.reshape(b * h, w), qt_zz, 128, hs=hs, vs=vs, blocks=(b * hb, wb))
    return out.reshape(b, hb, wb, 64)


def _mcu_order_batch(coeffs: torch.Tensor, h: int, v: int) -> torch.Tensor:
    """[B, Hb, Wb, 64] -> [B, N, 64] in the interleaved MCU walk order
    (per MCU: v rows of h blocks), the order of the DC predictor chain."""
    b, hb, wb, _ = coeffs.shape
    mr, mc = hb // v, wb // h
    x = coeffs.reshape(b, mr, v, mc, h, 64)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, mr * mc * v * h, 64)


def _component_plane(coeffs: torch.Tensor, qt_zz: torch.Tensor, up: int, k1) -> torch.Tensor:
    """One component's decode: [B, Hb, Wb, 64] zig-zag coefficients -> K1
    (one launch for the batch) -> int32 [B, Hb*8*up, Wb*8*up] samples,
    duplicated ``up`` times each way."""
    samples = k1(coeffs.contiguous(), qt_zz, 128)
    return decode_stage.upsample_duplicate(decode_stage.blocks_to_plane(samples), up, up)


def full_step(y_coeffs, cb_coeffs, cr_coeffs, qt_luma, qt_chroma, *, device):
    """The flagship device step over a batch of 4:2:0 images, on
    ``device``: the decode transform (dequantize + IDCT + level shift,
    duplicate upsampling, YCbCr -> RGB), the full re-encode transform
    (RGB -> YCbCr, the chroma's 2x2 box, FDCT + quantize of every
    component) and the DC and AC Huffman symbol histograms of the
    re-encoded blocks, per table class.

    ``y_coeffs`` int16 [B, Hb, Wb, 64] and ``cb_coeffs``, ``cr_coeffs``
    int16 [B, Hb/2, Wb/2, 64] zig-zag; ``qt_luma``, ``qt_chroma`` int32
    [64] zig-zag. Inputs not on ``device`` are copied there. Returns (rgb
    uint8 [B, H, W, 3], requant_y int16 [B, Hb, Wb, 64], hists int32
    [4, 256]: DC luma, AC luma, DC chroma, AC chroma), on ``device``. On
    the card: 3 K1 and 3 K2 launches."""
    rgb, requant, hists = _step(*_step_inputs(y_coeffs, cb_coeffs, cr_coeffs, qt_luma,
                                              qt_chroma, device),
                                kernels.dequantize_idct_shift, kernels.fdct_quantize)
    return rgb, requant[0], hists


def _step_inputs(y_coeffs, cb_coeffs, cr_coeffs, qt_luma, qt_chroma, device):
    """:func:`full_step`'s arguments as tensors on ``device``: the
    coefficients int16, the tables int32."""
    def to_dev(x, dtype):
        return torch.as_tensor(x, device=device).to(dtype)

    return (*(to_dev(c, torch.int16) for c in (y_coeffs, cb_coeffs, cr_coeffs)),
            to_dev(qt_luma, torch.int32), to_dev(qt_chroma, torch.int32))


def _step(y_coeffs, cb_coeffs, cr_coeffs, qt_luma, qt_chroma, k1, k2):
    """:func:`full_step` on tensors of one device, with K1's and K2's
    wrappers (or functions of their signatures: their plain versions, the
    yardstick ``chip_smoke.py`` holds the step to on the card) as ``k1``
    and ``k2``. Returns (rgb, (requant_y, requant_cb, requant_cr), hists):
    the step's outputs with the requantised chroma it counts besides."""
    b = y_coeffs.shape[0]

    # The decode transform.
    y8, cb8, cr8 = (
        decode_stage.clamp_to_uint8(_component_plane(c, q, up, k1))
        for c, q, up in ((y_coeffs, qt_luma, 1), (cb_coeffs, qt_chroma, 2),
                         (cr_coeffs, qt_chroma, 2))
    )
    r, g, bl = color.ycbcr_to_rgb(y8, cb8, cr8)
    rgb = torch.stack([r, g, bl], dim=-1)

    # The re-encode transform, all three components; K2 boxes the chroma.
    y2, cb2, cr2 = color.rgb_to_ycbcr(r, g, bl)
    requant_y = _fdct_quantize_batch(y2, qt_luma, k2=k2)
    requant_cb = _fdct_quantize_batch(cb2, qt_chroma, hs=2, vs=2, k2=k2)
    requant_cr = _fdct_quantize_batch(cr2, qt_chroma, hs=2, vs=2, k2=k2)

    # The symbol statistics; each chroma component is a chain of its own.
    y_mcu = _mcu_order_batch(requant_y, 2, 2)
    chroma_mcu = torch.cat([requant_cb.reshape(b, -1, 64), requant_cr.reshape(b, -1, 64)])
    dc_l, ac_l = encode_stage.symbol_histograms_device(y_mcu)
    dc_c, ac_c = encode_stage.symbol_histograms_device(chroma_mcu)
    return rgb, (requant_y, requant_cb, requant_cr), torch.stack([dc_l, ac_l, dc_c, ac_c])


def assemble_stripes(stripes, heights) -> np.ndarray:
    """Host assembly of stripes [S, 3, stripe_px, W]: [3, H, W] uint8,
    each stripe cut to its true height."""
    arr = stripes.cpu().numpy() if torch.is_tensor(stripes) else np.asarray(stripes)
    return np.concatenate([arr[i][:, :h, :] for i, h in enumerate(heights) if h > 0], axis=1)


def batched_transform_rgb(coeffs_batch: Sequence, quants, geometry: FrameGeometry, mesh=None,
                          *, device) -> torch.Tensor:
    """Decode-transform a batch of same-geometry images to uint8 RGB
    [B, H, W, 3] on ``device``: ``coeffs_batch`` holds one sequence of
    per-component [Hb, Wb, 64] coefficient planes per image, ``quants``
    the [64] zig-zag tables every image shares. One K1 launch per
    component for the batch. A ``mesh`` is not ported yet and raises."""
    if mesh is not None:
        raise ValueError("batched_transform_rgb over a mesh is not ported to PyTorch yet")
    stacked = [torch.stack([torch.as_tensor(c[i]) for c in coeffs_batch]).to(device)
               for i in range(len(quants))]
    q = torch.stack([torch.as_tensor(np.asarray(x), dtype=torch.int32) for x in quants])
    q = q.to(device).expand(len(coeffs_batch), -1, -1).contiguous()
    return transform_dense(stacked, q, geometry, device, output="rgb8")

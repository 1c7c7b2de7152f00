"""Device RGB output of a decoded JPEG, in PyTorch.

Port of ``jpeglibrary_tpu.models.decoder.DecodeResult.to_rgb8_device``
(the v2-wire branch and its guards). The host decode stays the JAX
package's own: ``JpegDecoder.decode(sparse_direct=True)`` returns a
``DecodeResult`` whose numpy state (the v2 payload and the quant tables)
this module carries onto the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from jpeglibrary_tpu.models.decoder import DecodeResult

from ..ops.pipeline import transform_mcu2


def device_inputs(result: DecodeResult, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The v2 payload (flat uint8) and the stacked ``[C, 64]`` int32
    zig-zag quant tables, as tensors on ``device``."""
    if result.packed_mcu2 is None:
        raise ValueError(
            "result carries no v2 payload; decode with "
            "JpegDecoder.decode(sparse_direct=True) and the native scanner"
        )
    quants = np.stack(
        [result.quant[c.component_index] for c in result.geometry.components]
    ).astype(np.int32)
    payload = torch.from_numpy(result.packed_mcu2).to(device)
    return payload, torch.from_numpy(quants).to(device)


def to_rgb8_device(result: DecodeResult, *, device, upsample: str = "duplicate",
                   scale: float = 1.0) -> torch.Tensor:
    """Planar ``[3, H, W]`` uint8 RGB on ``device`` for a baseline
    YCbCr or grayscale result that carries a v2 payload.

    Raises for what this port does not cover yet: lossless results,
    other colour transforms, ``scale != 1``, ``upsample != "duplicate"``
    and results without a v2 payload. ``upsample`` and ``scale`` keep
    the JAX signature only: their defaults are the one setting ported,
    and any other value raises."""
    if scale != 1:
        raise ValueError("only scale=1 is ported to the PyTorch device path")
    if upsample != "duplicate":
        raise ValueError("only duplicate upsampling is ported to the PyTorch device path")
    if result.samples is not None:
        raise ValueError("lossless results have no device transform stage")
    if result.color_transform not in ("ycbcr", "gray"):
        raise ValueError(
            "device RGB transform covers YCbCr/grayscale streams; "
            f"this stream is {result.color_transform} — use the host "
            "to_rgb8()/to_cmyk8() writers."
        )
    payload, quants = device_inputs(result, device)
    return transform_mcu2(payload, quants, result.geometry, device)

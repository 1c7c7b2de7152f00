"""Device RGB output of a decoded JPEG, in PyTorch.

Port of ``jpeglibrary_tpu.models.decoder.DecodeResult.to_rgb8_device``
with every branch but the packer-less one (the port always builds the
native packer): the v2 split-stream wire, the v1 MCU wire, the v1
plane-order wire of ``prepack``, and the dense planes, at full size and
at 1/2, 1/4 and 1/8, with duplicate or fancy upsampling. The host decode is the port's copy of the JAX
package's (``host/models/decoder.py``):
``JpegDecoder.decode(sparse_direct=True)`` returns a ``DecodeResult``
whose numpy state (payloads, coefficient planes, quant tables) this
module carries onto the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..host.models.decoder import DecodeResult
from ..host.parallel.batch import _stacked_quants
from ..ops import _build
from ..ops.pipeline import transform_delta, transform_dense, transform_mcu, transform_mcu2


def scale_n_of(scale: float) -> int:
    """The reduced block size n of ``scale`` = n/8, for scale in {1, 1/2,
    1/4, 1/8}; raises for any other scale."""
    scale_n = int(round(8 * scale))
    if scale_n not in (1, 2, 4, 8) or abs(8 * scale - scale_n) > 1e-9:
        raise ValueError("scale must be 1, 1/2, 1/4 or 1/8")
    return scale_n


def quant_tables(result: DecodeResult) -> np.ndarray:
    """The result's ``[C, 64]`` int32 zig-zag quant tables, in component order."""
    return _stacked_quants([result], result.geometry)[0]


def device_inputs(result: DecodeResult, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The v2 payload (flat uint8) and the stacked ``[C, 64]`` int32
    zig-zag quant tables, as tensors on ``device``."""
    if result.packed_mcu2 is None:
        raise ValueError(
            "result carries no v2 payload; decode with "
            "JpegDecoder.decode(sparse_direct=True) and the native scanner"
        )
    payload = torch.from_numpy(result.packed_mcu2).to(device)
    return payload, torch.from_numpy(quant_tables(result)).to(device)


def delta_payload(result: DecodeResult) -> np.ndarray:
    """The v1 plane-order payload of a result without a fused-scan payload:
    the one ``prepack`` left, or the native packer's now."""
    packed = getattr(result, "_packed", None)
    if packed is None:
        _build.load_scanner()  # the native packer; there is no numpy fallback
        from ..host.native import scanner as native_scanner

        planes = [result.coefficients[c.component_index] for c in result.geometry.components]
        packed = native_scanner.pack_sparse(planes).reshape(-1)
    return packed


def check_device_color(result: DecodeResult) -> None:
    """Raise for a result that has no device RGB transform: a lossless
    result, or a colour transform other than YCbCr or grayscale."""
    if result.samples is not None:
        raise ValueError("lossless results have no device transform stage")
    if result.color_transform not in ("ycbcr", "gray"):
        raise ValueError(
            "device RGB transform covers YCbCr/grayscale streams; "
            f"this stream is {result.color_transform} — use the host "
            "to_rgb8()/to_cmyk8() writers."
        )


def sparse_wire(result: DecodeResult):
    """``(transform, wire)``: the result's v2 payload for
    ``transform_mcu2``, else its v1 MCU payload for ``transform_mcu``,
    else the v1 plane-order payload of its coefficient planes for
    ``transform_delta``; the wire is a host array."""
    if result.packed_mcu2 is not None:
        return transform_mcu2, result.packed_mcu2
    if result.packed_mcu is not None:
        return transform_mcu, result.packed_mcu
    return transform_delta, delta_payload(result)


def to_rgb8_device(result: DecodeResult, *, device, sparse: bool = True,
                   upsample: str = "duplicate", scale: float = 1.0) -> torch.Tensor:
    """Planar ``[3, H', W']`` uint8 RGB on ``device`` for a YCbCr or
    grayscale result, ``H' = ceil(H * scale)``.

    The result's wire picks the transform, as in the JAX package: its v2
    payload, else its v1 MCU payload, else (``sparse``) the v1
    plane-order payload of its coefficient planes, else the dense planes.
    ``scale`` in {1, 1/2, 1/4, 1/8} runs the reduced IDCT on the sparse
    wires. ``upsample="fancy"`` runs libjpeg's triangular chroma filter
    (full size only). Raises for lossless results, other colour
    transforms, other scales, fancy upsampling at a scale below 1 and a
    scaled dense decode."""
    scale_n = scale_n_of(scale)
    check_device_color(result)
    geometry = result.geometry
    quants = quant_tables(result)
    if sparse or result.packed_mcu2 is not None or result.packed_mcu is not None:
        transform, wire = sparse_wire(result)
        return transform(wire, quants, geometry, device, scale_n=scale_n, upsample=upsample)
    if scale_n != 8:
        raise ValueError("scaled device decode rides the sparse paths")
    planes = [result.coefficients[c.component_index] for c in geometry.components]
    return transform_dense(planes, quants, geometry, device, upsample=upsample)

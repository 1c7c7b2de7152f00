"""Bounded-memory streaming decode onto a PyTorch device: MCU-row stripes
handed to the caller one at a time.

Port of the device half of ``jpeglibrary_tpu/models/streaming.py``
(``decode_rgb_stripes``, ``_stripes_from_payload2``,
``decode_rgb_streaming``). The host half, which slices the merged scan's
compact payload into per-stripe payloads, is the port's copy
(``host/models/streaming.py``). Each stripe is one ``transform_mcu2`` (v2
wire) or ``transform_mcu`` (v1 MCU wire) call at stripe shape: one K1
launch per component. Only the compact payload and one stripe are live
at once; the full image is never built.

JAX's ``device=False``, which hands back numpy stripes, is ``to_numpy=True``
here: ``device`` names the PyTorch device the transform runs on.
"""

from __future__ import annotations

from typing import Callable, Iterator, Tuple

import torch

from ..host.models.decoder import JpegDecoder
from ..host.models.streaming import (
    _stripe_geometry,
    decode_lossless_rows,
    split_payload2_stripes,
    split_payload_stripes,
)
from ..ops import _build
from ..ops.pipeline import transform_mcu, transform_mcu2

__all__ = ["decode_lossless_rows", "decode_rgb_stripes", "decode_rgb_streaming"]


def _deliver(stripe: torch.Tensor, to_numpy: bool):
    return stripe.cpu().numpy() if to_numpy else stripe


def decode_rgb_stripes(data: bytes, *, device, stripe_mcu_rows: int = 16,
                       to_numpy: bool = False) -> Iterator[Tuple[int, object]]:
    """Decode a baseline JPEG as a stream of RGB stripes.

    Yields ``(y0, stripe)`` pairs top to bottom, where ``stripe`` is
    planar uint8 ``[3, stripe_height, W]`` on ``device`` (a numpy array
    with ``to_numpy``) and ``y0`` the first pixel row it covers. The final
    stripe is cropped to the image height.

    Requires the merged-scan fast path (a single-scan baseline stream);
    other streams raise ValueError, progressive and lossless among them,
    as in the JAX package. Rides the v2 split-stream wire when the scan
    produced it, else the v1 MCU wire (``JPX_WIRE=1``)."""
    _build.load_scanner()  # the merged scan; there is no Python fallback for it
    dec = JpegDecoder()
    dec.set_input(data)
    res = dec.decode(sparse_direct=True)
    if res.packed_mcu2 is not None:
        yield from _stripes_from_payload2(res, stripe_mcu_rows, device, to_numpy)
        return
    if res.packed_mcu is None:
        raise ValueError("streaming decode requires a single-scan baseline (SOF0/1) stream")
    stripes, geo, quants, heights = split_payload_stripes(res, stripe_mcu_rows)
    quants = torch.from_numpy(quants).to(device)
    px_per_mcu_row = 8 * geo.max_v
    for i, (payload, height) in enumerate(zip(stripes, heights)):
        r0 = i * stripe_mcu_rows
        r1 = min(r0 + stripe_mcu_rows, geo.mcus_per_column)
        sgeo = _stripe_geometry(geo, r1 - r0, height)
        stripe = transform_mcu(payload, quants, sgeo, device)
        yield r0 * px_per_mcu_row, _deliver(stripe, to_numpy)


def _stripes_from_payload2(res, stripe_mcu_rows: int, device, to_numpy: bool):
    """The v2 stripe walk: every stripe payload has one geometry (the tail
    stripe is padded with zero blocks by ``split_payload2_stripes``), and
    the tail's padding rows are cropped to the true height. An image
    shorter than one stripe clamps the stripe height to its MCU rows."""
    stripe_mcu_rows = min(stripe_mcu_rows, res.geometry.mcus_per_column)
    stripes, geo, quants, heights = split_payload2_stripes(res, stripe_mcu_rows)
    quants = torch.from_numpy(quants).to(device)
    px_per_mcu_row = 8 * geo.max_v
    sgeo = _stripe_geometry(geo, stripe_mcu_rows, stripe_mcu_rows * px_per_mcu_row)
    for i, (payload, height) in enumerate(zip(stripes, heights)):
        stripe = transform_mcu2(payload, quants, sgeo, device)
        if stripe.shape[1] != height:
            stripe = stripe[:, :height]
        yield i * stripe_mcu_rows * px_per_mcu_row, _deliver(stripe, to_numpy)


def decode_rgb_streaming(data: bytes, consumer: Callable[[int, object], None], *, device,
                         stripe_mcu_rows: int = 16, to_numpy: bool = False) -> None:
    """Push form of :func:`decode_rgb_stripes`: ``consumer(y0, stripe)``
    for each stripe in turn."""
    for y0, stripe in decode_rgb_stripes(data, device=device, stripe_mcu_rows=stripe_mcu_rows,
                                         to_numpy=to_numpy):
        consumer(y0, stripe)

"""Pipelined streaming decode onto a PyTorch device.

Port of ``jpeglibrary_tpu.parallel.batch.decode_stream_rgb`` (the
per-image path, ``group=1``): host threads run the native entropy scan
ahead while a device thread transforms, and results come back in input
order.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import torch

from jpeglibrary_tpu.models.decoder import DecodeResult, JpegDecoder

from ..models.decoder import to_rgb8_device
from ..ops import _build


def scan(data: bytes) -> DecodeResult:
    """Host stage: container walk + native entropy scan to the v2 wire."""
    dec = JpegDecoder()
    dec.set_input(data)
    res = dec.decode(sparse_direct=True)
    if res.packed_mcu2 is None:
        raise ValueError("the native scanner gave no v2 payload for this stream")
    return res


def decode_stream_rgb(datas, *, device, depth: int = 4, scan_workers: int = 2):
    """Yield planar ``[3, H, W]`` uint8 RGB tensors on ``device``, in
    input order, while ``scan_workers`` host threads scan ahead.

    One device thread runs the upload and transform and waits for each
    image's work on the current CUDA stream to finish, so ``depth``
    bounds the images in flight on the device as well as on the host.
    The native scanner is built (or its build fails) before the first
    image, so no image falls back to the Python scanner."""
    _build.load_scanner()
    device = torch.device(device)

    def transform(scan_fut):
        rgb = to_rgb8_device(scan_fut.result(), device=device)
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        return rgb

    with ThreadPoolExecutor(max_workers=scan_workers) as scan_pool, \
            ThreadPoolExecutor(max_workers=1) as device_pool:
        inflight = deque()
        for data in datas:
            inflight.append(device_pool.submit(transform, scan_pool.submit(scan, data)))
            while len(inflight) > depth:
                yield inflight.popleft().result()
        while inflight:
            yield inflight.popleft().result()

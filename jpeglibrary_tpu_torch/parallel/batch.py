"""Batched and pipelined streaming decode onto a PyTorch device.

Port of ``jpeglibrary_tpu.parallel.batch``: ``decode_batch_rgb`` groups a
batch by frame geometry and runs each group as one stacked transform;
``decode_stream_rgb`` runs the host scan ahead on threads while device
threads transform, image by image or in groups, each on its own CUDA
stream through its own pinned staging buffer, and yields results in
input order. The host stages (the scan, the grouping, the stacking of
payloads and quant tables) are the port's copy of the JAX package's
(``host/parallel/batch.py``); the stacked transforms are
``ops.pipeline``'s, which run each op once per group (one K1 launch per
component). ``encode_batch_rgb`` maps the port's ``encode_rgb`` over a
batch on the shared thread pool.
"""

from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..host.models.decoder import DecodeResult, JpegDecoder
from ..host.utils.pool import shared_pool
from ..host.parallel.batch import (
    _device_color_ok,
    _group_key,
    _stack_payloads2,
    _stacked_quants,
    scan_images,
)
from ..models.decoder import (check_device_color, delta_payload, quant_tables, scale_n_of,
                               sparse_wire)
from ..models.encoder import encode_rgb
from ..ops import _build, _device
from ..ops.pipeline import transform_delta, transform_mcu, transform_mcu2
from . import collectives
from .sharding import device_or_mesh


def scan(data: bytes) -> DecodeResult:
    """Host stage of the stream: container walk + entropy scan, with the
    sparse payload packed here (``prepack``) for streams the fused native
    scan declines, so the device thread only uploads and transforms."""
    dec = JpegDecoder()
    dec.set_input(data)
    res = dec.decode(sparse_direct=True)
    res.prepack()  # a no-op when the fused scan produced the payload
    return res


def group_wire(batch: Sequence[DecodeResult], geometry):
    """The stacked inputs of one transform over a group of same-geometry
    images: ``(transform, wire, quants)`` with their v2 payloads
    re-bucketed to one width (``transform_mcu2``), else their v1 MCU
    payloads when all share one shape (``transform_mcu``); None when
    neither fits. ``quants`` is ``[B, C, 64]``, each image's own tables."""
    stacked = _stack_payloads2(batch, geometry)
    transform = transform_mcu2
    if stacked is None and all(r.packed_mcu is not None for r in batch) \
            and len({r.packed_mcu.shape for r in batch}) == 1:
        stacked = np.stack([r.packed_mcu for r in batch])
        transform = transform_mcu
    if stacked is None:
        return None
    return transform, stacked, _stacked_quants(batch, geometry)


def _host_rgb(res: DecodeResult, scale_n: int) -> np.ndarray:
    """``[H', W', 3]`` uint8 from the host writers, as the JAX batch takes
    them for lossless and for RGB-coded or CMYK streams."""
    if scale_n != 8 and res.samples is None and res.color_transform == "rgb":
        return res.to_rgb8_scaled(scale_n / 8)
    rgb = res.to_rgb8()
    if scale_n != 8:
        rgb = rgb[:: 8 // scale_n, :: 8 // scale_n]
    return rgb


def decode_batch_rgb(datas: Sequence[bytes], *, device=None, mesh=None,
                     max_workers: Optional[int] = None,
                     scale: float = 1.0) -> List[np.ndarray]:
    """Decode a batch of JPEGs to ``[H', W', 3]`` uint8 RGB numpy arrays,
    in input order.

    Images of one frame geometry transform as one stacked call on
    ``device``: their v2 payloads re-bucketed to one width, else their v1
    MCU payloads when all share one shape, else their v1 plane-order
    payloads padded to one width; each group comes back in one download.
    Lossless images and RGB-coded, CMYK or YCCK streams take the host
    writers. ``scale`` in {1, 1/2, 1/4, 1/8} runs the reduced IDCT (host
    images are subsampled or scaled on the host).

    With a ``mesh`` (``sharding.make_mesh``; every rank calls with the same
    ``datas``) each group's stacked wire splits over ``data``, padded to a
    multiple of its size, each rank transforms its share on its device,
    and a gather gives every rank the whole list. At most one of ``device``
    and ``mesh`` is given; with neither, the card (``ops._device``)."""
    if device is None and mesh is None:
        device = _device.default_device()
    device = device_or_mesh(device, mesh, "decode_batch_rgb")
    scale_n = scale_n_of(scale)
    _build.load_scanner()
    results = scan_images(datas, max_workers=max_workers)

    groups: Dict[object, List[int]] = {}
    for i, r in enumerate(results):
        groups.setdefault(_group_key(r), []).append(i)

    out: List[Optional[np.ndarray]] = [None] * len(results)
    for geometry, indices in groups.items():
        on_device = []
        for i in indices:
            r = results[i]
            if r.samples is not None or not _device_color_ok(r):
                out[i] = _host_rgb(r, scale_n)
            else:
                on_device.append(i)
        if not on_device:
            continue
        batch = [results[i] for i in on_device]
        wire = group_wire(batch, geometry)
        if wire is None:
            packs = [delta_payload(r) for r in batch]
            stacked = np.zeros((len(packs), max(p.shape[0] for p in packs)), dtype=np.int16)
            for j, p in enumerate(packs):
                stacked[j, : p.shape[0]] = p  # (0, 0) padding adds zero
            wire = transform_delta, stacked, _stacked_quants(batch, geometry)
        transform, stacked, quants = wire
        if mesh is None:
            rgb = transform(stacked, quants, geometry, device, scale_n=scale_n)
        else:
            rgb = _transform_over_data(transform, stacked, quants, geometry, mesh, device,
                                       scale_n)
        rgb = rgb.permute(0, 2, 3, 1).contiguous().cpu().numpy()  # planar -> [B, H, W, 3]
        for j, i in enumerate(on_device):
            out[i] = rgb[j]
    return out


def _transform_over_data(transform, stacked: np.ndarray, quants: np.ndarray, geometry, mesh,
                         device, scale_n: int) -> torch.Tensor:
    """One group's stacked transform split over the mesh's ``data`` axis:
    the batch is zero-padded to a multiple of its size (a zero wire and
    zero tables decode to a flat block), each rank transforms its share,
    and the shares are gathered back in batch order on every rank."""
    n_data, d = mesh["data"].size(), mesh.get_local_rank("data")
    b = stacked.shape[0]
    per = -(-b // n_data)
    pad = n_data * per - b
    if pad:
        stacked = np.concatenate([stacked, np.zeros((pad,) + stacked.shape[1:], stacked.dtype)])
        quants = np.concatenate([quants, np.zeros((pad,) + quants.shape[1:], quants.dtype)])
    mine = slice(d * per, (d + 1) * per)
    local = transform(stacked[mine], quants[mine], geometry, device, scale_n=scale_n)
    return torch.cat(collectives.all_gather(local, mesh.get_group("data")))[:b]


STAGING_ALIGN = 16  # bytes: every array of a staged upload starts at a multiple


def _staged_layout(arrays: Sequence[np.ndarray]):
    """The byte offsets of ``arrays`` laid one after another, each at a
    multiple of ``STAGING_ALIGN`` (K1 loads 16 bytes at a time, and a
    dtype view of a byte buffer needs an aligned start), and the total."""
    offsets, total = [], 0
    for a in arrays:
        total = -(-total // STAGING_ALIGN) * STAGING_ALIGN
        offsets.append(total)
        total += a.nbytes
    return offsets, total


def _stage(host: np.ndarray, arrays: Sequence[np.ndarray], offsets) -> None:
    """Copy each array's bytes into the byte buffer ``host`` at its offset."""
    for a, o in zip(arrays, offsets):
        host[o : o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _unstage(flat: torch.Tensor, arrays: Sequence[np.ndarray], offsets) -> List[torch.Tensor]:
    """Views of the byte tensor ``flat`` with each array's dtype and shape
    at its offset."""
    return [flat[o : o + a.nbytes].view(torch.from_numpy(a[:0]).dtype).view(a.shape)
            for a, o in zip(arrays, offsets)]


def _pinned(n_bytes: int) -> torch.Tensor:
    """A page-locked host buffer of ``n_bytes``; raises where pinning fails."""
    return torch.empty(n_bytes, dtype=torch.uint8, pin_memory=True)


class _Uploader:
    """One device worker's CUDA stream and pinned staging buffer.

    The worker's uploads and transforms run on its own stream, so with two
    workers the copy engine moves one worker's wire while the SMs run the
    other's transform, the double buffer of the JAX stream. The buffer
    grows to the largest group the worker has staged, and is rewritten only
    once the event recorded after the copy that last read it has completed."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.staging = None
        self.copied = None

    def upload(self, arrays: Sequence[np.ndarray]) -> List[torch.Tensor]:
        """One non-blocking copy of ``arrays`` through the staging buffer,
        enqueued on the worker's stream; their device views."""
        offsets, total = _staged_layout(arrays)
        if self.copied is not None:
            self.copied.synchronize()
        if self.staging is None or self.staging.numel() < total:
            self.staging = _pinned(total)
        _stage(self.staging.numpy(), arrays, offsets)
        flat = self.staging[:total].to(self.device, non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record(self.stream)
        return _unstage(flat, arrays, offsets)

    def finish(self) -> None:
        """Wait for an event recorded after the group's work on the
        worker's stream: the group's one wait, which leaves the other
        worker's work alone."""
        done = torch.cuda.Event()
        done.record(self.stream)
        done.synchronize()


def decode_stream_rgb(datas, *, device=None, depth: int = 4, scan_workers: int = 2,
                      device_workers: int = 1, group: int = 1, scale: float = 1.0):
    """Yield planar ``[3, H', W']`` uint8 RGB tensors on ``device`` (the
    card when None), in input order, while ``scan_workers`` host threads
    scan ahead.

    ``device_workers`` threads upload and transform. On the card each
    worker has its own CUDA stream and a pinned staging buffer: a group's
    wire and quant tables go up in one non-blocking copy, and the worker
    waits for its own stream's event before it hands the group on, so
    with 2 workers the upload of one group runs under the transform of
    the other. ``depth`` (at least ``device_workers``) bounds the groups
    in flight on the device as well as on the host. ``group`` > 1 runs up
    to ``group`` consecutive images of one geometry as one stacked
    transform: their v2 payloads, else their v1 MCU payloads of one
    shape, else image by image. ``scale`` in {1, 1/2, 1/4, 1/8} runs the
    reduced IDCT. Lossless images are decoded on the host and handed back
    on ``device`` like the rest. RGB-coded and CMYK streams raise, as
    ``to_rgb8_device`` does. The native scanner is built (or its build
    fails) before the first image, so no image falls back to the Python
    scanner. A device that is neither the CPU nor a CUDA card raises, and
    so does a failed pin or stream: there is no synchronous fallback."""
    scale_n = scale_n_of(scale)
    device = _device.resolve(device)
    _build.load_scanner()
    workers = threading.local()  # each device worker's _Uploader, for this call

    def plan(ress):
        """The group's steps, in output order: ``(transform, geometry,
        host arrays)`` of one stacked transform over the group or over one
        image (a batch of one), or ``(None, None, (rgb,))`` for a lossless
        image's host RGB, handed back as it is."""
        # The stacked transforms apply the YCbCr matrix; RGB-coded and CMYK
        # streams go image by image, where check_device_color raises.
        if (len(ress) > 1 and all(_device_color_ok(r) for r in ress)
                and len({r.geometry for r in ress}) == 1):
            wire = group_wire(ress, ress[0].geometry)
            if wire is not None:
                transform, stacked, quants = wire
                return [(transform, ress[0].geometry, (stacked, quants))]
        steps = []
        for r in ress:
            if r.samples is not None:
                rgb = np.ascontiguousarray(np.moveaxis(_host_rgb(r, scale_n), -1, 0))
                steps.append((None, None, (rgb,)))
                continue
            check_device_color(r)
            transform, wire = sparse_wire(r)
            steps.append((transform, r.geometry, (wire[None], quant_tables(r)[None])))
        return steps

    def run(steps, tensors):
        """The steps' outputs, given their arrays as tensors in order."""
        outs, i = [], 0
        for transform, geometry, arrays in steps:
            args = tensors[i : i + len(arrays)]
            i += len(arrays)
            outs += args if transform is None else list(
                transform(*args, geometry, device, scale_n=scale_n))
        return outs

    def transform_group(scan_futs):
        steps = plan([f.result() for f in scan_futs])
        arrays = [a for _, _, step_arrays in steps for a in step_arrays]
        if device.type == "cpu":
            # No staging here: a CPU "upload" of a staged buffer would be
            # the buffer itself, and its next group would overwrite images
            # already handed on.
            return run(steps, [torch.from_numpy(a) for a in arrays])
        up = getattr(workers, "uploader", None)
        if up is None:
            up = workers.uploader = _Uploader(device)
        with torch.cuda.stream(up.stream):
            outs = run(steps, up.upload(arrays))
            up.finish()
        return outs

    def hand_off(fut):
        outs = fut.result()
        if device.type != "cpu":
            # Allocated on a worker's stream: the caching allocator must not
            # give the memory back to that stream while the caller's work
            # still reads it.
            caller = torch.cuda.current_stream(device)
            for t in outs:
                t.record_stream(caller)
        return outs

    with ThreadPoolExecutor(max_workers=scan_workers) as scan_pool, \
            ThreadPoolExecutor(max_workers=device_workers) as device_pool:
        inflight = deque()
        pending = []

        def flush():
            if pending:
                inflight.append(device_pool.submit(transform_group, list(pending)))
                pending.clear()

        bound = max(depth, device_workers)
        for data in datas:
            pending.append(scan_pool.submit(scan, data))
            if len(pending) >= max(1, group):
                flush()
            while len(inflight) > bound:
                yield from hand_off(inflight.popleft())
        flush()
        while inflight:
            yield from hand_off(inflight.popleft())


def encode_batch_rgb(rgbs: Sequence[np.ndarray], quality: int = 75, *, device=None,
                     xp=None, max_workers: Optional[int] = None,
                     **encode_kwargs) -> List[bytes]:
    """Encode a batch of RGB images, in input order: the port of
    ``jpeglibrary_tpu.encode_batch_rgb``. Each image is one
    ``encode_rgb(rgb, quality, device=device, xp=xp, **encode_kwargs)`` (3
    K2 launches on a device; ``xp=np`` is the host encoder, and with
    neither ``xp`` nor ``device`` the card), the images spread over the
    shared thread pool (or a pool of ``max_workers``); an image's failure
    raises from its position."""
    def one(rgb: np.ndarray) -> bytes:
        return encode_rgb(rgb, quality, device=device, xp=xp, **encode_kwargs)

    items = list(rgbs)
    if len(items) <= 1:
        return [one(items[0])] if items else []
    if max_workers is not None:
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            return list(pool.map(one, items))
    return list(shared_pool().map(one, items))

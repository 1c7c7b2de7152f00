"""Entry points of the port for a harness: the single-device step and a
multi-device dry run.

The port's counterpart of the repository's ``__graft_entry__.py``.
:func:`entry` returns the flagship device step, ``full_step`` (the decode
transform, the full re-encode transform and the Huffman symbol
histograms of a batch of 4:2:0 images), bound to a device, with small
example inputs. :func:`dryrun_multichip` spawns one rank per device and
runs the sharded step, the stripe-sharded decode in three modes and the
global batch decode over their mesh, each held to its single-device
counterpart.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _example_args(batch: int = 2, hb: int = 8, wb: int = 16):
    from .host.syntax.quantization import STANDARD_CHROMINANCE_ZIGZAG, STANDARD_LUMINANCE_ZIGZAG

    rng = np.random.default_rng(0)
    y = rng.integers(-64, 64, size=(batch, hb, wb, 64), dtype=np.int16)
    cb = rng.integers(-32, 32, size=(batch, hb // 2, wb // 2, 64), dtype=np.int16)
    cr = rng.integers(-32, 32, size=(batch, hb // 2, wb // 2, 64), dtype=np.int16)
    return (y, cb, cr, STANDARD_LUMINANCE_ZIGZAG.astype(np.int32),
            STANDARD_CHROMINANCE_ZIGZAG.astype(np.int32))


def entry(*, device="cuda"):
    """``(step, example_args)``: ``full_step`` bound to ``device`` and its
    example inputs as tensors there."""
    from .parallel.sharding import full_step

    return (functools.partial(full_step, device=device),
            tuple(torch.from_numpy(a).to(device) for a in _example_args()))


def _dryrun_image() -> np.ndarray:
    rng = np.random.default_rng(1)
    return np.clip(np.linspace(0, 255, 64)[None, :, None] + rng.normal(0, 10, (64, 64, 3)),
                   0, 255).astype(np.uint8)


def _dryrun_rank(n_devices: int, device_type: str) -> dict:
    """One rank of :func:`dryrun_multichip`: every check raises on failure;
    returns the rank's K1 and K2 launches."""
    from .host.models.decoder import JpegDecoder
    from .host.models.encoder import encode_rgb
    from .host.models.lossless import encode_lossless
    from .host.models.progressive_encoder import encode_progressive_rgb
    from .models.decoder import to_rgb8_device
    from .ops import kernels
    from .parallel import distributed
    from .parallel.batch import decode_batch_rgb
    from .parallel.collectives import full_tensor
    from .parallel.sharding import (
        assemble_stripes,
        decode_rgb_sharded,
        full_step,
        make_mesh,
        make_sharded_full_step,
        mesh_device,
    )

    stripe = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices, stripe=stripe, device_type=device_type)
    device = mesh_device(mesh)
    kernels.dequantize_idct_shift.launches = kernels.fdct_quantize.launches = 0

    # The sharded step: whole MCU rows on every stripe, its shapes, one DC
    # symbol per block (luma chains cover every luma block, chroma chains
    # both half-size planes), and equal to the step on one device.
    args = _example_args(batch=2 * (n_devices // stripe), hb=4 * stripe, wb=16)
    rgb, requant, hists = make_sharded_full_step(mesh)(*args)
    y = args[0]
    if tuple(rgb.shape) != (y.shape[0], y.shape[1] * 8, y.shape[2] * 8, 3):
        raise AssertionError(f"sharded step RGB shape {tuple(rgb.shape)}")
    hists = full_tensor(hists)
    n_luma = y.shape[0] * y.shape[1] * y.shape[2]
    if int(hists[0].sum()) != n_luma or int(hists[2].sum()) != 2 * (n_luma // 4):
        raise AssertionError("sharded step DC symbol counts")
    for got, want in zip((full_tensor(rgb), full_tensor(requant), hists),
                         full_step(*args, device=device)):
        if not torch.equal(got, want):
            raise AssertionError("sharded step != single-device step")

    # The stripe-sharded decode in its three modes, against the host decode
    # (lossless) and the single-device transform (DCT modes, which round
    # their IDCT in float on the device).
    img = _dryrun_image()
    for what, data in (("baseline", encode_rgb(img, 85)),
                       ("progressive", encode_progressive_rgb(img, 85)),
                       ("lossless", encode_lossless(img, predictor=1))):
        stripes, heights = decode_rgb_sharded(data, mesh)
        got = assemble_stripes(stripes, heights)
        dec = JpegDecoder()
        dec.set_input(data)
        res = dec.decode(sparse_direct=True)
        if what == "lossless":
            want = np.moveaxis(res.to_rgb8(), -1, 0)
        else:
            want = to_rgb8_device(res, device=device, sparse=False).cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"sharded {what} decode != single-device decode")

    # The global batch decode, one image per rank.
    variants = [img, img[::-1].copy(), img[:, ::-1].copy(), np.roll(img, 32, axis=0)]
    datas = [encode_rgb(variants[i % 4], 85) for i in range(n_devices)]
    batch = distributed.decode_batch_rgb_global(datas, device_type=device_type)
    block = distributed.local_batch_block(len(datas))
    want = decode_batch_rgb([datas[i] for i in block], device=device)
    for got, w in zip(batch.to_local().cpu().numpy(), want):
        if not np.array_equal(np.moveaxis(got, 0, -1), w):
            raise AssertionError("decode_batch_rgb_global != single-device decode")
    return {"k1": kernels.dequantize_idct_shift.launches, "k2": kernels.fdct_quantize.launches}


def dryrun_multichip(n_devices: int, *, device_type: str = "cuda"):
    """Spawn ``n_devices`` ranks (NCCL for CUDA, gloo for CPU) and run one
    sharded step, the stripe-sharded decode of a baseline, a progressive
    and a lossless image, and the global batch decode over their mesh,
    each equal to its single-device counterpart. Raises if any rank fails
    or the ranks outlast ``spawn``'s time limit; returns each rank's K1
    and K2 launches."""
    from .parallel import distributed

    return distributed.spawn(_dryrun_rank, n_devices, n_devices, device_type,
                             backend=distributed.BACKENDS[device_type])

"""Mesh policy and sharded batch pipelines, over ``torch.distributed``.

Port of ``jpeglibrary_tpu/parallel/sharding.py``. JAX's ``Mesh`` is one
controller over many devices; here a mesh is a
``torch.distributed`` ``DeviceMesh`` with dims ``("data", "stripe")`` over
an initialized process group, one rank per device (NCCL on GPUs, gloo on
CPU ranks), and every function runs SPMD: each rank calls it with the
same arguments and works on its own block.

- axis ``data``: independent images (or blocks) of a batch;
- axis ``stripe``: MCU block rows within an image (IDCT, upsampling and
  colour are block-row local, so stripes shard with no halo).

Where the JAX function returns a sharded global array, the port returns a
``DTensor`` built with ``DTensor.from_local`` (no communication):
``to_local()`` is the rank's shard, ``full_tensor()`` the whole. Where it
returns host numpy, every rank returns the same full result. The only
traffic is ``collectives``': the histogram all-reduce, the last DC of each
DC predictor chain at a shard boundary, and the gathers of the batch
decode.

The single-device part: ``full_step``, the package's flagship device step
(the decode transform of a batch of 4:2:0 or 4:2:2 images, the full
re-encode transform and the true Huffman symbol statistics),
``assemble_stripes`` and ``batched_transform_rgb``. The decode half runs
K1 (``kernels.dequantize_idct_shift``), the colour round trip K6
(``kernels.color_round_trip``: K1's samples to the RGB output and K2's
uint8 planes), the re-encode K2 (``kernels.fdct_quantize``, which fuses
the chroma's 2x2 or 2x1 box), the statistics
``encode_stage.symbol_histograms_device`` (K5,
``kernels.symbol_histograms``, on the requantised int16 planes where K2
wrote them, walked in MCU order in place): 3 K1, 1 K6, 3 K2 and 2 K5
launches a step. ``gray_step`` is the same re-encoding step for a batch
of one-component frames at 8 or 12 bits (a CT series): K1's plane store
(``kernels.dequantize_idct_plane``, the uint16 samples), K2 on those
planes where they lie and K5 on the requantised planes, 1 launch each.
The sharded forms run the same kernels on each rank's device.
``progressive_step`` is the count pass of a lossless progressive transcode:
K7 (``kernels.progressive_histograms``), the symbol histograms of each
image under a progressive scan script, 3 launches a batch and 1 for the
EOB runs' stitch.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..host.models.geometry import FrameGeometry, ceil_div
from ..ops import color, decode_stage, encode_stage, kernels
from ..ops._trace import span
from ..ops.pipeline import transform_dense, transform_mcu, transform_mcu2
from . import collectives

MESH_DIMS = ("data", "stripe")


def make_mesh(n_devices: Optional[int] = None, *, stripe: int = 1, device_type: str = "cuda"):
    """A ``("data", "stripe")`` DeviceMesh of shape ``(n // stripe,
    stripe)`` over the initialized process group, one rank per device;
    ``n_devices`` None means the whole world. Raises without an
    initialized group whose size is ``n_devices``, when ``stripe`` does
    not divide it, and for a CUDA mesh without CUDA."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(distributed.initialize, or torchrun)")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices % stripe != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by stripe={stripe}")
    if n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices over a world of {world} ranks: "
                         "the port runs one rank per device")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs CUDA")
    return init_device_mesh(device_type, (n_devices // stripe, stripe), mesh_dim_names=MESH_DIMS)


def check_mesh(mesh) -> None:
    """Raise ValueError unless ``mesh`` is a DeviceMesh with the dims of
    :func:`make_mesh`'s over every rank of the process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not (isinstance(mesh, DeviceMesh) and tuple(mesh.mesh_dim_names or ()) == MESH_DIMS):
        raise ValueError(f"mesh must be a DeviceMesh with dims {MESH_DIMS} (make_mesh), "
                         f"got {type(mesh).__name__}")
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"a mesh of {mesh.size()} ranks in a world of "
                         f"{dist.get_world_size()}: a mesh spans the whole world")


def mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh``: its current CUDA device on a CUDA
    mesh."""
    check_mesh(mesh)
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def device_or_mesh(device, mesh, what: str) -> torch.device:
    """The device an entry point taking ``device`` or ``mesh`` runs on:
    ``device`` without a mesh, the rank's mesh device with one. Exactly
    one of the two must be given."""
    if mesh is None:
        if device is None:
            raise ValueError(f"{what} needs a device or a mesh")
        return device
    if device is not None:
        raise ValueError(f"{what} takes a device or a mesh, not both: a mesh runs on "
                         "each rank's own device")
    return mesh_device(mesh)


def _placements(mesh, sharded: Dict[str, int]):
    """One placement per mesh dim: ``Shard(sharded[name])`` where the dim is
    named in ``sharded``, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(sharded[name]) if name in sharded else Replicate()
            for name in mesh.mesh_dim_names]


def _from_local(local: torch.Tensor, mesh, sharded: Dict[str, int]):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, _placements(mesh, sharded), run_check=False)


def _fdct_quantize_batch(planes: torch.Tensor, qt_zz: torch.Tensor, *, level_shift: int = 128,
                         hs: int = 1, vs: int = 1, k2=kernels.fdct_quantize) -> torch.Tensor:
    """[B, H, W] uint8, uint16 or int32 samples -> int16 [B, H/(8 vs),
    W/(8 hs), 64] zig-zag coefficients: the (hs, vs) box ``(sum + n/2) //
    n``, the level shift (128 for 8-bit samples, 2^(P - 1) at precision
    P), FDCT and quantize; JAX's ``_fdct_quantize_batch`` (after ``box2x2``
    at hs = vs = 2). One K2 launch for the batch: the images stack as one
    [B*H, W] plane, and since H is a multiple of 8 vs no block row crosses
    from one image into the next (one launch per image would pay a launch
    and a ragged last wave per image). ``k2`` is K2's wrapper, or a
    function of the same signature (its plain version)."""
    b, h, w = planes.shape
    if h % (8 * vs) or w % (8 * hs):
        raise ValueError(f"{h} x {w} planes are not whole blocks at ({hs}, {vs})")
    hb, wb = h // (8 * vs), w // (8 * hs)
    out = k2(planes.reshape(b * h, w), qt_zz, level_shift, hs=hs, vs=vs, blocks=(b * hb, wb))
    return out.reshape(b, hb, wb, 64)


def full_step(y_coeffs, cb_coeffs, cr_coeffs, qt_luma, qt_chroma, *, device):
    """The flagship device step over a batch of 4:2:0 or 4:2:2 images, on
    ``device``: the decode transform (dequantize + IDCT + level shift,
    duplicate upsampling, YCbCr -> RGB), the full re-encode transform
    (RGB -> YCbCr, the chroma's box, FDCT + quantize of every component)
    and the DC and AC Huffman symbol histograms of the re-encoded blocks,
    per table class.

    ``y_coeffs`` int16 [B, Hb, Wb, 64] and ``cb_coeffs``, ``cr_coeffs``
    int16 [B, Hb/2, Wb/2, 64] (4:2:0) or [B, Hb, Wb/2, 64] (4:2:2)
    zig-zag: the chroma's sampling (hs, vs) = (2, 2) or (2, 1) is read from
    the shapes (``color.round_trip_factors``), and any other shape raises
    ValueError. ``qt_luma``, ``qt_chroma`` int32 [64] zig-zag. Inputs not
    on ``device`` are copied there. Returns (rgb uint8 [B, H, W, 3],
    requant_y int16 [B, Hb, Wb, 64], hists int32 [4, 256]: DC luma, AC
    luma, DC chroma, AC chroma), on ``device``; the luma's histograms count
    its blocks in the interleaved scan's (hs, vs) MCU order. On the card:
    3 K1, 1 K6, 3 K2 and 2 K5 launches.

    Spans (``ops._trace.span``, open only while a torch profiler runs or
    the metrics table is enabled): ``full_step`` around the whole call,
    and inside it :func:`_step`'s stage spans."""
    with span("full_step"):
        rgb, requant, hists = _step(*_step_inputs(y_coeffs, cb_coeffs, cr_coeffs, qt_luma,
                                                  qt_chroma, device))
    return rgb, requant[0], hists


def _on_device(x, dtype, device) -> torch.Tensor:
    """A step's argument as a tensor of ``dtype`` on ``device``."""
    return torch.as_tensor(x, device=device).to(dtype)


def _step_inputs(y_coeffs, cb_coeffs, cr_coeffs, qt_luma, qt_chroma, device):
    """:func:`full_step`'s arguments as tensors on ``device``: the
    coefficients int16, the tables int32."""
    return (*(_on_device(c, torch.int16, device) for c in (y_coeffs, cb_coeffs, cr_coeffs)),
            _on_device(qt_luma, torch.int32, device), _on_device(qt_chroma, torch.int32, device))


def _step(y_coeffs, cb_coeffs, cr_coeffs, qt_luma, qt_chroma, k1=kernels.dequantize_idct_shift,
          k2=kernels.fdct_quantize, chain_prev=None, k5=encode_stage.symbol_histograms_device,
          k6=kernels.color_round_trip):
    """:func:`full_step` on tensors of one device, with K1's and K2's
    wrappers (or functions of their signatures: their plain versions, the
    yardstick ``chip_smoke.py`` holds the step to on the card) as ``k1``
    and ``k2``, the symbol statistics as ``k5`` (through K5's wrapper, or
    ``encode_stage.symbol_histograms_plain``) and the colour round trip as
    ``k6`` (K6's wrapper, or ``color.round_trip_plain``); the defaults
    are the kernels the step runs. Returns (rgb,
    (requant_y, requant_cb, requant_cr), hists): the step's outputs with
    the requantised chroma it counts besides. The chroma's sampling (hs,
    vs) comes from the shapes (``color.round_trip_factors``): it sets
    K2's chroma box and the luma's MCU walk in the statistics.

    The histograms count B luma chains, then B Cb and B Cr chains, each
    from DC 0; ``chain_prev``, where given, maps the last DC of each of
    those 3B chains ([3B] int32) to the DC before its first block (the
    sharded step's boundary exchange).

    Every op the step runs lies in one of four spans, in this order:
    ``full_step.decode`` (the three K1 launches), ``full_step.to_rgb``
    (K6: the samples to the RGB output and back to the YCbCr planes of the
    re-encode), ``full_step.fdct`` (the three K2 launches) and
    ``full_step.stats`` (``chain_prev``, the two K5 calls and the
    histograms' stack)."""
    b = y_coeffs.shape[0]
    hs, vs = color.round_trip_factors(y_coeffs.shape, cb_coeffs.shape, cr_coeffs.shape)

    with span("full_step.decode"):
        samples = [k1(c.contiguous(), q, 128) for c, q in (
            (y_coeffs, qt_luma), (cb_coeffs, qt_chroma), (cr_coeffs, qt_chroma))]
    with span("full_step.to_rgb"):
        rgb, y2, cb2, cr2 = k6(*samples)
    # The re-encode transform, all three components; K2 boxes the chroma.
    with span("full_step.fdct"):
        requant_y = _fdct_quantize_batch(y2, qt_luma, k2=k2)
        requant_cb = _fdct_quantize_batch(cb2, qt_chroma, hs=hs, vs=vs, k2=k2)
        requant_cr = _fdct_quantize_batch(cr2, qt_chroma, hs=hs, vs=vs, k2=k2)

    # The symbol statistics, on the planes where K2 wrote them: the luma in
    # its (hs, vs) MCU walk, each chroma component a chain of its own. The
    # last block of each walk is the plane's bottom-right one.
    with span("full_step.stats"):
        prev_l = prev_c = None
        if chain_prev is not None:
            last = torch.cat([q[:, -1, -1, 0] for q in (requant_y, requant_cb, requant_cr)])
            prev = chain_prev(last.to(torch.int32))
            prev_l, prev_c = prev[:b], prev[b:]
        dc_l, ac_l = k5(requant_y, prev_dc=prev_l, mcu=(hs, vs))
        dc_c, ac_c = k5((requant_cb, requant_cr), prev_dc=prev_c)
        hists = torch.stack([dc_l, ac_l, dc_c, ac_c])
    return rgb, (requant_y, requant_cb, requant_cr), hists


def gray_step(coeffs, qt, *, precision: int = 12, device):
    """The re-encoding step over a batch of one-component frames of sample
    precision ``precision`` (8 or 12; the level shift 2^(P - 1) and the
    clamp to [0, 2^P - 1] follow from it), such as the slices of a 12-bit
    CT series, on ``device``: the decode transform (dequantize + IDCT +
    level shift + clamp), the re-encode transform (FDCT + quantize at the
    same table) and the DC and AC Huffman symbol histograms of the
    re-encoded blocks, one DC chain a frame in raster order (MCU = 1
    block).

    ``coeffs`` int16 [B, Hb, Wb, 64] zig-zag; ``qt`` int32 [64] zig-zag.
    Inputs not on ``device`` are copied there. Returns (samples uint16
    [B, 8 Hb, 8 Wb], requant int16 [B, Hb, Wb, 64], hists int32 [2, 256]:
    DC, AC), on ``device``. On the card: 1 K1 (its plane store), 1 K2 (its
    uint16 load) and 1 K5 launch.

    Spans as :func:`full_step`'s: ``gray_step`` around the whole call, and
    inside it :func:`_gray_step`'s stage spans."""
    with span("gray_step"):
        return _gray_step(_on_device(coeffs, torch.int16, device),
                          _on_device(qt, torch.int32, device), precision)


def _gray_step(coeffs, qt, precision: int, k1=kernels.dequantize_idct_plane,
               k2=kernels.fdct_quantize, chain_prev=None,
               k5=encode_stage.symbol_histograms_device):
    """:func:`gray_step` on tensors of one device, with K1's plane store and
    K2's wrappers (or functions of their signatures: their plain versions)
    as ``k1`` and ``k2`` and the symbol statistics as ``k5``, as
    :func:`_step` takes them (the defaults the kernels the step runs).
    ``chain_prev``, where given, maps the last DC
    of each of the B chains ([B] int32) to the DC before its first block
    (the sharded step's boundary exchange).

    Every op the step runs lies in one of three spans, in this order:
    ``gray_step.decode`` (K1), ``gray_step.fdct`` (K2 on the B planes
    stacked as one [B*H, W] plane by :func:`_fdct_quantize_batch`) and
    ``gray_step.stats`` (``chain_prev``, K5 and the histograms' stack)."""
    with span("gray_step.decode"):
        samples = k1(coeffs.contiguous(), qt, precision)
    with span("gray_step.fdct"):
        requant = _fdct_quantize_batch(samples, qt, level_shift=1 << (precision - 1), k2=k2)
    with span("gray_step.stats"):
        prev = None
        if chain_prev is not None:
            prev = chain_prev(requant[:, -1, -1, 0].to(torch.int32))
        hists = torch.stack(k5(requant, prev_dc=prev))
    return samples, requant, hists


def progressive_step(y_coeffs, cb_coeffs, cr_coeffs, *, script=None, size=None, device):
    """The count pass of a lossless progressive transcode (``jpegtran
    -optimize -progressive``) over a batch of images, on ``device``: the
    Huffman symbol histograms of each image under a progressive scan
    script, from which each file's optimised tables are built. No
    transform: coefficients in, histograms out.

    ``y_coeffs`` int16 [B, Hb, Wb, 64] and ``cb_coeffs``, ``cr_coeffs``
    [B, Hb / vs, Wb / hs, 64] zig-zag (4:2:0 at hs = vs = 2), or both None
    for one-component frames; the MCU-padded planes of images of ``size``
    = (height, width), their full size when None. ``script`` is
    ``(components, Ss, Se, Ah, Al)`` entries, libjpeg's
    ``jpeg_simple_progression`` for YCbCr (``SCRIPT_3``) when None (one
    component: ``SCRIPT_1``). Inputs not on ``device`` are copied there.
    Returns [B, R, 256] int32 on ``device``: one row per (scan, component)
    that codes Huffman symbols, in script order (11 rows for
    ``SCRIPT_3``). On the card: K7 (``kernels.progressive_histograms``),
    one launch a component and one for the EOB runs' stitch.

    Spans: ``progressive_step`` around the whole call, and
    ``progressive_step.eobrun`` around the stitch."""
    from ..host.models.progressive_encoder import SCRIPT_1, SCRIPT_3

    if script is None:
        script = SCRIPT_1 if cb_coeffs is None and cr_coeffs is None else SCRIPT_3
    with span("progressive_step"):
        planes = [None if c is None else _on_device(c, torch.int16, device).contiguous()
                  for c in (y_coeffs, cb_coeffs, cr_coeffs)]
        return kernels.progressive_histograms(*planes, script, size=size)


def _prev_across(mesh, dim: str):
    """``chain_prev`` for chains cut along mesh dim ``dim``: each rank's
    last DCs go to every rank of its ``dim`` group, and rank s > 0 takes
    rank s - 1's; rank 0 keeps 0, the start of every chain."""
    group = mesh.get_group(dim)
    s = mesh.get_local_rank(dim)

    def chain_prev(last: torch.Tensor) -> torch.Tensor:
        gathered = collectives.all_gather(last, group)
        return gathered[s - 1] if s > 0 else torch.zeros_like(last)

    return chain_prev


def _make_sharded(mesh, shard_step):
    """The mesh form of a re-encoding step, what :func:`make_sharded_full_step`
    and :func:`make_sharded_gray_step` share: the batch over ``data`` and
    the block rows over ``stripe``, each rank's DC chains taking the
    previous stripe's last DC, the histograms all-reduced over the mesh.

    ``shard_step(args, rows, stripe, n_stripe, device, chain_prev)`` checks
    the shapes of the step's arguments ``args``, slices the rank's shard
    (the batch ``rows``, block-row stripe ``stripe`` of ``n_stripe``) and
    runs the step on it on ``device`` with ``chain_prev``; it returns the
    two outputs sharded over the batch and the rows, and the rank's
    histograms. The returned function takes ``args``, the same on every
    rank, and raises unless the batch divides over ``data``."""
    check_mesh(mesh)
    n_data, n_stripe = mesh["data"].size(), mesh["stripe"].size()
    d, s = mesh.get_local_rank("data"), mesh.get_local_rank("stripe")
    device = mesh_device(mesh)
    chain_prev = _prev_across(mesh, "stripe")

    def step(*args):
        b = args[0].shape[0]
        if b % n_data:
            raise ValueError(f"a batch of {b} does not divide over {n_data} data ranks")
        bl = b // n_data
        first, second, hists = shard_step(args, slice(d * bl, (d + 1) * bl), s, n_stripe,
                                          device, chain_prev)
        hists = collectives.all_reduce_sum(hists)  # the mesh is the whole world
        return (_from_local(first, mesh, {"data": 0, "stripe": 1}),
                _from_local(second, mesh, {"data": 0, "stripe": 1}),
                _from_local(hists, mesh, {}))

    return step


def make_sharded_full_step(mesh):
    """:func:`full_step` over ``mesh``: the batch over ``data`` and the luma
    block rows over ``stripe`` (the chroma rows follow, at half at 4:2:0
    and at full height at 4:2:2), as JAX's ``P("data", "stripe")``. Each
    rank runs the step on its block on its own device (3 K1, 1 K6, 3 K2 and
    2 K5 launches); at each stripe boundary the DC predictor chains (each
    image's luma, Cb and Cr) take the previous stripe's last DC, and the
    histograms are all-reduced over the mesh.

    The returned function takes :func:`full_step`'s inputs, the same on
    every rank, and returns (rgb, requant_y) as DTensors sharded
    ``[Shard(0), Shard(1)]`` and hists as a replicated DTensor, equal to
    :func:`full_step`'s outputs. A shard must hold whole MCU rows (of 2
    luma block rows at 4:2:0, of 1 at 4:2:2): the batch divides over
    ``data`` and a whole number of MCU rows falls to each stripe, or it
    raises, as it does on a sampling :func:`full_step` does not take."""
    def shard_step(args, rows, s, n_stripe, device, chain_prev):
        y_coeffs, cb_coeffs, cr_coeffs, qt_luma, qt_chroma = args
        hb = y_coeffs.shape[1]
        short = f"{hb} luma block rows are no whole MCU rows on each of {n_stripe} stripes"
        if hb % n_stripe:
            raise ValueError(short)
        _, vs = color.round_trip_factors(y_coeffs.shape, cb_coeffs.shape, cr_coeffs.shape)
        hl = hb // n_stripe
        if hl % vs:
            raise ValueError(short)
        y = y_coeffs[rows, s * hl:(s + 1) * hl]
        cb = cb_coeffs[rows, s * hl // vs:(s + 1) * hl // vs]
        cr = cr_coeffs[rows, s * hl // vs:(s + 1) * hl // vs]
        rgb, requant, hists = _step(*_step_inputs(y, cb, cr, qt_luma, qt_chroma, device),
                                    chain_prev=chain_prev)
        return rgb, requant[0], hists

    return _make_sharded(mesh, shard_step)


def make_sharded_gray_step(mesh, *, precision: int = 12):
    """:func:`gray_step` over ``mesh``: the batch over ``data`` and the
    block rows over ``stripe``. Each rank runs the step on its block on its
    own device (1 K1, 1 K2 and 1 K5 launch); at each stripe boundary each
    frame's DC chain takes the previous stripe's last DC, and the
    histograms are all-reduced over the mesh.

    The returned function takes :func:`gray_step`'s ``coeffs`` and ``qt``,
    the same on every rank, and returns (samples, requant) as DTensors
    sharded ``[Shard(0), Shard(1)]`` and hists as a replicated DTensor,
    equal to :func:`gray_step`'s outputs. The batch must divide over
    ``data`` and the block rows over ``stripe``, or it raises."""
    def shard_step(args, rows, s, n_stripe, device, chain_prev):
        coeffs, qt = args
        hb = coeffs.shape[1]
        if hb % n_stripe:
            raise ValueError(f"{hb} block rows do not divide over {n_stripe} stripes")
        hl = hb // n_stripe
        local = coeffs[rows, s * hl:(s + 1) * hl]
        return _gray_step(_on_device(local, torch.int16, device),
                          _on_device(qt, torch.int32, device), precision,
                          chain_prev=chain_prev)

    return _make_sharded(mesh, shard_step)


def mesh_symbol_frequencies(blocks: np.ndarray, mesh):
    """Distributed 2-pass-encoder statistics: the DC and AC Huffman symbol
    histograms of one component's MCU-ordered blocks [N, 64], the block
    axis split over the mesh's ``data`` axis (zero-padded to an even split
    and masked out of every count), the boundary DC of each shard taken
    from the shard before it, and the histograms all-reduced. Bit-identical
    to the host gather ``dc_ac_symbol_frequencies``.

    Returns (dc_freq[256], ac_freq[256]) as int64 numpy arrays, the same on
    every rank."""
    device = mesh_device(mesh)
    n = blocks.shape[0]
    n_data, d = mesh["data"].size(), mesh.get_local_rank("data")
    per = ceil_div(n, n_data)
    local = np.zeros((per, 64), dtype=np.int16)
    mine = np.asarray(blocks)[d * per:(d + 1) * per]
    local[: len(mine)] = mine
    last = int(mine[-1, 0]) if len(mine) else 0
    prev = _prev_across(mesh, "data")(torch.tensor([last], dtype=torch.int32, device=device))
    dc, ac = encode_stage.symbol_histograms_device(
        torch.from_numpy(local)[None].to(device),
        n_valid=torch.tensor([len(mine)], dtype=torch.int32, device=device), prev_dc=prev)
    dc, ac = collectives.all_reduce_sum(torch.stack([dc, ac]), mesh.get_group("data")).cpu()
    return dc.numpy().astype(np.int64), ac.numpy().astype(np.int64)


def decode_rgb_sharded(data: bytes, mesh, *, axis: str = "stripe"):
    """Decode ONE image with its transform sharded over the mesh's ``axis``:
    every rank scans the image, and rank s on ``axis`` transforms MCU-row
    stripe s on its device (ranks along the other axis repeat it). Every
    mode shards with no halo:

    - single-scan baseline: the merged scan's v2 payload (or, under
      ``JPX_WIRE=1``, its v1 MCU payload) splits into per-stripe slices;
    - progressive and arithmetic: the dense coefficient planes split into
      MCU-block-row stripes;
    - lossless (SOF3): the sample planes split on the max_v row grid.

    An image of fewer MCU rows than stripes pads with empty stripes.
    Returns ``(stripes, heights)``: a DTensor [S, 3, stripe_px, W] uint8
    sharded over ``axis``, and the true pixel height of each stripe (crop
    with :func:`assemble_stripes`)."""
    from ..host.models.decoder import JpegDecoder

    device = mesh_device(mesh)
    n, s = mesh[axis].size(), mesh.get_local_rank(axis)
    dec = JpegDecoder()
    dec.set_input(data)
    res = dec.decode(sparse_direct=True)
    if res.packed_mcu2 is not None or res.packed_mcu is not None:
        local, heights = _sharded_baseline(res, n, s, device)
    elif res.samples is not None:
        local, heights = _sharded_lossless(res, n, s, device)
    else:
        local, heights = _sharded_dense_coefficients(res, n, s, device)
    return _from_local(local[None], mesh, {axis: 0}), heights


def _pad_stripes(payloads: np.ndarray, heights, n: int):
    """Short image: pad to ``n`` stripes with empty (zero) payloads."""
    if payloads.shape[0] < n:
        pad = np.zeros((n - payloads.shape[0], payloads.shape[1]), dtype=payloads.dtype)
        payloads = np.concatenate([payloads, pad])
        heights = heights + [0] * (n - len(heights))
    return payloads, heights


def _sharded_baseline(res, n: int, s: int, device):
    """Single-scan baseline: stripe s's slice of the v2 split-stream
    payload through ``transform_mcu2``, or, on the v1 MCU wire, of the
    sparse payload through ``transform_mcu``; both at the uniform stripe
    geometry, uncropped (assembly crops)."""
    from ..host.models import streaming

    if res.packed_mcu2 is not None:
        split, transform = streaming.split_payload2_stripes, transform_mcu2
    else:
        split, transform = streaming.split_payload_stripes, transform_mcu
    stripe_rows = ceil_div(res.geometry.mcus_per_column, n)
    payloads, geo, quants, heights = split(res, stripe_rows)
    payloads, heights = _pad_stripes(payloads, heights, n)
    sgeo = streaming._stripe_geometry(geo, stripe_rows, stripe_rows * 8 * geo.max_v)
    return transform(payloads[s], quants, sgeo, device), heights


def _sharded_dense_coefficients(res, n: int, s: int, device):
    """Progressive, arithmetic (any dense-plane) decode: stripe s of each
    accumulated coefficient plane, through ``transform_dense``."""
    from ..host.models.streaming import _stripe_geometry
    from ..models.decoder import quant_tables

    geo = res.geometry
    stripe_rows = ceil_div(geo.mcus_per_column, n)
    px = stripe_rows * 8 * geo.max_v
    planes = []
    for c in geo.components:
        plane = res.coefficients[c.component_index]  # [Hb, Wb, 64]
        rows = stripe_rows * c.v
        local = np.zeros((rows, plane.shape[1], 64), dtype=plane.dtype)
        mine = plane[s * rows:(s + 1) * rows]
        local[: len(mine)] = mine
        planes.append(local)
    heights = [max(0, min(px, geo.height - i * px)) for i in range(n)]
    return (transform_dense(planes, quant_tables(res), _stripe_geometry(geo, stripe_rows, px),
                            device), heights)


def _sharded_lossless(res, n: int, s: int, device):
    """Lossless (SOF3): stripe s of each sample plane on the max_v row
    grid; duplicate upsampling, the precision's 8-bit normalisation and
    YCbCr -> RGB run on the stripe."""
    from ..host.models.lossless import component_sizes

    geo = res.geometry
    if len(geo.components) not in (1, 3):
        raise ValueError(f"RGB output needs 1 or 3 components, got {len(geo.components)}.")
    height, width = geo.height, geo.width
    stripe_mcus = ceil_div(ceil_div(height, geo.max_v), n)
    px = stripe_mcus * geo.max_v
    sizes = component_sizes(res.frame)
    u8 = []
    for c in geo.components:
        plane = res.samples[c.component_index]  # padded grid [rows*v, cols*h]
        rows = stripe_mcus * c.v
        local = np.zeros((rows, plane.shape[1]), dtype=np.int32)
        mine = plane[s * rows:(s + 1) * rows]
        local[: len(mine)] = mine
        p = torch.from_numpy(local[:, : sizes[c.component_index][1]]).to(device)
        p = decode_stage.upsample_duplicate(p, c.hs, c.vs)[:, :width]
        u8.append(decode_stage.normalize_to_uint8(p, geo.precision))
    if len(u8) == 1:
        half = torch.full_like(u8[0], 128)
        r, g, b = color.ycbcr_to_rgb(u8[0], half, half)
    else:
        r, g, b = color.ycbcr_to_rgb(*u8)
    heights = [max(0, min(px, height - i * px)) for i in range(n)]
    return torch.stack([r, g, b]), heights


def assemble_stripes(stripes, heights) -> np.ndarray:
    """Host assembly of stripes [S, 3, stripe_px, W] (a tensor, a numpy
    array, or :func:`decode_rgb_sharded`'s DTensor, gathered whole on
    every rank): [3, H, W] uint8, each stripe cut to its true height."""
    from torch.distributed.tensor import DTensor

    if isinstance(stripes, DTensor):
        stripes = collectives.full_tensor(stripes)
    arr = stripes.cpu().numpy() if torch.is_tensor(stripes) else np.asarray(stripes)
    return np.concatenate([arr[i][:, :h, :] for i, h in enumerate(heights) if h > 0], axis=1)


def batched_transform_rgb(coeffs_batch: Sequence, quants, geometry: FrameGeometry, mesh=None,
                          *, device=None):
    """Decode-transform a batch of same-geometry images to uint8 RGB
    [B, H, W, 3]: ``coeffs_batch`` holds one sequence of per-component
    [Hb, Wb, 64] coefficient planes per image, ``quants`` the [64] zig-zag
    tables every image shares. One K1 launch per component for the batch.

    Without a mesh the batch runs on ``device`` and a tensor comes back.
    With a ``mesh`` (and no ``device``) the batch divides over ``data``
    (or it raises), each rank transforms its images on its device, and a
    DTensor sharded over ``data`` comes back."""
    device = device_or_mesh(device, mesh, "batched_transform_rgb")
    if mesh is not None:
        n_data, d = mesh["data"].size(), mesh.get_local_rank("data")
        if len(coeffs_batch) % n_data:
            raise ValueError(f"a batch of {len(coeffs_batch)} does not divide over "
                             f"{n_data} data ranks")
        per = len(coeffs_batch) // n_data
        local = batched_transform_rgb(coeffs_batch[d * per:(d + 1) * per], quants, geometry,
                                      device=device)
        return _from_local(local, mesh, {"data": 0})
    stacked = [torch.stack([torch.as_tensor(c[i]) for c in coeffs_batch]).to(device)
               for i in range(len(quants))]
    q = torch.stack([torch.as_tensor(np.asarray(x), dtype=torch.int32) for x in quants])
    q = q.to(device).expand(len(coeffs_batch), -1, -1).contiguous()
    return transform_dense(stacked, q, geometry, device, output="rgb8")

"""Rank functions of the port's mesh tests, run in gloo CPU ranks by
``jpeglibrary_tpu_torch.parallel.distributed.spawn``.

A spawned rank imports the module its function lives in, so these live
here, in a module that imports neither JAX nor the JAX package, and not
in a test file (which does). Each returns numpy arrays or bytes, which
pickle back to the test process.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _setup():
    torch.set_num_threads(1)  # a few ranks per test worker share the host's cores


def _mesh(n, stripe):
    from jpeglibrary_tpu_torch.parallel.sharding import make_mesh

    return make_mesh(n, stripe=stripe, device_type="cpu")


def _full(x) -> np.ndarray:
    from jpeglibrary_tpu_torch.parallel.collectives import full_tensor

    return full_tensor(x).numpy()


def sharded_steps(meshes, args) -> dict:
    """``make_sharded_full_step`` at each (n, stripe) of ``meshes``: the
    full outputs, the rank's local RGB shape and its K1 and K2 launches
    (0 on the CPU, where the wrappers take the plain versions)."""
    from jpeglibrary_tpu_torch.ops import kernels
    from jpeglibrary_tpu_torch.parallel.sharding import make_sharded_full_step

    _setup()
    out = {}
    for shape in meshes:
        rgb, requant, hists = make_sharded_full_step(_mesh(*shape))(*args)
        out[shape] = {"outputs": [_full(rgb), _full(requant), _full(hists)],
                      "local_rgb": tuple(rgb.to_local().shape),
                      "launches": (kernels.dequantize_idct_shift.launches,
                                   kernels.fdct_quantize.launches)}
    return out


def stripe_decodes(shape, cases) -> dict:
    """``decode_rgb_sharded`` of each (name, data, wire_v1) case over the
    mesh ``shape``: the assembled planar RGB and the stripe heights."""
    from jpeglibrary_tpu_torch.parallel.sharding import assemble_stripes, decode_rgb_sharded

    _setup()
    mesh = _mesh(*shape)
    out = {}
    for name, data, wire_v1 in cases:
        if wire_v1:
            os.environ["JPX_WIRE"] = "1"
        try:
            stripes, heights = decode_rgb_sharded(data, mesh)
        finally:
            os.environ.pop("JPX_WIRE", None)
        out[name] = {"rgb": assemble_stripes(stripes, heights), "heights": heights,
                     "local": tuple(stripes.to_local().shape)}
    return out


def symbol_frequencies(shapes, blocks) -> dict:
    """``mesh_symbol_frequencies`` of ``blocks`` over each mesh shape."""
    from jpeglibrary_tpu_torch.parallel.sharding import mesh_symbol_frequencies

    _setup()
    return {shape: mesh_symbol_frequencies(blocks, _mesh(*shape)) for shape in shapes}


def batches(shape, coeffs, quants, geometry, datas) -> dict:
    """``batched_transform_rgb(mesh=)`` of ``coeffs`` and
    ``decode_batch_rgb(mesh=)`` of ``datas`` over the mesh ``shape``."""
    from jpeglibrary_tpu_torch.parallel.batch import decode_batch_rgb
    from jpeglibrary_tpu_torch.parallel.sharding import batched_transform_rgb

    _setup()
    mesh = _mesh(*shape)
    return {"transform": _full(batched_transform_rgb(coeffs, quants, geometry, mesh=mesh)),
            "decode": decode_batch_rgb(datas, mesh=mesh)}


def mesh_encodes(shape, rgb, quality) -> dict:
    """The optimize-coding encode of ``rgb`` with the mesh ``shape`` set on
    the encoder, by the host encoder and by the device encode."""
    import jpeglibrary_tpu_torch as jtt
    from jpeglibrary_tpu_torch.host.models.encoder import _configure_rgb_encoder
    from jpeglibrary_tpu_torch.models.encoder import rgb_encoder

    _setup()
    mesh = _mesh(*shape)
    host = _configure_rgb_encoder(quality, "420", optimize_coding=True)
    host.set_input_rgb(rgb)
    host.mesh = mesh
    device = rgb_encoder(rgb, quality, optimize_coding=True)
    device.mesh = mesh
    return {"host": host.encode(), "device": jtt.encode(device, device="cpu")}


def global_batch(datas) -> dict:
    """The world as the rank sees it (after ``initialize``), its
    ``local_batch_block`` and ``local_batch_indices``, and its shard of
    ``decode_batch_rgb_global`` twice: as scanned, and with rank 1
    scanning under ``JPX_WIRE=1``, so that not every rank has the v2 wire
    and all must agree on the v1 plane-order branch."""
    import sys

    import torch.distributed as dist

    from jpeglibrary_tpu_torch.parallel import distributed

    _setup()
    out = distributed.decode_batch_rgb_global(datas, device_type="cpu")
    rank = dist.get_rank()
    if rank == 1:
        os.environ["JPX_WIRE"] = "1"
    try:
        mixed = distributed.decode_batch_rgb_global(datas, device_type="cpu")
    finally:
        os.environ.pop("JPX_WIRE", None)
    return {"rank": rank, "world": dist.get_world_size(),
            "block": list(distributed.local_batch_block(len(datas))),
            "indices": list(distributed.local_batch_indices(5)),
            "shard": out.to_local().numpy(), "mixed": mixed.to_local().numpy(),
            "global_shape": tuple(out.shape),
            "jax_modules": sorted(m for m in sys.modules
                                  if m.split(".")[0] in ("jax", "jpeglibrary_tpu"))}


def chip_smoke_mesh(world, datas, size) -> dict:
    """``chip_smoke.mesh_rank`` on a CPU rank at ``size``: the checks are
    recorded, not raised (the launch counts only the card can meet), and
    returned with the rank's lines and launches."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    failed = []
    smoke.check = lambda ok, what: ok or failed.append(what)
    smoke.MESH_DEVICE, smoke.SIZE, smoke.MESH_RUNS = "cpu", size, 1
    torch.cuda.synchronize = lambda *args, **kwargs: None  # the CPU build has no CUDA
    out = smoke.mesh_rank(world, datas)
    out["failed"] = failed
    return out


def run(jobs) -> list:
    """Run each (name, args) of ``jobs``, a function of this module and its
    arguments, in turn in one world; return their values in order."""
    return [globals()[name](*args) for name, args in jobs]


def imported_modules(names) -> list:
    """Import ``names`` in a spawned rank; return the JAX modules then loaded."""
    import importlib
    import sys

    for name in names:
        importlib.import_module(name)
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jpeglibrary_tpu.")) or m == "jpeglibrary_tpu")

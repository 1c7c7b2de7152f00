"""Multi-process scaling: one process (rank) per device over
``torch.distributed``.

Port of ``jpeglibrary_tpu/parallel/distributed.py``. Each process
entropy-decodes its own block of a batch on the host (the host stages are
independent across images), the sharded programs of ``parallel.sharding``
run SPMD over the global mesh, and the only cross-process traffic is the
histogram all-reduce and a few one-int agreements. Where JAX has one
controller per host over its devices, the port has one rank per device:
NCCL between GPUs, gloo between CPU ranks.

``spawn`` runs a function in a world of local ranks, as the tests,
``graft_entry.dryrun_multichip`` and ``chip_smoke.py`` start theirs; elsewhere ``torchrun``
or a launcher of the caller's starts the processes and each calls
:func:`initialize`.
"""

from __future__ import annotations

import os
import queue as queue_module
import time
import traceback
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import collectives

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _init(num_processes: int, process_id: int, backend: str, local_rank: int,
          **rendezvous) -> None:
    """``init_process_group`` through ``rendezvous`` (its ``init_method``
    or ``store``); on a machine with CUDA, the rank's current device is
    card ``local_rank`` first (NCCL needs one card per rank; gloo ranks may
    share)."""
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, world_size=num_processes, rank=process_id, **rendezvous)


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, backend: Optional[str] = None,
               local_rank: Optional[int] = None) -> None:
    """Join the process group of ``num_processes`` ranks whose rank 0
    listens at ``coordinator_address`` ("host:port"), as rank
    ``process_id``; a no-op for one process, as JAX's is. ``backend``
    defaults to NCCL where CUDA is available, else gloo.

    ``local_rank`` is the rank's index among the processes of its own
    node, which picks its card; it defaults to ``LOCAL_RANK`` where the
    launcher sets it (``torchrun`` does), else to ``process_id``, which is
    right on one node (and on nodes of equal card counts holding
    contiguous blocks of ranks)."""
    if num_processes is None or num_processes <= 1:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    _init(num_processes, process_id, backend, local_rank,
          init_method=f"tcp://{coordinator_address}")


def make_global_mesh(*, stripe: int = 1, device_type: str = "cuda"):
    """A ('data', 'stripe') mesh over every rank of the process group."""
    from .sharding import make_mesh

    return make_mesh(None, stripe=stripe, device_type=device_type)


def _rank_and_count():
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_batch_indices(n_images: int) -> Sequence[int]:
    """The images of a global batch this rank should scan, striped over
    the ranks so each one's entropy-decode load is balanced whatever
    each image costs."""
    rank, count = _rank_and_count()
    return range(rank, n_images, count)


def local_batch_block(n_images: int) -> range:
    """The contiguous block of a global batch this rank owns under a
    sharding over ``data`` (rank r holds images [r*B/R, (r+1)*B/R)): the
    block :func:`decode_batch_rgb_global` scans."""
    rank, count = _rank_and_count()
    per = n_images // count
    return range(rank * per, (rank + 1) * per)


def decode_batch_rgb_global(datas: Sequence[bytes], *, scan_workers: Optional[int] = None,
                            device_type: str = "cuda"):
    """Multi-process batch decode on the global mesh. Every rank calls it
    with the same ``datas``; each entropy-decodes only its
    :func:`local_batch_block` and transforms it on its own device.

    Two one-int gathers keep every rank on one branch: all ranks take the
    v2 wire only if every rank's images have a v2 payload (the minimum of
    a flag), and then agree on one AC bucket (the maximum), or else on one
    width of the v1 plane-order wire. Returns the global RGB batch as a
    DTensor [B, 3, H, W] uint8 sharded over ``data``. All images share one
    geometry and ``len(datas)`` divides over the ranks, or it raises."""
    from ..host.native import scanner as native_scanner
    from ..host.parallel.batch import _stacked_quants, scan_images
    from ..models.decoder import delta_payload
    from ..ops import _build
    from ..ops.pipeline import transform_delta, transform_mcu2
    from .sharding import _from_local, mesh_device

    mesh = make_global_mesh(device_type=device_type)
    device = mesh_device(mesh)
    n, n_ranks = len(datas), mesh.size()
    if n % n_ranks:
        raise ValueError(f"global batch of {n} images must divide the {n_ranks} ranks")
    _build.load_scanner()
    block = local_batch_block(n)
    results = scan_images([datas[i] for i in block], max_workers=scan_workers)
    geometry = results[0].geometry
    if any(r.geometry != geometry for r in results[1:]):
        raise ValueError("decode_batch_rgb_global needs one shared geometry")
    quants = _stacked_quants(results, geometry)

    local_v2 = all(r.packed_mcu2 is not None for r in results)
    if min(collectives.all_gather_int(int(local_v2))):
        nb = geometry.mcus_per_line * geometry.mcus_per_column * sum(
            c.h * c.v for c in geometry.components)
        bn = max(collectives.all_gather_int(
            max(native_scanner.v2_payload_bn(r.packed_mcu2, nb) for r in results)))
        payload = np.stack([native_scanner.rebucket_v2_payload(r.packed_mcu2, nb, bn)
                            for r in results])
        local = transform_mcu2(payload, quants, geometry, device)
    else:
        packs = [delta_payload(r) for r in results]
        width = max(collectives.all_gather_int(max(p.shape[0] for p in packs)))
        payload = np.zeros((len(packs), width), dtype=np.int16)
        for j, p in enumerate(packs):
            payload[j, : p.shape[0]] = p
        local = transform_delta(payload, quants, geometry, device)
    return _from_local(local, mesh, {"data": 0})


def _rank_main(rank: int, world: int, port: int, backend: str, target, args, results) -> None:
    """A spawned rank: join the group through the parent's store at
    ``port``, run ``target(*args)``, and report ``(rank, ok, value or
    traceback)``."""
    try:
        _init(world, rank, backend, rank,
              store=dist.TCPStore("127.0.0.1", port, world, is_master=False))
        value = target(*args)
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, True, value))
    except BaseException:  # reported to the parent, which fails the world
        results.put((rank, False, traceback.format_exc()))


def spawn(target, world: int, *args, backend: str, timeout: float = 120.0) -> list:
    """Run ``target(*args)`` in ``world`` spawned ranks of one new process
    group and return each rank's value, in rank order. The ranks meet at a
    store that this process serves on a port it binds and holds (not a
    port found free and released, which another process can take before
    rank 0 binds it). ``target`` and ``args`` must pickle:
    ``target`` is a module-level function of a module the ranks can
    import. Raises if a rank raises or exits without a value, or if the
    world outlasts ``timeout`` seconds; every rank still running is then
    killed."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = dist.TCPStore("127.0.0.1", 0, world, is_master=True, wait_for_workers=False)
    port = store.port
    procs = [ctx.Process(target=_rank_main, args=(rank, world, port, backend, target, args,
                                                  results), daemon=True)
             for rank in range(world)]
    for p in procs:
        p.start()
    values = {}
    deadline = time.monotonic() + timeout
    grace = 0.0  # a failed world is killed at once
    try:
        while len(values) < world:
            if time.monotonic() > deadline:
                raise TimeoutError(f"a world of {world} ranks outlasted {timeout} s; "
                                   f"ranks {sorted(set(range(world)) - set(values))} unfinished")
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_module.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in values and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no value")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            values[rank] = value
        grace = 30.0
    finally:
        for p in procs:
            p.join(timeout=grace)
            if p.is_alive():
                p.kill()
                p.join()
    return [values[r] for r in range(world)]

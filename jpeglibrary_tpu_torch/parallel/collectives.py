"""The mesh layer's few collectives, on the device its backend takes.

The mesh code moves little between ranks: the symbol histograms
(``all_reduce``), the last DC of each DC predictor chain at a shard
boundary, a rank's share of a batch decode, and one-int agreements
(``all_gather``). Each function here copies its tensor to the device the
group's backend works on, runs the collective there and hands the result
back on the tensor's own device. The rule is fixed by backend: NCCL
takes the rank's current CUDA device, gloo the CPU (on a card, the
kernels run on the card and the collectives on host copies). Any other
backend raises.

Neither gloo nor NCCL gathers int16: int16 travels widened to int32.
:func:`full_tensor`, the whole of a DTensor, gathers through the same rule
(gloo's own ``DTensor.full_tensor()`` of CUDA shards crashes its ranks).
PERF.md records what the card refused.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def backend_device(group=None) -> torch.device:
    """The device ``group``'s backend runs its collectives on."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    if backend == "gloo":
        return torch.device("cpu")
    raise ValueError(f"no collective device rule for backend {backend!r}")


def all_reduce_sum(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``tensor`` over ``group``'s ranks, on ``tensor``'s device."""
    work = tensor.to(backend_device(group), copy=True)
    dist.all_reduce(work, op=dist.ReduceOp.SUM, group=group)
    return work.to(tensor.device)


def all_gather(tensor: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``tensor`` (one shape and dtype on all ranks), in
    group rank order, on ``tensor``'s device."""
    wire = torch.int32 if tensor.dtype == torch.int16 else tensor.dtype
    work = tensor.to(backend_device(group), wire).contiguous()
    parts = [torch.empty_like(work) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, work, group=group)
    return [p.to(tensor.device, tensor.dtype) for p in parts]


def all_gather_int(value: int, group=None) -> List[int]:
    """Every rank's ``value``, in group rank order."""
    return [int(v) for v in all_gather(torch.tensor([value], dtype=torch.int64), group)]


def full_tensor(x) -> torch.Tensor:
    """The whole of DTensor ``x`` on every rank, on ``x``'s device: what
    ``x.full_tensor()`` gives, gathered by :func:`all_gather` under the
    backend rule. Each mesh dim whose placement is ``Shard(k)`` is
    gathered and concatenated along k, the last mesh dim first (rank
    order is row-major over the mesh)."""
    mesh = x.device_mesh
    out = x.to_local()
    for dim in reversed(range(mesh.ndim)):
        placement = x.placements[dim]
        if placement.is_shard():
            out = torch.cat(all_gather(out, mesh.get_group(dim)), dim=placement.dim)
    return out

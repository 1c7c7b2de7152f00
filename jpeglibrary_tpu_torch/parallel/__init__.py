"""Batches, streams, the batch step and the mesh.

``batch``: ``decode_batch_rgb`` (one stacked transform per frame
geometry, over a mesh's ``data`` axis when given one),
``decode_stream_rgb`` (host scans ahead on threads, the device transforms
image by image or in groups) and ``encode_batch_rgb``.
``sharding``: ``full_step`` (decode transform, re-encode transform and
Huffman symbol statistics of a batch of 4:2:0 images), ``progressive_step``
(the per-image symbol statistics of a progressive scan script), ``make_mesh`` (a
``torch.distributed`` DeviceMesh, one rank per device) and the sharded
programs over it. ``distributed``: joining a process group, and the
multi-process batch decode ``decode_batch_rgb_global``. ``collectives``:
the mesh's few collectives.
"""

from .batch import decode_batch_rgb, decode_stream_rgb, encode_batch_rgb
from .distributed import decode_batch_rgb_global, local_batch_block
from .sharding import batched_transform_rgb, full_step, make_mesh, progressive_step

__all__ = [
    "make_mesh",
    "batched_transform_rgb",
    "full_step",
    "progressive_step",
    "decode_batch_rgb",
    "decode_batch_rgb_global",
    "local_batch_block",
    "decode_stream_rgb",
    "encode_batch_rgb",
]

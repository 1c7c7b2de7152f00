"""Batches, streams and the batch step, on one device.

``batch``: ``decode_batch_rgb`` (one stacked transform per frame
geometry), ``decode_stream_rgb`` (host scans ahead on threads, the device
transforms image by image or in groups) and ``encode_batch_rgb``.
``sharding``: ``full_step`` (decode transform, re-encode transform and
Huffman symbol statistics of a batch of 4:2:0 images) and
``batched_transform_rgb``. The JAX package's mesh functions and
``distributed`` are not ported yet.
"""

from .batch import decode_batch_rgb, decode_stream_rgb, encode_batch_rgb
from .sharding import batched_transform_rgb, full_step

__all__ = [
    "batched_transform_rgb",
    "decode_batch_rgb",
    "decode_stream_rgb",
    "encode_batch_rgb",
    "full_step",
]

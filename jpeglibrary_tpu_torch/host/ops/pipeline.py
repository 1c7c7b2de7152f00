"""The port's copy of the host half of ``jpeglibrary_tpu/ops/pipeline.py``:
the numpy packer of the (flat index, value) wire that
``jpeglibrary_tpu_torch.ops.pipeline.transform_packed`` densifies on the
device (the JAX ``jitted_transform_packed``). The JAX module's compiled
transforms are the port's ``ops/pipeline.py``.
"""

from __future__ import annotations

import numpy as np

from ..models.geometry import FrameGeometry


def pack_sparse(coefficients, geometry: FrameGeometry, *, bucket_factor: float = 1.5) -> np.ndarray:
    """All components' nonzero coefficients packed into ONE FLAT int32
    buffer of interleaved (global flat index, value) pairs — a single
    host->device transfer per image, 1-D so the device layout isn't
    lane-padded. Bucketed zero padding keeps shapes stable (scatter-ADD
    of 0 at index 0 is a no-op)."""
    idx_parts = []
    val_parts = []
    base = 0
    for cg in geometry.components:
        flat = coefficients[cg.component_index].reshape(-1)
        idx = np.flatnonzero(flat)
        idx_parts.append(idx + base)
        val_parts.append(flat[idx])
        base += flat.shape[0]
    idx_all = np.concatenate(idx_parts)
    val_all = np.concatenate(val_parts)
    n = len(idx_all)
    bucket = 1024
    while bucket < n:
        bucket = (int(bucket * bucket_factor) + 1023) & ~1023
    packed = np.zeros((bucket, 2), dtype=np.int32)
    packed[:n, 0] = idx_all
    packed[:n, 1] = val_all
    return packed.reshape(-1)

"""Host helpers of the batched decode.

The port's copy of the host half of ``jpeglibrary_tpu/parallel/batch.py``:
the scan of a batch, the grouping key, and the stacking of quant tables
and v2 payloads. The JAX programs that consume them are not copied; the
port's batched and streaming decode is ``jpeglibrary_tpu_torch.parallel.batch``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np

from ..models.decoder import DecodeResult, JpegDecoder


def scan_images(datas: Sequence[bytes], *, max_workers: Optional[int] = None) -> List[DecodeResult]:
    """Host stage: parse + entropy-decode each image (no transform;
    merged sparse fast path when eligible)."""
    def one(data: bytes) -> DecodeResult:
        dec = JpegDecoder()
        dec.set_input(data)
        return dec.decode(sparse_direct=True)

    if len(datas) == 1:
        return [one(datas[0])]
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(one, datas))


def _group_key(r: DecodeResult):
    return r.geometry


def _stacked_quants(batch, geometry) -> np.ndarray:
    """[B, n_comps, 64] int32 — each image's OWN quant tables, vmapped
    alongside its payload (grouping is by geometry only, which says
    nothing about quality)."""
    return np.stack(
        [
            np.stack(
                [r.quant[c.component_index] for c in geometry.components]
            )
            for r in batch
        ]
    ).astype(np.int32)


def _device_color_ok(r) -> bool:
    """The stacked/grouped device transforms apply the YCbCr->RGB
    matrix — the same coverage as the port's ``to_rgb8_device``. RGB-coded
    and CMYK/YCCK streams must NOT ride them (silently mis-colored
    output otherwise)."""
    return r.color_transform in ("ycbcr", "gray")


def _stack_payloads2(batch, geometry) -> Optional[np.ndarray]:
    """Stack same-geometry v2 payloads into one [B, K] uint8 batch,
    re-bucketing to the group's largest AC bucket (zero padding in
    every stream is a device no-op) — same-geometry images routinely
    carry different AC densities, so requiring byte-identical shapes
    would send the common heterogeneous batch down the dense re-pack
    path. Returns None when any image lacks a v2 payload."""
    if not all(r.packed_mcu2 is not None for r in batch):
        return None
    from ..native import scanner as native_scanner

    bpm = sum(c.h * c.v for c in geometry.components)
    nb = geometry.mcus_per_line * geometry.mcus_per_column * bpm
    bn = max(native_scanner.v2_payload_bn(r.packed_mcu2, nb) for r in batch)
    return np.stack(
        [
            native_scanner.rebucket_v2_payload(r.packed_mcu2, nb, bn)
            for r in batch
        ]
    )

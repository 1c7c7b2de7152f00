"""Device encode in PyTorch: a configured ``JpegEncoder`` -> JPEG bytes,
with the sample transform on a PyTorch device.

Port of the device branch of ``jpeglibrary_tpu.models.encoder.JpegEncoder.encode``
(``xp=jnp``) and of its entry points ``encode_rgb``, ``encode_gray`` and
``encode_cmyk``. The host layers are the port's copy of the JAX package's
(``host/``): RGB input is converted on the host with the native
``rgb_to_ycbcr``, and CMYK/YCCK ink with the staged conversion, as that
branch converts them;
``ops.encode_stage.forward`` computes the coefficient planes on the
device; and a shallow copy of the encoder, given those planes through
``set_coefficient_planes``, orders them into MCUs and runs the Huffman
or arithmetic emission, which gives the bytes the JAX branch gives for
the same planes. The inputs that the JAX package encodes on the host
whatever ``xp`` is (coefficient planes, pull readers, streams) go to the
port's host encoder, as they go to the JAX package's.

Each entry point takes the JAX package's ``xp`` besides ``device``:
``xp=np`` is the host encoder (the JAX default), ``xp=torch`` the card and
a ``torch.device`` that device (``ops._device.encode_target``). With
neither ``xp`` nor ``device`` the port encodes on the card, where the JAX
package's default is the host: the port's entry points run on the card
unless asked otherwise, and without a card they raise rather than fall
back to the CPU.
"""

from __future__ import annotations

import copy
from typing import List

import numpy as np
import torch

from ..host.models.encoder import JpegEncodeError, JpegEncoder, _configure_rgb_encoder
from ..host.models.geometry import ceil_div
from ..host.ops import color as color_ops
from ..host.syntax import huffman_standard
from ..host.syntax.quantization import (
    scale_by_quality,
    standard_chrominance_table,
    standard_luminance_table,
)
from ..ops import _build, _device, encode_stage

#: Inputs that ``JpegEncoder.encode`` encodes on the host whatever ``xp``
#: is: streams and pull readers run its streaming encoders ahead of any
#: transform, and coefficient planes are already quantized.
HOST_INPUTS = ("_input_stream", "_input_rgb_reader", "_input_reader", "_coefficient_planes")


def takes_host_path(encoder: JpegEncoder) -> bool:
    """True when ``encoder``'s input is one of :data:`HOST_INPUTS`."""
    return any(getattr(encoder, field) is not None for field in HOST_INPUTS)


def ink_planes(ink: np.ndarray, ycck: bool) -> List[np.ndarray]:
    """The 4 uint8 sample planes of CMYK ink, converted as the JAX
    package's staged ink path converts them: plain CMYK stores ``255 -
    ink``; YCCK runs the CMY triple through the fixed-point RGB -> YCbCr
    transform and stores K inverted."""
    if not ycck:
        return [255 - ink[..., i] for i in range(4)]
    y, cb, cr = color_ops.rgb_to_ycbcr(
        ink[..., 0].astype(np.int32), ink[..., 1].astype(np.int32),
        ink[..., 2].astype(np.int32),
    )
    return [y.astype(np.uint8), cb.astype(np.uint8), cr.astype(np.uint8), 255 - ink[..., 3]]


def device_quants(encoder: JpegEncoder, device) -> torch.Tensor:
    """The encoder's quant tables in component order, stacked as int32
    [C, 64] zig-zag on ``device``."""
    by_id = {t.identifier: t for t in encoder._quant_tables}
    quants = []
    for comp in encoder._components:
        table = by_id.get(comp.quantization_table_id)
        if table is None or table.is_empty:
            raise JpegEncodeError(
                f"Quantization table {comp.quantization_table_id} is not defined."
            )
        quants.append(table.elements)
    return torch.from_numpy(np.stack(quants).astype(np.int32)).to(device)


def sample_planes(encoder: JpegEncoder) -> List[np.ndarray]:
    """The encoder's sample planes as the device stage takes them (uint8
    at 8 bits, int32 at 12): its input planes, or its RGB or ink input
    converted on the host. Raises for what the device branch does not
    take: the inputs of :data:`HOST_INPUTS` and differential frames
    (which take coefficient planes)."""
    if takes_host_path(encoder):
        raise JpegEncodeError("the device stage takes sample planes, RGB or ink")
    if encoder.differential:
        raise JpegEncodeError(
            "differential frames take pre-quantized coefficient planes "
            "(set_coefficient_planes), not samples")
    if encoder.sample_precision not in (8, 12):
        raise JpegEncodeError(
            f"the device encode takes 8- and 12-bit samples, not {encoder.sample_precision}"
        )
    if not encoder._components:
        raise JpegEncodeError("No component is specified.")
    planes = encoder._input_planes
    if planes is None and encoder._input_ink is not None:
        planes = ink_planes(*encoder._input_ink)
    if planes is None:
        if encoder._input_rgb is None:
            raise JpegEncodeError("Input is not specified.")
        from ..host.native import scanner as native_scanner

        _build.load_scanner()
        planes = native_scanner.rgb_to_ycbcr(encoder._input_rgb)
    if len(planes) != len(encoder._components):
        raise JpegEncodeError("Component count does not match input planes.")
    dtype = np.uint8 if encoder.sample_precision == 8 else np.int32
    return [np.asarray(p, dtype=dtype) for p in planes]


def coefficient_planes(encoder: JpegEncoder, *, device) -> List[np.ndarray]:
    """The device half of the encode: int16 [Hb, Wb, 64] zig-zag
    coefficient planes, one per component, computed on ``device``."""
    planes = sample_planes(encoder)
    comps = encoder._components
    max_h = max(c.h for c in comps)
    max_v = max(c.v for c in comps)
    comp_params = tuple((c.h, c.v, max_h // c.h, max_v // c.v) for c in comps)
    outs = encode_stage.forward(
        planes, device_quants(encoder, device), comp_params,
        ceil_div(encoder._width, 8 * max_h), ceil_div(encoder._height, 8 * max_v),
        1 << (encoder.sample_precision - 1), device,
    )
    return [o.numpy() for o in outs]


def emit(encoder: JpegEncoder, planes) -> bytes:
    """The host half: MCU ordering, tables and entropy emission of
    ``planes`` by a shallow copy of ``encoder``, which keeps its input."""
    _build.load_scanner()  # the native emitter; no image falls back to Python
    out = copy.copy(encoder)
    out._input_planes = None
    out.set_coefficient_planes(planes, encoder._width, encoder._height)
    return out.encode()


def encode(encoder: JpegEncoder, *, device=None, xp=None) -> bytes:
    """JPEG bytes of a configured encoder, the sample transform on
    ``device``: the port of ``JpegEncoder.encode(xp=jnp)``. ``xp=np`` runs
    the host encoder instead; with neither ``xp`` nor ``device``, the card
    (``ops._device.encode_target``).

    Sample planes, RGB and CMYK/YCCK ink take the device stage (one K2
    launch per component). Coefficient planes, pull readers and streams
    take the port's host encoder, which launches no kernel: the JAX
    package encodes them on the host whatever ``xp`` is, and so gives the
    same bytes. The encoder itself is left as it was (a shallow copy
    runs). With ``encoder.mesh`` set, the host half's optimize-coding
    statistics run over the mesh (``mesh_symbol_frequencies``), giving
    the same bytes."""
    target = _device.encode_target(xp, device)
    if target is None or takes_host_path(encoder):
        return copy.copy(encoder).encode()
    return emit(encoder, coefficient_planes(encoder, device=target))


def rgb_encoder(rgb: np.ndarray, quality: int = 75, *, subsampling: str = "420",
                optimize_coding: bool = False, most_optimal_coding: bool = False,
                restart_interval: int = 0, arithmetic: bool = False) -> JpegEncoder:
    """The encoder that :func:`encode_rgb` runs, configured as
    ``jpeglibrary_tpu.encode_rgb`` configures its own, with ``rgb`` as
    its input."""
    encoder = _configure_rgb_encoder(
        quality, subsampling,
        optimize_coding=optimize_coding,
        most_optimal_coding=most_optimal_coding,
        restart_interval=restart_interval,
        arithmetic=arithmetic,
    )
    encoder.set_input_rgb(np.asarray(rgb, dtype=np.uint8))
    return encoder


def encode_rgb(rgb: np.ndarray, quality: int = 75, *, device=None, subsampling: str = "420",
               optimize_coding: bool = False, most_optimal_coding: bool = False,
               restart_interval: int = 0, arithmetic: bool = False, xp=None) -> bytes:
    """RGB [H, W, 3] uint8 -> JPEG bytes, as ``jpeglibrary_tpu.encode_rgb``
    with the transform on ``device`` (or where ``xp`` says; the card when
    neither is given, where the JAX package's default is the host)."""
    return encode(rgb_encoder(
        rgb, quality, subsampling=subsampling, optimize_coding=optimize_coding,
        most_optimal_coding=most_optimal_coding, restart_interval=restart_interval,
        arithmetic=arithmetic,
    ), device=device, xp=xp)


def encode_gray(plane: np.ndarray, quality: int = 75, *, device=None,
                optimize_coding: bool = False, most_optimal_coding: bool = False,
                precision: int = 8, restart_interval: int = 0,
                arithmetic: bool = False, xp=None) -> bytes:
    """Grayscale [H, W] -> JPEG bytes, as ``jpeglibrary_tpu.encode_gray``
    with the transform on ``device`` (or where ``xp`` says, as in
    :func:`encode_rgb`): 8-bit (SOF0) or 12-bit samples in [0, 4095]
    (SOF1, level shift 2048, built tables)."""
    encoder = JpegEncoder()
    encoder.most_optimal_coding = most_optimal_coding
    encoder.restart_interval = restart_interval
    encoder.arithmetic = arithmetic
    encoder.set_quantization_table(scale_by_quality(standard_luminance_table(0), quality))
    if precision != 8:
        encoder.sample_precision = precision
        # The Annex-K tables cover 8-bit symbol ranges only.
        optimize_coding = True
    if arithmetic:
        pass  # adaptive QM coder: no Huffman tables
    elif optimize_coding or most_optimal_coding:
        encoder.set_huffman_table(True, 0)
        encoder.set_huffman_table(False, 0)
    else:
        encoder.set_huffman_table(True, 0, huffman_standard.dc_luminance())
        encoder.set_huffman_table(False, 0, huffman_standard.ac_luminance())
    encoder.add_component(1, 0, 0, 0, 1, 1)
    encoder.set_input([plane])
    return encode(encoder, device=device, xp=xp)


def cmyk_encoder(ink: np.ndarray, quality: int = 75, *, ycck: bool = False,
                 subsampling: str = "420", optimize_coding: bool = False,
                 restart_interval: int = 0) -> JpegEncoder:
    """The encoder that :func:`encode_cmyk` runs, configured as
    ``jpeglibrary_tpu.encode_cmyk`` configures its own (Adobe APP14
    transform 0 or 2; plain CMYK at 1x1; YCCK with Cb/Cr on quant and
    Huffman tables 1 and Y and K at the luma factors of ``subsampling``),
    with ``ink`` as its input."""
    ink = np.asarray(ink, dtype=np.uint8)
    if ink.ndim != 3 or ink.shape[-1] != 4:
        raise JpegEncodeError("encode_cmyk expects [H, W, 4] ink values.")
    encoder = JpegEncoder()
    encoder.most_optimal_coding = False
    encoder.restart_interval = restart_interval
    encoder.add_marker_segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 2 if ycck else 0]))
    tables = [(0, standard_luminance_table, huffman_standard.dc_luminance,
               huffman_standard.ac_luminance)]
    if ycck:
        tables.append((1, standard_chrominance_table, huffman_standard.dc_chrominance,
                       huffman_standard.ac_chrominance))
    for tid, quant, dc, ac in tables:
        encoder.set_quantization_table(scale_by_quality(quant(tid), quality))
        if optimize_coding:
            encoder.set_huffman_table(True, tid)
            encoder.set_huffman_table(False, tid)
        else:
            encoder.set_huffman_table(True, tid, dc())
            encoder.set_huffman_table(False, tid, ac())
    if not ycck:
        for i in range(4):
            encoder.add_component(i + 1, 0, 0, 0, 1, 1)
    else:
        luma_hv = {"420": (2, 2), "444": (1, 1), "422": (2, 1), "440": (1, 2),
                   "411": (4, 1)}.get(subsampling)
        if luma_hv is None:
            raise ValueError(f"unsupported subsampling {subsampling!r}")
        encoder.add_component(1, 0, 0, 0, *luma_hv)
        encoder.add_component(2, 1, 1, 1, 1, 1)
        encoder.add_component(3, 1, 1, 1, 1, 1)
        encoder.add_component(4, 0, 0, 0, *luma_hv)  # K at luma resolution
    encoder.set_input_ink(ink, ycck=ycck)
    return encoder


def encode_cmyk(ink: np.ndarray, quality: int = 75, *, device=None, ycck: bool = False,
                subsampling: str = "420", optimize_coding: bool = False,
                restart_interval: int = 0, xp=None) -> bytes:
    """CMYK ink [H, W, 4] uint8 -> Adobe-tagged 4-component JPEG, as
    ``jpeglibrary_tpu.encode_cmyk`` with the transform on ``device`` (or
    where ``xp`` says, as in :func:`encode_rgb`): the ink converted on the
    host (:func:`ink_planes`), then 4 K2 launches."""
    return encode(cmyk_encoder(
        ink, quality, ycck=ycck, subsampling=subsampling, optimize_coding=optimize_coding,
        restart_interval=restart_interval,
    ), device=device, xp=xp)

"""Universal lossless transcoder: any decodable JPEG -> any entropy
coding, preserving the quantized coefficients exactly (jpegtran-class,
and beyond the reference, whose only transcoder is the baseline-input
Huffman re-optimizer, JpegOptimizer.cs — progressive input explicitly
rejected there, JpegOptimizer.cs:580-582).

DCT modes (SOF0/1/2/9/10 input) re-emit the decoded coefficient planes
with the requested entropy coding; lossless (SOF3) input re-encodes
the sample planes with a chosen predictor and fresh optimal tables.
The gate in every case: the transcoded stream decodes bit-identically
to the input.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..syntax.quantization import QuantizationTable
from .decoder import JpegDecoder

# "baseline" and "optimized" both build Huffman tables from the data
# (fixed standard tables would be a pessimization for a transcoder);
# "optimal" selects package-merge, like the reference optimizer's
# MostOptimalCoding.
MODES = (
    "baseline",
    "optimized",
    "optimal",
    "progressive",
    "arithmetic",
    "arithmetic-progressive",
)


def transcode(
    data: bytes,
    mode: str = "optimized",
    *,
    restart_interval: int = 0,
    predictor: Optional[int] = None,
    grayscale: bool = False,
    device=None,
) -> bytes:
    """Re-encode a JPEG losslessly with a different entropy coding.

    ``mode``: one of {"optimized", "optimal", "progressive",
    "arithmetic", "arithmetic-progressive"} for DCT inputs. Lossless
    (SOF3/SOF11) inputs re-encode predictively (``predictor`` overrides
    the input's selector): the arithmetic modes target SOF11, the rest
    SOF3 with fresh optimal tables; the input scan's point transform is
    carried through.
    ``restart_interval`` adds DRI/RSTn seams where the target coding
    supports them (optimized / arithmetic / lossless).

    ``grayscale=True`` keeps only the luminance component (jpegtran
    -grayscale): the luma blocks pass through untouched, so the gray
    output decodes bit-identically to the input's Y plane.

    An Adobe APP14 tag on the input is copied into the output verbatim
    (like jpegtran): the tag changes the stream's color interpretation
    (RGB / CMYK / YCCK), so dropping it would alter decoded colors.

    ``device`` (a ``torch.device``, mode "progressive" alone) counts the
    progressive script's symbols there (``encode_progressive``'s
    ``device``); the output is the same bytes.
    """
    if device is not None and mode != "progressive":
        raise ValueError(f"mode {mode!r} has no device count; device= is for 'progressive'")
    out = _transcode_inner(
        data, mode, restart_interval=restart_interval, predictor=predictor,
        grayscale=grayscale, device=device,
    )
    if grayscale:
        return out  # single-component: no color tag to preserve
    return _copy_app14(data, out)


def _transcode_inner(
    data: bytes,
    mode: str = "optimized",
    *,
    restart_interval: int = 0,
    predictor: Optional[int] = None,
    grayscale: bool = False,
    device=None,
) -> bytes:
    dec = JpegDecoder()
    dec.set_input(data)
    res = dec.decode()

    if res.samples is not None:
        # Lossless input (SOF3 or SOF11): re-encode the sample planes
        # predictively (the decoded planes are already the padded
        # per-component MCU grids the interleaved walk covers). The
        # arithmetic modes emit SOF11 (adaptive QM coding), everything
        # else SOF3 with fresh optimal tables — so SOF3 <-> SOF11
        # conversion is just transcode(data, "arithmetic") /
        # transcode(data, "optimal").
        from .arithmetic_lossless import encode_lossless_arithmetic
        from .lossless import encode_lossless

        to_arith = mode in ("arithmetic", "arithmetic-progressive")
        frame = res.frame
        sampling = [
            (fc.horizontal_sampling_factor, fc.vertical_sampling_factor)
            for fc in frame.components
        ]
        all_1x1 = all(s == (1, 1) for s in sampling)
        # The input scan's point transform: decoded planes hold
        # Pt-shifted values, so re-encode must shift them back up and
        # declare the same Pt — a conformant third-party decoder
        # renders sample<<Pt either way.
        from ..io.reader import parse_stream
        from ..syntax.frame import ScanHeader as _SH
        from ..syntax.markers import Marker as _M

        stream = parse_stream(data)
        pt = 0
        for seg in stream.segments:
            if seg.marker == _M.SOS:
                pt = _SH.parse(seg.payload(data)).successive_approximation_bit_position_low
                break
        n_keep = 1 if grayscale else len(frame.components)
        planes = [
            (res.samples[i].astype(np.int64) & 0xFFFF) << pt
            for i in range(n_keep)
        ]
        if grayscale:
            sampling = sampling[:1]
            all_1x1 = sampling[0] == (1, 1)
        if restart_interval > 0 and not all_1x1 and not to_arith:
            raise ValueError(
                "restart_interval with sub-sampled Huffman lossless "
                "output is not supported (encode_lossless limitation); "
                "use the arithmetic target or restart_interval=0."
            )

        def enc(sel):
            if all_1x1:
                cropped = [
                    p[: frame.number_of_lines, : frame.samples_per_line]
                    for p in planes
                ]
                if to_arith:
                    return encode_lossless_arithmetic(
                        cropped,
                        precision=frame.sample_precision,
                        predictor=sel,
                        point_transform=pt,
                        restart_interval=restart_interval,
                    )
                return encode_lossless(
                    cropped,
                    precision=frame.sample_precision,
                    predictor=sel,
                    point_transform=pt,
                    restart_interval=restart_interval,
                )
            if to_arith:
                return encode_lossless_arithmetic(
                    planes,
                    precision=frame.sample_precision,
                    predictor=sel,
                    point_transform=pt,
                    sampling=sampling,
                    size=(frame.number_of_lines, frame.samples_per_line),
                    restart_interval=restart_interval,
                )
            return encode_lossless(
                planes,
                precision=frame.sample_precision,
                predictor=sel,
                point_transform=pt,
                sampling=sampling,
                size=(frame.number_of_lines, frame.samples_per_line),
            )

        if predictor is not None:
            return enc(predictor)
        return min((enc(sel) for sel in range(1, 8)), key=len)

    frame = res.frame
    geo = res.geometry
    n_comps = len(frame.components)
    if grayscale:
        # Luma only: its block grid is already the full image at its
        # own resolution — as a single-component frame the sampling
        # factors become 1x1 over the same blocks.
        n_comps = 1
    coeffs = [res.coefficients[i] for i in range(n_comps)]

    # Rebuild quantization tables by selector id.
    qts = {}
    for i, fc in enumerate(frame.components):
        qid = fc.quantization_table_selector
        if qid not in qts:
            elements = res.quant[i].astype(np.int64)
            qts[qid] = QuantizationTable(
                element_precision=0 if elements.max() < 256 else 1,
                identifier=qid,
                elements=elements.astype(np.uint16),
            )

    sampling = [
        (fc.horizontal_sampling_factor, fc.vertical_sampling_factor)
        for fc in frame.components
    ][:n_comps]
    quant_ids = [fc.quantization_table_selector for fc in frame.components][:n_comps]
    comp_ids = [fc.identifier for fc in frame.components][:n_comps]
    if grayscale:
        sampling = [(1, 1)]
        # As a 1x1 single-component frame the luma needs exactly
        # ceil(H/8) x ceil(W/8) blocks; its interleaved grid may carry
        # one extra padded MCU row/column — crop it.
        hb = -(-frame.number_of_lines // 8)
        wb = -(-frame.samples_per_line // 8)
        coeffs = [np.ascontiguousarray(coeffs[0][:hb, :wb])]
        qts = {qid: qt for qid, qt in qts.items() if qid in quant_ids}
    return _emit_dct(
        coeffs, qts, sampling, quant_ids, comp_ids, mode,
        restart_interval=restart_interval,
        size=(frame.number_of_lines, frame.samples_per_line),
        precision=frame.sample_precision,
        device=device,
    )


def _emit_dct(coeffs, qts, sampling, quant_ids, comp_ids, mode, *,
              restart_interval, size, precision, device=None):
    """Emit zig-zag coefficient planes as a JPEG with the requested
    entropy coding (the shared transcode/transform back end)."""
    n_comps = len(coeffs)
    # statistics/table ids: first component gets 0, the rest share 1
    # (the standard luma/chroma split; generalizes to any comp count <= 4)
    table_ids = [0] + [1] * (n_comps - 1) if n_comps > 1 else [0]

    if mode in ("progressive", "arithmetic-progressive"):
        from .progressive_encoder import SCRIPT_1, SCRIPT_3, encode_progressive

        if n_comps == 3:
            script = SCRIPT_3
        elif n_comps == 1:
            script = SCRIPT_1
        else:
            # generic script: DC all, then per-component full AC bands
            script = [(tuple(range(n_comps)), 0, 0, 0, 1)]
            script += [((i,), 1, 63, 0, 1) for i in range(n_comps)]
            script += [(tuple(range(n_comps)), 0, 0, 1, 0)]
            script += [((i,), 1, 63, 1, 0) for i in range(n_comps)]
        return encode_progressive(
            None,
            qts,
            sampling,
            quant_ids=quant_ids,
            table_ids=table_ids,
            script=script,
            arithmetic=(mode == "arithmetic-progressive"),
            coefficients=coeffs,
            size=size,
            precision=precision,
            device=device,
        )

    from .encoder import JpegEncoder

    enc = JpegEncoder()
    enc.sample_precision = precision
    enc.restart_interval = restart_interval
    for qt in qts.values():
        enc.set_quantization_table(qt)
    if mode == "arithmetic":
        enc.arithmetic = True
    elif mode in ("optimized", "baseline", "optimal"):
        enc.most_optimal_coding = mode == "optimal"
        for is_dc in (True, False):
            for tid in set(table_ids):
                enc.set_huffman_table(is_dc, tid)  # build from data
    else:
        raise ValueError(f"unknown transcode mode {mode!r}")
    for i in range(n_comps):
        enc.add_component(
            comp_ids[i], quant_ids[i], table_ids[i], table_ids[i],
            sampling[i][0], sampling[i][1],
        )
    enc.set_coefficient_planes(coeffs, size[1], size[0])
    return enc.encode()


# ---------------------------------------------------------------------------
# Lossless geometric transforms (jpegtran-class, coefficient domain)
# ---------------------------------------------------------------------------

#: supported operations: right-angle rotations, mirrors, transpose and
#: transverse-transpose (= transpose of the 180-degree rotation)
TRANSFORM_OPS = (
    "transpose", "fliph", "flipv", "rot90", "rot180", "rot270", "transverse",
)

# Each op as a sequence of primitives applied left to right. rot90 is
# clockwise (jpegtran -rotate 90): transpose, then mirror the new
# horizontal axis.
_TRANSFORM_SEQ = {
    "transpose": ("t",),
    "fliph": ("fh",),
    "flipv": ("fv",),
    "rot90": ("t", "fh"),
    "rot270": ("t", "fv"),
    "rot180": ("fh", "fv"),
    "transverse": ("t", "fh", "fv"),
}


def _zz_tables():
    """Per-primitive tables over the ZIG-ZAG coefficient axis, so the
    transforms never round-trip through natural order: a transpose
    permutation (out_zz[z] = in_zz[perm[z]]) and the (-1)^v / (-1)^u
    sign vectors."""
    from ..ops.zigzag import BLOCK_TO_ZIGZAG, ZIGZAG_TO_BLOCK

    nat = ZIGZAG_TO_BLOCK
    perm = np.array(
        [BLOCK_TO_ZIGZAG[(nat[z] % 8) * 8 + nat[z] // 8] for z in range(64)],
        dtype=np.int64,
    )
    sign_v = np.array([(-1) ** (nat[z] % 8) for z in range(64)], dtype=np.int16)
    sign_u = np.array([(-1) ** (nat[z] // 8) for z in range(64)], dtype=np.int16)
    return perm, sign_v, sign_u


_ZZ_TRANSPOSE, _ZZ_SIGN_V, _ZZ_SIGN_U = _zz_tables()


def _materialize_zz(view: np.ndarray, perm: np.ndarray,
                    sign: np.ndarray) -> np.ndarray:
    """One-pass contiguous materialization of a composed transform
    (native threaded gather; numpy fallback is bit-identical)."""
    try:
        from ..native import build as native_build
        from ..native import scanner as native_scanner

        native_build.load_library()
        return native_scanner.zz_block_permute(view, perm, sign)
    except ImportError:
        return np.ascontiguousarray(
            (view[..., perm].astype(np.int32) * sign).astype(np.int16)
        )


def transform(
    data: bytes,
    op: str,
    *,
    mode: str = "optimized",
    restart_interval: int = 0,
    trim: bool = False,
) -> bytes:
    """Lossless geometric transform in the coefficient domain
    (jpegtran-class: ``-rotate 90/180/270``, ``-flip h/v``,
    ``-transpose``, ``-transverse`` — a capability absent from the
    reference, whose only transcoder re-optimizes Huffman tables).

    DCT inputs (SOF0/1/2/9/10) transform the quantized coefficients
    exactly: the block grid is permuted, each 8x8 block is transposed
    and/or sign-flipped ((-1)^u / (-1)^v mirrors the spatial axes), and
    transpose ops also transpose the quantization tables and swap each
    component's sampling factors. No requantization happens, so a
    rot90+rot270 round trip is coefficient-exact.

    Mirror axes must fall on iMCU boundaries (jpegtran -perfect):
    ``fliph``/``rot270`` need width % (8*max_h) == 0, ``flipv``/
    ``rot90`` need height % (8*max_v) == 0, ``rot180``/``transverse``
    both. Pass ``trim=True`` to drop the offending partial edge
    instead (jpegtran -trim).

    Lossless inputs (SOF3/SOF11, 1x1 sampling) transform the sample
    planes spatially and re-encode predictively — exact by
    construction.

    ``mode``/``restart_interval`` choose the output entropy coding as
    in :func:`transcode`.
    """
    if op not in _TRANSFORM_SEQ:
        raise ValueError(f"unknown transform {op!r}; one of {TRANSFORM_OPS}")
    out = _transform_inner(
        data, op, mode=mode, restart_interval=restart_interval, trim=trim
    )
    return _copy_app14(data, out)


def _copy_app14(data: bytes, out: bytes) -> bytes:
    """Copy an input Adobe APP14 tag into the output (color
    interpretation must survive a lossless transform/transcode)."""
    from ..io.reader import parse_stream
    from ..syntax.markers import Marker as _M

    for seg in parse_stream(data).segments:
        if seg.marker == _M.APP14:
            payload = seg.payload(data)
            if len(payload) >= 12 and payload[:5] == b"Adobe":
                assert out[:2] == b"\xff\xd8"
                return out[:2] + data[seg.offset : seg.payload_end] + out[2:]
        if seg.marker == _M.SOS:
            break
    return out


def _transform_inner(data, op, *, mode, restart_interval, trim):
    dec = JpegDecoder()
    dec.set_input(data)
    res = dec.decode()
    frame = res.frame

    if res.samples is not None:
        # Lossless input: spatial ops on the sample planes.
        sampling = [
            (fc.horizontal_sampling_factor, fc.vertical_sampling_factor)
            for fc in frame.components
        ]
        if any(s != (1, 1) for s in sampling):
            raise ValueError(
                "geometric transforms of sub-sampled lossless streams "
                "are not supported (1x1 sampling only)"
            )
        planes = [
            (res.samples[i].astype(np.int64) & 0xFFFF)[
                : frame.number_of_lines, : frame.samples_per_line
            ]
            for i in range(len(frame.components))
        ]
        # Identical compositions to the coefficient-domain primitives:
        # t = transpose, fh = mirror columns, fv = mirror rows.
        spatial = {
            "transpose": lambda p: p.T,
            "fliph": lambda p: p[:, ::-1],
            "flipv": lambda p: p[::-1, :],
            "rot90": lambda p: p.T[:, ::-1],      # t, fh (clockwise)
            "rot270": lambda p: p.T[::-1, :],     # t, fv
            "rot180": lambda p: p[::-1, ::-1],    # fh, fv
            "transverse": lambda p: p.T[::-1, ::-1],  # t, fh, fv
        }[op]
        planes = [np.ascontiguousarray(spatial(p)) for p in planes]
        from ..io.reader import parse_stream
        from ..syntax.frame import ScanHeader as _SH
        from ..syntax.markers import Marker as _M

        pt = 0
        for seg in parse_stream(data).segments:
            if seg.marker == _M.SOS:
                pt = _SH.parse(
                    seg.payload(data)
                ).successive_approximation_bit_position_low
                break
        to_arith = mode in ("arithmetic", "arithmetic-progressive")
        if to_arith:
            from .arithmetic_lossless import encode_lossless_arithmetic

            return encode_lossless_arithmetic(
                [p << pt for p in planes],
                precision=frame.sample_precision,
                predictor=1,
                point_transform=pt,
                restart_interval=restart_interval,
            )
        from .lossless import encode_lossless

        shifted = [p << pt for p in planes]

        def enc(sel):
            return encode_lossless(
                shifted,
                precision=frame.sample_precision,
                predictor=sel,
                point_transform=pt,
                restart_interval=restart_interval,
            )

        return min((enc(sel) for sel in range(1, 8)), key=len)

    n_comps = len(frame.components)
    max_h = max(fc.horizontal_sampling_factor for fc in frame.components)
    max_v = max(fc.vertical_sampling_factor for fc in frame.components)
    sampling = [
        (fc.horizontal_sampling_factor, fc.vertical_sampling_factor)
        for fc in frame.components
    ]
    quant_ids = [fc.quantization_table_selector for fc in frame.components]
    comp_ids = [fc.identifier for fc in frame.components]
    w, h = frame.samples_per_line, frame.number_of_lines

    # Planes stay in the zig-zag domain throughout: grid ops are numpy
    # slices/transposes and the per-block ops are one permutation take
    # (transpose) or one sign multiply (mirrors) over the 64-axis —
    # no natural-order round trip.
    zz = [res.coefficients[i] for i in range(n_comps)]

    qzz = {}
    for i in range(n_comps):
        qid = quant_ids[i]
        if qid not in qzz:
            qzz[qid] = res.quant[i].astype(np.int64)

    def trim_axis(horizontal):
        nonlocal zz, w, h
        if horizontal:
            new_w = (w // (8 * max_h)) * 8 * max_h
            if new_w == 0:
                raise ValueError("image narrower than one iMCU; cannot trim")
            for i in range(n_comps):
                hshare = sampling[i][0]
                zz[i] = zz[i][:, : (new_w // (8 * max_h)) * hshare]
            w = new_w
        else:
            new_h = (h // (8 * max_v)) * 8 * max_v
            if new_h == 0:
                raise ValueError("image shorter than one iMCU; cannot trim")
            for i in range(n_comps):
                vshare = sampling[i][1]
                zz[i] = zz[i][: (new_h // (8 * max_v)) * vshare]
            h = new_h

    def require_imcu(horizontal, what):
        if horizontal and w % (8 * max_h) != 0:
            if trim:
                trim_axis(True)
            else:
                raise ValueError(
                    f"{what} needs width % {8 * max_h} == 0 (iMCU-aligned, "
                    "jpegtran -perfect); pass trim=True to drop the edge"
                )
        if not horizontal and h % (8 * max_v) != 0:
            if trim:
                trim_axis(False)
            else:
                raise ValueError(
                    f"{what} needs height % {8 * max_v} == 0 (iMCU-aligned, "
                    "jpegtran -perfect); pass trim=True to drop the edge"
                )

    # Compose the transform lazily: grid ops (transpose / mirrors) are
    # numpy VIEWS (no copies), per-block ops compose into one shared
    # (perm, sign) pair — grid ops act on axes 0/1, per-block ops on
    # the zig-zag axis, so they commute. One threaded native pass per
    # plane then materializes out[i,j,z] = view[i,j,perm[z]] * sign[z];
    # the previous eager numpy gather chain cost ~90 ms of the 140 ms
    # jt.transform total on a 4.2 MP image.
    zz = [p if p.dtype == np.int16 else p.astype(np.int16) for p in zz]
    perm = np.arange(64, dtype=np.int64)
    sign = np.ones(64, dtype=np.int32)
    for prim in _TRANSFORM_SEQ[op]:
        if prim == "t":
            zz = [p.transpose(1, 0, 2) for p in zz]
            perm = perm[_ZZ_TRANSPOSE]
            sign = sign[_ZZ_TRANSPOSE]
            sampling = [(v, hh) for hh, v in sampling]
            w, h = h, w
            max_h, max_v = max_v, max_h
        elif prim == "fh":
            require_imcu(True, op)
            zz = [p[:, ::-1] for p in zz]
            sign = sign * _ZZ_SIGN_V
        elif prim == "fv":
            require_imcu(False, op)
            zz = [p[::-1, :] for p in zz]
            sign = sign * _ZZ_SIGN_U

    qzz = {qid: q[perm] for qid, q in qzz.items()}
    coeffs = [_materialize_zz(p, perm, sign) for p in zz]
    qts = {
        qid: QuantizationTable(
            element_precision=0 if q.max() < 256 else 1,
            identifier=qid,
            elements=q.astype(np.uint16),
        )
        for qid, q in qzz.items()
    }
    return _emit_dct(
        coeffs, qts, sampling, quant_ids, comp_ids, mode,
        restart_interval=restart_interval,
        size=(h, w),
        precision=frame.sample_precision,
    )


def crop(
    data: bytes,
    x: int,
    y: int,
    width: int,
    height: int,
    *,
    snap: bool = False,
    mode: str = "optimized",
    restart_interval: int = 0,
) -> bytes:
    """Lossless crop in the coefficient domain (jpegtran -crop).

    The kept blocks are untouched, so the cropped stream decodes
    BIT-identically to the same region of the input's decode. ``x``/
    ``y`` must sit on iMCU boundaries (``8*max_h`` / ``8*max_v``);
    ``snap=True`` moves them down to the nearest boundary instead of
    raising (the kept region then grows leftward/upward, jpegtran's
    default adjustment). ``width``/``height`` may be arbitrary.

    Lossless (SOF3/SOF11) inputs crop the sample planes spatially at
    any offset. DCT inputs re-emit with the entropy coding selected by
    ``mode`` (as in :func:`transcode`).
    """
    out = _crop_inner(
        data, x, y, width, height, snap=snap, mode=mode,
        restart_interval=restart_interval,
    )
    return _copy_app14(data, out)


def _crop_inner(data, x, y, width, height, *, snap, mode, restart_interval):
    if width <= 0 or height <= 0 or x < 0 or y < 0:
        raise ValueError("crop region must be positive and inside the image")
    dec = JpegDecoder()
    dec.set_input(data)
    res = dec.decode()
    frame = res.frame
    w0, h0 = frame.samples_per_line, frame.number_of_lines
    if x + width > w0 or y + height > h0:
        raise ValueError(
            f"crop region {x},{y} {width}x{height} exceeds image {w0}x{h0}"
        )

    if res.samples is not None:
        sampling = [
            (fc.horizontal_sampling_factor, fc.vertical_sampling_factor)
            for fc in frame.components
        ]
        if any(s != (1, 1) for s in sampling):
            raise ValueError(
                "cropping sub-sampled lossless streams is not supported "
                "(1x1 sampling only)"
            )
        from ..io.reader import parse_stream
        from ..syntax.frame import ScanHeader as _SH
        from ..syntax.markers import Marker as _M

        pt = 0
        for seg in parse_stream(data).segments:
            if seg.marker == _M.SOS:
                pt = _SH.parse(
                    seg.payload(data)
                ).successive_approximation_bit_position_low
                break
        planes = [
            ((res.samples[i].astype(np.int64) & 0xFFFF) << pt)[
                y : y + height, x : x + width
            ]
            for i in range(len(frame.components))
        ]
        from .lossless import encode_lossless

        if mode in ("arithmetic", "arithmetic-progressive"):
            from .arithmetic_lossless import encode_lossless_arithmetic

            return encode_lossless_arithmetic(
                planes,
                precision=frame.sample_precision,
                predictor=1,
                point_transform=pt,
                restart_interval=restart_interval,
            )

        def enc(sel):
            return encode_lossless(
                planes,
                precision=frame.sample_precision,
                predictor=sel,
                point_transform=pt,
                restart_interval=restart_interval,
            )

        return min((enc(sel) for sel in range(1, 8)), key=len)

    n_comps = len(frame.components)
    max_h = max(fc.horizontal_sampling_factor for fc in frame.components)
    max_v = max(fc.vertical_sampling_factor for fc in frame.components)
    imcu_w, imcu_h = 8 * max_h, 8 * max_v
    if x % imcu_w or y % imcu_h:
        if snap:
            nx, ny = (x // imcu_w) * imcu_w, (y // imcu_h) * imcu_h
            width += x - nx
            height += y - ny
            x, y = nx, ny
        else:
            raise ValueError(
                f"crop origin must be iMCU-aligned ({imcu_w}x{imcu_h}); "
                "pass snap=True to move it down to the boundary"
            )

    sampling = [
        (fc.horizontal_sampling_factor, fc.vertical_sampling_factor)
        for fc in frame.components
    ]
    quant_ids = [fc.quantization_table_selector for fc in frame.components]
    comp_ids = [fc.identifier for fc in frame.components]

    def ceil_div(a, b):
        return -(-a // b)

    coeffs = []
    for i in range(n_comps):
        hh, vv = sampling[i]
        p = res.coefficients[i]
        bx0 = (x // imcu_w) * hh
        by0 = (y // imcu_h) * vv
        wb = ceil_div(width, imcu_w) * hh
        hb = ceil_div(height, imcu_h) * vv
        coeffs.append(
            np.ascontiguousarray(p[by0 : by0 + hb, bx0 : bx0 + wb]).astype(
                np.int16
            )
        )

    qts = {}
    for i in range(n_comps):
        qid = quant_ids[i]
        if qid not in qts:
            elements = res.quant[i].astype(np.int64)
            qts[qid] = QuantizationTable(
                element_precision=0 if elements.max() < 256 else 1,
                identifier=qid,
                elements=elements.astype(np.uint16),
            )
    return _emit_dct(
        coeffs, qts, sampling, quant_ids, comp_ids, mode,
        restart_interval=restart_interval,
        size=(height, width),
        precision=frame.sample_precision,
    )


# ---------------------------------------------------------------------------
# EXIF orientation (exiftran / jpegtran -auto-rotate class)
# ---------------------------------------------------------------------------

#: EXIF orientation value (2-8) -> geometric op that uprights the image
EXIF_ORIENTATION_OPS = {
    2: "fliph",
    3: "rot180",
    4: "flipv",
    5: "transpose",
    6: "rot90",
    7: "transverse",
    8: "rot270",
}


def exif_orientation(data: bytes):
    """Read the EXIF orientation tag (1-8) from an APP1 segment, or
    None when absent/unparseable. Minimal TIFF IFD0 walk (both byte
    orders), no third-party EXIF library."""
    import struct

    from ..io.reader import parse_stream
    from ..syntax.markers import Marker as _M

    for seg in parse_stream(data).segments:
        if seg.marker == _M.SOS:
            break
        if seg.marker != _M.APP1:
            continue
        payload = seg.payload(data)
        if not payload.startswith(b"Exif\x00\x00"):
            continue
        tiff = payload[6:]
        if len(tiff) < 14:
            return None
        if tiff[:2] == b"II":
            end = "<"
        elif tiff[:2] == b"MM":
            end = ">"
        else:
            return None
        try:
            magic, ifd0 = struct.unpack(end + "HI", tiff[2:8])
            if magic != 42:
                return None
            (count,) = struct.unpack(end + "H", tiff[ifd0 : ifd0 + 2])
            for k in range(count):
                off = ifd0 + 2 + 12 * k
                tag, typ, n = struct.unpack(end + "HHI", tiff[off : off + 8])
                if tag == 0x0112 and typ == 3 and n >= 1:
                    (val,) = struct.unpack(end + "H", tiff[off + 8 : off + 10])
                    return val if 1 <= val <= 8 else None
        except struct.error:
            return None
    return None


def autorotate(
    data: bytes,
    *,
    mode: str = "optimized",
    restart_interval: int = 0,
    trim: bool = False,
) -> bytes:
    """Upright a JPEG according to its EXIF orientation tag, losslessly
    (exiftran / jpegtran -auto-rotate class, via :func:`transform`).

    Orientation 1, a missing/invalid tag, or a lossless-mode input
    return the input unchanged. The output carries no EXIF block, so
    the (now wrong) orientation tag cannot be applied twice.
    """
    orientation = exif_orientation(data)
    if orientation is None or orientation == 1:
        return data
    op = EXIF_ORIENTATION_OPS[orientation]
    return transform(
        data, op, mode=mode, restart_interval=restart_interval, trim=trim
    )

"""The baseline Huffman entropy decode on the device: K3.

Port of ``jpeglibrary_tpu/ops/device_scan.py``, with the same names and
the same results. The host does what is vectorizable anyway: it parses
the container, removes the 0xFF00 stuffing, pads each restart segment
into one row of a byte matrix and lays out the Huffman tables
(:func:`prepare_scan`). The device then walks every segment, one Huffman
symbol at a time, and writes dense zig-zag coefficients in segment-local
MCU order (:func:`decode_segments_device`).

On a CUDA device the walk is K3 (``kernels.huffman_scan``,
``csrc/huffman_scan.cu``): a self-synchronising subsequence decoder, one
thread per subsequence of each row, with the tables in shared memory. The
JAX package ran it as a ``lax.while_loop`` whose lanes are the segments;
:func:`walk_lanes` is that loop's body written out in PyTorch over a lane
dimension, a Python loop that runs until every lane is done, and
:func:`decode_segments_plain` runs it with one lane per segment. That is
K3's plain version: the wrapper takes it for a CPU tensor, the tests hold
it to the JAX loop, and ``chip_smoke.py`` holds K3 to it on the card.
:func:`decode_segments_split_plain` is the CPU model of K3's algorithm on
the same lane step, lanes being subsequences. Everything here is integer
arithmetic, so K3, the plain versions and the host scanner agree bit for
bit.

The semantics are the JAX loop's, for corrupt streams too: a byte read
past a row's width reads the row's last byte (JAX clamps a gather); a
shift by an amount outside [0, 32) gives 0, or the sign for a right shift
(XLA's shift semantics); block indices are clamped to the output.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..host.models.geometry import FrameGeometry
from ..host.syntax.frame import FrameHeader, ScanHeader, resolve_scan_components
from ..host.syntax.huffman import HuffmanDecodingTable
from . import kernels


def _unstuff(seg: bytes) -> bytes:
    """Remove 0xFF00 stuffing, so the device reads a plain bitstream.
    Trailing garbage is irrelevant: the decoder stops after its MCU
    budget."""
    return bytes(seg).replace(b"\xff\x00", b"\xff")


def prepare_scan(
    data: bytes,
    spans,
    frame: FrameHeader,
    scan: ScanHeader,
    dc_tables: Dict[int, HuffmanDecodingTable],
    ac_tables: Dict[int, HuffmanDecodingTable],
    restart_interval: int,
    geometry: FrameGeometry,
):
    """Host prepass: the unstuffed segments as rows of a uint8 matrix
    (0xFF-filled, 8 bytes of peek slack past the longest) and the
    table and geometry constants for :func:`decode_segments_device`.

    ``const["tables"]`` is (lookahead [T, 256] as ``size << 8 | value``,
    maxcode [T, 18], valoffset [T, 19], values [T, 256]), int32, with slot
    2i the DC table and 2i + 1 the AC table of the scan's component i;
    ``comp_of`` is each block of an MCU's component, ``mcu_counts`` each
    segment's MCUs."""
    resolved = resolve_scan_components(frame, scan)
    comps = [geometry.components[ci] for ci, _, _ in resolved]
    bpm = sum(c.h * c.v for c in comps)
    comp_of = []
    for i, c in enumerate(comps):
        comp_of += [i] * (c.h * c.v)

    lookahead = np.zeros((2 * len(comps), 256), dtype=np.int32)
    maxcode = np.zeros((2 * len(comps), 18), dtype=np.int32)
    valoffset = np.zeros((2 * len(comps), 19), dtype=np.int32)
    values = np.zeros((2 * len(comps), 256), dtype=np.int32)
    for i, (_ci, _fc, sc) in enumerate(resolved):
        for j, t in ((2 * i, dc_tables[sc.dc_table_selector]),
                     (2 * i + 1, ac_tables[sc.ac_table_selector])):
            lookahead[j] = (
                (t.lookahead_size.astype(np.int32) << 8)
                | t.lookahead_value.astype(np.int32)
            )
            maxcode[j] = t.maxcode.astype(np.int32)
            valoffset[j, : len(t.valoffset)] = t.valoffset.astype(np.int32)
            values[j, : len(t.values)] = t.values.astype(np.int32)

    total_mcus = geometry.mcus_per_line * geometry.mcus_per_column
    ri = restart_interval if restart_interval > 0 else total_mcus
    segs: List[bytes] = []
    mcus: List[int] = []
    done_mcus = 0
    for sp in spans:
        if done_mcus >= total_mcus:
            break
        n = min(ri, total_mcus - done_mcus)
        segs.append(_unstuff(data[sp.start : sp.end]))
        mcus.append(n)
        done_mcus += n
    width = max(len(s) for s in segs) + 8  # peek slack past the end
    buf = np.full((len(segs), width), 0xFF, dtype=np.uint8)  # 1-fill pad
    for i, s in enumerate(segs):
        buf[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)

    const = {
        "bpm": bpm,
        "comp_of": np.asarray(comp_of, dtype=np.int32),
        "mcu_counts": np.asarray(mcus, dtype=np.int32),
        "tables": (lookahead, maxcode, valoffset, values),
        "n_comps": len(comps),
    }
    return buf, const


def _shl(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """int32 ``x << n`` with XLA's semantics: 0 for n outside [0, 32)."""
    ok = (n >= 0) & (n < 32)
    return torch.where(ok, x << n.clamp(0, 31), torch.zeros_like(x))


def _sar(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """int32 arithmetic ``x >> n`` with XLA's semantics: the sign for n
    outside [0, 32)."""
    ok = (n >= 0) & (n < 32)
    return torch.where(ok, x >> n.clamp(0, 31), torch.where(x < 0, -1, 0).to(x.dtype))


def walk_lanes(buf: torch.Tensor, lane_row: torch.Tensor, bit: torch.Tensor, k: torch.Tensor,
               block: torch.Tensor, preds: torch.Tensor, comp_of: torch.Tensor,
               lookahead: torch.Tensor, maxcode: torch.Tensor, valoffset: torch.Tensor,
               values: torch.Tensor, *, end_bit: Optional[torch.Tensor] = None,
               budget: Optional[torch.Tensor] = None, out: Optional[torch.Tensor] = None,
               max_blocks: int = 1):
    """The JAX ``while_loop`` body over N lanes, each walking a row of
    ``buf`` (uint8 [S, W]) one Huffman symbol per step: K3's step, the one
    every plain decode here runs.

    Lane i walks row ``lane_row[i]`` from the code boundary (``bit[i]``,
    ``k[i]``, ``block[i]``): its bit position, zig-zag index and block
    index, whose ``block % bpm`` picks the component; ``preds[i]`` (int32
    [N, components]) are its DC predictors there. A lane steps while its
    bit is below ``end_bit[i]`` (no limit when None) and its block below
    ``budget[i]`` (no limit when None). With ``out`` (a flat int32 [S *
    max_blocks * 64]) each emission is added there, at the lane's row,
    block (clamped to ``max_blocks - 1``) and zig-zag index, as JAX's
    ``.at[].add``. Returns the exit states (bit, k, block, preds), new
    tensors (int64, int64, int64, int32)."""
    dev = buf.device
    i32 = torch.int32
    width = buf.shape[1]
    n_lanes = lane_row.shape[0]
    bpm = comp_of.shape[0]
    lane = torch.arange(n_lanes, device=dev)
    row = lane_row.to(torch.int64) * width
    out_row = lane_row.to(torch.int64) * (max_blocks * 64)
    flat = buf.reshape(-1)
    comp_of = comp_of.to(torch.int64)
    lookahead, values = lookahead.reshape(-1), values.reshape(-1)
    maxcode, valoffset = maxcode.to(i32), valoffset.reshape(-1)

    def byte_at(byte):
        return flat[row + byte.clamp(max=width - 1)].to(i32)  # JAX clamps the gather

    def peek16(bit_pos):
        byte = bit_pos >> 3
        sh = (bit_pos & 7).to(i32)
        w = (byte_at(byte) << 16) | (byte_at(byte + 1) << 8) | byte_at(byte + 2)
        return (w >> (8 - sh)) & 0xFFFF

    def read_bits(bit_pos, n):
        v = peek16(bit_pos)
        shifted = torch.where(n > 0, _sar(v, 16 - torch.clamp(n, min=1)), 0)
        return shifted & (_shl(torch.ones_like(n), torch.clamp(n, min=0)) - 1)

    def extend(v, t):
        one = torch.ones_like(t)
        vt = torch.where(t > 0, _shl(one, torch.clamp(t - 1, min=0)), 0)
        return torch.where(v < vt, v - _shl(one, torch.clamp(t, min=1)) + 1, v)

    def live_lanes(bit, block):
        live = torch.ones(n_lanes, dtype=torch.bool, device=dev)
        if end_bit is not None:
            live &= bit < end_bit
        if budget is not None:
            live &= block < budget
        return live

    bit, k, block = bit.to(torch.int64), k.to(torch.int64), block.to(torch.int64)
    preds = preds.to(i32).clone()
    live = live_lanes(bit, block)
    while bool(live.any()):
        comp = comp_of[block % bpm]
        is_dc = k == 0
        tbl = 2 * comp + torch.where(is_dc, 0, 1)

        # Huffman decode: the 8-bit lookahead, else the slow path's size
        # 9 + the leading run of code16 > maxcode[9..16], capped at 16.
        code16 = peek16(bit)
        entry = lookahead[tbl * 256 + (code16 >> 8)]
        fast_size, fast_val = entry >> 8, entry & 0xFF
        gt = (code16[:, None] > maxcode[tbl, 9:17]).to(i32)
        slow_size = torch.clamp(9 + torch.cumprod(gt, dim=1).sum(1, dtype=i32), max=16)
        idx = valoffset[tbl * 19 + slow_size] + (code16 >> (16 - slow_size))
        slow_val = values[tbl * 256 + (idx & 0xFF)]
        hit = fast_size > 0
        size = torch.where(hit, fast_size, slow_size)
        sym = torch.where(hit, fast_val, slow_val)
        bit1 = bit + size

        # DC: t = sym; diff = extend(read(t), t); pred += diff.
        dc_bits = read_bits(bit1, sym)
        diff = torch.where(sym > 0, extend(dc_bits, sym), 0)
        pred = preds[lane, comp] + diff
        bit_dc = bit1 + sym

        # AC: r = sym >> 4, s = sym & 15.
        r, s_ac = sym >> 4, sym & 15
        ac_val = extend(read_bits(bit1, s_ac), s_ac)
        bit_ac = bit1 + s_ac
        k_emit = torch.clamp(k + r, max=63)
        eob = (s_ac == 0) & (r == 0)
        zrl = (s_ac == 0) & (r != 0)
        k_next_ac = torch.where(eob, 64, torch.where(zrl, k + 16, k_emit + 1))

        if out is not None:
            # One add per lane into the zeroed output, as JAX's .at[].add.
            base = torch.clamp(block, max=max_blocks - 1) * 64
            pos = torch.where(is_dc, base, base + k_emit)
            val = torch.where(is_dc, pred, torch.where(s_ac > 0, ac_val, 0))
            emit = live & (is_dc | (s_ac > 0))
            out.index_add_(0, out_row + pos, torch.where(emit, val, 0))

        bit = torch.where(live, torch.where(is_dc, bit_dc, bit_ac), bit)
        new_k = torch.where(live, torch.where(is_dc, 1, k_next_ac), k)
        preds[lane, comp] = torch.where(live & is_dc, pred, preds[lane, comp])
        adv = new_k >= 64
        block = torch.where(live & adv, block + 1, block)
        k = torch.where(adv, 0, new_k)
        live = live_lanes(bit, block)
    return bit, k, block, preds


def decode_segments_plain(buf: torch.Tensor, comp_of: torch.Tensor,
                          mcu_counts: torch.Tensor, lookahead: torch.Tensor,
                          maxcode: torch.Tensor, valoffset: torch.Tensor,
                          values: torch.Tensor, max_blocks: int) -> torch.Tensor:
    """K3's plain version: the JAX ``while_loop`` over S lanes, one per
    segment, each from the row's start with predictors 0 until its block
    budget (:func:`walk_lanes`). uint8 [S, W] segments -> int32 [S,
    max_blocks * 64] coefficients, on ``buf``'s device. Each step is some
    60 small ops and a host sync, so this is a yardstick of correctness,
    not of speed."""
    dev = buf.device
    s_count = buf.shape[0]
    n_comps = lookahead.shape[0] // 2
    zeros = torch.zeros(s_count, dtype=torch.int64, device=dev)
    out = torch.zeros(s_count * max_blocks * 64, dtype=torch.int32, device=dev)
    walk_lanes(buf, torch.arange(s_count, device=dev), zeros, zeros, zeros,
               torch.zeros(s_count, max(n_comps, 1), dtype=torch.int32, device=dev),
               comp_of, lookahead, maxcode, valoffset, values,
               budget=mcu_counts.to(torch.int64) * comp_of.shape[0], out=out,
               max_blocks=max_blocks)
    return out.view(s_count, max_blocks * 64)


def subsequence_count(width: int, sub_bits: int) -> int:
    """The subsequences of ``sub_bits`` bits that cover a row of ``width``
    bytes: ceil(8 * width / sub_bits)."""
    return -(-8 * width // sub_bits)


def subsequence_offsets(n_blk: torch.Tensor, dsum: torch.Tensor):
    """The write pass's offsets: exclusive prefix sums along each row of
    the blocks each subsequence completes (int64 [S, n_sub] -> the block
    index at each subsequence's start) and of its DC differences (int32
    [S, n_sub, components] -> the predictors there, the low 32 bits, which
    wrap as the JAX loop's int32 adds do)."""
    block0 = torch.cumsum(n_blk, dim=1) - n_blk
    d = dsum.to(torch.int64)
    p = torch.cumsum(d, dim=1) - d
    pred0 = ((p + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    return block0, pred0.to(torch.int32)


def decode_segments_split_plain(buf: torch.Tensor, comp_of: torch.Tensor,
                                mcu_counts: torch.Tensor, lookahead: torch.Tensor,
                                maxcode: torch.Tensor, valoffset: torch.Tensor,
                                values: torch.Tensor, max_blocks: int, sub_bits: int):
    """The CPU model of K3's subsequence decoder, on :func:`walk_lanes`:
    the same output as :func:`decode_segments_plain`, and the number of
    sync rounds it took, ``(int32 [S, max_blocks * 64], rounds)``.

    Each row is cut into ``n_sub`` subsequences of ``sub_bits`` bits;
    subsequence j owns the symbols whose first bit lies in [j * sub_bits,
    (j + 1) * sub_bits), the last one everything after up to the row's
    block budget. A decoder state at a code boundary is (bit, k, m), m the
    block's index within its MCU.

    1. Sync rounds over every subsequence but the last of each row. Round
       0 decodes each from a guess, (j * sub_bits, 0, 0), the first from
       the exact (0, 0, 0); a later round re-decodes each whose start
       differs from the exit of the one before it in the previous round,
       from that exit. Each decode records its exit, the blocks it
       completed and the sum of its DC differences per component, and
       stores nothing. The rounds stop when no start changed. After
       round r subsequences 0..r start exactly, so the fixed point is the
       sequential walk's states, for any stream, corrupt ones too, in at
       most n_sub rounds. A start at or past its subsequence's end decodes
       nothing and exits where it starts.
    2. Offsets: :func:`subsequence_offsets`.
    3. Write pass: every subsequence from its exact start, block index and
       predictors, while its bit is in its range and its block below the
       row's budget, adds its emissions into the zeroed output."""
    dev = buf.device
    s_count, width = buf.shape
    n_comps = max(lookahead.shape[0] // 2, 1)
    bpm = comp_of.shape[0]
    n_sub = subsequence_count(width, sub_bits)
    tables = (comp_of, lookahead, maxcode, valoffset, values)
    rows = torch.arange(s_count, device=dev)[:, None].expand(s_count, n_sub)
    cols = torch.arange(n_sub, device=dev)[None, :].expand(s_count, n_sub)
    start = [cols * sub_bits, torch.zeros_like(cols), torch.zeros_like(cols)]  # bit, k, m
    exit_ = [t.clone() for t in start]
    n_blk = torch.zeros(s_count, n_sub, dtype=torch.int64, device=dev)
    dsum = torch.zeros(s_count, n_sub, n_comps, dtype=torch.int32, device=dev)

    def sync(mask):
        """Decode the subsequences of ``mask`` [S, n_sub] from their starts
        to their ends, recording exit, blocks and DC sums."""
        r, j = rows[mask], cols[mask]
        m0 = start[2][mask]
        bit, k, block, d = walk_lanes(
            buf, r, start[0][mask], start[1][mask], m0,
            torch.zeros(r.shape[0], n_comps, dtype=torch.int32, device=dev), *tables,
            end_bit=(j + 1) * sub_bits)
        exit_[0][mask], exit_[1][mask], exit_[2][mask] = bit, k, block % bpm
        n_blk[mask] = block - m0
        dsum[mask] = d

    rounds = 0
    if n_sub > 1:
        sync(cols < n_sub - 1)
        rounds = 1
        while True:
            if rounds >= n_sub:
                raise RuntimeError(f"the sync rounds did not settle in {n_sub} rounds")
            prev = [torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]], dim=1) for t in exit_]
            changed = (cols >= 1) & (cols < n_sub - 1)
            changed &= (prev[0] != start[0]) | (prev[1] != start[1]) | (prev[2] != start[2])
            rounds += 1
            if not bool(changed.any()):
                break
            for s, p in zip(start, prev):
                s[changed] = p[changed]
            sync(changed)
        for s, e in zip(start, exit_):  # the last subsequence starts where the one before exits
            s[:, -1] = e[:, -2]

    block0, pred0 = subsequence_offsets(n_blk, dsum)
    out = torch.zeros(s_count * max_blocks * 64, dtype=torch.int32, device=dev)
    end = torch.where(cols < n_sub - 1, (cols + 1) * sub_bits, torch.iinfo(torch.int64).max)
    walk_lanes(buf, rows.reshape(-1), start[0].reshape(-1), start[1].reshape(-1),
               block0.reshape(-1), pred0.reshape(-1, n_comps), *tables,
               end_bit=end.reshape(-1),
               budget=(mcu_counts.to(torch.int64) * bpm).repeat_interleave(n_sub),
               out=out, max_blocks=max_blocks)
    return out.view(s_count, max_blocks * 64), rounds


def decode_segments_device(buf, const, *, device) -> torch.Tensor:
    """Run the entropy decode on ``device``: dense int32 [n_segments,
    max_blocks * 64] zig-zag coefficients in segment-local MCU order, on
    ``device``. ``buf`` and the constants are :func:`prepare_scan`'s (numpy
    arrays or tensors); they are copied to ``device`` if they are not
    there. On a CUDA device this is one K3 call (its sync rounds and its
    write pass)."""
    device = torch.device(device)
    lookahead, maxcode, valoffset, values = const["tables"]
    max_blocks = int(np.asarray(const["mcu_counts"]).max()) * const["bpm"]

    def on_device(a):
        return torch.as_tensor(np.ascontiguousarray(a) if isinstance(a, np.ndarray) else a,
                               device=device)

    return kernels.huffman_scan(
        on_device(buf), on_device(const["comp_of"]), on_device(const["mcu_counts"]),
        on_device(lookahead), on_device(maxcode), on_device(valoffset), on_device(values),
        max_blocks=max_blocks,
    )


def scan_inputs(data: bytes) -> Tuple[np.ndarray, dict, FrameGeometry]:
    """The host half of :func:`decode_baseline_device`: the container walk
    up to the first SOS, then :func:`prepare_scan`; returns ``(buf,
    const, geometry)``. Baseline single-scan streams only."""
    from ..host.models.decoder import JpegDecoder
    from ..host.models.geometry import frame_geometry
    from ..host.syntax.markers import ALL_SOF_MARKERS, Marker

    dec = JpegDecoder()
    dec.set_input(data)
    stream = dec._parsed()
    frame = None
    scan_header = None
    for seg in stream.segments:
        if seg.marker in (Marker.DQT, Marker.DHT, Marker.DAC, Marker.DRI):
            dec._process_table_segment(seg, data)
        elif seg.marker in ALL_SOF_MARKERS:
            frame = FrameHeader.parse(seg.payload(data), seg.marker)
        elif seg.marker == Marker.SOS:
            scan_header = ScanHeader.parse(seg.payload(data))
            break
    if frame is None or scan_header is None:
        raise ValueError("the stream has no frame header or no scan")
    geo = frame_geometry(frame)
    buf, const = prepare_scan(
        data, stream.scans[0].spans, frame, scan_header,
        dec._dc_tables, dec._ac_tables, dec._restart_interval, geo,
    )
    return buf, const, geo


def decode_baseline_device(data: bytes, *, device) -> Tuple[torch.Tensor, FrameGeometry]:
    """Parse the container on the host, run the entropy decode on
    ``device``: returns (dense int32 [S, max_blocks * 64] coefficients on
    ``device``, geometry). Baseline single-scan streams only."""
    buf, const, geo = scan_inputs(data)
    return decode_segments_device(buf, const, device=device), geo


def segment_planes(coeffs: torch.Tensor, const, geometry: FrameGeometry) -> List[torch.Tensor]:
    """:func:`decode_segments_device`'s rows -> per-component zig-zag
    coefficient planes ``[Hb, Wb, 64]`` int32 on the rows' device: each
    segment's blocks in turn give the image's MCUs in order, which
    un-interleave as the wires' densify does. For an interleaved scan of
    the whole frame (or one component at 1x1)."""
    from .pipeline import _mcu_planes

    counts = torch.as_tensor(np.asarray(const["mcu_counts"]), device=coeffs.device)
    used = (counts.to(torch.int64) * (const["bpm"] * 64))[:, None]
    mask = torch.arange(coeffs.shape[1], device=coeffs.device)[None, :] < used
    return [p[0] for p in _mcu_planes(coeffs[mask][None], geometry)]


def segment_rows(planes, geometry: FrameGeometry, ri: int) -> np.ndarray:
    """The inverse of :func:`segment_planes`, on the host: coefficient
    planes (one ``[Hb, Wb, 64]`` per component of ``geometry``, in its
    order) laid out as :func:`decode_segments_device`'s rows, int32
    ``[segments, ri * blocks per MCU * 64]``: each segment's MCUs in order
    from its row's start, zeros after the tail segment's. ``ri`` is the
    restart interval in MCUs, 0 for none."""
    mr, mc = geometry.mcus_per_column, geometry.mcus_per_line
    per_mcu = np.concatenate([
        np.asarray(p, np.int32).reshape(mr, c.v, mc, c.h, 64).transpose(0, 2, 1, 3, 4)
        .reshape(mr * mc, -1) for p, c in zip(planes, geometry.components)], axis=1)
    total = mr * mc
    ri = min(ri, total) if ri > 0 else total
    rows = np.zeros((-(-total // ri) * ri, per_mcu.shape[1]), np.int32)
    rows[:total] = per_mcu
    return rows.reshape(-1, ri * per_mcu.shape[1])

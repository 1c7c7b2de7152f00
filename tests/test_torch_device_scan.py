"""PyTorch port, K3 (the device entropy decode of ops/device_scan.py): the
host prepass and the plain version of the decode loop against the JAX
package's on the CPU, bit for bit, on the cases of
tests/test_device_scan.py and a tail segment; the CPU model of K3's
subsequence decoder (``decode_segments_split_plain``) against both, on
those cases and on corrupt streams, at subsequence lengths of 64, 512 and
1,024 bits; the segments through the dense transform against the port's
own decode; the wrapper's dispatch and guards. Everything is integer
arithmetic: no tolerance anywhere."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jpeglibrary_tpu as jt
from jpeglibrary_tpu.ops import device_scan as ref_scan

import jpeglibrary_tpu_torch as jtt
from jpeglibrary_tpu_torch.ops import _build, device_scan, kernels

from torch_reference_native import settle

settle()  # the JAX package's native scanner, built once before any test


def _rgb(seed, h=64, w=96):
    rng = np.random.default_rng(seed)
    return np.clip(np.linspace(0, 255, w)[None, :, None] + rng.normal(0, 30, (h, w, 3)),
                   0, 255).astype(np.uint8)


def _stream(case):
    """The JPEG of one case, written by the JAX package's encoder."""
    if case == "gray noise ri4":
        g = np.random.default_rng(51).integers(0, 256, (48, 80), dtype=np.uint8)
        return jt.encode_gray(g, 85, restart_interval=4), 4
    if case == "420 ri5 tail":  # 24 MCUs: 4 segments of 5 and a tail of 4
        return jt.encode_rgb(_rgb(52, 64, 96), 75, subsampling="420", restart_interval=5), 5
    sub, q, ri = case.split()
    ri = int(ri[2:])
    return jt.encode_rgb(_rgb(51), int(q[1:]), subsampling=sub, restart_interval=ri), ri


CASES = ["420 q75 ri2", "444 q90 ri3", "422 q80 ri0", "gray noise ri4", "420 ri5 tail"]


@pytest.fixture(scope="module", params=CASES)
def case(request):
    data, ri = _stream(request.param)
    want, geo = ref_scan.decode_baseline_device(data)
    return request.param, data, ri, np.asarray(want), geo


def test_plain_decode_equals_jax_decode(case):
    name, data, _, want, _ = case
    before = kernels.huffman_scan.launches
    got, geo = device_scan.decode_baseline_device(data, device="cpu")
    assert kernels.huffman_scan.launches == before
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert got.shape == want.shape, name
    np.testing.assert_array_equal(got.numpy(), want)
    ref_geo = case[4]
    assert (geo.width, geo.height, geo.mcus_per_line, geo.mcus_per_column) == (
        ref_geo.width, ref_geo.height, ref_geo.mcus_per_line, ref_geo.mcus_per_column)


def test_plain_decode_equals_host_scanner(case):
    name, data, ri, _, _ = case
    got, geo = device_scan.decode_baseline_device(data, device="cpu")
    ref = jtt.decode(data)
    want = device_scan.segment_rows([ref.coefficients[c.component_index]
                                     for c in geo.components], geo, ri)
    np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_prepare_scan_equals_jax(case):
    name, data, _, _, _ = case
    buf, const, geo = device_scan.scan_inputs(data)
    # The JAX package's own prepass, on its own parse of the stream.
    from jpeglibrary_tpu.io import reader as ref_reader
    from jpeglibrary_tpu.models.decoder import JpegDecoder
    from jpeglibrary_tpu.models.geometry import frame_geometry
    from jpeglibrary_tpu.syntax.frame import FrameHeader, ScanHeader
    from jpeglibrary_tpu.syntax.markers import ALL_SOF_MARKERS, Marker

    dec = JpegDecoder()
    dec.set_input(data)
    stream = dec._parsed()
    for seg in stream.segments:
        if seg.marker in (Marker.DQT, Marker.DHT, Marker.DAC, Marker.DRI):
            dec._process_table_segment(seg, data)
        elif seg.marker in ALL_SOF_MARKERS:
            frame = FrameHeader.parse(seg.payload(data), seg.marker)
        elif seg.marker == Marker.SOS:
            scan_header = ScanHeader.parse(seg.payload(data))
            break
    assert isinstance(stream, ref_reader.JpegStream)
    want_buf, want = ref_scan.prepare_scan(
        data, stream.scans[0].spans, frame, scan_header, dec._dc_tables, dec._ac_tables,
        dec._restart_interval, frame_geometry(frame))
    assert buf.dtype == want_buf.dtype == np.uint8
    np.testing.assert_array_equal(buf, want_buf)
    assert set(const) == set(want)
    assert (const["bpm"], const["n_comps"]) == (want["bpm"], want["n_comps"])
    for key in ("comp_of", "mcu_counts"):
        assert const[key].dtype == want[key].dtype
        np.testing.assert_array_equal(const[key], want[key], err_msg=key)
    for ours, theirs in zip(const["tables"], want["tables"]):
        assert ours.dtype == theirs.dtype == np.int32
        np.testing.assert_array_equal(ours, theirs)
    ref_geo = frame_geometry(frame)
    assert (geo.mcus_per_line, geo.mcus_per_column) == (ref_geo.mcus_per_line,
                                                        ref_geo.mcus_per_column)


def test_tail_segment_is_short():
    data, ri = _stream("420 ri5 tail")
    _, const, geo = device_scan.scan_inputs(data)
    assert geo.mcus_per_line * geo.mcus_per_column == 24
    assert const["mcu_counts"].tolist() == [5, 5, 5, 5, 4]


@pytest.mark.parametrize("name", ["420 q75 ri2", "422 q80 ri0", "420 ri5 tail"])
def test_segments_through_dense_transform_equal_decode(name):
    """K3's rows -> component planes -> the port's dense transform (K1's
    plain version here) give the port's own device decode of the stream,
    bit for bit."""
    data, _ = _stream(name)
    coeffs, geo = device_scan.decode_baseline_device(data, device="cpu")
    _, const, _ = device_scan.scan_inputs(data)
    planes = device_scan.segment_planes(coeffs, const, geo)
    res = jtt.decode(data, sparse_direct=True)
    from jpeglibrary_tpu_torch.models.decoder import quant_tables

    got = jtt.transform_dense(planes, quant_tables(res), geo, "cpu")
    want = jtt.to_rgb8_device(res, device="cpu")
    assert got.shape == want.shape == (3, geo.height, geo.width)
    assert torch.equal(got, want)
    for c, plane in zip(geo.components, planes):
        np.testing.assert_array_equal(plane.numpy(),
                                      jtt.decode(data).coefficients[c.component_index])


def test_corrupt_stream_equals_jax():
    """Bytes changed in the entropy-coded data send the loop down codes the
    tables do not hold and out of step with the segments: the plain
    version still gives the JAX loop's numbers."""
    data, _ = _stream("420 q75 ri2")
    buf, const, _ = device_scan.scan_inputs(data)
    rng = np.random.default_rng(7)
    bad = buf.copy()
    flips = rng.integers(0, bad.size, 40)
    bad.reshape(-1)[flips] ^= rng.integers(1, 256, 40).astype(np.uint8)
    want = np.asarray(ref_scan.decode_segments_device(bad, const))
    got = device_scan.decode_segments_device(bad, const, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, np.asarray(ref_scan.decode_segments_device(buf, const)))


SUB_BITS = [64, 512, 1024]  # at 64 a subsequence is often skipped whole and many rounds run


def _split_equals(buf, const, want, sub_bits, what):
    """The CPU model on prepare_scan's output equals ``want`` (the JAX
    loop's) and the plain version, in at most n_sub rounds; returns the
    rounds."""
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (buf, const["comp_of"], const["mcu_counts"], *const["tables"])]
    max_blocks = int(const["mcu_counts"].max()) * const["bpm"]
    got, rounds = device_scan.decode_segments_split_plain(*args, max_blocks, sub_bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want, err_msg=what)
    assert torch.equal(got, device_scan.decode_segments_plain(*args, max_blocks)), what
    n_sub = device_scan.subsequence_count(buf.shape[1], sub_bits)
    assert rounds <= n_sub, (what, rounds, n_sub)
    return rounds, n_sub


@pytest.mark.parametrize("sub_bits", SUB_BITS)
def test_split_model_equals_plain_and_jax(case, sub_bits):
    """Every case, the tail segment's among them: the subsequence decoder's
    output is the JAX loop's, bit for bit; where a segment is longer than
    a subsequence the rounds are at least 2 (round 0 and the round that
    finds no start changed)."""
    name, data, _, want, _ = case
    buf, const, _ = device_scan.scan_inputs(data)
    rounds, n_sub = _split_equals(buf, const, want, sub_bits, name)
    if sub_bits < 8 * (buf.shape[1] - 8):
        assert rounds >= 2, (name, rounds)
    else:
        assert n_sub == 1 and rounds == 0


@pytest.mark.parametrize("sub_bits", SUB_BITS)
def test_split_model_on_corrupt_stream(sub_bits):
    """test_corrupt_stream_equals_jax's stream: the subsequences of the
    corrupt rows sync to the walk the JAX loop takes."""
    data, _ = _stream("420 q75 ri2")
    buf, const, _ = device_scan.scan_inputs(data)
    rng = np.random.default_rng(7)
    bad = buf.copy()
    flips = rng.integers(0, bad.size, 40)
    bad.reshape(-1)[flips] ^= rng.integers(1, 256, 40).astype(np.uint8)
    want = np.asarray(ref_scan.decode_segments_device(bad, const))
    _split_equals(bad, const, want, sub_bits, "corrupt ri2")


def _past_the_end_stream():
    """A corrupt stream without restart markers (64x96, 4:2:2): the row cut
    to half its bytes and bytes changed in what is left, so the walk runs
    past the row's width, where every read takes the row's last byte."""
    data, _ = _stream("422 q80 ri0")
    buf, const, _ = device_scan.scan_inputs(data)
    bad = np.ascontiguousarray(buf[:, : buf.shape[1] // 2])
    rng = np.random.default_rng(13)
    flips = rng.integers(0, bad.size, 12)
    bad.reshape(-1)[flips] ^= rng.integers(1, 256, 12).astype(np.uint8)
    return bad, const


def test_past_the_end_stream_walks_past_the_row():
    bad, const = _past_the_end_stream()
    args = [torch.from_numpy(a) for a in (bad, const["comp_of"], const["mcu_counts"],
                                           *const["tables"])]
    zero = torch.zeros(1, dtype=torch.int64)
    preds = torch.zeros(1, const["n_comps"], dtype=torch.int32)
    bit, _, block, _ = device_scan.walk_lanes(
        args[0], zero, zero, zero, zero, preds, args[1], *args[3:],
        budget=args[2].to(torch.int64) * const["bpm"])
    assert int(block) == int(const["mcu_counts"][0]) * const["bpm"]
    assert int(bit) > 8 * bad.shape[1]


@pytest.mark.parametrize("sub_bits", SUB_BITS)
def test_split_model_on_stream_past_the_row(sub_bits):
    bad, const = _past_the_end_stream()
    want = np.asarray(ref_scan.decode_segments_device(bad, const))
    _split_equals(bad, const, want, sub_bits, "past the row's end")


def test_subsequence_offsets_wrap_as_int32():
    """The block offsets are exclusive prefix sums; the predictors' the low
    32 bits of theirs, as the JAX loop's int32 adds wrap."""
    n_blk = torch.tensor([[3, 0, 5, 7]], dtype=torch.int64)
    big = 2**31 - 5
    dsum = torch.tensor([[[big, -1], [big, 2], [10, -big], [1, 1]]], dtype=torch.int32)
    block0, pred0 = device_scan.subsequence_offsets(n_blk, dsum)
    assert block0.tolist() == [[0, 3, 3, 8]]
    want = np.cumsum(np.r_[[[0, 0]], dsum[0, :-1].numpy()], axis=0, dtype=np.int64)
    want = ((want + 2**31) % 2**32 - 2**31).astype(np.int32)
    assert pred0.dtype == torch.int32 and pred0[0].tolist() == want.tolist()


def test_subsequence_count():
    assert [device_scan.subsequence_count(w, 1024) for w in (1, 128, 129, 256)] == [1, 1, 2, 2]


def _wrapper_inputs(data=None):
    data = data or _stream("420 q75 ri2")[0]
    buf, const, _ = device_scan.scan_inputs(data)
    args = [torch.from_numpy(a) for a in (buf, const["comp_of"], const["mcu_counts"],
                                           *const["tables"])]
    return args, int(const["mcu_counts"].max()) * const["bpm"]


def test_wrapper_on_cpu_takes_plain_version():
    args, max_blocks = _wrapper_inputs()
    before = kernels.huffman_scan.launches
    got = kernels.huffman_scan(*args, max_blocks=max_blocks)
    assert kernels.huffman_scan.launches == before
    want = device_scan.decode_segments_plain(*args, max_blocks)
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("what", ["buf dtype", "buf rank", "table dtype", "table width",
                                  "odd tables", "comp_of", "mcu_counts", "max_blocks",
                                  "device", "meta", "sub_bits"])
def test_wrapper_rejects_bad_inputs(what):
    args, max_blocks = _wrapper_inputs()
    kwargs = {}
    if what == "buf dtype":
        args[0] = args[0].to(torch.int32)
    elif what == "buf rank":
        args[0] = args[0].reshape(-1)
    elif what == "table dtype":
        args[3] = args[3].to(torch.int64)
    elif what == "table width":
        args[4] = args[4][:, :17]
    elif what == "odd tables":
        args[3:7] = [t[:1] for t in args[3:7]]
    elif what == "comp_of":
        args[1] = torch.zeros(11, dtype=torch.int32)
    elif what == "mcu_counts":
        args[2] = args[2][:-1]
    elif what == "max_blocks":
        max_blocks = 0
    elif what == "device":
        args[1] = args[1].to("meta")
    elif what == "sub_bits":
        kwargs["sub_bits"] = 4
    else:
        args = [a.to("meta") for a in args]
    with pytest.raises(ValueError):
        kernels.huffman_scan(*args, max_blocks=max_blocks, **kwargs)


def test_kernel_source_is_built_and_bound():
    """csrc/huffman_scan.cu is one of the library's sources and defines the
    entry points the loader binds (the sync rounds and the write pass),
    each with as many parameters as its ctypes signature; its kernels are
    the sync and write kernels alone (no one-thread-per-segment kernel
    beside them)."""
    sources = sorted(p.name for p in _build._CSRC.glob("*.cu"))
    assert sources == ["butterfly_idct.cu", "color_round_trip.cu", "dequant_idct.cu",
                       "fdct_quant.cu", "huffman_scan.cu", "progressive_hist.cu",
                       "symbol_hist.cu"]
    text = (_build._CSRC / "huffman_scan.cu").read_text()
    for name in ("jpx_huffman_sync", "jpx_huffman_write"):
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
        assert m and m.group(1).count(",") + 1 == len(_build._ENTRY_POINTS[name]), name
    assert "jpx_huffman_scan" not in _build._ENTRY_POINTS
    assert re.findall(r"__global__ void __launch_bounds__\(kThreads\) (\w+)\(", text) == [
        "sync_kernel", "write_kernel"]

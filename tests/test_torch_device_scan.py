"""PyTorch port, K3 (the device entropy decode of ops/device_scan.py): the
host prepass and the plain version of the decode loop against the JAX
package's on the CPU, bit for bit, on the cases of
tests/test_device_scan.py and a tail segment; the segments through the
dense transform against the port's own decode; the wrapper's dispatch and
guards. Everything is integer arithmetic: no tolerance anywhere."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jpeglibrary_tpu as jt
from jpeglibrary_tpu.ops import device_scan as ref_scan

import jpeglibrary_tpu_torch as jtt
from jpeglibrary_tpu_torch.ops import _build, device_scan, kernels


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
                                  "device", "meta"])
def test_wrapper_rejects_bad_inputs(what):
    args, max_blocks = _wrapper_inputs()
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
    else:
        args = [a.to("meta") for a in args]
    with pytest.raises(ValueError):
        kernels.huffman_scan(*args, max_blocks=max_blocks)


def test_kernel_source_is_built_and_bound():
    """csrc/huffman_scan.cu is one of the library's sources and defines the
    entry point the loader binds, with as many parameters as its ctypes
    signature."""
    sources = sorted(p.name for p in _build._CSRC.glob("*.cu"))
    assert sources == ["butterfly_idct.cu", "dequant_idct.cu", "fdct_quant.cu",
                       "huffman_scan.cu"]
    text = (_build._CSRC / "huffman_scan.cu").read_text()
    m = re.search(r'extern "C" int jpx_huffman_scan\(([^)]*)\)', text)
    assert m and m.group(1).count(",") + 1 == len(_build._ENTRY_POINTS["jpx_huffman_scan"])

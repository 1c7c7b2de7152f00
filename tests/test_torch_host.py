"""PyTorch port, its own copy of the host layers (``jpeglibrary_tpu_torch/host``)
held to the JAX package's: the same streams give the same decode results
(coefficients, quant tables, wire payloads, the ``prepack`` payload, the
host RGB), the same errors, and the host encoder the same bytes. Exact
equality throughout: the copies run the same numpy and native code."""

import dataclasses
import os
import pathlib

import numpy as np
import pytest

pytest.importorskip("torch")

import jpeglibrary_tpu as jt
import jpeglibrary_tpu_torch as jtt
from jpeglibrary_tpu.models.progressive_encoder import encode_progressive_rgb
from jpeglibrary_tpu.native import build as ref_build
from jpeglibrary_tpu.native import scanner as ref_scanner
from jpeglibrary_tpu.ops import decode_stage as ref_decode_stage
from jpeglibrary_tpu.ops import encode_stage as ref_encode_stage
from jpeglibrary_tpu.ops import pallas_kernels
from jpeglibrary_tpu_torch.host.models import encoder as host_encoder
from jpeglibrary_tpu_torch.host.native import build as host_build
from jpeglibrary_tpu_torch.host.ops import decode_stage as host_decode_stage
from jpeglibrary_tpu_torch.host.ops import encode_stage as host_encode_stage

from torch_reference_native import settle

settle()  # the JAX package's native scanner, built once before any test

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF = ROOT / "jpeglibrary_tpu"
HOST = ROOT / "jpeglibrary_tpu_torch" / "host"


@pytest.fixture(scope="module", autouse=True)
def _reference_scanner():
    """The reference's native scanner, built and loaded before these tests
    (``torch_reference_native.settle``, which this module also calls while
    it is imported); here its absence fails the tests that need it."""
    settle()
    ref_build.load_library()


def _image(h, w, seed, sigma=20.0):
    rng = np.random.default_rng(seed)
    base = np.linspace(0, 255, w)[None, :, None] + np.linspace(0, 80, h)[:, None, None]
    return np.clip(base + rng.normal(0, sigma, (h, w, 3)), 0, 255).astype(np.uint8)


def _checkered(h, w, seed):
    """A checkerboard over a noisy gradient: at q95 its AC coefficients
    pass 127, which the v2 wire carries as exception entries."""
    img = _image(h, w, seed)
    img[::2, ::2] = 255
    img[1::2, 1::2] = 0
    return img


def _gray12(h, w, seed):
    rng = np.random.default_rng(seed)
    base = np.linspace(0, 4095, w)[None, :] + rng.normal(0, 200, (h, w))
    return np.clip(base, 0, 4095).astype(np.uint16)


# (stream maker, JPX_WIRE value for the scan or None)
CASES = {
    "baseline_420": (lambda: jt.encode_rgb(_image(64, 96, 1), 75, subsampling="420"), None),
    "baseline_422": (lambda: jt.encode_rgb(_image(64, 96, 2), 75, subsampling="422"), None),
    "baseline_444": (lambda: jt.encode_rgb(_image(64, 96, 3), 75, subsampling="444"), None),
    "gray": (lambda: jt.encode_gray(_image(64, 96, 4)[..., 0], 80), None),
    "restart7_211x333": (
        lambda: jt.encode_rgb(_image(211, 333, 5), 75, restart_interval=7), None),
    # q95 leaves |AC| > 127: the v2 wire's exception entries
    "q95_444": (lambda: jt.encode_rgb(_checkered(64, 96, 6), 95, subsampling="444"), None),
    "v1_wire_420": (lambda: jt.encode_rgb(_image(64, 96, 7), 80), "1"),
    "progressive": (lambda: encode_progressive_rgb(_image(64, 96, 8), 85), None),
    "arithmetic": (lambda: jt.encode_rgb(_image(64, 96, 9), 80, arithmetic=True), None),
    "lossless": (lambda: jt.encode_lossless(_image(40, 56, 10)), None),
    "arithmetic_lossless": (
        lambda: jt.encode_lossless_arithmetic(_image(40, 56, 11)[..., 0]), None),
    "gray12": (lambda: jt.encode_gray(_gray12(48, 72, 12), 85, precision=12), None),
    "hierarchical": (lambda: jt.encode_hierarchical([_image(48, 64, 13)[..., 0]]), None),
    "cmyk": (lambda: jt.encode_cmyk(np.concatenate(
        [_image(32, 48, 14), _image(32, 48, 15)[..., :1]], -1), 80), None),
}


def _scan(decode, data, wire):
    if wire is None:
        return decode(data, sparse_direct=True)
    saved = os.environ.get("JPX_WIRE")
    os.environ["JPX_WIRE"] = wire
    try:
        return decode(data, sparse_direct=True)
    finally:
        if saved is None:
            del os.environ["JPX_WIRE"]
        else:
            os.environ["JPX_WIRE"] = saved


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    make, wire = CASES[request.param]
    data = make()
    return request.param, _scan(jtt.decode, data, wire), _scan(jt.decode, data, wire)


def _assert_arrays_equal(ours, ref):
    if ref is None:
        assert ours is None
        return
    assert isinstance(ours, np.ndarray) and ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)


def _assert_planes_equal(ours, ref):
    if ref is None:
        assert ours is None
        return
    assert sorted(ours) == sorted(ref)
    for k in ref:
        _assert_arrays_equal(ours[k], ref[k])


def test_host_decode_is_the_ports_own(case):
    _name, ours, ref = case
    assert type(ours).__module__ == "jpeglibrary_tpu_torch.host.models.decoder"
    assert type(ours).__name__ == type(ref).__name__ == "DecodeResult"
    assert repr(ours.frame) == repr(ref.frame)
    assert dataclasses.astuple(ours.geometry) == dataclasses.astuple(ref.geometry)
    assert ours.color_transform == ref.color_transform
    assert ours.errors == ref.errors


def test_host_decode_coefficients_and_quant(case):
    _name, ours, ref = case
    _assert_planes_equal(ours.coefficients, ref.coefficients)
    _assert_planes_equal(ours.quant, ref.quant)
    _assert_planes_equal(ours.samples, ref.samples)


def test_host_decode_wire_payloads(case):
    name, ours, ref = case
    _assert_arrays_equal(ours.packed_mcu2, ref.packed_mcu2)
    _assert_arrays_equal(ours.packed_mcu, ref.packed_mcu)
    if name.startswith("baseline") or name in ("gray", "restart7_211x333", "q95_444"):
        assert ours.packed_mcu2 is not None
    if name == "v1_wire_420":
        assert ours.packed_mcu is not None and ours.packed_mcu2 is None
    if name == "q95_444":
        geo = ours.geometry
        nb = geo.mcus_per_line * geo.mcus_per_column * sum(c.h * c.v for c in geo.components)
        bn = ref_scanner.v2_payload_bn(ours.packed_mcu2, nb)
        exc = ours.packed_mcu2[3 * nb + 2 * bn:].view(np.int32).reshape(-1, 2)
        assert (exc[:, 1] != 0).any()


def test_host_decode_prepack_payload(case):
    name, ours, ref = case
    ours.prepack()
    ref.prepack()
    _assert_arrays_equal(getattr(ours, "_packed", None), getattr(ref, "_packed", None))
    if name in ("progressive", "arithmetic"):
        assert getattr(ours, "_packed", None) is not None


def test_host_decode_rgb(case):
    name, ours, ref = case
    if name == "cmyk":
        _assert_arrays_equal(ours.to_cmyk8(), ref.to_cmyk8())
    else:
        _assert_arrays_equal(ours.to_rgb8(), ref.to_rgb8())
    _assert_arrays_equal(ours.to_uint16_extended(), ref.to_uint16_extended())


def _truncated():
    data = jt.encode_rgb(_image(32, 48, 20), 75)
    return data[: len(data) // 2]


def _bad_marker():
    data = bytearray(jt.encode_rgb(_image(32, 48, 21), 75))
    sos = bytes(data).index(b"\xff\xda")
    data[sos + 40] = 0xFF  # a marker byte inside the entropy-coded segment
    data[sos + 41] = 0xC8
    return bytes(data)


BROKEN = {
    "empty": lambda: b"",
    "garbage": lambda: b"not a jpeg at all",
    "soi_only": lambda: b"\xff\xd8",
    "truncated": _truncated,
    "bad_marker": _bad_marker,
}


@pytest.mark.parametrize("kind", sorted(BROKEN))
def test_host_decode_raises_where_reference_raises(kind):
    data = BROKEN[kind]()
    outcomes = []
    for decode in (jt.decode, jtt.decode):
        try:
            res = decode(data, sparse_direct=True)
            outcomes.append(("ok", res.to_rgb8().tobytes()))
        except Exception as exc:  # the reference's exception, whatever it is
            outcomes.append((type(exc).__name__, str(exc)))
    assert outcomes[0] == outcomes[1]


ENCODE_CASES = {
    "q75_420": {},
    "optimize": {"optimize_coding": True},
    "restart5": {"restart_interval": 5},
    "444_most_optimal": {"subsampling": "444", "most_optimal_coding": True},
    "arithmetic": {"arithmetic": True},
}


@pytest.mark.parametrize("name", sorted(ENCODE_CASES))
def test_host_encode_rgb_bytes_equal(name):
    rgb = _image(77, 133, 30 + len(name))
    kwargs = ENCODE_CASES[name]
    assert host_encoder.encode_rgb(rgb, 75, **kwargs) == jt.encode_rgb(rgb, 75, **kwargs)


@pytest.mark.parametrize("precision", [8, 12])
def test_host_encode_gray_bytes_equal(precision):
    plane = _gray12(45, 70, 40) if precision == 12 else _image(45, 70, 40)[..., 0]
    assert (host_encoder.encode_gray(plane, 80, precision=precision)
            == jt.encode_gray(plane, 80, precision=precision))


def test_host_encoder_raises_for_jax_branches():
    import jax.numpy as jnp

    enc = host_encoder._configure_rgb_encoder(75, "420")
    enc.set_input_rgb(_image(16, 16, 41))
    with pytest.raises(TypeError, match="numpy"):  # xp takes numpy or torch, never jnp
        enc.encode(xp=jnp)
    enc.mesh = object()
    with pytest.raises(jtt.JpegEncodeError, match="mesh"):
        enc.encode()


@pytest.mark.parametrize("n", [8, 4, 2, 1])
def test_folded_idct_matrix_bit_equal(n):
    if n == 8:
        ours, ref = host_decode_stage.fused_transform_matrix(), pallas_kernels.fused_transform_matrix()
    else:
        ours, ref = host_decode_stage.scaled_folded_matrix(n), ref_decode_stage.scaled_folded_matrix(n)
    assert ours.dtype == ref.dtype == np.float32
    assert ours.tobytes() == ref.tobytes()


def test_folded_fdct_matrix_bit_equal():
    ours, ref = host_encode_stage.fdct_zigzag_matrix(), ref_encode_stage.fdct_zigzag_matrix()
    assert ours.dtype == ref.dtype == np.float32
    assert ours.tobytes() == ref.tobytes()


# Copied unchanged but for their imports, the upstream project's path in
# comments, two comments' wording and the device edits below; the other
# copies have the cuts the host package notes.
VERBATIM = [
    "io/bitreader.py", "io/reader.py", "io/writer.py", "models/arithmetic.py",
    "models/arithmetic_lossless.py", "models/geometry.py", "models/hierarchical.py",
    "models/huffman_baseline.py", "models/huffman_builder.py",
    "models/huffman_progressive.py", "models/lossless.py", "models/optimizer.py",
    "models/progressive_encoder.py", "models/region.py", "models/transcode.py",
    "native/scanner.cpp", "native/scanner.py", "ops/color.py", "ops/dct.py", "ops/zigzag.py",
    "syntax/frame.py", "syntax/huffman.py", "syntax/huffman_standard.py",
    "syntax/markers.py", "syntax/quantization.py", "utils/fixtures.py", "utils/metrics.py",
    "utils/pool.py",
]
SUBSTITUTIONS = [
    ("jpeglibrary_tpu.", "jpeglibrary_tpu_torch.host."),
    ("jpeglibrary_tpu/", "jpeglibrary_tpu_torch/host/"),
    ("/root/reference/", "yigolden/JpegLibrary/"),
    ("/root/reference)", "yigolden/JpegLibrary)"),
    ("// Shared driver for", "// Shared loop for"),
    ("a pull-reader driver can", "a pull-reader caller can"),
]


# The device count of the progressive transcode (``device=``, K7 through
# ``host/models/progressive_count.py``), each edit once in its copy.
DEVICE_EDITS = {
    "models/progressive_encoder.py": [
        ("    differential: bool = False,\n) -> bytes:",
         "    differential: bool = False,\n    device=None,\n) -> bytes:"),
        ("    the framework's progressive scanners decode them in parallel.\n    \"\"\"",
         "    the framework's progressive scanners decode them in parallel.\n\n"
         "    ``device`` (a ``torch.device``; Huffman coding, no restart intervals)\n"
         "    runs pass 1, the symbol count, on that device: the per-image rows of\n"
         "    ``parallel.sharding.progressive_step`` (K7 on the card), summed per\n"
         "    table class; the tables and the bytes are the host count's.\n    \"\"\""),
        ("        count_jobs = list(script)\n",
         "        count_jobs = list(script) if device is None else []\n"),
        ("                ac_freqs[tid] += local_ac[tid]\n",
         "                ac_freqs[tid] += local_ac[tid]\n"
         "        if device is not None:\n"
         "            if restart_interval > 0:\n"
         "                raise ValueError(\"the device count takes no restart intervals\")\n"
         "            from .progressive_count import progressive_frequencies\n\n"
         "            progressive_frequencies(coeffs, (h, w), sampling, script, table_ids,\n"
         "                                    dc_freqs, ac_freqs, device=device)\n"),
    ],
    "models/transcode.py": [
        ("    grayscale: bool = False,\n) -> bytes:\n    \"\"\"Re-encode",
         "    grayscale: bool = False,\n    device=None,\n) -> bytes:\n    \"\"\"Re-encode"),
        ("    (RGB / CMYK / YCCK), so dropping it would alter decoded colors.\n    \"\"\"\n",
         "    (RGB / CMYK / YCCK), so dropping it would alter decoded colors.\n\n"
         "    ``device`` (a ``torch.device``, mode \"progressive\" alone) counts the\n"
         "    progressive script's symbols there (``encode_progressive``'s\n"
         "    ``device``); the output is the same bytes.\n    \"\"\"\n"
         "    if device is not None and mode != \"progressive\":\n"
         "        raise ValueError(f\"mode {mode!r} has no device count; device= is for "
         "'progressive'\")\n"),
        ("        grayscale=grayscale,\n    )\n    if grayscale:",
         "        grayscale=grayscale, device=device,\n    )\n    if grayscale:"),
        ("    grayscale: bool = False,\n) -> bytes:\n    dec = JpegDecoder()",
         "    grayscale: bool = False,\n    device=None,\n) -> bytes:\n    dec = JpegDecoder()"),
        ("        precision=frame.sample_precision,\n    )\n\n\ndef _emit_dct",
         "        precision=frame.sample_precision,\n        device=device,\n    )\n\n\ndef _emit_dct"),
        ("restart_interval, size, precision):", "restart_interval, size, precision, device=None):"),
        ("            precision=precision,\n        )\n\n    from .encoder",
         "            precision=precision,\n            device=device,\n        )\n\n    from .encoder"),
    ],
}


@pytest.mark.parametrize("rel", VERBATIM)
def test_copy_matches_reference_source(rel):
    want = (REF / rel).read_text()
    for a, b in SUBSTITUTIONS:
        want = want.replace(a, b)
    for a, b in DEVICE_EDITS.get(rel, []):
        assert want.count(a) == 1, (rel, a)
        want = want.replace(a, b)
    assert (HOST / rel).read_text() == want


def _functions(text):
    """The top-level functions of a module's source, by name."""
    import ast

    tree = ast.parse(text)
    lines = text.splitlines()
    return {node.name: "\n".join(lines[node.lineno - 1:node.end_lineno])
            for node in tree.body if isinstance(node, ast.FunctionDef)}


def test_streaming_host_half_matches_reference_source():
    """``host/models/streaming.py`` is the JAX package's module without
    its three device functions: every other function is text-equal."""
    want = (REF / "models/streaming.py").read_text()
    for a, b in SUBSTITUTIONS:
        want = want.replace(a, b)
    ours, ref = _functions((HOST / "models/streaming.py").read_text()), _functions(want)
    device_half = {"decode_rgb_stripes", "_stripes_from_payload2", "decode_rgb_streaming"}
    assert sorted(ours) == sorted(set(ref) - device_half)
    for name, text in ours.items():
        assert text == ref[name], name


def test_both_native_scanners_load_side_by_side():
    ours, ref = host_build.load_library(), ref_build.load_library()
    assert ours is not ref
    assert pathlib.Path(host_build.build_library()).name.startswith("libjpxscan-")
    data = jt.encode_rgb(_image(32, 48, 50), 75)
    _assert_planes_equal(jtt.decode(data).coefficients, jt.decode(data).coefficients)

"""PyTorch port, the bit-exact device decode on the CPU: ``JpegDecoder.decode(xp=...)``
with a torch device (the JAX package's ``xp=jnp``), its region and
hierarchical forms, K4's plain version (``kernels.butterfly_idct_shift``),
the butterfly DCTs of ``ops/dct.py``, the butterfly FDCT route and the packed
wire (``transform_packed``), each held against the JAX package.

Tolerances: the planes, the regions, the butterfly DCTs, K4's plain version
and the FDCT route are exact (0 values differ, every float bit equal): the
float32 AAN butterfly is IEEE add and multiply in one fixed order in numpy,
XLA and PyTorch alike. ``transform_packed`` runs K1, so it is held to the
JAX ``jitted_transform_packed`` within the tolerance of the other wires
(``tests/test_torch_wires.py``): at most 2 RGB levels on at most 1e-4 of the
values (the u16 output compared as samples, ``>> 8``, within 1).
"""

import inspect
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import jpeglibrary_tpu as jt
import jpeglibrary_tpu_torch as jtt
from jpeglibrary_tpu.models.progressive_encoder import encode_progressive_rgb
from jpeglibrary_tpu.ops import dct as ref_dct
from jpeglibrary_tpu.ops import decode_stage as ref_stage
from jpeglibrary_tpu.ops import encode_stage as ref_encode
from jpeglibrary_tpu.ops import pipeline as ref_pipeline
from jpeglibrary_tpu_torch.host.ops import decode_stage as host_stage
from jpeglibrary_tpu_torch.host.ops import pipeline as host_pipeline
from jpeglibrary_tpu_torch.models.decoder import quant_tables
from jpeglibrary_tpu_torch.ops import _build, dct, decode_stage, encode_stage, kernels, pipeline

CPU = torch.device("cpu")
H, W = 61, 75  # odd, so every component's grid is ragged


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    base = np.linspace(0, 255, w)[None, :, None] + np.linspace(0, 90, h)[:, None, None]
    return np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


def _gray12(seed):
    return (_image(H, W, seed)[..., 0].astype(np.int32) * 16
            + np.random.default_rng(seed).integers(0, 16, (H, W))).astype(np.int32)


STREAMS = {
    "gray_ri": lambda: jt.encode_gray(_image(H, W, 1)[..., 0], 80, restart_interval=4),
    "444_ri": lambda: jt.encode_rgb(_image(H, W, 2), 85, subsampling="444", restart_interval=5),
    "420_ri": lambda: jt.encode_rgb(_image(H, W, 3), 75, subsampling="420", restart_interval=2),
    "422_ri": lambda: jt.encode_rgb(_image(H, W, 4), 75, subsampling="422", restart_interval=3),
    "gray12": lambda: jt.encode_gray(_gray12(5), 90, precision=12),
    "progressive": lambda: encode_progressive_rgb(_image(H, W, 6), 85),
    "arithmetic": lambda: jt.encode_rgb(_image(H, W, 7), 80, arithmetic=True),
    "hierarchical": lambda: jt.encode_hierarchical(_image(H, W, 8), base="dct",
                                                   refinement="dct", final_lossless=False,
                                                   levels=2),
}
RECTS = [(8, 8, 40, 30), (13, 5, 59, 47)]


@pytest.fixture(scope="module", params=sorted(STREAMS))
def stream(request):
    return request.param, STREAMS[request.param]()


@pytest.fixture
def k4_calls(monkeypatch):
    """Counts the calls of K4's wrapper (its plain version runs on the CPU)."""
    calls = []
    wrapped = kernels.butterfly_idct_shift

    def spy(*args, **kwargs):
        calls.append(args[0].device)
        return wrapped(*args, **kwargs)

    monkeypatch.setattr(kernels, "butterfly_idct_shift", spy)
    return calls


def _assert_planes_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.int32 and want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_planes_equal_jax_device_and_host(stream, k4_calls):
    """``jtt.decode(xp=torch.device("cpu")).planes`` equals the JAX
    package's ``decode(xp=jnp).planes`` and its numpy planes, every value;
    the DCT streams go through K4's wrapper once per component."""
    name, data = stream
    res = jtt.decode(data, xp=CPU)
    got = res.planes
    assert all(isinstance(p, np.ndarray) for p in got.values())
    _assert_planes_equal(got, jt.decode(data, xp=jnp).planes)
    _assert_planes_equal(got, jt.decode(data).planes)
    if res.samples is None:
        assert len(k4_calls) == len(res.geometry.components)
        assert all(d == CPU for d in k4_calls)
    else:  # the hierarchical pyramid ends in sample planes, which never read xp
        assert name == "hierarchical" and not k4_calls


@pytest.mark.parametrize("rect", RECTS, ids=["small", "large"])
def test_region_equals_jax(stream, rect):
    """``jtt.decode_region(..., xp=torch.device("cpu"))`` equals the JAX
    package's region on ``jnp`` and on numpy, every value."""
    _, data = stream
    x, y, w, h = rect
    got = jtt.decode_region(data, x, y, w, h, xp=CPU)
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jt.decode_region(data, x, y, w, h, xp=jnp))
    np.testing.assert_array_equal(got, jt.decode_region(data, x, y, w, h))


def test_rgb_writers_equal_jax(stream):
    """The host writers on the device planes equal the JAX package's on its
    ``jnp`` planes: ``to_rgb8`` and the 16-bit extending writer."""
    _, data = stream
    ours, ref = jtt.decode(data, xp=CPU), jt.decode(data, xp=jnp)
    np.testing.assert_array_equal(ours.to_rgb8(), ref.to_rgb8())
    np.testing.assert_array_equal(ours.to_uint16_extended(), ref.to_uint16_extended())


@pytest.mark.parametrize("bad", ["cuda", "torch", None, 0, jnp],
                         ids=["str-cuda", "str-torch", "none", "int", "jnp"])
def test_bad_xp_raises_type_error(bad):
    data = STREAMS["420_ri"]()
    with pytest.raises(TypeError, match="numpy .* torch .* torch.device"):
        jtt.decode(data, xp=bad).planes
    res = jt.decode(data)
    with pytest.raises(TypeError, match="xp must be"):
        host_stage.decode_components_to_planes(res.coefficients, res.quant, res.geometry,
                                               xp=bad)


@pytest.mark.parametrize("xp,want", [(np, None), (torch, torch.device("cuda")),
                                     (CPU, CPU), (torch.device("cuda", 1),
                                                  torch.device("cuda", 1))],
                         ids=["numpy", "torch", "cpu", "cuda1"])
def test_xp_names_the_device(xp, want):
    """``torch`` means the card, as ``jnp`` means the JAX default device; a
    ``torch.device`` names its device; numpy stays on the host."""
    assert host_stage.device_of(xp) == want


def test_host_stage_returns_device_tensors_and_one_download():
    """The host ``decode_components_to_planes`` with a device returns that
    device's int32 tensors (as the JAX one returns jnp arrays);
    ``planes_to_host`` brings them back as numpy."""
    data = STREAMS["422_ri"]()
    res = jt.decode(data)
    planes = host_stage.decode_components_to_planes(res.coefficients, res.quant,
                                                    res.geometry, xp=CPU)
    assert all(isinstance(p, torch.Tensor) and p.dtype == torch.int32 for p in planes.values())
    host = host_stage.planes_to_host(planes)
    assert list(host) == list(planes)
    _assert_planes_equal(host, jt.decode(data).planes)


def test_lossless_results_never_read_xp():
    """A lossless result's planes come from its samples, whatever ``xp``."""
    data = jt.encode_lossless(_image(H, W, 9), predictor=1)
    np.testing.assert_array_equal(jtt.decode(data, xp=CPU).to_rgb8(), jt.decode(data).to_rgb8())


MAGNITUDES = {"unit": 1.0, "coefficients": 1024.0, "extreme": float(2 ** 15 * 255)}


@pytest.mark.parametrize("which", ["idct8x8", "fdct8x8"])
@pytest.mark.parametrize("magnitude", sorted(MAGNITUDES))
def test_butterfly_dct_bit_equal_to_jax(which, magnitude):
    """``ops/dct.py`` equals the JAX package's ``dct`` on ``jnp`` and on
    numpy, every float bit, on random blocks up to +-2^15 * 255."""
    rng = np.random.default_rng(sorted(MAGNITUDES).index(magnitude))
    scale = MAGNITUDES[magnitude]
    blocks = rng.uniform(-scale, scale, (3, 257, 8, 8)).astype(np.float32)
    blocks[0, :4] = np.float32(scale)  # the extremes themselves
    blocks[0, 4:8] = np.float32(-scale)
    got = getattr(dct, which)(torch.from_numpy(blocks)).numpy()
    assert got.dtype == np.float32 and got.shape == blocks.shape
    ref = getattr(ref_dct, which)
    for want in (np.asarray(ref(jnp.asarray(blocks), xp=jnp)), ref(blocks)):
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


K4_CASES = {
    # (coefficient dtype, coefficient bound, quant bound, level shift)
    "int16_8bit": (np.int16, 1024, 256, 128),
    "int32_8bit": (np.int32, 1024, 256, 128),
    "int16_12bit": (np.int16, 256, 65536, 2048),
    "int16_full_range": (np.int16, 32768, 2, 128),
}


@pytest.mark.parametrize("case", sorted(K4_CASES))
@pytest.mark.parametrize("grid", [(5, 7), (1, 1), (16, 3)])
def test_k4_plain_version_equals_jax(case, grid):
    """K4's wrapper on the CPU (its plain version) equals the JAX
    ``dequantize_idct_shift`` + ``blocks_to_plane`` on ``jnp``, every
    sample: int16 and int32 coefficients, quant entries up to 65,535."""
    dtype, c_hi, q_hi, ls = K4_CASES[case]
    rng = np.random.default_rng(hash(case) % 2 ** 32 + grid[0])
    coeffs = rng.integers(-c_hi, c_hi, grid + (64,)).astype(dtype)
    coeffs[..., 20:] //= 8  # fewer large high frequencies, as in a real stream
    quant = rng.integers(1, q_hi, 64).astype(np.int32)
    got = kernels.butterfly_idct_shift(torch.from_numpy(coeffs), torch.from_numpy(quant), ls)
    want = ref_stage.blocks_to_plane(
        ref_stage.dequantize_idct_shift(jnp.asarray(coeffs), jnp.asarray(quant), ls, xp=jnp),
        xp=jnp)
    assert got.dtype == torch.int32 and tuple(got.shape) == (grid[0] * 8, grid[1] * 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hs,vs", [(1, 1), (2, 2), (2, 1), (1, 2), (4, 1)])
def test_component_plane_equals_jax(hs, vs):
    """The device ``component_plane`` (K4, duplicate upsampling, the crop)
    equals the JAX one on ``jnp`` at each box factor."""
    rng = np.random.default_rng(hs * 10 + vs)
    coeffs = rng.integers(-300, 300, (5, 6, 64)).astype(np.int16)
    quant = rng.integers(1, 64, 64).astype(np.int32)
    height, width = 5 * 8 * vs - 3, 6 * 8 * hs - 5
    got = decode_stage.component_plane(torch.from_numpy(coeffs), torch.from_numpy(quant), 128,
                                       hs, vs, height, width)
    want = ref_stage.component_plane(jnp.asarray(coeffs), jnp.asarray(quant), 128, hs, vs,
                                     height, width, xp=jnp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("level_shift,sample_hi", [(128.0, 256), (2048.0, 4096)])
@pytest.mark.parametrize("shape", [(64, 72), (8, 8), (40, 120)])
def test_butterfly_fdct_route_equals_jax(level_shift, sample_hi, shape):
    """``fdct_quantize_butterfly`` equals the JAX ``fdct_quantize(
    use_matmul=False, xp=jnp)``, every coefficient."""
    rng = np.random.default_rng(shape[0] + int(level_shift))
    plane = rng.integers(0, sample_hi, shape).astype(np.int32)
    quant = rng.integers(1, 100, 64).astype(np.int32)
    quant[:3] = 1
    got = encode_stage.fdct_quantize_butterfly(torch.from_numpy(plane), torch.from_numpy(quant),
                                               level_shift)
    want = ref_encode.fdct_quantize(jnp.asarray(plane), jnp.asarray(quant), jnp,
                                    use_matmul=False, level_shift=level_shift)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), ref_encode.fdct_quantize(plane, quant, use_matmul=False,
                                              level_shift=level_shift))


def test_butterfly_fdct_route_on_uint8_samples():
    """uint8 samples (the 8-bit planes) give what int32 samples give."""
    plane = np.random.default_rng(3).integers(0, 256, (16, 24)).astype(np.uint8)
    quant = torch.full((64,), 3, dtype=torch.int32)
    a = encode_stage.fdct_quantize_butterfly(torch.from_numpy(plane), quant)
    b = encode_stage.fdct_quantize_butterfly(torch.from_numpy(plane.astype(np.int32)), quant)
    assert torch.equal(a, b)


PACKED = ["420_ri", "444_ri", "gray_ri", "gray12", "progressive"]


@pytest.mark.parametrize("name", PACKED)
def test_pack_sparse_equals_jax(name):
    data = STREAMS[name]()
    ours, ref = jtt.decode(data), jt.decode(data)
    got = host_pipeline.pack_sparse(ours.coefficients, ours.geometry)
    want = ref_pipeline.pack_sparse(ref.coefficients, ref.geometry)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _contract(got, want, levels=2, share=1e-4):
    got, want = np.asarray(got).astype(np.int64), np.asarray(want).astype(np.int64)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= levels and (d > 0).sum() <= d.size * share, (d.max(), (d > 0).sum())


@pytest.mark.parametrize("output", ["rgb8", "u16"])
@pytest.mark.parametrize("name", PACKED)
def test_transform_packed_matches_jax(name, output):
    """``transform_packed`` on the port's packer wire equals the JAX
    ``jitted_transform_packed`` on the same image within the wires'
    tolerance, and the dense transform of the same planes exactly."""
    data = STREAMS[name]()
    ours, ref = jtt.decode(data), jt.decode(data)
    q = quant_tables(ours)
    packed = host_pipeline.pack_sparse(ours.coefficients, ours.geometry)
    got = pipeline.transform_packed(packed, q, ours.geometry, "cpu", output=output)
    want = ref_pipeline.jitted_transform_packed(ref.geometry, output, "duplicate")(
        ref_pipeline.pack_sparse(ref.coefficients, ref.geometry), q)
    if output == "u16":
        assert got.dtype == torch.uint16
        _contract(got.numpy() >> 8, np.asarray(want) >> 8, levels=1)
    else:
        assert got.dtype == torch.uint8
        _contract(got.numpy(), want)
    dense = [ours.coefficients[c.component_index] for c in ours.geometry.components]
    kind = "rgb8p" if output == "rgb8" else "u16"
    assert torch.equal(got, pipeline.transform_dense(dense, q, ours.geometry, "cpu",
                                                     output=kind))


def test_transform_packed_fancy_and_export():
    data = STREAMS["420_ri"]()
    res = jtt.decode(data)
    q = quant_tables(res)
    packed = host_pipeline.pack_sparse(res.coefficients, res.geometry)
    got = jtt.transform_packed(packed, q, res.geometry, "cpu", upsample="fancy")
    assert torch.equal(got, jtt.to_rgb8_device(res, device="cpu", upsample="fancy"))
    assert "transform_packed" in jtt.__all__


@pytest.mark.parametrize("args,err", [
    ((torch.zeros(2, 2, 64, dtype=torch.float32), torch.ones(64, dtype=torch.int32)), TypeError),
    ((torch.zeros(4, 64, dtype=torch.int16), torch.ones(64, dtype=torch.int32)), ValueError),
    ((torch.zeros(2, 2, 63, dtype=torch.int16), torch.ones(64, dtype=torch.int32)), ValueError),
    ((torch.zeros(2, 2, 64, dtype=torch.int16), torch.ones(64, dtype=torch.int16)), ValueError),
    ((torch.zeros(2, 2, 64, dtype=torch.int16), torch.ones(8, 8, dtype=torch.int32)), ValueError),
    ((torch.zeros(2, 2, 64, dtype=torch.int16, device="meta"),
      torch.ones(64, dtype=torch.int32)), ValueError),
    ((torch.zeros(2, 2, 64, dtype=torch.int16, device="meta"),
      torch.ones(64, dtype=torch.int32, device="meta")), ValueError),
], ids=["float", "2d", "63", "int16-quant", "quant-shape", "device-mismatch", "meta"])
def test_k4_wrapper_guards(args, err):
    """K4's wrapper refuses what the kernel does not take, and a device
    that is neither the CPU nor CUDA; nothing falls back."""
    with pytest.raises(err):
        kernels.butterfly_idct_shift(*args, 128)


def _cu_source():
    return (_build._CSRC / "butterfly_idct.cu").read_text()


def test_k4_source_is_built_and_bound():
    """csrc/butterfly_idct.cu is one of the library's sources and defines
    both entry points the loader binds, with as many parameters as their
    ctypes signatures; the global nvcc flags stay as they were (no
    --fmad=false, no fast math)."""
    assert "butterfly_idct.cu" in [p.name for p in _build._CSRC.glob("*.cu")]
    text = _cu_source()
    for name in ("jpx_butterfly_idct_i16", "jpx_butterfly_idct_i32"):
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
        assert m and m.group(1).count(",") + 1 == len(_build._ENTRY_POINTS[name])
    flags = " ".join(_build.NVCC_FLAGS)
    assert "fmad" not in flags and "fast-math" not in flags and "-O3" in flags


def test_k4_butterfly_is_written_in_rounding_intrinsics():
    """Every operation of K4's 1-D pass is an explicit __fmul_rn, __fadd_rn
    or __fsub_rn: a bare *, + or - there would let nvcc contract a product
    and a sum into one FMA, which rounds once where numpy rounds twice."""
    text = _cu_source()
    body = text[text.index("void idct_1d("):]
    body = body[body.index("{") + 1: body.index("\n}\n")]
    body = re.sub(r"//[^\n]*", "", body)
    body = re.sub(r"\[\d\]", "", body)  # x[1], y[7]
    assert not re.search(r"[-+*/]", body), re.findall(r"[^\n]*[-+*/][^\n]*", body)
    # As many of each as the JAX package's pass has.
    ref = inspect.getsource(ref_dct._idct_1d).split('"""')[2]
    for op, fn in ((" * ", "__fmul_rn"), (" + ", "__fadd_rn"), (" - ", "__fsub_rn")):
        assert body.count(fn) == ref.count(op), (fn, body.count(fn), ref.count(op))


def test_k4_constants_are_the_host_copys():
    """K4's hexadecimal float constants are the host copy's float32
    constants bit for bit (no decimal rounding in between)."""
    from jpeglibrary_tpu_torch.host.ops import dct as host_dct

    found = dict(re.findall(r"constexpr float k(C\d_\d+) = ([-+0-9a-fx.p]+)f;", _cu_source()))
    assert len(found) == 13
    for name, literal in found.items():
        want = getattr(host_dct, f"_{name.replace('C', 'C_', 1)}")
        value = float.fromhex(literal) if "0x" in literal else float(literal)
        assert value == float(want), (name, literal, float(want))

"""PyTorch port, the device encode on the CPU: K2's plain version against
the JAX package's Pallas kernel (interpret mode) and its XLA path, the
integer pad/subsample ops bit-exact against numpy, ``forward`` against
``jitted_forward``, and the entry points against the JAX device encode
(``xp=jnp``).

Tolerance for coefficients: 1 LSB on at most 1e-3 of the values. The
folded-matrix product sums in another order than XLA's dot and the
Pallas interpreter, so a quotient within an ulp of a .5 tie can round
the other way (the JAX package's own contract,
tests/test_pallas_kernels.py). Ties that are exact in fp32 must round
exactly, half to even. Bytes must be equal wherever the coefficient
planes are equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import jpeglibrary_tpu as jt
import jpeglibrary_tpu_torch as jtt
from jpeglibrary_tpu.models import encoder as ref_encoder
from jpeglibrary_tpu.ops import encode_stage as ref_stage
from jpeglibrary_tpu.ops import pallas_kernels
from jpeglibrary_tpu_torch.host.models import encoder as host_encoder
from jpeglibrary_tpu_torch.models import encoder as port_encoder
from jpeglibrary_tpu_torch.ops import encode_stage, kernels

LEVEL_SHIFTS = [128, 2048]


def _samples(shape, level_shift, seed):
    """Samples of the precision that ``level_shift`` implies: uint8 at
    8 bits, int32 in [0, 4095] at 12."""
    rng = np.random.default_rng(seed)
    if level_shift == 128:
        return rng.integers(0, 256, size=shape).astype(np.uint8)
    return rng.integers(0, 4096, size=shape).astype(np.int32)


def _quant(seed):
    return np.random.default_rng(seed).integers(1, 256, size=64).astype(np.int32)


def _plain(plane, quant, level_shift):
    return encode_stage.fdct_quantize(
        torch.from_numpy(plane), torch.from_numpy(quant), level_shift,
        kernels.fdct_matrix(torch.device("cpu")),
    ).numpy()


def _assert_within_one(got, want):
    got = np.asarray(got).astype(np.int64)
    want = np.asarray(want).astype(np.int64)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def _gradient_noise(h, w, seed, sigma=30.0):
    rng = np.random.default_rng(seed)
    return np.clip(
        np.linspace(0, 255, w)[None, :, None] + rng.normal(0, sigma, (h, w, 3)), 0, 255
    ).astype(np.uint8)


# --- K2's plain version ---------------------------------------------------

@pytest.mark.parametrize("level_shift", LEVEL_SHIFTS)
@pytest.mark.parametrize("n_blocks", [1, 64, 513])
def test_plain_matches_pallas_interpret(n_blocks, level_shift):
    plane = _samples((8, 8 * n_blocks), level_shift, seed=n_blocks)
    quant = _quant(3)
    blocks = plane.reshape(8, n_blocks, 8).transpose(1, 0, 2).reshape(n_blocks, 64)
    want = np.asarray(pallas_kernels.fdct_quantize_pallas(
        jnp.asarray(blocks.astype(np.int32)), jnp.asarray(quant),
        level_shift=level_shift, interpret=True,
    ))
    got = _plain(plane, quant, level_shift)
    assert got.dtype == np.int16 and got.shape == (1, n_blocks, 64)
    _assert_within_one(got[0], want)


@pytest.mark.parametrize("level_shift", LEVEL_SHIFTS)
def test_plain_matches_xla(level_shift):
    plane = _samples((256, 512), level_shift, seed=11)
    quant = _quant(4)
    want = np.asarray(ref_stage.fdct_quantize(
        jnp.asarray(plane.astype(np.int32)), jnp.asarray(quant), xp=jnp,
        level_shift=float(level_shift),
    ))
    got = _plain(plane, quant, level_shift)
    assert got.dtype == np.int16 and got.shape == want.shape == (32, 64, 64)
    _assert_within_one(got, want)


@pytest.mark.parametrize("level_shift", LEVEL_SHIFTS)
def test_ties_round_half_to_even(level_shift):
    """A constant block of level_shift + s has DC 8s exactly (F's DC
    column is 1/8 everywhere), so q = 16 makes DC = s/2: an exact .5 for
    odd s, which must round to the even neighbour."""
    s = np.arange(-128, 128)
    plane = np.repeat(np.repeat((level_shift + s).reshape(16, 16), 8, 0), 8, 1)
    plane = plane.astype(np.uint8 if level_shift == 128 else np.int32)
    got = _plain(plane, np.full(64, 16, np.int32), level_shift).reshape(256, 64)
    np.testing.assert_array_equal(got[:, 0], np.rint(s / 2).astype(np.int16))
    assert not got[:, 1:].any()
    assert (np.rint(s / 2) != np.floor(s / 2 + 0.5)).sum() == 64  # half of the odd s


def test_fdct_matrix_equals_jax_package():
    ours = kernels.fdct_matrix(torch.device("cpu"))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (64, 64)
    np.testing.assert_array_equal(ours.numpy(), ref_stage.fdct_zigzag_matrix())


# --- pad and subsample ----------------------------------------------------

# Every box T.81's sampling factors give: hs and vs are each 1 to 4.
ALL_BOXES = [(1, 1), (2, 2), (2, 1), (1, 2), (4, 1), (3, 1), (1, 3), (3, 2), (3, 3), (4, 3),
             (4, 4)]


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("hs,vs", ALL_BOXES)
def test_pad_and_subsample_bit_exact(hs, vs, dtype):
    plane = np.random.default_rng(hs * 10 + vs).integers(0, 256, size=(37, 53)).astype(dtype)
    hp, wp = 8 * vs * 5, 8 * hs * 7  # the grid of 37x53 with 8x8 blocks after subsampling
    want_pad = ref_stage.pad_to_grid(plane, hp, wp, xp=np)
    got_pad = encode_stage.pad_to_grid(torch.from_numpy(plane), hp, wp)
    assert got_pad.dtype == torch.from_numpy(plane).dtype
    np.testing.assert_array_equal(got_pad.numpy(), want_pad)
    assert not got_pad[37:].any() and not got_pad[:, 53:].any()
    want = ref_stage.subsample_box(want_pad, hs, vs, xp=np)
    got = encode_stage.subsample_box(got_pad, hs, vs)
    # A 1x1 box keeps the plane's dtype (K2 takes uint8); the JAX version widens it.
    assert got.dtype == (got_pad.dtype if (hs, vs) == (1, 1) else torch.int32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hs,vs", [(3, 1), (3, 3), (1, 3), (3, 2), (2, 3), (4, 3)])
def test_subsample_floors_negative_sums(hs, vs):
    """int32 samples below zero give negative box sums: (sum + n//2) // n
    floors them, as the JAX package's int32 division does (and as K2's
    division by a constant n that is no power of two must), where a
    truncating division would round them toward zero."""
    rng = np.random.default_rng(100 + 10 * hs + vs)
    plane = rng.integers(-3000, 3000, size=(8 * vs * 4, 8 * hs * 5)).astype(np.int32)
    want = ref_stage.subsample_box(plane, hs, vs, xp=np)
    got = encode_stage.subsample_box(torch.from_numpy(plane), hs, vs).numpy()
    np.testing.assert_array_equal(got, want)
    sums = plane.reshape(4 * 8, vs, 5 * 8, hs).sum(axis=(1, 3)) + hs * vs // 2
    truncated = np.trunc(sums / (hs * vs)).astype(np.int32)
    assert (truncated != want).sum() > 0  # the case floor division exists for
    # Through the K2 wrapper (its plain version on a CPU plane) and the JAX
    # package's device forward, 12-bit level shift.
    quant = _quant(hs * vs)
    got = kernels.fdct_quantize(torch.from_numpy(plane), torch.from_numpy(quant), 2048,
                                hs=hs, vs=vs).numpy()
    (jitted,) = ref_stage.jitted_forward(((1, 1, hs, vs),), 5, 4, 2048.0)((plane,), quant[None])
    _assert_within_one(got, np.asarray(jitted))


# --- forward against jitted_forward ---------------------------------------

FORWARD_CASES = {
    "420": (((2, 2, 1, 1), (1, 1, 2, 2), (1, 1, 2, 2)), 128),
    "422": (((2, 1, 1, 1), (1, 1, 2, 1), (1, 1, 2, 1)), 128),
    "444": (((1, 1, 1, 1),) * 3, 128),
    "gray": (((1, 1, 1, 1),), 128),
    "gray12": (((1, 1, 1, 1),), 2048),
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_forward_matches_jitted_forward(case):
    comp_params, level_shift = FORWARD_CASES[case]
    h, w = 77, 133
    max_h = max(p[0] for p in comp_params)
    max_v = max(p[1] for p in comp_params)
    mpl, mpc = -(-w // (8 * max_h)), -(-h // (8 * max_v))
    planes = tuple(_samples((h, w), level_shift, seed=i) for i in range(len(comp_params)))
    quants = np.stack([_quant(20 + i) for i in range(len(comp_params))])
    fwd = ref_stage.jitted_forward(comp_params, mpl, mpc, float(level_shift))
    want = [np.asarray(o) for o in fwd(planes, quants)]
    before = kernels.fdct_quantize.launches
    got = encode_stage.forward(planes, quants, comp_params, mpl, mpc, level_shift, "cpu")
    assert kernels.fdct_quantize.launches == before
    assert len(got) == len(want)
    for g, wnt in zip(got, want):
        assert g.dtype == torch.int16 and g.device.type == "cpu"
        _assert_within_one(g.numpy(), wnt)


# --- the entry points against the JAX device encode -------------------------

RGB_CASES = {
    "420": {},
    "444": {"subsampling": "444"},
    "422": {"subsampling": "422"},
    "420_optimize": {"optimize_coding": True},
    "420_restart3": {"restart_interval": 3},
    "444_optimize_restart3": {"subsampling": "444", "optimize_coding": True,
                              "restart_interval": 3},
    "420_arithmetic": {"arithmetic": True},
}


def _jax_planes(encoder):
    """The coefficient planes of the JAX device branch for ``encoder``."""
    comps = encoder._components
    max_h = max(c.h for c in comps)
    max_v = max(c.v for c in comps)
    fwd = ref_stage.jitted_forward(
        tuple((c.h, c.v, max_h // c.h, max_v // c.v) for c in comps),
        -(-encoder._width // (8 * max_h)), -(-encoder._height // (8 * max_v)),
        float(1 << (encoder.sample_precision - 1)),
    )
    planes = port_encoder.sample_planes(encoder)
    return [np.asarray(o) for o in fwd(tuple(planes), port_encoder.device_quants(
        encoder, "cpu").numpy())]


def _check_against_jax(encoder, got_bytes, want_bytes):
    got_planes = port_encoder.coefficient_planes(encoder, device="cpu")
    want_planes = _jax_planes(encoder)
    for g, w in zip(got_planes, want_planes):
        _assert_within_one(g, w)
    if all(np.array_equal(g, w) for g, w in zip(got_planes, want_planes)):
        assert got_bytes == want_bytes
    # The stream itself carries the planes: decode both and compare.
    got_res, want_res = jt.decode(got_bytes), jt.decode(want_bytes)
    for c in want_res.geometry.components:
        _assert_within_one(got_res.coefficients[c.component_index],
                           want_res.coefficients[c.component_index])


@pytest.mark.parametrize("case", sorted(RGB_CASES))
def test_encode_rgb_matches_jax_device_encode(case):
    kwargs = RGB_CASES[case]
    rgb = _gradient_noise(77, 133, seed=len(case))
    got = jtt.encode_rgb(rgb, 75, device="cpu", **kwargs)
    want = ref_encoder.encode_rgb(rgb, 75, xp=jnp, **kwargs)
    _check_against_jax(port_encoder.rgb_encoder(rgb, 75, **kwargs), got, want)


@pytest.mark.parametrize("precision", [8, 12])
def test_encode_gray_matches_jax_device_encode(precision):
    level_shift = 1 << (precision - 1)
    plane = _samples((77, 133), level_shift, seed=precision)
    got = jtt.encode_gray(plane, 80, device="cpu", precision=precision)
    want = ref_encoder.encode_gray(plane, 80, precision=precision, xp=jnp)
    encoder = jtt.JpegEncoder()
    encoder.sample_precision = precision
    encoder.set_quantization_table(port_encoder.scale_by_quality(
        port_encoder.standard_luminance_table(0), 80))
    encoder.add_component(1, 0, 0, 0, 1, 1)
    encoder.set_input([plane])
    _check_against_jax(encoder, got, want)
    assert jt.decode(got).to_uint16_extended().shape[:2] == (77, 133)


def test_encode_keeps_the_callers_input():
    rgb = _gradient_noise(40, 56, seed=5)
    encoder = port_encoder.rgb_encoder(rgb, 75)
    first = jtt.encode(encoder, device="cpu")
    np.testing.assert_array_equal(encoder._input_rgb, rgb)
    assert encoder._input_planes is None and encoder._coefficient_planes is None
    assert jtt.encode(encoder, device="cpu") == first


def _ink_encoder():
    encoder = port_encoder._configure_rgb_encoder(75, "444")
    encoder.add_component(4, 0, 0, 0, 1, 1)
    encoder.set_input_ink(np.zeros((16, 16, 4), np.uint8))
    return encoder


def _unported(kind):
    """An encoder whose input the device encode refuses, as the JAX
    package's ``encode(xp=jnp)`` does or, for a mesh that is no
    DeviceMesh of ``sharding.make_mesh``'s kind, as only the port does
    (a JAX mesh would fail there at its first use)."""
    rgb = _gradient_noise(16, 16, seed=1)
    encoder = port_encoder._configure_rgb_encoder(75, "420")
    if kind == "mesh":
        encoder.set_input_rgb(rgb)
        encoder.mesh = object()
    elif kind == "ink_differential":
        encoder = _ink_encoder()
        encoder.differential = True
    elif kind == "ink_precision16":
        encoder = _ink_encoder()
        encoder.sample_precision = 16
    elif kind == "component_count":
        encoder.add_component(4, 0, 0, 0, 1, 1)
        encoder.set_input_rgb(rgb)
    elif kind == "quant_table_missing":
        encoder.add_component(4, 3, 0, 0, 1, 1)
        encoder.set_input([rgb[..., 0]] * 4)
    elif kind == "differential":
        encoder.set_input_rgb(rgb)
        encoder.differential = True
    elif kind == "precision16":
        encoder.set_input([rgb[..., i].astype(np.int32) for i in range(3)])
        encoder.sample_precision = 16
    elif kind == "no_input":
        pass
    return encoder


@pytest.mark.parametrize("kind", ["mesh", "ink_differential", "ink_precision16",
                                  "component_count", "quant_table_missing",
                                  "differential", "precision16", "no_input"])
def test_encode_raises_for_unported_inputs(kind):
    with pytest.raises(jtt.JpegEncodeError):
        jtt.encode(_unported(kind), device="cpu")


def _host_input_encoder(mod, kind):
    """An encoder of ``mod`` (the JAX package's encoder module or the
    port's host copy) with an input that ``encode`` takes on the host."""
    rgb = _gradient_noise(24, 40, seed=6)
    encoder = mod._configure_rgb_encoder(75, "420")
    if kind == "rgb_reader":
        encoder.set_input_rgb_reader(lambda y0, y1: rgb[y0:y1], 40, 24)
    elif kind == "reader":
        encoder.set_input_reader(lambda y0, y1: [rgb[y0:y1, :, i] for i in range(3)], 40, 24)
    elif kind == "stream":
        encoder.set_input_stream(iter([[rgb[:16, :, i] for i in range(3)],
                                       [rgb[16:, :, i] for i in range(3)]]), 40)
    elif kind == "coefficients":
        res = jt.decode(ref_encoder.encode_rgb(rgb, 80))
        encoder.set_coefficient_planes(
            [res.coefficients[c.component_index] for c in res.geometry.components], 40, 24)
    elif kind == "differential_coefficients":
        encoder = mod.JpegEncoder()
        encoder.differential = True
        encoder.set_quantization_table(port_encoder.scale_by_quality(
            port_encoder.standard_luminance_table(0), 80))
        encoder.set_huffman_table(True, 0)
        encoder.set_huffman_table(False, 0)
        encoder.add_component(1, 0, 0, 0, 1, 1)
        encoder.set_coefficient_planes(
            [np.random.default_rng(7).integers(-20, 20, (3, 5, 64)).astype(np.int16)], 40, 24)
    return encoder


@pytest.mark.parametrize("kind", ["rgb_reader", "reader", "stream", "coefficients",
                                  "differential_coefficients"])
def test_encode_host_inputs_match_jax_device_encode(kind, monkeypatch):
    """Coefficient planes, pull readers and streams: the JAX package's
    ``encode(xp=jnp)`` encodes them on the host, and so does the port,
    with the same bytes and no K2 call at all."""
    calls = []
    plain = kernels.fdct_quantize
    monkeypatch.setattr(kernels, "fdct_quantize",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    want = _host_input_encoder(ref_encoder, kind).encode(xp=jnp)
    encoder = _host_input_encoder(host_encoder, kind)
    assert port_encoder.takes_host_path(encoder)
    assert jtt.encode(encoder, device="cpu") == want
    assert calls == []


@pytest.mark.parametrize("ycck,subsampling", [(False, "420"), (True, "420"), (True, "444"),
                                              (True, "422"), (True, "440"), (True, "411")])
def test_encode_cmyk_matches_jax_device_encode(ycck, subsampling, monkeypatch):
    """CMYK ink through the staged conversion and 4 K2 calls, against
    ``jt.encode_cmyk(xp=jnp)``: planes within one, bytes equal where they
    are equal (the decoded streams too)."""
    calls = []
    plain = kernels.fdct_quantize
    monkeypatch.setattr(kernels, "fdct_quantize",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    rgb = _gradient_noise(37, 53, seed=11)
    ink = np.concatenate([rgb, _gradient_noise(37, 53, seed=12)[..., :1]], axis=-1)
    got = jtt.encode_cmyk(ink, 75, device="cpu", ycck=ycck, subsampling=subsampling)
    assert len(calls) == 4
    want = ref_encoder.encode_cmyk(ink, 75, ycck=ycck, subsampling=subsampling, xp=jnp)
    encoder = port_encoder.cmyk_encoder(ink, 75, ycck=ycck, subsampling=subsampling)
    _check_against_jax(encoder, got, want)
    assert got == want


def test_encode_cmyk_optimize_restart_matches_jax():
    ink = np.random.default_rng(13).integers(0, 256, (32, 48, 4)).astype(np.uint8)
    kw = {"ycck": True, "optimize_coding": True, "restart_interval": 2}
    assert (jtt.encode_cmyk(ink, 60, device="cpu", **kw)
            == ref_encoder.encode_cmyk(ink, 60, xp=jnp, **kw))


# The encoder's private fields that jpeglibrary_tpu_torch/models/encoder.py reads.
HOST_FIELDS = ("_components", "_quant_tables", "_input_planes", "_input_rgb", "_input_ink",
               "sample_precision", "_width", "_height", "differential", "mesh")


def test_encoder_fields_the_port_reads_exist():
    fields = vars(jtt.JpegEncoder())
    missing = [f for f in HOST_FIELDS if f not in fields]
    assert not missing, missing
    for f in port_encoder.HOST_INPUTS:
        assert f in fields, f


# --- the wrapper's dispatch -----------------------------------------------

@pytest.mark.parametrize("dtype", [torch.int32, torch.uint8])
def test_wrapper_on_cpu_takes_plain_version(dtype):
    plane = _samples((24, 40), 128, seed=9)
    quant = _quant(9)
    before = kernels.fdct_quantize.launches
    got = kernels.fdct_quantize(torch.from_numpy(plane).to(dtype), torch.from_numpy(quant), 128)
    assert kernels.fdct_quantize.launches == before
    assert got.shape == (3, 5, 64) and got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), _plain(plane, quant, 128))


def test_wrapper_rejects_bad_inputs():
    p = torch.from_numpy(_samples((16, 16), 128, seed=1)).to(torch.int32)
    q = torch.from_numpy(_quant(1))
    with pytest.raises(TypeError):
        kernels.fdct_quantize(p.to(torch.float32), q, 128)
    with pytest.raises(TypeError):
        kernels.fdct_quantize(p.to(torch.int16), q, 128)
    with pytest.raises(ValueError):
        kernels.fdct_quantize(p[:, :12], q, 128)
    with pytest.raises(ValueError):
        kernels.fdct_quantize(p.reshape(2, 8, 16), q, 128)
    with pytest.raises(ValueError):
        kernels.fdct_quantize(p, q[:32], 128)
    with pytest.raises(ValueError):
        kernels.fdct_quantize(p, q.to(torch.int64), 128)
    with pytest.raises(ValueError):
        kernels.fdct_quantize(p.to("meta"), q.to("meta"), 128)


# --- K2's fused pad and box subsample -------------------------------------

SAMPLE_KINDS = [(np.uint8, 128), (np.int32, 128), (np.int32, 2048)]
BOXES = ALL_BOXES


def _kind_samples(shape, dtype, level_shift, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 * level_shift, size=shape).astype(dtype)


@pytest.mark.parametrize("h,w,extra", [(37, 53, 1), (211, 333, 0)])
@pytest.mark.parametrize("hs,vs", BOXES)
@pytest.mark.parametrize("dtype,level_shift", SAMPLE_KINDS)
def test_wrapper_fuses_pad_and_subsample(dtype, level_shift, hs, vs, h, w, extra):
    """On a CPU plane the wrapper is the composition pad_to_grid ->
    subsample_box -> plain fdct_quantize, bit for bit, over a block grid
    that may reach past the plane (``extra`` block rows of zeros)."""
    plane = torch.from_numpy(_kind_samples((h, w), dtype, level_shift, seed=h + hs * 10 + vs))
    quant = torch.from_numpy(_quant(hs + vs))
    hb, wb = -(-h // (8 * vs)) + extra, -(-w // (8 * hs))
    before = kernels.fdct_quantize.launches
    got = kernels.fdct_quantize(plane, quant, level_shift, hs=hs, vs=vs, blocks=(hb, wb))
    assert kernels.fdct_quantize.launches == before
    padded = encode_stage.pad_to_grid(plane, hb * 8 * vs, wb * 8 * hs)
    want = encode_stage.fdct_quantize(encode_stage.subsample_box(padded, hs, vs), quant,
                                      level_shift, kernels.fdct_matrix(torch.device("cpu")))
    assert got.dtype == torch.int16 and tuple(got.shape) == (hb, wb, 64)
    assert torch.equal(got, want)


@pytest.mark.parametrize("hs,vs", BOXES)
@pytest.mark.parametrize("dtype,level_shift", SAMPLE_KINDS)
def test_wrapper_matches_jax_forward_component(dtype, level_shift, hs, vs):
    """The same ragged plane through the JAX package's forward_component
    (xp=jnp) and jitted_forward: within 1 on at most 1e-3 of the values."""
    h, w = 211, 333
    plane = _kind_samples((h, w), dtype, level_shift, seed=7 * hs + vs)
    quant = _quant(30 + hs)
    mpl, mpc = -(-w // (8 * hs)), -(-h // (8 * vs))
    got = kernels.fdct_quantize(torch.from_numpy(plane), torch.from_numpy(quant), level_shift,
                                hs=hs, vs=vs, blocks=(mpc, mpl)).numpy()
    eager = ref_stage.forward_component(jnp.asarray(plane), jnp.asarray(quant), 1, 1, hs, vs,
                                        mpl, mpc, xp=jnp, level_shift=float(level_shift))
    (jitted,) = ref_stage.jitted_forward(((1, 1, hs, vs),), mpl, mpc, float(level_shift))(
        (plane,), quant[None])
    for want in (eager, jitted):
        _assert_within_one(got, np.asarray(want))


@pytest.mark.parametrize("level_shift", LEVEL_SHIFTS)
@pytest.mark.parametrize("hs,vs", BOXES)
def test_wrapper_ties_round_half_to_even(hs, vs, level_shift):
    """Blocks that are constant after the box (level_shift + s over each
    hs x vs box) have DC 8s exactly; q = 16 makes an exact .5 for odd s,
    which rounds to even, as the JAX package's jitted_forward does."""
    s = np.arange(-128, 128)
    plane = np.repeat(np.repeat((level_shift + s).reshape(16, 16), 8 * vs, 0), 8 * hs, 1)
    plane = plane.astype(np.uint8 if level_shift == 128 else np.int32)
    q16 = np.full(64, 16, np.int32)
    got = kernels.fdct_quantize(torch.from_numpy(plane), torch.from_numpy(q16), level_shift,
                                hs=hs, vs=vs).numpy()
    np.testing.assert_array_equal(got.reshape(256, 64)[:, 0], np.rint(s / 2).astype(np.int16))
    assert not got.reshape(256, 64)[:, 1:].any()
    (want,) = ref_stage.jitted_forward(((1, 1, hs, vs),), 16, 16, float(level_shift))(
        (plane,), q16[None])
    np.testing.assert_array_equal(got, np.asarray(want))


# --- the bf16 split of the tensor-core product -----------------------------

def _bf16_exact(x):
    """x (float64) is representable in bf16."""
    t = torch.from_numpy(np.asarray(x, np.float64))
    return torch.equal(t.to(torch.bfloat16).double(), t)


def _fp32_exact(x):
    return np.array_equal(np.asarray(x, np.float64).astype(np.float32).astype(np.float64), x)


@pytest.mark.parametrize("bits", [8, 12])
@pytest.mark.parametrize("part", [0, 1, 2])
def test_fdct_split_is_exact(part, bits):
    """F1 + F2 + F3 == F in float64, each part in bf16; every level-shifted
    sample splits as the kernel splits it (A_hi: the fp32 bits with the low
    16 cleared, A_lo = a - A_hi), both exact in bf16, and every partial
    product A_x * F_k is exact in fp32."""
    f = ref_stage.fdct_zigzag_matrix().astype(np.float64)
    parts = kernels.fdct_split()
    assert parts.dtype == torch.bfloat16 and tuple(parts.shape) == (3, 64, 64)
    p64 = parts.double().numpy()
    np.testing.assert_array_equal(p64[0] + p64[1] + p64[2], f)
    assert _bf16_exact(p64[part])
    half = 1 << (bits - 1)
    a = np.arange(-half, half).astype(np.float32)
    a_hi = (a.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32).astype(np.float64)
    a_lo = a.astype(np.float64) - a_hi
    assert _bf16_exact(a_hi) and _bf16_exact(a_lo)
    if bits == 8:
        assert not a_lo.any()  # one pass of A at 8 bits
    for x in (a_hi, a_lo):
        assert _fp32_exact(x[:, None] * p64[part].reshape(1, -1))


def test_fdct_split_operand_is_column_major():
    split = kernels.fdct_split()
    operand = kernels.fdct_split_operand(torch.device("cpu"))
    assert operand.is_contiguous() and torch.equal(operand, split.transpose(1, 2))


def _bad_k2_call(kind):
    p = torch.from_numpy(_samples((40, 56), 128, seed=2))
    q = torch.from_numpy(_quant(2))
    calls = {
        "hs5": lambda: kernels.fdct_quantize(p, q, 128, hs=5),
        "vs0": lambda: kernels.fdct_quantize(p, q, 128, vs=0),
        "hs0": lambda: kernels.fdct_quantize(p, q, 128, hs=0),
        "rows_short": lambda: kernels.fdct_quantize(p, q, 128, vs=2, blocks=(2, 7)),
        "cols_short": lambda: kernels.fdct_quantize(p, q, 128, hs=2, blocks=(5, 3)),
        "negative_blocks": lambda: kernels.fdct_quantize(p, q, 128, blocks=(-1, 7)),
        "non_contiguous": lambda: kernels.fdct_quantize(p.t(), q, 128),
        "level_shift": lambda: kernels.fdct_quantize(p, q, 1 << 16),
    }
    return calls[kind]


@pytest.mark.parametrize("kind", ["hs5", "vs0", "hs0", "rows_short", "cols_short",
                                  "negative_blocks", "non_contiguous", "level_shift"])
def test_wrapper_rejects_bad_box_grid_or_layout(kind):
    with pytest.raises(ValueError):
        _bad_k2_call(kind)()


def test_wrapper_takes_a_grid_larger_than_the_plane():
    """blocks (5, 7) over a 40 x 56 plane at 1x1 is the plane itself;
    more blocks add zero-padded ones, which hold -level_shift * 8 / q at
    DC and nothing else."""
    p = torch.from_numpy(_samples((40, 56), 128, seed=2))
    q = torch.from_numpy(np.full(64, 4, np.int32))
    tight = kernels.fdct_quantize(p, q, 128, blocks=(5, 7))
    wide = kernels.fdct_quantize(p, q, 128, blocks=(6, 9))
    assert torch.equal(wide[:5, :7], tight)
    pad = torch.cat([wide[5:].reshape(-1, 64), wide[:5, 7:].reshape(-1, 64)])
    assert (pad[:, 0] == -256).all() and not pad[:, 1:].any()


def _box_encoder(mod, h, v, plane):
    """A luma sampled (h, v) over 1x1 chroma, the setup of the JAX
    package's tests/test_encoder.py exotic-sampling round trip."""
    encoder = mod.JpegEncoder()
    encoder.set_quantization_table(port_encoder.scale_by_quality(
        port_encoder.standard_luminance_table(0), 80))
    encoder.set_huffman_table(True, 0)
    encoder.set_huffman_table(False, 0)
    encoder.add_component(1, 0, 0, 0, h, v)
    encoder.add_component(2, 0, 0, 0, 1, 1)
    encoder.set_input([plane, plane])
    return encoder


def test_unsupported_box_factors_raise_encode_error():
    """The boxes the device encode once refused, a component sampled 3x or
    4x finer than another, now encode on the device: the bytes of the JAX
    package's ``encode(xp=jnp)`` for luma (3,1), (1,3), (3,2), (3,3) and
    (4,4) over 1x1 chroma, and no JpegEncodeError."""
    plane = _samples((24, 48), 128, seed=4)
    for h, v in [(3, 1), (1, 3), (3, 2), (3, 3), (4, 4)]:
        want = _box_encoder(ref_encoder, h, v, plane).encode(xp=jnp)
        encoder = _box_encoder(host_encoder, h, v, plane)
        got = jtt.encode(encoder, device="cpu")
        _check_against_jax(encoder, got, want)
        assert got == want, (h, v)


@pytest.mark.parametrize("h,v", [(3, 1), (1, 3), (3, 2), (3, 3), (4, 4), (4, 3)])
def test_encode_every_box_matches_jax_device_encode(h, v):
    """A ragged 12-bit plane pair at each luma factor: planes within one of
    the JAX device encode's, bytes equal where the planes are."""
    plane = _samples((61, 83), 2048, seed=10 * h + v)
    encoder = _box_encoder(host_encoder, h, v, plane)
    encoder.sample_precision = 12
    ref = _box_encoder(ref_encoder, h, v, plane)
    ref.sample_precision = 12
    _check_against_jax(encoder, jtt.encode(encoder, device="cpu"), ref.encode(xp=jnp))

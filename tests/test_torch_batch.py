"""PyTorch port, the batched decode on the CPU: K1's plain version with
one quant table per image and reduced outputs, held against the JAX
package's Pallas kernel (interpret mode) and its scaled transform; and
``decode_batch_rgb`` / grouped ``decode_stream_rgb`` held against the
JAX package's batch API, its host writers and the port's own
single-image path.

Tolerances: K1 within 1 sample LSB on at most 1e-3 of the samples (the
folded product sums in another order than the Pallas kernel and numpy's
matmul, so a value within an ulp of a .5 tie can round the other way);
at 1/4 scale (n = 2), where about one sample in eight is such a near
tie, every differing sample must be one.
Decoded images within the JAX package's device contract of the host
golden (at most 2 RGB levels on at most 1e-4 of the values); the
batched and grouped paths equal the port's single-image path, since they
run the same ops on the same values."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import jpeglibrary_tpu as jt
import jpeglibrary_tpu_torch as jtt
from jpeglibrary_tpu.models.encoder import JpegEncoder
from jpeglibrary_tpu.models.progressive_encoder import encode_progressive_rgb
from jpeglibrary_tpu.ops import decode_stage as ref_stage
from jpeglibrary_tpu.ops import pallas_kernels
from jpeglibrary_tpu.parallel import batch as ref_batch
from jpeglibrary_tpu.syntax import huffman_standard
from jpeglibrary_tpu.syntax.quantization import scale_by_quality, standard_luminance_table
from jpeglibrary_tpu_torch.ops import decode_stage, kernels


def _k1_inputs(n_tables, blocks_per_table, seed):
    rng = np.random.default_rng(seed)
    coeffs = rng.integers(-1024, 1024, size=(n_tables * blocks_per_table, 64)).astype(np.int16)
    quants = rng.integers(1, 255, size=(n_tables, 64)).astype(np.int32)
    return coeffs, quants


def _assert_k1_close(got, want):
    assert got.shape == want.shape
    d = np.abs(got.astype(np.int64) - want)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


# 48 blocks per table is the 4:2:0 chroma of a 96x128 image: CTAs of 64
# blocks straddle two tables.
@pytest.mark.parametrize("n_tables,blocks_per_table", [(1, 200), (3, 48), (4, 64), (2, 513)])
def test_plain_per_table_matches_pallas_interpret(n_tables, blocks_per_table):
    coeffs, quants = _k1_inputs(n_tables, blocks_per_table, seed=n_tables)
    want = np.concatenate([
        np.asarray(pallas_kernels.dequantize_idct_shift_pallas(
            jnp.asarray(coeffs[g * blocks_per_table : (g + 1) * blocks_per_table]),
            jnp.asarray(quants[g]), 128, interpret=True))
        for g in range(n_tables)
    ])
    got = decode_stage.dequantize_idct_shift(
        torch.from_numpy(coeffs), torch.from_numpy(quants), blocks_per_table, 128,
        kernels.transform_matrix(torch.device("cpu")),
    ).numpy()
    _assert_k1_close(got, want)


@pytest.mark.parametrize("level_shift", [128, 2048])
@pytest.mark.parametrize("n", [4, 2, 1])
def test_plain_scaled_matches_jax_scaled(n, level_shift):
    """Against the JAX package's reduced IDCT, at the magnitudes of a real
    decode (dequantized coefficients up to 2048). At n = 2 the folded
    matrix's entries are all +-fl(1/8) = +-0.99999994/8, so about one
    sample in eight lies within rounding noise of a .5 tie, and two sum
    orders round a share of those apart: every differing sample must be
    such a near tie."""
    rng = np.random.default_rng(10 + n)
    coeffs = rng.integers(-64, 64, size=(3 * 70, 64)).astype(np.int16)
    quants = rng.integers(1, 32, size=(3, 64)).astype(np.int32)
    want = np.concatenate([
        ref_stage.dequantize_idct_shift_scaled(
            coeffs[g * 70 : (g + 1) * 70], quants[g], level_shift, n)
        for g in range(3)
    ])
    got = decode_stage.dequantize_idct_shift(
        torch.from_numpy(coeffs), torch.from_numpy(quants), 70, level_shift,
        kernels.transform_matrix(torch.device("cpu"), n),
    ).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape == (210, n, n)
    d = np.abs(got.astype(np.int64) - want)
    exact = (coeffs.astype(np.float64) * np.repeat(quants, 70, axis=0)) @ \
        ref_stage.scaled_folded_matrix(n).astype(np.float64)
    near_tie = np.abs(exact - np.floor(exact) - 0.5).reshape(got.shape) < 1e-3
    assert d.max() <= 1 and not (d > 0)[~near_tie].any()
    if n != 2:
        assert (d > 0).mean() <= 1e-3, (d > 0).mean()


@pytest.mark.parametrize("n", [8, 4, 2, 1])
def test_scaled_matrix_equals_jax_package(n):
    ours = kernels.transform_matrix(torch.device("cpu"), n)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (64, n * n)
    want = (pallas_kernels.fused_transform_matrix() if n == 8
            else ref_stage.scaled_folded_matrix(n))
    np.testing.assert_array_equal(ours.numpy(), want)


@pytest.mark.parametrize("scale_n", [8, 4, 1])
def test_wrapper_with_tables_takes_plain_version(scale_n):
    coeffs, quants = _k1_inputs(3, 20, seed=30)
    c = torch.from_numpy(coeffs).reshape(3, 4, 5, 64)
    before = kernels.dequantize_idct_shift.launches
    got = kernels.dequantize_idct_shift(c, torch.from_numpy(quants), 128,
                                        blocks_per_table=20, scale_n=scale_n)
    assert kernels.dequantize_idct_shift.launches == before
    assert got.shape == (3, 4, 5, scale_n, scale_n) and got.dtype == torch.int32
    want = decode_stage.dequantize_idct_shift(
        torch.from_numpy(coeffs), torch.from_numpy(quants), 20, 128,
        kernels.transform_matrix(torch.device("cpu"), scale_n))
    assert torch.equal(got.reshape(60, scale_n, scale_n), want)


@pytest.mark.parametrize("kwargs,err", [
    ({}, "blocks_per_table"),                          # several tables, no block count
    ({"blocks_per_table": 10}, "do not cover"),        # 3 x 10 < 60 blocks
    ({"blocks_per_table": 20, "scale_n": 3}, "scale_n"),
])
def test_wrapper_rejects_bad_table_layouts(kwargs, err):
    coeffs, quants = _k1_inputs(3, 20, seed=31)
    with pytest.raises(ValueError, match=err):
        kernels.dequantize_idct_shift(torch.from_numpy(coeffs), torch.from_numpy(quants),
                                      128, **kwargs)


# --- decode_batch_rgb and the grouped stream --------------------------------


def _image(h, w, seed, sigma=18.0):
    rng = np.random.default_rng(seed)
    return np.clip(
        np.linspace(0, 255, w)[None, :, None] + np.linspace(0, 60, h)[:, None, None]
        + rng.normal(0, sigma, (h, w, 3)), 0, 255,
    ).astype(np.uint8)


def _assert_contract(got, want):
    got = np.asarray(got).astype(np.int64)
    want = np.asarray(want).astype(np.int64)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= 2 and (d > 0).sum() <= d.size * 1e-4, (d.max(), (d > 0).sum())


def _single(data, scale=1.0):
    """The port's single-image device path, as [H, W, 3] numpy."""
    res = jtt.decode(data, sparse_direct=True)
    res.prepack()
    return np.moveaxis(jtt.to_rgb8_device(res, device="cpu", scale=scale).numpy(), 0, -1)


def _rgb_coded(seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
    enc = JpegEncoder()
    enc.set_quantization_table(scale_by_quality(standard_luminance_table(0), 95))
    enc.set_huffman_table(True, 0, huffman_standard.dc_luminance())
    enc.set_huffman_table(False, 0, huffman_standard.ac_luminance())
    for cid in (0x52, 0x47, 0x42):  # 'R', 'G', 'B' component ids
        enc.add_component(cid, 0, 0, 0, 1, 1)
    enc.set_input([img[..., i] for i in range(3)])
    return enc.encode()


BATCHES = {
    # same geometry, own quant tables: a per-CTA table load would mix them
    "mixed_quality": lambda: [jt.encode_rgb(_image(96, 128, 1), q) for q in (90, 25, 60)],
    # same geometry, different AC buckets: re-bucketed into one stacked call
    "mixed_ac_density": lambda: [
        jt.encode_rgb(np.full((64, 64, 3), 128, np.uint8), 95),
        jt.encode_rgb(np.random.default_rng(9).integers(0, 256, (64, 64, 3), dtype=np.uint8), 95),
    ],
    "two_geometries": lambda: [
        jt.encode_rgb(_image(80, 96, 2), 75), jt.encode_rgb(_image(72, 104, 3), 75),
        jt.encode_rgb(_image(80, 96, 4), 80, subsampling="444"),
        jt.encode_gray(_image(80, 96, 5)[..., 0], 75), jt.encode_rgb(_image(80, 96, 6), 70),
    ],
    # the v1 plane-order wire: streams the fused scan declines
    "progressive_and_arithmetic": lambda: [
        jt.encode_rgb(_image(64, 80, 7), 80, arithmetic=True),
        encode_progressive_rgb(_image(64, 80, 8), 60),
        jt.encode_rgb(_image(64, 80, 9), 50, arithmetic=True),
    ],
}


@pytest.fixture(scope="module", params=sorted(BATCHES))
def batch(request):
    return BATCHES[request.param]()


def test_batch_matches_single_path_and_host(batch):
    outs = jtt.decode_batch_rgb(batch, device="cpu")
    assert len(outs) == len(batch)
    for got, data in zip(outs, batch):
        assert isinstance(got, np.ndarray) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, _single(data))
        _assert_contract(got, jt.decode(data).to_rgb8())


def test_batch_matches_jax_batch(batch):
    for got, want in zip(jtt.decode_batch_rgb(batch, device="cpu", max_workers=2),
                         ref_batch.decode_batch_rgb(batch)):
        _assert_contract(got, want)


@pytest.mark.parametrize("scale", [0.5, 0.25, 0.125])
def test_batch_scaled_matches_single_path_and_host(request, batch, scale):
    """Equal to the single-image path; against the host transform, the
    JAX package's own scaled contract (at most 2 levels on under 5% of the
    values). The share is not bounded on the uniform-noise image of
    "mixed_ac_density": at 1/4 (n = 2) its q95 chroma sits on near .5 ties
    (see test_plain_scaled_matches_jax_scaled), so 3-6% of its chroma
    samples round apart from numpy's sum order, each spread over 4 pixels."""
    noise = request.node.callspec.params["batch"] == "mixed_ac_density"
    outs = jtt.decode_batch_rgb(batch, device="cpu", scale=scale)
    for j, (got, data) in enumerate(zip(outs, batch)):
        res = jt.decode(data)
        n = int(8 * scale)
        assert got.shape == (-(-res.height * n // 8), -(-res.width * n // 8), 3)
        np.testing.assert_array_equal(got, _single(data, scale))
        d = np.abs(got.astype(np.int64) - res.to_rgb8_scaled(scale))
        assert d.max() <= 2
        if not (noise and j == 1):
            assert (d > 0).mean() < 0.05, (d > 0).mean()


def test_batch_one_stacked_call_per_geometry(monkeypatch):
    """One stacked transform per group, whatever the AC buckets."""
    from jpeglibrary_tpu_torch.parallel import batch as port_batch

    calls = []
    real = port_batch.transform_mcu2

    def spy(stacked, quants, geometry, device, **kw):
        calls.append(tuple(stacked.shape))
        return real(stacked, quants, geometry, device, **kw)

    monkeypatch.setattr(port_batch, "transform_mcu2", spy)
    datas = BATCHES["mixed_ac_density"]() + BATCHES["mixed_quality"]()
    jtt.decode_batch_rgb(datas, device="cpu")
    assert [c[0] for c in calls] == [2, 3]


def test_batch_host_writers_for_rgb_coded_and_lossless():
    rgb_coded = _rgb_coded(7)
    lossless = jt.encode_lossless(_image(40, 56, 8))
    ycc = jt.encode_rgb(_image(64, 80, 9), 75)
    datas = [rgb_coded, lossless, ycc, rgb_coded]
    assert jt.decode(rgb_coded).color_transform == "rgb"
    for scale in (1.0, 0.5):
        outs = jtt.decode_batch_rgb(datas, device="cpu", scale=scale)
        f = int(1 / scale)
        want_rgb = jt.decode(rgb_coded)
        want_rgb = want_rgb.to_rgb8() if scale == 1 else want_rgb.to_rgb8_scaled(scale)
        np.testing.assert_array_equal(outs[0], want_rgb)
        np.testing.assert_array_equal(outs[3], want_rgb)
        np.testing.assert_array_equal(outs[1], jt.decode(lossless).to_rgb8()[::f, ::f])
        np.testing.assert_array_equal(outs[2], _single(ycc, scale))


@pytest.mark.parametrize("kwargs,err", [({"mesh": object()}, "mesh"), ({"scale": 0.3}, "scale")])
def test_batch_guards(kwargs, err):
    with pytest.raises(ValueError, match=err):
        jtt.decode_batch_rgb([jt.encode_rgb(_image(16, 16, 1), 75)], device="cpu", **kwargs)


def _stream_datas():
    return [jt.encode_rgb(_image(80, 96, 20 + i), q) for i, q in enumerate((90, 50, 25, 75, 60))]


@pytest.mark.parametrize("group,device_workers", [(1, 1), (2, 2), (4, 1), (8, 3)])
def test_grouped_stream_equals_single_path(group, device_workers):
    datas = _stream_datas()
    outs = list(jtt.decode_stream_rgb(datas, device="cpu", group=group, depth=2,
                                      device_workers=device_workers))
    assert len(outs) == len(datas)
    for got, data in zip(outs, datas):
        assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
        np.testing.assert_array_equal(np.moveaxis(got.numpy(), 0, -1), _single(data))


@pytest.mark.parametrize("scale", [0.5, 0.25, 0.125])
def test_grouped_stream_scaled(scale):
    datas = _stream_datas()[:3]
    grouped = list(jtt.decode_stream_rgb(datas, device="cpu", group=3, scale=scale))
    single = list(jtt.decode_stream_rgb(datas, device="cpu", scale=scale))
    for g, s, data in zip(grouped, single, datas):
        assert torch.equal(g, s)
        np.testing.assert_array_equal(np.moveaxis(g.numpy(), 0, -1), _single(data, scale))


def test_stream_mixed_group_falls_back_per_image():
    """A group of mixed geometries and wires (v2, delta-wire arithmetic,
    lossless) decodes image by image; lossless comes back as a tensor."""
    lossless = jt.encode_lossless(_image(40, 56, 30))
    datas = [jt.encode_rgb(_image(64, 80, 31), 75),
             jt.encode_rgb(_image(64, 80, 32), 75, arithmetic=True), lossless]
    outs = list(jtt.decode_stream_rgb(datas, device="cpu", group=3))
    assert all(isinstance(o, torch.Tensor) for o in outs)
    np.testing.assert_array_equal(np.moveaxis(outs[0].numpy(), 0, -1), _single(datas[0]))
    np.testing.assert_array_equal(np.moveaxis(outs[1].numpy(), 0, -1), _single(datas[1]))
    np.testing.assert_array_equal(np.moveaxis(outs[2].numpy(), 0, -1),
                                  jt.decode(lossless).to_rgb8())


def test_grouped_stream_rgb_coded_raises():
    data = _rgb_coded(8)
    with pytest.raises(ValueError, match="rgb"):
        list(jtt.decode_stream_rgb([data, data], device="cpu", group=2))

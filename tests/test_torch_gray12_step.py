"""PyTorch port, ``parallel.sharding.gray_step``: the re-encoding step of a
batch of one-component frames at 12 (and 8) bits, a CT series a step.

On the CPU the step runs its kernels' plain versions: it is held to the
plain float64 reference of the benchmark's CT cell
(``jpegbench/reference/recompress_gray12.py``, which imports nothing of
the port) on seeded frames and random coefficients at small sizes, ragged
block grids among them: the samples within one level on at most the share
the benchmark's limit allows, the histograms exact against the reference's
count of the step's own requantised blocks; planted extremes give DC
category 15 and AC size 14; precision 8 runs through the same step; the
JAX package's 12-bit transforms (its IDCT at level shift 2048, its
forward transform at 2048) agree with the step; the wrappers refuse what
the kernels do not take; the sharded step's chains and histograms equal
the whole step's, in one process and in two gloo ranks.

The tests marked ``cuda`` need the card and skip without one: K1's uint16
plane store equals K1's int32 blocks through the plain tail, and K2's
uint16 load equals its int32 load, byte for byte, at the benchmark cell's
shape and two ragged ones; ``gray_step`` on the card within the cell's
limits with one launch of each kernel. They import no JAX, so the card
runs them without this directory's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_gray12_step.py
"""

import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jpegbench.reference import recompress_gray12 as reference
from jpeglibrary_tpu_torch.host.syntax.quantization import (
    scale_by_quality,
    standard_luminance_table,
)
from jpeglibrary_tpu_torch.ops import decode_stage, kernels
from jpeglibrary_tpu_torch.parallel import sharding

ROOT = pathlib.Path(__file__).resolve().parent.parent
LIMITS = json.loads((ROOT / "jpegbench/limits/recompress_ct12_b512.json").read_text())
CELL = (512, 64, 64)  # the benchmark cell's series: 512 slices of 64 x 64 blocks
RAGGED = [(3, 5, 7), (2, 13, 33)]


def _table(quality=90) -> torch.Tensor:
    """The Annex K luminance table at IJG ``quality``, int32 zig-zag."""
    elements = scale_by_quality(standard_luminance_table(), quality).elements
    return torch.from_numpy(elements.astype(np.int32))


def _frames(seed, b, hb, wb, bits=12) -> torch.Tensor:
    """int32 [b, 8 hb, 8 wb] samples of ``bits`` bits: smooth regions of
    random levels, hard edges between them and noise, clipped to range."""
    rng = np.random.default_rng(seed)
    h, w = 8 * hb, 8 * wb
    top = (1 << bits) - 1
    coarse = rng.uniform(0, top, (b, hb // 2 + 2, wb // 2 + 2))
    levels = np.kron(coarse, np.ones((16, 16)))[:, :h, :w]
    noise = rng.normal(0, 15 * top / 4095, (b, h, w))
    return torch.from_numpy(np.clip(np.round(levels + noise), 0, top).astype(np.int32))


def _coefficients(seed, b, hb, wb, q, bits=12, kind="frames") -> torch.Tensor:
    """int16 [b, hb, wb, 64]: the quantised blocks of seeded frames, or
    random coefficients (whose decode leaves the range and is clamped)."""
    if kind == "frames":
        return reference.encode(_frames(seed, b, hb, wb, bits), q, bits)
    rng = np.random.default_rng(seed)
    c = np.round(rng.laplace(0, 40, (b, hb, wb, 64)) / (1 + np.arange(64) / 8))
    c[..., 0] = rng.integers(-5 << bits, 5 << bits, (b, hb, wb)) // q[0].item()
    return torch.from_numpy(c.astype(np.int16))


def _check(coeffs, q, bits, out):
    """The step's outputs against the reference: their types, the samples
    within one level on at most the cell's share, the requantised blocks
    within one of the reference's re-encode of the step's own samples, the
    histograms exact on the step's own blocks."""
    samples, requant, hists = out
    b, hb, wb, _ = coeffs.shape
    assert samples.dtype == torch.uint16 and tuple(samples.shape) == (b, 8 * hb, 8 * wb)
    assert requant.dtype == torch.int16 and requant.shape == coeffs.shape
    assert hists.dtype == torch.int32 and tuple(hists.shape) == (2, 256)
    want = reference.decode(coeffs, q, bits)
    assert int((samples.to(torch.int32) - want).abs().max()) <= 1
    numbers = reference.judge((coeffs, q), out, bits)
    assert numbers["sample_diff_share"] <= LIMITS["sample_diff_share"], numbers
    assert numbers["hist_bins_off"] == 0
    again = reference.encode(samples.to(torch.int32), q, bits)
    assert int((requant.to(torch.int32) - again.to(torch.int32)).abs().max()) <= 1
    own = torch.stack(reference.histograms(requant))
    assert torch.equal(hists.to(torch.int64), own)
    return numbers


@pytest.mark.parametrize("b,hb,wb,kind,quality", [
    (3, 5, 7, "frames", 90),
    (2, 8, 8, "frames", 75),
    (4, 3, 9, "random", 90),
    (1, 13, 33, "random", 50),
])
def test_step_matches_reference(b, hb, wb, kind, quality):
    q = _table(quality)
    coeffs = _coefficients(7 * b + hb, b, hb, wb, q, kind=kind)
    out = sharding.gray_step(coeffs, q, device="cpu")
    _check(coeffs, q, 12, out)
    if kind == "random":  # the decode leaves the range on both sides
        want = reference.decode(coeffs, q)
        assert (want == 0).any() and (want == 4095).any()


def _extremes():
    """Frames of full swings, 0 against 4095: flat blocks at either end
    beside each other (DC steps of +-32,760 at q = 1: category 15) and
    blocks split down the middle (a first horizontal AC of about 14,850:
    size 14)."""
    s = np.zeros((2, 16, 32), dtype=np.int32)
    s[0, :8, :8] = 4095  # block (0, 0) at the top, (0, 1) at the bottom
    s[0, :8, 16:20] = 4095  # block (0, 2) split down the middle
    s[1, 8:, 8:16] = 4095
    s[1, 8:, 28:32] = 4095
    return torch.from_numpy(s)


def test_extremes_reach_dc_category_15_and_ac_size_14():
    q = torch.ones(64, dtype=torch.int32)
    coeffs = reference.encode(_extremes(), q)
    out = sharding.gray_step(coeffs, q, device="cpu")
    _check(coeffs, q, 12, out)
    dc, ac = out[2].to(torch.int64)
    assert dc[15] > 0 and dc[16:].sum() == 0
    sizes = torch.arange(256) & 15
    assert ac[sizes == 14].sum() > 0 and ac[sizes == 15].sum() == 0


@pytest.mark.parametrize("kind", ["frames", "random"])
def test_precision_8_through_the_same_step(kind):
    q = _table(75)
    coeffs = _coefficients(11, 3, 5, 7, q, bits=8, kind=kind)
    out = sharding.gray_step(coeffs, q, precision=8, device="cpu")
    _check(coeffs, q, 8, out)
    assert int(out[0].to(torch.int32).max()) <= 255


def test_jax_package_transforms_at_12_bits():
    """The JAX package's 12-bit decode transform (its butterfly IDCT at
    level shift 2048) and forward transform (level shift 2048) agree with
    the step within one level, on few samples and coefficients."""
    from torch_reference_native import settle

    settle()  # the JAX package's native scanner, built once under its lock
    from jpeglibrary_tpu.ops import decode_stage as ref_decode_stage
    from jpeglibrary_tpu.ops import encode_stage as ref_encode_stage

    q = _table(90)
    coeffs = _coefficients(5, 3, 5, 7, q)
    samples, requant, _ = sharding.gray_step(coeffs, q, device="cpu")
    qn, n = q.numpy(), samples.numel()
    off_s = off_r = 0
    for i in range(coeffs.shape[0]):
        blocks = ref_decode_stage.dequantize_idct_shift(coeffs[i].numpy(), qn, 2048)
        want = np.clip(ref_decode_stage.blocks_to_plane(blocks), 0, 4095)
        d = np.abs(samples[i].numpy().astype(np.int32) - want)
        assert d.max() <= 1
        off_s += int((d != 0).sum())
        plane = samples[i].numpy().astype(np.int32)
        want_r = ref_encode_stage.fdct_quantize(plane, qn, level_shift=2048)
        d = np.abs(requant[i].numpy().astype(np.int32) - want_r)
        assert d.max() <= 1
        off_r += int((d != 0).sum())
    assert off_s / n <= LIMITS["sample_diff_share"] and off_r / n <= LIMITS["requant_diff_share"]


@pytest.mark.parametrize("call,error", [
    (lambda c, q: kernels.dequantize_idct_plane(c.to(torch.int32), q, 12), TypeError),
    (lambda c, q: kernels.dequantize_idct_plane(c[0], q, 12), ValueError),
    (lambda c, q: kernels.dequantize_idct_plane(c, q[None], 12), ValueError),
    (lambda c, q: kernels.dequantize_idct_plane(c, q, 10), ValueError),
    (lambda c, q: kernels.fdct_quantize(torch.zeros((16, 16), dtype=torch.uint16), q, 2048,
                                        hs=2, vs=2), ValueError),
], ids=["k1_int32", "k1_3d", "k1_tables", "k1_precision", "k2_u16_box"])
def test_wrappers_refuse(call, error):
    coeffs = torch.zeros((1, 2, 2, 64), dtype=torch.int16)
    with pytest.raises(error):
        call(coeffs, _table())


def test_chains_cut_into_stripes_equal_the_whole():
    """``_gray_step`` on two stripes of block rows, the second taking the
    first's last DCs through ``chain_prev``: the same samples, blocks and
    (summed) histograms as the whole step; without the exchange the
    second stripe's chains start from 0 and the DC counts differ."""
    q = _table(90)
    coeffs = _coefficients(9, 3, 6, 7, q)
    whole = sharding.gray_step(coeffs, q, device="cpu")
    k = (kernels.dequantize_idct_plane, kernels.fdct_quantize)
    top = sharding._gray_step(coeffs[:, :3], q, 12, *k)
    last = top[1][:, -1, -1, 0].to(torch.int32)
    bottom = sharding._gray_step(coeffs[:, 3:], q, 12, *k, chain_prev=lambda _: last)
    assert torch.equal(torch.cat([top[0], bottom[0]], dim=1), whole[0])
    assert torch.equal(torch.cat([top[1], bottom[1]], dim=1), whole[1])
    assert torch.equal(top[2] + bottom[2], whole[2])
    alone = sharding._gray_step(coeffs[:, 3:], q, 12, *k)
    assert not torch.equal(top[2][0] + alone[2][0], whole[2][0])


def test_sharded_gray_step_in_two_ranks():
    """``make_sharded_gray_step`` over meshes (2, 1) and (1, 2) of two gloo
    CPU ranks: every rank's full outputs equal ``gray_step``'s."""
    import torch_mesh_workers as workers

    from jpeglibrary_tpu_torch.parallel import distributed

    q = _table(90)
    coeffs = _coefficients(4, 2, 6, 5, q)
    ranks = distributed.spawn(workers.sharded_gray_steps, 2, [(2, 1), (2, 2)], coeffs.numpy(),
                              q.numpy(), backend="gloo", timeout=180)
    single = [x.numpy() for x in sharding.gray_step(coeffs, q, device="cpu")]
    for rank in ranks:
        for shape, got in rank.items():
            for g, s in zip(got, single):
                assert g.dtype == s.dtype
                np.testing.assert_array_equal(g, s)


# --- On the card ----------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1's plane store and K2's uint16 load run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_coefficients(shape, seed, device) -> torch.Tensor:
    """Random int16 coefficients at a 12-bit frame's scale, made on the
    card; their decode is clamped now and then on both sides."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = torch.randn((*shape, 64), generator=g, device=device) * 60
    c = c / (1 + torch.arange(64, device=device) / 8)
    c[..., 0] = torch.randint(-2800, 2800, shape, generator=g, device=device)
    return c.round().to(torch.int16)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [CELL, *RAGGED], ids=["cell", "ragged_5x7", "ragged_13x33"])
@pytest.mark.parametrize("precision", [12, 8])
def test_card_plane_store_and_uint16_load_are_byte_exact(card, shape, precision):
    q = _table(90).to(card)
    coeffs = _card_coefficients(shape, 20 + shape[1], card)
    if precision == 8:
        coeffs = (coeffs // 16).to(torch.int16)
    b, hb, wb = shape
    got = kernels.dequantize_idct_plane(coeffs, q, precision)
    blocks = kernels.dequantize_idct_shift(coeffs, q, 1 << (precision - 1))
    want = decode_stage.clamp_plane_u16(blocks.reshape(b, hb, wb, 8, 8), precision)
    assert got.dtype == torch.uint16 and torch.equal(got, want)
    plane = got.view(b * hb * 8, wb * 8)
    k2 = [kernels.fdct_quantize(p, q, 1 << (precision - 1), blocks=(b * hb, wb))
          for p in (plane, plane.to(torch.int32))]
    torch.cuda.synchronize()
    assert torch.equal(k2[0], k2[1])


@pytest.mark.cuda
def test_card_gray_step_within_the_cell_limits(card):
    q = _table(90).to(card)
    frames = torch.cat([_frames(s, 64, 64, 64).to(card) for s in range(8)])
    coeffs = reference.encode(frames, q)
    before = (kernels.dequantize_idct_plane.launches, kernels.fdct_quantize.launches,
              kernels.symbol_histograms.launches)
    out = sharding.gray_step(coeffs, q, device=card)
    after = (kernels.dequantize_idct_plane.launches, kernels.fdct_quantize.launches,
             kernels.symbol_histograms.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    numbers = reference.judge((coeffs, q), out)
    assert numbers["hist_bins_off"] == 0
    for name, limit in LIMITS.items():
        assert numbers[name] <= limit, (name, numbers)

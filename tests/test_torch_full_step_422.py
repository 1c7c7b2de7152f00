"""PyTorch port, ``parallel.sharding.full_step`` at 4:2:2 (the chroma halved
across only: luma [B, Hb, Wb, 64], each chroma [B, Hb, Wb/2, 64]).

On the CPU the step runs its kernels' plain versions: it is held to the
plain float64 reference of the benchmark's 4:2:2 cell
(``jpegbench/reference/recompress_422.py``, which imports nothing of the
port) on seeded photographs and random coefficients at small sizes (odd
MCU rows and columns, MCU rows that are no whole number of K6's strips),
within the cell's limits and with the luma's histograms exact against the
reference's count of the step's own requantised blocks; K5's (2, 1) luma
walk (plain version, CPU model and wrapper) equals the host gather of the
blocks laid out in MCU order by hand; the 4:2:0 step equals its chain with
every factor spelled out; other samplings raise; the sharded step over two
gloo ranks equals the whole step.

The test marked ``cuda`` needs the card and skips without one:
``full_step`` on a 4:2:2 batch launches K1, K6, K2 and K5 3, 1, 3 and 2
times, K6 and K2 at the 2x1 box, within the cell's limits. It imports no
JAX, so the card runs it without this directory's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_full_step_422.py
"""

import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jpegbench.generators import coefficients, coefficients422, content
from jpegbench.reference import recompress_422 as reference
from jpegbench.reference import tables
from jpeglibrary_tpu_torch.host.ops import encode_stage as host_encode_stage
from jpeglibrary_tpu_torch.ops import color, encode_stage, kernels
from jpeglibrary_tpu_torch.parallel import sharding

ROOT = pathlib.Path(__file__).resolve().parent.parent
LIMITS = json.loads((ROOT / "jpegbench/limits/recompress_24mp_422_b4.json").read_text())
PLAIN = {"k1": kernels.dequantize_idct_shift, "k2": kernels.fdct_quantize,
         "k5": encode_stage.symbol_histograms_plain, "k6": color.round_trip_plain}


def _tables(quality=95):
    return tuple(torch.from_numpy(q) for q in tables.quant_tables_zz(quality))


def _inputs(seed, b, hb, wb, kind="photo", quality=95):
    """(y, cb, cr, qy, qc) of a 4:2:2 batch of ``b`` images of ``hb`` x
    ``wb`` luma blocks: a seeded photograph's quantised planes, or random
    coefficients whose decode leaves [0, 255] and is clamped."""
    qy, qc = _tables(quality)
    if kind == "photo":
        rgb = content.photo(torch.Generator().manual_seed(seed), b, 8 * hb, 8 * wb)
        return (*coefficients422.quantised_planes(rgb, qy, qc), qy, qc)
    rng = np.random.default_rng(seed)
    planes = []
    for shape in ((b, hb, wb), (b, hb, wb // 2), (b, hb, wb // 2)):
        c = np.round(rng.laplace(0, 12, shape + (64,)) / (1 + np.arange(64) / 8))
        c[..., 0] = rng.integers(-160, 160, shape)
        planes.append(torch.from_numpy(c.astype(np.int16)))
    return (*planes, qy, qc)


# (images, luma block rows, luma block columns): odd MCU rows and columns;
# MCU rows of 11, 17 and 5 MCUs, none a whole number of K6's 16-MCU strips.
SHAPES = [(2, 5, 22), (1, 3, 34), (3, 7, 10)]
IDS = ["x".join(map(str, s)) for s in SHAPES]


@pytest.mark.parametrize("kind", ["photo", "random"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_step_with_plain_versions_matches_the_reference(shape, kind):
    """``_step`` with the plain versions of K1, K2, K5 and K6 against the
    cell's reference: RGB within one level on at most the cell's share, the
    requantised luma and chroma within the cell's share, the luma's
    histograms exact against the reference's (2, 1) walk of the step's own
    blocks, and ``full_step`` the same outputs."""
    inputs = _inputs(sum(shape), *shape, kind=kind)
    rgb, (ry, rcb, rcr), hists = sharding._step(*inputs, **PLAIN)
    numbers = reference.judge(inputs, (rgb, ry, hists))
    assert numbers["luma_hist_bins_off"] == 0
    for name, limit in LIMITS.items():
        assert numbers[name] <= limit, (name, numbers)
    want_rgb, want = reference._chunk(*inputs, "float64")
    assert int((rgb.to(torch.int32) - want_rgb.to(torch.int32)).abs().max()) <= 1
    for got_c, want_c in zip((rcb, rcr), want[1:]):
        assert got_c.shape == want_c.shape
        assert int((got_c != want_c).sum()) <= LIMITS["requant_diff_share"] * got_c.numel()
    whole = sharding.full_step(*inputs, device="cpu")
    assert torch.equal(whole[0], rgb) and torch.equal(whole[1], ry)
    assert torch.equal(whole[2], hists)


def _gather_in_mcu_order(plane, h, v):
    """[B, Hb, Wb, 64] numpy blocks -> one [Hb Wb, 64] chain an image, laid
    out by hand in the order of an interleaved scan's (h, v) MCUs."""
    b, hb, wb, _ = plane.shape
    return [np.stack([plane[i, my * v + r, mx * h + c]
                      for my in range(hb // v) for mx in range(wb // h)
                      for r in range(v) for c in range(h)]) for i in range(b)]


@pytest.mark.parametrize("version", ["plain", "model", "wrapper"])
@pytest.mark.parametrize("shape", [(2, 3, 6), (1, 5, 22)], ids=["2x3x6", "1x5x22"])
def test_luma_walk_2x1_equals_the_host_gather(shape, version):
    """K5's luma walk at (2, 1) (its plain version, its CPU model of the
    kernel's tile walk, and the wrapper, which takes the plain version on
    the CPU) equals the host gather of the blocks laid out in (2, 1) MCU
    order by hand, one DC chain an image."""
    fn = {"plain": encode_stage.symbol_histograms_plain,
          "model": encode_stage.symbol_histograms_model,
          "wrapper": kernels.symbol_histograms}[version]
    plane = _inputs(7, *shape, kind="random")[0]
    dc, ac = fn(plane, mcu=(2, 1))
    want_dc, want_ac = np.zeros(256, np.int64), np.zeros(256, np.int64)
    for chain in _gather_in_mcu_order(plane.numpy(), 2, 1):
        d, a = host_encode_stage.dc_ac_symbol_frequencies(chain)
        want_dc += d
        want_ac += a
    np.testing.assert_array_equal(dc.numpy(), want_dc)
    np.testing.assert_array_equal(ac.numpy(), want_ac)


def test_420_step_is_its_chain_with_the_factors_spelled_out():
    """A 4:2:0 batch through ``full_step`` equals the chain composed here with
    every factor written out: K1 on each component, the plain colour round
    trip, K2 with the chroma's 2x2 box, K5 with the luma's (2, 2) walk."""
    qy, qc = _tables(75)
    rgb = content.photo(torch.Generator().manual_seed(5), 2, 48, 80)
    y, cb, cr = coefficients.quantised_planes(rgb, qy, qc)
    got = sharding.full_step(y, cb, cr, qy, qc, device="cpu")
    samples = [kernels.dequantize_idct_shift(c.contiguous(), q, 128)
               for c, q in ((y, qy), (cb, qc), (cr, qc))]
    want_rgb, y2, cb2, cr2 = color.round_trip_plain(*samples)
    ry = sharding._fdct_quantize_batch(y2, qy)
    rcb, rcr = (sharding._fdct_quantize_batch(c, qc, hs=2, vs=2) for c in (cb2, cr2))
    hists = torch.stack([*encode_stage.symbol_histograms_plain(ry, mcu=(2, 2)),
                         *encode_stage.symbol_histograms_plain((rcb, rcr))])
    assert torch.equal(got[0], want_rgb) and torch.equal(got[1], ry)
    assert torch.equal(got[2], hists)


@pytest.mark.parametrize("chroma", [(2, 4, 8), (2, 2, 8), (2, 4, 2), "mixed"],
                         ids=["1x1", "1x2", "4x1", "mixed"])
def test_full_step_refuses_other_samplings(chroma):
    qy, qc = _tables()
    y = torch.zeros((2, 4, 8, 64), dtype=torch.int16)
    if chroma == "mixed":  # Cb at 4:2:2, Cr at 4:2:0
        cb, cr = torch.zeros((2, 4, 4, 64), dtype=torch.int16), torch.zeros(
            (2, 2, 4, 64), dtype=torch.int16)
    else:
        cb = cr = torch.zeros(chroma + (64,), dtype=torch.int16)
    with pytest.raises(ValueError, match="4:2:0|differ"):
        sharding.full_step(y, cb, cr, qy, qc, device="cpu")


def test_sharded_422_step_in_two_ranks():
    """``make_sharded_full_step`` over meshes (2, 1) and (1, 2) of two gloo
    CPU ranks on a 4:2:2 batch (stripes of 3 MCU rows at (1, 2), the chroma
    rows following at full height): every rank's full outputs equal
    ``full_step``'s."""
    import torch_mesh_workers as workers

    from jpeglibrary_tpu_torch.parallel import distributed

    inputs = _inputs(11, 2, 6, 10, kind="random")
    args = tuple(x.numpy() for x in inputs)
    single = [x.numpy() for x in sharding.full_step(*inputs, device="cpu")]
    (ranks,) = zip(*distributed.spawn(workers.run, 2, [("sharded_steps", ([(2, 1), (2, 2)],
                                                                          args))],
                                      backend="gloo", timeout=180))
    for rank in ranks:
        for shape, got in rank.items():
            assert got["local_rgb"] == ((1, 48, 80, 3) if shape == (2, 1) else (2, 24, 80, 3))
            for g, s in zip(got["outputs"], single):
                assert g.dtype == s.dtype
                np.testing.assert_array_equal(g, s)


# --- On the card ----------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1, K2, K5 and K6 run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_422_step_launches_and_limits(card):
    """``full_step`` on two 4:2:2 images of 1,040 x 768 (65 MCUs a row: 4
    whole strips of K6 and one MCU): 3 K1, 1 K6 at (2, 1), 3 K2 (two at the
    uint8 2x1 box) and 2 K5 launches, within the cell's limits."""
    qy, qc = (t.to(card) for t in _tables())
    rgb = content.photo(torch.Generator(device=card).manual_seed(3), 2, 768, 1040)
    inputs = (*coefficients422.quantised_planes(rgb, qy, qc), qy, qc)
    counters = (kernels.dequantize_idct_shift, kernels.color_round_trip,
                kernels.fdct_quantize, kernels.symbol_histograms)
    before = [c.launches for c in counters]
    k6_box = kernels.color_round_trip.launches_by_box.get((2, 1), 0)
    k2_box = kernels.fdct_quantize.launches_by_box.get((torch.uint8, 2, 1), 0)
    out = sharding.full_step(*inputs, device=card)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [3, 1, 3, 2]
    assert kernels.color_round_trip.launches_by_box[(2, 1)] - k6_box == 1
    assert kernels.fdct_quantize.launches_by_box[(torch.uint8, 2, 1)] - k2_box == 2
    numbers = reference.judge(inputs, out)
    assert numbers["luma_hist_bins_off"] == 0
    for name, limit in LIMITS.items():
        assert numbers[name] <= limit, (name, numbers)

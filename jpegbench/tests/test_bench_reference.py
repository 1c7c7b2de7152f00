"""The plain reference against the program on the CPU at tiny shapes, its
pieces against the standard's definitions, and the control: the
reference one precision below the configuration's, in the program's
place, fails the comparison that the program passes."""

import json

import numpy as np
import pytest
import torch

from conftest import ROOT
from jpegbench.generators import coefficients, content
from jpegbench.reference import recompress as ref
from jpegbench.reference import tables


def _inputs(kind="histology", quality=75, n=2, h=256, w=256, seed=3):
    g = torch.Generator().manual_seed(seed)
    qy, qc = (torch.from_numpy(q) for q in tables.quant_tables_zz(quality))
    y, cb, cr = coefficients.quantised_planes(content.KINDS[kind](g, n, h, w), qy, qc)
    return y, cb, cr, qy, qc


def _limits(workload):
    return json.loads((ROOT / f"jpegbench/limits/{workload}.json").read_text())


CASES = [("histology", 75, 2, 128, 160, "recompress_16mp_b4"),
         ("photo", 90, 3, 75, 100, "recompress_imagenet_b256")]


@pytest.mark.parametrize("kind,quality,n,h,w,workload", CASES, ids=["hetissue", "imagenet"])
def test_full_step_agrees_with_the_reference(kind, quality, n, h, w, workload):
    from jpeglibrary_tpu_torch.parallel.sharding import full_step

    inputs = _inputs(kind, quality, n, h, w)
    numbers = ref.judge(inputs, full_step(*inputs, device="cpu"))
    limits = _limits(workload)
    assert set(numbers) >= set(limits)
    assert all(numbers[k] <= limits[k] for k in limits), numbers
    assert numbers["luma_hist_bins_off"] == 0


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("kind,quality,n,h,w,workload", CASES, ids=["hetissue", "imagenet"])
def test_control_is_not_correct(kind, quality, n, h, w, workload, seed):
    """The reference with its products in TF32 fails each cell's limits at
    a size a test holds, on the cell's content and tables, through the
    comparison that a run makes."""
    inputs = _inputs(kind, quality, n, 2 * h, 2 * w, seed)
    numbers = ref.judge(inputs, ref.step(*inputs, precision="tf32"))
    limits = _limits(workload)
    assert any(numbers[k] > limits[k] for k in limits), numbers


def test_reference_step_judges_itself_exact():
    inputs = _inputs(n=1, h=64, w=96)
    numbers = ref.judge(inputs, ref.step(*inputs))
    assert all(v == 0 for v in numbers.values()), numbers


def test_basis_is_the_orthonormal_dct_with_exact_dc():
    b = tables.BASIS_ZZ
    np.testing.assert_allclose(b @ b.T, np.eye(64), atol=1e-14)
    assert (b[0] == 0.125).all()  # the DC row: a flat block's value is exact
    x = np.random.default_rng(0).normal(size=(5, 64))
    np.testing.assert_allclose((x @ b.T) @ b, x, atol=1e-12)


def test_zigzag_and_tables():
    assert list(tables.ZIGZAG[:10]) == [0, 1, 8, 16, 9, 2, 3, 10, 17, 24]
    assert sorted(tables.ZIGZAG) == list(range(64))
    qy, qc = tables.quant_tables_zz(50)
    assert qy[0] == 16 and qc[0] == 17 and qy[-1] == 99  # Annex K at quality 50
    qy, _ = tables.quant_tables_zz(75)
    assert qy[0] == 8


def test_colour_constants_are_the_programs():
    from jpeglibrary_tpu_torch.ops import color

    assert (tables.CR_R, tables.CR_G, tables.CB_B, tables.CB_G) == (
        color._D1, color._D2, color._D3, color._D4)
    assert (tables.Y_R, tables.Y_G, tables.Y_B) == (color._Y_R, color._Y_G, color._Y_B)
    assert (tables.CB_R_, tables.CB_G_, tables.CB_B_) == (color._CB_R, color._CB_G, color._CB_B)
    assert (tables.CR_R_, tables.CR_G_, tables.CR_B_) == (color._CB_B, color._CR_G, color._CR_B)


def test_colour_conversions_cover_every_value():
    v = torch.arange(256, dtype=torch.int32)
    rgb = torch.stack(torch.meshgrid(v, v, v, indexing="ij"), dim=-1)[::3, ::5].to(torch.uint8)
    y, cb, cr = ref.rgb_to_ycbcr(rgb)
    assert all(int(p.min()) >= 0 and int(p.max()) <= 255 for p in (y, cb, cr))
    back = ref.ycbcr_to_rgb(y, cb, cr).to(torch.int32)
    assert int((back - rgb.to(torch.int32)).abs().max()) <= 3


def test_histograms_against_a_loop():
    rng = np.random.default_rng(5)
    blocks = rng.integers(-40, 40, size=(2, 7, 64)) * (rng.random((2, 7, 64)) < 0.2)
    blocks[0, 3, 1:] = 0  # an empty block
    blocks[1, 2, 1:] = 0
    blocks[1, 2, 40] = 3  # a run of 39 zeros: two ZRLs
    dc, ac = ref.histograms(torch.from_numpy(blocks))
    want_dc, want_ac = np.zeros(256, int), np.zeros(256, int)
    for chain in blocks:
        prev = 0
        for blk in chain:
            want_dc[int(abs(int(blk[0]) - prev)).bit_length()] += 1
            prev = int(blk[0])
            run = 0
            for k in range(1, 64):
                if blk[k] == 0:
                    run += 1
                    continue
                while run > 15:
                    want_ac[0xF0] += 1
                    run -= 16
                want_ac[run << 4 | int(abs(int(blk[k]))).bit_length()] += 1
                run = 0
            if blk[63] == 0:
                want_ac[0] += 1
    assert (dc.numpy() == want_dc).all() and (ac.numpy() == want_ac).all()


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-11, 1 + 3 * 2**-11, -(1 + 3 * 2**-11), 1 + 2**-12])
    want = torch.tensor([1.0, 1 + 2**-10, 1.0, 1 + 2**-9, -(1 + 2**-9), 1.0])
    assert torch.equal(ref.to_tf32(x), want)


def test_generators_make_coefficients_within_range():
    y, cb, cr, _, _ = _inputs("photo", 90, 2, 75, 100)
    assert tuple(y.shape) == (2, 10, 14, 64)  # 75 x 100 padded to 80 x 112
    assert tuple(cb.shape) == (2, 5, 7, 64) and y.dtype == torch.int16
    assert int(y[..., 0].abs().max()) <= 1024


@pytest.mark.parametrize("kind,quality,h,w,low,high", [("histology", 75, 512, 512, 1.25, 1.6),
                                                      ("photo", 90, 375, 500, 3.7, 4.5)])
def test_generators_hold_the_sources_density(kind, quality, h, w, low, high):
    """The scan that the content stands for holds as many bits a pixel as
    the configuration's source: HETissueSlide.jpg about 1.5 with its
    headers and tables, ILSVRC-2012 about 4-5 (calibrate.scan_bits_per_pixel)."""
    from jpegbench.calibrate import scan_bits_per_pixel

    y, cb, cr, _, _ = _inputs(kind, quality, 2, h, w)
    assert low < scan_bits_per_pixel(y, cb, cr, h * w) < high


def test_jpeg420_copy_decodes():
    from jpegbench.generators import jpeg420
    from jpeglibrary_tpu_torch.host.models.decoder import decode

    rgb = jpeg420.synth_image(4, 64)
    res = decode(jpeg420.encode_420(rgb, 75))
    assert (res.width, res.height) == (64, 64)


def _walked_in_mcus(order):
    """K5's chroma walk in 2x2 MCU order instead of raster order."""
    return lambda plane, h, v: order(plane, 2, 2) if (h, v) == (1, 1) else order(plane, h, v)


def _cb_for_cr(chunk):
    """A chroma plane lost: the Cb plane counted in place of the Cr plane."""
    def faulty(*args):
        rgb, (y, cb, _) = chunk(*args)
        return rgb, (y, cb, cb)
    return faulty


@pytest.mark.parametrize("fault", ["chroma_walk_2x2", "cb_for_cr"])
@pytest.mark.parametrize("kind,quality,workload", [c[:2] + c[-1:] for c in CASES],
                         ids=["hetissue", "imagenet"])
def test_chroma_faults_are_not_correct(monkeypatch, kind, quality, workload, fault):
    """A fault on the chroma side alone fails each cell's limits, through
    the histograms that are its only output (at sizes whose chroma has
    whole 2x2 groups of blocks, as both cells' has)."""
    inputs = _inputs(kind, quality, 2, 256, 320)
    with monkeypatch.context() as m:
        if fault == "chroma_walk_2x2":
            m.setattr(ref, "mcu_order", _walked_in_mcus(ref.mcu_order))
        else:
            m.setattr(ref, "_chunk", _cb_for_cr(ref._chunk))
        outputs = ref.step(*inputs)
    numbers = ref.judge(inputs, outputs)
    limits = _limits(workload)
    assert any(numbers[k] > limits[k] for k in limits), numbers

"""PyTorch port, K5 (the symbol statistics) on the CPU, against the JAX
package: ``encode_stage.symbol_histograms_plain`` (K5's plain version) and
``symbol_histograms_model`` (a CPU model of the kernel's per-block
arithmetic) against the JAX ``symbol_histograms_device``, jitted on the
CPU, and the host gather ``dc_ac_symbol_frequencies``, on
``chip_smoke.k5_edge_cases`` (the batch the card holds K5 to) and on
random batches; the same on component planes walked in MCU order in place
(one plane at MCU (1, 1), (2, 1), (1, 2), (2, 2), and two planes whose
chains stack, as ``full_step``'s chroma) against the JAX package's
``_mcu_order_batch`` + ``symbol_histograms_device``, and the step's
histograms against the JAX ``full_step``; then K5's wrapper
``kernels.symbol_histograms``: its dispatch on the CPU and its errors.

Every comparison is exact: the histograms are integer counts."""

import importlib.util
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from jpeglibrary_tpu.ops import encode_stage as ref_encode_stage
from jpeglibrary_tpu.parallel import sharding as ref_sharding
from jpeglibrary_tpu.syntax.quantization import (
    STANDARD_CHROMINANCE_ZIGZAG,
    STANDARD_LUMINANCE_ZIGZAG,
)

from jpeglibrary_tpu_torch.host.ops import encode_stage as host_encode_stage
from jpeglibrary_tpu_torch.ops import _build, encode_stage, kernels
from jpeglibrary_tpu_torch.parallel import sharding

from torch_reference_native import settle

settle()  # the JAX package's native scanner, built once before any test

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _load_smoke()
CASES = {label: case for label, *case in SMOKE.k5_edge_cases()}
VERSIONS = {"plain": encode_stage.symbol_histograms_plain,
            "model": encode_stage.symbol_histograms_model,
            "wrapper": encode_stage.symbol_histograms_device}


def _tensor(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


@jax.jit
def _jax_hists(blocks, n_valid):
    return ref_encode_stage.symbol_histograms_device(blocks, jnp, n_valid=n_valid)


def _jax_reference(blocks, n_valid, prev_dc):
    """The JAX package's histograms. It has no ``prev_dc``: a row with one
    runs as the row with its predecessor block (DC ``prev_dc``, AC zero)
    prepended, less that block's own counts (its DC from 0 and one EOB)."""
    b, n, _ = blocks.shape
    nv = np.full(b, n) if n_valid is None else np.clip(np.asarray(n_valid), 0, n)
    if prev_dc is None:
        dc, ac = _jax_hists(blocks, jnp.asarray(nv))
        return np.asarray(dc), np.asarray(ac)
    lead = np.zeros((b, 1, 64), blocks.dtype)
    lead[:, 0, 0] = prev_dc
    dc, ac = (np.asarray(h).astype(np.int64) for h in _jax_hists(
        np.concatenate([lead, blocks], axis=1), jnp.asarray(np.where(nv > 0, nv + 1, 0))))
    for p, k in zip(prev_dc, nv):
        if k > 0:
            dc[int(abs(int(p))).bit_length()] -= 1
            ac[0] -= 1
    return dc, ac


def _host_gather(blocks, n_valid, prev_dc):
    """The host gather, one chain per row, over each row's valid blocks;
    with ``prev_dc``, the chain with its predecessor block prepended, less
    that block's own counts (the gather of the block alone)."""
    dc = np.zeros(256, np.int64)
    ac = np.zeros(256, np.int64)
    for i, row in enumerate(blocks):
        k = len(row) if n_valid is None else int(np.clip(n_valid[i], 0, len(row)))
        if k == 0:
            continue
        chain = row[:k]
        if prev_dc is not None:
            lead = np.zeros((1, 64), blocks.dtype)
            lead[0, 0] = prev_dc[i]
            lead_dc, lead_ac = host_encode_stage.dc_ac_symbol_frequencies(lead)
            dc -= lead_dc
            ac -= lead_ac
            chain = np.concatenate([lead, chain])
        d, a = host_encode_stage.dc_ac_symbol_frequencies(chain)
        dc += d
        ac += a
    return dc, ac


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == (256,)
        np.testing.assert_array_equal(g.numpy().astype(np.int64), np.asarray(w, np.int64))


@pytest.mark.parametrize("version", sorted(VERSIONS))
@pytest.mark.parametrize("label", sorted(CASES))
def test_edge_cases_match_jax(label, version):
    blocks, n_valid, prev_dc = CASES[label]
    got = VERSIONS[version](torch.from_numpy(blocks), _tensor(n_valid), _tensor(prev_dc))
    _assert_equal(got, _jax_reference(blocks, n_valid, prev_dc))


# The host gather counts bits without the cap of 16, so the int32 case,
# whose values pass 16 bits, is held to the JAX package alone.
HOST_CASES = sorted(label for label, (blocks, _, _) in CASES.items() if blocks.dtype == np.int16)


@pytest.mark.parametrize("version", sorted(VERSIONS))
@pytest.mark.parametrize("label", HOST_CASES)
def test_edge_cases_match_host_gather(label, version):
    blocks, n_valid, prev_dc = CASES[label]
    got = VERSIONS[version](torch.from_numpy(blocks), _tensor(n_valid), _tensor(prev_dc))
    _assert_equal(got, _host_gather(blocks, n_valid, prev_dc))


def test_edge_batch_covers_the_cases():
    """The edge batch holds what it names: int16 extremes, sizes past 16
    bits, every zero run of ZERO_RUNS ahead of a non-zero, blocks with a
    non-zero last coefficient and all-zero blocks, N = 1, and rows with
    n_valid 0, partial and full."""
    ext = CASES["int16 extremes"][0]
    assert ext.min() == -32768 and ext.max() == 32767
    wide = np.abs(CASES["int32 sizes above 16"][0].astype(np.int64))
    assert wide.max() >= 1 << 31 and ((wide >= 1 << 16) & (wide < 1 << 31)).any()
    runs = set()
    for blk in CASES["zero runs"][0].reshape(-1, 64):
        pos = np.r_[0, np.flatnonzero(blk[1:]) + 1]
        runs |= set(np.diff(pos) - 1)
    assert set(SMOKE.ZERO_RUNS) <= runs
    tails = CASES["last coefficient and all-zero blocks"][0].reshape(-1, 64)
    assert (tails[:, 63] != 0).any() and (tails == 0).all(axis=1).any()
    assert CASES["N = 1"][0].shape[1] == 1
    blocks, n_valid, _ = CASES["n_valid 0, partial, full"]
    assert sorted(n_valid) == [0, 17, blocks.shape[1]]


def test_edge_batch_covers_the_dense_cases():
    """The dense cases hold what they name: every AC coefficient non-zero
    over more than one tile; one lone non-zero at each AC position 1..63;
    non-zeros only at 1 and 63; int16's -32768 everywhere; int32 sizes
    from 1 past 16; dense rows whose n_valid ends inside a warp's blocks."""
    dense = CASES["every AC coefficient non-zero"][0]
    assert (dense[..., 1:] != 0).all() and dense.shape[1] > 128
    lone = CASES["a lone non-zero at each position 1..63"][0].reshape(-1, 64)
    assert ((lone[:, 1:] != 0).sum(axis=1) == 1).all()
    assert {int(np.flatnonzero(b[1:])[0]) + 1 for b in lone} == set(range(1, 64))
    ends = CASES["non-zeros only at 1 and 63"][0].reshape(-1, 64)
    assert (ends[:, 1] != 0).all() and (ends[:, 63] != 0).all() and (ends[:, 2:63] == 0).all()
    assert (CASES["every coefficient -32768"][0][0] == -32768).all()
    wide = np.abs(CASES["int32 dense, sizes to 16 and past"][0][..., 1:].astype(np.int64))
    bits = np.floor(np.log2(wide)).astype(int) + 1
    assert (wide > 0).all() and bits.min() == 1 and bits.max() > 16
    blocks, n_valid, _ = CASES["dense, n_valid inside a warp"]
    assert (blocks[..., 1:] != 0).all() and any(0 < n % 32 for n in n_valid)


def test_size_16_aliases_into_the_run_nibble():
    """A size of 16 sets bit 4 of the symbol, the run's lowest bit, as the
    plain ``|`` does: run 0 or 1 at size 16 lands in 0x10, run 2 in 0x30."""
    blocks = np.zeros((1, 3, 64), np.int16)
    blocks[0, 0, 1] = -32768            # run 0, size 16
    blocks[0, 1, 2] = 32767             # run 1, size 15: 0x1F
    blocks[0, 1, 3] = -32768            # run 0 after it: 0x10
    blocks[0, 2, 3] = -32768            # run 2, size 16: 0x30
    want_ac = np.zeros(256, np.int64)
    want_ac[[0x10, 0x1F, 0x30]] = [2, 1, 1]
    want_ac[0] = 3
    for fn in VERSIONS.values():
        _, ac = fn(torch.from_numpy(blocks))
        np.testing.assert_array_equal(ac.numpy(), want_ac)
    np.testing.assert_array_equal(np.asarray(_jax_hists(blocks, jnp.asarray([3]))[1]), want_ac)
    wide = blocks.astype(np.int32)
    wide[wide == -32768] = -(1 << 21)  # 22 bits: still size 16
    np.testing.assert_array_equal(VERSIONS["wrapper"](torch.from_numpy(wide))[1].numpy(),
                                  want_ac)


@pytest.mark.parametrize("shape,lo,hi,share,seed", [
    ((1, 1, 64), -300, 300, 0.5, 0),
    ((2, 333, 64), -2047, 2048, 0.1, 1),
    ((8, 64, 64), -4, 4, 0.05, 2),
    ((3, 100, 64), -32768, 32768, 0.9, 3),
])
def test_random_batches_match_jax_and_host(shape, lo, hi, share, seed):
    rng = np.random.default_rng(seed)
    blocks = rng.integers(lo, hi, size=shape).astype(np.int16)
    blocks[..., 1:] *= (rng.random(shape[:2] + (63,)) < share).astype(np.int16)
    n_valid = rng.integers(0, shape[1] + 1, size=shape[0])
    prev_dc = rng.integers(-2048, 2048, size=shape[0]).astype(np.int32)
    for nv, pd in ((None, None), (n_valid, None), (None, prev_dc), (n_valid, prev_dc)):
        want = _jax_reference(blocks, nv, pd)
        for h, w in zip(_host_gather(blocks, nv, pd), want):
            np.testing.assert_array_equal(h, np.asarray(w, np.int64))
        for fn in VERSIONS.values():
            _assert_equal(fn(torch.from_numpy(blocks), _tensor(nv), _tensor(pd)), want)
        _assert_equal(VERSIONS["model"](torch.from_numpy(blocks.astype(np.int32)), _tensor(nv),
                                        _tensor(pd)), want)


def _plane_case(mcu, dtype, seed, n_planes=1, b=2, mcu_rows=3, mcu_cols=37):
    """Random planes [b, mcu_rows v, mcu_cols h, 64] at an (h, v) MCU (the
    luma's 37 MCUs at (2, 2) span two of the kernel's 32-MCU tiles, three
    at (1, 1)), with n_valid and prev_dc for all n_planes x b chains."""
    h, v = mcu
    rng = np.random.default_rng(seed)
    shape = (b, mcu_rows * v, mcu_cols * h, 64)
    planes = []
    for _ in range(n_planes):
        x = rng.integers(-1200, 1200, size=shape).astype(dtype)
        x[..., 1:] *= (rng.random(shape[:3] + (63,)) < 0.2).astype(dtype)
        planes.append(x)
    n = shape[1] * shape[2]
    n_valid = rng.integers(0, n + 1, size=n_planes * b)
    n_valid[0] = n
    prev_dc = rng.integers(-2047, 2048, size=n_planes * b).astype(np.int32)
    return planes, n_valid, prev_dc


def _jax_walk(planes, mcu):
    """The JAX package's MCU walk of each plane, the chains stacked as the
    step's ``cat`` of its chroma stacked them."""
    h, v = mcu
    return np.concatenate([np.asarray(ref_sharding._mcu_order_batch(jnp.asarray(x), h, v, jnp))
                           for x in planes])


@pytest.mark.parametrize("version", ["plain", "model", "wrapper"])
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("mcu", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_planes_in_place_match_jax_walk(mcu, dtype, version):
    """One component plane, walked in its MCU order where it lies, bin
    for bin the JAX package's histograms of its ``_mcu_order_batch``
    copy, with and without n_valid and prev_dc."""
    (plane,), n_valid, prev_dc = _plane_case(mcu, dtype, seed=sum(mcu) * 7 + (dtype == np.int32))
    flat = _jax_walk([plane], mcu)
    for nv, pd in ((None, None), (n_valid, None), (None, prev_dc), (n_valid, prev_dc)):
        got = VERSIONS[version](torch.from_numpy(plane), _tensor(nv), _tensor(pd), mcu=mcu)
        _assert_equal(got, _jax_reference(flat, nv, pd))


PLANE_CASES = {label: case for label, *case in SMOKE.k5_plane_cases()}


@pytest.mark.parametrize("version", sorted(VERSIONS))
@pytest.mark.parametrize("label", sorted(PLANE_CASES))
def test_plane_cases_match_jax(label, version):
    """``chip_smoke.k5_plane_cases``, the planes the card holds K5 to in
    place: each version bin for bin the JAX package's histograms of the
    planes' ``_mcu_order_batch`` copies, stacked."""
    planes, n_valid, prev_dc, mcu = PLANE_CASES[label]
    planes = planes if isinstance(planes, tuple) else (planes,)
    blocks = tuple(torch.from_numpy(x) for x in planes)
    got = VERSIONS[version](blocks if len(blocks) > 1 else blocks[0], _tensor(n_valid),
                            _tensor(prev_dc), mcu=mcu)
    _assert_equal(got, _jax_reference(_jax_walk(planes, mcu), n_valid, prev_dc))


@pytest.mark.parametrize("version", ["plain", "model", "wrapper"])
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_two_planes_match_jax_cat(dtype, version):
    """Two planes of one shape (the step's Cb and Cr): their chains stack,
    B of the first and then B of the second, as JAX's cat of the two."""
    planes, n_valid, prev_dc = _plane_case((1, 1), dtype, seed=11, n_planes=2, b=3,
                                           mcu_rows=4, mcu_cols=150)
    flat = _jax_walk(planes, (1, 1))
    for nv, pd in ((None, None), (n_valid, prev_dc)):
        got = VERSIONS[version](tuple(torch.from_numpy(x) for x in planes), _tensor(nv),
                                _tensor(pd))
        _assert_equal(got, _jax_reference(flat, nv, pd))


def test_walk_is_the_jax_walk():
    """``encode_stage.mcu_walk`` (the plain version's way in) is the JAX
    ``_mcu_order_batch``, and K5's own walk (``k5_walk``, by its tile and
    stage arithmetic) visits the same blocks in the same order, each DC
    chained to the block before it in the walk."""
    for mcu in ((1, 1), (2, 1), (1, 2), (2, 2), (3, 2), (4, 4)):
        (plane,), _, _ = _plane_case(mcu, np.int16, seed=3, b=1, mcu_rows=2, mcu_cols=130)
        want = _jax_walk([plane], mcu)
        np.testing.assert_array_equal(encode_stage.mcu_walk(torch.from_numpy(plane), mcu).numpy(),
                                      want)
        pos, pred = encode_stage.k5_walk(*plane.shape[1:3], *mcu)
        flat = plane.reshape(1, -1, 64)
        np.testing.assert_array_equal(flat[:, pos.numpy()], want)
        assert pred[0] == -1
        np.testing.assert_array_equal(pred[1:].numpy(), pos[:-1].numpy())


@pytest.mark.parametrize("version", ["plain", "model", "wrapper"])
def test_step_histograms_match_jax_full_step(version):
    """``_step``'s histograms, its luma and chroma counted on the planes
    where its K2 wrote them, equal the JAX ``full_step``'s; and with an
    identity ``chain_prev`` (every chain's DC before it its own last DC),
    the sum of the JAX histograms of each chain with that block ahead of
    it, less that block's own counts."""
    rng = np.random.default_rng(4)
    b, hb, wb = 2, 8, 16
    y = rng.integers(-64, 64, size=(b, hb, wb, 64), dtype=np.int16)
    cb, cr = (rng.integers(-32, 32, size=(b, hb // 2, wb // 2, 64), dtype=np.int16)
              for _ in range(2))
    args = (y, cb, cr, STANDARD_LUMINANCE_ZIGZAG.astype(np.int32),
            STANDARD_CHROMINANCE_ZIGZAG.astype(np.int32))
    want = np.asarray(jax.jit(ref_sharding.full_step)(*args)[2])
    inputs = sharding._step_inputs(*args, "cpu")
    _, requants, hists = sharding._step(*inputs, kernels.dequantize_idct_shift,
                                        kernels.fdct_quantize, k5=VERSIONS[version])
    np.testing.assert_array_equal(hists.numpy(), want)

    lasts = []
    _, _, chained = sharding._step(*inputs, kernels.dequantize_idct_shift,
                                   kernels.fdct_quantize, k5=VERSIONS[version],
                                   chain_prev=lambda last: lasts.append(last) or last)
    (last,) = lasts
    y_walk = _jax_walk([requants[0].numpy()], (2, 2))
    c_walk = _jax_walk([q.numpy() for q in requants[1:]], (1, 1))
    np.testing.assert_array_equal(last.numpy(), np.r_[y_walk[:, -1, 0], c_walk[:, -1, 0]])
    luma = _jax_reference(y_walk, None, last.numpy()[:b])
    chroma = _jax_reference(c_walk, None, last.numpy()[b:])
    np.testing.assert_array_equal(chained.numpy(), np.stack([*luma, *chroma]))


def test_wrapper_takes_the_plain_version_on_the_cpu(monkeypatch):
    """On CPU tensors the wrapper returns the plain version's result and
    launches nothing."""
    blocks, n_valid, prev_dc = CASES["prev_dc and n_valid"]
    calls = []
    plain = encode_stage.symbol_histograms_plain
    monkeypatch.setattr(encode_stage, "symbol_histograms_plain",
                        lambda *a, **kw: calls.append(a) or plain(*a, **kw))
    before = kernels.symbol_histograms.launches
    got = kernels.symbol_histograms(torch.from_numpy(blocks), _tensor(n_valid), _tensor(prev_dc))
    assert kernels.symbol_histograms.launches == before and len(calls) == 1
    _assert_equal(got, plain(torch.from_numpy(blocks), _tensor(n_valid), _tensor(prev_dc)))


@pytest.mark.parametrize("case,err,match", [
    (dict(blocks=torch.zeros((1, 4, 64), dtype=torch.float32)), TypeError, "int16 or int32"),
    (dict(blocks=torch.zeros((1, 4, 64), dtype=torch.uint8)), TypeError, "int16 or int32"),
    (dict(blocks=torch.zeros((4, 64), dtype=torch.int16)), ValueError, r"\[B, N, 64\]"),
    (dict(blocks=torch.zeros((1, 4, 63), dtype=torch.int16)), ValueError, r"\[B, N, 64\]"),
    (dict(n_valid=torch.tensor([1, 2])), ValueError, "n_valid must be"),
    (dict(prev_dc=torch.tensor([[1]])), ValueError, "prev_dc must be"),
    (dict(prev_dc=torch.tensor([1.0])), ValueError, "prev_dc must be"),
    (dict(n_valid=[3]), TypeError, "n_valid must be a tensor"),
    (dict(n_valid=torch.tensor([3], device="meta")), ValueError, "n_valid on meta"),
    (dict(prev_dc=torch.tensor([3], device="meta")), ValueError, "prev_dc on meta"),
    (dict(blocks=torch.zeros((1, 4, 64), dtype=torch.int16, device="meta")), ValueError,
     "no K5 kernel for device meta"),
])
def test_wrapper_raises(case, err, match):
    args = dict(blocks=torch.zeros((1, 4, 64), dtype=torch.int16), n_valid=None, prev_dc=None)
    args.update(case)
    before = kernels.symbol_histograms.launches
    with pytest.raises(err, match=match):
        kernels.symbol_histograms(args["blocks"], args["n_valid"], args["prev_dc"])
    assert kernels.symbol_histograms.launches == before


def test_k5_source_is_built_and_bound():
    """csrc/symbol_hist.cu is one of the library's sources and defines both
    entry points the loader binds, each with as many parameters as its
    ctypes signature."""
    assert "symbol_hist.cu" in [p.name for p in _build._CSRC.glob("*.cu")]
    text = (_build._CSRC / "symbol_hist.cu").read_text()
    for name in ("jpx_symbol_histograms_i16", "jpx_symbol_histograms_i32"):
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
        assert m and m.group(1).count(",") + 1 == len(_build._ENTRY_POINTS[name]), name

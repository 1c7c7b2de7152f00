"""PyTorch port, K5 (the symbol statistics) on the CPU, against the JAX
package: ``encode_stage.symbol_histograms_plain`` (K5's plain version) and
``symbol_histograms_model`` (a CPU model of the kernel's per-block
arithmetic) against the JAX ``symbol_histograms_device``, jitted on the
CPU, and the host gather ``dc_ac_symbol_frequencies``, on
``chip_smoke.k5_edge_cases`` (the batch the card holds K5 to) and on
random batches; then K5's wrapper ``kernels.symbol_histograms``: its
dispatch on the CPU and its errors.

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

from jpeglibrary_tpu_torch.host.ops import encode_stage as host_encode_stage
from jpeglibrary_tpu_torch.ops import _build, encode_stage, kernels

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


def test_wrapper_takes_the_plain_version_on_the_cpu(monkeypatch):
    """On CPU tensors the wrapper returns the plain version's result and
    launches nothing."""
    blocks, n_valid, prev_dc = CASES["prev_dc and n_valid"]
    calls = []
    plain = encode_stage.symbol_histograms_plain
    monkeypatch.setattr(encode_stage, "symbol_histograms_plain",
                        lambda *a: calls.append(a) or plain(*a))
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

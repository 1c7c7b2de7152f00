"""PyTorch port, K5 (``kernels.symbol_histograms``, ``csrc/symbol_hist.cu``)
on the card: the kernel bin for bin its plain version
(``encode_stage.symbol_histograms_plain``) on ``chip_smoke.k5_edge_cases``
and ``k5_plane_cases`` (the dense and wrap-around cases among them), and on
planes of the CT and 4:2:2 cells' shapes at their MCU walks, sparse, as
dense as the cells' content and with every AC coefficient non-zero.

Every test needs the card and skips without one. The module imports no
JAX, so the card runs it without this directory's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_symbol_hist_card.py
"""

import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jpeglibrary_tpu_torch.ops import encode_stage, kernels

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _load_smoke()
EDGE = {label: case for label, *case in SMOKE.k5_edge_cases()}
PLANES = {label: case for label, *case in SMOKE.k5_plane_cases()}
# The cells' planes K5 counts: (planes, [B, Hb, Wb] of each, MCU walk).
CELL_SHAPES = {"ct12 series": (1, (512, 64, 64), (1, 1)),
               "24mp 4:2:2 luma": (1, (4, 500, 750), (2, 1)),
               "24mp 4:2:2 chroma": (2, (4, 500, 375), (1, 1))}
DENSITIES = (0.05, 0.6, 1.0)  # the share of AC coefficients that are non-zero


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K5 runs only there")
    return torch.device("cuda")


def _equal_to_the_plain_version(planes, n_valid, prev_dc, mcu, device):
    on = [torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in planes]
    blocks = tuple(on) if len(on) > 1 else on[0]
    nv = None if n_valid is None else torch.as_tensor(n_valid, dtype=torch.int32, device=device)
    pd = None if prev_dc is None else torch.as_tensor(prev_dc, dtype=torch.int32, device=device)
    before = kernels.symbol_histograms.launches
    got = kernels.symbol_histograms(blocks, nv, pd, mcu=mcu)
    want = encode_stage.symbol_histograms_plain(blocks, nv, pd, mcu=mcu)
    torch.cuda.synchronize()
    assert kernels.symbol_histograms.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == (256,)
        assert int((g != w).sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("label", sorted(EDGE))
def test_card_k5_edge_cases_equal_the_plain_version(card, label):
    blocks, n_valid, prev_dc = EDGE[label]
    _equal_to_the_plain_version([blocks], n_valid, prev_dc, (1, 1), card)


@pytest.mark.cuda
@pytest.mark.parametrize("label", sorted(PLANES))
def test_card_k5_plane_cases_equal_the_plain_version(card, label):
    planes, n_valid, prev_dc, mcu = PLANES[label]
    _equal_to_the_plain_version(planes if isinstance(planes, tuple) else [planes], n_valid,
                                prev_dc, mcu, card)


@pytest.mark.cuda
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("cell", sorted(CELL_SHAPES))
def test_card_k5_cell_planes_equal_the_plain_version(card, cell, density):
    """Random int16 planes of a cell's shape at its walk, with n_valid and
    prev_dc on every chain (n_valid inside a warp's blocks on the first)."""
    n_planes, shape, mcu = CELL_SHAPES[cell]
    rng = np.random.default_rng([25, n_planes, *shape, int(density * 100)])
    planes = []
    for _ in range(n_planes):
        x = rng.integers(-2047, 2048, size=shape + (64,), dtype=np.int16)
        x[..., 1:] *= (rng.random(shape + (63,)) < density).astype(np.int16)
        planes.append(x)
    chains = n_planes * shape[0]
    n = shape[1] * shape[2]
    n_valid = np.full(chains, n)
    n_valid[0] = n - 77
    prev_dc = rng.integers(-2048, 2048, size=chains).astype(np.int32)
    _equal_to_the_plain_version(planes, n_valid, prev_dc, mcu, card)

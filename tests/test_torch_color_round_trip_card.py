"""PyTorch port, K6 (``kernels.color_round_trip``, ``csrc/color_round_trip.cu``)
on the card: both instantiations against the plain version
(``color.round_trip_plain``), 0 bytes differing, and the 4:2:0
instantiation against the SHA-256 digests of its outputs recorded on an
H100 from the kernel before it took the MCU's height as a template
parameter, so that the 4:2:0 path is held byte for byte.

Every test needs the card and skips without one. The module imports no
JAX, so the card runs it without this directory's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_color_round_trip_card.py

``python3 tests/test_torch_color_round_trip_card.py`` prints the digests of
the tree it runs in (how the recorded ones were made).
"""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jpeglibrary_tpu_torch.ops import kernels

# (batch, luma block rows, luma block columns) of 4:2:0 batches: both 4:2:0
# cells' batches, MCU rows of 33 and 13 MCUs (the last strip of a row
# ragged), and one MCU.
DIGEST_SHAPES = {"recompress_16mp_b4": (4, 512, 512), "recompress_imagenet_b256": (256, 48, 64),
                 "ragged_3x6x66": (3, 6, 66), "ragged_2x10x26": (2, 10, 26),
                 "one_mcu": (1, 2, 2)}
DIGEST_SEED = 24

# SHA-256 of the RGB and the three planes' bytes, in that order, recorded on
# an NVIDIA H100 80GB HBM3 from the 4:2:0 kernel that kept its MCU's two
# block rows fixed in its source.
K6_DIGESTS = {
    "one_mcu":
        "ff3198e827111639ff27345f4c3281fadba8734bbe56ae4f1f82382cef68c870",
    "ragged_2x10x26":
        "d6d974950f8ca954138fc5196b2cf3908f51544a598e5988110fa4ebed9d26a1",
    "ragged_3x6x66":
        "366ed3bef2bbebbacb59b4f64c84e703a2a3d42c64699961ea17782d44c93a67",
    "recompress_16mp_b4":
        "2c73f22070fab5e81a574a17879055b8903ab5fe22b1b2b78536a98bd98f4e9a",
    "recompress_imagenet_b256":
        "bdfd8c7b5c4bdf059bd91b0ca91a30fca08d3032464f56a6edbb64521bb19d63",
}

# 4:2:2 batches: the 24 MP cell's batch (375 MCUs a row: 23 whole strips of
# 16 MCUs and 7 MCUs), odd MCU rows, MCU rows of 1, 5 and 17 MCUs.
SHAPES_422 = {"recompress_24mp_422_b4": (4, 500, 750), "ragged_1x3x34": (1, 3, 34),
              "ragged_3x7x10": (3, 7, 10), "one_mcu_row_of_1": (2, 1, 2)}


def samples(b, hb, wb, vs, device, seed=DIGEST_SEED):
    """K1-range int32 samples (-300 to 400) of a 4:2:0 (``vs`` 2) or 4:2:2
    (1) batch, made with numpy from ``seed``, with the int32 extremes and
    the clamp's edges planted in each component, on ``device``."""
    rng = np.random.default_rng([seed, b, hb, wb, vs])
    out = []
    chroma = (b, hb // vs, wb // 2, 8, 8)
    for shape in ((b, hb, wb, 8, 8), chroma, chroma):
        x = rng.integers(-300, 401, size=shape, dtype=np.int32)
        edges = np.array([-2**31, 2**31 - 1, -1, 0, 255, 256], np.int32)
        x.reshape(-1)[rng.choice(x.size, edges.size, replace=False)] = edges
        out.append(torch.from_numpy(x).to(device))
    return out


def k6_digest(name, device) -> str:
    """SHA-256 of K6's four outputs for the 4:2:0 batch ``name`` of
    :data:`DIGEST_SHAPES` on ``device``."""
    outputs = kernels.color_round_trip(*samples(*DIGEST_SHAPES[name], 2, device))
    digest = hashlib.sha256()
    for out in outputs:
        digest.update(out.cpu().numpy().tobytes())
    return digest.hexdigest()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(DIGEST_SHAPES))
def test_card_k6_420_outputs_equal_recorded_digests(card, name):
    assert k6_digest(name, card) == K6_DIGESTS[name], name


def _equal_to_the_plain_version(b, hb, wb, vs, device):
    from jpeglibrary_tpu_torch.ops import color

    x = samples(b, hb, wb, vs, device, seed=DIGEST_SEED + 1)
    before = dict(kernels.color_round_trip.launches_by_box)
    got = kernels.color_round_trip(*x)
    want = color.round_trip_plain(*x)
    torch.cuda.synchronize()
    after = kernels.color_round_trip.launches_by_box
    assert after.get((2, vs), 0) - before.get((2, vs), 0) == 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.uint8 and g.shape == w.shape and g.is_contiguous()
        assert int((g != w).sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHAPES_422))
def test_card_k6_422_equals_the_plain_version(card, name):
    _equal_to_the_plain_version(*SHAPES_422[name], 1, card)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ragged_3x6x66", "recompress_imagenet_b256"])
def test_card_k6_420_equals_the_plain_version(card, name):
    _equal_to_the_plain_version(*DIGEST_SHAPES[name], 2, card)


if __name__ == "__main__":
    dev = torch.device("cuda")
    for key in sorted(DIGEST_SHAPES):
        print(f'    "{key}":\n        "{k6_digest(key, dev)}",')

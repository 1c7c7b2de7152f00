"""PyTorch port, K7 (``kernels.progressive_histograms``,
``csrc/progressive_hist.cu``) on the card: the kernel bin for bin its plain
version (``encode_stage.progressive_histograms_plain``) on random planes of
several densities and sizes (ragged grids, the transcode cell's shape),
on planes whose EOB runs cross every segment and tile boundary, on a flat
luma whose runs pass 0x7FFF, and on a script of other bands and point
transforms; and K5's ``symbol_hist_kernel`` compiled to the same SASS as
before K7 came beside it.

Every test needs the card and skips without one. The module imports no
JAX, so the card runs it without this directory's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_progressive_hist_card.py
"""

import hashlib
import re
import shutil
import subprocess

import pytest

torch = pytest.importorskip("torch")

from jpeglibrary_tpu_torch.host.models.progressive_encoder import SCRIPT_3
from jpeglibrary_tpu_torch.ops import _build, encode_stage, kernels

# SHA-256 of the SASS of symbol_hist_kernel<int> and <short> (cuobjdump
# -sass, each function's instruction lines without their addresses and
# encodings, the two joined in that order: the mangled names hold a hash of
# the source's path), recorded from the source before K7 was added, built
# alone with the library's flags (CUDA 12.9's nvcc, sm_90a).
K5_SASS_SHA256 = "258ff08b009e3da9b5c4c79c5f1b34a3d28dfe707b84de5748cdedb80a94c45d"

# A script of other bands and point transforms (every bit refined).
SCRIPT_WIDE = [
    ((0, 1, 2), 0, 0, 0, 0),
    ((0,), 1, 2, 0, 3), ((0,), 3, 63, 0, 2), ((0,), 1, 2, 3, 2),
    ((0,), 1, 63, 2, 1), ((0,), 1, 63, 1, 0),
    ((1,), 1, 63, 0, 0), ((2,), 1, 20, 0, 1), ((2,), 21, 63, 0, 0), ((2,), 1, 20, 1, 0),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K7 runs only there")
    return torch.device("cuda")


def _planes(g, b, hb, wb, density, scale=12.0):
    """4:2:0 int16 planes on the card: a fraction ``density`` of the AC
    coefficients non-zero, magnitudes falling with the zig-zag position,
    both signs."""
    out = []
    for shape in ((b, hb, wb, 64), (b, hb // 2, wb // 2, 64), (b, hb // 2, wb // 2, 64)):
        decay = torch.exp(-torch.arange(64, device=g.device) / 16.0) * scale
        x = torch.randn(shape, generator=g, device=g.device) * decay
        keep = torch.rand(shape, generator=g, device=g.device) < density
        keep[..., 0] = True
        out.append((x * keep).round().clamp(-2047, 2047).to(torch.int16))
    return out


def _equal(planes, size, script, device):
    before = dict(kernels.progressive_histograms.launches_by_walk)
    got = kernels.progressive_histograms(*planes, script, size=size)
    want = encode_stage.progressive_histograms_plain(*planes, script, size=size)
    torch.cuda.synchronize()
    after = kernels.progressive_histograms.launches_by_walk
    given = [n for n, p in zip(("y", "cb", "cr"), planes) if p is not None]
    for walk in given + ["eobrun"]:
        assert after.get(walk, 0) > before.get(walk, 0), walk
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert int((got != want).sum()) == 0
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("size,b,density", [
    ((29, 37), 3, 0.5), ((375, 500), 4, 0.3), ((375, 500), 2, 1.0), ((1080, 1920), 2, 0.05),
    ((3024, 4032), 2, 0.6), ((16, 16), 5, 0.8), ((120, 1000), 3, 0.01)])
def test_card_k7_random_planes_equal_the_plain_version(card, size, b, density):
    g = torch.Generator(device=card).manual_seed(7000 + size[0])
    hb, wb = 2 * -(-size[0] // 16), 2 * -(-size[1] // 16)
    _equal(_planes(g, b, hb, wb, density), size, SCRIPT_3, card)


@pytest.mark.cuda
@pytest.mark.parametrize("every", [1, 31, 33, 64, 127, 129, 4099])
def test_card_k7_runs_across_segments_and_tiles(card, every):
    """Flat blocks but for one coding block in every ``every``: runs start
    and end at every offset of the 32-block segments and of the tiles."""
    g = torch.Generator(device=card).manual_seed(every)
    planes = _planes(g, 3, 96, 200, 0.0)
    for p in planes:
        n = p.shape[1] * p.shape[2]
        flat = p.view(p.shape[0], n, 64)
        flat[:, ::every, 1:6] = 3
        flat[:, 5::every, 40] = -1
    _equal(planes, (8 * 96, 8 * 200), SCRIPT_3, card)


@pytest.mark.cuda
def test_card_k7_flat_luma_past_the_longest_run(card):
    """A flat luma of 2 x 32,768 blocks: runs longer than 0x7FFF blocks."""
    g = torch.Generator(device=card).manual_seed(2)
    planes = _planes(g, 2, 64, 1024, 0.0)
    got = _equal(planes, (512, 8192), SCRIPT_3, card)
    assert int(got[:, 3:, 0xE0].sum()) > 0


@pytest.mark.cuda
def test_card_k7_other_script_and_one_component(card):
    g = torch.Generator(device=card).manual_seed(11)
    planes = _planes(g, 3, 50, 62, 0.7, scale=40.0)
    _equal(planes, (397, 490), SCRIPT_WIDE, card)
    from jpeglibrary_tpu_torch.host.models.progressive_encoder import SCRIPT_1

    _equal([planes[0], None, None], (400, 496), SCRIPT_1, card)


def sass(binary, name):
    """The instructions of the functions whose names hold ``name`` in a
    compiled ``binary``, one a line, the functions in the order of their
    names after ``name``."""
    text = subprocess.run([shutil.which("cuobjdump"), "-sass", str(binary)], check=True,
                          capture_output=True, text=True).stdout
    funcs = {}
    for part in re.split(r"(?m)^\s*Function : ", text)[1:]:
        title = part.splitlines()[0].strip()
        if name in title:
            funcs[title.split(name, 1)[1]] = "\n".join(
                re.findall(r"/\*[0-9a-f]{4,}\*/\s*([^;]*;)", part))
    return "\n".join(funcs[k] for k in sorted(funcs))


@pytest.mark.cuda
def test_card_k5_sass_unchanged(card):
    if shutil.which("cuobjdump") is None:
        pytest.skip("no cuobjdump")
    text = sass(_build.build_library(), "symbol_hist_kernel")
    assert text.count("EXIT") >= 2, "no symbol_hist_kernel in the library"
    assert hashlib.sha256(text.encode()).hexdigest() == K5_SASS_SHA256

"""PyTorch port, K1 (dequantize + IDCT): its plain version against the
JAX package's Pallas kernel (interpret mode, the JAX tests' own CPU
route) and against the butterfly IDCT, and the wrapper's dispatch.

Tolerance: 1 sample LSB. The folded-matrix product sums in another order
than the butterfly (and than XLA's dot), so a value within an ulp of a
.5 tie can round the other way. The share of samples that differ is
bounded too: a plain version that truncated, or lost mantissa bits,
would be off by 1 on about half of them.

The tests marked ``cuda`` need the card and skip without one: K1's
outputs, both W = 64 stores and both coefficient types, equal the SHA-256
digests recorded on an H100 from the kernel whose product loop ran 8
blocks by 4 columns a thread (before the W = 64 loop was redesigned), so
the loop's arithmetic is held bit for bit; K2's outputs (every sample
type, the cells' boxes and sizes, ragged edges, each load width, two quant
tables) equal the digests recorded from the kernel that ran its strips in
lock-step rounds of 4-warp CTAs (before the warpgroup walk), and the cells'
instantiations take the warpgroup walk. Where JAX is not installed the
JAX package is not imported either, and the CPU tests that compare with it
cannot run; the card tests run without this directory's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import hashlib
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jpeglibrary_tpu_torch.ops import _build, decode_stage, kernels

try:  # the CPU tests' reference, not needed by the card tests
    import jax.numpy as jnp

    from jpeglibrary_tpu.ops import decode_stage as ref_stage
    from jpeglibrary_tpu.ops import pallas_kernels
except ModuleNotFoundError:
    jnp = ref_stage = pallas_kernels = None
else:
    from torch_reference_native import settle

    settle()  # the JAX package's native scanner, built once before any test


def _inputs(n_blocks, seed=5):
    rng = np.random.default_rng(seed)
    coeffs = rng.integers(-1024, 1024, size=(n_blocks, 64)).astype(np.int16)
    quant = rng.integers(1, 255, size=64).astype(np.int32)
    return coeffs, quant


def _plain(coeffs, quant, level_shift):
    matrix = torch.from_numpy(kernels.fused_transform_matrix())
    return decode_stage.dequantize_idct_shift(
        torch.from_numpy(coeffs), torch.from_numpy(quant), len(coeffs), level_shift, matrix
    ).numpy()


@pytest.mark.parametrize("level_shift", [128, 2048])
@pytest.mark.parametrize("n_blocks", [1, 64, 513])
def test_plain_matches_pallas_interpret(n_blocks, level_shift):
    coeffs, quant = _inputs(n_blocks)
    want = np.asarray(
        pallas_kernels.dequantize_idct_shift_pallas(
            jnp.asarray(coeffs), jnp.asarray(quant), level_shift, interpret=True
        )
    )
    got = _plain(coeffs, quant, level_shift)
    assert got.shape == want.shape == (n_blocks, 8, 8)
    d = np.abs(got.astype(np.int64) - want)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("level_shift", [128, 2048])
@pytest.mark.parametrize("n_blocks", [1, 64, 513])
def test_plain_matches_butterfly(n_blocks, level_shift):
    coeffs, quant = _inputs(n_blocks, seed=7)
    want = ref_stage.dequantize_idct_shift(coeffs, quant, level_shift)
    got = _plain(coeffs, quant, level_shift)
    assert got.dtype == np.int32 and got.shape == want.shape
    d = np.abs(got.astype(np.int64) - want)
    # These inputs reach samples of ~1e5, where fp32's ulp is ~1e-2, so
    # the two summation orders round about 1% of the samples apart.
    assert d.max() <= 1 and (d > 0).mean() <= 2e-2, (d.max(), (d > 0).mean())


def test_transform_matrix_equals_jax_package():
    ours = kernels.transform_matrix(torch.device("cpu"))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (64, 64)
    np.testing.assert_array_equal(ours.numpy(), pallas_kernels.fused_transform_matrix())


@pytest.mark.parametrize("dtype", [torch.int32, torch.int16])
def test_wrapper_on_cpu_takes_plain_version(dtype):
    coeffs, quant = _inputs(70, seed=9)
    c = torch.from_numpy(coeffs).to(dtype).reshape(7, 10, 64)
    before = kernels.dequantize_idct_shift.launches
    got = kernels.dequantize_idct_shift(c, torch.from_numpy(quant), 128)
    assert kernels.dequantize_idct_shift.launches == before
    assert got.shape == (7, 10, 8, 8) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.reshape(70, 8, 8).numpy(), _plain(coeffs, quant, 128))


def test_wrapper_rejects_bad_inputs():
    coeffs, quant = _inputs(4)
    c = torch.from_numpy(coeffs)
    q = torch.from_numpy(quant)
    with pytest.raises(TypeError):
        kernels.dequantize_idct_shift(c.to(torch.float32), q, 128)
    with pytest.raises(ValueError):
        kernels.dequantize_idct_shift(c[:, :63], q, 128)
    with pytest.raises(ValueError):
        kernels.dequantize_idct_shift(c, q[:32], 128)
    with pytest.raises(ValueError):
        kernels.dequantize_idct_shift(c, q.to(torch.int64), 128)
    with pytest.raises(ValueError):
        kernels.dequantize_idct_shift(c.to("meta"), q.to("meta"), 128)


def test_import_needs_no_nvcc_or_triton(tmp_path):
    """The modules import, and the CPU path runs, with no nvcc anywhere;
    asking for the CUDA build then raises with a clear message."""
    code = (
        "import sys, torch\n"
        "from jpeglibrary_tpu_torch.ops import _build, kernels\n"
        "c = torch.zeros(3, 64, dtype=torch.int32)\n"
        "q = torch.ones(64, dtype=torch.int32)\n"
        "assert (kernels.dequantize_idct_shift(c, q, 128) == 128).all()\n"
        "assert 'triton' not in sys.modules\n"
        "import os\n"
        "if not os.path.exists('/usr/local/cuda/bin/nvcc'):\n"
        "    try:\n"
        "        _build.find_nvcc()\n"
        "    except RuntimeError as e:\n"
        "        assert 'nvcc not found' in str(e)\n"
        "    else:\n"
        "        raise AssertionError('find_nvcc found a compiler')\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "ok"


# --- On the card ----------------------------------------------------------------

# Blocks a launch: one, a partial warp tile, a whole tile of 128 and one past
# it, an odd count, and 4 x 4,096. The plane store lays them out as rows of
# PLANE_WIDTH[n] blocks.
DIGEST_BLOCKS = (1, 127, 128, 129, 513, 4 * 4096)
PLANE_WIDTH = {1: 1, 127: 127, 128: 16, 129: 43, 513: 27, 4 * 4096: 128}
DIGEST_SEED = 21


def _digest_cases():
    """Case name -> (store, coefficient dtype, blocks, level shift, max
    sample): the int32 block store at both coefficient types and both level
    shifts, the uint16 plane store (int16 only) at 8 and 12 bits."""
    cases = {}
    for n in DIGEST_BLOCKS:
        for dtype in ("int16", "int32"):
            for ls in (128, 2048):
                cases[f"blocks-{dtype}-{n}-ls{ls}"] = ("blocks", dtype, n, ls, None)
        for ls, top in ((128, 255), (2048, 4095)):
            cases[f"plane-int16-{n}-ls{ls}-max{top}"] = ("plane", "int16", n, ls, top)
    return cases


DIGEST_CASES = _digest_cases()

# SHA-256 of each case's output bytes (int32 blocks or the uint16 plane, as
# the card leaves them), recorded on an NVIDIA H100 80GB HBM3 from the
# kernel whose product loop ran 8 blocks by 4 columns a thread.
K1_DIGESTS = {
    "blocks-int16-1-ls128":
        "7c313dc2de45347a7e54e137650d448e9caf8cc0503205517cfd7e0807c2ad00",
    "blocks-int16-1-ls2048":
        "4021458f4d583177cec98d025861e416ed9d81ce68d2ad7fe5455ec30ea94f82",
    "blocks-int16-127-ls128":
        "14d4f9efd9b1284bf0759625f12354ffb22f6e0f75a9b2aca431094a92328fb1",
    "blocks-int16-127-ls2048":
        "2758e009b5953e1f5221ceec7d5cf79df81df4a44d642528ada858022af2bdaf",
    "blocks-int16-128-ls128":
        "b189a2c95e62cbc80c7d971328ffa5d1ce691ec6c1d3e52d080cb9a578a67e33",
    "blocks-int16-128-ls2048":
        "7e108a64b75b4285d93029708401036d1018db7c04d5cd6a9e9fb377ec604506",
    "blocks-int16-129-ls128":
        "aa78d1f14a780be3ec90d286fee805192e3d0f7aab2bfcfc1e15c2e1ad3e2613",
    "blocks-int16-129-ls2048":
        "f992955c8a03003f3fda24a77abeb4d2143532ad452cf4eb37727c8ef011f00c",
    "blocks-int16-16384-ls128":
        "fd2fe663fe670ebb585cf055ec1acf619f81b2c60f9dd97394a7e1d064765164",
    "blocks-int16-16384-ls2048":
        "36334c9896eabd0a54516bc46c32ed7edde206a4f9b28f06b8cf9c169b792441",
    "blocks-int16-513-ls128":
        "3fec4e3809ab6ff2b1d2f5d2ffb44bcb0d7115d32c33532afce5abfaf2d4f100",
    "blocks-int16-513-ls2048":
        "3d197760b79959a33ca50c608e1b063e7f2625c8a9ea1581117ee49615e129bc",
    "blocks-int32-1-ls128":
        "654758e2940b90aa1ebe20228eea38fe44fb8af619e8db3e6b622b9b21c7ed50",
    "blocks-int32-1-ls2048":
        "cde69cb8979c0807278722abcb9ac8910fb7e7f1b090dfa09e44c691bf6103b9",
    "blocks-int32-127-ls128":
        "ce7c04dc21cfd281d08487dd6c893f964c682b20cb89a550241391f0acc56d05",
    "blocks-int32-127-ls2048":
        "eddf6a85f388d5fd384f737b337536b24500b2bbed3a75e862b048787c2ce676",
    "blocks-int32-128-ls128":
        "77f44738ccc5dd8fd11093d281a6f1145dced54a5f2dfbe0190440551d132e1b",
    "blocks-int32-128-ls2048":
        "0a5925b856910c6b94f96aaa4405d9187a94506fc33c429c43abdc3fd88d2373",
    "blocks-int32-129-ls128":
        "878bb1518e7958133c625da3fcb4a30eb340cce2999eb86198b28074e040fd3a",
    "blocks-int32-129-ls2048":
        "ce880db932c240f817f9e62a0a6c3a80d8fa3881923f4319cbec94c0c1abbdbe",
    "blocks-int32-16384-ls128":
        "0b79c13bacf441c0a292254681d509ada090690a532834831636218b857b693c",
    "blocks-int32-16384-ls2048":
        "61b08cf3d09d688bdc6768ebfced90c31c1bf12ac71ba5e825a4e4551c7367ad",
    "blocks-int32-513-ls128":
        "91326b21c46eef1cafe619d8b2ef21eb69bff6c6aa6318b020a09bde06f1ebb3",
    "blocks-int32-513-ls2048":
        "b96e1ac76667d0bfbb41f8483f7585561900a01272533e2ba532a562c51574c8",
    "plane-int16-1-ls128-max255":
        "a884071933344a1f229f8abed18a21aed8ed60bf4257beeb514b4bb89ef9af4a",
    "plane-int16-1-ls2048-max4095":
        "8017317d61eb53b2e48b703d5532b2c335efc0387f5966098db33ee35e483f73",
    "plane-int16-127-ls128-max255":
        "7f803a2aec28c8da211ea352cdbf88bf9ca28c83380b1390759b149797df4821",
    "plane-int16-127-ls2048-max4095":
        "eb60b9e3452a56d9a26f0b18eff15addffb12a0c4e0cb4002ae39e169004fcba",
    "plane-int16-128-ls128-max255":
        "ffa40da7a182e21996e7f4d5f9f652d436bded7f126c6ff414cf133397d7f46d",
    "plane-int16-128-ls2048-max4095":
        "1832dcc3f45643730edd9a6d7c54a751f0c204c55460bf97bce2f4ec732c6134",
    "plane-int16-129-ls128-max255":
        "7e3a0de27acbb92aa3cb120ce8f697a407bca429a23ee1d636ab666297567968",
    "plane-int16-129-ls2048-max4095":
        "562597c94e2d41b6ab1b81ddf9beeee05e5ccf2247d5babf93a951ee91dd17f7",
    "plane-int16-16384-ls128-max255":
        "81a46ff553f8f98c8ebdc3e2fdb6cc7a1707645c488a8cbe1fcac6e592f2405f",
    "plane-int16-16384-ls2048-max4095":
        "de9f49056d4c66233961b48aed9538a99a33b14a79eb9460af29b81fbb410410",
    "plane-int16-513-ls128-max255":
        "6dee558e1b7075f5ad806afea3a98fcba3f4aa77d0061c0f99cd593276f700bd",
    "plane-int16-513-ls2048-max4095":
        "5d60bc25efb7613d1a191448b4b46435875b2ef743061759586d594ebeccea27",
}


def _digest_inputs(dtype, n):
    """Seeded coefficients [n, 64] and the two quant tables [G, 64] they
    take, with blocks_per_table such that a table boundary falls inside a
    tile (G = 1 for one block). Blocks of five kinds in random order:
    JPEG-like (falling with frequency), int16's whole range (sums past the
    fast rounding's range), flat (DC only: exact .5 ties), empty, and for
    int32 DC-led blocks past 2^22 (past the fast conversion's range), for
    int16 JPEG-like again."""
    rng = np.random.default_rng([DIGEST_SEED, n])
    kind = rng.integers(0, 5, size=n)
    kind[0] = 0  # the single block is no empty one
    typical = rng.integers(-1024, 1025, size=(n, 64)) // (1 + np.arange(64) // 8)
    full = rng.integers(-32768, 32768, size=(n, 64))
    c = np.where((kind == 0)[:, None], typical, 0)
    c = np.where((kind == 1)[:, None], full, c)
    c[kind == 2, 0] = rng.integers(-2048, 2048, size=n)[kind == 2]
    if dtype == "int32":
        big = np.where(rng.integers(0, 2, size=n) == 1, 1, -1) * rng.integers(1 << 22, 1 << 25, size=n)
        c[kind == 4] = typical[kind == 4] // 8
        c[kind == 4, 0] = big[kind == 4]
    else:
        c[kind == 4] = typical[kind == 4]
    quant = rng.integers(1, 256, size=(2, 64)).astype(np.int32)
    per_table = n // 2 + 7 if n > 16 else n
    n_tables = -(-n // per_table)
    return c.astype(dtype), quant[:n_tables], per_table


def k1_digest(case, device) -> str:
    """SHA-256 of K1's output bytes for ``case`` on ``device``."""
    store, dtype, n, ls, top = DIGEST_CASES[case]
    c, quant, per_table = _digest_inputs(dtype, n)
    coeffs = torch.from_numpy(c).to(device)
    quants = torch.from_numpy(quant).to(device)
    if store == "blocks":
        out = kernels.dequantize_idct_shift(coeffs, quants, ls, blocks_per_table=per_table)
    else:  # the plane store's C entry, which takes the tables as the block store does
        wb = PLANE_WIDTH[n]
        out = torch.empty((n // wb * 8, wb * 8), dtype=torch.uint16, device=device)
        err = _build.load_library().jpx_dequant_idct_plane_u16(
            coeffs.data_ptr(), quants.data_ptr(), kernels.transform_matrix(device).data_ptr(),
            out.data_ptr(), n, per_table, wb, ls, top, torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"CUDA error {err}"
    return hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DIGEST_CASES))
def test_card_k1_outputs_equal_recorded_digests(card, case):
    assert k1_digest(case, card) == K1_DIGESTS[case], case


# --- K2 on the card ----------------------------------------------------------

def _k2_digest_cases():
    """Case name -> (sample dtype, hs, vs, height, width, extra block rows
    and columns past the least grid, level shift, max sample, offset of the
    plane's first sample in its buffer, in samples). They cover the cells'
    three instantiations at the cells' sizes (uint8 1x1 and 2x2, uint16 1x1
    at level shift 2048) and small; int32 at 3x1 and 4x4; ragged right and
    bottom edges; pitches and base offsets that take the 16-, 4- and 1-byte
    loads; launches of fewer strips than the grid and of many a CTA."""
    cases = {}
    u8 = (128, 255)
    for hs, vs in ((1, 1), (2, 2)):
        box = f"{hs}x{vs}"
        cases[f"u8-{box}-cell-16384x4096"] = ("uint8", hs, vs, 16384, 4096, (0, 0), *u8, 0)
        cases[f"u8-{box}-2048x2048"] = ("uint8", hs, vs, 2048, 2048, (0, 0), *u8, 0)
        cases[f"u8-{box}-pitch16-ragged-1000x4112"] = ("uint8", hs, vs, 1000, 4112, (0, 0), *u8, 0)
        cases[f"u8-{box}-pitch4-ragged-600x516"] = ("uint8", hs, vs, 600, 516, (0, 0), *u8, 0)
        cases[f"u8-{box}-pitch1-ragged-1001x777"] = ("uint8", hs, vs, 1001, 777, (0, 0), *u8, 0)
        cases[f"u8-{box}-offset4-256x1024"] = ("uint8", hs, vs, 256, 1024, (0, 0), *u8, 4)
        cases[f"u8-{box}-offset1-256x1024"] = ("uint8", hs, vs, 256, 1024, (0, 0), *u8, 1)
        cases[f"u8-{box}-grid-past-plane-100x200"] = ("uint8", hs, vs, 100, 200, (2, 3), *u8, 0)
        cases[f"u8-{box}-tiny-{8 * vs}x{24 * hs}"] = ("uint8", hs, vs, 8 * vs, 24 * hs, (0, 0),
                                                      *u8, 0)
    u16 = (2048, 4095)
    cases["u16-1x1-cell-262144x512"] = ("uint16", 1, 1, 262144, 512, (0, 0), *u16, 0)
    cases["u16-1x1-512x512"] = ("uint16", 1, 1, 512, 512, (0, 0), *u16, 0)
    cases["u16-1x1-pitch4-ragged-509x514"] = ("uint16", 1, 1, 509, 514, (0, 0), *u16, 0)
    cases["u16-1x1-pitch1-ragged-515x515"] = ("uint16", 1, 1, 515, 515, (0, 0), *u16, 0)
    cases["u16-1x1-offset1-64x512"] = ("uint16", 1, 1, 64, 512, (0, 0), *u16, 1)
    cases["u16-1x1-tiny-8x8"] = ("uint16", 1, 1, 8, 8, (0, 0), *u16, 0)
    for hs, vs in ((3, 1), (4, 4)):
        box = f"{hs}x{vs}"
        for ls, top in ((128, 255), (2048, 4095)):
            cases[f"i32-{box}-ls{ls}-1024x1536"] = ("int32", hs, vs, 1024, 1536, (0, 0), ls, top, 0)
            cases[f"i32-{box}-ls{ls}-pitch4-ragged-333x1001"] = ("int32", hs, vs, 333, 1001, (0, 0),
                                                                 ls, top, 0)
        cases[f"i32-{box}-ls128-offset1-64x512"] = ("int32", hs, vs, 64, 512, (1, 1), 128, 255, 1)
    return cases


K2_DIGEST_CASES = _k2_digest_cases()

# SHA-256 of each case's two int16 outputs (small quant steps, then large),
# recorded on an NVIDIA H100 80GB HBM3 from the kernel that ran its strips in
# lock-step rounds of 4-warp CTAs (before the pipelined schedule).
K2_DIGESTS = {
    "i32-3x1-ls128-1024x1536":
        "9be1f111bf24cd1d44e916a6de6ae01d723ae3f22237ae791c469314bb433c90",
    "i32-3x1-ls128-offset1-64x512":
        "eb6edf2e41eb2ab8228cd2ffd677535638f331fcab347bf0503fd496edfb7ca9",
    "i32-3x1-ls128-pitch4-ragged-333x1001":
        "4d1c012df6d7c9318b37f1110c4226d0a68c1086617599347db32b22458740bc",
    "i32-3x1-ls2048-1024x1536":
        "403d761853d216170b22a03588ccae66bda906fb3dd0ccf9ab585b2d2a3602ac",
    "i32-3x1-ls2048-pitch4-ragged-333x1001":
        "542897d696d6ff1129f602b653704a4d1454ab1b65530662bbf7bcf2be8de981",
    "i32-4x4-ls128-1024x1536":
        "b7d15f85b1f3ae9fb58e1cdf7c86df40df31884d6b965c4688f3eb8b123d0ca4",
    "i32-4x4-ls128-offset1-64x512":
        "5cae65f3347ba45811f10697d8a2f3b1f258b79c34a813541ad43c866e532a03",
    "i32-4x4-ls128-pitch4-ragged-333x1001":
        "21c1d834fc55bcada141412422b8a527988aa3401b867a681d7922ea7823538e",
    "i32-4x4-ls2048-1024x1536":
        "4aeb3a8981ce6cd2b75f7b0d49f2c922e241a31a012623cb50815c63567b21d7",
    "i32-4x4-ls2048-pitch4-ragged-333x1001":
        "cd5f89e5f9a62c58880f925400e7bf7cc22fa7938ea3bfd08296e9464f875a73",
    "u16-1x1-512x512":
        "8fa5a035bb6b25b31570edb63dfa77b469107032209251d4309be947babc5322",
    "u16-1x1-cell-262144x512":
        "429a1f1981b508b9e3e35369a7cce9ff1c09cdfaf3d09a64ef0d25e9dc847e2b",
    "u16-1x1-offset1-64x512":
        "9a52ce5bf47aa99ba8757455ffa73c1eca37692397f792ac3034608220b7ebd4",
    "u16-1x1-pitch1-ragged-515x515":
        "38b018256bc3c37f2859b62eaaf7cc90d1c10052e59efb346e1d535f9a635009",
    "u16-1x1-pitch4-ragged-509x514":
        "df2ee8d9aa91c1d055d7f513df7bc398f66df6a6da7a76e6243b98972e587290",
    "u16-1x1-tiny-8x8":
        "bc320810f4723eb02e615538929253e0270ab09a98a67461f752b0e134e3122c",
    "u8-1x1-2048x2048":
        "a06d6b19ee5bf3e29dd366d97bb18630465cc25799040a0080f6800a32b6a3b2",
    "u8-1x1-cell-16384x4096":
        "7ddd682308a39348ccb298fa58e5b5345597eb5915cb927a6b358d194f19046f",
    "u8-1x1-grid-past-plane-100x200":
        "0e3052286c91994bd74c5bf7e9911420fe813cda089db7bdf5cc4728a8713b18",
    "u8-1x1-offset1-256x1024":
        "2328e65327dc70a5b0f8636400601f81a7d7d07ff1ffc9197798e311e0b71365",
    "u8-1x1-offset4-256x1024":
        "ba1a8a38c22e80d41a9ec62838f47c3707a34a2e8de7b322f71a90d8f791e044",
    "u8-1x1-pitch1-ragged-1001x777":
        "ae28bfb78ce22e214b58fad0a08c30126e91d8af03388c34ea9f3249e426afae",
    "u8-1x1-pitch16-ragged-1000x4112":
        "ccf204fbe7c1433f6c150389e608952a1279259295206661d78abad57085c791",
    "u8-1x1-pitch4-ragged-600x516":
        "0b8530242873453b00727c47bbf81843f62fa1e0efa46fa9c949c939b7a0e4c5",
    "u8-1x1-tiny-8x24":
        "80499022886a6e2cef8eb348b07dc2d3fd2a3c6adeb1cd22ce3c551b412692ca",
    "u8-2x2-2048x2048":
        "665508a8dcb27b21f881c22a88a5f2aef57c05cc5eba0c81090726a4e8ab7372",
    "u8-2x2-cell-16384x4096":
        "8d75d39c13b99d0fff2d639c17cf8b00b07c60a7a6143ac947febdd5c58e3c86",
    "u8-2x2-grid-past-plane-100x200":
        "8235d47b70ab1380ac039f08885ed9ce422b0dd12b7bc99d834ae8c2bb3620b0",
    "u8-2x2-offset1-256x1024":
        "be95d9eba656fdb79602408da82636274dafa3b68bee8b1122eddbdafda6d361",
    "u8-2x2-offset4-256x1024":
        "c107eac73263e18fd06463a1bceb9c7068024c4554dd8b70eb816f0c8c8356c2",
    "u8-2x2-pitch1-ragged-1001x777":
        "f9a7788037b08d30df0fac8302d4cf7aa4b12e94456bd17ce2fbd7fdcf0ac820",
    "u8-2x2-pitch16-ragged-1000x4112":
        "0286d272ee8b2c63eba77b5378628a6e5fa8da7a4cbe5be87f2e6697fef4e74c",
    "u8-2x2-pitch4-ragged-600x516":
        "0e1fa053e916318da1e1d7a2a5073fe5beb1484bb7a2a47eef7e42ac1fa92982",
    "u8-2x2-tiny-16x48":
        "77991ddeaf6ab361763fd5e4d8762220d286f0811920429dd6415af1ba3774f1",
}


def _k2_digest_inputs(case):
    """The case's samples (numpy, seeded by its name): uniform noise over
    the whole range, with 32 x 32 tiles overwritten by flat values (exact
    .5 ties in the DC), by 0 or by the largest sample; and its two quant
    tables, steps of 1 to 3 and of 64 to 255."""
    dtype, hs, vs, h, w, extra, ls, top, offset = K2_DIGEST_CASES[case]
    rng = np.random.default_rng([DIGEST_SEED, zlib.crc32(case.encode())])
    plane = rng.integers(0, top + 1, size=(h, w), dtype=np.int64)
    th, tw = -(-h // 32), -(-w // 32)
    kind = rng.integers(0, 8, size=(th, tw))
    flat = rng.integers(0, top + 1, size=(th, tw))
    tile = np.select([kind == 1, kind == 2, kind == 3], [flat, 0, top], -1)
    over = np.kron(tile, np.ones((32, 32), np.int64))[:h, :w]
    plane = np.where(over >= 0, over, plane).astype(dtype)
    small = rng.integers(1, 4, size=64).astype(np.int32)
    large = rng.integers(64, 256, size=64).astype(np.int32)
    return plane, (small, large)


def k2_digest(case, device) -> str:
    """SHA-256 of K2's outputs for ``case`` on ``device``: one launch per
    quant table, the plane placed ``offset`` samples into its buffer."""
    dtype, hs, vs, h, w, extra, ls, top, offset = K2_DIGEST_CASES[case]
    plane, quants = _k2_digest_inputs(case)
    buf = np.zeros(h * w + offset, dtype)
    buf[offset:] = plane.reshape(-1)
    samples = torch.from_numpy(buf).to(device)[offset:].view(h, w)
    blocks = (-(-h // (8 * vs)) + extra[0], -(-w // (8 * hs)) + extra[1])
    digest = hashlib.sha256()
    for quant in quants:
        out = kernels.fdct_quantize(samples, torch.from_numpy(quant).to(device), ls, hs=hs, vs=vs,
                                    blocks=blocks)
        digest.update(out.cpu().numpy().tobytes())
    return digest.hexdigest()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K2_DIGEST_CASES))
def test_card_k2_outputs_equal_recorded_digests(card, case):
    assert k2_digest(case, card) == K2_DIGESTS[case], case


def test_k2_entries_match_their_ctypes_signatures():
    """Every C entry of csrc/fdct_quant.cu takes as many arguments as
    ``_build`` declares for it, the walk query among them."""
    import re

    text = (_build._CSRC / "fdct_quant.cu").read_text()
    for name in ("jpx_fdct_quant_u8", "jpx_fdct_quant_u16", "jpx_fdct_quant_i32",
                 "jpx_fdct_quant_walk"):
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
        assert m and m.group(1).count(",") + 1 == len(_build._ENTRY_POINTS[name]), name


@pytest.mark.cuda
def test_card_k2_walks(card):
    """The cells' three instantiations take the warpgroup walk; int32 at 4x4,
    whose strip is 128 KB, and 8-bit samples past level shift 256 take the
    CTA walk; a box K2 does not take is refused."""
    walk = kernels.fdct_walk
    assert [walk(1, 1, 1, 128), walk(1, 2, 2, 128), walk(2, 1, 1, 2048)] == ["warpgroups"] * 3
    assert [walk(4, 4, 4, 128), walk(1, 1, 1, 2048)] == ["rounds"] * 2
    with pytest.raises(ValueError):
        walk(2, 2, 2, 2048)
